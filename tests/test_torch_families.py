"""The port's other LM families against the JAX package on the CPU, at
their SMOKE sizes in fp32: GShard MoE (granite-moe-3b-a800m, dbrx-132b),
cross attention (llama-3.2-vision-90b), pre-embedded frames
(musicgen-medium) and the dense GQA configs (glm4-9b, command-r-35b,
qwen1.5-110b with its QKV bias). For each config the schema and the
weight bridge, logits, loss and parameter gradients on the same weights
and batch; then the MoE layer expert for expert (top-k tie order, drops
past capacity, bf16, gelu experts, the load-balancing loss), the
cross-attention layer, the frame input, the registry and the main
paths' parameter counts. The JAX side runs its reference path
(`use_pallas=False`), as its own SMOKE configs do. Inputs come from
numpy seeds (`tests/test_models.py::make_batch`) and cross as numpy
arrays."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax import lax

from repro import configs as jconfigs
from repro.comms.payload import UpdatePayload as JaxPayload
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.benchmarks import table1 as T1
from repro_torch.common import bridge
from repro_torch.common import config as C
from repro_torch.comms.payload import UpdatePayload
from repro_torch.models import layers, lm

from test_models import make_batch

NEW_ARCHS = ["glm4-9b", "command-r-35b", "qwen1.5-110b",
             "llama-3.2-vision-90b", "granite-moe-3b-a800m", "dbrx-132b",
             "musicgen-medium"]
# Bars, from tools/lm_fp32_spread.py over make_batch seeds 0-3 (port fp32,
# JAX fp32, and the port in float64 on the JAX package's weights):
# * logits within 5e-5 of the largest logit. These configs' logits reach
#   2 to 6, and the two packages lie up to 2.7e-5 of the largest apart
#   (the JAX package's own fp32 logits up to 3.0e-5 from float64), so
#   test_torch_models.py::TestLM's absolute 2e-5 does not carry over;
# * gradients per leaf within 1e-4 of the leaf's largest entry, TestLM's
#   bar, at seed 0. At other seeds granite/dbrx and musicgen lie up to
#   2.2e-4 apart, where the JAX package's own fp32 gradients lie up to
#   2.7e-4 and 3.5e-4 from float64; so does phi3's at seed 0 (2.3e-4),
#   while the packages agree to 2.2e-5: two fp32 runs, not a port fault;
# * but llama-vision SMOKE's gradients within 3e-3. Its five layers form
#   one stacked block, so every weight is drawn with fan-in 1 (the JAX
#   schema's `shape[0]` of a stacked leaf) at std 1, and four such
#   attention layers amplify rounding: each package's fp32 gradients lie
#   up to 1.2e-3 of a leaf's largest entry from float64, and the two up
#   to 2.2e-3 apart (9.9e-4 at seed 0). phi3 SMOKE built as one
#   five-layer block shows the same spread, so this is the
#   configuration's conditioning, not the cross-attention layer, whose
#   own output and gradients are held at 2e-5 and 1e-4 below
LOGITS_TOL = 5e-5
GRAD_TOL = {"llama-3.2-vision-90b": 3e-3}


def _pair(arch):
    return (jconfigs.get_config(arch, smoke=True),
            configs.get_config(arch, smoke=True))


def _flat(tree):
    return dict(bridge.flatten_with_paths(tree))


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jlm.init_params(cfg, jax.random.PRNGKey(seed)))


def _np_batch(cfg, seed=0):
    return {k: np.asarray(v) for k, v in make_batch(cfg, seed=seed).items()}


def _torch_batch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
                else torch.from_numpy(v)) for k, v in batch.items()}


# one JAX evaluation per arch, shared by the cases
_JAX = {}


def _jax_results(arch):
    """JAX logits, loss and gradients of `arch` SMOKE on make_batch."""
    if arch not in _JAX:
        jcfg, _ = _pair(arch)
        jp = jax.tree.map(jnp.asarray, _jax_params(jcfg))
        jb = {k: jnp.asarray(v) for k, v in _np_batch(jcfg).items()}
        logits, _ = jlm.forward(jp, jcfg, jb["tokens"], cond=jb.get("cond"))
        loss, grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, jb))(jp)
        _JAX[arch] = (np.asarray(logits), float(loss),
                      _flat(jax.tree.map(np.asarray, grads)))
    return _JAX[arch]


class TestSchema:
    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_port_init_has_the_jax_schema(self, arch):
        jcfg, cfg = _pair(arch)
        jp = _jax_params(jcfg)
        params = lm.init_params(cfg, seed=0, device="cpu")
        want = {k: (v.shape, v.dtype.name) for k, v in _flat(jp).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _flat(params).items()}
        assert got == want
        assert [k for k, _ in lm.param_shapes(cfg)] == list(_flat(jp))
        for q in (False, True):
            assert dataclasses.astuple(
                UpdatePayload.from_tree(params, quantized=q)) == \
                dataclasses.astuple(JaxPayload.from_tree(jp, quantized=q))

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_round_trip_is_bit_identical(self, arch, dtype):
        jcfg, cfg = _pair(arch)
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype, dtype=dtype)
        cfg = dataclasses.replace(cfg, param_dtype=dtype, dtype=dtype)
        jp = _jax_params(jcfg)
        back = _flat(bridge.params_to_numpy(
            bridge.params_from_numpy(jp, cfg, device="cpu")))
        assert set(back) == set(_flat(jp))
        for k, a in _flat(jp).items():
            assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
            assert back[k].tobytes() == a.tobytes(), k

    @pytest.mark.parametrize("smoke", [False, True])
    def test_registry_is_the_jax_package_s(self, smoke):
        """The same ten architectures in the same order, each FULL and
        SMOKE config equal field for field, but the fields the port
        leaves out."""
        assert configs.ARCH_IDS == jconfigs.ARCH_IDS
        left_out = {"attn_chunk", "sharding_overrides", "use_pallas",
                    "scan_layers"}
        for arch in configs.ARCH_IDS:
            got = configs.get_config(arch, smoke=smoke)
            want = jconfigs.get_config(arch, smoke=smoke)
            fields = {f.name for f in dataclasses.fields(want)} - left_out
            assert fields == {f.name for f in dataclasses.fields(got)}, arch
            for f in fields:
                a, b = getattr(got, f), getattr(want, f)
                if dataclasses.is_dataclass(b):
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, (arch, f)

    @pytest.mark.parametrize("model", sorted(T1.MAIN_PATHS))
    def test_main_path_parameter_count_is_the_jax_package_s(self, model):
        cfg = T1.main_path(model)[0]
        jcfg = dataclasses.replace(jconfigs.get_config(model),
                                   num_layers=cfg.num_layers)
        got = sum(int(np.prod(shape)) for _, (shape, _) in
                  lm.param_shapes(cfg))
        assert got == jlm.param_count(jcfg)
        if model == "granite-moe-3b-a800m":
            assert got == 352_461_312


class TestLM:
    # fp32 end to end, at the bars above
    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_logits_and_loss_match_jax(self, arch):
        jlogits, jloss, _ = _jax_results(arch)
        jcfg, cfg = _pair(arch)
        params = bridge.params_from_numpy(_jax_params(jcfg), cfg,
                                          device="cpu")
        tb = _torch_batch(_np_batch(jcfg))
        logits, _ = lm.forward(params, cfg, tb["tokens"], cond=tb.get("cond"))
        np.testing.assert_allclose(
            logits.detach().numpy(), jlogits, rtol=0,
            atol=LOGITS_TOL * np.max(np.abs(jlogits)))
        np.testing.assert_allclose(lm.loss_fn(params, cfg, tb).item(), jloss,
                                   rtol=1e-6)

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_grads_match_jax(self, arch, remat):
        _, jloss, jg = _jax_results(arch)
        jcfg, cfg = _pair(arch)
        cfg = dataclasses.replace(cfg, remat=remat)
        params = bridge.params_from_numpy(_jax_params(jcfg), cfg,
                                          device="cpu")
        leaves = _flat(params)
        for t in leaves.values():
            t.requires_grad_(True)
        loss = lm.loss_fn(params, cfg, _torch_batch(_np_batch(jcfg)))
        # musicgen's frames bypass the embedding table: no gradient
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
        assert set(leaves) == set(jg)
        tol = GRAD_TOL.get(arch, 1e-4)
        for k, g in zip(leaves, grads):
            g = np.zeros(jg[k].shape, np.float32) if g is None else g.numpy()
            err = np.max(np.abs(g - jg[k]))
            assert err <= tol * np.max(np.abs(jg[k])), (k, err)

    def test_frames_bypass_the_embedding(self):
        """(B,S,D) frames enter as the embedded tokens would: feeding the
        embedding rows of token ids gives the logits of the ids."""
        cfg = configs.get_config("musicgen-medium", smoke=True)
        params = lm.init_params(cfg, seed=1, device="cpu")
        toks = torch.from_numpy(
            np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 12)))
        frames = params["embed"]["table"][toks]
        a, _ = lm.forward(params, cfg, toks)
        b, _ = lm.forward(params, cfg, frames)
        torch.testing.assert_close(a, b, atol=0, rtol=0)

    def test_moe_aux_enters_the_loss(self):
        """The MoE layers' load-balancing losses, summed over the layers,
        enter the loss at weight `aux_weight`, as in the JAX package."""
        jcfg, cfg = _pair("granite-moe-3b-a800m")
        jp = _jax_params(jcfg)
        batch = _np_batch(jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        _, jaux = jlm.forward(jax.tree.map(jnp.asarray, jp), jcfg,
                              jb["tokens"])
        params = bridge.params_from_numpy(jp, cfg, device="cpu")
        tb = _torch_batch(batch)
        _, aux = lm.forward(params, cfg, tb["tokens"])
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
        ce = lm.loss_fn(params, cfg, tb, aux_weight=0.0)
        np.testing.assert_allclose(
            lm.loss_fn(params, cfg, tb, aux_weight=0.5).item(),
            ce.item() + 0.5 * float(aux), rtol=1e-6)


# ---------------------------------------------------------------------------
# The MoE layer.
# ---------------------------------------------------------------------------
def _moe_case(seed, *, capacity_factor=2.0, mlp_kind="swiglu", B=2, S=32,
              experts=4, top_k=2, group=32, d=64, router=None):
    """A granite-SMOKE-like MoE layer's weights and input, from `seed`."""
    jcfg, cfg = _pair("granite-moe-3b-a800m")
    moe = dataclasses.replace(jcfg.moe, num_experts=experts, top_k=top_k,
                              group_size=group,
                              capacity_factor=capacity_factor)
    kw = dict(mlp_kind=mlp_kind, d_model=d)
    jcfg = dataclasses.replace(jcfg, moe=moe, **kw)
    cfg = dataclasses.replace(cfg, moe=C.MoEConfig(**dataclasses.asdict(moe)),
                              **kw)
    rng = np.random.RandomState(seed)
    p = {k: (rng.randn(*s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for k, s in jlayers.moe_schema(jcfg).items()}
    if router is not None:
        p["router"] = router(rng, p["router"].shape)
    x = rng.randn(B, S, d).astype(np.float32)
    return jcfg, cfg, p, x


def _routing(probs, k):
    """lax.top_k's expert choice."""
    _, idx = lax.top_k(jnp.asarray(probs), k)
    return np.asarray(idx)


def _run_moe(jcfg, cfg, p, x, dtype=jnp.float32):
    jy, jaux = jlayers.moe({k: jnp.asarray(v, dtype) for k, v in p.items()},
                           jnp.asarray(x, dtype), jcfg)
    tp = {k: bridge._to_tensor(np.asarray(jnp.asarray(v, dtype)))
          for k, v in p.items()}
    tx = bridge._to_tensor(np.asarray(jnp.asarray(x, dtype)))
    y, aux = layers.moe(tp, tx, cfg)
    return (bridge._to_numpy(y).astype(np.float32),
            np.asarray(jy, np.float32), float(aux), float(jaux), tp, tx)


def _expert_choice(cfg, p, x):
    """The port's router probabilities and top-k expert choice."""
    m = cfg.moe
    gs = min(m.group_size, x.shape[0] * x.shape[1])
    xg = x.reshape(-1, gs, x.shape[-1])
    probs = torch.softmax(torch.einsum("gsd,de->gse", xg, p["router"])
                          .float(), dim=-1)
    return probs, layers.top_k(probs, m.top_k)[1]


class TestMoE:
    def test_top_k_breaks_ties_as_lax_top_k(self):
        x = np.array([[.1, .3, .3, .2, .3, .1], [0., 0., 0., 0., 0., 0.]],
                     np.float32)
        want_vals, want_idx = lax.top_k(jnp.asarray(x), 3)
        vals, idx = layers.top_k(torch.from_numpy(x), 3)
        assert idx.tolist() == np.asarray(want_idx).tolist() == \
            [[1, 2, 4], [0, 1, 2]]
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))

    @pytest.mark.parametrize("capacity_factor", [2.0, 1.0])
    def test_matches_jax_expert_for_expert(self, capacity_factor):
        """At capacity_factor 2 (capacity = group tokens: no drops) and 1.0
        (capacity 16 of 32 tokens: some slots are dropped), the same
        expert choice as `lax.top_k` and the same output and aux loss."""
        jcfg, cfg, p, x = _moe_case(0, capacity_factor=capacity_factor)
        got, want, aux, jaux, tp, tx = _run_moe(jcfg, cfg, p, x)
        probs, idx = _expert_choice(cfg, tp, tx)
        assert idx.tolist() == _routing(probs.numpy(), cfg.moe.top_k).tolist()
        # slots past their expert's capacity, in GShard's slot-major order
        K, E = cfg.moe.top_k, cfg.moe.num_experts
        cap = layers.moe_capacity(cfg, idx.shape[1])
        assert cap == jlayers.moe_capacity(jcfg, idx.shape[1])
        counts = np.zeros((idx.shape[0], E), int)
        dropped = 0
        for g in range(idx.shape[0]):
            for k in range(K):
                for s in range(idx.shape[1]):
                    e = int(idx[g, s, k])
                    dropped += counts[g, e] >= cap
                    counts[g, e] += 1
        assert (dropped > 0) == (capacity_factor == 1.0), dropped
        np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(),
                                   rtol=0)
        np.testing.assert_allclose(aux, jaux, rtol=1e-6)

    def test_zero_router_ties_every_expert(self):
        """A zero router gives every expert the same probability: JAX takes
        the first K experts, and so must the port, for every token."""
        zero = _moe_case(1, router=lambda rng, shape: np.zeros(shape,
                                                               np.float32))
        jcfg, cfg, p, x = zero
        got, want, aux, jaux, tp, tx = _run_moe(jcfg, cfg, p, x)
        _, idx = _expert_choice(cfg, tp, tx)
        assert (idx == torch.arange(cfg.moe.top_k)).all()
        np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(),
                                   rtol=0)
        np.testing.assert_allclose(aux, jaux, rtol=1e-6)

    def test_bf16_with_tied_router_logits(self):
        """bf16, as the full-width models run: x and router on coarse grids,
        so both packages' bf16 router logits are the same exact sums, many
        of them equal, and the expert choice and the drops are the same;
        the output is held at bf16's bar, 2e-2 of its largest entry."""
        def coarse(rng, shape):
            return (rng.randint(-2, 3, shape) / 4.0).astype(np.float32)

        jcfg, cfg, p, _ = _moe_case(2, capacity_factor=1.0, router=coarse)
        x = coarse(np.random.RandomState(3), (2, 32, 64))
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        got, want, aux, jaux, tp, tx = _run_moe(jcfg, cfg, p, x, jnp.bfloat16)
        probs, idx = _expert_choice(cfg, tp, tx)
        assert (probs[..., :, None] == probs[..., None, :]).sum() \
            > probs.numel()                           # some experts tie
        assert idx.tolist() == _routing(probs.numpy(), cfg.moe.top_k).tolist()
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(),
                                   rtol=0)
        np.testing.assert_allclose(aux, jaux, rtol=1e-6)

    def test_gelu_experts(self):
        jcfg, cfg, p, x = _moe_case(4, mlp_kind="gelu")
        got, want, aux, jaux, _, _ = _run_moe(jcfg, cfg, p, x)
        np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(),
                                   rtol=0)
        np.testing.assert_allclose(aux, jaux, rtol=1e-6)

    def test_full_width_routing(self):
        """granite-moe-3b-a800m's router (40 experts, top 8, groups of 128,
        capacity 32) on one group of tokens, with its bf16 logits: the
        expert choice of `lax.top_k`."""
        cfg = configs.get_config("granite-moe-3b-a800m")
        rng = np.random.RandomState(6)
        x = jnp.asarray(rng.randn(1, 128, cfg.d_model), jnp.bfloat16)
        router = jnp.asarray(rng.randn(cfg.d_model, 40) / np.sqrt(2),
                             jnp.bfloat16)
        logits = np.asarray(jnp.einsum("gsd,de->gse", x, router)
                            .astype(jnp.float32))
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        assert layers.moe_capacity(cfg, 128) == 32
        vals, idx = layers.top_k(torch.from_numpy(probs), 8)
        assert idx.tolist() == _routing(probs, 8).tolist()
        # bf16 logits tie within a token's top 8, so the order matters
        assert bool((vals[..., 1:] == vals[..., :-1]).any())

    @pytest.mark.parametrize("seed", [0, 1])
    def test_gradients_match_jax(self, seed):
        """Gradients of a loss on the layer's output and aux with respect
        to its weights and input, at 1e-4 of each one's largest entry."""
        jcfg, cfg, p, x = _moe_case(10 + seed, capacity_factor=1.0)
        g = np.random.RandomState(seed).randn(*x.shape).astype(np.float32)

        def jloss(p, x):
            y, aux = jlayers.moe(p, x, jcfg)
            return jnp.sum(y * g) + 3.0 * aux

        want = jax.grad(jloss, argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        tx = torch.from_numpy(x).requires_grad_()
        y, aux = layers.moe(tp, tx, cfg)
        got = torch.autograd.grad((y * torch.from_numpy(g)).sum() + 3.0 * aux,
                                  list(tp.values()) + [tx])
        pairs = [(got[i], want[0][k]) for i, k in enumerate(tp)]
        pairs.append((got[-1], want[1]))
        for a, b in pairs:
            b = np.asarray(b)
            assert np.max(np.abs(a.numpy() - b)) <= 1e-4 * np.max(np.abs(b))

    def test_aux_loss(self):
        rng = np.random.RandomState(7)
        logits = rng.randn(3, 16, 5).astype(np.float32)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        _, idx = lax.top_k(jnp.asarray(probs), 2)
        onehot = np.asarray(jax.nn.one_hot(idx, 5, dtype=jnp.float32))
        want = jlayers._aux_loss(jnp.asarray(probs), jnp.asarray(onehot))
        got = layers._aux_loss(torch.from_numpy(probs),
                               torch.from_numpy(onehot))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    def test_group_must_divide_the_tokens(self):
        _, cfg, p, x = _moe_case(8, B=3, S=16)     # 48 tokens, groups of 32
        with pytest.raises(ValueError, match="dispatch groups"):
            layers.moe({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), cfg)


# ---------------------------------------------------------------------------
# Cross attention.
# ---------------------------------------------------------------------------
class TestCrossAttention:
    @pytest.mark.parametrize("softcap,qkv_bias", [(None, False),
                                                  (5.0, True)])
    def test_layer_matches_jax(self, softcap, qkv_bias):
        """llama-vision SMOKE's cross layer (8 heads over 2 kv heads, head
        dim 8), not causal, no RoPE, against the JAX chunked path:
        output at 2e-5, gradients of weights, x and cond at 1e-4 of each
        one's largest entry."""
        jcfg, cfg = _pair("llama-3.2-vision-90b")
        kw = dict(logit_softcap=softcap, qkv_bias=qkv_bias)
        jcfg = dataclasses.replace(jcfg, **kw)
        cfg = dataclasses.replace(cfg, **kw)
        rng = np.random.RandomState(9)
        p = {k: (rng.randn(*s.shape) * 0.3).astype(np.float32)
             for k, s in jlayers.attention_schema(jcfg, cross=True).items()}
        assert set(p) == set(layers.attention_schema(cfg))
        x = rng.randn(2, 12, 64).astype(np.float32)
        cond = rng.randn(2, 8, 64).astype(np.float32)
        g = rng.randn(2, 12, 64).astype(np.float32)

        def jf(p, x, cond):
            return jlayers.attention(p, x, jcfg, kind=C.CROSS_ATTN, cond=cond)

        jy = jf({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                jnp.asarray(cond))
        want = jax.grad(lambda *a: jnp.sum(jf(*a) * g), argnums=(0, 1, 2))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            jnp.asarray(cond))
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        tx, tc = (torch.from_numpy(a).requires_grad_() for a in (x, cond))
        y = layers.attention(tp, tx, cfg, kind=C.CROSS_ATTN, cond=tc)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   atol=2e-5, rtol=2e-5)
        got = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                                  list(tp.values()) + [tx, tc])
        pairs = [(got[i], want[0][k]) for i, k in enumerate(tp)]
        pairs += [(got[-2], want[1]), (got[-1], want[2])]
        for a, b in pairs:
            b = np.asarray(b)
            assert np.max(np.abs(a.numpy() - b)) <= 1e-4 * np.max(np.abs(b))

    def test_needs_cond(self):
        cfg = configs.get_config("llama-3.2-vision-90b", smoke=True)
        params = lm.init_params(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="cond"):
            lm.forward(params, cfg, torch.zeros((1, 4), dtype=torch.long))

    def test_cross_layer_runs_no_flash_kernel(self, monkeypatch):
        """The JAX package never sends cross attention to its kernel, and
        the port's cross layers call no flash op either."""
        from repro_torch.kernels.flash_attention import ops as fa
        cfg = configs.get_config("llama-3.2-vision-90b", smoke=True)
        cfg = dataclasses.replace(cfg, pattern=(C.CROSS_ATTN,), num_layers=2)
        params = lm.init_params(cfg, seed=0, device="cpu")
        calls = []
        real = fa.flash_attention
        monkeypatch.setattr(fa, "flash_attention",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        logits, _ = lm.forward(params, cfg,
                               torch.zeros((1, 4), dtype=torch.long),
                               cond=torch.zeros((1, 8, 64)))
        assert not calls and bool(torch.isfinite(logits).all())
