"""The port's model stack against the JAX package's on the CPU, at phi3
SMOKE (2 layers, d=64) in fp32: the weight bridge, RMSNorm and RoPE one
by one, and the LM's logits, loss and parameter gradients on the same
weights, with the JAX attention through the Pallas kernel (interpret
mode) and through its chunked path. Then the same for the state-space
families at their SMOKE sizes (mamba2, recurrentgemma), with
`_causal_conv`, `_rglru_coeffs` and both mixes checked one by one; their
JAX Pallas scans have no gradient, so gradients are held to the JAX
reference path (`use_pallas=False`) and the forward to both paths."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.comms.payload import UpdatePayload as JaxPayload
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.common import bridge
from repro_torch.comms.payload import UpdatePayload
from repro_torch.models import layers, lm, ssm

JCFG = jconfigs.get_config("phi3-mini-3.8b", smoke=True)
CFG = configs.get_config("phi3-mini-3.8b", smoke=True)


def _jax_params(cfg=JCFG, seed=0):
    return jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(seed)))


def _flat(tree):
    return dict(bridge.flatten_with_paths(tree))


class TestBridge:
    def test_keys_match_jax_checkpoint_paths(self):
        from repro.checkpoint.ckpt import _flatten_with_paths
        jp = _jax_params()
        assert [k for k, _ in bridge.flatten_with_paths(jp)] == \
            [k for k, _ in _flatten_with_paths(jp)]
        assert [k for k, _ in lm.param_shapes(CFG)] == list(_flat(jp))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_round_trip_is_bit_identical(self, dtype):
        jcfg = dataclasses.replace(JCFG, param_dtype=dtype, dtype=dtype)
        cfg = dataclasses.replace(CFG, param_dtype=dtype, dtype=dtype)
        jp = _jax_params(jcfg)
        back = _flat(bridge.params_to_numpy(
            bridge.params_from_numpy(jp, cfg, device="cpu")))
        for k, a in _flat(jp).items():
            assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
            assert back[k].tobytes() == a.tobytes(), k

    def test_rejects_a_wrong_layout(self):
        jp = _jax_params()
        jp["blocks"]["00_attn"]["mix"]["wq"] = \
            jp["blocks"]["00_attn"]["mix"]["wq"].transpose(0, 2, 1, 3)
        with pytest.raises(ValueError, match="wq"):
            bridge.params_from_numpy(jp, CFG, device="cpu")

    def test_port_init_has_the_jax_schema(self):
        params = lm.init_params(CFG, seed=0, device="cpu")
        want = {k: (v.shape, v.dtype.name) for k, v in _flat(_jax_params()).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _flat(params).items()}
        assert got == want
        # the stacked layer dim is kept, so the payload matches leaf for leaf
        for q in (False, True):
            assert dataclasses.astuple(
                UpdatePayload.from_tree(params, quantized=q)) == \
                dataclasses.astuple(
                    JaxPayload.from_tree(_jax_params(), quantized=q))


class TestLayers:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_rms_norm(self, dtype):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 8, 64).astype(np.float32) * 3
        scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
        jx = jnp.asarray(x, dtype)
        want = jlayers.rms_norm(jx, {"scale": jnp.asarray(scale)}, 1e-5)
        got = layers.rms_norm(bridge._to_tensor(np.asarray(jx)),
                              {"scale": torch.from_numpy(scale)}, 1e-5)
        tol = 1e-6 if dtype == jnp.float32 else 1e-2
        assert got.dtype == bridge._to_tensor(np.asarray(want)).dtype
        np.testing.assert_allclose(bridge._to_numpy(got).astype(np.float32),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_rope(self, dtype):
        rng = np.random.RandomState(1)
        x = rng.randn(2, 16, 4, 32).astype(np.float32)
        jx = jnp.asarray(x, dtype)
        want = jlayers.rope(jx, jnp.arange(16), 10_000.0)
        got = layers.rope(bridge._to_tensor(np.asarray(jx)),
                          torch.arange(16), 10_000.0)
        tol = 2e-5 if dtype == jnp.float32 else 1e-2
        np.testing.assert_allclose(bridge._to_numpy(got).astype(np.float32),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def _batch(seed=0, B=2, S=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, CFG.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TestLM:
    # fp32 end to end; the attention sums in another order than the JAX
    # kernel, so logits and loss agree to ~1e-6. Gradients are held per
    # leaf to 1e-4 of the leaf's largest entry: the 0.02-scale embeddings
    # pass through RMSNorm, which scales their gradient up ~50x, and the
    # rounding with it
    @pytest.mark.parametrize("use_pallas", [True, False])
    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_grads_match_jax(self, use_pallas, remat):
        jcfg = dataclasses.replace(JCFG, use_pallas=use_pallas, remat=remat)
        cfg = dataclasses.replace(CFG, remat=remat)
        jp = _jax_params()
        batch = _batch()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss, jgrads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, jb))(jax.tree.map(jnp.asarray, jp))
        jlogits, _ = jlm.forward(jax.tree.map(jnp.asarray, jp), jcfg,
                                 jb["tokens"])

        params = bridge.params_from_numpy(jp, cfg, device="cpu")
        leaves = dict(bridge.flatten_with_paths(params))
        for t in leaves.values():
            t.requires_grad_(True)
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        loss = lm.loss_fn(params, cfg, tb)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        logits, _ = lm.forward(params, cfg, tb["tokens"])

        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
        jg = _flat(jax.tree.map(np.asarray, jgrads))
        for k, g in zip(leaves, grads):
            err = np.max(np.abs(g.numpy() - jg[k]))
            assert err <= 1e-4 * np.max(np.abs(jg[k])), (k, err)

    def test_local_window_softcap_gqa_and_tail(self):
        """The LOCAL_ATTN kind, logit softcap, a GQA repeat and a tail
        layer (3 layers of a 2-kind pattern), against the JAX chunked
        path."""
        kw = dict(pattern=("local_attn", "attn"), window_size=5,
                  logit_softcap=8.0, num_kv_heads=2, num_layers=3)
        jcfg = dataclasses.replace(JCFG, **kw, use_pallas=False)
        cfg = dataclasses.replace(CFG, **kw)
        jp = _jax_params(jcfg)
        batch = _batch(1)
        jloss = jlm.loss_fn(jax.tree.map(jnp.asarray, jp), jcfg,
                            {k: jnp.asarray(v) for k, v in batch.items()})
        loss = lm.loss_fn(bridge.params_from_numpy(jp, cfg, device="cpu"),
                          cfg, {k: torch.from_numpy(v).long()
                                for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)


# ---------------------------------------------------------------------------
# State-space families.
# ---------------------------------------------------------------------------
SSM_ARCHS = ["mamba2-1.3b", "recurrentgemma-2b"]


def _pair(arch):
    return (jconfigs.get_config(arch, smoke=True),
            configs.get_config(arch, smoke=True))


def _ssm_batch(cfg, seed=0, B=2, S=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TestSSMBridge:
    @pytest.mark.parametrize("arch", SSM_ARCHS)
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

    @pytest.mark.parametrize("arch", SSM_ARCHS)
    def test_port_init_has_the_jax_schema(self, arch):
        jcfg, cfg = _pair(arch)
        # in a bf16 model the SSM's scalar leaves stay fp32, as in JAX
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
        params = lm.init_params(cfg, seed=0, device="cpu")
        jp = _jax_params(jcfg)
        want = {k: (v.shape, v.dtype.name) for k, v in _flat(jp).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _flat(params).items()}
        assert got == want
        for q in (False, True):
            assert dataclasses.astuple(
                UpdatePayload.from_tree(params, quantized=q)) == \
                dataclasses.astuple(JaxPayload.from_tree(jp, quantized=q))

    def test_mamba2_initializers_draw_the_jax_ranges(self):
        cfg = configs.get_config("mamba2-1.3b", smoke=True)
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=1))                      # 128 heads to draw
        mix = lm.init_params(cfg, seed=3, device="cpu")["blocks"]["00_mamba2"]["mix"]
        lo, hi = cfg.ssm.a_init_range
        a = torch.exp(mix["A_log"])
        assert float(a.min()) >= lo and float(a.max()) <= hi
        dt = torch.nn.functional.softplus(mix["dt_bias"])
        assert float(dt.min()) >= cfg.ssm.dt_min * (1 - 1e-5)
        assert float(dt.max()) <= cfg.ssm.dt_max * (1 + 1e-5)
        assert float(dt.max()) > 10 * float(dt.min())  # log-uniform spread

    def test_rglru_initializer_draws_the_jax_range(self):
        cfg = configs.get_config("recurrentgemma-2b", smoke=True)
        lam = lm.init_params(cfg, seed=4, device="cpu")["blocks"]["00_rglru"]["mix"]["lam"]
        a = torch.sigmoid(lam)
        assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
        assert lam.dtype == torch.float32


def _t(a):
    return bridge._to_tensor(np.asarray(a))


class TestSSMLayers:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_causal_conv(self, dtype):
        rng = np.random.RandomState(20)
        u = jnp.asarray(rng.randn(2, 12, 40), dtype)
        w = jnp.asarray(rng.randn(4, 40) * 0.5, dtype)
        b = jnp.asarray(rng.randn(40) * 0.1, dtype)
        want = jssm._causal_conv(u, w, b)
        got = ssm._causal_conv(_t(u), _t(w), _t(b))
        assert got.dtype == _t(want).dtype
        # the same products and sums in the same order: bit-equal in fp32;
        # in bf16 within one rounding of the result
        tol = 0 if dtype == jnp.float32 else 1e-2
        np.testing.assert_allclose(
            bridge._to_numpy(got).astype(np.float32),
            np.asarray(want, np.float32), atol=tol, rtol=tol)

    def test_rglru_coeffs(self):
        jcfg, cfg = _pair("recurrentgemma-2b")
        jp = _jax_params(jcfg)["blocks"]["00_rglru"]["mix"]
        p = {k: _t(v[0]) for k, v in jp.items()}
        rng = np.random.RandomState(21)
        u = (rng.randn(2, 9, 64) * 2).astype(np.float32)
        ja, jb = jssm._rglru_coeffs({k: v[0] for k, v in jp.items()},
                                    jnp.asarray(u), jcfg)
        a, b = ssm._rglru_coeffs(p, torch.from_numpy(u), cfg)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=2e-6,
                                   atol=0)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=2e-5,
                                   atol=1e-7)

    @pytest.mark.parametrize("arch,kind,mix", [
        ("mamba2-1.3b", "00_mamba2", "mamba2_mix"),
        ("recurrentgemma-2b", "00_rglru", "rglru_mix")])
    @pytest.mark.parametrize("use_pallas", [True, False])
    def test_mix_matches_jax(self, arch, kind, mix, use_pallas):
        """One mixing layer on the same weights and input, against the JAX
        mix through its Pallas scan (interpret mode) and its reference."""
        jcfg, cfg = _pair(arch)
        jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
        jp = {k: v[0] for k, v in _jax_params(jcfg)["blocks"][kind]["mix"].items()}
        rng = np.random.RandomState(22)
        x = rng.randn(2, 16, cfg.d_model).astype(np.float32)
        want = getattr(jssm, mix)(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                  jcfg)
        got = getattr(ssm, mix)({k: _t(v) for k, v in jp.items()},
                                torch.from_numpy(x), cfg)
        scale = np.max(np.abs(np.asarray(want)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5 * scale, rtol=0)


# one JAX loss-and-gradient evaluation per arch, shared by the cases
_JAX_GRADS = {}


def _jax_loss_and_grads(arch):
    if arch not in _JAX_GRADS:
        jcfg, _ = _pair(arch)
        jp = _jax_params(jcfg)
        jb = {k: jnp.asarray(v) for k, v in _ssm_batch(jcfg).items()}
        loss, grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, jb))(jax.tree.map(jnp.asarray, jp))
        _JAX_GRADS[arch] = (float(loss), _flat(jax.tree.map(np.asarray, grads)))
    return _JAX_GRADS[arch]


# Per-leaf gradient bars, relative to the leaf's largest entry. mamba2
# SMOKE agrees to 1e-4 as phi3 does. recurrentgemma SMOKE is
# ill-conditioned in fp32: sqrt(1 - a^2) cancels for decays near 1, and
# both packages' fp32 gradients are about 5e-3 of a leaf's largest
# entry away from a float64 run of the same model; they agree with each
# other to 6e-4, held here at 1e-3
GRAD_TOL = {"mamba2-1.3b": 1e-4, "recurrentgemma-2b": 1e-3}


class TestSSMLM:
    @pytest.mark.parametrize("arch", SSM_ARCHS)
    @pytest.mark.parametrize("use_pallas", [True, False])
    def test_logits_match_jax(self, arch, use_pallas):
        jcfg, cfg = _pair(arch)
        jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
        jp = _jax_params(jcfg)
        toks = _ssm_batch(cfg)["tokens"]
        want, _ = jlm.forward(jax.tree.map(jnp.asarray, jp), jcfg,
                              jnp.asarray(toks))
        got, _ = lm.forward(bridge.params_from_numpy(jp, cfg, device="cpu"),
                            cfg, torch.from_numpy(toks).long())
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("arch", SSM_ARCHS)
    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_grads_match_jax(self, arch, remat):
        jloss, jg = _jax_loss_and_grads(arch)
        jcfg, cfg = _pair(arch)
        cfg = dataclasses.replace(cfg, remat=remat)
        params = bridge.params_from_numpy(_jax_params(jcfg), cfg, device="cpu")
        leaves = dict(bridge.flatten_with_paths(params))
        for t in leaves.values():
            t.requires_grad_(True)
        tb = {k: torch.from_numpy(v).long()
              for k, v in _ssm_batch(cfg).items()}
        loss = lm.loss_fn(params, cfg, tb)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        np.testing.assert_allclose(loss.item(), jloss, rtol=1e-6)
        assert set(leaves) == set(jg)
        for k, g in zip(leaves, grads):
            err = np.max(np.abs(g.numpy() - jg[k]))
            assert err <= GRAD_TOL[arch] * np.max(np.abs(jg[k])), (k, err)


# ---------------------------------------------------------------------------
# The stacked `blocks/*` leaves: unbound once a forward.
# ---------------------------------------------------------------------------
# (arch, overrides): every case has n_super >= 2; the last adds a tail
STACKED_CASES = {
    "phi3": ("phi3-mini-3.8b", {}),
    "mamba2": ("mamba2-1.3b", {}),
    "granite-h": ("granite-4.0-h-micro", {}),
    "phi3-tail": ("phi3-mini-3.8b", dict(pattern=("local_attn", "attn"),
                                         window_size=5, num_layers=5)),
}


def _indexed_loss(params, cfg, batch):
    """`lm.loss_fn` with every stacked leaf indexed once a layer
    (`tree[i]` inside the block), the forward's former way."""
    x = lm._embed(params, cfg, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32)

    def block(h, i):
        return lm._apply_block(cfg.pattern,
                               lm._layer_slice(params["blocks"], i), h, cfg,
                               None)

    for i in range(cfg.n_super):
        if cfg.remat:
            x, a = torch.utils.checkpoint.checkpoint(block, x, i,
                                                     use_reentrant=False)
        else:
            x, a = block(x, i)
        aux = aux + a
    if cfg.tail_pattern:
        x, a = lm._apply_block(cfg.tail_pattern, params["tail"], x, cfg, None)
        aux = aux + a
    logits = lm._logits(params, cfg, x).float()
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold) + 0.01 * aux


def _stacked_case(case, remat, dtype="float32"):
    arch, kw = STACKED_CASES[case]
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **kw,
                              remat=remat, dtype=dtype, param_dtype=dtype)
    assert cfg.n_super >= 2
    params = lm.init_params(cfg, seed=3, device="cpu")
    leaves = dict(bridge.flatten_with_paths(params))
    for t in leaves.values():
        t.requires_grad_(True)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()}
    return cfg, params, leaves, batch


class TestStackedLeaves:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("remat", [False, True])
    @pytest.mark.parametrize("case", list(STACKED_CASES))
    def test_grads_equal_per_layer_indexing(self, case, remat, dtype):
        """Each slice's gradient comes from its own layer alone, so the
        unbound leaves' gradients are the indexed ones bit for bit (up to
        the sign of a zero, which `torch.equal` does not tell)."""
        cfg, params, leaves, batch = _stacked_case(case, remat, dtype)
        loss = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        want_loss = _indexed_loss(params, cfg, batch)
        want = torch.autograd.grad(want_loss, list(leaves.values()))
        assert torch.equal(loss, want_loss)
        for k, g, w in zip(leaves, grads, want):
            assert g.dtype == w.dtype and torch.equal(g, w), k

    @pytest.mark.parametrize("remat", [False, True])
    def test_one_unbind_per_stacked_leaf(self, remat):
        """The backward graph holds one `UnbindBackward0` per `blocks/*`
        leaf and no `SelectBackward0` straight off one."""
        cfg, params, leaves, batch = _stacked_case("granite-h", remat)
        loss = lm.loss_fn(params, cfg, batch)
        stacked = {id(t): k for k, t in leaves.items()
                   if k.startswith("blocks/")}
        unbinds = {k: 0 for k in stacked.values()}
        seen, todo = set(), [loss.grad_fn]
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            nexts = [f for f, _ in node.next_functions]
            todo.extend(nexts)
            inputs = [stacked.get(id(getattr(f, "variable", None)))
                      for f in nexts]
            inputs = [k for k in inputs if k is not None]
            name = type(node).__name__
            assert not (name == "SelectBackward0" and inputs), inputs
            if name == "UnbindBackward0":
                for k in inputs:
                    unbinds[k] += 1
        assert unbinds and set(unbinds.values()) == {1}, unbinds
