"""The port's model stack against the JAX package's on the CPU, at phi3
SMOKE (2 layers, d=64) in fp32: the weight bridge, RMSNorm and RoPE one
by one, and the LM's logits, loss and parameter gradients on the same
weights, with the JAX attention through the Pallas kernel (interpret
mode) and through its chunked path."""
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
from repro_torch import configs
from repro_torch.common import bridge
from repro_torch.comms.payload import UpdatePayload
from repro_torch.models import layers, lm

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

    @pytest.mark.parametrize("kw", [dict(pattern=("mamba2",)),
                                    dict(pattern=("rglru",)),
                                    dict(pattern=("cross_attn",)),
                                    dict(moe=object())])
    def test_unported_families_raise(self, kw):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lm.param_schema(dataclasses.replace(CFG, **kw))
