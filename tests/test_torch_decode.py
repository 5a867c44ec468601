"""The port's decode path against the JAX package's on the CPU, at every
registry config's SMOKE size in fp32: the cache tree of `lm.init_cache`
(keys, shapes, dtypes), 16 steps of `lm.decode_step` (B = 2) with the
logits and every cache leaf held to the JAX package's after each step,
the port's decode against its own forward (teacher forcing), and the
one-token layers one by one: `decode_attention` over a global cache, a
ring buffer that has wrapped and cross-attention keys, `mamba2_decode`
and `rglru_decode`. recurrentgemma SMOKE's window is 8, so its ring
wraps within the 16 steps. The JAX side runs its reference path, as its
own SMOKE configs do; inputs come from numpy seeds and cross as numpy
arrays."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.common.config import CROSS_ATTN
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.common import bridge
from repro_torch.models import layers, lm, ssm

from test_models import make_batch

B, STEPS = 2, 16
# The logits are held at the bars of each config's forward parity
# (tests/test_torch_models.py for phi3, mamba2 and recurrentgemma: 2e-5
# absolute and relative; the other seven, tests/test_torch_families.py:
# 5e-5 of the largest logit). A cache leaf is held at the same number
# times its largest entry, as the mixes' parity is: mamba2 SMOKE's SSM
# state reaches 2.7e3 within 16 steps, where the two packages lie 1.2e-3
# apart (4.5e-7 of it). But recurrentgemma SMOKE's cache leaves are held
# within 1e-3 of their largest entry, its gradient bar: sqrt(1 - a^2)
# cancels for decays near 1 (ROADMAP §3), and each package's fp32 `h`
# lies up to 3.6e-4 of its largest entry from a float64 run of the port,
# the two up to 1.4e-4 apart (its k, v, conv and later `h` leaves up to
# 2.6e-4 and 1.8e-5)
ABS_BAR = {"phi3-mini-3.8b", "mamba2-1.3b", "recurrentgemma-2b"}
FAMILY_TOL = 5e-5
CACHE_TOL = {"recurrentgemma-2b": 1e-3}
# the reference's own decode-against-forward bar (tests/test_models.py)
DECODE_TOL = 2e-3


def _pair(arch):
    return (jconfigs.get_config(arch, smoke=True),
            configs.get_config(arch, smoke=True))


def _flat(tree):
    return dict(bridge.flatten_with_paths(tree))


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jlm.init_params(cfg, jax.random.PRNGKey(seed)))


def _close(arch, got, want, what, logits=False):
    got, want = bridge._to_numpy(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if logits and arch in ABS_BAR:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5,
                                   err_msg=what)
        return
    tol = 2e-5 if arch in ABS_BAR else FAMILY_TOL
    if not logits:
        tol = CACHE_TOL.get(arch, tol)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * np.max(np.abs(want)))


def _fill_cond_kv(cfg, params, cache, cond):
    """A copy of tests/test_models.py::_fill_cond_kv: the cross-attention
    layers' keys and values of `cond`, written into a JAX cache."""
    def fill(cblk, pblk, pattern, stacked):
        for i, kind in enumerate(pattern):
            if kind != CROSS_ATTN:
                continue
            key = f"{i:02d}_{kind}"
            wk, wv = pblk[key]["mix"]["wk"], pblk[key]["mix"]["wv"]
            if stacked:
                cblk[key]["cond_k"] = jnp.einsum("btd,ldnh->lbtnh", cond, wk)
                cblk[key]["cond_v"] = jnp.einsum("btd,ldnh->lbtnh", cond, wv)
            else:
                cblk[key]["cond_k"] = jnp.einsum("btd,dnh->btnh", cond, wk)
                cblk[key]["cond_v"] = jnp.einsum("btd,dnh->btnh", cond, wv)
    if "blocks" in cache:
        fill(cache["blocks"], params["blocks"], cfg.pattern, True)
    if "tail" in cache:
        fill(cache["tail"], params["tail"], cfg.tail_pattern, False)
    return cache


def _inputs(jcfg, jp):
    """make_batch's tokens (or frames) of seed 1, as the reference's decode
    test takes them, and the JAX cache (cond keys and values filled)."""
    batch = make_batch(jcfg, B, STEPS, seed=1)
    cache = jlm.init_cache(jcfg, B, STEPS)
    if jcfg.family == "vlm":
        cache = _fill_cond_kv(jcfg, jax.tree.map(jnp.asarray, jp), cache,
                              batch["cond"])
    return {k: np.array(v) for k, v in batch.items()}, cache


def _torch_tokens(a):
    return (torch.from_numpy(a).long() if a.dtype.kind == "i"
            else torch.from_numpy(a))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("max_len", [5, STEPS])
def test_init_cache_is_the_jax_package_s(arch, max_len):
    """Keys, shapes and dtypes, with a ring shorter than the window when
    max_len is (recurrentgemma SMOKE: window 8)."""
    jcfg, cfg = _pair(arch)
    want = {k: (v.shape, np.dtype(v.dtype).name)
            for k, v in _flat(jlm.init_cache(jcfg, B, max_len)).items()}
    cache = lm.init_cache(cfg, B, max_len, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(cache).items()}
    assert got == want
    assert [k for k, _ in lm.cache_shapes(cfg, B, max_len)] == list(want)
    assert all(not v.any() for v in _flat(cache).values())


def test_init_cache_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(configs.get_config("phi3-mini-3.8b", smoke=True), 1, 4)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decode_steps_match_jax(arch):
    """16 steps from the same weights, tokens and (for vlm) cond keys:
    the logits and every cache leaf after each step. The cache crosses
    the bridge once, before the first step."""
    jcfg, cfg = _pair(arch)
    jp = _jax_params(jcfg)
    batch, jcache = _inputs(jcfg, jp)
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                                    B, STEPS, device="cpu")
    params = bridge.params_from_numpy(jp, cfg, device="cpu")
    toks = batch["tokens"]
    jstep = jax.jit(lambda p, t, pos, c: jlm.decode_step(p, jcfg, t, pos, c))
    jpj = jax.tree.map(jnp.asarray, jp)
    for t in range(STEPS):
        pos = np.full((B,), t, np.int32)
        jlogits, jcache = jstep(jpj, jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(pos), jcache)
        logits, cache = lm.decode_step(params, cfg,
                                       _torch_tokens(toks[:, t:t + 1]),
                                       torch.from_numpy(pos).long(), cache)
        _close(arch, logits, jlogits, f"{arch} step {t} logits",
               logits=True)
        jflat = _flat(jax.tree.map(np.asarray, jcache))
        for k, leaf in _flat(cache).items():
            _close(arch, leaf, jflat[k], f"{arch} step {t} cache {k}")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decode_matches_forward(arch):
    """The port's teacher-forced decode against the port's forward, within
    the reference's own 2e-3 (tests/test_models.py)."""
    jcfg, cfg = _pair(arch)
    jp = _jax_params(jcfg)
    batch, jcache = _inputs(jcfg, jp)
    params = bridge.params_from_numpy(jp, cfg, device="cpu")
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                                    B, STEPS, device="cpu")
    toks = _torch_tokens(batch["tokens"])
    cond = (torch.from_numpy(batch["cond"]) if "cond" in batch else None)
    with torch.no_grad():
        full, _ = lm.forward(params, cfg, toks, cond=cond)
    outs = []
    for t in range(STEPS):
        logits, cache = lm.decode_step(params, cfg, toks[:, t:t + 1],
                                       torch.full((B,), t), cache)
        outs.append(logits[:, 0])
    err = (torch.stack(outs, dim=1) - full).abs().max().item()
    assert err < DECODE_TOL, f"{arch}: decode/forward mismatch {err}"


# ---------------------------------------------------------------------------
# The one-token layers.
# ---------------------------------------------------------------------------
# phi3 SMOKE with GQA (2 kv heads), a softcap, QKV biases and a window of
# 8 for the ring
ATTN_CFG = dict(num_kv_heads=2, logit_softcap=8.0, qkv_bias=True,
                window_size=8)


def _t(a):
    return bridge._to_tensor(np.asarray(a))


@pytest.mark.parametrize("kind,pos", [
    ("attn", [3, 11]),            # rows at other positions
    ("local_attn", [5, 13]),      # one row before the ring wraps, one after
    ("local_attn", [8, 21]),      # the first wrap, and a second lap
    ("cross_attn", [0, 7])])
def test_decode_attention_matches_jax(kind, pos):
    jcfg = dataclasses.replace(jconfigs.get_config("phi3-mini-3.8b",
                                                   smoke=True), **ATTN_CFG)
    cfg = dataclasses.replace(configs.get_config("phi3-mini-3.8b",
                                                 smoke=True), **ATTN_CFG)
    rng = np.random.RandomState(30)
    d, nq, nk, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    p = {"wq": rng.randn(d, nq, h) / 8, "wk": rng.randn(d, nk, h) / 8,
         "wv": rng.randn(d, nk, h) / 8, "wo": rng.randn(nq, h, d) / 8,
         "bq": rng.randn(nq, h) / 4, "bk": rng.randn(nk, h) / 4,
         "bv": rng.randn(nk, h) / 4}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(B, 1, d).astype(np.float32)
    L = 8 if kind == "local_attn" else 16
    kv = {n: rng.randn(B, L, nk, h).astype(np.float32) for n in "kv"}
    posn = np.asarray(pos, np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if kind == "cross_attn":
        want, _ = jlayers.decode_attention(
            jp, jnp.asarray(x), jcfg, kind=kind, cache=None,
            pos=jnp.asarray(posn),
            cond_kv={n: jnp.asarray(v) for n, v in kv.items()})
        got, _ = layers.decode_attention(
            tp, torch.from_numpy(x), cfg, kind=kind, cache=None,
            pos=torch.from_numpy(posn).long(),
            cond_kv={n: torch.from_numpy(v) for n, v in kv.items()})
    else:
        want, jnew = jlayers.decode_attention(
            jp, jnp.asarray(x), jcfg, kind=kind,
            cache={n: jnp.asarray(v) for n, v in kv.items()},
            pos=jnp.asarray(posn))
        cache = {n: torch.from_numpy(v.copy()) for n, v in kv.items()}
        got, new = layers.decode_attention(
            tp, torch.from_numpy(x), cfg, kind=kind, cache=cache,
            pos=torch.from_numpy(posn).long())
        assert new is cache          # written in place, returned as given
        for n in "kv":
            np.testing.assert_allclose(new[n].numpy(), np.asarray(jnew[n]),
                                       atol=2e-6, rtol=2e-6)
    scale = np.max(np.abs(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("arch,kind", [("mamba2-1.3b", "00_mamba2"),
                                       ("recurrentgemma-2b", "00_rglru")])
def test_ssm_decode_matches_jax(arch, kind):
    """One step from a random state: the output and the new conv and
    recurrent states."""
    jcfg, cfg = _pair(arch)
    jp = {k: v[0] for k, v in _jax_params(jcfg)["blocks"][kind]["mix"].items()}
    rng = np.random.RandomState(31)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    if kind == "00_mamba2":
        jfn, fn = jssm.mamba2_decode, ssm.mamba2_decode
        zero = ssm.mamba2_init_state(cfg, B, torch.float32, "cpu")
        jzero = jssm.mamba2_init_state(jcfg, B, jnp.float32)
    else:
        jfn, fn = jssm.rglru_decode, ssm.rglru_decode
        zero = ssm.rglru_init_state(cfg, B, torch.float32, "cpu")
        jzero = jssm.rglru_init_state(jcfg, B, jnp.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in zero.items()} == \
        {k: (v.shape, _t(np.asarray(v)).dtype) for k, v in jzero.items()}
    state = {k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
             for k, v in zero.items()}
    want, jnew = jfn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg,
                     {k: jnp.asarray(v) for k, v in state.items()})
    got, new = fn({k: _t(v) for k, v in jp.items()}, torch.from_numpy(x),
                  cfg, {k: torch.from_numpy(v) for k, v in state.items()})
    scale = np.max(np.abs(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5 * scale, rtol=0)
    for k in state:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   atol=2e-5, rtol=2e-5, err_msg=k)
