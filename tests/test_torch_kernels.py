"""The port's kernel modules against the JAX package's, on the CPU: the
flash-attention op (plain version, gradients through its recompute
backward) against the Pallas kernel in interpret mode and its reference,
the int8 codec bit for bit against both JAX paths, the SSD scan against
the Pallas kernel in interpret mode, `ssd_reference` and a sequential
recurrence (gradients against `jax.vjp` of `ssd_reference`), and the
RG-LRU scan against the Pallas kernel and `rglru_scan_ref` (its
backward, and the fused backward's plain version, against `jax.vjp` of
`rglru_scan_ref`; the one-pass kernel's blocking emulated in plain
PyTorch against a float64 loop). The bf16
tensor-core flash kernel's arithmetic (key tiles in order, P as bf16 hi
+ lo) and the bf16 tensor-core SSD kernel's (128-row pieces, 64-row
tiles in order, M, the state and dec x as bf16 hi + lo) are emulated in
plain PyTorch and held to JAX's fp32 reference at one bf16 rounding, as
is the bf16 SSD backward kernel's (its forward sweep of entry states,
its reverse sweep, and its seven fp32 operands as bf16 hi + lo) against
`jax.vjp`, and the wrappers' layout checks, the SSD routes and the
backward's meta and CPU branches are tested on CPU tensors.

On the CPU each wrapper runs its plain version; the CUDA kernels are
held to the same plain versions on the card (`chip_smoke.py` and
`tests/test_torch_cuda.py`). Inputs come from numpy seeds and cross as
numpy arrays."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import reference_attention as jax_ref
from repro.kernels.grad_quant import ops as jgq
from repro.kernels.rglru.ops import rglru_scan as jax_rglru
from repro.kernels.rglru.ref import rglru_scan_ref as jax_rglru_ref
from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.models.ssm import ssd_reference as jax_ssd_ref
from repro_torch.common.bridge import _to_numpy, _to_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.grad_quant import ops as gq
from repro_torch.kernels.rglru import ops as rg
from repro_torch.kernels.ssd import ops as sd


def _fold(x):
    B, S, N, H = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * N, S, H)


def _unfold(x, B, N):
    return x.reshape(B, N, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _qkv(rng, B, S, N, H, dtype, scale=1.0):
    arrs = [(rng.randn(B, S, N, H) * scale).astype(np.float32)
            for _ in range(3)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [_to_tensor(np.asarray(a)) for a in jx]
    return jx, tx


# (S, H, dtype, window, softcap, input scale, tolerance): the sweep of
# tests/test_kernels.py — the bars are the reference's own, 2e-5 in fp32,
# 2e-2 in bf16, 3e-5 with the softcap's larger inputs
FLASH_CASES = [
    (128, 32, jnp.float32, None, None, 1.0, 2e-5),
    (256, 64, jnp.float32, None, None, 1.0, 2e-5),
    (128, 64, jnp.bfloat16, None, None, 1.0, 2e-2),
    (512, 128, jnp.float32, None, None, 1.0, 2e-5),
    (256, 32, jnp.float32, 32, None, 1.0, 2e-5),
    (256, 32, jnp.float32, 128, None, 1.0, 2e-5),
    (128, 32, jnp.float32, None, 10.0, 3.0, 3e-5),
    # head dim 8, which the fp32 kernel has an instance for: the SMOKE
    # configs with d_model 64 over 8 heads
    (128, 8, jnp.float32, None, None, 1.0, 2e-5),
    (200, 8, jnp.float32, 64, 10.0, 3.0, 3e-5),
]


class TestFlashAttention:
    @pytest.mark.parametrize("S,H,dtype,window,softcap,scale,tol",
                             FLASH_CASES)
    def test_matches_pallas_and_reference(self, S, H, dtype, window,
                                          softcap, scale, tol):
        rng = np.random.RandomState(S + H + (window or 0))
        B, N = 2, 2
        (jq, jk, jv), (tq, tk, tv) = _qkv(rng, B, S, N, H, dtype, scale)
        out = _to_numpy(fa.flash_attention(tq, tk, tv, window=window,
                                           softcap=softcap)).astype(np.float32)
        # the JAX op at its default blocks (block_q = min(512, S))
        pallas = jax_flash(jq, jk, jv, window=window, softcap=softcap,
                           interpret=True)
        ref = _unfold(jax_ref(_fold(jq), _fold(jk), _fold(jv),
                              window=window, softcap=softcap), B, N)
        for want in (pallas, ref):
            np.testing.assert_allclose(out, np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)

    @pytest.mark.parametrize("window,softcap", [(None, None), (48, 5.0)])
    def test_gradients_match_jax_vjp(self, window, softcap):
        rng = np.random.RandomState(3)
        B, S, N, H = 1, 128, 2, 32
        (jq, jk, jv), (tq, tk, tv) = _qkv(rng, B, S, N, H, jnp.float32)
        g = rng.randn(B, S, N, H).astype(np.float32)

        def f(q, k, v):
            return jax_flash(q, k, v, window=window, softcap=softcap,
                             interpret=True)

        _, vjp = jax.vjp(f, jq, jk, jv)
        want = vjp(jnp.asarray(g))
        qkv = [t.requires_grad_() for t in (tq, tk, tv)]
        out = fa.flash_attention(*qkv, window=window, softcap=softcap)
        got = torch.autograd.grad(out, qkv, torch.from_numpy(g))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=3e-4, rtol=3e-4)

    def test_head_dims_by_dtype(self):
        """The fp32 kernel takes head dim 8 as well; bf16 at 8 raises (a
        wgmma K step is 16, and no config sends it)."""
        for H in fa.FP32_HEAD_DIMS:
            fa.check_head_dim(H, torch.float32)
        assert 8 in fa.FP32_HEAD_DIMS and 8 not in fa.HEAD_DIMS
        for H, dtype in [(8, torch.bfloat16), (48, torch.float32),
                         (4, torch.float32)]:
            with pytest.raises(ValueError, match="head dim"):
                fa.check_head_dim(H, dtype)

    def test_cpu_tensors_take_the_plain_version(self):
        rng = np.random.RandomState(4)
        _, (tq, tk, tv) = _qkv(rng, 1, 64, 2, 16, jnp.float32)
        before = fa.flash_attention_fwd.launches
        out = fa.flash_attention(tq, tk, tv)
        torch.testing.assert_close(out, fa.flash_attention_plain(tq, tk, tv),
                                   atol=0, rtol=0)
        assert fa.flash_attention_fwd.launches == before


def _sm90_arithmetic(q, k, v, window, softcap, tile=64):
    """The bf16 tensor-core kernel's arithmetic in plain PyTorch on the
    CPU: key tiles of 64 in order, scores in the log2 domain, an online
    softmax in fp32, P entering P.V as bf16 hi + bf16 lo with fp32 sums,
    one bf16 rounding of the output. q: (BN, S, H), k, v: (BN, T, H)."""
    q, k, v = q.float(), k.float(), v.float()
    S, H, T = q.shape[1], q.shape[2], k.shape[1]
    log2e = 1.4426950408889634
    qpos = torch.arange(S)[:, None]
    m = torch.full((q.shape[0], S, 1), -1e30)
    l = torch.zeros(q.shape[0], S, 1)
    o = torch.zeros(q.shape[0], S, H)
    for k0 in range(0, T, tile):
        s = q @ k[:, k0:k0 + tile].transpose(1, 2)
        if softcap is None:
            s = s * (1.0 / math.sqrt(H) * log2e)
        else:
            s = softcap * torch.tanh(s * (1.0 / math.sqrt(H)) / softcap) * log2e
        kpos = torch.arange(k0, min(k0 + tile, T))[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        vt = v[:, k0:k0 + tile]
        o = o * alpha + hi @ vt + lo @ vt
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return (o / l.clamp_min(1e-30)).to(torch.bfloat16)


class TestTensorCoreFlashArithmetic:
    """What the bf16 kernel computes, on the CPU; the kernel itself is held
    to the same bar on the card (tests/test_torch_cuda.py)."""

    @pytest.mark.parametrize("S,H,window,softcap", [
        (200, 64, None, None), (333, 96, 100, None), (130, 32, None, 10.0),
        (77, 16, 32, None)])
    def test_hi_lo_p_rounds_once_against_jax_reference(self, S, H, window,
                                                        softcap):
        """P carried as bf16 hi + lo keeps the output within one bf16
        rounding of JAX's fp32 reference on the same bf16 inputs."""
        rng = np.random.RandomState(S + H)
        jx, _ = _qkv(rng, 1, S, 2, H, jnp.bfloat16)
        # the bf16 inputs, exactly, in fp32 and folded to (BN, S, H)
        q, k, v = (_fold(np.asarray(x, np.float32)) for x in jx)
        got = _sm90_arithmetic(*(torch.from_numpy(x) for x in (q, k, v)),
                               window, softcap)
        want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  softcap=softcap))
        err = np.abs(got.float().numpy() - want)
        bar = 2.0 ** -8 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert (err <= bar).all(), (err / bar).max()

    @pytest.mark.parametrize("make,ready", [
        (lambda: torch.zeros(2, 64, 3, 96, dtype=torch.bfloat16), True),
        (lambda: torch.zeros(2, 64, 3, 3 * 96,
                             dtype=torch.bfloat16)[..., 96:192], True),
        (lambda: torch.zeros(2 * 64 * 3 * 16 + 1,
                             dtype=torch.bfloat16)[1:].view(2, 64, 3, 16),
         False),
        (lambda: torch.zeros(2, 3, 64, 32,
                             dtype=torch.bfloat16).transpose(1, 2), True),
        (lambda: torch.zeros(2, 64, 1, 36,
                             dtype=torch.bfloat16)[..., :32], False),
        (lambda: torch.zeros(1, 64, 1, 32, dtype=torch.bfloat16)
         .as_strided((1, 64, 1, 32), (5, 32, 3, 1)), True),
        (lambda: torch.zeros(2, 64, 1, 32,
                             dtype=torch.bfloat16).expand(2, 64, 4, 32),
         False),
        (lambda: torch.zeros(2, 64, 3, 32,
                             dtype=torch.bfloat16).transpose(2, 3), False)])
    def test_tma_ready_layouts(self, make, ready):
        """Which layouts the tensor maps take as they lie (a 16-byte base,
        H contiguous, other strides multiples of 16 bytes; a size-1 dim's
        stride never counts) and which the wrapper copies first."""
        assert fa.tma_ready(make()) is ready


class TestBuild:
    def test_library_name_follows_the_included_headers(self, tmp_path):
        """A library is named after its source and every header it
        includes with quotes, directly or through another header, so an
        edited header rebuilds it."""
        (tmp_path / "csrc").mkdir()
        src = tmp_path / "csrc" / "k.cu"
        src.write_text('#include <cuda.h>\n#include "../h.cuh"\n')
        hdr, inner = tmp_path / "h.cuh", tmp_path / "g.cuh"
        hdr.write_text('#pragma once\n  #  include "g.cuh"\n')
        inner.write_text("int a;\n")
        assert _build._headers(src) == [hdr.resolve(), inner.resolve()]
        before = _build._library_path(src)
        assert _build._library_path(src) == before
        inner.write_text("int b;\n")
        assert _build._library_path(src) != before

    def test_tensor_core_sources_share_one_header(self):
        for stem in ("flash_attention_fwd_sm90", "ssd_fwd_sm90",
                     "ssd_bwd_sm90"):
            headers = _build._headers(_build.sources()[stem])
            assert [h.name for h in headers] == ["sm90.cuh"]


def _tie_row():
    """One block whose amax is 127, so scale == 1 and x/scale lands on
    exact halves: round half to even must give 2, 4, -2, -4, 0, 0."""
    x = np.zeros(gq.BLOCK, np.float32)
    x[:7] = [127.0, 2.5, 3.5, -2.5, -3.5, 0.5, -0.5]
    return x


class TestGradQuant:
    def test_block_matches_jax(self):
        assert gq.BLOCK == jgq.BLOCK

    @pytest.mark.parametrize("shape,scale", [
        ((100,), 0.01), ((3, 1000), 0.01), ((17, 65, 5), 0.01),
        ((5000,), 1.0), ((2, 2048), 1e-3), ((4096 * 3 + 7,), 30.0)])
    def test_bit_equal_to_both_jax_paths(self, shape, scale):
        rng = np.random.RandomState(sum(shape))
        x = (rng.randn(*shape) * scale).astype(np.float32)
        q, s = gq.quantize(torch.from_numpy(x))
        for use_pallas in (True, False):
            jq, js = jgq.quantize(jnp.asarray(x), use_pallas=use_pallas)
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            back = gq.dequantize(q, s, shape, torch.float32)
            jback = jgq.dequantize(jq, js, shape, jnp.float32,
                                   use_pallas=use_pallas)
            np.testing.assert_array_equal(back.numpy(), np.asarray(jback))

    def test_round_half_to_even_ties(self):
        x = _tie_row()
        q, s = gq.quantize(torch.from_numpy(x))
        assert s.item() == 1.0
        assert q[0, :7].tolist() == [127, 2, 4, -2, -4, 0, 0]
        jq, _ = jgq.quantize(jnp.asarray(x), use_pallas=True)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))

    def test_dequantize_to_bf16(self):
        rng = np.random.RandomState(6)
        x = rng.randn(4, 3333).astype(np.float32)
        q, s = gq.quantize(torch.from_numpy(x))
        got = gq.dequantize(q, s, (4, 3333), torch.bfloat16)
        jq, js = jgq.quantize(jnp.asarray(x))
        want = jgq.dequantize(jq, js, (4, 3333), jnp.bfloat16)
        np.testing.assert_array_equal(_to_numpy(got).view(np.uint16),
                                      np.asarray(want).view(np.uint16))


def _rel(got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    return np.max(np.abs(np.asarray(got, np.float64) - want)) / (
        np.max(np.abs(want)) + 1e-30)


def _ssd_arrays(rng, b, s, h, p, n, g=None, la_scale=0.1):
    """x, log decay and per-group B, C (g groups; g = h: one per head)."""
    g = g or h
    return (rng.randn(b, s, h, p).astype(np.float32) * 0.5,
            (-np.abs(rng.randn(b, s, h)) * la_scale).astype(np.float32),
            rng.randn(b, s, g, n).astype(np.float32) * 0.3,
            rng.randn(b, s, g, n).astype(np.float32) * 0.3)


def _heads(t, h):
    return np.repeat(t, h // t.shape[2], axis=2)


def _port_ssd(x, la, B, C, chunk):
    y, state = sd.ssd(*(torch.from_numpy(a) for a in (x, la, B, C)),
                      chunk=chunk)
    assert state is None
    return y.numpy()


def _sequential_ssd(x, la, B, C):
    """Independent O(S) oracle in float64: h_t = a_t h_{t-1} + B_t x_t,
    y_t = C_t . h_t (B, C per head)."""
    b, s, h, p = x.shape
    st = np.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(s):
        st = (np.exp(la[:, t].astype(np.float64))[..., None, None] * st
              + np.einsum("bhp,bhn->bhpn", x[:, t], B[:, t]))
        ys.append(np.einsum("bhpn,bhn->bhp", st, C[:, t]))
    return np.stack(ys, axis=1)


class TestSSD:
    # the cases of tests/test_kernels.py, at the reference's 1e-5 bar
    # relative to the largest output
    @pytest.mark.parametrize("s,p,n,chunk", [
        (64, 16, 16, 16), (128, 32, 64, 32), (256, 64, 128, 64)])
    def test_matches_pallas_and_reference(self, s, p, n, chunk):
        rng = np.random.RandomState(s + p)
        x, la, B, C = _ssd_arrays(rng, 2, s, 3, p, n)
        got = _port_ssd(x, la, B, C, chunk)
        pallas, _ = jax_ssd(x, la, B, C, chunk=chunk, interpret=True)
        ref, _ = jax_ssd_ref(x, la, B, C, chunk=chunk)
        for want in (pallas, ref):
            assert _rel(got, want) < 1e-5

    def test_two_groups_read_per_group(self):
        """B and C per group (4 heads, 2 groups) against the JAX paths fed
        the per-head repeat that `mamba2_mix` makes."""
        rng = np.random.RandomState(7)
        x, la, B, C = _ssd_arrays(rng, 2, 64, 4, 16, 16, g=2)
        got = _port_ssd(x, la, B, C, 16)
        Bh, Ch = _heads(B, 4), _heads(C, 4)
        pallas, _ = jax_ssd(x, la, Bh, Ch, chunk=16, interpret=True)
        ref, _ = jax_ssd_ref(x, la, Bh, Ch, chunk=16)
        for want in (pallas, ref):
            assert _rel(got, want) < 1e-5

    def test_ragged_sequence(self):
        """S = 100 is no multiple of the chunk (the Pallas kernel asserts
        one); held to the JAX reference in one chunk and to the
        sequential recurrence."""
        rng = np.random.RandomState(8)
        x, la, B, C = _ssd_arrays(rng, 1, 100, 2, 8, 16)
        got = _port_ssd(x, la, B, C, 32)
        ref, _ = jax_ssd_ref(x, la, B, C, chunk=100)
        assert _rel(got, ref) < 1e-5
        assert _rel(got, _sequential_ssd(x, la, B, C)) < 1e-5

    def test_vs_sequential_recurrence(self):
        rng = np.random.RandomState(11)
        x, la, B, C = _ssd_arrays(rng, 1, 64, 2, 8, 8, la_scale=0.2)
        got = _port_ssd(x, la, B, C, 16)
        assert _rel(got, _sequential_ssd(x, la, B, C)) < 1e-5

    def test_chunk_invariance(self):
        rng = np.random.RandomState(12)
        args = _ssd_arrays(rng, 1, 128, 1, 8, 8)
        assert _rel(_port_ssd(*args, 16), _port_ssd(*args, 64)) < 1e-5

    def test_final_state_matches_jax_reference(self):
        rng = np.random.RandomState(13)
        x, la, B, C = _ssd_arrays(rng, 2, 48, 2, 8, 16)
        _, got = sd.ssd_plain(*(torch.from_numpy(a) for a in (x, la, B, C)),
                              chunk=16)
        _, want = jax_ssd_ref(x, la, B, C, chunk=16)
        assert _rel(got.numpy(), want) < 1e-5

    @pytest.mark.parametrize("g", [1, 2])
    def test_gradients_match_jax_vjp(self, g):
        rng = np.random.RandomState(14 + g)
        h, chunk = 4, 16
        x, la, B, C = _ssd_arrays(rng, 2, 64, h, 16, 16, g=g)
        gy = rng.randn(*x.shape).astype(np.float32)

        def f(x, la, B, C):
            return jax_ssd_ref(x, la, jnp.repeat(B, h // g, axis=2),
                               jnp.repeat(C, h // g, axis=2), chunk=chunk)[0]

        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, la, B, C)))
        want = vjp(jnp.asarray(gy))
        ins = [torch.from_numpy(a).requires_grad_() for a in (x, la, B, C)]
        y, _ = sd.ssd(*ins, chunk=chunk)
        got = torch.autograd.grad(y, ins, torch.from_numpy(gy))
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert _rel(a.numpy(), b) < 1e-5

    def test_cpu_tensors_take_the_plain_version(self):
        rng = np.random.RandomState(15)
        ins = [torch.from_numpy(a) for a in _ssd_arrays(rng, 1, 32, 2, 8, 16)]
        before = sd.ssd_fwd.launches
        y, _ = sd.ssd(*ins, chunk=8)
        torch.testing.assert_close(y, sd.ssd_plain(*ins, chunk=8)[0],
                                   atol=0, rtol=0)
        assert sd.ssd_fwd.launches == before


def _hi_lo(t, lo=True):
    """t as bf16 hi + bf16 lo (or hi alone), summed back in fp32."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float() if lo else hi


def _ssd_sm90_arithmetic(x, la, B, C, split=("m", "state", "decx"),
                         piece=128, tile=64):
    """The bf16 tensor-core SSD kernel's arithmetic in plain PyTorch on
    the CPU: pieces of 128 rows whatever the chunk, the cumulative log
    decay per piece, Y = exp(cs_i) C state^T + sum over 64-row tiles in
    order of M x_t, M = (C B_t^T) o exp(cs_i - cs_j) where j <= i, state
    <- exp(cs_end) state + (dec x)^T B, fp32 sums, one bf16 rounding of
    y. The operands named in `split` (M, the state, dec x) enter their
    products as bf16 hi + lo, the others as bf16 hi alone. x, B and C:
    fp32 holding bf16 values, B and C per head."""
    b, s, h, p = x.shape
    y = torch.zeros(b, s, h, p)
    state = torch.zeros(b, h, p, B.shape[-1])
    for r0 in range(0, s, piece):
        xs, Bs, Cs = (t[:, r0:r0 + piece].transpose(1, 2) for t in (x, B, C))
        cs = torch.cumsum(la[:, r0:r0 + piece].transpose(1, 2), -1)
        q = cs.shape[-1]
        st = _hi_lo(state, "state" in split)
        yp = (Cs @ st.transpose(-1, -2)) * torch.exp(cs)[..., None]
        i = torch.arange(q)[:, None]
        for t0 in range(0, q, tile):
            ok = torch.arange(t0, min(t0 + tile, q))[None, :] <= i
            seg = torch.where(
                ok, cs[..., :, None] - cs[..., None, t0:t0 + tile], 0.0)
            s_t = Cs @ Bs[:, :, t0:t0 + tile].transpose(-1, -2)
            m = torch.where(ok, s_t * torch.exp(seg), 0.0)
            yp = yp + _hi_lo(m, "m" in split) @ xs[:, :, t0:t0 + tile]
        cs_end = cs[..., -1]
        dx = _hi_lo(torch.exp(cs_end[..., None] - cs)[..., None] * xs,
                    "decx" in split)
        state = (state * torch.exp(cs_end)[..., None, None]
                 + dx.transpose(-1, -2) @ Bs)
        y[:, r0:r0 + piece] = yp.transpose(1, 2)
    return y.to(torch.bfloat16)


def _ssd_bf16_case(la_scale):
    """b=1, s=520 (four pieces and a ragged one), 4 heads x 64, one
    group of 128: the emulation's inputs (bf16 values in fp32, B and C
    per head) and JAX's fp32 reference on them at chunk 256."""
    rng = np.random.RandomState(20)
    x, la, B, C = _ssd_arrays(rng, 1, 520, 4, 64, 128, g=1, la_scale=la_scale)
    x, B, C = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in (x, B, C))
    B, C = _heads(B, 4), _heads(C, 4)
    want, _ = jax_ssd_ref(x, la, B, C, chunk=256)
    return [torch.from_numpy(a) for a in (x, la, B, C)], np.asarray(want)


def _share_of_bar(got, want):
    """The worst element's |error| over the one-rounding bar, and how
    many elements lie over it."""
    err = np.abs(got.float().numpy() - want)
    bar = 2.0 ** -8 * np.abs(want) + 1e-5 * np.abs(want).max()
    return (err / bar).max(), int((err > bar).sum())


class TestTensorCoreSSDArithmetic:
    """What the bf16 SSD kernel computes, on the CPU; the kernel itself is
    held to the same bar on the card (tests/test_torch_cuda.py)."""

    @pytest.mark.parametrize("la_scale", [0.1, 1.0])
    def test_hi_lo_operands_round_once_against_jax_reference(self, la_scale):
        """M, the state and dec x each carried as bf16 hi + lo keep the
        output within one bf16 rounding of JAX's fp32 reference on the
        same bf16 inputs, at weak and at mamba2-like decays."""
        ins, want = _ssd_bf16_case(la_scale)
        worst, over = _share_of_bar(_ssd_sm90_arithmetic(*ins), want)
        assert over == 0, worst

    @pytest.mark.parametrize("hi_only", ["m", "state", "decx"])
    def test_one_operand_as_hi_alone_breaks_the_bar(self, hi_only):
        """Rounding any one of the three fp32 operands once to bf16 puts
        outputs over the one-rounding bar: each needs its lo term."""
        ins, want = _ssd_bf16_case(0.1)
        split = tuple(o for o in ("m", "state", "decx") if o != hi_only)
        worst, over = _share_of_bar(_ssd_sm90_arithmetic(*ins, split=split),
                                    want)
        assert over > 0 and worst > 2, (worst, over)

    def test_pieces_do_not_depend_on_the_chunk(self):
        """The kernel ignores the chunk: its 128-row pieces against the
        reference at chunks of 104, 260 and 520 rows (chunks that divide
        s, as the JAX reference needs), every operand split."""
        ins, _ = _ssd_bf16_case(1.0)
        got = _ssd_sm90_arithmetic(*ins, piece=128).float().numpy()
        for chunk in (104, 260, 520):
            want, _ = jax_ssd_ref(*(a.numpy() for a in ins), chunk=chunk)
            worst, over = _share_of_bar(torch.from_numpy(got),
                                        np.asarray(want))
            assert over == 0, (chunk, worst)

    @pytest.mark.parametrize("dtype,p,stem", [
        (torch.bfloat16, 64, "ssd_fwd_sm90"),
        (torch.bfloat16, 8, "ssd_fwd_sm90"),
        (torch.bfloat16, 24, "ssd_fwd_sm90"),
        (torch.bfloat16, 128, "ssd_fwd_sm90"),
        (torch.bfloat16, 20, "ssd_fwd"), (torch.bfloat16, 136, "ssd_fwd"),
        (torch.float32, 64, "ssd_fwd"), (torch.float32, 128, "ssd_fwd")])
    def test_route_by_dtype_and_head_dim(self, dtype, p, stem):
        """bf16 with p a multiple of 8 up to 128 goes to the tensor-core
        kernel; fp32 and other bf16 head dims to the CUDA-core kernel."""
        assert sd.route(dtype, p) == stem

    def test_mamba2_mix_hands_over_tma_ready_views(self, monkeypatch):
        """At mamba2-1.3b's width, `mamba2_mix` hands the op B and C as
        views of the convolution's output, 256 bytes apart at a row stride
        of 8704 bytes, and x as a fresh tensor: all as TMA takes them, so
        the main path makes no copy."""
        from repro_torch import configs
        from repro_torch.models import ssm

        cfg = configs.get_config("mamba2-1.3b")
        seen = {}

        def capture(xbar, log_a, Bm, Cm, *, chunk):
            seen.update(x=xbar, B=Bm, C=Cm, chunk=chunk)
            return torch.zeros_like(xbar), None

        monkeypatch.setattr(ssm.ssd_ops, "ssd", capture)
        params = {k: torch.zeros(spec.shape,
                                 dtype=spec.dtype or cfg.param_torch_dtype)
                  for k, spec in ssm.mamba2_schema(cfg).items()}
        x = torch.zeros(1, 4, cfg.d_model, dtype=cfg.activation_dtype)
        ssm.mamba2_mix(params, x, cfg)
        xb, B, C = seen["x"], seen["B"], seen["C"]
        assert xb.dtype == B.dtype == C.dtype == torch.bfloat16
        assert sd.route(xb.dtype, xb.shape[-1]) == "ssd_fwd_sm90"
        assert all(sd.tma_ready(t) for t in (xb, B, C))
        assert B.stride(1) * 2 == C.stride(1) * 2 == 8704
        assert C.data_ptr() - B.data_ptr() == 256
        assert B.shape == C.shape == (1, 4, 1, 128)


# the backward kernel's fp32 operands that enter a product as bf16 hi +
# lo: M^T (for dx), P^T (dB), P (dC), dS (dx, dB), the entry state S
# (dC), e o gy (the dS update) and dec o x (the forward sweep's states)
BWD_SPLITS = ("mt", "pt", "p", "ds", "s", "egy", "decx")


def _ssd_bwd_sm90_arithmetic(x, la, B, C, gy, split=BWD_SPLITS, piece=128,
                             cols=64):
    """The bf16 tensor-core SSD backward kernel's arithmetic in plain
    PyTorch on the CPU. Per (batch, head, 64 columns of p): a forward
    sweep of 128-row pieces keeps each piece's entry state S (the
    forward's state update); a reverse sweep carries dS, the state's
    gradient after the piece, and per piece forms dx = dec o (B dS^T) +
    M^T gy, dB = dec o (x dS) + P^T C, dC = e o (gy S) + P B, with M =
    (C B^T) o E, P = (gy x^T) o E, E_ij = exp(cs_i - cs_j) for j <= i;
    dcs = T's row sums less its column sums off the diagonal (T = M o gy
    x^T) + C . (e o gy S) - B . (dec o x dS), plus <dS, S_next> at the
    last row; dlog_a its reverse cumulative sum; then dS <- exp(cs_end)
    dS + (e o gy)^T C. dB and dC are summed over a group's heads and
    column blocks in fp32, then dx, dB, dC rounded to bf16 once. The
    operands named in `split` enter their products as bf16 hi + lo, the
    others as bf16 hi alone; with `split` None nothing is rounded (and
    nothing is rounded at the end: the algorithm in fp32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rnd = ((lambda name, t: t) if split is None
           else (lambda name, t: _hi_lo(t, name in split)))
    npc, halves = -(-s // piece), -(-p // cols)
    pad = npc * piece - s

    def padded(t, width=None):
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t if width is None else torch.nn.functional.pad(
            t, (0, width - t.shape[-1]))

    xs, gys = padded(x, halves * cols), padded(gy, halves * cols)
    Bs, Cs = padded(B), padded(C)
    las = torch.nn.functional.pad(la, (0, 0, 0, pad))
    dx = torch.zeros(b, npc * piece, h, halves * cols)
    dla = torch.zeros(b, npc * piece, h)
    parts = torch.zeros(2, b, npc * piece, h * halves, n)
    idx = torch.arange(piece)
    below = idx[:, None] >= idx[None, :]                # [i, j]: j <= i
    strict = idx[:, None] > idx[None, :]
    for hh in range(h * halves):
        head, half = divmod(hh, halves)
        grp = head // (h // g)
        c0 = half * cols
        X, GY = xs[:, :, head, c0:c0 + cols], gys[:, :, head, c0:c0 + cols]
        Bh, Ch, L = Bs[:, :, grp], Cs[:, :, grp], las[:, :, head]
        states, st = [], torch.zeros(b, cols, n)
        for c in range(npc):
            cs = torch.cumsum(L[:, c * piece:(c + 1) * piece], -1)
            states.append(st)
            dec = torch.exp(cs[:, -1:] - cs)
            st = (st * torch.exp(cs[:, -1])[:, None, None]
                  + rnd("decx", dec[..., None]
                        * X[:, c * piece:(c + 1) * piece]).transpose(1, 2)
                  @ Bh[:, c * piece:(c + 1) * piece])
        dS = torch.zeros(b, cols, n)
        for c in reversed(range(npc)):
            rows = slice(c * piece, (c + 1) * piece)
            Xc, Gc, Bc, Cc = X[:, rows], GY[:, rows], Bh[:, rows], Ch[:, rows]
            cs = torch.cumsum(L[:, rows], -1)
            e, dec = torch.exp(cs), torch.exp(cs[:, -1:] - cs)
            end = ((dS * states[c + 1]).sum((1, 2)) if c + 1 < npc
                   else torch.zeros(b))
            dSr, Sr = rnd("ds", dS), rnd("s", states[c])
            E = torch.where(below, torch.exp(torch.where(
                below, cs[:, :, None] - cs[:, None, :], 0.0)), 0.0)
            S_, G_ = Cc @ Bc.transpose(1, 2), Gc @ Xc.transpose(1, 2)
            M, P = S_ * E, G_ * E                       # [i, j]
            T = M * G_
            dxc = (dec[..., None] * (Bc @ dSr.transpose(1, 2))
                   + rnd("mt", M.transpose(1, 2)) @ Gc)
            dBc = dec[..., None] * (Xc @ dSr)
            boff = (Bc * dBc).sum(-1)
            dBc = dBc + rnd("pt", P.transpose(1, 2)) @ Cc
            dCc = e[..., None] * (Gc @ Sr)
            coff = (Cc * dCc).sum(-1)
            dCc = dCc + rnd("p", P) @ Bc
            dcs = (torch.where(strict, T, 0.0).sum(-1)
                   - torch.where(strict, T, 0.0).sum(-2) + coff - boff)
            dcs[:, -1] += end
            dla[:, rows, head] += torch.flip(
                torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
            dx[:, rows, head, c0:c0 + cols] = dxc
            parts[0, :, rows, hh], parts[1, :, rows, hh] = dBc, dCc
            dS = (dS * torch.exp(cs[:, -1])[:, None, None]
                  + rnd("egy", e[..., None] * Gc).transpose(1, 2) @ Cc)
    dB, dC = parts.reshape(2, b, npc * piece, g, -1, n).sum(4)
    out = torch.float32 if split is None else torch.bfloat16
    return (dx[:, :s, :, :p].to(out), dla[:, :s], dB[:, :s].to(out),
            dC[:, :s].to(out))


def _ssd_bwd_case(g, n, la_scale=1.0, bf16=True, s=520, h=4, p=64):
    """b=1, s=520 (four pieces and a ragged one), 4 heads: the inputs (x,
    B, C and gy bf16 values in fp32 where `bf16`) and `jax.vjp` of JAX's
    fp32 reference on them at chunk 260."""
    rng = np.random.RandomState(30 + g + n)
    x, la, B, C = _ssd_arrays(rng, 1, s, h, p, n, g=g, la_scale=la_scale)
    gy = rng.randn(1, s, h, p).astype(np.float32)
    if bf16:
        x, B, C, gy = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                       for a in (x, B, C, gy))

    def f(x, la, B, C):
        return jax_ssd_ref(x, la, jnp.repeat(B, h // g, axis=2),
                           jnp.repeat(C, h // g, axis=2), chunk=s // 2)[0]

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, la, B, C)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(gy))]
    return [torch.from_numpy(a) for a in (x, la, B, C, gy)], want


class TestTensorCoreSSDBackwardArithmetic:
    """What the bf16 SSD backward kernel computes, on the CPU; the kernel
    itself is held to the same bar against the plain recompute on the
    card (`chip_smoke.py`, tests/test_torch_cuda.py)."""

    @pytest.mark.parametrize("g,n", [(1, 16), (1, 128), (2, 16), (2, 128)])
    def test_algorithm_matches_jax_vjp_in_fp32(self, g, n):
        """Its pieces, its forward and reverse sweeps and its dcs, with
        nothing rounded, on fp32 inputs: 1e-5 relative to each gradient's
        largest value, the JAX package's ssd bar."""
        ins, want = _ssd_bwd_case(g, n, bf16=False)
        got = _ssd_bwd_sm90_arithmetic(*ins, split=None)
        for a, w in zip(got, want):
            assert a.shape == w.shape
            assert _rel(a.numpy(), w) < 1e-5

    @pytest.mark.parametrize("g,n,la_scale", [
        (1, 16, 1.0), (1, 128, 1.0), (2, 16, 1.0), (2, 128, 1.0),
        (1, 128, 0.1)])
    def test_hi_lo_operands_round_once_against_jax_vjp(self, g, n, la_scale):
        """Every fp32 operand as bf16 hi + lo keeps each gradient within
        one bf16 rounding (2^-8 |ref| + 1e-5 max |ref|) of `jax.vjp` of
        JAX's fp32 reference on the same bf16 inputs."""
        ins, want = _ssd_bwd_case(g, n, la_scale)
        got = _ssd_bwd_sm90_arithmetic(*ins)
        for a, w in zip(got, want):
            worst, over = _share_of_bar(a, w)
            assert over == 0, worst

    def test_two_column_blocks_of_p_meet_in_the_sums(self):
        """p = 128 runs as two blocks of 64 columns, whose dlog_a, dB and
        dC partials are summed: the same bar."""
        ins, want = _ssd_bwd_case(2, 64, p=128, s=300)
        for a, w in zip(_ssd_bwd_sm90_arithmetic(*ins), want):
            worst, over = _share_of_bar(a, w)
            assert over == 0, worst

    @pytest.mark.parametrize("hi_only", BWD_SPLITS)
    def test_one_operand_as_hi_alone_breaks_the_bar(self, hi_only):
        """Rounding any one of the seven fp32 operands once to bf16 puts
        some gradient over the one-rounding bar: each needs its lo term."""
        ins, want = _ssd_bwd_case(1, 128, la_scale=0.1)
        split = tuple(o for o in BWD_SPLITS if o != hi_only)
        shares = [_share_of_bar(a, w)
                  for a, w in zip(_ssd_bwd_sm90_arithmetic(*ins, split=split),
                                  want)]
        assert max(worst for worst, _ in shares) > 2, shares
        assert sum(over for _, over in shares) > 0, shares

    @pytest.mark.parametrize("dtype,p", [
        (torch.bfloat16, 64), (torch.bfloat16, 8), (torch.bfloat16, 24),
        (torch.bfloat16, 128), (torch.bfloat16, 20), (torch.bfloat16, 136),
        (torch.float32, 64), (torch.float32, 128)])
    def test_backward_routes_where_the_forward_does(self, dtype, p):
        """The backward kernel takes exactly the calls whose forward ran
        the tensor-core kernel; the rest keep the plain recompute."""
        fwd_sm90 = sd.route(dtype, p) == "ssd_fwd_sm90"
        assert sd.route_bwd(dtype, p) == ("ssd_bwd_sm90" if fwd_sm90
                                          else None)

    @pytest.mark.parametrize("p,g,n", [(64, 1, 128), (128, 2, 16),
                                       (32, 4, 64)])
    def test_meta_branch_counts_the_kernels_work(self, p, g, n):
        """On meta tensors the backward returns empty gradients of the
        inputs' shapes and dtypes, adds the kernel's work once to an
        active `WorkCounter`, and counts no launch."""
        from repro_torch.launch import roofline

        b, s, h, chunk = 2, 300, 4, 256
        meta = dict(device="meta")
        ins = (torch.empty(b, s, h, p, dtype=torch.bfloat16, **meta),
               torch.empty(b, s, h, **meta),
               torch.empty(b, s, g, n, dtype=torch.bfloat16, **meta),
               torch.empty(b, s, g, n, dtype=torch.bfloat16, **meta))
        gy = torch.empty(b, s, h, p, dtype=torch.bfloat16, **meta)
        before = (sd.ssd_bwd.launches, sd.ssd_bwd.sm90_launches)
        with roofline.WorkCounter() as wc:
            got = sd.ssd_bwd(*ins, gy, chunk=chunk)
        assert (sd.ssd_bwd.launches, sd.ssd_bwd.sm90_launches) == before
        for a, ref in zip(got, ins):
            assert a.device.type == "meta"
            assert a.shape == ref.shape and a.dtype == ref.dtype
        flops, nbytes = roofline.ssd_bwd_work(b, s, h, p, g, n, 128, 2)
        assert flops == 2 * roofline.ssd_flops(b, s, h, p, n, 128)
        assert wc.kernels == {"ssd_bwd": [1, flops, nbytes]}

    def test_bound_at_mamba2s_shape(self):
        """mamba2-1.3b's layer: 30.2 GFLOP in 0.0305 ms at 989 TFLOP/s,
        106.95 MB in 0.0319 ms at 3.35 TB/s: the bytes bound it."""
        from repro_torch.launch import roofline

        flops, nbytes = roofline.ssd_bwd_work(2, 2048, 64, 64, 1, 128, 128, 2)
        assert nbytes == 3 * 2 * 2048 * 64 * 64 * 2 + 2 * 2 * 2048 * 64 * 4 \
            + 4 * 2 * 2048 * 128 * 2
        assert round(1e3 * flops / 989e12, 4) == 0.0305
        assert round(1e3 * nbytes / 3.35e12, 4) == 0.0319

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cpu_tensors_take_the_plain_recompute(self, dtype):
        """On CPU tensors the op's backward is the plain recompute, bit for
        bit, and counts no launch."""
        rng = np.random.RandomState(16)
        x, la, B, C = (torch.from_numpy(a) for a in
                       _ssd_arrays(rng, 1, 200, 4, 64, 32, g=2))
        x, B, C = (t.to(dtype) for t in (x, B, C))
        gy = torch.from_numpy(rng.randn(1, 200, 4, 64).astype(
            np.float32)).to(dtype)
        ins = [t.requires_grad_() for t in (x, la, B, C)]
        before = (sd.ssd_bwd.launches, sd.ssd_bwd.sm90_launches)
        y, _ = sd.ssd(*ins, chunk=64)
        got = torch.autograd.grad(y, ins, gy)
        assert (sd.ssd_bwd.launches, sd.ssd_bwd.sm90_launches) == before
        want = sd.ssd_bwd_plain(*(t.detach() for t in ins), gy, chunk=64)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype
            torch.testing.assert_close(a, w, atol=0, rtol=0)


def _rglru_arrays(rng, B, S, W, la_scale=0.2):
    return ((-np.abs(rng.randn(B, S, W)) * la_scale).astype(np.float32),
            (rng.randn(B, S, W) * 0.5).astype(np.float32))


class TestRGLRU:
    # the cases of tests/test_kernels.py at its 1e-5 relative bar
    @pytest.mark.parametrize("S,W,chunk,bw", [
        (64, 16, 16, 16), (128, 64, 32, 32), (256, 32, 128, 32)])
    def test_matches_pallas_and_reference(self, S, W, chunk, bw):
        rng = np.random.RandomState(S + W)
        la, b = _rglru_arrays(rng, 2, S, W)
        got = rg.rglru_scan(torch.from_numpy(la), torch.from_numpy(b))
        pallas = jax_rglru(la, b, chunk=chunk, block_w=bw, interpret=True)
        for want in (pallas, jax_rglru_ref(la, b)):
            assert _rel(got.numpy(), want) < 1e-5

    def test_ragged_sequence_and_strong_decay(self):
        """S = 600, no multiple of any chunk, at recurrentgemma's decays
        (log a down to about -55): a log-space cumulative sum would leave
        fp32's range here."""
        rng = np.random.RandomState(16)
        la = (-rng.rand(2, 600, 24) * 55.0).astype(np.float32)
        la[:, ::7] *= 1e-3                    # some steps keep their state
        b = (rng.randn(2, 600, 24) * 0.5).astype(np.float32)
        got = rg.rglru_scan(torch.from_numpy(la), torch.from_numpy(b))
        assert np.isfinite(got.numpy()).all()
        assert _rel(got.numpy(), jax_rglru_ref(la, b)) < 1e-5

    @pytest.mark.parametrize("S", [64, 150])
    def test_reverse_mode_backward_matches_jax_vjp(self, S):
        rng = np.random.RandomState(17 + S)
        la, b = _rglru_arrays(rng, 2, S, 24, la_scale=0.5)
        gh = rng.randn(2, S, 24).astype(np.float32)
        _, vjp = jax.vjp(jax_rglru_ref, jnp.asarray(la), jnp.asarray(b))
        want = vjp(jnp.asarray(gh))
        ins = [torch.from_numpy(a).requires_grad_() for a in (la, b)]
        got = torch.autograd.grad(rg.rglru_scan(*ins), ins,
                                  torch.from_numpy(gh))
        for a, w in zip(got, want):
            assert _rel(a.numpy(), w) < 1e-5

    def test_reverse_scan_is_the_backward_recurrence(self):
        """g_t = gh_t + a_{t+1} g_{t+1}, a_S = 0, against a float64 loop."""
        rng = np.random.RandomState(18)
        la, gh = _rglru_arrays(rng, 1, 40, 5, la_scale=0.5)
        a = np.exp(la.astype(np.float64))
        want = np.zeros_like(a)
        acc = np.zeros((1, 5))
        for t in reversed(range(40)):
            acc = (a[:, t + 1] if t + 1 < 40 else 0.0) * acc + gh[:, t]
            want[:, t] = acc
        got = rg.rglru_scan_reverse(torch.from_numpy(la), torch.from_numpy(gh))
        assert _rel(got.numpy(), want) < 1e-6

    def test_cpu_tensors_take_the_plain_version(self):
        rng = np.random.RandomState(19)
        la, b = (torch.from_numpy(a).requires_grad_()
                 for a in _rglru_arrays(rng, 1, 32, 8))
        before = (rg.rglru_scan_fwd.launches, rg.rglru_scan_reverse.launches,
                  rg.rglru_scan_bwd.launches)
        h = rg.rglru_scan(la, b)
        torch.autograd.grad(h.sum(), (la, b))
        torch.testing.assert_close(h, rg.rglru_scan_ref(la, b), atol=0,
                                   rtol=0)
        assert (rg.rglru_scan_fwd.launches, rg.rglru_scan_reverse.launches,
                rg.rglru_scan_bwd.launches) == before

    @pytest.mark.parametrize("S", [1, 64, 150, 600])
    def test_fused_backward_matches_jax_vjp(self, S):
        """`rglru_scan_bwd_ref`, the plain version of the fused backward
        kernel, at recurrentgemma's decays (log a down to about -55, every
        seventh step keeping its state)."""
        rng = np.random.RandomState(20 + S)
        la = (-rng.rand(2, S, 24) * 55.0).astype(np.float32)
        la[:, ::7] *= 1e-3
        b = (rng.randn(2, S, 24) * 0.5).astype(np.float32)
        gh = rng.randn(2, S, 24).astype(np.float32)
        h, vjp = jax.vjp(jax_rglru_ref, jnp.asarray(la), jnp.asarray(b))
        want = vjp(jnp.asarray(gh))
        got = rg.rglru_scan_bwd(torch.from_numpy(la),
                                torch.from_numpy(np.array(h)),
                                torch.from_numpy(gh))
        for a, w in zip(got, want):
            assert np.isfinite(a.numpy()).all()
            assert _rel(a.numpy(), w) < 1e-5

    def test_plan_keeps_every_block_resident(self):
        """At recurrentgemma's layer the cluster is 4: 80 strips of 32
        channels, 320 blocks for 3 places on each of 132 SMs; never more
        ranks than segments."""
        assert rg.plan(1, 4096, 2560, rg.L_SCAN, 132) == 4
        assert rg.plan(1, 4096, 2560, rg.L_BWD, 132) == 4
        assert rg.plan(1, 1, 5, rg.L_SCAN, 132) == 1
        assert rg.plan(1, 200, 5, rg.L_SCAN, 132) == 2
        assert rg.plan(1, 300, 5, rg.L_SCAN, 132) == 4
        assert rg.plan(1, 16384, 16, rg.L_BWD, 132) == 8
        assert rg.plan(64, 4096, 2560, rg.L_SCAN, 132) == 1

    @pytest.mark.parametrize("mode", ["forward", "reverse", "backward"])
    @pytest.mark.parametrize("S", [1, 37, 1000, 3000])
    def test_kernel_blocking_emulation(self, mode, S):
        """The kernel's blocking emulated in fp32 (segments of chunks, the
        shuffle fold, the cluster's ranks and rounds, the reverse shift,
        the backward's h_{t-1} and last la) against a float64 loop; S =
        3000 takes several rounds of a cluster of 8 in every mode."""
        rng = np.random.RandomState(21 + S)
        la = (-rng.rand(2, S, 5) * 8.0).astype(np.float32)
        la[:, ::7] *= 1e-3
        u = rng.randn(2, S, 5).astype(np.float32)
        h = rng.randn(2, S, 5).astype(np.float32)
        steps = rg.L_BWD if mode == "backward" else rg.L_SCAN
        cluster = rg.plan(2, S, 5, steps, 132)
        if S == 3000:
            assert cluster == 8 and S > cluster * rg.NC * steps
        got = _emulate_rglru_kernel(torch.from_numpy(la), torch.from_numpy(u),
                                    mode, torch.from_numpy(h), cluster)
        a = np.exp(la.astype(np.float64))
        want = np.zeros((2, S, 5))
        acc = np.zeros((2, 5))
        order = range(S) if mode == "forward" else reversed(range(S))
        for t in order:
            c = a[:, t] if mode == "forward" else (
                a[:, t + 1] if t + 1 < S else 0.0)
            acc = c * acc + u[:, t]
            want[:, t] = acc
        assert _rel(got[0].numpy(), want) < 1e-6
        if mode == "backward":
            h_prev = np.concatenate([np.zeros((2, 1, 5)), h[:, :-1]], axis=1)
            assert _rel(got[1].numpy(), want * a * h_prev) < 1e-6


def _shift(x, dim, by, fill):
    """x moved `by` places up along `dim`, the first `by` set to fill."""
    pad = torch.full_like(x.narrow(dim, 0, by), fill)
    return torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - by)], dim)


def _scan_pairs(A, B, dim, width):
    """The kernel's shuffle scan of affine maps over `dim`: d = 1, 2, 4
    .. below `width`, lanes past the end of `dim` being identities."""
    d = 1
    while d < width and d < A.shape[dim]:
        Al, Bl = _shift(A, dim, d, 1.0), _shift(B, dim, d, 0.0)
        A, B = A * Al, A * Bl + B
        d *= 2
    return A, B


def _emulate_rglru_kernel(la, u, mode, h, cluster):
    """csrc/rglru_scan.cu's arithmetic and indexing in fp32 torch: step k
    at time t (S-1-k in reverse), segments of NC chunks of L steps, rank r
    of the cluster taking segment q CL + r in round q. Returns the scan,
    and in the backward also dlog_a."""
    B, S, W = u.shape
    L = rg.L_BWD if mode == "backward" else rg.L_SCAN
    nc, cl = rg.NC, cluster
    rounds = -(-S // (cl * nc * L))
    K = rounds * cl * nc * L
    rev = mode != "forward"
    k = torch.arange(K)
    inr = k < S
    t = torch.where(inr, S - 1 - k if rev else k, 0)
    # steps past S load la = 0 and u = 0; in reverse the coefficient is
    # la_{t+1}, -inf (exp 0) at t = S-1
    x = torch.where(inr[:, None], u[:, t], 0.0)
    if rev:
        lc = torch.where((t + 1 < S)[:, None],
                         la[:, torch.clamp(t + 1, max=S - 1)],
                         torch.tensor(-math.inf))
    else:
        lc = la[:, t]
    c = torch.exp(torch.where(inr[:, None], lc, 0.0))
    shape = (B, rounds, cl, nc, L, W)
    c6, x6 = c.reshape(shape), x.reshape(shape)
    prod, v = torch.ones(shape[:4] + (W,)), torch.zeros(shape[:4] + (W,))
    for j in range(L):
        v = c6[..., j, :] * v + x6[..., j, :]
        prod = prod * c6[..., j, :]
    A, Bp = _scan_pairs(prod, v, 3, nc)
    XA, XB = _shift(A, 3, 1, 1.0), _shift(Bp, 3, 1, 0.0)
    CA, CB = _scan_pairs(A[:, :, :, -1], Bp[:, :, :, -1], 2, 8)
    out = torch.empty(shape)
    h_round = torch.zeros(B, W)
    for q in range(rounds):
        EA, EB = _shift(CA[:, q], 1, 1, 1.0), _shift(CB[:, q], 1, 1, 0.0)
        hin = EA * h_round[:, None] + EB
        hin[:, 0] = h_round
        h_round = CA[:, q, -1] * h_round + CB[:, q, -1]
        v = XA[:, q] * hin[:, :, None] + XB[:, q]
        for j in range(L):
            v = c6[:, q, :, :, j] * v + x6[:, q, :, :, j]
            out[:, q, :, :, j] = v
    out = out.reshape(B, K, W)
    scan = torch.empty(B, S, W)
    scan[:, t[:S]] = out[:, :S]
    if mode != "backward":
        return (scan,)
    # exp(la_t) is the next step's coefficient, or for a chunk's last step
    # that of the extra load la[t - ... ]; h_{t-1} shifted by one step
    ea = torch.cat([c[:, 1:], torch.ones(B, 1, W)], 1).reshape(shape)
    last = k.reshape(rounds, cl, nc, L)[..., -1]
    last_t = torch.where(last < S, S - 1 - last, 0)
    ea[..., -1, :] = torch.where((last < S)[None, ..., None],
                                 torch.exp(la[:, last_t.reshape(-1)])
                                 .reshape(B, rounds, cl, nc, W), 1.0)
    hk = torch.where((k + 1 < S)[:, None],
                     h[:, torch.clamp(t - 1, min=0)], 0.0)
    dla_k = out * ea.reshape(B, K, W) * hk
    dla = torch.empty(B, S, W)
    dla[:, t[:S]] = dla_k[:, :S]
    return scan, dla
