"""The port's kernel modules against the JAX package's, on the CPU: the
flash-attention op (plain version, gradients through its recompute
backward) against the Pallas kernel in interpret mode and its reference,
and the int8 codec bit for bit against both JAX paths.

On the CPU each wrapper runs its plain version; the CUDA kernels are
held to the same plain versions on the card (`chip_smoke.py` and
`tests/test_torch_cuda.py`). Inputs come from numpy seeds and cross as
numpy arrays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import reference_attention as jax_ref
from repro.kernels.grad_quant import ops as jgq
from repro_torch.common.bridge import _to_numpy, _to_tensor
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.grad_quant import ops as gq


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

    def test_cpu_tensors_take_the_plain_version(self):
        rng = np.random.RandomState(4)
        _, (tq, tk, tv) = _qkv(rng, 1, 64, 2, 16, jnp.float32)
        before = fa.flash_attention_fwd.launches
        out = fa.flash_attention(tq, tk, tv)
        torch.testing.assert_close(out, fa.flash_attention_plain(tq, tk, tv),
                                   atol=0, rtol=0)
        assert fa.flash_attention_fwd.launches == before


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
