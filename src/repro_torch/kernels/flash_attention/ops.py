"""Public flash-attention op on model-layout tensors (B, S, N, H), kv
already expanded to N heads by the attention layer.

Differentiable through `torch.autograd.Function`: the forward is
`flash_attention_fwd`, which launches the kernel in
`csrc/flash_attention_fwd.cu` on a CUDA tensor (adding one to its
`launches` count) and runs the plain version in `ref.py` on a CPU tensor.
The backward recomputes attention with the plain version under autograd,
as the JAX package's `_fa_bwd` does with its reference; a backward kernel
is queued in ROADMAP.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import reference_attention

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_STEM = "flash_attention_fwd"


def _fold(x):
    B, S, N, H = x.shape
    return x.transpose(1, 2).reshape(B * N, S, H)


def _unfold(x, B, N):
    BN, S, H = x.shape
    return x.reshape(B, N, S, H).transpose(1, 2)


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          softcap=None):
    """The plain version on (B, S|T, N, H) tensors."""
    B, _, N, _ = q.shape
    out = reference_attention(_fold(q), _fold(k), _fold(v), causal=causal,
                              window=window, softcap=softcap)
    return _unfold(out, B, N)


def _lib():
    lib = _build.library(_STEM)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        fn.argtypes = ([ptr] * 4 + [i32] * 6 + [i64] * 12
                       + [f32, i32, i32, f32, ptr])
        fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd(q, k, v, *, causal=True, window=None, softcap=None):
    """Forward only: q (B,S,N,H), k and v (B,T,N,H) -> (B,S,N,H)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    B, S, N, H = q.shape
    T = k.shape[1]
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: fp32 or bf16 q, k, v of one "
                         f"dtype, got {q.dtype} {k.dtype} {v.dtype}")
    if tuple(k.shape) != (B, T, N, H) or tuple(v.shape) != (B, T, N, H):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if H not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {H} not in {HEAD_DIMS}")
    if B * N > 65535:
        raise ValueError(f"flash_attention: B*N={B * N} exceeds 65535")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        q, k, v = (x.contiguous() for x in (q, k, v))
    o = torch.empty((B, S, N, H), dtype=q.dtype, device=q.device)
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), B, N, S, T, H,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        1.0 / math.sqrt(H), int(bool(causal)),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), _build.stream_ptr(q))
    _build.check(_STEM, rc)
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return flash_attention_fwd(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = flash_attention_plain(*qkv, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """q, k, v: (B, S|T, N, H) -> (B, S, N, H)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)
