"""Public flash-attention op on model-layout tensors (B, S, N, H), kv
already expanded to N heads by the attention layer.

Differentiable through `torch.autograd.Function`: the forward is
`flash_attention_fwd`, which on a CUDA tensor launches one of two kernels
(adding one to its `launches` count, and its work to an active
`launch.roofline.WorkCounter`) and on a CPU tensor runs the plain
version in `ref.py`. bf16 goes to `csrc/flash_attention_fwd_sm90.cu`, on
the tensor cores; fp32 to `csrc/flash_attention_fwd.cu`, on the CUDA
cores. On a meta tensor (the dry run, `launch/dryrun.py`) it runs the
CUDA branch's argument checks, adds the kernel's work to an active
`WorkCounter` and returns an empty meta output: nothing launches, so
`launches` stays as it was.
The backward recomputes attention with the plain version under autograd,
as the JAX package's `_fa_bwd` does with its reference; a backward kernel
is queued in ROADMAP.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.common.trace import span
from repro_torch.kernels import _build
from repro_torch.kernels._tma import map_strides, tma_ready
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.launch import roofline

# head dims of the bf16 kernel (a wgmma K step is 16), and of the fp32
# one, which also takes the 8 of the SMOKE configs with d_model 64 over
# 8 heads
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
FP32_HEAD_DIMS = (8,) + HEAD_DIMS
_STEM = "flash_attention_fwd"               # fp32, CUDA cores
_STEM_SM90 = "flash_attention_fwd_sm90"     # bf16, tensor cores


def _fold(x):
    B, S, N, H = x.shape
    return x.transpose(1, 2).reshape(B * N, S, H)


def _unfold(x, B, N):
    BN, S, H = x.shape
    return x.reshape(B, N, S, H).transpose(1, 2)


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          softcap=None, scale=None):
    """The plain version on (B, S|T, N, H) tensors."""
    B, _, N, _ = q.shape
    out = reference_attention(_fold(q), _fold(k), _fold(v), causal=causal,
                              window=window, softcap=softcap, scale=scale)
    return _unfold(out, B, N)


def check_head_dim(H, dtype):
    """Raise unless a kernel of `dtype` has an instance for head dim H."""
    dims = HEAD_DIMS if dtype == torch.bfloat16 else FP32_HEAD_DIMS
    if H not in dims:
        raise ValueError(f"flash_attention: head dim {H} not in {dims} "
                         f"for {dtype}")


def _entry(stem):
    """The C entry of `stem`; both take the same arguments."""
    fn = getattr(_build.library(stem), stem)
    if fn.argtypes is None:
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        fn.argtypes = ([ptr] * 4 + [i32] * 5 + [i64] * 12
                       + [f32, i32, i32, f32, ptr])
        fn.restype = ctypes.c_int
    return fn


def _check_args(q, k, v, window, softcap, scale):
    """The kernels' argument checks; returns (B, S, T, N, H)."""
    B, S, N, H = q.shape
    T = k.shape[1]
    if (q.device.type not in ("cuda", "meta") or k.device != q.device
            or v.device != q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                         "device (or all on meta)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: fp32 or bf16 q, k, v of one "
                         f"dtype, got {q.dtype} {k.dtype} {v.dtype}")
    if tuple(k.shape) != (B, T, N, H) or tuple(v.shape) != (B, T, N, H):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    check_head_dim(H, q.dtype)
    if B * N > 65535:
        raise ValueError(f"flash_attention: B*N={B * N} exceeds 65535")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    if scale is not None and not scale > 0:
        raise ValueError(f"flash_attention: scale must be > 0, got {scale}")
    return B, S, T, N, H


def _launch(q, k, v, B, S, T, N, H, causal, window, softcap, scale):
    """Launch the kernel of q's dtype; returns o (B,S,N,H)."""
    if q.dtype == torch.bfloat16:
        # TMA reads the tensors as they lie, or a contiguous copy where
        # their base or strides break its alignment
        stem = _STEM_SM90
        q, k, v = (x if tma_ready(x)
                   else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
        strides = [st for x in (q, k, v) for st in map_strides(x)]
    else:
        stem = _STEM
        if any(x.stride(3) != 1 for x in (q, k, v)):
            q, k, v = (x.contiguous() for x in (q, k, v))
        strides = [st for x in (q, k, v) for st in x.stride()[:3]]
    o = torch.empty((B, S, N, H), dtype=q.dtype, device=q.device)
    rc = _entry(stem)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, N, S, T, H, *strides, *o.stride()[:3],
        1.0 / math.sqrt(H) if scale is None else float(scale),
        int(bool(causal)),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), _build.stream_ptr(q))
    _build.check(stem, rc)
    return o


def flash_attention_fwd(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    """Forward only: q (B,S,N,H), k and v (B,T,N,H) -> (B,S,N,H); the
    scores are scaled by `scale` (None: 1/sqrt(H))."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    B, S, T, N, H = _check_args(q, k, v, window, softcap, scale)
    if q.device.type == "meta":
        # the dry run: the output's shape and dtype, nothing launched
        o = torch.empty((B, S, N, H), dtype=q.dtype, device="meta")
    else:
        o = _launch(q, k, v, B, S, T, N, H, causal, window, softcap, scale)
        flash_attention_fwd.launches += 1
    roofline.add_kernel_work("flash_attention_fwd", lambda: (
        roofline.attention_work(B, S, T, N, H, q.element_size(),
                                causal=causal, window=window)))
    return o


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return flash_attention_fwd(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with span("attn.bwd"), torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = flash_attention_plain(*qkv, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None):
    """q, k, v: (B, S|T, N, H) -> (B, S, N, H); the scores are scaled by
    `scale` (None: 1/sqrt(H)), in the forward and the backward's
    recompute."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
