"""Public RG-LRU scan op on (B, S, W) tensors: h_t = exp(log_a_t) h_{t-1}
+ b_t per channel, fp32.

Differentiable through `torch.autograd.Function`. The forward is
`rglru_scan_fwd`; the backward is `rglru_scan_reverse`, the same kernel
(`csrc/rglru_scan.cu`) run from the end on the output gradient:
g_t = gh_t + exp(log_a_{t+1}) g_{t+1}, then db = g and
dlog_a_t = g_t exp(log_a_t) h_{t-1}. On a CUDA tensor each wrapper
launches the kernel and adds one to its own `launches` count (forward
and reverse launches are counted apart); on a CPU tensor it runs the
plain version in `ref.py`. There is no other path.

The JAX package's Pallas kernel has no gradient; the backward is held to
`jax.vjp` of its reference scan, which is the gradient the JAX package
trains with.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_scan_ref, rglru_scan_reverse_ref

_STEM = "rglru_scan"


def _lib():
    lib = _build.library(_STEM)
    fn = lib.rglru_scan
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 3 + [i32] * 4 + [i64] * 9 + [ptr]
        fn.restype = ctypes.c_int
    return lib


def _launch(log_a, u, reverse):
    if log_a.device.type != "cuda" or u.device != log_a.device:
        raise ValueError("rglru_scan: log_a and b must lie on one CUDA device")
    if log_a.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"rglru_scan: fp32 inputs only, got {log_a.dtype} "
                         f"{u.dtype}")
    if log_a.dim() != 3 or log_a.shape != u.shape:
        raise ValueError(f"rglru_scan: (B,S,W) inputs of one shape, got "
                         f"{tuple(log_a.shape)} {tuple(u.shape)}")
    B, S, W = u.shape
    if B > 65535:
        raise ValueError(f"rglru_scan: batch {B} exceeds 65535")
    out = torch.empty((B, S, W), dtype=torch.float32, device=u.device)
    rc = _lib().rglru_scan(log_a.data_ptr(), u.data_ptr(), out.data_ptr(),
                           B, S, W, int(reverse), *log_a.stride(),
                           *u.stride(), *out.stride(),
                           _build.stream_ptr(u))
    _build.check(_STEM, rc)
    return out


def rglru_scan_fwd(log_a, b):
    """Forward only: h (B,S,W); fp32 on the card, b's dtype on the CPU."""
    if log_a.device.type == "cpu":
        return rglru_scan_ref(log_a, b)
    h = _launch(log_a, b, reverse=False)
    rglru_scan_fwd.launches += 1
    return h


def rglru_scan_reverse(log_a, g):
    """out_t = exp(log_a_{t+1}) out_{t+1} + g_t from the end, fp32."""
    if log_a.device.type == "cpu":
        return rglru_scan_reverse_ref(log_a, g)
    out = _launch(log_a, g, reverse=True)
    rglru_scan_reverse.launches += 1
    return out


rglru_scan_fwd.launches = 0
rglru_scan_reverse.launches = 0


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, b):
        h = rglru_scan_fwd(log_a, b)
        ctx.save_for_backward(log_a, h)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, gh):
        log_a, h = ctx.saved_tensors
        g = rglru_scan_reverse(log_a, gh.float())
        h_prev = torch.nn.functional.pad(h.float()[:, :-1], (0, 0, 1, 0))
        dlog_a = g * torch.exp(log_a.float()) * h_prev
        return dlog_a.to(log_a.dtype), g.to(ctx.b_dtype)


def rglru_scan(log_a, b):
    """log_a, b: (B,S,W) -> h (B,S,W), h_t = exp(log_a_t) h_{t-1} + b_t."""
    return _RGLRUScan.apply(log_a, b)
