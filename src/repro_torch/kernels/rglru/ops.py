"""Public RG-LRU scan op on (B, S, W) tensors: h_t = exp(log_a_t) h_{t-1}
+ b_t per channel, fp32.

Differentiable through `torch.autograd.Function`. The forward is
`rglru_scan_fwd`; the backward is `rglru_scan_bwd`, one launch of the
same kernel source (`csrc/rglru_scan.cu`) that walks the output
gradient from the end, g_t = gh_t + exp(log_a_{t+1}) g_{t+1}, and writes
db = g and dlog_a_t = g_t exp(log_a_t) h_{t-1} in the same pass.
`rglru_scan_reverse` is the reverse scan alone. On a CUDA tensor each
wrapper launches its kernel and adds one to its own `launches` count; on
a CPU tensor it runs the plain version in `ref.py`. There is no other
path.

The JAX package's Pallas kernel has no gradient; the backward is held to
`jax.vjp` of its reference scan, which is the gradient the JAX package
trains with.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import (rglru_scan_bwd_ref, rglru_scan_ref,
                                           rglru_scan_reverse_ref)

_STEM = "rglru_scan"

# The kernel's blocking (csrc/rglru_scan.cu): channels and chunk threads
# a block, steps a chunk thread in the scans and in the backward, the
# largest cluster, and blocks a SM.
CW, NC, L_SCAN, L_BWD, MAX_CLUSTER, BLOCKS_PER_SM = 32, 8, 16, 12, 8, 3


def plan(B, S, W, steps, sms):
    """The cluster size for a launch whose chunk threads take `steps`
    steps: the largest power of two, up to 8 and to the number of
    segments, whose blocks all fit on `sms` SMs at once (1 at least)."""
    strips = -(-W // CW)
    segments = -(-S // (NC * steps))
    cluster = 1
    while (cluster < MAX_CLUSTER and cluster < segments
           and B * strips * cluster * 2 <= BLOCKS_PER_SM * sms):
        cluster *= 2
    return cluster


def _lib():
    lib = _build.library(_STEM)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, n_ptr, n_int, n_stride in [("rglru_scan", 3, 5, 9),
                                         ("rglru_scan_bwd", 5, 4, 15)]:
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [i64] * n_stride \
                + [ptr]
            fn.restype = ctypes.c_int
    return lib


def _check_inputs(*tensors):
    x = tensors[0]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("rglru_scan: inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"rglru_scan: fp32 inputs only, got "
                         f"{[t.dtype for t in tensors]}")
    if x.dim() != 3 or any(t.shape != x.shape for t in tensors):
        raise ValueError(f"rglru_scan: (B,S,W) inputs of one shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    B, S, W = x.shape
    if B > 65535:
        raise ValueError(f"rglru_scan: batch {B} exceeds 65535")
    return B, S, W


def _cluster(x, B, S, W, steps):
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return plan(B, S, W, steps, sms)


def _launch(log_a, u, reverse):
    B, S, W = _check_inputs(log_a, u)
    out = torch.empty((B, S, W), dtype=torch.float32, device=u.device)
    rc = _lib().rglru_scan(log_a.data_ptr(), u.data_ptr(), out.data_ptr(),
                           B, S, W, int(reverse),
                           _cluster(u, B, S, W, L_SCAN), *log_a.stride(),
                           *u.stride(), *out.stride(), _build.stream_ptr(u))
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


def rglru_scan_bwd(log_a, h, gh):
    """The backward of h = rglru_scan(log_a, b) for the output gradient
    gh: (dlog_a, db), fp32."""
    if log_a.device.type == "cpu":
        return rglru_scan_bwd_ref(log_a, h, gh)
    B, S, W = _check_inputs(log_a, h, gh)
    db = torch.empty((B, S, W), dtype=torch.float32, device=gh.device)
    dlog_a = torch.empty_like(db)
    rc = _lib().rglru_scan_bwd(
        log_a.data_ptr(), gh.data_ptr(), h.data_ptr(), db.data_ptr(),
        dlog_a.data_ptr(), B, S, W, _cluster(gh, B, S, W, L_BWD),
        *log_a.stride(), *gh.stride(), *h.stride(), *db.stride(),
        *dlog_a.stride(), _build.stream_ptr(gh))
    _build.check(_STEM, rc)
    rglru_scan_bwd.launches += 1
    return dlog_a, db


rglru_scan_fwd.launches = 0
rglru_scan_reverse.launches = 0
rglru_scan_bwd.launches = 0


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
        dlog_a, db = rglru_scan_bwd(log_a, h, gh.float())
        return dlog_a.to(log_a.dtype), db.to(ctx.b_dtype)


def rglru_scan(log_a, b):
    """log_a, b: (B,S,W) -> h (B,S,W), h_t = exp(log_a_t) h_{t-1} + b_t."""
    return _RGLRUScan.apply(log_a, b)
