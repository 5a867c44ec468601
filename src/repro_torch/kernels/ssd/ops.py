"""Public SSD op on model-layout tensors: x (b,s,h,p), log decay (b,s,h),
and B and C per group, (b,s,g,n), head h reading group h // (h_total//g).

Differentiable through `torch.autograd.Function`: the forward is
`ssd_fwd`, which on a CUDA tensor launches one of two kernels (adding one
to its `launches` count, and its work to an active
`launch.roofline.WorkCounter`) and on a CPU tensor runs the plain
version in `ref.py`. `route` picks the kernel by dtype and head dim: bf16 with p a
multiple of 8 up to 128 goes to `csrc/ssd_fwd_sm90.cu`, on the tensor
cores (also counted in `sm90_launches`); fp32, and bf16 of any other p,
to `csrc/ssd_fwd.cu`, on the CUDA cores. On a meta tensor (the dry run)
it runs the same checks, adds the routed kernel's work to an active
`WorkCounter` and returns an empty meta output, counting no launch.
The backward recomputes the
scan with the plain version under autograd, which is the gradient the
JAX package takes (`jax.grad` of `ssd_reference`; its Pallas kernel has
none). B and C are expanded to heads only inside that recompute, so
autograd's sum over the heads of a group gives their gradients. A
backward kernel is queued in ROADMAP.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tma import map_strides, tma_ready
from repro_torch.kernels.ssd.ref import ssd_reference
from repro_torch.launch import roofline

STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256
MAX_P_SM90 = 128
# rows of the pieces the tensor-core kernel cuts the sequence into,
# whatever chunk the caller names
SM90_PIECE = 128
_STEM = "ssd_fwd"                 # fp32 and other bf16, CUDA cores
_STEM_SM90 = "ssd_fwd_sm90"       # bf16, tensor cores


def _heads(t, h):
    """(b,s,g,n) per-group tensor -> (b,s,h,n), each group repeated for its
    h // g heads in order, as `jnp.repeat` does in `mamba2_mix`."""
    return torch.repeat_interleave(t, h // t.shape[2], dim=2)


def ssd_plain(xbar, log_a, Bm, Cm, *, chunk=256):
    """The plain version: (y (b,s,h,p) in xbar's dtype, final state)."""
    h = xbar.shape[2]
    return ssd_reference(xbar, log_a, _heads(Bm, h), _heads(Cm, h), chunk)


def route(dtype, p):
    """The kernel source `ssd_fwd` launches for x of this dtype and head
    dim: the tensor-core kernel takes bf16 with p a multiple of 8 (a TMA
    box row of whole 16-byte units) up to 128."""
    if dtype == torch.bfloat16 and p % 8 == 0 and p <= MAX_P_SM90:
        return _STEM_SM90
    return _STEM


def _entry(stem):
    fn = getattr(_build.library(stem), stem)
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # the CUDA-core entry also takes is_bf16 and the chunk
        n_int = 8 if stem == _STEM else 6
        fn.argtypes = [ptr] * 5 + [i32] * n_int + [i64] * 15 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def _check(xbar, log_a, Bm, Cm, chunk):
    b, s, h, p = xbar.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if xbar.device.type not in ("cuda", "meta") or any(
            t.device != xbar.device for t in (log_a, Bm, Cm)):
        raise ValueError("ssd: all inputs must lie on one CUDA device (or "
                         "all on meta)")
    if xbar.dtype not in (torch.float32, torch.bfloat16) or not (
            Bm.dtype == Cm.dtype == xbar.dtype):
        raise ValueError(f"ssd: x, B, C of one dtype, fp32 or bf16; got "
                         f"{xbar.dtype} {Bm.dtype} {Cm.dtype}")
    if log_a.dtype != torch.float32:
        raise ValueError(f"ssd: log decay must be fp32, got {log_a.dtype}")
    if (tuple(log_a.shape) != (b, s, h) or tuple(Cm.shape) != (b, s, g, n)
            or Bm.shape[:2] != (b, s) or g < 1 or h % g):
        raise ValueError(f"ssd: shapes x {tuple(xbar.shape)}, log_a "
                         f"{tuple(log_a.shape)}, B {tuple(Bm.shape)}, C "
                         f"{tuple(Cm.shape)}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssd: state dim {n} not in {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if b * h > 65535:
        raise ValueError(f"ssd: b*h={b * h} exceeds 65535")


def ssd_fwd(xbar, log_a, Bm, Cm, *, chunk=256):
    """Forward only: y (b,s,h,p) in xbar's dtype."""
    if xbar.device.type == "cpu":
        return ssd_plain(xbar, log_a, Bm, Cm, chunk=chunk)[0]
    _check(xbar, log_a, Bm, Cm, chunk)
    b, s, h, p = xbar.shape
    g, n = Bm.shape[2], Bm.shape[3]
    stem = route(xbar.dtype, p)
    # the rows of the chunks the launched kernel runs
    run_chunk = min(chunk, SM90_PIECE if stem == _STEM_SM90 else s)
    y = torch.empty((b, s, h, p), dtype=xbar.dtype, device=xbar.device)
    if xbar.device.type == "cuda":
        _launch(stem, xbar, log_a, Bm, Cm, y, chunk)
        ssd_fwd.launches += 1
        ssd_fwd.sm90_launches += int(stem == _STEM_SM90)
    roofline.add_kernel_work("ssd_fwd", lambda: roofline.ssd_work(
        b, s, h, p, g, n, run_chunk, y.element_size()))
    return y


ssd_fwd.launches = 0
ssd_fwd.sm90_launches = 0


def _launch(stem, xbar, log_a, Bm, Cm, y, chunk):
    """Launch `stem`'s kernel, writing y."""
    b, s, h, p = xbar.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if stem == _STEM_SM90:
        # TMA reads x, B and C as they lie, or a contiguous copy where
        # their base or strides break its alignment; the kernel cuts the
        # sequence into its own pieces, whatever the chunk
        xbar, Bm, Cm = (t if tma_ready(t)
                        else t.clone(memory_format=torch.contiguous_format)
                        for t in (xbar, Bm, Cm))
        args = (b, s, h, p, g, n, *map_strides(xbar), *log_a.stride(),
                *map_strides(Bm), *map_strides(Cm))
    else:
        xbar, Bm, Cm = (t if t.stride(3) == 1 else t.contiguous()
                        for t in (xbar, Bm, Cm))
        args = (int(xbar.dtype == torch.bfloat16), b, s, h, p, g, n,
                min(chunk, s), *xbar.stride()[:3], *log_a.stride(),
                *Bm.stride()[:3], *Cm.stride()[:3])
    ptrs = (t.data_ptr() for t in (xbar, log_a, Bm, Cm, y))
    rc = _entry(stem)(*ptrs, *args, *y.stride()[:3], _build.stream_ptr(y))
    _build.check(stem, rc)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xbar, log_a, Bm, Cm, chunk):
        ctx.save_for_backward(xbar, log_a, Bm, Cm)
        ctx.chunk = chunk
        return ssd_fwd(xbar, log_a, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in saved]
            y, _ = ssd_plain(*ins, chunk=ctx.chunk)
            grads = torch.autograd.grad(y, ins, gy)
        return (*grads, None)


def ssd(xbar, log_a, Bm, Cm, *, chunk=256):
    """xbar (b,s,h,p), log_a (b,s,h), Bm and Cm (b,s,g,n) with g dividing
    h -> (y (b,s,h,p), None), the calling convention of the JAX
    package's `ssd/ops.py::ssd` (the final state is not returned)."""
    return _SSD.apply(xbar, log_a, Bm, Cm, chunk), None
