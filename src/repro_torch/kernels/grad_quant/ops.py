"""Quantize and dequantize tensors of any shape through the int8 block
codec: the tensor is flattened and cut into `BLOCK`-wide rows, the last
one padded with zeros.

On a CUDA tensor each function launches its kernel (`csrc/grad_quant.cu`)
and adds one to its `launches` count (and its work to an active
`launch.roofline.WorkCounter`); on a CPU tensor it runs the plain
version in `ref.py`. There is no other path.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grad_quant import ref as R
from repro_torch.launch import roofline

BLOCK = 2048
_STEM = "grad_quant"


def _n_blocks(n: int) -> int:
    return max((n + BLOCK - 1) // BLOCK, 1)


def _pad_rows(x):
    flat = x.reshape(-1)
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, _n_blocks(n) * BLOCK - n))
    return flat.reshape(-1, BLOCK), n


def _lib():
    lib = _build.library(_STEM)
    if lib.grad_quant_quantize.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.grad_quant_quantize.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
        lib.grad_quant_dequantize.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
        lib.grad_quant_quantize.restype = ctypes.c_int
        lib.grad_quant_dequantize.restype = ctypes.c_int
    return lib


def quantize_plain(x):
    """The plain version of `quantize`, on any device."""
    return R.quantize_blocks_ref(_pad_rows(x)[0])


def dequantize_plain(q, scales, shape, dtype=torch.float32):
    """The plain version of `dequantize`, on any device."""
    n = math.prod(int(d) for d in shape)
    x2d = R.dequantize_blocks_ref(q, scales, dtype)
    return x2d.reshape(-1)[:n].reshape(shape)


def quantize(x):
    """x: any shape -> (q int8 (nb, BLOCK), scales fp32 (nb, 1))."""
    if x.device.type == "cpu":
        return quantize_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: unsupported device {x.device}")
    flat = x.detach().reshape(-1).float().contiguous()
    n = flat.numel()
    nb = _n_blocks(n)
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    rc = _lib().grad_quant_quantize(flat.data_ptr(), q.data_ptr(),
                                    scales.data_ptr(), n, nb,
                                    _build.stream_ptr(x))
    _build.check(_STEM, rc)
    quantize.launches += 1
    roofline.add_kernel_work("quantize",
                             lambda: roofline.codec_work(n, nb, BLOCK))
    return q, scales


def dequantize(q, scales, shape, dtype=torch.float32):
    """Inverse of `quantize`: (q, scales) -> a `dtype` tensor of `shape`."""
    if q.device.type == "cpu":
        return dequantize_plain(q, scales, shape, dtype)
    n = math.prod(int(d) for d in shape)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize: unsupported device {q.device}")
    nb = q.shape[0]
    if (q.dtype != torch.int8 or scales.dtype != torch.float32
            or tuple(q.shape) != (nb, BLOCK) or scales.numel() != nb
            or not (q.is_contiguous() and scales.is_contiguous())
            or nb != _n_blocks(n)):
        raise ValueError(
            f"dequantize: want contiguous int8 ({_n_blocks(n)}, {BLOCK}) "
            f"and fp32 scales for shape {tuple(shape)}, got "
            f"{q.dtype} {tuple(q.shape)} and {scales.dtype} "
            f"{tuple(scales.shape)}")
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    rc = _lib().grad_quant_dequantize(q.data_ptr(), scales.data_ptr(),
                                      out.data_ptr(), n, nb,
                                      _build.stream_ptr(q))
    _build.check(_STEM, rc)
    dequantize.launches += 1
    roofline.add_kernel_work("dequantize", lambda: roofline.codec_work(
        n, nb, BLOCK, dequantize=True))
    return out.reshape(shape).to(dtype)


quantize.launches = 0
dequantize.launches = 0
