"""Plain PyTorch version of the per-block int8 codec (the CPU path, and
what the kernel is held to on the card)."""
from __future__ import annotations

import torch


def quantize_blocks_ref(x2d):
    xf = x2d.float()
    amax = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-12)
    # a tensor divisor, not the Python scalar 127.0: on the card PyTorch
    # turns division by a scalar into a multiply by its reciprocal,
    # which is not the IEEE quotient the codec is defined by
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks_ref(q2d, scales, out_dtype=torch.float32):
    return (q2d.float() * scales).to(out_dtype)
