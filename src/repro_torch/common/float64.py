"""Float64 runs of the port's model code, to measure how far fp32 rounding
moves a result (`chip_smoke.py`, `tools/lm_fp32_spread.py`).

The model code upcasts to fp32 with `Tensor.float()` (softmax, norms,
router probabilities, SSM states). In a float64 run those upcasts must
keep float64, so `float_is_double` makes `.float()` return float64 for
the length of a `with` block.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float_is_double():
    """Within the block every `Tensor.float()` computes in float64. The
    patch is process-wide and comes off when the block ends, also when it
    ends with an exception."""
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = real
