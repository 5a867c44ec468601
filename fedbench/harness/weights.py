"""The run's weights, made by the benchmark from `--seed` on the device
with a generator of that device, one draw a leaf (the layers of a leaf
are stacked), in the dtype they are stored in. The same seed on the same
device gives the same weights, so the reference makes them again after
the window instead of keeping a copy.

"normal" leaves are drawn with the standard deviation 1/sqrt(fan_in) of
the products they enter, "embed" with 0.02; the Mamba2 per-head scalars
follow its published initialisation: A_log = log U(lo, hi), and dt_bias
the inverse softplus of a dt drawn log-uniform in [dt_min, dt_max].
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from fedbench.reference.schema import dims, schema


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """flat key -> tensor of the configuration's schema."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    z = dims(cfg)
    out = {}
    for key, shape, dtype, init, fan_in in schema(cfg):
        if init == "ones":
            x = torch.ones(shape, device=dev)
        elif init == "zeros":
            x = torch.zeros(shape, device=dev)
        elif init == "embed":
            x = torch.randn(shape, generator=gen, device=dev) * 0.02
        elif init == "normal":
            x = torch.randn(shape, generator=gen, device=dev) \
                / math.sqrt(fan_in)
        elif init == "a_log":
            lo, hi = z["a_range"]
            x = torch.log(torch.rand(shape, generator=gen, device=dev)
                          * (hi - lo) + lo)
        elif init == "dt_bias":
            u = torch.rand(shape, generator=gen, device=dev)
            lo, hi = math.log(z["dt_min"]), math.log(z["dt_max"])
            dt = torch.exp(u * (hi - lo) + lo)
            x = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(f"{key}: unknown init {init!r}")
        out[key] = x.to(dtype)
    return out
