"""The run's weights, made by the benchmark from `--seed` on the device
with a generator of that device, one draw a leaf (the layers of a leaf
are stacked), in the dtype they are stored in. The same seed on the same
device gives the same weights, so the reference makes them again after
the window instead of keeping a copy.

"normal" leaves are drawn with the standard deviation 1/sqrt(fan_in) of
the products they enter, "embed" with 0.02; any other init is the
family's own (its `INITS`: Mamba2's per-head scalars follow its published
initialisation).
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def make(family, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """flat key -> tensor of the schema of the configuration's family."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    z = family.dims(cfg)
    out = {}
    for key, shape, dtype, init, fan_in in family.schema(cfg):
        if init == "ones":
            x = torch.ones(shape, device=dev)
        elif init == "zeros":
            x = torch.zeros(shape, device=dev)
        elif init == "embed":
            x = torch.randn(shape, generator=gen, device=dev) * 0.02
        elif init == "normal":
            x = torch.randn(shape, generator=gen, device=dev) \
                / math.sqrt(fan_in)
        elif init in family.INITS:
            x = family.INITS[init](shape, gen, dev, z)
        else:
            raise ValueError(f"{key}: unknown init {init!r}")
        out[key] = x.to(dtype)
    return out
