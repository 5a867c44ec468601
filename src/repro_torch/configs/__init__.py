"""Architecture registry of the port: ``get_config(arch)`` resolves here.

Each module exposes FULL (the published config) and SMOKE (a reduced
same-family config that trains on the CPU in the tests). Only the
architectures the port runs are listed; the others follow with the
model families they need (ROADMAP §1, queued item 5).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.common.config import ModelConfig

_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "mamba2-1.3b": "mamba2_1p3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.FULL
