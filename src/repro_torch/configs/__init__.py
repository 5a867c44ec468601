"""Architecture registry of the port: ``get_config(arch)`` resolves here.

Each module exposes FULL (the published config) and SMOKE (a reduced
same-family config that trains on the CPU in the tests). The ten
architectures of the JAX package's registry, in its order, and the
dry run's cells: every (arch, shape) pair after the rule-based skips.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.common.config import SHAPES, ModelConfig

_MODULES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "glm4-9b": "glm4_9b",
    "command-r-35b": "command_r_35b",
    "qwen1.5-110b": "qwen1p5_110b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "dbrx-132b": "dbrx_132b",
    "musicgen-medium": "musicgen_medium",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.FULL


def applicable_shapes(arch: str) -> List[str]:
    """The assigned shape set, minus rule-based skips: long_500k only for
    sub-quadratic (SSM / hybrid) architectures."""
    cfg = get_config(arch)
    out = []
    for name, sh in SHAPES.items():
        if name == "long_500k" and not cfg.is_subquadratic:
            continue
        out.append(name)
    return out


def all_cells():
    """Every (arch, shape) dry-run cell after rule-based skips."""
    return [(a, s) for a in ARCH_IDS for s in applicable_shapes(a)]


def skipped_cells():
    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if s not in applicable_shapes(a)]
