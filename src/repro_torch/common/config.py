"""Model configuration for the PyTorch port.

Copies of `SSMConfig`, `RGLRUConfig` and `ModelConfig` from the JAX
package's `common/config.py`, kept here because the port imports
nothing from that package. Field names and derived properties are the
same, so a config reads alike in both; `activation_dtype` and
`param_torch_dtype` give torch dtypes.

Fields that only steer the JAX package's TPU path are left out:
`use_pallas` (the port always runs its kernels on the card),
`attn_chunk` (the chunked-attention fallback is not ported),
`scan_layers`, `grad_accum` and `sharding_overrides`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Layer kinds used in block patterns.
# ---------------------------------------------------------------------------
ATTN = "attn"            # global self attention (GQA / MHA)
LOCAL_ATTN = "local_attn"  # sliding-window self attention
CROSS_ATTN = "cross_attn"  # cross attention to (stub) image embeddings
MAMBA2 = "mamba2"        # SSD state-space layer
RGLRU = "rglru"          # Griffin recurrent block (RG-LRU)

SUPPORTED_KINDS = (ATTN, LOCAL_ATTN, CROSS_ATTN, MAMBA2, RGLRU)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD hyper-parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """Griffin / RecurrentGemma recurrent-block hyper-parameters."""
    lru_width: Optional[int] = None   # defaults to d_model
    conv_width: int = 4
    c_constant: float = 8.0           # the fixed `c` exponent scale


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype string ("float32", "bfloat16")."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {list(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|ssm|hybrid|moe|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    # Block pattern. A model is `num_layers` layers tiled by `pattern`;
    # remainder layers (num_layers % len(pattern)) form an explicit tail
    # taking the pattern prefix.
    pattern: Tuple[str, ...] = (ATTN,)
    # attention
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    window_size: int = 2048            # for local_attn layers
    logit_softcap: Optional[float] = None
    # mlp
    mlp_kind: str = "swiglu"           # swiglu|gelu
    # MoE sub-config; the port does not run MoE yet, and `models.lm`
    # raises NotImplementedError when one is set
    moe: Optional[Any] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True

    # ------------------------------------------------------------------
    def __post_init__(self):
        for k in self.pattern:
            if k not in SUPPORTED_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires MoEConfig")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def n_super(self) -> int:
        """Number of full pattern repetitions (the stacked blocks)."""
        return self.num_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        """Remainder layers appended after the stacked super-blocks."""
        return self.pattern[: self.num_layers % len(self.pattern)]

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)
