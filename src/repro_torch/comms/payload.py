"""Client-update payload sizing: a copy of the JAX package's
`comms/payload.py` for the port's parameter dicts.

One FL round uploads one model-sized update per participating client,
in one of two wire formats:

* fp32 — each leaf uploads as raw float32, 4 bytes per element.
* quantized — each leaf uploads in the `kernels.grad_quant` block
  layout: int8 values padded to full `BLOCK`-wide rows plus one fp32
  scale per row, exactly what `grad_quant.ops.quantize` returns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.common.bridge import flatten_with_paths
from repro_torch.kernels.grad_quant.ops import BLOCK

_FP32_BYTES = 4


def fp32_leaf_bytes(n: int) -> int:
    """Wire bytes for one n-element leaf uploaded as raw float32."""
    return int(n) * _FP32_BYTES


def quantized_leaf_bytes(n: int) -> int:
    """Wire bytes for one n-element leaf in the grad_quant block layout:
    `nb = ceil(n/BLOCK)` full int8 rows (minimum one), padding included,
    plus one fp32 scale per row."""
    nb = max((int(n) + BLOCK - 1) // BLOCK, 1)
    return nb * BLOCK + nb * _FP32_BYTES


@dataclasses.dataclass(frozen=True)
class UpdatePayload:
    """Byte-exact size of one client's update upload.

    `n_params`/`n_leaves` describe the parameter dict the bytes were
    derived from; `num_bytes` is the wire size in the chosen format.
    """
    n_params: int
    n_leaves: int
    num_bytes: int
    quantized: bool = False

    @property
    def size_mb(self) -> float:
        """Wire size in MB (2**20 bytes), the unit provider rates use."""
        return self.num_bytes / float(1 << 20)

    @classmethod
    def from_tree(cls, tree: Any, quantized: bool = False) -> "UpdatePayload":
        """Size an update from the parameter dict, leaf by leaf — each
        leaf is quantized independently, so padding is summed per leaf."""
        counts = [math.prod(leaf.shape)
                  for _, leaf in flatten_with_paths(tree)]
        per_leaf = quantized_leaf_bytes if quantized else fp32_leaf_bytes
        return cls(n_params=sum(counts), n_leaves=len(counts),
                   num_bytes=sum(per_leaf(n) for n in counts),
                   quantized=quantized)

    @classmethod
    def from_mb(cls, size_mb: float,
                quantized: bool = False) -> "UpdatePayload":
        """Back a modeled size (`FLRunConfig.update_payload_mb`) into a
        payload, treating it as one flat fp32 leaf of the equivalent
        element count so the quantized variant prices consistently."""
        n = max(int(round(size_mb * (1 << 20))) // _FP32_BYTES, 0)
        per_leaf = quantized_leaf_bytes if quantized else fp32_leaf_bytes
        return cls(n_params=n, n_leaves=1, num_bytes=per_leaf(n),
                   quantized=quantized)
