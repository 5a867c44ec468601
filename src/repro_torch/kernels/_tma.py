"""What the tensor-core kernels' TMA tensor maps take: a (B, rows, N, cols)
bf16 tensor addressed through its strides, as it lies or as a copy.

Shared by the bf16 routes of flash attention and the SSD scan, whose C
entries build 4-D tensor maps over such tensors.
"""
from __future__ import annotations


def tma_ready(x):
    """Whether a tensor map can address x as it lies: a 16-byte-aligned
    base, the last dim contiguous, and the other three strides positive
    multiples of 8 elements (16 bytes). A dim of size 1 never steps, so
    its stride does not count."""
    if x.stride(3) != 1 or x.data_ptr() % 16:
        return False
    return all(size == 1 or (st > 0 and st % 8 == 0)
               for size, st in zip(x.shape[:3], x.stride()[:3]))


def map_strides(x):
    """x's first three strides, with 8 for a dim of size 1, which the
    tensor map must still be given as a multiple of 16 bytes."""
    return [8 if size == 1 else st
            for size, st in zip(x.shape[:3], x.stride()[:3])]
