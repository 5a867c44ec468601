"""The benchmark's own work arithmetic: what a kernel launch or a round
needs, from shapes alone, and its least time on a card's published peaks.

`attention_work` and `ssd_flops` are copies of the program's
`repro_torch/launch/roofline.py`, frozen here so that a change to the
program cannot move the yardstick (the ssd's bytes and the codec's work
are copied into their metrics' own readers). Each input byte is counted
read once and each output byte written once. A family's `model_flops`
(`fedbench/families/`) is built from these.
"""
from __future__ import annotations

import math

# the tensor-core ssd kernel cuts the sequence into pieces of this many
# rows, whatever chunk the model names
SSD_PIECE = 128


def attention_work(B, S, T, N, H, elem_bytes, causal=True, window=None):
    """The flash forward: q, k, v read and o written; the multiply-adds
    of QK^T and PV over the (query, key) pairs the mask leaves."""
    pairs = 0
    for i in range(S):
        hi = min(i, T - 1) if causal else T - 1
        lo = max(0, i - window + 1) if window else 0
        pairs += max(hi - lo + 1, 0)
    return 4.0 * H * pairs * B * N, 2 * (S + T) * B * N * H * elem_bytes


def ssd_flops(b, s, h, p, n, chunk):
    """The chunked scan's products, a chunk of Q rows: C B^T and (.)x over
    the Q(Q+1)/2 causal pairs, C . state and the state update."""
    flops = 0.0
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        flops += 2.0 * (q * (q + 1) // 2) * (n + p) + 4.0 * q * n * p
    return flops * b * h


def bound_s(flops, nbytes, flops_peak, bytes_peak):
    """The least time of the work: the larger of its two terms."""
    return max(flops / flops_peak, nbytes / bytes_peak)


def layer_dims(z: dict, kind: str):
    """The sizes of a family's layers of `kind` in its `dims` (the metric
    readers' `ctx["dims"]`): `z[kind]` for a family of several kinds, `z`
    itself for a family of that one kind, None for a family without."""
    if kind in z:
        return z[kind]
    return z if z.get("kind") == kind else None


def round_tokens(mix: dict) -> int:
    return mix["clients"] * mix["local_steps"] * mix["batch"] * mix["seq"]


def product_params(d, v, entries, counted) -> int:
    """Parameters that enter a matrix product of the forward: the output
    head's d x v (the tied table counts once, as the head) and every leaf
    of the schema `entries` that `counted(key, init)` keeps."""
    return d * v + sum(math.prod(shape) for key, shape, _, init, _ in entries
                       if counted(key, init))
