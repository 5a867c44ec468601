"""Plain PyTorch version of the flash-attention forward (the CPU path, the
backward's recompute, and what the kernel is held to on the card)."""
from __future__ import annotations

import math

import torch


def reference_attention(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    """q: (BN, S, H); k, v: (BN, T, H). Naive fp32 softmax attention, the
    scores times `scale` (None: divided by sqrt(H))."""
    BN, S, H = q.shape
    T = k.shape[1]
    s = torch.einsum("bsh,bth->bst", q.float(), k.float())
    s = s / math.sqrt(H) if scale is None else s * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bst,bth->bsh", p, v.float())
    return out.to(q.dtype)
