"""Plain PyTorch versions of the RG-LRU linear recurrence, of its
reverse and of its backward (the CPU path, and what the kernel is held to
on the card).

Both walk the sequence one step at a time in fp32: an oracle independent
of the kernel's chunking, and free of the overflow of a cumulative sum in
log space, where exp(-cumsum) passes fp32's range after a few hundred
steps at recurrentgemma's decays.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rglru_scan_ref(log_a, b):
    """h_t = exp(log_a_t) * h_{t-1} + b_t over axis 1, h_{-1} = 0.
    (B,S,W) -> (B,S,W) in b's dtype."""
    a = torch.exp(log_a.float())
    u = b.float()
    h = torch.zeros_like(u[:, 0])
    out = []
    for t in range(u.shape[1]):
        h = a[:, t] * h + u[:, t]
        out.append(h)
    return torch.stack(out, dim=1).to(b.dtype)


def rglru_scan_reverse_ref(log_a, g):
    """The recurrence walked from the end, the backward of `rglru_scan_ref`:
    out_t = exp(log_a_{t+1}) * out_{t+1} + g_t, out_S = 0. fp32 out."""
    a = torch.exp(log_a.float())
    u = g.float()
    acc = torch.zeros_like(u[:, 0])
    out = [None] * u.shape[1]
    for t in reversed(range(u.shape[1])):
        nxt = a[:, t + 1] if t + 1 < u.shape[1] else torch.zeros_like(acc)
        acc = nxt * acc + u[:, t]
        out[t] = acc
    return torch.stack(out, dim=1)


def rglru_scan_bwd_ref(log_a, h, gh):
    """The backward of h = `rglru_scan_ref`(log_a, b) for the output
    gradient gh: g = `rglru_scan_reverse_ref`(log_a, gh), then
    (dlog_a, db) = (g exp(log_a) h_{t-1}, g) with h_{-1} = 0. fp32 out."""
    g = rglru_scan_reverse_ref(log_a, gh)
    h_prev = F.pad(h.float()[:, :-1], (0, 0, 1, 0))
    return g * torch.exp(log_a.float()) * h_prev, g
