"""Plain PyTorch version of the Mamba2 SSD chunked scan (the CPU path, the
backward's recompute, and what the kernel is held to on the card).

A copy of the JAX package's `models/ssm.py::ssd_reference` with its
`_segsum`: the same `nc = max(s // chunk, 1)` chunks of `q = s // nc`
rows, fp32 throughout, the inter-chunk `lax.scan` as a Python loop.
Where `nc` chunks of `q` rows do not cover `s` (the JAX reference then
fails to reshape), the sequence is padded at its end with rows of zero
input and zero log decay, which leave every earlier output and the
carried state exactly as they were, and the padding is cut off again.
"""
from __future__ import annotations

import torch


def _segsum(a):
    """a: (..., q) -> (..., q, q) with out[i,j]=sum_{k=j+1..i} a_k, i>=j."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_reference(xbar, log_a, Bm, Cm, chunk, initial_state=None):
    """Chunked state-space-duality scan (Mamba2 §6 minimal algorithm).

    xbar: (b,s,h,p)  inputs already scaled by dt
    log_a: (b,s,h)   dt * A  (negative)
    Bm, Cm: (b,s,h,n) input/output projections (already group-broadcast)
    Returns y: (b,s,h,p) in xbar's dtype, final_state: (b,h,p,n) fp32
    """
    b, s, h, p = xbar.shape
    n = Bm.shape[-1]
    q = s // max(s // chunk, 1)
    nc = -(-s // q)
    pad = nc * q - s

    def chunks(t, *tail):
        t = t.float()
        if pad:
            t = torch.nn.functional.pad(t, (0, 0) * len(tail) + (0, pad))
        return t.reshape(b, nc, q, *tail)

    xb = chunks(xbar, h, p)
    la = chunks(log_a, h)
    Bc = chunks(Bm, h, n)
    Cc = chunks(Cm, h, n)

    la_cs = torch.cumsum(la, dim=2)                    # (b,c,q,h) inclusive
    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(la.permute(0, 1, 3, 2)))     # (b,c,h,q,q)
    att = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    y_diag = torch.einsum("bchij,bchij,bcjhp->bcihp", att, L, xb)
    # 2. per-chunk end states
    decay_end = torch.exp(la_cs[:, :, -1:, :] - la_cs)  # (b,c,q,h)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bc, decay_end, xb)
    # 3. inter-chunk recurrence, the state BEFORE each chunk kept
    chunk_decay = torch.exp(la_cs[:, :, -1, :])        # (b,c,h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=xbar.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)             # (b,c,h,p,n)
    # 4. contribution of carried state to each position
    state_decay = torch.exp(la_cs)                     # (b,c,q,h)
    y_off = torch.einsum("bcihn,bchpn,bcih->bcihp", Cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y.to(xbar.dtype), carry
