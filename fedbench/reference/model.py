"""Plain PyTorch pieces of the benchmark's language models, in float32,
with no kernel of the program; a family (`fedbench/families/`) builds its
loss of a batch from them.

They follow the published layer equations as the port states them:
RMSNorm before each mixer and MLP, residual adds; attention with RoPE
(half-split rotation) and a causal softmax over every earlier position;
a SwiGLU MLP; the Mamba2 mixer (z, x, B, C and dt projections, a
depthwise causal conv with bias and SiLU over x|B|C, softplus dt with a
bias, A = -exp(A_log), the chunked SSD scan, the D skip, a gated RMSNorm,
the output projection); and `lm_loss`: the embedding, the layers, a final
RMSNorm, the output head (the embedding table's transpose where tied),
and the mean token cross-entropy.

Every layer is checkpointed (its activations recomputed in the backward),
which changes no number and keeps the float32 round of the deepest cell
inside one card. `Precision.cast` is applied to both operands of every
dense product: the identity here, a rounding to fp8 in the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class Precision:
    """The products' operand precision: float32, unchanged."""

    def cast(self, t):
        return t


class Fp8Products(Precision):
    """The control: each operand of a dense product rounded to
    float8_e4m3fn under one scale a tensor (its largest magnitude onto
    448), the product then taken in float32. The backward passes the
    gradient straight through the rounding."""

    def cast(self, t):
        amax = t.detach().abs().amax().clamp(min=1e-30)
        scale = amax / 448.0
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (q - t).detach()


def rms_norm(x, scale, eps):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale


def rope(x, theta):
    """x (B,S,N,H) rotated by its position along S."""
    s, h = x.shape[1], x.shape[-1]
    half = h // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freq / half)
    ang = torch.arange(s, device=x.device).float()[:, None] * inv
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _proj(eq, x, w, prec):
    return torch.einsum(eq, prec.cast(x), prec.cast(w))


def attention(p, x, z, prec):
    q = _proj("bsd,dnh->bsnh", x, p["wq"], prec)
    k = _proj("bsd,dnh->bsnh", x, p["wk"], prec)
    v = _proj("bsd,dnh->bsnh", x, p["wv"], prec)
    q, k = rope(q, z["theta"]), rope(k, z["theta"])
    g = z["n"] // z["k"]
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    s = x.shape[1]
    scores = _proj("bqnh,btnh->bnqt", q, k, prec) / math.sqrt(z["h"])
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = _proj("bnqt,btnh->bqnh", probs, v, prec)
    return _proj("bsnh,nhd->bsd", out, p["wo"], prec)


def swiglu(p, x, prec):
    gate = _proj("bsd,df->bsf", x, p["wi_gate"], prec)
    up = _proj("bsd,df->bsf", x, p["wi_up"], prec)
    return _proj("bsf,fd->bsd", F.silu(gate) * up, p["wo"], prec)


def _segsum(a):
    """a (..., q) -> (..., q, q): out[i, j] = a[j+1] + ... + a[i] for
    i >= j, -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd(xbar, log_a, Bm, Cm, chunk):
    """The chunked state-space-duality scan (Mamba2, section 6's minimal
    algorithm): xbar (b,s,h,p), log_a (b,s,h), Bm and Cm (b,s,h,n), a zero
    initial state. The sequence is padded at its end with zero input and
    zero decay where the chunks do not cover it."""
    b, s, h, p = xbar.shape
    n = Bm.shape[-1]
    q = s // max(s // chunk, 1)
    nc = -(-s // q)
    pad = nc * q - s

    def chunks(t, *tail):
        if pad:
            t = F.pad(t, (0, 0) * len(tail) + (0, pad))
        return t.reshape(b, nc, q, *tail)

    xb, la = chunks(xbar, h, p), chunks(log_a, h)
    Bc, Cc = chunks(Bm, h, n), chunks(Cm, h, n)
    la_cs = torch.cumsum(la, dim=2)
    L = torch.exp(_segsum(la.permute(0, 1, 3, 2)))
    att = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    y_diag = torch.einsum("bchij,bchij,bcjhp->bcihp", att, L, xb)
    decay_end = torch.exp(la_cs[:, :, -1:, :] - la_cs)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bc, decay_end, xb)
    chunk_decay = torch.exp(la_cs[:, :, -1, :])
    carry = torch.zeros((b, h, p, n), dtype=xbar.dtype, device=xbar.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    y_off = torch.einsum("bcihn,bchpn,bcih->bcihp", Cc,
                         torch.stack(prev, dim=1), torch.exp(la_cs))
    return (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]


def mamba2(p, x, z, prec):
    b, s, _ = x.shape
    d_in, nh, gn = z["d_in"], z["nh"], z["g"] * z["n"]
    zg = _proj("bsd,di->bsi", x, p["wz"], prec)
    xi = _proj("bsd,di->bsi", x, p["wx"], prec)
    Bm = _proj("bsd,dn->bsn", x, p["wB"], prec)
    Cm = _proj("bsd,dn->bsn", x, p["wC"], prec)
    dt = _proj("bsd,dh->bsh", x, p["wdt"], prec)
    u = torch.cat([xi, Bm, Cm], dim=-1)
    k = p["conv_w"].shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    conv = sum(pad[:, i:i + s] * p["conv_w"][i] for i in range(k))
    u = F.silu(conv + p["conv_b"])
    xi, Bm, Cm = u[..., :d_in], u[..., d_in:d_in + gn], u[..., d_in + gn:]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(b, s, nh, z["p"])
    rep = nh // z["g"]
    Bh = torch.repeat_interleave(Bm.reshape(b, s, z["g"], z["n"]), rep, 2)
    Ch = torch.repeat_interleave(Cm.reshape(b, s, z["g"], z["n"]), rep, 2)
    y = ssd(xh * dt[..., None], dt * A, Bh, Ch, z["chunk"])
    y = (y + xh * p["D"][:, None]).reshape(b, s, d_in)
    y = rms_norm(y * F.silu(zg), p["norm"], z["eps"])
    return _proj("bsi,id->bsd", y, p["wo"], prec)


def group(p, name):
    """The leaves of `p` under `name/`, with that prefix taken off."""
    cut = len(name) + 1
    return {k[cut:]: v for k, v in p.items() if k.startswith(name + "/")}


def lm_loss(params, z, tokens, labels, prec, block, repeats):
    """Mean token cross-entropy of one batch. `params`: flat key ->
    float32 tensor (the family's schema); tokens, labels (B,S) int64.
    `block`: [(prefix, layer)] in the order the block runs them, each
    `layer(p, x) -> x` given the leaves under its prefix (stacked over the
    block's `repeats`) at one repeat, the prefix taken off."""
    x = params["embed/table"][tokens]
    layers = []
    for prefix, layer in block:
        names = sorted(k[len(prefix):] for k in params
                       if k.startswith(prefix))
        layers.append((prefix, names, _checkpointed(layer, names)))
    for i in range(repeats):
        for prefix, names, run in layers:
            leaves = [params[prefix + k][i] for k in names]
            x = checkpoint(run, x, *leaves, use_reentrant=False)
    x = rms_norm(x, params["final_norm/scale"], z["eps"])
    head = (params["embed/table"].T if z["tied"]
            else params["lm_head/table"])
    logits = _proj("bsd,dv->bsv", x, head, prec)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def _checkpointed(layer, names):
    def run(x, *leaves):
        return layer(dict(zip(names, leaves)), x)
    return run
