"""Core transformer layers of the port: parameter schemas, RMSNorm, RoPE,
attention (global or sliding-window self attention, cross attention;
GQA, softcap), the dense MLP and GShard capacity-routed MoE.

Counterpart of the JAX package's `models/layers.py`; the functions take
the same parameter dicts, layouts and shape letters: B=batch, S=query
seq, T=kv seq, D=d_model, N=q heads, K=kv heads, G=N//K, H=head_dim,
F=d_ff, E=experts, C=capacity. Self attention always runs the
flash-attention op, as the JAX path does under `cfg.use_pallas`; cross
attention is plain PyTorch, as the JAX package never sends it to its
kernel. `decode_attention` is the one-token step of every attention
kind over a KV cache (a ring buffer of the window for local attention),
plain PyTorch as in the JAX package, whose decode path runs no kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import config as C
from repro_torch.common.bridge import flatten_with_paths, unflatten
from repro_torch.kernels.flash_attention import ops as fa_ops


# ---------------------------------------------------------------------------
# Param schema plumbing.
# ---------------------------------------------------------------------------
class ParamSpec:
    """Declarative parameter: shape + logical axes + initializer."""

    __slots__ = ("shape", "axes", "init", "dtype")

    def __init__(self, shape, axes, init="normal", dtype=None):
        assert len(shape) == len(axes), (shape, axes)
        self.shape = tuple(shape)
        self.axes = tuple(axes)
        self.init = init
        self.dtype = dtype

    def materialize(self, gen, dtype, device):
        """Draw the parameter on the CPU from `gen` (so a seed gives the
        same weights on every device), then move it to `device`."""
        dtype = self.dtype or dtype
        if self.init == "zeros":
            x = torch.zeros(self.shape)
        elif self.init == "ones":
            x = torch.ones(self.shape)
        elif self.init == "normal":
            fan_in = self.shape[0] if self.shape else 1
            x = torch.randn(self.shape, generator=gen) / math.sqrt(
                max(fan_in, 1))
        elif self.init == "embed":
            x = torch.randn(self.shape, generator=gen) * 0.02
        elif callable(self.init):
            # a schema's own initializer: (gen, shape) -> fp32 CPU tensor
            x = self.init(gen, self.shape)
        else:
            raise ValueError(self.init)
        return x.to(dtype).to(device)


def materialize_tree(schema, gen, dtype, device):
    """Tensors for every spec of `schema`, drawn in sorted-key order."""
    return unflatten({k: s.materialize(gen, dtype, device)
                      for k, s in flatten_with_paths(schema)})


def stack_specs(schema, n, axis_name="layers"):
    """Prefix every spec with a stacked leading dim (one slice per layer)."""
    return unflatten({
        k: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.dtype)
        for k, s in flatten_with_paths(schema)})


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------
def rms_norm_schema(d):
    return {"scale": ParamSpec((d,), ("norm",), "ones", dtype=torch.float32)}


def rms_norm(x, p, eps):
    """RMSNorm with fp32 statistics; the normalization multiply stays in
    the input dtype, in the JAX package's order."""
    dt = x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * p["scale"].to(dt)


# ---------------------------------------------------------------------------
# RoPE.
# ---------------------------------------------------------------------------
def rope(x, positions, theta):
    """x: (..., S, n, H) rotated in (S) by `positions` (..., S)."""
    h = x.shape[-1]
    half = h // 2
    freq = torch.arange(0, half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freq / half)                           # (half,)
    ang = positions[..., None].float() * inv                # (..., S, half)
    sin = torch.sin(ang)[..., None, :]                      # (..., S, 1, half)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    # bf16 x times fp32 sin/cos promotes to fp32, cast back at the end
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------
def attention_schema(cfg):
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nk = cfg.num_heads, cfg.num_kv_heads
    s = {
        "wq": ParamSpec((d, nq, h), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, nk, h), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, nk, h), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((nq, h, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((nq, h), ("heads", "head_dim"), "zeros")
        s["bk"] = ParamSpec((nk, h), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamSpec((nk, h), ("kv_heads", "head_dim"), "zeros")
    return s


def _soft_cap(scores, cap):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _cross_attn(q, k, v, softcap):
    """Full (not causal) attention of q (B,S,N,H) over k, v (B,T,N,H):
    fp32 scores, softcap, fp32 softmax, the weights cast to q's dtype.
    The JAX package computes it in query chunks; each row's softmax is
    whole there too, so one pass gives the same numbers."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqnh,btnh->bnqt", q.float(), k.float()) * scale
    p = torch.softmax(_soft_cap(s, softcap), dim=-1).to(q.dtype)
    return torch.einsum("bnqt,btnh->bqnh", p, v)


def attention(p, x, cfg, *, kind, cond=None):
    """Self / sliding-window / cross attention. x: (B,S,D) -> (B,S,D);
    a cross layer attends to `cond` (B,T,D), without RoPE or a mask. A
    self-attention layer rotates q and k by RoPE unless
    `cfg.position_embedding` is "none", and scales its scores by
    `cfg.attention_scale` where that is set (else 1/sqrt(h))."""
    cross = kind == C.CROSS_ATTN
    if cross and cond is None:
        raise ValueError("a cross-attention layer needs `cond` (B,T,D)")
    src = cond if cross else x
    S = x.shape[1]
    g = cfg.num_heads // cfg.num_kv_heads

    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("btd,dnh->btnh", src, p["wk"])
    v = torch.einsum("btd,dnh->btnh", src, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]

    if not cross and cfg.position_embedding == "rope":
        positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    # GQA: expand kv to the full head count, as the JAX layer does
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    if cross:
        out = _cross_attn(q, k, v, cfg.logit_softcap)
    else:
        window = cfg.window_size if kind == C.LOCAL_ATTN else None
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                     softcap=cfg.logit_softcap,
                                     scale=cfg.attention_scale)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"])


def decode_attention(p, x, cfg, *, kind, cache, pos, cond_kv=None):
    """One-token decode. x: (B,1,D); cache: dict(k,v: (B,L,K,H)); `pos`:
    (B,) current position per sequence. Returns (y, cache).

    Global attention writes the new k/v row at slot `pos`, local
    attention at `pos % L` of a ring buffer of L = window slots; both
    write in place (the JAX package returns a new cache and its step
    donates the old one), and the cache comes back as given. A cross
    layer reads `cond_kv` (k, v: (B,T,K,H)) and leaves `cache` alone.
    Scores and softmax are fp32 with -1e30 masking, grouped (B,K,G,H).
    RoPE and the scores' scale of a self-attention layer follow `cfg`
    as in `attention`."""
    B = x.shape[0]
    nq, nk, h = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = nq // nk

    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]

    if kind == C.CROSS_ATTN:
        # static cross KV, precomputed at prefill time
        k, v = cond_kv["k"], cond_kv["v"]
        valid = torch.ones((B, k.shape[1]), dtype=torch.bool,
                           device=x.device)
    else:
        knew = torch.einsum("btd,dnh->btnh", x, p["wk"])
        vnew = torch.einsum("btd,dnh->btnh", x, p["wv"])
        if cfg.qkv_bias:
            knew = knew + p["bk"]
            vnew = vnew + p["bv"]
        if cfg.position_embedding == "rope":
            q = rope(q, pos[:, None], cfg.rope_theta)
            knew = rope(knew, pos[:, None], cfg.rope_theta)
        k, v = cache["k"], cache["v"]
        L = k.shape[1]
        # a ring buffer of the window: W tokens, the current one included,
        # as the flash kernel's kpos > qpos - window
        slot = pos % L if kind == C.LOCAL_ATTN else pos
        bidx = torch.arange(B, device=x.device)
        k[bidx, slot] = knew[:, 0].to(k.dtype)
        v[bidx, slot] = vnew[:, 0].to(v.dtype)
        idx = torch.arange(L, device=x.device)
        if kind == C.LOCAL_ATTN:
            valid = (idx[None] <= slot[:, None]) | (pos[:, None] >= L)
        else:
            valid = idx[None] <= pos[:, None]

    qf = q.reshape(B, nk, g, h).float()
    s = torch.einsum("bkgh,btkh->bkgt", qf, k.float())
    scale = None if kind == C.CROSS_ATTN else cfg.attention_scale
    s = s / math.sqrt(h) if scale is None else s * scale
    s = _soft_cap(s, cfg.logit_softcap)
    s = torch.where(valid[:, None, None], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", pr, v.float())
    o = o.reshape(B, 1, nq, h).to(x.dtype)
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"]), cache


# ---------------------------------------------------------------------------
# Dense MLP.
# ---------------------------------------------------------------------------
def mlp_schema(cfg):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {
            "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
            "wi_up": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp(p, x, cfg):
    if cfg.mlp_kind == "swiglu":
        gate = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
        up = torch.einsum("bsd,df->bsf", x, p["wi_up"])
        h = F.silu(gate) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["wi"]),
                   approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard capacity routing, top-k).
# ---------------------------------------------------------------------------
def moe_schema(cfg):
    d = cfg.d_model
    e, f = cfg.moe.num_experts, cfg.moe.d_ff
    s = {"router": ParamSpec((d, e), ("embed", None))}
    if cfg.mlp_kind == "swiglu":
        s["wi_gate"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"))
        s["wi_up"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"))
        s["wo"] = ParamSpec((e, f, d), ("experts", "mlp", "embed"))
    else:
        s["wi"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"))
        s["wo"] = ParamSpec((e, f, d), ("experts", "mlp", "embed"))
    return s


def moe_capacity(cfg, group_tokens: int) -> int:
    m = cfg.moe
    cap = int(math.ceil(group_tokens * m.top_k * m.capacity_factor
                        / m.num_experts))
    return max(cap, m.top_k)


def _one_hot(idx, n):
    """`jax.nn.one_hot`: an index outside [0, n) gives a zero row (a
    dropped token's queue position), where `F.one_hot` would raise."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(x, k):
    """The k largest entries along the last dim, in `lax.top_k`'s order:
    descending, equal values by lower index first. `torch.topk` orders
    ties otherwise, and a slot's order is its GShard queue priority."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(p, x, cfg):
    """x: (B,S,D) -> ((B,S,D), aux loss). GShard one-hot dispatch with
    per-group capacity; a token whose slot lands past its expert's
    capacity is dropped from that expert."""
    m = cfg.moe
    B, S, D = x.shape
    gs = min(m.group_size, B * S)
    if (B * S) % gs:
        raise ValueError(f"moe: {B}x{S} tokens are no whole number of "
                         f"dispatch groups of {gs}")
    ng = B * S // gs
    E, K = m.num_experts, m.top_k
    cap = moe_capacity(cfg, gs)

    xg = x.reshape(ng, gs, D)
    logits = torch.einsum("gsd,de->gse", xg, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)                 # (ng, gs, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    onehot = _one_hot(expert_idx, E)                        # (ng,gs,K,E)
    # position of each (token, slot) within its expert queue, priority by
    # (slot-major, token) order as in GShard
    flat = onehot.transpose(1, 2).reshape(ng, K * gs, E)
    pos = torch.cumsum(flat, dim=1) - flat                  # (ng, K*gs, E)
    pos = pos.reshape(ng, K, gs, E).transpose(1, 2)         # (ng,gs,K,E)
    pos = (pos * onehot).sum(-1)                            # (ng, gs, K)
    within = (pos < cap).float()

    pos_oh = _one_hot(pos, cap) * within[..., None]
    dispatch = torch.einsum("gske,gskc->gsec", onehot, pos_oh)
    combine = torch.einsum("gsk,gske,gskc->gsec", gate_vals, onehot, pos_oh)

    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wi_gate"])) \
            * torch.einsum("gecd,edf->gecf", xe, p["wi_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.einsum("gecd,edf->gecf", xe, p["wi"]),
                   approximate="tanh")
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])         # (ng,E,C,D)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    return y.reshape(B, S, D), _aux_loss(probs, onehot)


def _aux_loss(probs, onehot):
    """Load-balancing auxiliary loss (Switch-style)."""
    # probs: (ng, gs, E); onehot: (ng, gs, K, E)
    E = probs.shape[-1]
    frac_tokens = onehot.sum(2).mean(1)                     # (ng, E)
    frac_probs = probs.mean(1)                              # (ng, E)
    return (frac_tokens * frac_probs).sum(-1).mean() * E
