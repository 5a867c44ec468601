"""Core transformer layers of the port: parameter schemas, RMSNorm, RoPE,
self attention (global or sliding-window, GQA, softcap) and the dense MLP.

Counterpart of the JAX package's `models/layers.py`; the functions take
the same parameter dicts, layouts and shape letters: B=batch, S=query
seq, T=kv seq, D=d_model, N=q heads, K=kv heads, G=N//K, H=head_dim,
F=d_ff. Self attention always runs the flash-attention op, as the JAX
path does under `cfg.use_pallas`. Cross attention, MoE and the decode
path are not ported yet (ROADMAP §1, queued items 5 and 6).
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


def attention(p, x, cfg, *, kind):
    """Self / sliding-window attention. x: (B,S,D) -> (B,S,D)."""
    if kind == C.CROSS_ATTN:
        raise NotImplementedError(
            "cross attention is not ported yet (ROADMAP §1, queued item 5)")
    S = x.shape[1]
    g = cfg.num_heads // cfg.num_kv_heads

    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("btd,dnh->btnh", x, p["wk"])
    v = torch.einsum("btd,dnh->btnh", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]

    positions = torch.arange(S, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    # GQA: expand kv to the full head count, as the JAX layer does
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    window = cfg.window_size if kind == C.LOCAL_ATTN else None
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                 softcap=cfg.logit_softcap)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"])


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
