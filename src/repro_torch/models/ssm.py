"""State-space layers of the port: Mamba2 (SSD, chunked scan) and RG-LRU
(Griffin).

Counterpart of the JAX package's `models/ssm.py`, with its shape
letters: b=batch, s=seq, d=d_model, i=d_inner, h=ssm heads, p=head_dim,
n=d_state, g=B/C groups, w=lru width. The mixes always run the scan
kernels' ops, as the JAX mixes do under `cfg.use_pallas`: `ssd` for
Mamba2 and `rglru_scan` for RG-LRU. The one-token decode steps
(`mamba2_decode`, `rglru_decode`) and their zero states are plain
PyTorch, as in the JAX package, whose decode path runs no kernel: the
conv state is kept in the activation dtype, the SSM state and `h` in
fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import ParamSpec, rms_norm


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


# ===========================================================================
# Mamba2 (SSD).
# ===========================================================================
def mamba2_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nheads, conv_dim


def mamba2_schema(cfg):
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_dim = mamba2_dims(cfg)
    gn = s.n_groups * s.d_state

    def a_init(gen, shape):
        lo, hi = s.a_init_range
        return torch.log(_uniform(gen, shape, lo, hi))

    def dt_bias_init(gen, shape):
        u = _uniform(gen, shape)
        dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                       + math.log(s.dt_min))
        # inverse softplus
        return dt + torch.log(-torch.expm1(-dt))

    f32 = torch.float32
    return {
        "wz": ParamSpec((d, d_in), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, d_in), ("embed", "ssm_inner")),
        "wB": ParamSpec((d, gn), ("embed", None)),
        "wC": ParamSpec((d, gn), ("embed", None)),
        "wdt": ParamSpec((d, nh), ("embed", "ssm_heads")),
        "conv_w": ParamSpec((s.conv_width, conv_dim), (None, None)),
        "conv_b": ParamSpec((conv_dim,), (None,), "zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), a_init, dtype=f32),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), dt_bias_init, dtype=f32),
        "D": ParamSpec((nh,), ("ssm_heads",), "ones", dtype=f32),
        "norm": ParamSpec((d_in,), ("ssm_inner",), "ones", dtype=f32),
        "wo": ParamSpec((d_in, d), ("ssm_inner", "embed")),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv. u: (b,s,c); w: (k,c); b: (c,). A sum of
    shifted products in the input dtype, then the bias, in the JAX
    package's order (a convolution op would accumulate otherwise)."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + u.shape[1]] * w[i] for i in range(k))
    return out + b


def mamba2_mix(p, x, cfg):
    """Full Mamba2 mixing layer. x: (b,s,d) -> (b,s,d)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_in, nh, conv_dim = mamba2_dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state

    z = torch.einsum("bsd,di->bsi", x, p["wz"])
    xi = torch.einsum("bsd,di->bsi", x, p["wx"])
    Bm = torch.einsum("bsd,dn->bsn", x, p["wB"])
    Cm = torch.einsum("bsd,dn->bsn", x, p["wC"])
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"])

    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xi = conv_out[..., :d_in]
    Bm = conv_out[..., d_in:d_in + gn]
    Cm = conv_out[..., d_in + gn:]

    # jax.nn.softplus has no threshold; F.softplus returns x itself above
    # 20, where log1p(exp(x)) rounds to x in fp32 anyway
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                         # (nh,)
    xh = xi.reshape(b, s, nh, s_cfg.head_dim)
    # B and C stay per group, (b,s,g,n) views of conv_out; the op reads
    # each group for its heads without the JAX package's jnp.repeat copy
    groups = (b, s, s_cfg.n_groups, s_cfg.d_state)
    Bg, Cg = Bm.reshape(groups), Cm.reshape(groups)

    xbar = xh * dt[..., None].to(xh.dtype)
    log_a = dt * A
    y, _ = ssd_ops.ssd(xbar, log_a, Bg, Cg, chunk=s_cfg.chunk_size)
    y = y + xh * p["D"][:, None].to(y.dtype)
    y = y.reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), {"scale": p["norm"]}, cfg.norm_eps)
    return torch.einsum("bsi,id->bsd", y, p["wo"])


def mamba2_init_state(cfg, batch, dtype, device):
    s = cfg.ssm
    d_in, nh, conv_dim = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(p, x, cfg, state):
    """One-token decode. x: (b,1,d) -> ((b,1,d), new state)."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    d_in, nh, _ = mamba2_dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state

    z = torch.einsum("bsd,di->bsi", x, p["wz"])[:, 0]
    xi = torch.einsum("bsd,di->bsi", x, p["wx"])[:, 0]
    Bm = torch.einsum("bsd,dn->bsn", x, p["wB"])[:, 0]
    Cm = torch.einsum("bsd,dn->bsn", x, p["wC"])[:, 0]
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"])[:, 0]

    conv_in = torch.cat([xi, Bm, Cm], dim=-1)             # (b, conv_dim)
    window = torch.cat([state["conv"], conv_in[:, None]], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                      + p["conv_b"])

    xi = conv_out[:, :d_in]
    Bm = conv_out[:, d_in:d_in + gn]
    Cm = conv_out[:, d_in + gn:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                  # (b, nh)
    xh = xi.reshape(b, nh, s_cfg.head_dim).float()
    hpg = nh // s_cfg.n_groups
    Bh = torch.repeat_interleave(
        Bm.reshape(b, s_cfg.n_groups, s_cfg.d_state), hpg, dim=1).float()
    Ch = torch.repeat_interleave(
        Cm.reshape(b, s_cfg.n_groups, s_cfg.d_state), hpg, dim=1).float()

    xbar = xh * dt[..., None]
    new_ssm = (state["ssm"] * a[..., None, None]
               + torch.einsum("bhp,bhn->bhpn", xbar, Bh))
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, Ch)
    y = y + xh * p["D"][:, None]
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z)[:, None], {"scale": p["norm"]}, cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y, p["wo"])
    return out, {"conv": window[:, 1:], "ssm": new_ssm}


# ===========================================================================
# RG-LRU (Griffin / RecurrentGemma recurrent block).
# ===========================================================================
def rglru_schema(cfg):
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    k = cfg.rglru.conv_width

    def lam_init(gen, shape):
        # a = sigmoid(lam) ~ U(0.9, 0.999) as in Griffin
        u = _uniform(gen, shape, 0.9, 0.999)
        return torch.log(u) - torch.log1p(-u)

    f32 = torch.float32
    return {
        "w_gate": ParamSpec((d, w), ("embed", "lru_width")),
        "w_in": ParamSpec((d, w), ("embed", "lru_width")),
        "conv_w": ParamSpec((k, w), (None, "lru_width")),
        "conv_b": ParamSpec((w,), ("lru_width",), "zeros"),
        "ra_w": ParamSpec((w,), ("lru_width",), "normal", dtype=f32),
        "ra_b": ParamSpec((w,), ("lru_width",), "zeros", dtype=f32),
        "ix_w": ParamSpec((w,), ("lru_width",), "normal", dtype=f32),
        "ix_b": ParamSpec((w,), ("lru_width",), "zeros", dtype=f32),
        "lam": ParamSpec((w,), ("lru_width",), lam_init, dtype=f32),
        "wo": ParamSpec((w, d), ("lru_width", "embed")),
    }


def _rglru_coeffs(p, u, cfg):
    """u: (..., w) fp32 -> (a, b) recurrence coefficients."""
    c = cfg.rglru.c_constant
    r = torch.sigmoid(u * p["ra_w"] + p["ra_b"])
    i = torch.sigmoid(u * p["ix_w"] + p["ix_b"])
    log_a = -c * r * F.softplus(p["lam"])
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization (Griffin eq. 4)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * u)


def rglru_mix(p, x, cfg):
    """Griffin recurrent block. x: (b,s,d) -> (b,s,d)."""
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate"]),
                  approximate="tanh")
    u = torch.einsum("bsd,dw->bsw", x, p["w_in"])
    u = _causal_conv(u, p["conv_w"], p["conv_b"])
    a, bvec = _rglru_coeffs(p, u.float(), cfg)
    h = rglru_ops.rglru_scan(torch.log(torch.clamp(a, min=1e-37)), bvec)
    h = h.to(x.dtype)
    return torch.einsum("bsw,wd->bsd", gate * h, p["wo"])


def rglru_init_state(cfg, batch, dtype, device):
    w = cfg.rglru.lru_width or cfg.d_model
    k = cfg.rglru.conv_width
    return {
        "conv": torch.zeros((batch, k - 1, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode(p, x, cfg, state):
    """One-token decode. x: (b,1,d) -> ((b,1,d), new state)."""
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate"]),
                  approximate="tanh")[:, 0]
    u = torch.einsum("bsd,dw->bsw", x, p["w_in"])[:, 0]      # (b,w)
    window = torch.cat([state["conv"], u[:, None]], dim=1)
    u = torch.einsum("bkw,kw->bw", window, p["conv_w"]) + p["conv_b"]
    a, bvec = _rglru_coeffs(p, u.float(), cfg)
    h = state["h"] * a + bvec
    out = torch.einsum("bw,wd->bd", gate * h.to(x.dtype), p["wo"])[:, None]
    return out, {"conv": window[:, 1:], "h": h}
