"""The Mamba2 family: an attention-free stack, every layer RMSNorm and the
Mamba2 mixer with a residual add, no MLP (mamba_ssm's `ssm_cfg`).

The family's file layout is `families/dense.py`'s.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from fedbench.harness import program, work
from fedbench.reference import model as M
from fedbench.reference import schema as S

KIND = "mamba2"
BLOCK = f"blocks/00_{KIND}/"


def _a_log(shape, gen, device, z):
    """A_log = log U(lo, hi), Mamba2's published initialisation."""
    lo, hi = z["a_range"]
    return torch.log(torch.rand(shape, generator=gen, device=device)
                     * (hi - lo) + lo)


def _dt_bias(shape, gen, device, z):
    """The inverse softplus of a dt drawn log-uniform in [dt_min,
    dt_max], Mamba2's published initialisation."""
    u = torch.rand(shape, generator=gen, device=device)
    lo, hi = math.log(z["dt_min"]), math.log(z["dt_max"])
    dt = torch.exp(u * (hi - lo) + lo)
    return dt + torch.log(-torch.expm1(-dt))


# the family's own initialisers, beside the generic ones of
# `harness/weights.py`: (shape, generator, device, dims) -> float32 tensor
INITS = {"a_log": _a_log, "dt_bias": _dt_bias}


def dims(cfg: dict) -> dict:
    """The sizes the reference computes with, from a configuration file."""
    z = S.lm_dims(cfg)
    s = cfg["ssm_cfg"]
    d_in = s["expand"] * z["d"]
    z.update(kind=KIND, d_in=d_in, nh=d_in // s["headdim"], p=s["headdim"],
             g=s["ngroups"], n=s["d_state"], conv=s["d_conv"],
             chunk=s["chunk_size"], a_range=tuple(s["A_init_range"]),
             dt_min=s["dt_min"], dt_max=s["dt_max"],
             conv_dim=d_in + 2 * s["ngroups"] * s["d_state"])
    return z


def mixer_entries(z: dict, prefix: str, L: int):
    """The Mamba2 mixer's leaves under `prefix`, stacked over `L`."""
    d, w, f32 = z["d"], z["dtype"], S.DTYPES["float32"]
    d_in, nh, gn = z["d_in"], z["nh"], z["g"] * z["n"]
    return [(prefix + "A_log", (L, nh), f32, "a_log", 0),
            (prefix + "D", (L, nh), f32, "ones", 0),
            (prefix + "conv_b", (L, z["conv_dim"]), w, "zeros", 0),
            (prefix + "conv_w", (L, z["conv"], z["conv_dim"]), w,
             "normal", z["conv"]),
            (prefix + "dt_bias", (L, nh), f32, "dt_bias", 0),
            (prefix + "norm", (L, d_in), f32, "ones", 0),
            (prefix + "wB", (L, d, gn), w, "normal", d),
            (prefix + "wC", (L, d, gn), w, "normal", d),
            (prefix + "wdt", (L, d, nh), w, "normal", d),
            (prefix + "wo", (L, d_in, d), w, "normal", d_in),
            (prefix + "wx", (L, d, d_in), w, "normal", d),
            (prefix + "wz", (L, d, d_in), w, "normal", d)]


def schema(cfg: dict):
    """Every parameter of the configuration, in sorted-key order."""
    z = dims(cfg)
    L = z["layers"]
    return sorted(
        S.lm_entries(z)
        + [(BLOCK + "norm1/scale", (L, z["d"]), S.DTYPES["float32"], "ones",
            0)]
        + mixer_entries(z, BLOCK + "mix/", L))


def loss(params, cfg, tokens, labels, prec=M.Precision()):
    """Mean token cross-entropy of one batch in float32."""
    z = dims(cfg)

    def layer(p, x):
        h = M.rms_norm(x, p["norm1/scale"], z["eps"])
        return x + M.mamba2(M.group(p, "mix"), h, z, prec)

    return M.lm_loss(params, z, tokens, labels, prec, [(BLOCK, layer)],
                     z["layers"])


def counted(key: str, init: str) -> bool:
    """A leaf that enters a dense product: every projection, not the
    depthwise conv."""
    return init == "normal" and not key.endswith("conv_w")


def model_flops(cfg: dict, mix: dict) -> float:
    """The model FLOPs of one round: 6 x the parameters of the dense
    products (every projection and the tied head once) x the tokens
    trained (forward, and the backward's two products), plus 3 x the SSD
    scan's forward at the tensor-core kernel's 128-row pieces. Remat's
    recompute, the embedding gather, the norms, the depthwise conv and the
    per-head scalars are not counted."""
    z = dims(cfg)
    steps = mix["clients"] * mix["local_steps"]
    b, s = mix["batch"], mix["seq"]
    params = work.product_params(z["d"], z["v"], schema(cfg), counted)
    flops = 6.0 * params * work.round_tokens(mix)
    mixer = work.ssd_flops(b, s, z["nh"], z["p"], z["n"],
                           min(work.SSD_PIECE, z["chunk"]))
    return flops + 3.0 * mixer * z["layers"] * steps


def port_config(cfg: dict, mix: dict = None):
    """The port's ModelConfig of the configuration file: the port's model
    of that family with every size the file states."""
    from repro_torch import configs
    from repro_torch.common.config import SSMConfig
    z = dims(cfg)
    base = configs.get_config(cfg["port_model"])
    if base.pattern != (KIND,):
        raise ValueError(f"{cfg['port_model']}: pattern {base.pattern}, the "
                         f"file describes {KIND} layers")
    return dataclasses.replace(
        base, **program.lm_fields(z, cfg), d_ff=0, moe=None, ssm=SSMConfig(
            d_state=z["n"], head_dim=z["p"], expand=z["d_in"] // z["d"],
            conv_width=z["conv"], n_groups=z["g"], chunk_size=z["chunk"],
            dt_min=z["dt_min"], dt_max=z["dt_max"],
            a_init_range=z["a_range"]))
