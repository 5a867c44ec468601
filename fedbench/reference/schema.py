"""The parameter list of the benchmark's model families, kept here so that
neither the weight maker nor the plain reference has to ask the program.

Each entry is (key, shape, storage dtype, init, fan_in). The keys are the
flat paths of the port's parameter tree (`blocks/<i>_<kind>/...` with the
stacked leading layer dim), so one flat dict of tensors serves both sides.
`init` is one of "embed", "normal", "ones", "zeros", "a_log", "dt_bias";
`fan_in` is the size a "normal" leaf's products contract over.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

Entry = Tuple[str, Tuple[int, ...], torch.dtype, str, int]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _get(cfg: dict, *names):
    """The first of `names` that the file holds: a transformers config
    and a mamba_ssm config name the same size differently."""
    for name in names:
        if name in cfg:
            return cfg[name]
    raise KeyError(f"the configuration names none of {names}")


def layer_kind(cfg: dict) -> str:
    """"mamba2" for a Mamba2 stack (mamba_ssm's `ssm_cfg`), else "attn"."""
    return "mamba2" if "ssm_cfg" in cfg else "attn"


def dims(cfg: dict) -> dict:
    """The sizes the reference computes with, from a configuration file.
    The vocabulary is padded up to `pad_vocab_size_multiple` where the
    file names one, as mamba_ssm pads its embedding table."""
    v = cfg["vocab_size"]
    pad = cfg.get("pad_vocab_size_multiple", 1)
    d = {"d": _get(cfg, "hidden_size", "d_model"), "v": -(-v // pad) * pad,
         "layers": _get(cfg, "num_hidden_layers", "n_layer"),
         "kind": layer_kind(cfg),
         "eps": _get(cfg, "rms_norm_eps", "norm_epsilon"),
         "tied": _get(cfg, "tie_word_embeddings", "tie_embeddings"),
         "dtype": DTYPES[cfg["torch_dtype"]]}
    if d["kind"] == "attn":
        d.update(n=cfg["num_attention_heads"], k=cfg["num_key_value_heads"],
                 h=cfg["hidden_size"] // cfg["num_attention_heads"],
                 f=cfg["intermediate_size"], theta=cfg["rope_theta"])
    else:
        s = cfg["ssm_cfg"]
        d_in = s["expand"] * d["d"]
        d.update(d_in=d_in, nh=d_in // s["headdim"], p=s["headdim"],
                 g=s["ngroups"], n=s["d_state"], conv=s["d_conv"],
                 chunk=s["chunk_size"], a_range=tuple(s["A_init_range"]),
                 dt_min=s["dt_min"], dt_max=s["dt_max"],
                 conv_dim=d_in + 2 * s["ngroups"] * s["d_state"])
    return d


def schema(cfg: dict) -> List[Entry]:
    """Every parameter of the configuration, in sorted-key order."""
    z = dims(cfg)
    d, v, L, w = z["d"], z["v"], z["layers"], z["dtype"]
    f32 = torch.float32
    out = [("embed/table", (v, d), w, "embed", 0),
           ("final_norm/scale", (d,), f32, "ones", 0)]
    if not z["tied"]:
        out.append(("lm_head/table", (d, v), w, "normal", d))
    blk = f"blocks/00_{z['kind']}/"
    out.append((blk + "norm1/scale", (L, d), f32, "ones", 0))
    if z["kind"] == "attn":
        n, k, h, f = z["n"], z["k"], z["h"], z["f"]
        out += [(blk + "mix/wq", (L, d, n, h), w, "normal", d),
                (blk + "mix/wk", (L, d, k, h), w, "normal", d),
                (blk + "mix/wv", (L, d, k, h), w, "normal", d),
                (blk + "mix/wo", (L, n, h, d), w, "normal", n * h),
                (blk + "norm2/scale", (L, d), f32, "ones", 0),
                (blk + "mlp/wi_gate", (L, d, f), w, "normal", d),
                (blk + "mlp/wi_up", (L, d, f), w, "normal", d),
                (blk + "mlp/wo", (L, f, d), w, "normal", f)]
    else:
        d_in, nh, gn = z["d_in"], z["nh"], z["g"] * z["n"]
        out += [(blk + "mix/A_log", (L, nh), f32, "a_log", 0),
                (blk + "mix/D", (L, nh), f32, "ones", 0),
                (blk + "mix/conv_b", (L, z["conv_dim"]), w, "zeros", 0),
                (blk + "mix/conv_w", (L, z["conv"], z["conv_dim"]), w,
                 "normal", z["conv"]),
                (blk + "mix/dt_bias", (L, nh), f32, "dt_bias", 0),
                (blk + "mix/norm", (L, d_in), f32, "ones", 0),
                (blk + "mix/wB", (L, d, gn), w, "normal", d),
                (blk + "mix/wC", (L, d, gn), w, "normal", d),
                (blk + "mix/wdt", (L, d, nh), w, "normal", d),
                (blk + "mix/wo", (L, d_in, d), w, "normal", d_in),
                (blk + "mix/wx", (L, d, d_in), w, "normal", d),
                (blk + "mix/wz", (L, d, d_in), w, "normal", d)]
    return sorted(out)


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product of the forward: every
    projection and the output head (the tied table counts once, as the
    head); the embedding gather, norms, the depthwise conv and the
    per-head scalars do not."""
    z = dims(cfg)
    total = z["d"] * z["v"]
    for key, shape, _, init, _ in schema(cfg):
        if init == "normal" and not key.startswith("lm_head") \
                and not key.endswith("conv_w"):
            n = 1
            for s in shape:
                n *= s
            total += n
    return total
