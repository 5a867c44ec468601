"""The dense decoder family: every layer RMSNorm, causal attention with
RoPE, RMSNorm, a SwiGLU MLP, each with a residual add (phi3).

A family file holds what the benchmark knows of one model family, found
by a configuration file's `"family"` key (`harness/spec.py::family`):
`dims`, `schema`, `INITS`, the plain float32 `loss`, `model_flops` and
`port_config`. Only `port_config` touches the port.
"""
from __future__ import annotations

import dataclasses

from fedbench.harness import program, work
from fedbench.reference import model as M
from fedbench.reference import schema as S

KIND = "attn"
BLOCK = f"blocks/00_{KIND}/"
# the family's own initialisers, beside the generic ones of
# `harness/weights.py`: none
INITS = {}


def dims(cfg: dict) -> dict:
    """The sizes the reference computes with, from a configuration file."""
    z = S.lm_dims(cfg)
    z.update(kind=KIND, n=cfg["num_attention_heads"],
             k=cfg["num_key_value_heads"],
             h=cfg["hidden_size"] // cfg["num_attention_heads"],
             f=cfg["intermediate_size"], theta=cfg["rope_theta"])
    return z


def schema(cfg: dict):
    """Every parameter of the configuration, in sorted-key order."""
    z = dims(cfg)
    d, L, w = z["d"], z["layers"], z["dtype"]
    n, k, h, f = z["n"], z["k"], z["h"], z["f"]
    f32 = S.DTYPES["float32"]
    return sorted(S.lm_entries(z) + [
        (BLOCK + "norm1/scale", (L, d), f32, "ones", 0),
        (BLOCK + "mix/wq", (L, d, n, h), w, "normal", d),
        (BLOCK + "mix/wk", (L, d, k, h), w, "normal", d),
        (BLOCK + "mix/wv", (L, d, k, h), w, "normal", d),
        (BLOCK + "mix/wo", (L, n, h, d), w, "normal", n * h),
        (BLOCK + "norm2/scale", (L, d), f32, "ones", 0),
        (BLOCK + "mlp/wi_gate", (L, d, f), w, "normal", d),
        (BLOCK + "mlp/wi_up", (L, d, f), w, "normal", d),
        (BLOCK + "mlp/wo", (L, f, d), w, "normal", f)])


def loss(params, cfg, tokens, labels, prec=M.Precision()):
    """Mean token cross-entropy of one batch in float32."""
    z = dims(cfg)

    def layer(p, x):
        h = M.rms_norm(x, p["norm1/scale"], z["eps"])
        x = x + M.attention(M.group(p, "mix"), h, z, prec)
        h = M.rms_norm(x, p["norm2/scale"], z["eps"])
        return x + M.swiglu(M.group(p, "mlp"), h, prec)

    return M.lm_loss(params, z, tokens, labels, prec, [(BLOCK, layer)],
                     z["layers"])


def model_flops(cfg: dict, mix: dict) -> float:
    """The model FLOPs of one round: 6 x the parameters of the dense
    products (every projection and the output head) x the tokens trained
    (forward, and the backward's two products), plus 3 x causal
    attention's forward over its pairs. Remat's recompute and the
    embedding gather are not counted."""
    z = dims(cfg)
    steps = mix["clients"] * mix["local_steps"]
    b, s = mix["batch"], mix["seq"]
    params = work.product_params(
        z["d"], z["v"], schema(cfg),
        lambda key, init: init == "normal" and not key.startswith("lm_head"))
    flops = 6.0 * params * work.round_tokens(mix)
    mixer, _ = work.attention_work(b, s, s, z["n"], z["h"], 2)
    return flops + 3.0 * mixer * z["layers"] * steps


def port_config(cfg: dict, mix: dict = None):
    """The port's ModelConfig of the configuration file: the port's model
    of that family with every size the file states. With `mix`, a mix
    whose sequences pass the file's sliding window is refused: the port
    attends over the whole context."""
    from repro_torch import configs
    window = cfg.get("sliding_window")
    if mix is not None and window is not None and mix["seq"] > window:
        raise ValueError(f"seq {mix['seq']} passes the configuration's "
                         f"sliding window of {window}, which the port "
                         f"does not apply")
    z = dims(cfg)
    base = configs.get_config(cfg["port_model"])
    if base.pattern != (KIND,):
        raise ValueError(f"{cfg['port_model']}: pattern {base.pattern}, the "
                         f"file describes {KIND} layers")
    return dataclasses.replace(
        base, **program.lm_fields(z, cfg), num_heads=z["n"],
        num_kv_heads=z["k"], head_dim=z["h"], d_ff=z["f"],
        rope_theta=z["theta"], mlp_kind="swiglu", moe=None)
