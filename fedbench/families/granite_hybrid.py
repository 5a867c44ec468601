"""The Granite 4.0-H family (transformers' `granitemoehybrid`, without its
experts): a stack of Mamba2 and attention layers in the order of the
configuration's `layer_types`, each layer RMSNorm, its mixer, RMSNorm and
a SwiGLU MLP (`shared_mlp`), with Granite's multipliers.

The plain reference follows the published equations
(`modeling_granitemoehybrid.py`):

- the embedded tokens times `embedding_multiplier`;
- a layer: x + mixer(norm(x)) r, then x + mlp(norm(x)) r, r the
  `residual_multiplier`;
- the Mamba2 mixer as the Mamba2 family's (`reference/model.py::mamba2`:
  z, x, B, C, dt projections, the depthwise causal conv with bias and
  SiLU, softplus dt with a bias, A = -exp(A_log), the SSD scan, the D
  skip, the gated RMSNorm, the output projection);
- attention: q, k, v projections without bias, no positional embedding
  (`position_embedding_type` "nope"), GQA, the scores times
  `attention_multiplier` (1/h, not 1/sqrt(h)), a causal softmax, the
  output projection;
- the MLP: silu(x W_gate) * (x W_up), then W_out;
- the final RMSNorm, the tied head, the logits over `logits_scaling`, the
  mean token cross-entropy.

Departures, none of them a change of the function: the fused
`input_linear` of the MLP is held as `wi_gate` and `wi_up` (its two
halves), and Mamba2's fused `in_proj` as `wz`, `wx`, `wB`, `wC`, `wdt`
(its parts), the port's parameter layout; weights are random, drawn as
`harness/weights.py` says, Mamba2's per-head scalars by Mamba2's
published initialisation (`assumed` in the configuration); every layer
is checkpointed, as the other families' references are.

The file layout is `families/dense.py`'s. The layer kinds' sizes lie
under `dims(cfg)["mamba2"]` and `["attn"]`, where the kernel readers
find them (`harness/work.py::layer_dims`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from fedbench.families import mamba2
from fedbench.harness import program, work
from fedbench.reference import model as M
from fedbench.reference import schema as S

# `layer_types` names -> the port's layer kinds
KINDS = {"mamba": "mamba2", "attention": "attn"}
# Mamba2's own initialisers, given the Mamba2 layers' sizes
INITS = {name: (lambda shape, gen, device, z, init=init:
                init(shape, gen, device, z["mamba2"]))
         for name, init in mamba2.INITS.items()}


def _period(types):
    """The shortest block whose repeats make up `types`."""
    n = len(types)
    for p in range(1, n + 1):
        if n % p == 0 and types == types[:p] * (n // p):
            return p
    raise ValueError("empty layer_types")


def dims(cfg: dict) -> dict:
    """The sizes the reference computes with, from a configuration file."""
    z = S.lm_dims(cfg)
    d = z["d"]
    types = list(cfg["layer_types"][:z["layers"]])
    if len(types) != z["layers"]:
        raise ValueError(f"{len(types)} layer_types for {z['layers']} layers")
    period = types[:_period(types)]
    nh, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    d_in = cfg["mamba_expand"] * d
    if nh * p != d_in:
        raise ValueError(f"mamba_n_heads x mamba_d_head = {nh * p}, "
                         f"mamba_expand x hidden_size = {d_in}")
    g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    assumed = cfg["assumed"]
    base = {k: z[k] for k in ("d", "eps", "dtype")}
    heads = cfg["num_attention_heads"]
    z.update(
        kind="granite_hybrid", pattern=tuple(KINDS[t] for t in period),
        repeats=z["layers"] // len(period), f=cfg["shared_intermediate_size"],
        emb_mult=float(cfg["embedding_multiplier"]),
        res_mult=float(cfg["residual_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]),
        mamba2=dict(base, kind="mamba2", d_in=d_in, nh=nh, p=p, g=g, n=n,
                    conv=cfg["mamba_d_conv"], chunk=cfg["mamba_chunk_size"],
                    a_range=tuple(assumed["A_init_range"]),
                    dt_min=assumed["time_step_min"],
                    dt_max=assumed["time_step_max"],
                    conv_dim=d_in + 2 * g * n),
        attn=dict(base, kind="attn", n=heads,
                  k=cfg["num_key_value_heads"], h=d // heads,
                  scale=float(cfg["attention_multiplier"]),
                  rope=cfg["position_embedding_type"] != "nope"))
    return z


def prefixes(z: dict):
    """The block's layers: (key prefix, kind), in the order they run."""
    return [(f"blocks/{i:02d}_{kind}/", kind)
            for i, kind in enumerate(z["pattern"])]


def _attention_entries(za, prefix, R):
    d, n, k, h, w = za["d"], za["n"], za["k"], za["h"], za["dtype"]
    return [(prefix + "wq", (R, d, n, h), w, "normal", d),
            (prefix + "wk", (R, d, k, h), w, "normal", d),
            (prefix + "wv", (R, d, k, h), w, "normal", d),
            (prefix + "wo", (R, n, h, d), w, "normal", n * h)]


def schema(cfg: dict):
    """Every parameter of the configuration, in sorted-key order."""
    z = dims(cfg)
    d, f, R, w = z["d"], z["f"], z["repeats"], z["dtype"]
    f32 = S.DTYPES["float32"]
    out = S.lm_entries(z)
    for prefix, kind in prefixes(z):
        out += [(prefix + "norm1/scale", (R, d), f32, "ones", 0),
                (prefix + "norm2/scale", (R, d), f32, "ones", 0),
                (prefix + "mlp/wi_gate", (R, d, f), w, "normal", d),
                (prefix + "mlp/wi_up", (R, d, f), w, "normal", d),
                (prefix + "mlp/wo", (R, f, d), w, "normal", f)]
        if kind == "mamba2":
            out += mamba2.mixer_entries(z["mamba2"], prefix + "mix/", R)
        else:
            out += _attention_entries(z["attn"], prefix + "mix/", R)
    return sorted(out)


def attention(p, x, za, prec):
    """Causal GQA attention without positions, the scores times the
    configuration's `attention_multiplier`."""
    if za["rope"]:
        raise ValueError("the Granite 4.0-H reference has no RoPE path")
    q = M._proj("bsd,dnh->bsnh", x, p["wq"], prec)
    k = M._proj("bsd,dnh->bsnh", x, p["wk"], prec)
    v = M._proj("bsd,dnh->bsnh", x, p["wv"], prec)
    g = za["n"] // za["k"]
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    s = x.shape[1]
    scores = M._proj("bqnh,btnh->bnqt", q, k, prec) * za["scale"]
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = M._proj("bnqt,btnh->bqnh", probs, v, prec)
    return M._proj("bsnh,nhd->bsd", out, p["wo"], prec)


def _layer(z, kind, prec):
    """One layer, `layer(leaves by name, x) -> x`."""
    mixer, sizes = ((M.mamba2, z["mamba2"]) if kind == "mamba2"
                    else (attention, z["attn"]))
    r, eps = z["res_mult"], z["eps"]

    def layer(p, x):
        h = M.rms_norm(x, p["norm1/scale"], eps)
        x = x + mixer(M.group(p, "mix"), h, sizes, prec) * r
        h = M.rms_norm(x, p["norm2/scale"], eps)
        return x + M.swiglu(M.group(p, "mlp"), h, prec) * r
    return layer


def loss(params, cfg, tokens, labels, prec=M.Precision()):
    """Mean token cross-entropy of one batch in float32, every layer
    checkpointed."""
    z = dims(cfg)
    layers = []
    for prefix, kind in prefixes(z):
        names = sorted(k[len(prefix):] for k in params
                       if k.startswith(prefix))
        layers.append((prefix, names,
                       M._checkpointed(_layer(z, kind, prec), names)))
    x = params["embed/table"][tokens] * z["emb_mult"]
    for i in range(z["repeats"]):
        for prefix, names, run in layers:
            leaves = [params[prefix + k][i] for k in names]
            x = checkpoint(run, x, *leaves, use_reentrant=False)
    x = M.rms_norm(x, params["final_norm/scale"], z["eps"])
    head = (params["embed/table"].T if z["tied"]
            else params["lm_head/table"])
    logits = M._proj("bsd,dv->bsv", x, head, prec) / z["logits_scaling"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def model_flops(cfg: dict, mix: dict) -> float:
    """The model FLOPs of one round: 6 x the parameters of the dense
    products (every projection and the tied head once, not the depthwise
    conv) x the tokens trained, plus 3 x the mixers' forward work a
    block (the SSD scan at the tensor-core kernel's 128-row pieces for
    each Mamba2 layer, causal attention's pairs for each attention layer)
    x the blocks x the steps. Remat's recompute, the embedding gather,
    the norms, the per-head scalars and the multipliers are not counted."""
    z = dims(cfg)
    zm, za = z["mamba2"], z["attn"]
    b, s = mix["batch"], mix["seq"]
    params = work.product_params(
        z["d"], z["v"], schema(cfg),
        lambda key, init: mamba2.counted(key, init)
        and not key.startswith("lm_head"))
    ssd = work.ssd_flops(b, s, zm["nh"], zm["p"], zm["n"],
                         min(work.SSD_PIECE, zm["chunk"]))
    attn, _ = work.attention_work(b, s, s, za["n"], za["h"], 2)
    block = sum(ssd if k == "mamba2" else attn for k in z["pattern"])
    steps = mix["clients"] * mix["local_steps"]
    return (6.0 * params * work.round_tokens(mix)
            + 3.0 * block * z["repeats"] * steps)


def port_config(cfg: dict, mix: dict = None):
    """The port's ModelConfig of the configuration file: the port's model
    of that family with every size and multiplier the file states."""
    from repro_torch import configs
    from repro_torch.common.config import GraniteHybridConfig, SSMConfig
    z = dims(cfg)
    zm, za = z["mamba2"], z["attn"]
    base = configs.get_config(cfg["port_model"])
    if not isinstance(base, GraniteHybridConfig):
        raise ValueError(f"{cfg['port_model']}: {type(base).__name__}, the "
                         f"file describes a Granite 4.0-H model")
    return dataclasses.replace(
        base, **program.lm_fields(z, cfg), pattern=z["pattern"],
        num_heads=za["n"], num_kv_heads=za["k"], head_dim=za["h"],
        d_ff=z["f"], mlp_kind="swiglu", moe=None,
        rope_theta=float(cfg["rope_theta"]),
        position_embedding="rope" if za["rope"] else "none",
        attention_scale=za["scale"], embedding_multiplier=z["emb_mult"],
        residual_multiplier=z["res_mult"],
        logits_scaling=z["logits_scaling"], ssm=SSMConfig(
            d_state=zm["n"], head_dim=zm["p"], expand=zm["d_in"] // z["d"],
            conv_width=zm["conv"], n_groups=zm["g"], chunk_size=zm["chunk"],
            dt_min=zm["dt_min"], dt_max=zm["dt_max"],
            a_init_range=zm["a_range"]))
