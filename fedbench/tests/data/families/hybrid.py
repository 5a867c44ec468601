"""A family that only the tests hold: a block of two kinds of layer, a
Mamba2 layer and then a causal attention layer, each followed by a SwiGLU
MLP, repeated. Laid out in a temporary benchmark root beside a
configuration file that names it, it shows that a new family is files
and entries alone: no file of the harness or the reference knows it.
"""
from __future__ import annotations

from fedbench.families import dense, mamba2
from fedbench.harness import program, work
from fedbench.reference import model as M
from fedbench.reference import schema as S

PATTERN = ("mamba2", "attn")
PREFIXES = tuple(f"blocks/{i:02d}_{k}/" for i, k in enumerate(PATTERN))
# Mamba2's own initialisers, given the Mamba2 layer's sizes
INITS = {name: (lambda shape, gen, device, z, init=init:
                init(shape, gen, device, z["mamba2"]))
         for name, init in mamba2.INITS.items()}


def dims(cfg: dict) -> dict:
    z = S.lm_dims(cfg)
    z.update(kind="hybrid", repeats=z["layers"] // len(PATTERN),
             f=cfg["intermediate_size"], mamba2=mamba2.dims(cfg),
             attn=dense.dims(cfg))
    return z


def _mlp(z, prefix, R):
    d, f, w = z["d"], z["f"], z["dtype"]
    f32 = S.DTYPES["float32"]
    return [(prefix + "norm2/scale", (R, d), f32, "ones", 0),
            (prefix + "mlp/wi_gate", (R, d, f), w, "normal", d),
            (prefix + "mlp/wi_up", (R, d, f), w, "normal", d),
            (prefix + "mlp/wo", (R, f, d), w, "normal", f)]


def schema(cfg: dict):
    z = dims(cfg)
    za, d, R, w = z["attn"], z["d"], z["repeats"], z["dtype"]
    n, k, h = za["n"], za["k"], za["h"]
    pm, pa = PREFIXES
    f32 = S.DTYPES["float32"]
    return sorted(
        S.lm_entries(z)
        + [(pm + "norm1/scale", (R, d), f32, "ones", 0)]
        + mamba2.mixer_entries(z["mamba2"], pm + "mix/", R)
        + _mlp(z, pm, R)
        + [(pa + "norm1/scale", (R, d), f32, "ones", 0),
           (pa + "mix/wq", (R, d, n, h), w, "normal", d),
           (pa + "mix/wk", (R, d, k, h), w, "normal", d),
           (pa + "mix/wv", (R, d, k, h), w, "normal", d),
           (pa + "mix/wo", (R, n, h, d), w, "normal", n * h)]
        + _mlp(z, pa, R))


def loss(params, cfg, tokens, labels, prec=M.Precision()):
    z = dims(cfg)

    def with_mlp(mixer, sizes):
        def layer(p, x):
            h = M.rms_norm(x, p["norm1/scale"], z["eps"])
            x = x + mixer(M.group(p, "mix"), h, sizes, prec)
            h = M.rms_norm(x, p["norm2/scale"], z["eps"])
            return x + M.swiglu(M.group(p, "mlp"), h, prec)
        return layer

    block = [(PREFIXES[0], with_mlp(M.mamba2, z["mamba2"])),
             (PREFIXES[1], with_mlp(M.attention, z["attn"]))]
    return M.lm_loss(params, z, tokens, labels, prec, block, z["repeats"])


def model_flops(cfg: dict, mix: dict) -> float:
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
    steps = mix["clients"] * mix["local_steps"]
    return (6.0 * params * work.round_tokens(mix)
            + 3.0 * (ssd + attn) * z["repeats"] * steps)


def port_config(cfg: dict, mix: dict = None):
    from repro_torch.common.config import ModelConfig, SSMConfig
    z = dims(cfg)
    zm, za = z["mamba2"], z["attn"]
    return ModelConfig(
        name=cfg["name"], family="hybrid", pattern=PATTERN,
        **program.lm_fields(z, cfg), num_heads=za["n"],
        num_kv_heads=za["k"], head_dim=za["h"], d_ff=z["f"],
        rope_theta=za["theta"], mlp_kind="swiglu", ssm=SSMConfig(
            d_state=zm["n"], head_dim=zm["p"], expand=zm["d_in"] // z["d"],
            conv_width=zm["conv"], n_groups=zm["g"],
            chunk_size=zm["chunk"], dt_min=zm["dt_min"],
            dt_max=zm["dt_max"], a_init_range=zm["a_range"]))
