"""Decoder LM of the port, for the attention patterns (`attn`,
`local_attn`) and the state-space ones (`mamba2`, `rglru`).

Counterpart of the JAX package's `models/lm.py`: the same parameter
tree, with the stacked leading layer dim of `blocks/*`, which the forward
indexes in a Python loop where the JAX package scans. `cfg.remat`
recomputes each block in the backward
(`torch.utils.checkpoint.checkpoint`, non-reentrant), as `jax.checkpoint`
with `nothing_saveable` does. Cross attention and MoE raise
NotImplementedError naming their ROADMAP item.

Public API:
  param_schema / param_shapes / init_params
  forward(params, cfg, tokens)   -> logits, aux
  loss_fn(params, cfg, batch)    -> scalar loss
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import config as C
from repro_torch.common.bridge import flatten_with_paths
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

_NOT_PORTED = {
    C.CROSS_ATTN: "ROADMAP §1, queued item 5 (other LM families)",
}


def _check_supported(cfg):
    for kind in set(cfg.pattern + cfg.tail_pattern):
        if kind in _NOT_PORTED:
            raise NotImplementedError(
                f"layer kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE is not ported yet: ROADMAP §1, queued item 5 "
            "(other LM families)")


# ---------------------------------------------------------------------------
# Schemas.
# ---------------------------------------------------------------------------
def _sublayer_schema(cfg, kind):
    sub = {"norm1": L.rms_norm_schema(cfg.d_model)}
    if kind == C.MAMBA2:
        sub["mix"] = S.mamba2_schema(cfg)
    elif kind == C.RGLRU:
        sub["mix"] = S.rglru_schema(cfg)
    else:
        sub["mix"] = L.attention_schema(cfg)
    if _has_mlp(cfg):
        sub["norm2"] = L.rms_norm_schema(cfg.d_model)
        sub["mlp"] = L.mlp_schema(cfg)
    return sub


def _has_mlp(cfg):
    return cfg.d_ff > 0


def _block_schema(cfg, pattern):
    return {f"{i:02d}_{k}": _sublayer_schema(cfg, k)
            for i, k in enumerate(pattern)}


def param_schema(cfg):
    _check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    schema = {
        "embed": {"table": L.ParamSpec((v, d), ("vocab", "embed"), "embed")},
        "final_norm": L.rms_norm_schema(d),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = {
            "table": L.ParamSpec((d, v), ("embed", "vocab"))}
    if cfg.n_super > 0:
        schema["blocks"] = L.stack_specs(
            _block_schema(cfg, cfg.pattern), cfg.n_super)
    if cfg.tail_pattern:
        schema["tail"] = _block_schema(cfg, cfg.tail_pattern)
    return schema


def param_shapes(cfg):
    """(key, (shape, torch dtype)) for every parameter, in sorted-key order."""
    return [(k, (s.shape, s.dtype or cfg.param_torch_dtype))
            for k, s in flatten_with_paths(param_schema(cfg))]


def init_params(cfg, seed: int = 0, device: str = "cuda"):
    """Random parameters from `seed`, identical on every device."""
    gen = torch.Generator().manual_seed(seed)
    return L.materialize_tree(param_schema(cfg), gen, cfg.param_torch_dtype,
                              device)


# ---------------------------------------------------------------------------
# Forward (train / prefill).
# ---------------------------------------------------------------------------
def _apply_sublayer(kind, p, x, cfg):
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == C.MAMBA2:
        x = x + S.mamba2_mix(p["mix"], h, cfg)
    elif kind == C.RGLRU:
        x = x + S.rglru_mix(p["mix"], h, cfg)
    else:
        x = x + L.attention(p["mix"], h, cfg, kind=kind)
    if _has_mlp(cfg):
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, cfg)
    return x


def _apply_block(pattern, p_blk, x, cfg):
    for i, kind in enumerate(pattern):
        x = _apply_sublayer(kind, p_blk[f"{i:02d}_{kind}"], x, cfg)
    return x


def _layer_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def forward(params, cfg, tokens):
    """tokens: (B,S) integer ids. Returns (logits (B,S,V), aux_loss scalar);
    aux is zero, as for every family without MoE."""
    _check_supported(cfg)
    x = params["embed"]["table"][tokens].to(cfg.activation_dtype)

    if cfg.n_super > 0:
        def block(h, i):
            return _apply_block(cfg.pattern,
                                _layer_slice(params["blocks"], i), h, cfg)

        for i in range(cfg.n_super):
            if cfg.remat:
                x = checkpoint(block, x, i, use_reentrant=False)
            else:
                x = block(x, i)
    if cfg.tail_pattern:
        x = _apply_block(cfg.tail_pattern, params["tail"], x, cfg)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = (params["embed"]["table"].T if cfg.tie_embeddings
             else params["lm_head"]["table"])
    logits = torch.einsum("bsd,dv->bsv", x, table)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch, aux_weight: float = 0.01):
    """batch: dict(tokens (B,S), labels (B,S)). Mean token CE."""
    logits, aux = forward(params, cfg, batch["tokens"])
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    ce = torch.mean(logz - gold)
    return ce + aux_weight * aux
