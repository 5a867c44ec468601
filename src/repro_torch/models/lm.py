"""Decoder LM of the port, for every layer kind (`attn`, `local_attn`,
`cross_attn`, `mamba2`, `rglru`), with a dense or an MoE MLP.

Counterpart of the JAX package's `models/lm.py`: the same parameter
tree, with the stacked leading layer dim of `blocks/*`, which the forward
indexes in a Python loop where the JAX package scans. `cfg.remat`
recomputes each block in the backward
(`torch.utils.checkpoint.checkpoint`, non-reentrant), as `jax.checkpoint`
with `nothing_saveable` does. The MoE layers' load-balancing losses are
summed over the layers into `aux`.

The decode path keeps one cache tree a model, with the JAX package's
keys, shapes and dtypes (`f"{i:02d}_{kind}"` under `blocks`, with the
stacked leading layer dim, and under `tail`): k and v rows of the
attention layers (a ring of the window for local attention), the
cross-attention layers' `cond_k`/`cond_v`, and the SSM layers' conv and
recurrent states. `decode_step` updates it in place and returns it.

The abstract trees are meta tensors (shapes and dtypes, no data), the
counterpart of the JAX package's `ShapeDtypeStruct` trees: the dry run
(`launch/dryrun.py`) runs the FULL configs' steps on them, and the
sharding rules resolve the logical-axes trees beside them.

Public API:
  param_schema / param_shapes / init_params
  abstract_params / logical_axes / param_count
  forward(params, cfg, tokens, cond=None)      -> logits, aux
  loss_fn(params, cfg, batch)                  -> scalar loss
  cache_shapes / init_cache / abstract_cache / cache_logical_axes
  decode_step(params, cfg, tokens, pos, cache) -> logits, cache
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import config as C
from repro_torch.common.bridge import flatten_with_paths, unflatten
from repro_torch.common.device import require_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

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
        sub["mlp"] = L.moe_schema(cfg) if cfg.moe else L.mlp_schema(cfg)
    return sub


def _has_mlp(cfg):
    return cfg.d_ff > 0 or cfg.moe is not None


def _block_schema(cfg, pattern):
    return {f"{i:02d}_{k}": _sublayer_schema(cfg, k)
            for i, k in enumerate(pattern)}


def param_schema(cfg):
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


def abstract_params(cfg):
    """The parameter tree as meta tensors: shapes and dtypes, no data."""
    return unflatten({k: torch.empty(shape, dtype=dt, device="meta")
                      for k, (shape, dt) in param_shapes(cfg)})


def logical_axes(cfg):
    """The parameter tree's logical axis names, a tuple a leaf."""
    return unflatten({k: s.axes
                      for k, s in flatten_with_paths(param_schema(cfg))})


def param_count(cfg) -> int:
    return sum(math.prod(shape) for _, (shape, _) in param_shapes(cfg))


# ---------------------------------------------------------------------------
# Forward (train / prefill).
# ---------------------------------------------------------------------------
def _apply_sublayer(kind, p, x, cfg, cond):
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == C.MAMBA2:
        x = x + S.mamba2_mix(p["mix"], h, cfg)
    elif kind == C.RGLRU:
        x = x + S.rglru_mix(p["mix"], h, cfg)
    else:
        x = x + L.attention(p["mix"], h, cfg, kind=kind, cond=cond)
    if _has_mlp(cfg):
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if cfg.moe:
            h, aux = L.moe(p["mlp"], h, cfg)
        else:
            h = L.mlp(p["mlp"], h, cfg)
        x = x + h
    return x, aux


def _apply_block(pattern, p_blk, x, cfg, cond):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(pattern):
        x, a = _apply_sublayer(kind, p_blk[f"{i:02d}_{kind}"], x, cfg, cond)
        aux = aux + a
    return x, aux


def _layer_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def forward(params, cfg, tokens, cond=None):
    """tokens: (B,S) integer ids, or (B,S,D) pre-embedded frames (audio);
    cond: (B,T,D) conditioning tokens of the cross-attention layers (vlm).
    Returns (logits (B,S,V), aux_loss scalar)."""
    if tokens.ndim == 2:
        x = params["embed"]["table"][tokens]
    else:
        x = tokens
    x = x.to(cfg.activation_dtype)
    if cond is not None:
        cond = cond.to(cfg.activation_dtype)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_super > 0:
        def block(h, i):
            return _apply_block(cfg.pattern,
                                _layer_slice(params["blocks"], i), h, cfg,
                                cond)

        for i in range(cfg.n_super):
            if cfg.remat:
                x, a = checkpoint(block, x, i, use_reentrant=False)
            else:
                x, a = block(x, i)
            aux = aux + a
    if cfg.tail_pattern:
        x, a = _apply_block(cfg.tail_pattern, params["tail"], x, cfg, cond)
        aux = aux + a

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = (params["embed"]["table"].T if cfg.tie_embeddings
             else params["lm_head"]["table"])
    logits = torch.einsum("bsd,dv->bsv", x, table)
    return logits, aux


def loss_fn(params, cfg, batch, aux_weight: float = 0.01):
    """batch: dict(tokens (B,S), labels (B,S), [cond]). Mean token CE."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          cond=batch.get("cond"))
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    ce = torch.mean(logz - gold)
    return ce + aux_weight * aux


# ---------------------------------------------------------------------------
# Decode path.
# ---------------------------------------------------------------------------
def _sublayer_cache_shapes(cfg, kind, batch, max_len, dtype):
    """name -> (shape, dtype, logical axes) of one sublayer's cache."""
    h = cfg.resolved_head_dim
    nk = cfg.num_kv_heads
    if kind == C.ATTN:
        ax = ("batch", "cache_len", "kv_heads", "head_dim")
        return {"k": ((batch, max_len, nk, h), dtype, ax),
                "v": ((batch, max_len, nk, h), dtype, ax)}
    if kind == C.LOCAL_ATTN:
        wl = min(cfg.window_size, max_len)
        ax = ("batch", None, "kv_heads", "head_dim")
        return {"k": ((batch, wl, nk, h), dtype, ax),
                "v": ((batch, wl, nk, h), dtype, ax)}
    if kind == C.CROSS_ATTN:
        t = cfg.n_cond_tokens
        ax = ("batch", "cond", "kv_heads", "head_dim")
        return {"cond_k": ((batch, t, nk, h), dtype, ax),
                "cond_v": ((batch, t, nk, h), dtype, ax)}
    if kind == C.MAMBA2:
        s = cfg.ssm
        d_in, nh, conv_dim = S.mamba2_dims(cfg)
        return {"conv": ((batch, s.conv_width - 1, conv_dim), dtype,
                         ("batch", None, "ssm_inner")),
                "ssm": ((batch, nh, s.head_dim, s.d_state), torch.float32,
                        ("batch", "ssm_heads", None, "ssm_state"))}
    if kind == C.RGLRU:
        w = cfg.rglru.lru_width or cfg.d_model
        k = cfg.rglru.conv_width
        return {"conv": ((batch, k - 1, w), dtype,
                         ("batch", None, "lru_width")),
                "h": ((batch, w), torch.float32, ("batch", "lru_width"))}
    raise ValueError(kind)


def _cache_leaves(cfg, batch, max_len, dtype):
    """(key, (shape, dtype, logical axes)) for every cache leaf, in
    sorted-key order; stacked leaves gain the leading `layers` dim."""
    parts = ([("blocks", cfg.pattern, True)] if cfg.n_super > 0 else []) \
        + [("tail", cfg.tail_pattern, False)]
    flat = {}
    for part, pattern, stack in parts:
        for i, kind in enumerate(pattern):
            for name, (shape, dt, ax) in _sublayer_cache_shapes(
                    cfg, kind, batch, max_len, dtype).items():
                if stack:
                    shape, ax = (cfg.n_super,) + shape, ("layers",) + ax
                flat[f"{part}/{i:02d}_{kind}/{name}"] = (shape, dt, ax)
    return sorted(flat.items())


def cache_shapes(cfg, batch, max_len, dtype=None):
    """(key, (shape, torch dtype)) for every cache leaf, in sorted-key
    order; `dtype` (default the activation dtype) is that of every leaf
    but the SSM layers' fp32 recurrent states."""
    return [(k, (shape, dt)) for k, (shape, dt, _) in _cache_leaves(
        cfg, batch, max_len, dtype or cfg.activation_dtype)]


def abstract_cache(cfg, batch, max_len, dtype=None):
    """The cache tree as meta tensors."""
    return unflatten({k: torch.empty(shape, dtype=dt, device="meta")
                      for k, (shape, dt) in cache_shapes(cfg, batch, max_len,
                                                         dtype)})


def cache_logical_axes(cfg, batch=0, max_len=0):
    """The cache tree's logical axis names, a tuple a leaf."""
    return unflatten({k: ax for k, (_, _, ax) in _cache_leaves(
        cfg, 1, 2, torch.float32)})


def init_cache(cfg, batch, max_len, dtype=None, device: str = "cuda"):
    """A zero cache for `batch` sequences of up to `max_len` tokens."""
    dev = require_device(device, "init_cache")
    return unflatten({k: torch.zeros(shape, dtype=dt, device=dev)
                      for k, (shape, dt) in cache_shapes(cfg, batch, max_len,
                                                         dtype)})


def _apply_sublayer_decode(kind, p, x, cfg, cache, pos):
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind in (C.ATTN, C.LOCAL_ATTN):
        h, new = L.decode_attention(p["mix"], h, cfg, kind=kind,
                                    cache=cache, pos=pos)
    elif kind == C.CROSS_ATTN:
        h, _ = L.decode_attention(
            p["mix"], h, cfg, kind=kind, cache=None, pos=pos,
            cond_kv={"k": cache["cond_k"], "v": cache["cond_v"]})
        new = cache
    elif kind == C.MAMBA2:
        h, new = S.mamba2_decode(p["mix"], h, cfg, cache)
    elif kind == C.RGLRU:
        h, new = S.rglru_decode(p["mix"], h, cfg, cache)
    x = x + h
    if _has_mlp(cfg):
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if cfg.moe:
            h, _ = L.moe(p["mlp"], h, cfg)
        else:
            h = L.mlp(p["mlp"], h, cfg)
        x = x + h
    return x, new


def _apply_block_decode(pattern, p_blk, x, cfg, cache_blk, pos):
    """One block's decode step; each sublayer's new state is written
    into its slot of `cache_blk` (a view of the stacked cache)."""
    for i, kind in enumerate(pattern):
        key = f"{i:02d}_{kind}"
        x, new = _apply_sublayer_decode(kind, p_blk[key], x, cfg,
                                        cache_blk[key], pos)
        for name, t in new.items():
            if t is not cache_blk[key][name]:
                cache_blk[key][name].copy_(t)
    return x


@torch.no_grad()
def decode_step(params, cfg, tokens, pos, cache):
    """tokens: (B,1) integer ids (or (B,1,D) frames); pos: (B,) integer.

    Returns (logits (B,1,V), cache), `cache` updated in place."""
    if tokens.ndim == 2:
        x = params["embed"]["table"][tokens]
    else:
        x = tokens
    x = x.to(cfg.activation_dtype)

    for i in range(cfg.n_super):
        x = _apply_block_decode(cfg.pattern,
                                _layer_slice(params["blocks"], i), x, cfg,
                                _layer_slice(cache["blocks"], i), pos)
    if cfg.tail_pattern:
        x = _apply_block_decode(cfg.tail_pattern, params["tail"], x, cfg,
                                cache["tail"], pos)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = (params["embed"]["table"].T if cfg.tie_embeddings
             else params["lm_head"]["table"])
    return torch.einsum("bsd,dv->bsv", x, table), cache
