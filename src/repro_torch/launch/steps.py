"""Step functions of the port (train / prefill / decode) with their
sharding trees: the programs the drivers `launch/train.py` and
`launch/serve.py` execute and the dry run (`launch/dryrun.py`) counts.

Counterpart of the JAX package's `launch/steps.py`. The steps run
eagerly on one device; `step_for` is `jit_step_for` without the jit: it
returns the step with the spec trees of its inputs and outputs, resolved
by `sharding/rules.py` on a `MeshShape`, which the dry run reports.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.bridge import flatten_with_paths, unflatten_as
from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.optim import optimizers
from repro_torch.sharding import rules as R


# ---------------------------------------------------------------------------
# Sharding trees (nested dicts of specs, `sharding/rules.py`'s tuples).
# ---------------------------------------------------------------------------
def param_shardings(cfg, rules, mesh):
    return R.tree_shardings(lm.logical_axes(cfg), rules, mesh,
                            lm.abstract_params(cfg))


def opt_shardings(cfg, rules, mesh):
    pshard = param_shardings(cfg, rules, mesh)
    return optimizers.OptState(step=(), mu=pshard, nu=pshard)


def batch_shardings(cfg, rules, mesh, kind: str, shape=None):
    tok_axes = (("batch", "seq", "embed_act") if cfg.family == "audio"
                else ("batch", "seq"))
    B = shape.global_batch if shape is not None else None
    S = shape.seq_len if shape is not None else None
    d = cfg.d_model

    def rs(axes, shp):
        return R.resolve_spec(axes, rules, mesh,
                              shp if shape is not None else None)

    tok_shape = (B, S, d) if cfg.family == "audio" else (B, S)
    if kind == "train":
        b = {"tokens": rs(tok_axes, tok_shape),
             "labels": rs(("batch", "seq"), (B, S))}
        if cfg.family == "vlm":
            b["cond"] = rs(("batch", "cond", "embed_act"),
                           (B, cfg.n_cond_tokens, d))
        return {"batch": b}
    if kind == "prefill":
        out = {"tokens": rs(tok_axes, tok_shape)}
        if cfg.family == "vlm":
            out["cond"] = rs(("batch", "cond", "embed_act"),
                             (B, cfg.n_cond_tokens, d))
        return out
    if kind == "decode":
        tok_dec = (("batch", None, "embed_act") if cfg.family == "audio"
                   else ("batch", None))
        tok_dec_shape = (B, 1, d) if cfg.family == "audio" else (B, 1)
        cache_abs = (lm.abstract_cache(cfg, B, S)
                     if shape is not None else None)
        return {
            "tokens": rs(tok_dec, tok_dec_shape),
            "pos": rs(("batch",), (B,)),
            "cache": R.tree_shardings(lm.cache_logical_axes(cfg), rules,
                                      mesh, cache_abs),
        }
    raise ValueError(kind)


def _loss_and_grads(params, cfg, batch):
    """The loss of `batch` and its gradient leaves, in flatten order."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in flatten_with_paths(params)]
    loss = lm.loss_fn(unflatten_as(params, leaves), cfg, batch)
    # an audio model's token table takes no gradient (its batches are
    # frames): zeros, as `jax.grad` gives
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                              materialize_grads=True)


def make_train_step(cfg, lr: float = 3e-4):
    """Train step with gradient accumulation: `cfg.grad_accum`
    micro-batches a step, their fp32 gradients summed and divided by the
    count, their losses averaged (the JAX package scans them; this is a
    Python loop). AdamW with weight decay 0.1. Returns (step, optimizer);
    `step(params, opt_state, batch)` -> (params, opt_state, {"loss"})."""
    opt = optimizers.adamw(lr=lr, weight_decay=0.1)
    accum = max(cfg.grad_accum, 1)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = _loss_and_grads(params, cfg, batch)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                     for k, v in batch.items()}
            grads, losses = None, []
            for i in range(accum):
                l, g = _loss_and_grads(params, cfg,
                                       {k: v[i] for k, v in micro.items()})
                grads = ([gi.float() for gi in g] if grads is None
                         else [a + gi.float() for a, gi in zip(grads, g)])
                losses.append(l)
            grads = [g / accum for g in grads]
            loss = torch.mean(torch.stack(losses))
        params, opt_state = opt.update(unflatten_as(params, grads),
                                       opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step, opt


def make_prefill_step(cfg):
    """`prefill(params, tokens, cond=None)` -> the next-token logits of
    the last position, (B, V)."""

    @torch.no_grad()
    def prefill_step(params, tokens, cond=None):
        logits, _ = lm.forward(params, cfg, tokens, cond=cond)
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg):
    """`serve_step(params, tokens, pos, cache)` -> (greedy next token (B,),
    cache), the cache updated in place."""

    def serve_step(params, tokens, pos, cache):
        logits, cache = lm.decode_step(params, cfg, tokens, pos, cache)
        return torch.argmax(logits[:, -1, :], dim=-1), cache

    return serve_step


def step_for(cfg: ModelConfig, shape: ShapeConfig, mesh: R.MeshShape,
             rule_overrides: Optional[dict] = None):
    """The step of `shape.kind` with the spec trees of its inputs and
    outputs on `mesh`: (step, in_specs, out_specs), each spec tree a
    tuple matching the step's positional arguments or its outputs (a
    spec standing for a whole subtree is a prefix, as a sharding is in
    `jax.jit`)."""
    kind = shape.kind
    # per-arch overrides target the training layout (e.g. phi3's ZeRO-3
    # rules); prefill/decode keep the serving rule sets.
    overrides = dict(cfg.sharding_overrides or ()) if kind == "train" \
        else {}
    if rule_overrides:
        overrides.update(rule_overrides)
    rules = R.make_rules(kind, overrides)
    pspec = param_shardings(cfg, rules, mesh)
    bspec = batch_shardings(cfg, rules, mesh, kind, shape)

    if kind == "train":
        step, _ = make_train_step(cfg)
        ospec = opt_shardings(cfg, rules, mesh)
        return step, (pspec, ospec, bspec["batch"]), (pspec, ospec, ())
    if kind == "prefill":
        vocab_out = R.resolve_spec(("batch", "vocab"), rules, mesh,
                                   (shape.global_batch, cfg.vocab_size))
        names = ["tokens"] + (["cond"] if cfg.family == "vlm" else [])
        return (make_prefill_step(cfg),
                tuple([pspec] + [bspec[n] for n in names]), vocab_out)
    if kind == "decode":
        in_specs = (pspec, bspec["tokens"], bspec["pos"], bspec["cache"])
        out_specs = (R.resolve_spec(("batch",), rules, mesh,
                                    (shape.global_batch,)), bspec["cache"])
        return make_decode_step(cfg), in_specs, out_specs
    raise ValueError(kind)
