"""Step functions of the port (train / prefill / decode), the programs
the drivers `launch/train.py` and `launch/serve.py` execute.

Counterpart of the JAX package's `launch/steps.py` without its sharding
trees and `jit_step_for`, which need a mesh and the sharding rules
(ROADMAP §1 item 8): the steps here run eagerly on one device.
"""
from __future__ import annotations

import torch

from repro_torch.common.bridge import flatten_with_paths, unflatten_as
from repro_torch.models import lm
from repro_torch.optim import optimizers


def _loss_and_grads(params, cfg, batch):
    """The loss of `batch` and its gradient leaves, in flatten order."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in flatten_with_paths(params)]
    loss = lm.loss_fn(unflatten_as(params, leaves), cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


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
