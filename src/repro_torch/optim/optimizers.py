"""Optimizers over pytrees of tensors, the port of the JAX package's
`optim/optimizers.py`: AdamW, SGD(+momentum), schedules, global-norm
clipping. Written from its formulas, not with `torch.optim`, so a step
rounds as the JAX one does: the step count is an int32 tensor, the
learning rate and the bias corrections `1 - b**t` are float32 tensors,
the global norm is summed leaf by leaf in flatten order, and the
optimizer state is fp32 whatever the parameters' dtype (bf16 parameters
update through an fp32 path and are cast back). `update` is functional:
it returns new trees and leaves its arguments as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.common.bridge import leaves, tree_map, unflatten_as


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any             # first moment  (or momentum buffer for sgd)
    nu: Any             # second moment (a 0-d zero for sgd)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable    # (grads, state, params) -> (new_params, new_state)


def _f32_like(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def _device(tree):
    return leaves(tree)[0].device


def clip_by_global_norm(grads, max_norm):
    sq = None
    for g in leaves(grads):
        s = torch.sum(torch.square(g.float()))
        sq = s if sq is None else sq + s
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def cosine_schedule(base_lr, warmup, total):
    def fn(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant_schedule(lr):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          clip_norm: Optional[float] = 1.0, schedule=None) -> Optimizer:
    sched = schedule or constant_schedule(lr)

    def init(params):
        return OptState(torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                        _f32_like(params), _f32_like(params))

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        t = step.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            new_p = p.float() - lr_t * delta
            return new_p.to(p.dtype), m, v

        out = [upd(p, g, m, v) for p, g, m, v in zip(
            leaves(params), leaves(grads), leaves(state.mu),
            leaves(state.nu))]
        return (unflatten_as(params, [o[0] for o in out]),
                OptState(step, unflatten_as(params, [o[1] for o in out]),
                         unflatten_as(params, [o[2] for o in out])))

    return Optimizer(init, update)


def sgd(lr=0.01, momentum=0.9, clip_norm: Optional[float] = None,
        schedule=None) -> Optimizer:
    sched = schedule or constant_schedule(lr)

    def init(params):
        dev = _device(params)
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        _f32_like(params),
                        torch.zeros((), dtype=torch.float32, device=dev))

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)

        def upd(p, g, m):
            g = g.float()
            m = momentum * m + g
            new_p = p.float() - lr_t * m
            return new_p.to(p.dtype), m

        out = [upd(p, g, m) for p, g, m in zip(
            leaves(params), leaves(grads), leaves(state.mu))]
        return (unflatten_as(params, [o[0] for o in out]),
                OptState(step, unflatten_as(params, [o[1] for o in out]),
                         state.nu))

    return Optimizer(init, update)


def get(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "sgd":
        return sgd(**kw)
    raise ValueError(name)
