"""Synchronous FL aggregation algorithms, the port of the JAX package's
`fl/algorithms.py`.

The paper deliberately keeps the *synchronous* protocol (§I) — FedCostAware
is an orthogonal, system-level optimization — so the algorithms here are
the standard synchronous family:

  fedavg   — sample-count weighted parameter average (McMahan et al.)
  fedprox  — fedavg aggregation + proximal term in the client loss
  fedavgm  — fedavg + server momentum on the update direction

The average rounds as the JAX one does: the weights are normalised in
float32, and each leaf is accumulated in float32 as
`(w0 l0 + w1 l1) + w2 l2 + ...`, in the clients' order, then cast back.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.common.bridge import leaves, tree_map


def weighted_average(param_list: Sequence, weights: Sequence[float]):
    dev = leaves(param_list[0])[0].device
    w = torch.tensor(weights, dtype=torch.float32, device=dev)
    w = w / torch.sum(w)

    def avg(*ls):
        acc = w[0] * ls[0].float()
        for wi, leaf in zip(w[1:], ls[1:]):
            acc = acc + wi * leaf.float()
        return acc.to(ls[0].dtype)

    return tree_map(avg, *param_list)


def fedprox_penalty(params, global_params, mu: float):
    sq = None
    for p, g in zip(leaves(params), leaves(global_params)):
        s = torch.sum(torch.square(p.float() - g.float()))
        sq = s if sq is None else sq + s
    return 0.5 * mu * sq


class ServerState:
    """Holds the global model + algorithm-specific server state."""

    def __init__(self, params, algorithm: str = "fedavg",
                 server_momentum: float = 0.9, server_lr: float = 1.0):
        self.params = params
        self.algorithm = algorithm
        self.server_momentum = server_momentum
        self.server_lr = server_lr
        self._velocity = None

    def aggregate(self, client_params: Sequence, weights: Sequence[float]):
        new = weighted_average(client_params, weights)
        if self.algorithm in ("fedavg", "fedprox"):
            self.params = new
            return self.params
        if self.algorithm == "fedavgm":
            delta = tree_map(lambda a, b: a.float() - b.float(),
                             self.params, new)
            if self._velocity is None:
                self._velocity = delta
            else:
                self._velocity = tree_map(
                    lambda v, d: self.server_momentum * v + d,
                    self._velocity, delta)
            self.params = tree_map(
                lambda p, v: (p.float() - self.server_lr * v).to(p.dtype),
                self.params, self._velocity)
            return self.params
        raise ValueError(self.algorithm)
