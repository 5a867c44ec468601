"""FL client: owns a local dataset shard and a local-train step, the port
of the JAX package's `fl/client.py`.

The client periodically checkpoints its train state to the (simulated)
cloud object store — the paper's fault-tolerance mechanism (§III-D) — and
can resume a local epoch from the latest checkpoint after preemption.

It trains on `device`, the card unless the caller asks for the CPU. A
step's loss stays on the device; an epoch reads its losses once, at its
end, so the card never waits on the host between steps for a number
the epoch only averages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.common.bridge import leaves, unflatten_as
from repro_torch.common.device import require_device
from repro_torch.fl.algorithms import fedprox_penalty
from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass
class LocalMetrics:
    loss: float
    n_batches: int
    n_samples: int


class FLClient:
    def __init__(self, name: str, apply_fn: Callable, optimizer: Optimizer,
                 data_fn: Callable[[int], Iterator[Tuple[np.ndarray, np.ndarray]]],
                 n_samples: int,
                 algorithm: str = "fedavg", fedprox_mu: float = 0.01,
                 checkpointer: Optional[Checkpointer] = None,
                 checkpoint_every: int = 10, device="cuda"):
        self.device = require_device(device, "FLClient")
        self.name = name
        self.apply_fn = apply_fn
        self.opt = optimizer
        self.data_fn = data_fn
        self.n_samples = n_samples
        self.algorithm = algorithm
        self.mu = fedprox_mu
        self.ckpt = checkpointer
        self.checkpoint_every = checkpoint_every

    def _step(self, params, opt_state, x, y, global_params):
        """One step: cross-entropy (+ the FedProx term against the
        round's global parameters), its gradient, the optimizer update.
        Returns the new params and state and the loss, on the device."""
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        tree = unflatten_as(params, live)
        logits = self.apply_fn(tree, x)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -torch.mean(torch.gather(logp, 1, y[:, None]))
        if self.algorithm == "fedprox":
            loss = loss + fedprox_penalty(tree, global_params, self.mu)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            params, opt_state = self.opt.update(
                unflatten_as(params, grads), opt_state, params)
        return params, opt_state, loss.detach()

    # ------------------------------------------------------------------
    def train_epoch(self, global_params, round_idx: int,
                    resume_from_batch: int = 0):
        """One local epoch from `global_params`; returns (params, metrics).

        Checkpoints every `checkpoint_every` batches; `resume_from_batch`
        restarts mid-epoch after a (simulated) preemption.
        """
        params = global_params
        opt_state = self.opt.init(params)
        start = 0
        if resume_from_batch > 0 and self.ckpt is not None:
            template = {"params": params, "opt_state": opt_state, "batch": 0}
            saved = self.ckpt.restore(self._key(round_idx), template)
            if saved is not None:
                params, opt_state = saved["params"], saved["opt_state"]
                start = int(saved["batch"])
        losses = []
        nb = 0
        for bi, (x, y) in enumerate(self.data_fn(round_idx)):
            if bi < start:
                continue
            params, opt_state, loss = self._step(
                params, opt_state, torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device, torch.int64),
                global_params)
            losses.append(loss)
            nb += 1
            if self.ckpt is not None and (bi + 1) % self.checkpoint_every == 0:
                self.ckpt.save(self._key(round_idx), {
                    "params": params, "opt_state": opt_state,
                    "batch": bi + 1})
        metrics = LocalMetrics(
            float(np.mean(torch.stack(losses).cpu().tolist()))
            if losses else float("nan"),
            nb, self.n_samples)
        return params, metrics

    def _key(self, round_idx: int) -> str:
        return f"client={self.name}/round={round_idx}"
