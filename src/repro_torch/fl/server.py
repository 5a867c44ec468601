"""Synchronous FL server + a TrainerHooks adapter binding real training
into the cloud runner (so a FedCostAware run produces an actual trained
global model while the simulator produces the dollar costs). The port of
the JAX package's `fl/server.py`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.common.device import require_device
from repro_torch.fl.algorithms import ServerState
from repro_torch.fl.client import FLClient
from repro_torch.fl.types import TrainerHooks


class FederatedServer:
    """Plain synchronous server (no cloud): used in unit tests and as the
    aggregation engine inside the cloud-attached trainer below."""

    def __init__(self, init_params, algorithm: str = "fedavg",
                 server_momentum: float = 0.9):
        self.state = ServerState(init_params, algorithm, server_momentum)
        self.history: List[Dict] = []

    @property
    def params(self):
        return self.state.params

    def run_round(self, clients: List[FLClient], round_idx: int):
        updates, weights, losses = [], [], []
        for c in clients:
            p, m = c.train_epoch(self.params, round_idx)
            updates.append(p)
            weights.append(m.n_samples)
            losses.append(m.loss)
        self.state.aggregate(updates, weights)
        rec = {"round": round_idx,
               "mean_client_loss": float(np.mean(losses))}
        self.history.append(rec)
        return rec

    def fit(self, clients: List[FLClient], n_rounds: int):
        for r in range(n_rounds):
            self.run_round(clients, r)
        return self.history


class ServerTrainerHooks(TrainerHooks):
    """Adapter: the cloud runner calls `run_local`/`aggregate` as simulated
    time advances; we execute the corresponding real computation. The
    counterpart of the JAX package's `fl/server.py::JaxTrainerHooks`
    (`fl/training.py::TorchTrainerHooks` is the counterpart of its
    `MeshTrainerHooks`). Like `JaxTrainerHooks` it sizes no payload, so
    the runner bills the modeled `FLRunConfig.update_payload_mb`.

    The clients must train on `device`, the card unless the caller asks
    for the CPU."""

    def __init__(self, server: FederatedServer, clients: Dict[str, FLClient],
                 device="cuda"):
        self.device = require_device(device, "ServerTrainerHooks")
        wrong = {n: str(c.device) for n, c in clients.items()
                 if c.device != self.device}
        if wrong:
            raise ValueError(f"clients not on {self.device}: {wrong}")
        self.server = server
        self.clients = clients
        self._pending: Dict[str, object] = {}
        self._weights: Dict[str, float] = {}
        self._losses: Dict[str, float] = {}

    def run_local(self, client: str, round_idx: int) -> None:
        c = self.clients[client]
        params, metrics = c.train_epoch(self.server.params, round_idx)
        self._pending[client] = params
        self._weights[client] = metrics.n_samples
        self._losses[client] = metrics.loss

    @staticmethod
    def staleness_discount(staleness: int) -> float:
        """FedBuff (arXiv:2106.06639) polynomial staleness weight: a
        fresh update keeps its full sample weight, an update `s` rounds
        stale is discounted by 1/sqrt(1+s)."""
        return 1.0 / math.sqrt(1.0 + max(staleness, 0))

    def aggregate(self, participants: List[str], round_idx: int,
                  staleness: Optional[Dict[str, int]] = None) -> None:
        stale = staleness or {}
        ups = [self._pending[c] for c in participants if c in self._pending]
        ws = [self._weights[c] * self.staleness_discount(stale.get(c, 0))
              for c in participants if c in self._pending]
        if ups:
            self.server.state.aggregate(ups, ws)
            self.server.history.append({
                "round": round_idx,
                "mean_client_loss": float(np.mean(
                    [self._losses[c] for c in participants
                     if c in self._losses]))})
        self._pending.clear()
        self._weights.clear()
        self._losses.clear()
