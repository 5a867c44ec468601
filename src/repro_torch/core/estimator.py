"""EMA time estimators (paper §III-B "Dynamic Estimation Updates").

Per client the scheduler tracks three quantities:
  T_epoch_cold : first-epoch time on a freshly started instance
  T_epoch_warm : epoch time on an already-running instance
  T_spinup     : instance provisioning + boot time

Each is smoothed with an exponential moving average; the spin-up estimate
is only updated when a result actually required a fresh spin-up.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


class EMA:
    def __init__(self, alpha: float, init: Optional[float] = None):
        self.alpha = alpha
        self.value: Optional[float] = init
        self.n_obs = 0

    def update(self, obs: float) -> float:
        self.n_obs += 1
        if self.value is None:
            self.value = float(obs)
        else:
            self.value = self.alpha * float(obs) + (1 - self.alpha) * self.value
        return self.value

    def get(self, default: float = 0.0) -> float:
        return self.value if self.value is not None else default


@dataclasses.dataclass
class ClientTimeModel:
    """All EMA estimates for one client."""
    epoch_cold: EMA
    epoch_warm: EMA
    spin_up: EMA

    @classmethod
    def fresh(cls, alpha: float, spin_up_prior: float = 150.0):
        return cls(EMA(alpha), EMA(alpha), EMA(alpha, init=spin_up_prior))

    # ------------------------------------------------------------------
    def predict_epoch(self, cold: bool) -> float:
        if cold:
            # before any cold observation fall back on warm (and vice versa)
            return self.epoch_cold.get(self.epoch_warm.get())
        return self.epoch_warm.get(self.epoch_cold.get())

    def predict_finish(self, start_time: float, cold: bool,
                       includes_spin_up: bool) -> float:
        t = start_time
        if includes_spin_up:
            t += self.spin_up.get()
        return t + self.predict_epoch(cold)


class TimeEstimator:
    """Registry of per-client time models + the update rules of §III-B."""

    def __init__(self, alpha: float, spin_up_prior: float = 150.0):
        self.alpha = alpha
        self.spin_up_prior = spin_up_prior
        self._models: Dict[str, ClientTimeModel] = {}

    def model(self, client: str) -> ClientTimeModel:
        if client not in self._models:
            self._models[client] = ClientTimeModel.fresh(
                self.alpha, self.spin_up_prior)
        return self._models[client]

    def observe_epoch(self, client: str, duration_s: float, cold: bool):
        m = self.model(client)
        (m.epoch_cold if cold else m.epoch_warm).update(duration_s)

    def observe_spin_up(self, client: str, duration_s: float):
        self.model(client).spin_up.update(duration_s)
