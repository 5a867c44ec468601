"""FedCostAware scheduler — the paper's core contribution (§III, Listing 1).

Implements, against the simulated cloud:
  * calibration phase (round 1 cold / round 2 warm, §III-B),
  * EMA estimate updates on every client result,
  * instance termination when predicted idle time pays for a respin
    (`idle - T_spin_up > T_threshold`),
  * proactive pre-warming at `F_s - T_spin_up - T_buffer`,
  * dynamic schedule adjustment when a preempted client pushes the round's
    critical path out (§III-D),
  * budget screening before each round (§III-E).

Since the composable-strategy redesign this class is the pure
*decision core*: round engines never call it directly. The strategy
components in `repro_torch.core.strategy` (LifecycleStrategy wrapping the
Listing-1 calls, BudgetScreen wrapping §III-E) read and update it
through the `StrategyStack`, and the OnDemand / PlainSpot baselines
simply compose no strategies — which is exactly the paper's Table I
comparison.

"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.common.config import SchedulerConfig
from repro_torch.core.budget import BudgetLedger
from repro_torch.core.estimator import TimeEstimator


@dataclasses.dataclass
class RoundClientState:
    """Scheduler-visible state of one client within the current round."""
    start_time: float = 0.0         # when its training task was dispatched
    is_cold_start: bool = True      # first epoch on a fresh instance?
    includes_spin_up: bool = False  # instance still spinning at dispatch?
    finished: bool = False
    finish_time: Optional[float] = None
    # recovery override (§III-D): expected finish after preemption restart
    recovery_finish: Optional[float] = None


class FedCostAwareScheduler:
    """Pure decision logic with no side effects: the strategy
    components (`repro_torch.core.strategy`) consume the decisions and the
    `DirectiveExecutor` (`repro_torch.fl.cluster`) executes them (terminate /
    pre-warm spin-ups), so the scheduler stays independently testable
    and engine-agnostic — the async buffered engine's stack reuses the
    estimator EMAs and §III-E budget screening while skipping the
    barrier-specific Listing-1 calls.
    """

    def __init__(self, cfg: SchedulerConfig, estimator: TimeEstimator,
                 ledger: BudgetLedger):
        self.cfg = cfg
        self.est = estimator
        self.ledger = ledger
        self.round_idx = 0
        self.states: Dict[str, RoundClientState] = {}
        self.prewarm_queue: Dict[str, float] = {}   # client -> spin_up time
        self.terminated: set = set()

    # ------------------------------------------------------------------
    # Round bookkeeping.
    # ------------------------------------------------------------------
    @property
    def in_calibration(self) -> bool:
        return self.round_idx < self.cfg.calibration_rounds

    def begin_round(self, round_idx: int):
        self.round_idx = round_idx
        self.states = {}
        self.prewarm_queue = {}

    def register_dispatch(self, client: str, t: float, cold: bool,
                          includes_spin_up: bool):
        self.states[client] = RoundClientState(
            start_time=t, is_cold_start=cold,
            includes_spin_up=includes_spin_up)

    # ------------------------------------------------------------------
    # Listing 1: estimate_slowest_finish_time.
    # ------------------------------------------------------------------
    def estimate_finish(self, client: str) -> float:
        s = self.states[client]
        if s.finished:
            return s.finish_time
        if s.recovery_finish is not None:
            return s.recovery_finish
        m = self.est.model(client)
        return m.predict_finish(s.start_time, s.is_cold_start,
                                s.includes_spin_up)

    def estimate_slowest_finish_time(self) -> float:
        return max(self.estimate_finish(c) for c in self.states)

    # ------------------------------------------------------------------
    # Listing 1: evaluate_termination.
    # ------------------------------------------------------------------
    def evaluate_termination(self, client: str, f_i: float,
                             more_rounds: bool) -> Optional[float]:
        """Called when `client` delivers its result at time `f_i`.

        Returns the pre-warm spin-up start time if the instance should be
        terminated (caller terminates + queues the spin-up), else None.
        """
        if self.in_calibration:
            return None
        f_s = self.estimate_slowest_finish_time()
        idle = f_s - f_i
        t_spin = self.est.model(client).spin_up.get(self.cfg.t_threshold_s)
        if idle - t_spin <= self.cfg.t_threshold_s:
            return None
        self.terminated.add(client)
        if not more_rounds:
            return math.inf            # terminate; nothing to pre-warm
        prewarm_t = f_s - t_spin - self.cfg.t_buffer_s
        self.prewarm_queue[client] = prewarm_t
        return prewarm_t

    # ------------------------------------------------------------------
    # Result / preemption hooks (§III-B, §III-D).
    # ------------------------------------------------------------------
    def on_result(self, client: str, t: float, epoch_duration: float,
                  cold: bool, spin_up_observed: Optional[float]):
        s = self.states[client]
        s.finished = True
        s.finish_time = t
        self.est.observe_epoch(client, epoch_duration, cold)
        if spin_up_observed is not None:
            self.est.observe_spin_up(client, spin_up_observed)

    def on_preemption_recovery(self, client: str, recovery_finish: float
                               ) -> Dict[str, float]:
        """§III-D: a preempted client restarts and will now finish at
        `recovery_finish`; recompute pre-warm targets for every already-
        terminated client. Returns the updated {client: spin_up_time} map
        (callers must reschedule their pending spin-up events).
        """
        s = self.states.get(client)
        if s is not None:
            s.recovery_finish = recovery_finish
        f_s = self.estimate_slowest_finish_time()
        updates = {}
        for c, old_t in list(self.prewarm_queue.items()):
            t_spin = self.est.model(c).spin_up.get(self.cfg.t_threshold_s)
            new_t = max(f_s, recovery_finish) - t_spin - self.cfg.t_buffer_s
            if new_t > old_t + 1e-9:
                self.prewarm_queue[c] = new_t
                updates[c] = new_t
        return updates

    # ------------------------------------------------------------------
    # Budget screening (§III-E).
    # ------------------------------------------------------------------
    def screen_participants(self, clients: List[str],
                            spot_price_of) -> List[str]:
        def est_cost(c):
            m = self.est.model(c)
            dur = m.predict_epoch(cold=False) + m.spin_up.get()
            return spot_price_of(c) * dur / 3600.0

        return self.ledger.screen_round(clients, est_cost)
