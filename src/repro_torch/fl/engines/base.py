"""RoundEngine protocol + the shared engine machinery.

A `RoundEngine` owns the FL-round semantics of a run: when clients are
dispatched, what constitutes a completed round, and when aggregation
fires. Engines are driven entirely by client-level bus events
(`ClientReady`, `ClientLost`) plus the simulator clock — they never
talk to raw instance callbacks, which is what makes new round
disciplines (async buffering, straggler cut-offs, hierarchical rounds)
addable without touching the cloud or cluster layers.

Scheduling decisions are not made here either: engines report
observations to the run's `StrategyStack` (`repro_torch.core.strategy`) and
invoke its decision points; the strategy components answer with typed
directives that the `DirectiveExecutor` (`repro_torch.fl.cluster`) applies.
The engine's remaining job is purely the round discipline — which is
why a policy can swap lifecycle/budget/warning behavior without any
engine edit.

Contract:
  * `start()` schedules the initial work at t=0; the composition root
    then drains the simulator.
  * `result()` is called after the event heap drains and returns the
    engine's `RunResult`.

Engines also serve as the *view* the `WarningReaction` strategy reads
per-epoch facts from (`is_training` / `train_start` / …): subclasses
opt in to notice-aware checkpointing by implementing `_is_training`
and keeping the `_train_start` / `_train_duration` bookkeeping both
built-in engines already keep.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.checkpoint.store import MemoryStore, ObjectStore
from repro_torch.cloud.accounting import CostAccountant
from repro_torch.cloud.simulator import CloudSimulator
from repro_torch.common.config import (ClientProfile, CloudConfig, FLRunConfig,
                                 SchedulerConfig)
from repro_torch.core.events import (ClientLost, ClientReady,
                               ClientResumedFromCheckpoint,
                               ClientStateChanged, RoundCompleted,
                               RoundStarted)
from repro_torch.core.policies import Policy
from repro_torch.core.strategy import StrategyStack
from repro_torch.fl.cluster import ClusterManager
from repro_torch.fl.telemetry import TimelineRecorder
from repro_torch.comms.channel import CommsModel
from repro_torch.core.events import ClientUpdateSent
from repro_torch.fl.types import (RunResult, TrainerHooks,
                            aggregate_accepts_staleness)


@dataclasses.dataclass
class EngineContext:
    """Everything a round engine needs, wired by the composition root."""
    run_cfg: FLRunConfig
    cloud_cfg: CloudConfig
    sched_cfg: SchedulerConfig
    policy: Policy
    sim: CloudSimulator
    cluster: ClusterManager
    strategies: StrategyStack
    accountant: CostAccountant
    timeline: TimelineRecorder
    rng: np.random.RandomState
    hooks: Optional[TrainerHooks] = None
    ckpt_store: Optional[ObjectStore] = None   # None -> private MemoryStore
    # None -> no comms modeling: uploads are instantaneous and free,
    # no ClientUpdateSent events — the pre-v7 default path, bit-exact
    comms: Optional[CommsModel] = None


class BaseEngine:
    """Shared state + helpers; subclasses implement the round discipline."""

    name = "base"

    def __init__(self, ctx: EngineContext):
        self.ctx = ctx
        self.run_cfg = ctx.run_cfg
        self.cloud_cfg = ctx.cloud_cfg
        self.sched_cfg = ctx.sched_cfg
        self.policy = ctx.policy
        self.sim = ctx.sim
        self.cluster = ctx.cluster
        self.strategies = ctx.strategies
        self.accountant = ctx.accountant
        self.timeline = ctx.timeline
        self.hooks = ctx.hooks
        self.comms = ctx.comms
        # sniffed once here, not per round (fl.types helper warns on
        # the deprecated 2-argument aggregate override)
        self._aggregate_accepts_staleness = aggregate_accepts_staleness(
            ctx.hooks)
        # clients whose finished update is still occupying the uplink
        # (comms modeling only); they are not "training" for the
        # warning path, and losing their instance costs no redo
        self._uploading: Set[str] = set()
        self._rng = ctx.rng
        self.ckpt_store = ctx.ckpt_store or MemoryStore()
        self.profiles: Dict[str, ClientProfile] = {
            c.name: c for c in ctx.run_cfg.clients}
        self.cost_curve: List[dict] = []
        self.per_round_participants: List[List[str]] = []
        self.excluded: List[str] = []
        self._round_idx = -1
        self._done = False
        self._makespan: Optional[float] = None
        # per-epoch bookkeeping (also read by the WarningReaction
        # strategy through the view methods below)
        self._train_start: Dict[str, float] = {}
        self._train_duration: Dict[str, float] = {}
        self.lost_work_s = 0.0
        self.n_preemptions = 0
        self.strategies.attach_engine(self)
        self.sim.bus.subscribe(ClientLost, self._count_client_lost)
        self.sim.bus.subscribe(ClientReady, self._on_client_ready)
        self.sim.bus.subscribe(ClientLost, self._on_client_lost)

    # ------------------------------------------------------------------
    # Round discipline (subclass responsibility).
    # ------------------------------------------------------------------
    def start(self):
        """Schedule the engine's initial work at t=0; the composition
        root then drains the simulator."""
        raise NotImplementedError

    def _on_client_ready(self, ev: ClientReady):
        raise NotImplementedError

    def _on_client_lost(self, ev: ClientLost):
        raise NotImplementedError

    def _is_training(self, c: str) -> bool:
        """Is `c` mid-epoch on a RUNNING instance right now? Gates the
        preemption-warning path; engines that keep the shared
        `_train_start`/`_train_duration` bookkeeping override this.
        The conservative default opts an engine out of notice-aware
        checkpointing entirely (warnings no-op)."""
        return False

    # ------------------------------------------------------------------
    # Strategy view: the per-epoch facts the WarningReaction strategy
    # reads (and the two engine-side reactions it triggers).
    # ------------------------------------------------------------------
    def is_done(self) -> bool:
        """Has the run finished (strategies stop reacting)?"""
        return self._done

    def is_training(self, c: str) -> bool:
        """Public view of `_is_training` for the strategy layer."""
        return self._is_training(c)

    def train_start(self, c: str) -> float:
        """When the client's current epoch started (simulated s)."""
        return self._train_start[c]

    def train_duration(self, c: str) -> float:
        """The client's current epoch's total duration (simulated s)."""
        return self._train_duration[c]

    def current_round(self) -> int:
        """The engine's current round index."""
        return self._round_idx

    def note_lost_work(self, c: str, remaining: float):
        """Account the client-seconds of training that must be redone:
        time spent this epoch minus what the surviving checkpoint
        preserves."""
        elapsed = max(self.sim.now - self._train_start[c], 0.0)
        preserved = max(self._train_duration[c] - remaining, 0.0)
        self.lost_work_s += max(elapsed - preserved, 0.0)

    def after_drain(self, c: str, remaining: float):
        """Engine reaction after a `Drain` directive re-requested the
        client's replacement. Default: nothing; the sync barrier
        additionally runs the §III-D schedule adjustment."""

    # ------------------------------------------------------------------
    # Shared helpers.
    # ------------------------------------------------------------------
    def _sample_duration(self, c: str, cold: bool) -> float:
        prof = self.profiles[c]
        base = prof.mean_epoch_s * (prof.cold_multiplier if cold else 1.0)
        jit = float(np.exp(self._rng.randn() * prof.jitter))
        return base * jit

    def _checkpoint_remaining(self, c: str, train_start: float,
                              train_duration: float) -> float:
        """§III-D: work since the last periodic checkpoint is lost on
        preemption; returns the epoch time still owed after a resume."""
        elapsed = max(self.sim.now - train_start, 0.0)
        ck = self.sched_cfg.checkpoint_every_s
        preserved = math.floor(elapsed / ck) * ck
        return max(train_duration - preserved, 1.0)

    def _preemption_remaining(self, c: str) -> Tuple[float, str]:
        """Epoch time still owed after a reclaim, from the best
        surviving checkpoint: the warning-window snapshot when a
        strategy holds one that preserves more than the last periodic
        checkpoint, else the periodic one. Returns `(remaining_s,
        source)` with source "warning" | "periodic"."""
        periodic = self._checkpoint_remaining(
            c, self._train_start[c], self._train_duration[c])
        return self.strategies.preemption_remaining(c, periodic)

    def _count_client_lost(self, ev: ClientLost):
        """Every cluster-filtered `ClientLost` is a real spot reclaim
        of a tracked instance; count it for `RunResult.n_preemptions`."""
        self.n_preemptions += 1

    def _publish_resumed_from_checkpoint(self, c: str, r: int,
                                         remaining: float):
        """Telemetry for a resume that starts from a warning-window
        snapshot (periodic-checkpoint resumes stay un-evented to keep
        default streams unchanged)."""
        self.sim.bus.publish(ClientResumedFromCheckpoint(
            self.sim.now, c, r, remaining))

    def _call_aggregate(self, participants: List[str], round_idx: int,
                        staleness: Optional[Dict[str, int]] = None):
        """Invoke `hooks.aggregate`, forwarding per-client staleness to
        hooks that accept it (legacy 2-argument overrides still work)."""
        if self.hooks is None:
            return
        if self._aggregate_accepts_staleness:
            self.hooks.aggregate(participants, round_idx,
                                 staleness=staleness)
        else:
            self.hooks.aggregate(participants, round_idx)

    def _publish_update_sent(self, c: str, round_idx: int) -> float:
        """Comms modeling: publish `ClientUpdateSent` for `c`'s finished
        round-`round_idx` update and return the modeled uplink seconds
        the upload occupies (0.0 when bandwidth is unmodeled). Only
        called when `self.comms` is attached, so default runs publish
        nothing."""
        inst = self.cluster.instance_of(c)
        provider = getattr(inst, "provider", "") or ""
        zone = getattr(inst, "zone", "") or ""
        xfer = self.comms.transfer_s(provider, zone)
        self.sim.bus.publish(ClientUpdateSent(
            self.sim.now, c, round_idx, self.comms.size_mb,
            self.comms.quantized, provider, zone, xfer))
        return xfer

    def _screen_round(self, round_idx: int,
                      candidates: List[str]) -> List[str]:
        """Run the strategy stack's §III-E screening pass; records the
        newly screened-out clients in `excluded` (their `ScreenOut`
        directives — `BudgetExhausted`, teardown — were already
        applied) and returns the surviving participants."""
        keep, screened = self.strategies.screen(round_idx, candidates)
        self.excluded.extend(screened)
        return keep

    # ------------------------------------------------------------------
    # Telemetry publication. Engines never write to the timeline or the
    # recorder directly — every observation goes through the bus, so
    # record/replay consumers (core.eventlog, fl.telemetry) see exactly
    # what the live consumers see.
    # ------------------------------------------------------------------
    def _mark(self, c: str, state: str):
        self.sim.bus.publish(ClientStateChanged(self.sim.now, c, state))

    def _publish_round_started(self, r: int, participants):
        self.sim.bus.publish(
            RoundStarted(self.sim.now, r, tuple(participants)))

    def _publish_round_completed(self, r: int, participants, snapshot):
        self.sim.bus.publish(RoundCompleted(
            self.sim.now, r, tuple(participants), snapshot))

    def _cost_snapshot(self) -> Dict[str, float]:
        return {c: self.accountant.client_cost(c) for c in self.profiles}

    def _record_costs(self, snapshot: Optional[Dict[str, float]] = None):
        snap = snapshot if snapshot is not None else self._cost_snapshot()
        for c, cost in snap.items():
            self.cost_curve.append({
                "t": self.sim.now, "client": c,
                "cum_cost": cost,
                "round": self._round_idx,
            })

    # ------------------------------------------------------------------
    def result(self) -> RunResult:
        """Assemble the engine's `RunResult` after the heap drains."""
        return RunResult(
            total_cost=self.accountant.total_cost(),
            per_client_cost={c: self.accountant.client_cost(c)
                             for c in self.profiles},
            makespan_s=(self._makespan if self._makespan is not None
                        else self.sim.now),
            timeline=self.timeline.segments,
            cost_curve=self.cost_curve,
            rounds_completed=self._round_idx + 1,
            excluded_clients=list(self.excluded),
            per_round_participants=self.per_round_participants,
            lost_work_s=self.lost_work_s,
            n_preemptions=self.n_preemptions,
            checkpoint_cost=self.accountant.checkpoint_cost_total(),
            comm_cost=self.accountant.transfer_cost_total())
