"""Composable scheduling strategies + typed directives.

The paper's FedCostAware scheduler (§III, Listing 1) is one of several
lifecycle disciplines the framework compares. This module makes the
discipline *composable*: a policy names a list of `SchedulingStrategy`
components, each of which observes the run (bus events plus the
engine-reported observations below) and answers with typed
**directives** —

  SpinUp(client)        ensure an instance is coming: request one when
                        the client is untracked, else pre-warm a
                        *standby* replacement next to the live instance
  Terminate(client)     stop the client's instance (Listing-1 idle
                        termination; `standby=True` cancels a standby)
  PreWarm(client, at_t) spin the client's next instance up at `at_t`
                        (the scheduler's F_s - T_spin_up - T_buffer)
  Checkpoint(client, …) persist a warning-window training snapshot
  Drain(client, …)      vacate a doomed instance and immediately
                        re-request its replacement with a resume token
  ScreenOut(client)     budget screening (§III-E) excludes the client

— which a `DirectiveExecutor` (`repro_torch.fl.cluster`) applies against the
cluster. Engines never call `FedCostAwareScheduler` methods directly
any more: they report observations to the `StrategyStack`
(`note_dispatch` / `note_result` / …) and invoke its decision points
(`screen`, `client_result`, `recovered`, `preemption_remaining`);
everything Listing-1-shaped lives behind the strategy components:

  LifecycleStrategy       wraps Listing-1 termination + pre-warming
  BudgetScreen            wraps §III-E budget screening
  WarningReaction         the preemption-notice machinery (checkpoint /
                          drain) formerly hard-coded in the engines
  ForecastPrewarmStrategy beyond-paper: watches a reclaim hazard —
                          the true model's (`oracle=True`) or the
                          tenant-observable price-derived estimate
                          (`oracle=False`) — and pre-warms a standby
                          replacement *before* the expected
                          interruption burst, closing the spin-up gap
                          entirely (ROADMAP item) — with zero engine
                          or cloud edits. Its fully learned successor,
                          `repro_torch.forecast.LearnedForecastStrategy`,
                          plugs into the same API from outside core.

Table-I policies are declarative compositions of these components
(`repro_torch.core.policies`); new disciplines plug in as new strategies (or
new engines) without touching `fl/engines` internals.

Layering: this module depends on `core.*`, `common.config` and
`checkpoint.snapshots` only — never on `fl.*` or `cloud.*`. Cluster
and hazard access reach strategies as plain callables on the
`StrategyContext`, wired by the composition root (`repro_torch.fl.runner`).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.checkpoint import snapshots
from repro_torch.common.config import SchedulerConfig
from repro_torch.core.events import ClientPreemptionWarning, EventBus
from repro_torch.core.scheduler import FedCostAwareScheduler

# instance-state literal shared with repro_torch.cloud.simulator.RUNNING
# (kept as a literal so the core layer stays free of cloud imports)
_RUNNING = "running"


# ---------------------------------------------------------------------------
# Directives: the typed vocabulary strategies answer with.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Directive:
    """Base class of every strategy decision; `client` is the FL client
    the decision concerns."""
    client: str


@dataclasses.dataclass(frozen=True)
class SpinUp(Directive):
    """Ensure an instance is on its way for `client`: a fresh request
    when the client is currently untracked (optionally resuming from
    `resume_token`), else a *standby* replacement pre-warmed alongside
    the live instance (promoted on the next request/reclaim)."""
    resume_token: Optional[Mapping[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class Terminate(Directive):
    """Stop the client's tracked instance now (Listing-1 idle
    termination: the executor also publishes the Fig-4 "savings"
    state). `standby=True` instead cancels the client's standby
    replacement, leaving the tracked instance alone."""
    standby: bool = False


@dataclasses.dataclass(frozen=True)
class PreWarm(Directive):
    """Spin the client's next instance up at absolute time `at_t` (the
    scheduler's `F_s - T_spin_up - T_buffer` target; §III-C)."""
    at_t: float = 0.0


@dataclasses.dataclass(frozen=True)
class Checkpoint(Directive):
    """Persist a warning-window training snapshot for `client`: the
    executor writes `payload` to the run's checkpoint store and
    publishes `ClientCheckpointed`."""
    round_idx: int = -1
    progress_s: float = 0.0
    remaining_s: float = 0.0
    reclaim_at: float = 0.0
    payload: Optional[Mapping[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class Drain(Directive):
    """Vacate the client's doomed instance (billing closes now, not at
    the reclaim) and immediately re-request a replacement carrying
    `resume_token`, giving its spin-up a head start."""
    resume_token: Optional[Mapping[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class ScreenOut(Directive):
    """Budget screening (§III-E) permanently excluded `client` from
    `round_idx` on: the executor publishes `BudgetExhausted` +
    `ClientScreenedOut` and stops any tracked instance."""
    round_idx: int = -1


# ---------------------------------------------------------------------------
# Strategy specs: the declarative, hashable half that lives inside a
# frozen Policy. `build(policy)` turns a spec into the live component.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """Declarative description of one strategy inside a `Policy`."""

    def build(self, policy) -> "SchedulingStrategy":
        """Instantiate the live strategy this spec describes."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LifecycleSpec(StrategySpec):
    """Listing-1 lifecycle management: terminate idle instances whose
    saving beats the respin threshold, pre-warm replacements."""

    def build(self, policy) -> "SchedulingStrategy":
        """A `LifecycleStrategy`."""
        return LifecycleStrategy()


@dataclasses.dataclass(frozen=True)
class BudgetScreenSpec(StrategySpec):
    """§III-E budget screening before each round."""

    def build(self, policy) -> "SchedulingStrategy":
        """A `BudgetScreen`."""
        return BudgetScreen()


@dataclasses.dataclass(frozen=True)
class WarningReactionSpec(StrategySpec):
    """Preemption-notice reaction; `mode` overrides the policy's
    `on_warning` knob (None inherits it). An explicit `mode` is the
    stronger statement: it also wins over a per-run
    `FLRunConfig.on_warning` override, which only reaches strategies
    through the policy knob — compositions that want the run override
    to apply should leave `mode=None`."""
    mode: Optional[str] = None

    def build(self, policy) -> "SchedulingStrategy":
        """A `WarningReaction` in `mode` (or the policy's)."""
        return WarningReaction(self.mode or policy.on_warning)


@dataclasses.dataclass(frozen=True)
class ForecastPrewarmSpec(StrategySpec):
    """Interruption-forecast pre-warming: pre-warm a standby
    replacement whenever the client's reclaim hazard (events/hour)
    crosses `hazard_threshold_per_hr`; release it once the hazard falls
    below `release_below_per_hr` (default: half the threshold).

    `oracle` names the hazard signal explicitly: True thresholds the
    *true* preemption-model hazard (`ctx.hazard_of` — a signal no real
    tenant can read; it silently degrades to the observable estimate
    when the driving model exposes no hazard, e.g. interruption
    replay), False thresholds the tenant-observable price-derived
    estimate (`ctx.observable_hazard_of`, routed through the run's
    `ObservableFeed`). Leaving it unset keeps the historical oracle
    behavior but raises a `DeprecationWarning` — compositions must now
    say which side of the oracle/observable line they stand on."""
    hazard_threshold_per_hr: float = 2.0
    poll_s: float = 30.0
    release_below_per_hr: Optional[float] = None
    oracle: Optional[bool] = None

    def build(self, policy) -> "SchedulingStrategy":
        """A `ForecastPrewarmStrategy` with this spec's thresholds."""
        oracle = self.oracle
        if oracle is None:
            warnings.warn(
                "ForecastPrewarmSpec without an explicit oracle= flag "
                "defaults to oracle=True, thresholding the true "
                "preemption-model hazard no real tenant can observe; "
                "pass oracle=True to keep that deliberately, or "
                "oracle=False for the observable price-derived signal "
                "(repro_torch.forecast.ObservableFeed)",
                DeprecationWarning, stacklevel=2)
            oracle = True
        return ForecastPrewarmStrategy(
            self.hazard_threshold_per_hr, self.poll_s,
            self.release_below_per_hr, oracle=oracle)


# ---------------------------------------------------------------------------
# Context: everything a strategy may read or act through.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StrategyContext:
    """Wiring handed to every strategy at bind time. Cluster state and
    market/hazard lookups are plain callables so the core layer stays
    import-free of `fl.*` / `cloud.*`; the composition root
    (`repro_torch.fl.runner`) fills them in."""
    policy: Any                          # repro_torch.core.policies.Policy
    sched: FedCostAwareScheduler         # shared Listing-1 decision core
    sched_cfg: SchedulerConfig
    bus: EventBus
    now: Callable[[], float]
    schedule_in: Callable[[float, Callable[[], None]], None]
    clients: Tuple[str, ...]
    spin_up_default: float = 150.0       # CloudConfig.spin_up_mean_s
    instance_of: Callable[[str], Any] = lambda c: None
    standby_of: Callable[[str], Any] = lambda c: None
    spot_price_of: Callable[[str], float] = lambda c: 0.0
    spend_of: Callable[[str], float] = lambda c: 0.0
    hazard_of: Callable[[str], float] = lambda c: 0.0
    # tenant-observable hazard estimate (events/hour), routed through
    # the run's ObservableFeed — what oracle=False strategies threshold
    observable_hazard_of: Callable[[str], float] = lambda c: 0.0
    # $ one checkpoint write of size_mb costs on `provider` (the
    # provider's StorageRates, wired by the composition root)
    ckpt_cost_of: Callable[[str, float], float] = lambda p, mb: 0.0
    is_shutdown: Callable[[], bool] = lambda: False
    # the run's repro_torch.forecast.ObservableFeed (held as Any: the core
    # layer never imports forecast); None on paths that don't wire one
    feed: Any = None
    ckpt_store: Any = None
    executor: Any = None                 # repro_torch.fl.cluster.DirectiveExecutor
    view: Any = None                     # engine adapter (attached later)


# ---------------------------------------------------------------------------
# The strategy protocol.
# ---------------------------------------------------------------------------
class SchedulingStrategy:
    """One composable scheduling discipline.

    Strategies are bound to a `StrategyContext` once, may subscribe to
    bus events in `bind` (reactive paths apply their directives through
    `ctx.executor` themselves), and answer the stack's decision points
    with directive lists. Every hook defaults to "no opinion", so a
    strategy only implements the decisions it owns.
    """

    def bind(self, ctx: StrategyContext) -> None:
        """Attach the run wiring; subscribe to bus events here."""
        self.ctx = ctx

    def screen(self, round_idx: int, candidates: List[str]
               ) -> Tuple[List[str], List[str]]:
        """Filter the round's participant candidates; returns
        `(keep, newly_screened_out)`."""
        return list(candidates), []

    def on_client_result(self, client: str, t: float,
                         more_rounds: bool) -> List[Directive]:
        """`client` delivered its round result at `t` while the round
        is still open; return lifecycle directives."""
        return []

    def preemption_remaining(self, client: str, periodic_remaining: float
                             ) -> Optional[Tuple[float, str]]:
        """Offer a better resume point than the periodic checkpoint
        after a reclaim; `(remaining_s, source)` or None to pass."""
        return None

    def invalidate(self, client: str) -> None:
        """The client's epoch completed: drop any per-epoch state
        (e.g. a now-stale warning snapshot)."""


class LifecycleStrategy(SchedulingStrategy):
    """Listing-1 termination + pre-warming, wrapped as a strategy.

    The math stays in the shared `FedCostAwareScheduler` core
    (`ctx.sched`) so the decisions are bit-identical to the paper
    implementation; this component turns them into directives.
    """

    def on_client_result(self, client: str, t: float,
                         more_rounds: bool) -> List[Directive]:
        """Listing-1 `evaluate_termination`: terminate when the
        predicted idle time pays for a respin, pre-warm the
        replacement at `F_s - T_spin_up - T_buffer`."""
        prewarm_t = self.ctx.sched.evaluate_termination(
            client, t, more_rounds)
        if prewarm_t is None:
            return []
        out: List[Directive] = [Terminate(client)]
        if math.isfinite(prewarm_t):
            out.append(PreWarm(client, prewarm_t))
        return out


class BudgetScreen(SchedulingStrategy):
    """§III-E budget screening, wrapped as a strategy: sync real spend
    into the ledger, keep the affordable clients, emit `ScreenOut` for
    the newly excluded ones."""

    def screen(self, round_idx: int, candidates: List[str]
               ) -> Tuple[List[str], List[str]]:
        """One pre-round screening pass over `candidates`."""
        ctx = self.ctx
        sched = ctx.sched
        before = set(c for c in candidates
                     if not sched.ledger.is_excluded(c))
        for c in ctx.clients:
            sched.ledger.sync_spend(c, ctx.spend_of(c))
        keep = sched.screen_participants(list(candidates),
                                         ctx.spot_price_of)
        kept = set(keep)
        screened = [c for c in candidates
                    if c in before and c not in kept]
        if screened:
            ctx.executor.apply(
                [ScreenOut(c, round_idx) for c in screened])
        return keep, screened


class WarningReaction(SchedulingStrategy):
    """Preemption-notice reaction (`Policy.on_warning`): under
    "checkpoint"/"drain", snapshot a mid-epoch client's training state
    inside the provider's reclaim-warning window; "drain" additionally
    vacates the doomed instance right after the snapshot lands.

    This absorbs the machinery formerly hard-coded in
    `repro_torch.fl.engines.base`; per-epoch facts (is the client mid-epoch,
    when did the epoch start, how long is it) come from the engine
    adapter at `ctx.view`.
    """

    def __init__(self, mode: str = "ignore"):
        self.mode = mode
        self._snap: Dict[str, dict] = {}   # client -> latest snapshot

    def bind(self, ctx: StrategyContext) -> None:
        """Subscribe to the cluster-filtered reclaim warnings."""
        super().bind(ctx)
        ctx.bus.subscribe(ClientPreemptionWarning, self._on_warning)

    # ------------------------------------------------------------------
    def _on_warning(self, ev: ClientPreemptionWarning) -> None:
        """Provider reclaim notice for a tracked client: start writing
        a training-state snapshot if (a) the client is actually
        mid-epoch and (b) the write can finish inside the notice
        window; otherwise the warning is informational and the reclaim
        falls back to periodic-checkpoint (lost-work) semantics."""
        ctx = self.ctx
        view = ctx.view
        if self.mode == "ignore" or view is None or view.is_done():
            return
        c = ev.client
        inst = ctx.instance_of(c)
        if inst is None or inst.iid != ev.instance.iid:
            return                          # stale: already replaced
        if not view.is_training(c):
            return                          # idle/pre-warmed: no state
        write_s = ctx.sched_cfg.warning_ckpt_write_s
        if ev.reclaim_at - ctx.now() + 1e-9 < write_s:
            return      # window too short: checkpoint cannot land
        # the snapshot captures progress at write *start*; work done
        # during the write itself is not in it (and is lost on reclaim)
        epoch_started = view.train_start(c)
        progress_s = ctx.now() - epoch_started
        ctx.schedule_in(write_s, lambda: (
            self._complete(c, ev.instance, ev.reclaim_at, progress_s,
                           epoch_started)))

    def _complete(self, c: str, inst, reclaim_at: float,
                  progress_s: float, epoch_started: float) -> None:
        """The notice-triggered snapshot finished writing: persist it
        via a `Checkpoint` directive and, under "drain", proactively
        vacate the instance. A no-op when the world moved on during
        the write (instance terminated/preempted, epoch finished — or
        a new epoch began on the same warm instance, which
        `epoch_started` detects)."""
        ctx = self.ctx
        view = ctx.view
        if view.is_done():
            return
        cur = ctx.instance_of(c)
        if cur is None or cur.iid != inst.iid or cur.state != _RUNNING:
            return          # terminated or reclaimed during the write
        if not view.is_training(c):
            return          # epoch finished inside the write window
        if view.train_start(c) != epoch_started:
            return          # a different epoch is running now
        r = view.current_round()
        remaining = max(view.train_duration(c) - progress_s, 1.0)
        payload = {"client": c, "round": r, "remaining": remaining,
                   "progress": progress_s, "t": ctx.now()}
        self._snap[c] = payload
        ctx.executor.apply([Checkpoint(
            c, round_idx=r, progress_s=progress_s, remaining_s=remaining,
            reclaim_at=reclaim_at, payload=payload)])
        if self.mode == "drain":
            self._drain(c, r, remaining)

    def _drain(self, c: str, r: int, remaining: float) -> None:
        """"drain": the snapshot is durable, so stop paying for a
        doomed instance — terminate it now (billing closes at the
        warning, not the reclaim) and immediately request the
        replacement with a resume token."""
        view = self.ctx.view
        # work done during the snapshot write is redone after resume
        view.note_lost_work(c, remaining)
        self._snap.pop(c, None)         # consumed by this resume
        self.ctx.executor.apply([Drain(c, resume_token={
            "round": r, "remaining": remaining, "source": "warning"})])
        view.after_drain(c, remaining)

    # ------------------------------------------------------------------
    def preemption_remaining(self, client: str, periodic_remaining: float
                             ) -> Optional[Tuple[float, str]]:
        """Offer the warning-window snapshot when it preserves more
        than the last periodic checkpoint (coarse `checkpoint_every_s`
        cadences are where the notice pays off)."""
        snap = self._snap.pop(client, None)
        if snap is None:
            return None
        stored = snapshots.load_snapshot(
            self.ctx.ckpt_store, client) or snap
        warn_remaining = float(stored["remaining"])
        if warn_remaining < periodic_remaining:
            return warn_remaining, "warning"
        return None

    def invalidate(self, client: str) -> None:
        """Epoch done: the warning snapshot (if any) is stale."""
        self._snap.pop(client, None)


class ForecastPrewarmStrategy(SchedulingStrategy):
    """Interruption-forecast pre-warming (ROADMAP): watch a reclaim
    hazard and pre-warm a *standby* replacement before the expected
    interruption burst. When the reclaim lands, the standby is
    promoted instead of a cold re-request — the spin-up gap collapses
    to ~0. Once the hazard falls back below the release threshold, an
    unused standby is cancelled so quiet market stretches cost nothing
    extra.

    `oracle=True` thresholds the true-model hazard (`ctx.hazard_of`,
    wired to `PriceCoupledModel.hazard` when that model drives the
    run); `oracle=False` thresholds the tenant-observable
    price-derived estimate (`ctx.observable_hazard_of`, the
    `repro_torch.forecast.ObservableFeed` signal). The fully *learned*
    alternative — no hazard formula at all — is
    `repro_torch.forecast.LearnedForecastStrategy`.

    Lives entirely outside `fl/engines/` and `cloud/`: it only reads
    context callables and answers with `SpinUp` / `Terminate`
    directives.
    """

    def __init__(self, hazard_threshold_per_hr: float = 2.0,
                 poll_s: float = 30.0,
                 release_below_per_hr: Optional[float] = None,
                 oracle: bool = True):
        self.threshold = hazard_threshold_per_hr
        self.poll_s = poll_s
        self.release = (release_below_per_hr
                        if release_below_per_hr is not None
                        else hazard_threshold_per_hr / 2.0)
        self.oracle = oracle

    def bind(self, ctx: StrategyContext) -> None:
        """Start the hazard polling loop on the simulator clock."""
        super().bind(ctx)
        ctx.schedule_in(self.poll_s, self._tick)

    def _tick(self) -> None:
        """One hazard sweep over every client; re-arms itself until
        the cluster shuts down."""
        ctx = self.ctx
        if ctx.is_shutdown():
            return
        hazard_of = ctx.hazard_of if self.oracle \
            else ctx.observable_hazard_of
        directives: List[Directive] = []
        for c in ctx.clients:
            inst = ctx.instance_of(c)
            standby = ctx.standby_of(c)
            tracked_spot = (inst is not None and not inst.on_demand
                            and inst.state == _RUNNING)
            # only clients that are actually mid-epoch stall anyone on
            # a reclaim: an idle instance lost at the barrier is simply
            # re-requested at the next dispatch, so a standby for it
            # would be pure waste
            training = (ctx.view is not None
                        and ctx.view.is_training(c))
            if tracked_spot and training and standby is None:
                if hazard_of(c) >= self.threshold:
                    directives.append(SpinUp(c))
            elif standby is not None:
                if (not tracked_spot or not training
                        or hazard_of(c) < self.release):
                    directives.append(Terminate(c, standby=True))
        if directives:
            ctx.executor.apply(directives)
        ctx.schedule_in(self.poll_s, self._tick)


# ---------------------------------------------------------------------------
# The stack: what engines talk to.
# ---------------------------------------------------------------------------
class StrategyStack:
    """The run's composed scheduling discipline.

    Owns the shared `FedCostAwareScheduler` decision core and the
    policy's strategy components. Engines report observations here
    (`note_*`) and invoke the decision points; strategies answer with
    directives that the stack (or the strategy itself, on reactive
    paths) applies through the `DirectiveExecutor`.

    A `WarningReaction` is appended automatically when the policy's
    strategy list does not name one, so the `on_warning` knob keeps
    working for every policy — exactly the pre-redesign behavior where
    the machinery lived in the shared engine base.
    """

    def __init__(self, strategies: Sequence[SchedulingStrategy],
                 ctx: StrategyContext):
        self.ctx = ctx
        self.sched = ctx.sched
        self.strategies: List[SchedulingStrategy] = list(strategies)
        if not any(isinstance(s, WarningReaction)
                   for s in self.strategies):
            self.strategies.append(WarningReaction(ctx.policy.on_warning))
        for s in self.strategies:
            s.bind(ctx)

    @classmethod
    def from_policy(cls, policy, ctx: StrategyContext) -> "StrategyStack":
        """Build the stack a policy's declarative spec list describes."""
        return cls([spec.build(policy) for spec in policy.strategies],
                   ctx)

    def attach_engine(self, view) -> None:
        """Register the engine adapter strategies read per-epoch facts
        from (`is_training` / `train_start` / …)."""
        self.ctx.view = view

    # ------------------------------------------------------------------
    # Observation reporting (engines feed the shared decision core).
    # ------------------------------------------------------------------
    def begin_round(self, round_idx: int) -> None:
        """A new FL round opened: reset per-round decision state."""
        self.sched.begin_round(round_idx)

    def note_dispatch(self, client: str, t: float, cold: bool,
                      includes_spin_up: bool) -> None:
        """A training task was dispatched to `client` at `t`."""
        self.sched.register_dispatch(client, t, cold, includes_spin_up)

    def note_result(self, client: str, t: float, epoch_s: float,
                    cold: bool, spin_up_s: Optional[float]) -> None:
        """`client` finished a full epoch: update finish state and the
        §III-B EMA estimates."""
        self.sched.on_result(client, t, epoch_s, cold, spin_up_s)

    def note_resume_result(self, client: str, t: float,
                           spin_up_s: Optional[float]) -> None:
        """`client` finished a *partial* (checkpoint-resumed) epoch:
        partial durations would corrupt the epoch-time EMAs, so only
        the finish state and the spin-up observation are recorded."""
        s = self.sched.states[client]
        s.finished = True
        s.finish_time = t
        if spin_up_s is not None:
            self.sched.est.observe_spin_up(client, spin_up_s)

    def note_observation(self, client: str,
                         epoch_s: Optional[float] = None,
                         cold: bool = False,
                         spin_up_s: Optional[float] = None) -> None:
        """Round-free estimator update (async engines keep the EMAs
        fresh without the sync barrier's round bookkeeping)."""
        if epoch_s is not None:
            self.sched.est.observe_epoch(client, epoch_s, cold)
        if spin_up_s is not None:
            self.sched.est.observe_spin_up(client, spin_up_s)

    # ------------------------------------------------------------------
    # Decision points.
    # ------------------------------------------------------------------
    def screen(self, round_idx: int, candidates: List[str]
               ) -> Tuple[List[str], List[str]]:
        """Chain every component's screening pass; returns the
        surviving participants and the newly screened-out clients
        (whose `ScreenOut` directives were already applied)."""
        keep, screened_all = list(candidates), []
        for s in self.strategies:
            keep, screened = s.screen(round_idx, keep)
            screened_all.extend(screened)
        return keep, screened_all

    def client_result(self, client: str, t: float,
                      more_rounds: bool) -> None:
        """`client` delivered its round result while the round is
        still open: apply every component's lifecycle directives."""
        for s in self.strategies:
            d = s.on_client_result(client, t, more_rounds)
            if d:
                self.ctx.executor.apply(d)

    def recovered(self, client: str, remaining_s: float) -> None:
        """§III-D dynamic schedule adjustment: `client` restarts after
        a reclaim (or drain) owing `remaining_s` seconds; push back the
        pre-warm targets of already-terminated clients so they stay
        off while it recovers."""
        spin_est = self.sched.est.model(client).spin_up.get(
            self.ctx.spin_up_default)
        recovery_finish = self.ctx.now() + spin_est + remaining_s
        moved = self.sched.on_preemption_recovery(client, recovery_finish)
        if moved:
            self.ctx.executor.apply(
                [PreWarm(c, t) for c, t in moved.items()])

    def preemption_remaining(self, client: str, periodic_remaining: float
                             ) -> Tuple[float, str]:
        """Epoch time still owed after a reclaim, from the best
        surviving checkpoint any component can offer; falls back to
        the periodic checkpoint. Returns `(remaining_s, source)`."""
        for s in self.strategies:
            better = s.preemption_remaining(client, periodic_remaining)
            if better is not None:
                return better
        return periodic_remaining, "periodic"

    def invalidate_ckpt(self, client: str) -> None:
        """The client's epoch completed: per-epoch strategy state
        (warning snapshots) is stale."""
        for s in self.strategies:
            s.invalidate(client)

    def prewarm_target(self, client: str) -> Optional[float]:
        """The client's currently queued pre-warm fire time, if any
        (consulted by the cluster's staleness check at fire time)."""
        return self.sched.prewarm_queue.get(client)
