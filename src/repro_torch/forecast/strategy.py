"""`LearnedForecastStrategy`: learned predictions -> directives.

The composition the whole package exists for: a `SchedulingStrategy`
(`repro_torch.core.strategy` API — zero engine or cloud edits) that

  1. samples the tenant-observable market surface through the run's
     `ObservableFeed` (`ctx.feed`, wired by the composition root),
  2. keeps an online `Forecaster` and a `CalibrationTracker` fed from
     those observations,
  3. converts the predicted interruption probability into PreWarm /
     Checkpoint / Drain directives via the explicit cost-of-error rule
     (`repro_torch.forecast.decision`), priced from the live spot rate and
     the provider's storage rates, and
  4. publishes one `ForecastUpdated` telemetry event per poll per
     tracked training spot client (eventlog schema v8) carrying the
     prediction, the learned price band, and the running calibration
     metrics — the raw material `benchmarks/forecast_quality.py` maps
     from calibration to dollars.

Unlike `ForecastPrewarmStrategy(oracle=True)` this strategy never
touches the preemption model: every input is something a real tenant
could read off its own bus. The checkpoint/drain arms mirror the
guard discipline of `core.strategy.WarningReaction` (stale-instance /
stale-epoch checks around the asynchronous snapshot write), but fire
on *predicted* doom rather than a provider notice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.checkpoint import snapshots
from repro_torch.core.events import ForecastUpdated
from repro_torch.core.policies import Policy, register_policy
from repro_torch.core.strategy import (Checkpoint, Directive, Drain,
                                 SchedulingStrategy, SpinUp,
                                 StrategyContext, StrategySpec,
                                 Terminate)
from repro_torch.forecast.calibration import CalibrationTracker
from repro_torch.forecast.decision import Decision, DecisionConfig, decide
from repro_torch.forecast.predictors import Forecaster, make_forecaster

# instance-state literal shared with repro_torch.cloud.simulator.RUNNING
_RUNNING = "running"


@dataclasses.dataclass(frozen=True)
class LearnedForecastSpec(StrategySpec):
    """Declarative spec of a `LearnedForecastStrategy`.

    `forecaster` picks the predictor ("quantile" or "ewma");
    `prior_rate_per_hr` seeds both predictors' hazard prior (a real
    tenant's base interruption-rate assumption). The decision knobs
    mirror `DecisionConfig`; the learning knobs (`lr`,
    `spike_margin`, `prior_weight`, `ewma_alpha`) reach the chosen
    predictor. `miscalibrate=True` builds the deliberately wrong
    quantile forecaster (regime hazards swapped at query time) used to
    demonstrate that bad calibration loses money."""
    forecaster: str = "quantile"
    horizon_s: float = 600.0
    poll_s: float = 30.0
    prior_rate_per_hr: float = 1.0
    stall_weight: float = 3.0
    prewarm_hysteresis: float = 0.5
    drain_threshold: float = 0.95
    lr: float = 0.05
    spike_margin: float = 0.15
    prior_weight: float = 1.0
    ewma_alpha: float = 0.3
    miscalibrate: bool = False
    seed: int = 0

    def build(self, policy) -> "SchedulingStrategy":
        """A `LearnedForecastStrategy` configured by this spec."""
        return LearnedForecastStrategy(self)

    def make_forecaster(self) -> Forecaster:
        """The configured online predictor instance."""
        if self.forecaster == "ewma":
            return make_forecaster(
                "ewma", base_rate_per_hr=self.prior_rate_per_hr,
                alpha=self.ewma_alpha, seed=self.seed)
        return make_forecaster(
            "quantile", lr=self.lr, spike_margin=self.spike_margin,
            base_rate_per_hr=self.prior_rate_per_hr,
            prior_weight=self.prior_weight,
            miscalibrate=self.miscalibrate, seed=self.seed)


class LearnedForecastStrategy(SchedulingStrategy):
    """Forecast-driven scheduling from observable signals only
    (module docstring)."""

    def __init__(self, spec: LearnedForecastSpec):
        self.spec = spec
        self.predictor = spec.make_forecaster()
        self.calibration = CalibrationTracker(spec.horizon_s)
        self.decision_cfg = DecisionConfig(
            horizon_s=spec.horizon_s, stall_weight=spec.stall_weight,
            prewarm_hysteresis=spec.prewarm_hysteresis,
            drain_threshold=spec.drain_threshold)
        self._snap: Dict[str, dict] = {}   # client -> durable snapshot
        self._writing: set = set()         # clients mid snapshot-write

    def bind(self, ctx: StrategyContext) -> None:
        """Attach the predictor + calibration to the run's observable
        feed and start the poll loop. Requires `ctx.feed` (the
        composition root's `ObservableFeed`)."""
        super().bind(ctx)
        if ctx.feed is None:
            raise ValueError(
                "LearnedForecastStrategy needs StrategyContext.feed "
                "(an ObservableFeed); the per-object FLCloudRunner "
                "wires one — the fleet path does not support learned "
                "forecasting")
        ctx.feed.attach(self.predictor)
        ctx.feed.attach(self.calibration)
        ctx.schedule_in(self.spec.poll_s, self._tick)

    # ------------------------------------------------------------------
    # The poll loop.
    # ------------------------------------------------------------------
    def _tick(self) -> None:
        """One forecast sweep: sample every tracked zone's price,
        resolve expired calibration questions, then decide and act per
        client. Re-arms itself until the cluster shuts down."""
        ctx = self.ctx
        if ctx.is_shutdown():
            return
        now = ctx.now()
        # pass 1: feed the predictors every tracked zone's price before
        # any prediction is read, so co-located clients see one
        # consistent market snapshot per tick
        for c in ctx.clients:
            inst = ctx.instance_of(c)
            if (inst is not None and not inst.on_demand
                    and inst.state == _RUNNING):
                ctx.feed.sample_price(inst.provider, inst.zone, now)
        self.calibration.advance(now)
        # pass 2: decide per client
        directives: List[Directive] = []
        for c in ctx.clients:
            directives.extend(self._decide_client(c, now))
        if directives:
            ctx.executor.apply(directives)
        ctx.schedule_in(self.spec.poll_s, self._tick)

    def _decide_client(self, c: str, now: float) -> List[Directive]:
        """Evaluate the cost-of-error rule for one client and emit the
        resulting directives + `ForecastUpdated` telemetry."""
        ctx = self.ctx
        spec = self.spec
        inst = ctx.instance_of(c)
        standby = ctx.standby_of(c)
        tracked_spot = (inst is not None and not inst.on_demand
                        and inst.state == _RUNNING)
        training = ctx.view is not None and ctx.view.is_training(c)
        if not (tracked_spot and training):
            # nobody stalls on an idle/untracked client's reclaim: an
            # active standby for it is pure waste
            if standby is not None:
                return [Terminate(c, standby=True)]
            return []
        provider, zone = inst.provider, inst.zone
        p = self.predictor.interruption_probability(
            provider, zone, now, spec.horizon_s)
        hazard = self.predictor.hazard_per_hr(provider, zone, now)
        self.calibration.note_prediction(provider, zone, now, p)
        quants = self.predictor.price_quantiles(provider, zone)
        lo = mid = hi = 0.0
        if quants:
            lo, hi = quants[min(quants)], quants[max(quants)]
            mid = quants.get(0.5, (lo + hi) / 2.0)
            self.calibration.note_band(provider, zone, lo, hi)

        epoch_started = ctx.view.train_start(c)
        progress_s = now - epoch_started
        snap = self._snap.get(c)
        fresh_snap = (snap is not None
                      and snap.get("epoch_started") == epoch_started)
        snapped_s = snap["progress"] if fresh_snap else 0.0
        # durable floor: the periodic checkpoint cadence covers
        # progress up to the last multiple of checkpoint_every_s
        every = ctx.sched_cfg.checkpoint_every_s
        if every > 0.0:
            snapped_s = max(snapped_s, (progress_s // every) * every)
        unsnapshotted = max(progress_s - snapped_s, 0.0)

        rate_hr = ctx.spot_price_of(c)
        # all-in snapshot cost: storage dollars + the paid instance
        # seconds the write itself occupies
        ckpt_usd = (ctx.ckpt_cost_of(
            provider, ctx.sched_cfg.warning_ckpt_size_mb)
            + ctx.sched_cfg.warning_ckpt_write_s * rate_hr / 3600.0)
        d = decide(
            p=p, spot_rate_hr=rate_hr,
            spin_up_s=ctx.spin_up_default,
            lost_work_s=unsnapshotted, unsnapshotted_s=unsnapshotted,
            ckpt_usd=ckpt_usd,
            standby_active=standby is not None,
            have_fresh_snapshot=fresh_snap, cfg=self.decision_cfg)

        out: List[Directive] = []
        if d.prewarm:
            out.append(SpinUp(c))
        elif d.release and standby is not None:
            out.append(Terminate(c, standby=True))
        if d.checkpoint and c not in self._writing:
            self._start_snapshot(c, inst, now, epoch_started)
        if d.drain and fresh_snap:
            self._drain(c, snap)
        ctx.bus.publish(ForecastUpdated(
            now, client=c, provider=provider, zone=zone,
            forecaster=self.predictor.name, horizon_s=spec.horizon_s,
            p_interrupt=p, hazard_per_hr=hazard,
            price_lo=lo, price_mid=mid, price_hi=hi,
            brier=self.calibration.brier(),
            coverage=self.calibration.coverage(), action=d.action))
        return out

    # ------------------------------------------------------------------
    # Forecast-triggered checkpoint/drain (WarningReaction's guard
    # discipline, driven by prediction instead of a provider notice).
    # ------------------------------------------------------------------
    def _start_snapshot(self, c: str, inst, now: float,
                        epoch_started: float) -> None:
        """Kick off an asynchronous snapshot write for the client's
        current epoch; completion re-checks that the world did not
        move on during the write."""
        write_s = self.ctx.sched_cfg.warning_ckpt_write_s
        progress_s = now - epoch_started
        self._writing.add(c)
        self.ctx.schedule_in(write_s, lambda: self._complete(
            c, inst, progress_s, epoch_started))

    def _complete(self, c: str, inst, progress_s: float,
                  epoch_started: float) -> None:
        """The forecast-triggered snapshot finished writing: persist
        it via a `Checkpoint` directive. A no-op when the instance was
        replaced, the epoch finished, or a new epoch began during the
        write."""
        ctx = self.ctx
        self._writing.discard(c)
        view = ctx.view
        if view.is_done():
            return
        cur = ctx.instance_of(c)
        if cur is None or cur.iid != inst.iid or cur.state != _RUNNING:
            return
        if not view.is_training(c):
            return
        if view.train_start(c) != epoch_started:
            return
        r = view.current_round()
        remaining = max(view.train_duration(c) - progress_s, 1.0)
        payload = {"client": c, "round": r, "remaining": remaining,
                   "progress": progress_s, "t": ctx.now()}
        self._snap[c] = dict(payload, epoch_started=epoch_started)
        ctx.executor.apply([Checkpoint(
            c, round_idx=r, progress_s=progress_s,
            remaining_s=remaining,
            reclaim_at=ctx.now() + self.spec.horizon_s,
            payload=payload)])

    def _drain(self, c: str, snap: dict) -> None:
        """Predicted doom + durable snapshot: vacate the instance now
        and re-request the replacement with a resume token."""
        view = self.ctx.view
        remaining = float(snap["remaining"])
        r = int(snap["round"])
        view.note_lost_work(c, remaining)
        self._snap.pop(c, None)
        self.ctx.executor.apply([Drain(c, resume_token={
            "round": r, "remaining": remaining, "source": "forecast"})])
        view.after_drain(c, remaining)

    # ------------------------------------------------------------------
    def preemption_remaining(self, client: str, periodic_remaining: float
                             ) -> Optional[Tuple[float, str]]:
        """Offer the forecast-triggered snapshot when it preserves
        more than the periodic checkpoint."""
        snap = self._snap.pop(client, None)
        if snap is None:
            return None
        stored = snapshots.load_snapshot(
            self.ctx.ckpt_store, client) or snap
        remaining = float(stored["remaining"])
        if remaining < periodic_remaining:
            return remaining, "forecast"
        return None

    def invalidate(self, client: str) -> None:
        """Epoch done: any forecast snapshot for it is stale."""
        self._snap.pop(client, None)


def register_learned_policy(name: str = "learned_forecast",
                            on_warning: str = "checkpoint",
                            overwrite: bool = True,
                            **spec_kwargs) -> Policy:
    """Register (and return) a policy composing the learned forecast
    strategy over cheapest-zone spot placement; `spec_kwargs` reach
    `LearnedForecastSpec`. The default `on_warning="checkpoint"` keeps
    provider-notice handling active alongside the forecaster, matching
    the reactive baseline it is benchmarked against."""
    return register_policy(Policy(
        name, pick_cheapest_zone=True, on_warning=on_warning,
        strategies=(LearnedForecastSpec(**spec_kwargs),)),
        overwrite=overwrite)
