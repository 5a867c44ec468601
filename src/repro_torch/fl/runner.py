"""FL-on-cloud runner: the thin composition root.

Wires the layered stack together and drains the simulator:

  EventBus          typed pub/sub connecting every layer (core.events)
  CloudSimulator    discrete-event cloud; publishes instance lifecycle +
                    billing events (cloud.simulator)
  CostAccountant    incremental per-client dollar accounting off the
                    billing events (cloud.accounting)
  ClusterManager    instance lifecycle: request / terminate / pre-warm /
                    standby / resume-from-checkpoint (fl.cluster)
  DirectiveExecutor applies typed strategy directives against the
                    cluster (fl.cluster)
  StrategyStack     the policy's composed scheduling discipline —
                    Listing-1 lifecycle, §III-E budget screening,
                    preemption-notice reaction, forecast pre-warming
                    (core.strategy), sharing one FedCostAware decision
                    core (core.scheduler)
  RoundEngine       FL-round semantics — SyncEngine reproduces the
                    paper's synchronous barrier (Table I); the
                    AsyncBufferedEngine adds FedBuff-style buffered
                    asynchronous rounds (fl.engines)

The policy (`on_demand` / `spot` / `fedcostaware` / `fedcostaware_async`
or any `register_policy`-ed composition) selects the market, the
strategy composition, and the engine. Optionally a `TrainerHooks`
object attaches *real training* so the run produces an actual
global model; simulated time stays decoupled from wall-clock, mirroring
the paper's scaled-duration simulation setup for MNIST/CIFAR.

Outputs (`RunResult`): per-client costs, a Fig-4 style state timeline, a
Fig-5 style cumulative cost curve, and the trained model (when hooks
attached).

Every run is recordable: `record=True` attaches an `EventRecorder`
(core.eventlog) capturing the full typed event stream in memory, and
`record_to=<path>` additionally persists it as JSONL at the end of
`run()`. A recorded trace replays offline through
`repro_torch.fl.telemetry.replay_result` — same timelines, same costs, no
simulation.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Union

import numpy as np

from repro_torch.checkpoint.store import MemoryStore, ObjectStore
from repro_torch.cloud.accounting import CostAccountant
from repro_torch.cloud.pricing import SpotMarket
from repro_torch.comms.channel import CommsModel, UplinkChannel
from repro_torch.comms.payload import UpdatePayload
from repro_torch.cloud.simulator import CloudSimulator
from repro_torch.common.config import CloudConfig, FLRunConfig, SchedulerConfig
from repro_torch.core.events import EventBus, RunCompleted
from repro_torch.core.eventlog import EventRecorder
from repro_torch.core.policies import Policy, get_policy, make_scheduler
from repro_torch.core.strategy import StrategyContext, StrategyStack
from repro_torch.fl.cluster import ClusterManager, DirectiveExecutor
from repro_torch.fl.engines import EngineContext, get_engine
from repro_torch.forecast.feed import ObservableFeed
from repro_torch.fl.fleet import FleetRunner, fleet_supported
from repro_torch.fl.telemetry import Segment, TimelineRecorder
from repro_torch.fl.types import RunResult, TrainerHooks

__all__ = ["FLCloudRunner", "RunResult", "Segment", "TrainerHooks"]


class FLCloudRunner:
    """Compose a full FL-on-cloud run and execute it (see module
    docstring for the layer map; docs/architecture.md for the long
    form)."""

    def __init__(self, run_cfg: FLRunConfig,
                 cloud_cfg: Optional[CloudConfig] = None,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 hooks: Optional[TrainerHooks] = None,
                 seed: Optional[int] = None,
                 record_to: Optional[Union[str, Path]] = None,
                 record: bool = False,
                 ckpt_store: Optional[ObjectStore] = None):
        self.run_cfg = run_cfg
        self.cloud_cfg = cloud_cfg or CloudConfig()
        self.sched_cfg = sched_cfg or SchedulerConfig()
        self.policy: Policy = get_policy(run_cfg.policy)
        if run_cfg.cross_provider is not None:
            self.policy = dataclasses.replace(
                self.policy, cross_provider=run_cfg.cross_provider)
        if run_cfg.on_warning is not None:
            self.policy = dataclasses.replace(
                self.policy, on_warning=run_cfg.on_warning)
        if run_cfg.engine is not None:
            self.policy = dataclasses.replace(
                self.policy, engine=run_cfg.engine)
        seed = run_cfg.seed if seed is None else seed
        self.record_to = record_to
        # the simulated S3: warning-window client snapshots land here
        # (checkpoint.snapshots); callers may pass a FileStore to keep
        # them on disk
        self.ckpt_store = ckpt_store or MemoryStore()

        # fleet dispatch: population runs, fleet=True, or explicit
        # client lists at/above CloudConfig.fleet_threshold under a
        # fleet-capable policy take the struct-of-arrays hot path
        # (repro_torch.fl.fleet) instead of the per-object event stack below
        self._fleet: Optional[FleetRunner] = None
        if self._fleet_mode():
            if hooks is not None:
                raise ValueError(
                    "the fleet path does not support TrainerHooks; "
                    "pass fleet=False to force the per-object engines")
            if run_cfg.update_payload_mb is not None:
                raise ValueError(
                    "the fleet path does not model comms; unset "
                    "update_payload_mb or pass fleet=False")
            self.bus = EventBus()
            self.recorder = None
            if record or record_to is not None:
                self.recorder = EventRecorder(self.bus, meta={
                    "dataset": run_cfg.dataset, "policy": run_cfg.policy,
                    "seed": seed, "n_epochs": run_cfg.n_epochs,
                    "clients": [c.name for c in run_cfg.clients]})
            market = SpotMarket.for_cloud_config(self.cloud_cfg,
                                                 seed=seed)
            self._fleet = FleetRunner(run_cfg, self.cloud_cfg,
                                      self.sched_cfg, self.policy,
                                      market, self.bus, seed)
            # the per-object layers are never built on this path
            self.sim = None
            self.accountant = None
            self.scheduler = None
            self.cluster = None
            self.executor = None
            self.feed = None
            self.strategies = None
            self.timeline = None
            self.engine = None
            self.hooks = hooks
            return

        # layer wiring — construction order fixes bus subscription order:
        # the recorder (wildcard) sees everything first, accounting sees
        # cloud events before the cluster re-publishes them as client
        # events, and engines only ever see client events.
        self.bus = EventBus()
        # only attached on request: encoding every event and retaining
        # the stream is pure overhead for callers that just want a
        # RunResult. `record=True` keeps it in memory (self.recorder);
        # `record_to` additionally persists it after run().
        self.recorder: Optional[EventRecorder] = None
        if record or record_to is not None:
            self.recorder = EventRecorder(self.bus, meta={
                "dataset": run_cfg.dataset, "policy": run_cfg.policy,
                "seed": seed, "n_epochs": run_cfg.n_epochs,
                "clients": [c.name for c in run_cfg.clients]})
        self.sim = CloudSimulator(self.cloud_cfg, seed=seed, bus=self.bus)
        self.accountant = CostAccountant(self.bus, self.sim.market,
                                         clock=lambda: self.sim.now)
        # the FedCostAware decision core (estimator + ledger): shared
        # state behind every strategy component; engines never touch it
        self.scheduler = make_scheduler(
            self.policy, self.sched_cfg, self.cloud_cfg.spin_up_mean_s)
        self.profiles = {c.name: c for c in run_cfg.clients}
        for c in run_cfg.clients:
            self.scheduler.ledger.register(c.name, c.budget)
        self.timeline = TimelineRecorder(self.bus)
        # the fire-time staleness check reads pre-warm targets through
        # the strategy stack (constructed just below; targets are only
        # consulted at simulated fire time, long after __init__)
        self.cluster = ClusterManager(
            self.sim, self.policy, self.profiles, self.scheduler,
            prewarm_target_of=lambda c: self.strategies.prewarm_target(c))
        self.executor = DirectiveExecutor(
            self.cluster, ckpt_store=self.ckpt_store,
            ckpt_size_mb=self.sched_cfg.warning_ckpt_size_mb,
            trace=run_cfg.trace_directives)
        # the tenant-observable market surface (repro_torch.forecast):
        # learned strategies attach their predictors here, and the
        # observable hazard fallback below routes through it. Built
        # after every simulator/accounting subscription so its pure
        # observer handlers run last and cannot reorder anything.
        self.feed = ObservableFeed.for_market(
            self.sim.market, self.cloud_cfg.preemption_rate_per_hr,
            bus=self.bus)
        self.strategies = StrategyStack.from_policy(
            self.policy, StrategyContext(
                policy=self.policy, sched=self.scheduler,
                sched_cfg=self.sched_cfg, bus=self.bus,
                now=lambda: self.sim.now,
                schedule_in=self.sim.schedule_in,
                clients=tuple(self.profiles),
                spin_up_default=self.cloud_cfg.spin_up_mean_s,
                instance_of=self.cluster.instance_of,
                standby_of=self.cluster.standby_of,
                spot_price_of=self.cluster.spot_price_of,
                spend_of=self.accountant.client_cost,
                hazard_of=self._hazard_of,
                observable_hazard_of=self._observable_hazard_of,
                ckpt_cost_of=lambda provider, mb: (
                    self.sim.market.provider_of(provider)
                    .storage.checkpoint_cost(mb)),
                is_shutdown=lambda: self.cluster.is_shutdown,
                feed=self.feed,
                ckpt_store=self.ckpt_store,
                executor=self.executor))
        self.hooks = hooks
        self.comms = self._build_comms()
        self.engine = get_engine(self.policy.engine)(EngineContext(
            run_cfg=run_cfg, cloud_cfg=self.cloud_cfg,
            sched_cfg=self.sched_cfg, policy=self.policy, sim=self.sim,
            cluster=self.cluster, strategies=self.strategies,
            accountant=self.accountant, timeline=self.timeline,
            rng=np.random.RandomState(seed + 101), hooks=hooks,
            ckpt_store=self.ckpt_store, comms=self.comms))

    def _build_comms(self) -> Optional[CommsModel]:
        """Comms modeling is strictly opt-in: hooks that expose a real
        payload win over the modeled `FLRunConfig.update_payload_mb`;
        with neither, uploads stay instantaneous and free and no comms
        events are published (every pre-v7 stream is unchanged)."""
        quantized = self.run_cfg.quantize_updates
        payload: Optional[UpdatePayload] = None
        if self.hooks is not None:
            # getattr: duck-typed hooks predating `update_payload` pass
            sizer = getattr(self.hooks, "update_payload", None)
            payload = sizer(quantized=quantized) if sizer else None
        if payload is None and self.run_cfg.update_payload_mb is not None:
            payload = UpdatePayload.from_mb(self.run_cfg.update_payload_mb,
                                            quantized=quantized)
        if payload is None:
            return None
        return CommsModel(payload, UplinkChannel.from_market(
            self.sim.market))

    # ------------------------------------------------------------------
    def _fleet_mode(self) -> bool:
        """Decide the execution path: `FLRunConfig.fleet` forces it
        either way (population runs and cohort sampling *require* the
        fleet path); with no override, explicit client lists at or
        above `CloudConfig.fleet_threshold` under a fleet-capable
        policy are auto-promoted."""
        rc = self.run_cfg
        if rc.fleet is False:
            if rc.population is not None:
                raise ValueError(
                    "population runs require the fleet path; "
                    "fleet=False is contradictory")
            mode = False
        elif rc.population is not None or rc.fleet is True:
            if not fleet_supported(self.policy):
                raise ValueError(
                    f"policy {self.policy.name!r} cannot run on the "
                    f"fleet path (sync engine, on_warning='ignore', "
                    f"lifecycle/budget strategies only)")
            mode = True
        else:
            mode = (fleet_supported(self.policy)
                    and len(rc.clients) >= self.cloud_cfg.fleet_threshold)
        if rc.cohort_size is not None and not mode:
            raise ValueError("cohort_size requires the fleet path "
                             "(population runs or fleet=True)")
        return mode

    # ------------------------------------------------------------------
    def _stamp_hazard_source(self, source: str) -> None:
        """Record which hazard signal the run's strategies actually
        consulted in the trace header (`hazard_source`: "oracle" |
        "observable" | "mixed"). Stamped lazily on first use, so runs
        whose strategies never poll a hazard — every default policy —
        record headers without the key, byte-identical to before."""
        if self.recorder is None:
            return
        prev = self.recorder.header.get("hazard_source")
        if prev is None:
            self.recorder.header["hazard_source"] = source
        elif prev != source:
            self.recorder.header["hazard_source"] = "mixed"

    def _observable_hazard_of(self, client: str) -> float:
        """The tenant-observable reclaim-hazard estimate (events/hour)
        for the client's tracked spot instance right now; 0 when
        untracked or on-demand. Routed through the run's
        `ObservableFeed` (`repro_torch.forecast`): the price-derived
        price-coupled formula evaluated on published prices — how a
        real scheduler reads an interruption forecast off the market,
        with no model internals involved."""
        inst = self.cluster.instance_of(client)
        if inst is None or inst.on_demand:
            return 0.0
        self._stamp_hazard_source("observable")
        return self.feed.price_derived_hazard(
            inst.provider, inst.zone, self.sim.now) * 3600.0

    def _hazard_of(self, client: str) -> float:
        """The *oracle* reclaim hazard (events/hour) for the client's
        tracked spot instance right now; 0 when untracked or
        on-demand. Uses the driving preemption model's own hazard when
        it exposes one (`PriceCoupledModel`); otherwise — e.g. under
        recorded-interruption replay, where the true reclaim times are
        not observable in advance — it falls back to the observable
        estimate, and the recorded trace header says so
        (`hazard_source: "observable"`) instead of silently
        substituting."""
        inst = self.cluster.instance_of(client)
        if inst is None or inst.on_demand:
            return 0.0
        hazard = getattr(self.sim.preemption_model, "hazard", None)
        if hazard is None:
            return self._observable_hazard_of(client)
        self._stamp_hazard_source("oracle")
        return hazard(inst.provider, inst.zone, self.sim.now) * 3600.0

    # ------------------------------------------------------------------
    def run(self) -> RunResult:
        """Execute the run to completion: start the engine, drain the
        simulator, publish the terminal `RunCompleted` summary, persist
        the event log if requested, and return the `RunResult`."""
        if self._fleet is not None:
            res = self._fleet.run()
            # fleet-mode terminal summary: per-client costs live in
            # RunResult.per_client_cost and, per step, in
            # FleetStepSummary.client_cost_delta (schema v6) — the
            # terminal event stays aggregate, so client_costs is
            # deliberately empty
            self.bus.publish(RunCompleted(
                res.makespan_s, makespan_s=res.makespan_s,
                total_cost=res.total_cost, client_costs={},
                rounds_completed=res.rounds_completed,
                excluded_clients=tuple(res.excluded_clients),
                final_round_idx=res.rounds_completed - 1))
            if self.record_to is not None:
                self.recorder.dump(self.record_to)
            return res
        self.engine.start()
        self.sim.run_until_idle()
        self.timeline.close(self.sim.now)   # no-op on complete runs
        res = self.engine.result()
        # terminal summary, published after the drain: the sync engine's
        # makespan includes post-finish drain time, so only here is the
        # true makespan known. Costs are frozen once the engine finishes,
        # making this snapshot == the accountant's state at finish.
        self.bus.publish(RunCompleted(
            self.sim.now, makespan_s=res.makespan_s,
            total_cost=res.total_cost,
            client_costs=dict(res.per_client_cost),
            rounds_completed=res.rounds_completed,
            excluded_clients=tuple(res.excluded_clients),
            final_round_idx=res.rounds_completed - 1))
        if self.record_to is not None:
            self.recorder.dump(self.record_to)
        return res
