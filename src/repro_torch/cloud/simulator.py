"""Discrete-event cloud simulator: instance lifecycles, spin-up delays,
model-driven spot preemption, and per-second billing against the
SpotMarket.

This is the stand-in for AWS EC2 + the custom Ray node launcher in the
paper. The FedCostAware scheduler interacts with it through exactly the
operations the paper's scheduler uses: request instance (in a chosen
zone, on a chosen provider), terminate instance, observe ready/preempt
events, read accrued cost.

Billing semantics are per provider (`repro_torch.cloud.pricing.Provider`):
the min-billing floor, billing granularity and preemption-notice lead
time all come from the provider descriptor of the zone an instance runs
in, so a multi-provider market bills each instance by its own
provider's rules.

Spot reclaims are delegated to a pluggable `PreemptionModel`
(`repro_torch.cloud.preemption`): the default constant-rate model reproduces
the historical flat-Poisson behavior bit-for-bit, while the
price-coupled and recorded-interruption models replay realistic fault
patterns (see docs/markets.md).

Lifecycle notifications are published as typed events on an `EventBus`
(`repro_torch.core.events`) — the simulator takes no per-request callbacks, so
any number of consumers (cluster manager, cost accountant, loggers) can
observe the same run without threading closures through call sites.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.common.config import CloudConfig
from repro_torch.cloud.preemption import PreemptionModel, build_preemption_model
from repro_torch.cloud.pricing import DEFAULT_PROVIDER, SpotMarket, Zone
from repro_torch.core.events import (BillingTick, EventBus, InstancePreempted,
                               InstancePreemptionWarning, InstanceReady,
                               InstanceRequested, InstanceTerminated)

# Instance states
REQUESTED, SPINNING_UP, RUNNING, TERMINATED, PREEMPTED = (
    "requested", "spinning_up", "running", "terminated", "preempted")


@dataclasses.dataclass
class Instance:
    """One cloud instance's mutable lifecycle record (the live
    counterpart of `repro_torch.core.eventlog.InstanceRef` snapshots)."""
    iid: int
    client: str
    zone: str
    on_demand: bool
    t_request: float
    t_ready: Optional[float] = None
    t_end: Optional[float] = None
    state: str = SPINNING_UP
    cost: float = 0.0          # finalized at termination/preemption
    _billing_from: Optional[float] = None
    provider: str = DEFAULT_PROVIDER


class CloudSimulator:
    """Event-driven cloud with billing.

    Events are (time, seq, callback) on a heap; callbacks may schedule
    further events. `run_until_idle` drains the heap. Lifecycle
    transitions are published on `self.bus`.
    """

    def __init__(self, cfg: CloudConfig,
                 market: Optional[SpotMarket] = None,
                 seed: int = 0, bus: Optional[EventBus] = None,
                 preemption_model: Optional[PreemptionModel] = None):
        self.cfg = cfg
        self.market = market or SpotMarket.for_cloud_config(cfg, seed=seed)
        self.preemption_model = (preemption_model
                                 or build_preemption_model(cfg,
                                                           self.market))
        self.bus = bus or EventBus()
        self.now = 0.0
        self._heap: List = []
        self._seq = itertools.count()
        self._rng = np.random.RandomState(seed + 17)
        self._instances: Dict[int, Instance] = {}
        self._iid = itertools.count(1)
        self.event_log: List[dict] = []
        # aggregate-query indexes: per-client instance lists, running
        # settled-cost accumulators, and the set of instances with an
        # open billing segment — total_cost/client_cost/instances_of
        # are O(open)/O(k) instead of scanning every instance ever made
        self._by_client: Dict[str, List[Instance]] = defaultdict(list)
        self._settled_total = 0.0
        self._settled_by_client: Dict[str, float] = defaultdict(float)
        self._open_by_client: Dict[str, Dict[int, Instance]] = (
            defaultdict(dict))

    @property
    def prices(self) -> SpotMarket:
        """Pre-redesign name for the market facade."""
        return self.market

    def provider_of(self, inst: Instance):
        """Billing semantics of the instance's provider."""
        return self.market.provider_of(inst.provider)

    # ------------------------------------------------------------------
    # Event engine.
    # ------------------------------------------------------------------
    def schedule(self, t: float, fn: Callable[[], None]):
        """Run `fn` at absolute simulated time `t` (>= now); same-time
        events fire in scheduling order (FIFO sequence numbers)."""
        assert t >= self.now - 1e-9, (t, self.now)
        heapq.heappush(self._heap, (max(t, self.now), next(self._seq), fn))

    def schedule_in(self, delay: float, fn: Callable[[], None]):
        """`schedule` relative to the current clock."""
        self.schedule(self.now + max(delay, 0.0), fn)

    def run_until_idle(self, t_max: float = math.inf):
        """Drain the event heap (advancing `now`), stopping before the
        first event past `t_max` (which stays queued)."""
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            if t > t_max:
                heapq.heappush(self._heap, (t, next(self._seq), fn))
                return
            self.now = max(self.now, t)
            fn()

    # ------------------------------------------------------------------
    # Instance lifecycle (the paper's Ray-autoscaler custom API analogue).
    # ------------------------------------------------------------------
    def sample_spin_up(self) -> float:
        """Lognormal provisioning+boot delay around
        `cfg.spin_up_mean_s`."""
        mu = math.log(self.cfg.spin_up_mean_s)
        return float(np.exp(mu + self._rng.randn() * self.cfg.spin_up_sigma))

    def request_instance(self, client: str,
                         zone: Optional[Union[str, Zone]] = None,
                         on_demand: bool = False,
                         provider: Optional[str] = None) -> Instance:
        """Launch an instance for `client` in `zone` (None -> the
        currently cheapest zone across the whole market); it becomes
        RUNNING after a sampled spin-up delay and — if spot — gets its
        reclaim scheduled by the preemption model."""
        if zone is None:
            z, _ = self.market.cheapest_zone(self.now)
            zone, provider = z.name, z.provider
        elif isinstance(zone, Zone):
            zone, provider = zone.name, zone.provider
        # a bare pinned zone name binds to its owning provider (first
        # registered), not blindly to the default provider
        inst = Instance(next(self._iid), client, zone, on_demand, self.now,
                        provider=self.market.resolve_provider(zone,
                                                              provider))
        self._instances[inst.iid] = inst
        self._by_client[inst.client].append(inst)
        spin = self.sample_spin_up()
        self._log("request", inst)
        self.bus.publish(InstanceRequested(self.now, inst))

        def ready():
            if inst.state != SPINNING_UP:        # terminated while spinning
                return
            inst.state = RUNNING
            inst.t_ready = self.now
            inst._billing_from = self.now
            self._open_by_client[inst.client][inst.iid] = inst
            self._log("ready", inst)
            if not inst.on_demand:
                self._schedule_preemption(inst)
            self.bus.publish(InstanceReady(self.now, inst))

        self.schedule_in(spin, ready)
        return inst

    def _schedule_preemption(self, inst: Instance):
        """Ask the preemption model when the spot market reclaims
        `inst`; schedule the provider's warning and the reclaim. A
        model answer of None means the instance is never preempted."""
        delay = self.preemption_model.next_preemption_delay(
            inst, self.now, self._rng)
        if delay is None:
            return
        notice = self.provider_of(inst).preemption_notice_s
        if notice > 0.0:
            # the provider's reclaim warning (AWS: 2 min) precedes the
            # actual reclaim; consumers may checkpoint / drain on it
            reclaim_at = self.now + delay

            def warn():
                if inst.state == RUNNING:
                    self.bus.publish(InstancePreemptionWarning(
                        self.now, inst, reclaim_at))

            self.schedule_in(max(delay - notice, 0.0), warn)
        self.schedule_in(delay, lambda: self.preempt(inst))

    def preempt(self, inst: Instance) -> bool:
        """Spot reclaim. A no-op unless the instance is RUNNING — in
        particular, a preemption arriving while the instance is still
        SPINNING_UP neither bills nor changes state. Returns True if the
        instance was actually reclaimed."""
        if inst.state != RUNNING:
            return False
        self._finalize_billing(inst)
        inst.state = PREEMPTED
        inst.t_end = self.now
        self._log("preempt", inst)
        self.bus.publish(InstancePreempted(self.now, inst))
        return True

    def terminate(self, inst: Instance):
        """Custom terminate-specific-node API (paper §III-C)."""
        if inst.state in (TERMINATED, PREEMPTED):
            return
        if inst.state == RUNNING:
            self._finalize_billing(inst)
        inst.state = TERMINATED
        inst.t_end = self.now
        self._log("terminate", inst)
        self.bus.publish(InstanceTerminated(self.now, inst))

    # ------------------------------------------------------------------
    # Billing.
    # ------------------------------------------------------------------
    def _finalize_billing(self, inst: Instance):
        t0 = inst._billing_from
        if t0 is None:
            return
        t1 = self.now
        prov = self.provider_of(inst)
        billed = max(t1 - t0, prov.min_billing_s if not inst.on_demand
                     else 0.0)
        # coarse-granularity providers round the billed duration up to
        # whole billing units; per-second (or finer) billing is treated
        # as continuous, matching the pre-redesign behavior
        g = prov.billing_granularity_s
        if g > 1.0:
            billed = math.ceil(billed / g - 1e-12) * g
        amount = self.market.cost(inst.zone, t0, t0 + billed,
                                  inst.on_demand, provider=inst.provider)
        inst.cost += amount
        inst._billing_from = None
        self._settled_total += amount
        self._settled_by_client[inst.client] += amount
        self._open_by_client[inst.client].pop(inst.iid, None)
        self.bus.publish(BillingTick(self.now, inst, inst.client,
                                     t0, t0 + billed, amount))

    def accrued_cost(self, inst: Instance) -> float:
        """Cost so far including the open billing segment."""
        c = inst.cost
        if inst._billing_from is not None:
            c += self.market.cost(inst.zone, inst._billing_from, self.now,
                                  inst.on_demand, provider=inst.provider)
        return c

    def _open_cost(self, inst: Instance) -> float:
        """Price of the instance's open billing segment (0 if closed)."""
        if inst._billing_from is None:
            return 0.0
        return self.market.cost(inst.zone, inst._billing_from, self.now,
                                inst.on_demand, provider=inst.provider)

    def client_cost(self, client: str) -> float:
        """Settled accumulator + the client's open segments: O(open
        instances of `client`), not a scan of every instance ever made
        (see benchmarks/accounting_bench.py for the old gap)."""
        return (self._settled_by_client[client]
                + sum(self._open_cost(i)
                      for i in self._open_by_client[client].values()))

    def total_cost(self) -> float:
        """Settled accumulator + all open segments: O(currently open
        instances); see `client_cost`."""
        open_cost = sum(self._open_cost(i)
                        for open_map in self._open_by_client.values()
                        for i in open_map.values())
        return self._settled_total + open_cost

    def instances_of(self, client: str) -> List[Instance]:
        """Every instance (any state) ever created for `client` —
        served from the per-client index in O(k)."""
        return list(self._by_client[client])

    # ------------------------------------------------------------------
    def _log(self, kind: str, inst: Instance):
        self.event_log.append({
            "t": self.now, "kind": kind, "client": inst.client,
            "iid": inst.iid, "zone": inst.zone,
            "provider": inst.provider, "on_demand": inst.on_demand,
        })
