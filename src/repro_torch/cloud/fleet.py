"""Struct-of-arrays fleet core: vectorized instance state + billing.

The per-object `CloudSimulator` pays one heap callback, one `Instance`
object and several bus publishes per instance lifecycle transition —
fine at cross-silo scale (tens of clients), hopeless for the ROADMAP's
100k-client fleets. This module holds the same lifecycle state in
contiguous numpy arrays, one slot per client:

  status        int8    ABSENT | SPINNING | RUNNING
  zone_idx      int64   index into the market's zone table
  t_request / t_ready   spin-up timing of the current instance
  billing_from  float64 open-billing anchor (NaN = no open segment)
  preempt_at    float64 absolute reclaim time (inf = never)
  fresh         bool    no epoch completed on the current instance yet
  settled       float64 dollars settled for the client so far

so a whole step's spin-up completions, billing settlements and
preemption draws are single array operations (`SpotMarket.cost_batch`,
`PreemptionModel.next_preemption_delays`) instead of Python loops.

Billing semantics are identical to the per-object path: billing starts
when an instance becomes RUNNING (spin-up is unbilled), segments close
at terminate/preempt with the provider's min-billing floor (spot only)
and granularity rounding, and dollars are priced by the zone's
`SpotMarket` source over the exact same prefix-sum integrals.

`ClientArrays` is the matching client-profile SoA: built either from
explicit `ClientProfile` tuples or — the cross-device jump — expanded
from a `PopulationConfig` in O(arrays), never materializing one Python
object per client.

The round discipline that drives these arrays lives in
`repro_torch.fl.fleet.FleetRunner`; the switch between this core and the
per-object path is `CloudConfig.fleet_threshold` / `FLRunConfig.fleet`
(see docs/architecture.md, "Fleet core").
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.config import ClientProfile, PopulationConfig
from repro_torch.cloud.pricing import SpotMarket

# instance slot states
ABSENT, SPINNING, RUNNING = 0, 1, 2


class _Placement:
    """Lightweight (provider, zone) record passed to the preemption
    models' vectorized path — duck-typed like an `Instance` but shared
    across a whole zone group, so batching 10k draws allocates a
    handful of these, not 10k."""

    __slots__ = ("provider", "zone")

    def __init__(self, provider: str, zone: str):
        self.provider = provider
        self.zone = zone


class ClientArrays:
    """Client heterogeneity profiles as contiguous arrays.

    Names are generated lazily (`name` / `names`): a 100k-client
    population costs five float arrays up front, and the string names
    only materialize when a result dict is assembled at run end.
    """

    def __init__(self, n: int, warm_mean: np.ndarray,
                 cold_mult: np.ndarray, jitter: np.ndarray,
                 budget: np.ndarray, join_round: np.ndarray,
                 name_prefix: str = "c",
                 explicit_names: Optional[List[str]] = None,
                 pinned: Optional[List[Optional[Tuple[Optional[str],
                                                      str]]]] = None):
        self.n = n
        self.warm_mean = warm_mean
        self.cold_mult = cold_mult
        self.jitter = jitter
        self.budget = budget
        self.join_round = join_round
        self._prefix = name_prefix
        self._names = explicit_names      # None -> prefix+index on demand
        # per-client pinned (provider, zone) placement, or None for
        # policy-driven placement; populations are never pinned
        self.pinned = pinned if pinned is not None else [None] * n

    # ------------------------------------------------------------------
    @classmethod
    def from_population(cls, pop: PopulationConfig) -> "ClientArrays":
        """Expand a `PopulationConfig` into arrays: per-client warm
        epoch times are lognormal around `mean_epoch_s` with
        cross-client sigma `epoch_sigma`, drawn from the population's
        own seed (reproducible independent of the run seed)."""
        n = pop.n_clients
        rng = np.random.RandomState(pop.seed)
        warm = pop.mean_epoch_s * np.exp(rng.randn(n) * pop.epoch_sigma)
        return cls(
            n, warm,
            np.full(n, pop.cold_multiplier),
            np.full(n, pop.jitter),
            np.full(n, pop.budget),
            np.zeros(n, dtype=np.int64),
            name_prefix=pop.name_prefix)

    @classmethod
    def from_profiles(cls, profiles: Sequence[ClientProfile]
                      ) -> "ClientArrays":
        """Arrays from explicit per-client profiles (the cross-silo
        spelling); pinned zones are preserved per client."""
        n = len(profiles)
        return cls(
            n,
            np.array([p.mean_epoch_s for p in profiles], dtype=np.float64),
            np.array([p.cold_multiplier for p in profiles]),
            np.array([p.jitter for p in profiles]),
            np.array([p.budget for p in profiles]),
            np.array([p.join_round for p in profiles], dtype=np.int64),
            explicit_names=[p.name for p in profiles],
            pinned=[None if p.zone is None else (p.provider, p.zone)
                    for p in profiles])

    # ------------------------------------------------------------------
    def name(self, i: int) -> str:
        """The i-th client's name."""
        if self._names is not None:
            return self._names[i]
        return f"{self._prefix}{i}"

    def names(self) -> List[str]:
        """All client names (materializes the lazy population names)."""
        if self._names is None:
            self._names = [f"{self._prefix}{i}" for i in range(self.n)]
        return self._names


class FleetState:
    """Instance lifecycle + billing state for a whole fleet, one slot
    per client (the sync barrier's invariant: at most one tracked
    instance per client; a replacement reuses the slot).

    All mutating operations take index arrays and run as batched numpy
    ops, grouped per zone only where billing rules differ. Settled
    dollars accumulate per client (`settled`) and per step/zone
    (`flush_step` drains the per-step aggregates that become one
    `FleetStepSummary` event).
    """

    def __init__(self, n: int, market: SpotMarket, on_demand: bool):
        self.n = n
        self.market = market
        self.on_demand = on_demand
        # zone table: stable index per (provider, zone) in market order
        self.zone_table: List[Tuple[str, str]] = [
            (z.provider, z.name) for z in market.zones]
        self.zone_index: Dict[Tuple[str, str], int] = {
            pz: i for i, pz in enumerate(self.zone_table)}
        provs = [market.provider_of(p) for p, _ in self.zone_table]
        self._min_billing = np.array(
            [0.0 if on_demand else p.min_billing_s for p in provs])
        self._granularity = np.array(
            [p.billing_granularity_s for p in provs])
        self._placements = [_Placement(p, z) for p, z in self.zone_table]

        self.status = np.zeros(n, dtype=np.int8)
        self.zone_idx = np.zeros(n, dtype=np.int64)
        self.t_request = np.full(n, np.nan)
        self.t_ready = np.full(n, np.nan)
        self.billing_from = np.full(n, np.nan)
        self.preempt_at = np.full(n, np.inf)
        self.fresh = np.ones(n, dtype=bool)
        self.settled = np.zeros(n)

        # lifetime counters + per-step aggregates (drained per summary)
        self.n_spinups = 0
        self.n_preemptions = 0
        self.n_terminations = 0
        self._step_cost = 0.0
        self._step_by_zone: Dict[int, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        # per-slot dollars settled since the last flush — the payload of
        # FleetStepSummary.client_cost_delta (dense array + touched mask
        # so `settle` stays a pure numpy scatter, no per-client loop)
        self._step_settled = np.zeros(n)
        self._step_touched = np.zeros(n, dtype=bool)

    # ------------------------------------------------------------------
    # Lifecycle transitions.
    # ------------------------------------------------------------------
    def request(self, idx: np.ndarray, zone_ids: np.ndarray,
                t_request: np.ndarray, spin_delays: np.ndarray
                ) -> np.ndarray:
        """Open fresh instance slots: SPINNING from `t_request`, ready
        after `spin_delays`. Returns the ready times."""
        ready = t_request + spin_delays
        self.status[idx] = SPINNING
        self.zone_idx[idx] = zone_ids
        self.t_request[idx] = t_request
        self.t_ready[idx] = ready
        self.billing_from[idx] = np.nan
        self.preempt_at[idx] = np.inf
        self.fresh[idx] = True
        self.n_spinups += len(idx)
        for z, cnt in zip(*np.unique(zone_ids, return_counts=True)):
            self._step_by_zone[int(z)]["spinups"] += int(cnt)
        return ready

    def activate(self, idx: np.ndarray, model, rng,
                 step_t: float) -> None:
        """SPINNING -> RUNNING at each slot's own ready time: billing
        opens at `t_ready`, and — spot fleets — the vectorized
        preemption model draws each instance's reclaim delay in one
        batch, anchored at the step time (per-step hazard batching;
        delays are measured from each instance's ready instant)."""
        self.status[idx] = RUNNING
        self.billing_from[idx] = self.t_ready[idx]
        if self.on_demand or model is None:
            return
        delays = np.full(len(idx), np.inf)
        for z in np.unique(self.zone_idx[idx]):
            sel = self.zone_idx[idx] == z
            insts = [self._placements[int(z)]] * int(sel.sum())
            delays[sel] = model.next_preemption_delays(insts, step_t, rng)
        self.preempt_at[idx] = self.t_ready[idx] + delays

    def settle(self, idx: np.ndarray, t_end: np.ndarray) -> np.ndarray:
        """Close the open billing segments of `idx` at aligned times
        `t_end`: min-billing floor (spot) + granularity rounding per
        provider, then one `cost_batch` per distinct zone. Returns the
        per-slot amounts (0 where no segment was open) and folds them
        into the per-client and per-step accumulators."""
        amounts = np.zeros(len(idx))
        t0 = self.billing_from[idx]
        open_mask = ~np.isnan(t0)
        if not open_mask.any():
            return amounts
        for z in np.unique(self.zone_idx[idx][open_mask]):
            sel = open_mask & (self.zone_idx[idx] == z)
            a = np.asarray(t0[sel])
            billed = np.maximum(t_end[sel] - a, self._min_billing[z])
            g = self._granularity[z]
            if g > 1.0:
                billed = np.ceil(billed / g - 1e-12) * g
            prov, zname = self.zone_table[int(z)]
            amt = self.market.cost_batch(zname, a, a + billed,
                                         self.on_demand, provider=prov)
            amounts[sel] = amt
            tot = float(amt.sum())
            self._step_cost += tot
            self._step_by_zone[int(z)]["cost"] += tot
        self.settled[idx] += amounts
        self._step_settled[idx] += amounts
        self._step_touched[idx[amounts != 0.0]] = True
        self.billing_from[idx] = np.nan
        return amounts

    def terminate(self, idx: np.ndarray, t_end: np.ndarray) -> None:
        """Deliberate stop at aligned times `t_end`: RUNNING slots
        settle their open segment; SPINNING slots just close (a spin-up
        terminated before ready never billed). Slots become ABSENT."""
        if len(idx) == 0:
            return
        self.settle(idx, t_end)
        running = self.status[idx] == RUNNING
        self.n_terminations += int(running.sum())
        for z, cnt in zip(*np.unique(self.zone_idx[idx][running],
                                     return_counts=True)):
            self._step_by_zone[int(z)]["terminations"] += int(cnt)
        self.status[idx] = ABSENT
        self.preempt_at[idx] = np.inf

    def preempt(self, idx: np.ndarray, t_end: np.ndarray) -> None:
        """Spot reclaim at aligned times `t_end` (callers pass each
        slot's own `preempt_at`): settle + count + close the slot."""
        if len(idx) == 0:
            return
        self.settle(idx, t_end)
        self.n_preemptions += len(idx)
        for z, cnt in zip(*np.unique(self.zone_idx[idx],
                                     return_counts=True)):
            self._step_by_zone[int(z)]["preemptions"] += int(cnt)
        self.status[idx] = ABSENT
        self.preempt_at[idx] = np.inf

    # ------------------------------------------------------------------
    # Queries.
    # ------------------------------------------------------------------
    def open_cost(self, now: float,
                  idx: Optional[np.ndarray] = None) -> np.ndarray:
        """Accrued-but-unsettled dollars of each slot's open billing
        segment at `now` (0 where closed); `idx=None` means the whole
        fleet. One `cost_batch` per distinct zone."""
        if idx is None:
            idx = np.arange(self.n)
        out = np.zeros(len(idx))
        t0 = self.billing_from[idx]
        open_mask = ~np.isnan(t0)
        if not open_mask.any():
            return out
        for z in np.unique(self.zone_idx[idx][open_mask]):
            sel = open_mask & (self.zone_idx[idx] == z)
            a = np.asarray(t0[sel])
            prov, zname = self.zone_table[int(z)]
            out[sel] = self.market.cost_batch(
                zname, a, np.full(len(a), now), self.on_demand,
                provider=prov)
        return out

    def flush_step(self) -> Tuple[float, Dict[str, Dict[str, float]],
                                  np.ndarray, np.ndarray]:
        """Drain the per-step aggregates: (dollars settled since the
        last flush, per-"provider/zone" breakdown, slot indices that
        settled nonzero dollars this step, their aligned amounts) — the
        payload of one `FleetStepSummary` event. The amounts sum to the
        first element (the step's `cost_delta`)."""
        by_zone = {f"{self.zone_table[z][0]}/{self.zone_table[z][1]}":
                   dict(aggs) for z, aggs in self._step_by_zone.items()}
        cost = self._step_cost
        touched = np.nonzero(self._step_touched)[0]
        amounts = self._step_settled[touched].copy()
        self._step_settled[touched] = 0.0
        self._step_touched[touched] = False
        self._step_cost = 0.0
        self._step_by_zone = defaultdict(lambda: defaultdict(float))
        return cost, by_zone, touched, amounts

    def resolve_zone(self, provider: Optional[str], zone: str) -> int:
        """Zone-table index of a pinned placement (provider resolved
        like `SpotMarket.resolve_provider`)."""
        prov = self.market.resolve_provider(zone, provider)
        return self.zone_index[(prov, zone)]
