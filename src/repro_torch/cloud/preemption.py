"""Pluggable spot-reclaim models for the cloud simulator.

Real spot markets do not preempt at a flat Poisson rate: interruptions
cluster when demand (and therefore the spot price) spikes, and recorded
market days come with recorded reclaim times. This module makes the
reclaim process a strategy the simulator consults once per spot
instance, behind one small protocol:

  PreemptionModel.next_preemption_delay(inst, now, rng)
      -> seconds until this instance is reclaimed, or None for "never".

  PreemptionModel.next_preemption_delays(insts, now, rng)
      -> float array of delays for a whole batch, np.inf for "never".
         The vectorized path the struct-of-arrays fleet core
         (`repro_torch.cloud.fleet`) uses: one call per simulation step for
         every instance that became RUNNING, instead of one Python
         callback per instance.

Four implementations:

  ConstantRateModel        — the pre-model behavior: exponential
                             inter-arrival at `preemption_rate_per_hr`.
                             Bit-identical to the old inline code (same
                             RNG, same draw, no draw at rate 0), so
                             default runs and golden traces do not move.
  PriceCoupledModel        — non-homogeneous hazard coupled to the
                             zone's current spot price: a price spike in
                             a `TracePriceSource` day drives an
                             interruption burst. Sensitivity is per
                             provider (`Provider.
                             preemption_price_sensitivity`).
  ReplayInterruptionModel  — replays recorded reclaim timestamps
                             (`SpotMarket.interruptions`, loaded from
                             `<provider>.interruptions.csv` files by
                             `repro_torch.cloud.traces`) on the market clock.
  CorrelatedReclaimModel   — a base hazard model composed with the
                             market's recorded interruption schedule:
                             background churn plus scheduled
                             capacity-crunch reclaims that land
                             *correlated* across every zone of the
                             flagged provider (the `capacity_crunch`
                             scenario generator, `cloud.scenarios`).

Every model's batched path (`next_preemption_delays`) consumes the RNG
stream exactly like sequential scalar calls — `rng.random_sample(n)` /
`rng.exponential(scale, n)` draw in instance order — so a seeded run
lands on the same reclaim sequence whether it crosses
`CloudConfig.fleet_threshold` or not. tests/test_fleet.py pins the
draw identity for all models.

`build_preemption_model` resolves `CloudConfig.preemption_model`
("constant" | "price_coupled" | "replay" | "correlated") into an
instance bound to the run's `SpotMarket`.

See docs/markets.md for the trace formats and docs/architecture.md for
where the model sits in the event flow.
"""
from __future__ import annotations

import bisect
from typing import Dict, Optional, Protocol, Tuple

import numpy as np

from repro_torch.cloud.pricing import SpotMarket

MODEL_NAMES = ("constant", "price_coupled", "replay", "correlated")


class PreemptionModel(Protocol):
    """When does the spot market reclaim an instance?"""

    def next_preemption_delay(self, inst, now: float,
                              rng: np.random.RandomState,
                              ) -> Optional[float]:
        """Seconds from `now` until `inst` is reclaimed, or None if it
        never is. Called once when the instance becomes RUNNING; the
        simulator schedules the provider's warning and the reclaim off
        the returned delay. Draws (if any) must come from `rng` so
        seeded runs stay deterministic."""
        ...

    def next_preemption_delays(self, insts, now: float,
                               rng: np.random.RandomState,
                               ) -> np.ndarray:
        """Vectorized form: delays (seconds from `now`) for every
        element of `insts` at once, `np.inf` standing in for the scalar
        API's None. `insts` is a sequence of anything carrying
        `.provider` and `.zone` (live `Instance`s or the fleet core's
        lightweight placement records)."""
        ...


class ConstantRateModel:
    """Flat Poisson reclaims — the paper's §III-D fault model and the
    simulator's historical behavior.

    The delay is a single `rng.exponential` draw with the exact
    arithmetic of the pre-model inline code (and no draw at all when
    the rate is zero), keeping seeded event sequences bit-identical
    across the refactor.
    """

    def __init__(self, rate_per_hr: float):
        self.rate_per_hr = rate_per_hr

    def next_preemption_delay(self, inst, now, rng):
        """One exponential inter-arrival at the configured rate."""
        if self.rate_per_hr <= 0.0:
            return None
        rate = self.rate_per_hr / 3600.0
        return float(rng.exponential(1.0 / rate))

    def next_preemption_delays(self, insts, now, rng):
        """Batched exponential draws. `rng.exponential(scale, size=n)`
        consumes the legacy `RandomState` stream in the same order as n
        sequential scalar draws, so the batch is draw-identical to
        calling `next_preemption_delay` once per instance — the
        equivalence tests pin this."""
        n = len(insts)
        if self.rate_per_hr <= 0.0:
            return np.full(n, np.inf)
        rate = self.rate_per_hr / 3600.0
        return rng.exponential(1.0 / rate, size=n)


class PriceCoupledModel:
    """Reclaim hazard scaled by the zone's current price level.

    The instantaneous hazard is

        lambda(t) = base_rate * max(0, 1 + s * (p(t) / p_ref - 1))

    where `p(t)` is the zone's spot price, `p_ref` its time-averaged
    price over the recorded horizon (`SpotMarket.mean_spot_price`), and
    `s` the owning provider's `preemption_price_sensitivity`. At `s=0`
    this degrades to the constant model's mean behavior; larger `s`
    concentrates interruptions into price spikes (a 2x spike at `s=5`
    multiplies the hazard by 6).

    Sampling discretizes the hazard onto a `step_s` grid: each step
    preempts with probability `1 - exp(-lambda * step)`, which keeps
    the model correct under hazard clamping and arbitrary price shapes.
    The draw itself is a single uniform inverted through the per-step
    failure CDF (`_zone_failure_cdf`) — scalar and batched calls
    therefore consume the RNG stream identically (one uniform per
    instance, in instance order), so a seeded run's reclaim sequence
    does not depend on whether the fleet path batched the draws. The
    pre-fix scalar path thinned step-by-step (one uniform per step),
    which consumed the stream in a different order than the batch;
    distributionally the two are the same.
    """

    def __init__(self, market: SpotMarket, base_rate_per_hr: float,
                 step_s: float = 60.0, horizon_s: float = 14 * 86400.0):
        self.market = market
        self.base_rate_per_hr = base_rate_per_hr
        self.step_s = step_s
        self.horizon_s = horizon_s
        self._ref_price: Dict[Tuple[str, str], float] = {}

    def _ref(self, provider: str, zone: str) -> float:
        """Cached per-zone reference (mean) price."""
        key = (provider, zone)
        if key not in self._ref_price:
            self._ref_price[key] = self.market.mean_spot_price(
                zone, provider)
        return self._ref_price[key]

    def hazard(self, provider: str, zone: str, t: float) -> float:
        """Instantaneous reclaim hazard (events/second) at `t`."""
        base = self.base_rate_per_hr / 3600.0
        if base <= 0.0:
            return 0.0
        s = self.market.provider_of(provider).preemption_price_sensitivity
        ref = self._ref(provider, zone)
        level = self.market.spot_price(zone, t, provider) / ref
        return base * max(1.0 + s * (level - 1.0), 0.0)

    def next_preemption_delay(self, inst, now, rng):
        """One uniform inverted through the zone's failure CDF: the
        first step whose cumulative failure probability exceeds the
        draw fails at its end; a draw beyond the horizon's CDF means
        the instance outlives the horizon (None)."""
        if self.base_rate_per_hr <= 0.0:
            return None
        cdf = self._zone_failure_cdf(inst.provider, inst.zone, now,
                                     self.horizon_s)
        k = int(np.searchsorted(cdf, rng.random_sample(), side="right"))
        if k >= len(cdf):
            return None
        return (k + 1) * self.step_s

    def _zone_failure_cdf(self, provider: str, zone: str, now: float,
                          horizon_s: float) -> np.ndarray:
        """Per-step failure CDF for one zone from `now`: F[k] is the
        probability thinning has fired by the end of step k. Built once
        per (zone, step) and shared by every co-located instance — the
        whole fleet's preemption draws then reduce to one uniform per
        instance plus a `searchsorted`."""
        n_steps = int(horizon_s / self.step_s)
        ts = now + np.arange(n_steps) * self.step_s
        base = self.base_rate_per_hr / 3600.0
        s = self.market.provider_of(provider).preemption_price_sensitivity
        ref = self._ref(provider, zone)
        src = self.market.source(zone, provider)
        prices_at = getattr(src, "prices_at", None)
        if prices_at is not None:
            level = prices_at(ts) / ref
        else:
            level = np.array([self.market.spot_price(zone, float(t),
                                                     provider)
                              for t in ts]) / ref
        lam = base * np.maximum(1.0 + s * (level - 1.0), 0.0)
        p = -np.expm1(-lam * self.step_s)
        return 1.0 - np.cumprod(1.0 - p)

    def next_preemption_delays(self, insts, now, rng,
                               horizon_s: Optional[float] = None):
        """Inverse-CDF sampling over the whole batch: one uniform per
        instance (`rng.random_sample(n)` consumes the RandomState
        stream exactly like n sequential scalar draws, so the batch is
        draw-identical to calling `next_preemption_delay` per instance
        — pinned by tests/test_fleet.py), then one shared CDF +
        `searchsorted` per distinct zone. `horizon_s` overrides the
        model horizon (the fleet may pass round-scale horizons to keep
        the CDF short)."""
        n = len(insts)
        out = np.full(n, np.inf)
        if self.base_rate_per_hr <= 0.0 or n == 0:
            return out
        horizon = self.horizon_s if horizon_s is None else horizon_s
        u = rng.random_sample(n)
        groups: Dict[Tuple[str, str], list] = {}
        for i, inst in enumerate(insts):
            groups.setdefault((inst.provider, inst.zone), []).append(i)
        for (prov, zone), raw in groups.items():
            cdf = self._zone_failure_cdf(prov, zone, now, horizon)
            idx = np.asarray(raw)
            # first step whose CDF exceeds u -> fails at end of step k
            k = np.searchsorted(cdf, u[idx], side="right")
            hit = k < len(cdf)
            out[idx[hit]] = (k[hit] + 1) * self.step_s
        return out


class ReplayInterruptionModel:
    """Recorded real interruption timestamps, on the market clock.

    A reclaim recorded at time T in zone z takes down whatever spot
    instance is running there at T (every co-located instance sees the
    same event, as a real capacity reclaim would). An instance whose
    zone has no recorded interruption after `now` runs until terminated.
    Draws nothing — replayed fault patterns are exactly reproducible.
    """

    def __init__(self, market: SpotMarket):
        self.market = market

    def next_preemption_delay(self, inst, now, rng):
        """First recorded interruption in the instance's zone after
        `now` (strictly — an instance born at the reclaim instant
        survives it)."""
        times = self.market.interruptions.get((inst.provider, inst.zone))
        if not times:
            return None
        i = bisect.bisect_right(times, now)
        if i >= len(times):
            return None
        return times[i] - now

    def next_preemption_delays(self, insts, now, rng):
        """Batched zone lookups: one bisect per distinct zone, the same
        recorded delay fanned out to every co-located instance (as the
        scalar API would return). Draws nothing."""
        out = np.full(len(insts), np.inf)
        cache: Dict[Tuple[str, str], float] = {}
        for i, inst in enumerate(insts):
            key = (inst.provider, inst.zone)
            if key not in cache:
                times = self.market.interruptions.get(key)
                if times:
                    j = bisect.bisect_right(times, now)
                    cache[key] = (times[j] - now if j < len(times)
                                  else np.inf)
                else:
                    cache[key] = np.inf
            out[i] = cache[key]
        return out


class CorrelatedReclaimModel:
    """Scheduled capacity-crunch reclaims on top of a base hazard.

    Real provider-wide capacity crunches reclaim spot instances across
    *every* zone of the squeezed provider at nearly the same instant —
    a correlation no per-zone Poisson process reproduces. This model
    composes a base `PreemptionModel` (independent background churn)
    with the market's recorded interruption schedule
    (`SpotMarket.interruptions`, e.g. the `capacity_crunch` scenario
    generator's correlated reclaim times): an instance falls at
    whichever comes first, the base model's draw or the next scheduled
    reclaim in its zone.

    The schedule lookup draws nothing, so the composition's RNG
    consumption — and therefore the scalar/batch draw identity — is
    exactly the base model's.
    """

    def __init__(self, market: SpotMarket, base: PreemptionModel):
        self.market = market
        self.base = base
        self._sched = ReplayInterruptionModel(market)

    def next_preemption_delay(self, inst, now, rng):
        """min(base draw, next scheduled reclaim), None if neither."""
        delays = [d for d in (self.base.next_preemption_delay(inst, now,
                                                              rng),
                              self._sched.next_preemption_delay(inst, now,
                                                                rng))
                  if d is not None]
        return min(delays) if delays else None

    def next_preemption_delays(self, insts, now, rng):
        """Elementwise min of the base batch and the schedule batch
        (inf stands in for None on both sides)."""
        return np.minimum(
            self.base.next_preemption_delays(insts, now, rng),
            self._sched.next_preemption_delays(insts, now, rng))


def build_preemption_model(cfg, market: SpotMarket) -> PreemptionModel:
    """Resolve `CloudConfig.preemption_model` into a model bound to
    `market`. Unknown names raise `ValueError` listing the registry."""
    name = getattr(cfg, "preemption_model", "constant")
    if name == "constant":
        return ConstantRateModel(cfg.preemption_rate_per_hr)
    if name == "price_coupled":
        return PriceCoupledModel(market, cfg.preemption_rate_per_hr)
    if name == "replay":
        return ReplayInterruptionModel(market)
    if name == "correlated":
        return CorrelatedReclaimModel(
            market, ConstantRateModel(cfg.preemption_rate_per_hr))
    raise ValueError(f"unknown preemption model {name!r}; "
                     f"known: {MODEL_NAMES}")
