"""The tenant-observable market surface forecasters learn from.

A real spot tenant sees exactly two things: the published price
history of the zones it runs in, and the reclaims (plus provider
notices) that hit its own instances. `ObservableFeed` packages those
two signals — and nothing else — behind one object:

  * it subscribes to `InstancePreempted` / `InstancePreemptionWarning`
    on the run's bus and forwards spot reclaim observations to every
    attached observer (forecasters, calibration trackers);
  * `sample_price` reads a zone's current spot price through the
    market callables and forwards the sample, deduplicated per
    (provider, zone, time) so co-located clients polling in the same
    tick don't double-count market exposure;
  * `price_derived_hazard` reproduces the price-coupled hazard
    formula (`repro_torch.cloud.preemption.PriceCoupledModel`) from the
    observable quantities alone — the estimate the runner's replay
    fallback (`fl.runner._observable_hazard_of`) now routes through,
    making "oracle" vs "observable" an explicit property of every
    recorded trace instead of a silent substitution.

Layering: depends on `core.events` and the stdlib only. Market access
arrives as plain callables (`for_market` builds them over any
duck-typed market object without importing `cloud.*`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.events import (EventBus, InstancePreempted,
                               InstancePreemptionWarning)


class ObservableFeed:
    """Subscription hub for tenant-observable market signals.

    `spot_price_of(provider, zone, t)` and
    `mean_price_of(provider, zone)` read the published price surface;
    `sensitivity_of(provider)` is the provider's advertised
    hazard-vs-price slope (`preemption_price_sensitivity`) and
    `base_rate_per_hr` the tenant's prior reclaim rate — the same two
    knobs a real scheduler calibrates its interruption estimate with.
    """

    def __init__(self,
                 spot_price_of: Callable[[str, str, float], float],
                 mean_price_of: Callable[[str, str], float],
                 sensitivity_of: Callable[[str], float],
                 base_rate_per_hr: float = 0.0,
                 bus: Optional[EventBus] = None):
        self.spot_price_of = spot_price_of
        self.mean_price_of = mean_price_of
        self.sensitivity_of = sensitivity_of
        self.base_rate_per_hr = base_rate_per_hr
        self._observers: List[Any] = []
        self._ref_price: Dict[Tuple[str, str], float] = {}
        self._last_sample_t: Dict[Tuple[str, str], float] = {}
        self.n_reclaims_seen = 0
        self.n_warnings_seen = 0
        if bus is not None:
            bus.subscribe(InstancePreempted, self._on_preempted)
            bus.subscribe(InstancePreemptionWarning, self._on_warning)

    @classmethod
    def for_market(cls, market: Any, base_rate_per_hr: float,
                   bus: Optional[EventBus] = None) -> "ObservableFeed":
        """Build a feed over a duck-typed `SpotMarket`-shaped object
        (the composition root passes the live market; tests may pass
        any object with `spot_price` / `mean_spot_price` /
        `provider_of`)."""
        return cls(
            spot_price_of=lambda p, z, t: market.spot_price(z, t, p),
            mean_price_of=lambda p, z: market.mean_spot_price(z, p),
            sensitivity_of=lambda p: (
                market.provider_of(p).preemption_price_sensitivity),
            base_rate_per_hr=base_rate_per_hr, bus=bus)

    # ------------------------------------------------------------------
    # Observer fan-out.
    # ------------------------------------------------------------------
    def attach(self, observer: Any) -> Any:
        """Register an observer; anything with `observe_price(provider,
        zone, t, price)` and/or `observe_reclaim(provider, zone, t)`
        (forecasters, calibration trackers) qualifies."""
        self._observers.append(observer)
        return observer

    def _on_preempted(self, ev: InstancePreempted) -> None:
        """A spot reclaim landed on one of the tenant's instances:
        forward the observation. On-demand terminations never reach
        this handler (the simulator only reclaims spot)."""
        inst = ev.instance
        if getattr(inst, "on_demand", False):
            return
        self.n_reclaims_seen += 1
        for obs in self._observers:
            hook = getattr(obs, "observe_reclaim", None)
            if hook is not None:
                hook(inst.provider, inst.zone, ev.t)

    def _on_warning(self, ev: InstancePreemptionWarning) -> None:
        """A provider reclaim notice arrived; counted for telemetry
        but *not* forwarded as a reclaim — the reclaim itself follows
        and forwarding both would double-count the event."""
        self.n_warnings_seen += 1

    def sample_price(self, provider: str, zone: str, t: float) -> float:
        """Read the zone's spot price at `t` and forward the sample to
        every observer. Repeat samples of the same (provider, zone) at
        a non-advancing time are read but not re-forwarded, so several
        co-located clients polling in one tick count the market
        exposure once."""
        price = self.spot_price_of(provider, zone, t)
        key = (provider, zone)
        last = self._last_sample_t.get(key)
        if last is not None and t <= last:
            return price
        self._last_sample_t[key] = t
        for obs in self._observers:
            hook = getattr(obs, "observe_price", None)
            if hook is not None:
                hook(provider, zone, t, price)
        return price

    # ------------------------------------------------------------------
    # The price-derived hazard estimate (replay-fallback signal).
    # ------------------------------------------------------------------
    def _ref(self, provider: str, zone: str) -> float:
        """Cached per-zone reference (historical mean) price."""
        key = (provider, zone)
        if key not in self._ref_price:
            self._ref_price[key] = self.mean_price_of(provider, zone)
        return self._ref_price[key]

    def price_derived_hazard(self, provider: str, zone: str,
                             t: float) -> float:
        """Instantaneous reclaim-hazard estimate (events/second) from
        the observable price level alone: the price-coupled formula
        `base * max(0, 1 + s * (p/p_ref - 1))` evaluated on published
        prices — numerically identical to
        `PriceCoupledModel.hazard`, but computed without touching the
        model (which, under recorded-interruption replay, does not
        even exist)."""
        base = self.base_rate_per_hr / 3600.0
        if base <= 0.0:
            return 0.0
        s = self.sensitivity_of(provider)
        level = self.spot_price_of(provider, zone, t) / self._ref(
            provider, zone)
        return base * max(1.0 + s * (level - 1.0), 0.0)
