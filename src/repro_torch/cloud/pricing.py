"""Provider-agnostic spot / on-demand market across providers, regions
and availability zones.

The paper (§III-A "Dynamic Resource Allocation") queries real-time spot
prices across regions/zones and picks the cheapest. The pricing surface
is layered so both synthetic and real market days plug in behind one
interface:

  PriceSource   — `price(t)` / `integral(t0, t1)` for one zone's spot
                  price process. Two implementations:
                    SyntheticOUSource  — the calibrated OU-like process
                                         (paper Table I rates)
                    TracePriceSource   — piecewise-constant real price
                                         history (AWS spot-history
                                         format, loaded by cloud.traces)
                  Both answer integrals in O(1) off prefix sums — the
                  billing hot path prices an open segment on every cost
                  query.
  Provider      — per-provider billing semantics: on-demand rate,
                  billing granularity, min-billing floor, preemption
                  notice.
  Zone          — (provider, region, zone) placement target.
  SpotMarket    — owns every provider's sources and arbitrates
                  `cheapest_zone` across providers with deterministic
                  tie-breaking (lowest price, then registration order).

`PriceBook(cfg, seed)` survives as a constructor alias for the default
single-provider synthetic market; it builds the exact same traces as the
pre-redesign class, so seeded runs are bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, Iterable, List, Optional, Protocol, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.comms.billing import TransferRates
from repro_torch.common.config import CloudConfig, MarketConfig, ProviderConfig

DEFAULT_PROVIDER = "aws"


@dataclasses.dataclass(frozen=True)
class StorageRates:
    """Object-storage pricing of one provider: what a warning-window
    checkpoint write costs (S3-style flat PUT request + per-MB egress
    of the model state). Zero by default, so checkpoint writes stay
    free — and every pre-redesign total unchanged — until a market
    opts in."""
    put_usd: float = 0.0               # $ per PUT request
    egress_usd_per_mb: float = 0.0     # $ per MB written out

    def checkpoint_cost(self, size_mb: float) -> float:
        """Dollars one checkpoint write of `size_mb` MB costs."""
        return self.put_usd + self.egress_usd_per_mb * max(size_mb, 0.0)


@dataclasses.dataclass(frozen=True)
class Provider:
    """Billing semantics of one cloud provider (formerly CloudConfig
    globals, now carried per provider so markets can mix them)."""
    name: str
    on_demand_rate: float              # $/hr
    billing_granularity_s: float = 1.0  # round billed duration up to this
    min_billing_s: float = 60.0         # spot min-billing floor (seconds)
    preemption_notice_s: float = 0.0    # reclaim warning lead time
    # hazard-vs-price slope under the price-coupled preemption model
    # (repro_torch.cloud.preemption.PriceCoupledModel); 0 keeps this
    # provider's reclaim rate flat even when the market spikes
    preemption_price_sensitivity: float = 1.0
    # object-storage rates billed per warning-window checkpoint write
    storage: StorageRates = StorageRates()
    # client-update egress rates (repro_torch.comms.billing); zero default
    # keeps transfer billing opt-in and pre-comms totals unchanged
    transfer: TransferRates = TransferRates()
    # uplink bandwidth for client-update uploads (Mbit/s); <= 0 means
    # unmodeled (instantaneous). Zone pairs override the base rate.
    uplink_mbps: float = 0.0
    zone_uplink_mbps: Tuple[Tuple[str, float], ...] = ()

    @classmethod
    def from_cloud_config(cls, cfg: CloudConfig,
                          name: str = DEFAULT_PROVIDER) -> "Provider":
        """Build the single default provider a legacy scalar
        `CloudConfig` (no explicit `MarketConfig`) describes."""
        return cls(name, on_demand_rate=cfg.on_demand_rate,
                   billing_granularity_s=cfg.billing_granularity_s,
                   min_billing_s=cfg.min_billing_s,
                   preemption_price_sensitivity=(
                       cfg.preemption_price_sensitivity))

    @classmethod
    def from_provider_config(cls, pc: ProviderConfig) -> "Provider":
        """Lift one `MarketConfig` provider entry into the runtime
        descriptor every billing/preemption decision reads."""
        return cls(pc.name, on_demand_rate=pc.on_demand_rate,
                   billing_granularity_s=pc.billing_granularity_s,
                   min_billing_s=pc.min_billing_s,
                   preemption_notice_s=pc.preemption_notice_s,
                   preemption_price_sensitivity=(
                       pc.preemption_price_sensitivity),
                   storage=StorageRates(
                       pc.storage_put_usd,
                       pc.storage_egress_usd_per_mb),
                   transfer=TransferRates(pc.update_egress_usd_per_mb),
                   uplink_mbps=pc.uplink_mbps,
                   zone_uplink_mbps=tuple(pc.zone_uplink_mbps))


@dataclasses.dataclass(frozen=True)
class Zone:
    """A placement target: (provider, region, availability zone)."""
    name: str                       # e.g. "us-east-1a"
    region: str                     # e.g. "us-east-1"
    provider: str = DEFAULT_PROVIDER


class PriceSource(Protocol):
    """One zone's spot price process."""

    def price(self, t: float) -> float:
        """Spot price ($/hr) in force at time `t`."""
        ...

    def integral(self, t0: float, t1: float) -> float:
        """Integral of price over [t0, t1] in $·s/hr (divide by 3600
        for dollars)."""
        ...


class SyntheticOUSource:
    """Piecewise-constant mean-reverting price process for one zone.

    AWS publishes spot price updates at irregular intervals (minutes to
    hours); we model hourly steps of an OU-like process clipped to
    [0.25, 1.0] x on-demand.
    """

    def __init__(self, mean: float, sigma: float, on_demand: float,
                 seed: int, step_s: float = 3600.0, horizon_s: float = 7 * 86400.0,
                 reversion: float = 0.2):
        rng = np.random.RandomState(seed)
        n = int(horizon_s / step_s) + 2
        prices = np.empty(n)
        p = mean + rng.randn() * sigma
        for i in range(n):
            prices[i] = np.clip(p, 0.25 * on_demand, 1.0 * on_demand)
            p = p + reversion * (mean - p) + rng.randn() * sigma
        self._step = step_s
        self._prices = prices
        # prefix sums: _cum[i] = integral over the first i full steps,
        # making `integral` O(1) instead of O(steps spanned) — it sits on
        # the billing hot path (every cost query prices an open segment).
        self._cum = np.concatenate([[0.0], np.cumsum(prices) * step_s])

    def price(self, t: float) -> float:
        """Price of the hourly step containing `t` (last step extends
        beyond the horizon)."""
        i = min(int(t / self._step), len(self._prices) - 1)
        return float(self._prices[i])

    def _antiderivative(self, t: float) -> float:
        """Integral of the trace over [0, t]; beyond the horizon the last
        step's price extends (matching `price`'s clamped lookup)."""
        i = min(int(t / self._step), len(self._prices) - 1)
        return float(self._cum[i]
                     + self._prices[i] * (t - i * self._step))

    def integral(self, t0: float, t1: float) -> float:
        """Integral of the price over [t0, t1] in $·s/hr, O(1)."""
        if t1 <= t0:
            return 0.0
        return self._antiderivative(t1) - self._antiderivative(t0)

    def _antiderivative_batch(self, t: np.ndarray) -> np.ndarray:
        """Vectorized `_antiderivative` over an array of times — the
        fleet core settles thousands of billing segments per step, and
        one scalar Python call per instance would dominate the whole
        simulation."""
        i = np.minimum((t / self._step).astype(np.int64),
                       len(self._prices) - 1)
        return self._cum[i] + self._prices[i] * (t - i * self._step)

    def integral_batch(self, t0: np.ndarray, t1: np.ndarray) -> np.ndarray:
        """Elementwise `integral` over aligned time arrays ($·s/hr)."""
        t0 = np.asarray(t0, dtype=np.float64)
        t1 = np.asarray(t1, dtype=np.float64)
        out = self._antiderivative_batch(t1) - self._antiderivative_batch(t0)
        return np.where(t1 <= t0, 0.0, out)

    def prices_at(self, t: np.ndarray) -> np.ndarray:
        """Vectorized `price` lookup (per-step hazard batching)."""
        i = np.minimum((np.asarray(t, dtype=np.float64)
                        / self._step).astype(np.int64),
                       len(self._prices) - 1)
        return self._prices[i]


# backwards-compatible name for the synthetic process
SpotPriceTrace = SyntheticOUSource


class TracePriceSource:
    """Piecewise-constant price history at *irregular* update times —
    the shape of real `describe-spot-price-history` output.

    `times` are seconds (ascending, relative to the market epoch) at
    which the price changed; `prices[i]` holds on [times[i],
    times[i+1]). Outside the recorded horizon the trace clamps: before
    `times[0]` the first price applies, after the last update the final
    price extends indefinitely (mirroring the synthetic source's clamped
    lookup). Integrals are O(log n): prefix sums over the irregular
    segments plus a binary search for the containing segment.
    """

    def __init__(self, times: Sequence[float], prices: Sequence[float]):
        t = np.asarray(times, dtype=np.float64)
        p = np.asarray(prices, dtype=np.float64)
        if t.ndim != 1 or t.shape != p.shape or len(t) == 0:
            raise ValueError("times/prices must be equal-length 1-D, "
                             "non-empty")
        if np.any(np.diff(t) < 0):
            raise ValueError("times must be ascending")
        if np.any(p < 0):
            raise ValueError("negative price in trace")
        self._times = t
        self._prices = p
        # _cum[i] = integral from times[0] up to times[i]
        widths = np.diff(t)
        self._cum = np.concatenate([[0.0],
                                    np.cumsum(self._prices[:-1] * widths)])

    def _index(self, t: float) -> int:
        i = int(np.searchsorted(self._times, t, side="right")) - 1
        return min(max(i, 0), len(self._times) - 1)

    def price(self, t: float) -> float:
        """Price of the recorded segment containing `t` (clamped
        outside the horizon)."""
        return float(self._prices[self._index(t)])

    def _antiderivative(self, t: float) -> float:
        """Integral over [times[0], t]; clamped below times[0]."""
        if t <= self._times[0]:
            # pre-horizon: first price extends backwards
            return float(self._prices[0] * (t - self._times[0]))
        i = self._index(t)
        return float(self._cum[i]
                     + self._prices[i] * (t - self._times[i]))

    def integral(self, t0: float, t1: float) -> float:
        """Integral of the price over [t0, t1] in $·s/hr, O(log n)."""
        if t1 <= t0:
            return 0.0
        return self._antiderivative(t1) - self._antiderivative(t0)

    def _antiderivative_batch(self, t: np.ndarray) -> np.ndarray:
        """Vectorized `_antiderivative`: one `searchsorted` over the
        whole batch instead of a Python call per billing segment."""
        i = np.clip(np.searchsorted(self._times, t, side="right") - 1,
                    0, len(self._times) - 1)
        out = self._cum[i] + self._prices[i] * (t - self._times[i])
        # pre-horizon clamp: the first price extends backwards
        pre = t <= self._times[0]
        return np.where(pre, self._prices[0] * (t - self._times[0]), out)

    def integral_batch(self, t0: np.ndarray, t1: np.ndarray) -> np.ndarray:
        """Elementwise `integral` over aligned time arrays ($·s/hr)."""
        t0 = np.asarray(t0, dtype=np.float64)
        t1 = np.asarray(t1, dtype=np.float64)
        out = self._antiderivative_batch(t1) - self._antiderivative_batch(t0)
        return np.where(t1 <= t0, 0.0, out)

    def prices_at(self, t: np.ndarray) -> np.ndarray:
        """Vectorized `price` lookup (per-step hazard batching)."""
        i = np.clip(np.searchsorted(self._times,
                                    np.asarray(t, dtype=np.float64),
                                    side="right") - 1,
                    0, len(self._times) - 1)
        return self._prices[i]

    @property
    def horizon(self) -> Tuple[float, float]:
        """(first, last) recorded update times of the trace."""
        return float(self._times[0]), float(self._times[-1])


# ---------------------------------------------------------------------------
# The market facade.
# ---------------------------------------------------------------------------
_REGIONS = ("us-east-1", "us-east-2", "us-west-2", "eu-west-1")


class SpotMarket:
    """All providers' zones, prices and billing semantics; cross-provider
    cheapest-zone arbitration.

    Zone registration order is the arbitration tie-break: `cheapest_zone`
    scans zones in registration order and keeps the strictly cheapest,
    so equal prices resolve to the first-registered zone (provider
    config order, then zone index). That rule is deterministic across
    runs and preserves the pre-redesign single-provider behavior
    exactly.
    """

    def __init__(self, providers: Optional[Iterable[Provider]] = None):
        self.providers: Dict[str, Provider] = {}
        self.zones: List[Zone] = []
        self._sources: Dict[Tuple[str, str], PriceSource] = {}
        self._zone_owner: Dict[str, str] = {}   # zone name -> first owner
        # recorded real interruption timestamps per (provider, zone),
        # seconds on the market clock, ascending — consumed by the
        # replay preemption model (repro_torch.cloud.preemption)
        self.interruptions: Dict[Tuple[str, str], Tuple[float, ...]] = {}
        for p in providers or ():
            self.add_provider(p)

    # ------------------------------------------------------------------
    # Construction.
    # ------------------------------------------------------------------
    def add_provider(self, provider: Provider) -> Provider:
        """Register a provider; the first registered one is the
        market's default. Duplicate names raise."""
        if provider.name in self.providers:
            raise ValueError(f"provider {provider.name!r} already "
                             f"registered")
        self.providers[provider.name] = provider
        return provider

    def add_zone(self, zone: Zone, source: PriceSource) -> Zone:
        """Register a zone and its price source under an
        already-registered provider; registration order is the
        cheapest-zone tie-break order."""
        if zone.provider not in self.providers:
            raise ValueError(f"unknown provider {zone.provider!r} for "
                             f"zone {zone.name!r}")
        key = (zone.provider, zone.name)
        if key in self._sources:
            raise ValueError(f"zone {key} already registered")
        self.zones.append(zone)
        self._sources[key] = source
        self._zone_owner.setdefault(zone.name, zone.provider)
        return zone

    def add_interruptions(self, provider: str, zone: str,
                          times: Sequence[float]) -> None:
        """Attach recorded interruption timestamps (market-clock
        seconds, any order) to one provider's zone for the replay
        preemption model."""
        if provider not in self.providers:
            raise ValueError(f"unknown provider {provider!r}")
        self.interruptions[(provider, zone)] = tuple(sorted(times))

    def replace_source(self, zone: str, source: PriceSource,
                       provider: Optional[str] = None) -> None:
        """Swap an already-registered zone's price source in place
        (registration order, and therefore cheapest-zone tie-breaking,
        is unchanged). The scenario generators (`cloud.scenarios`)
        reshape markets through this hook."""
        key = (self.resolve_provider(zone, provider), zone)
        if key not in self._sources:
            raise ValueError(f"zone {key} not registered")
        self._sources[key] = source

    @property
    def default_provider(self) -> str:
        """Name of the first-registered provider."""
        return next(iter(self.providers))

    @classmethod
    def synthetic(cls, cfg: CloudConfig, seed: int = 0) -> "SpotMarket":
        """The default single-provider market: bit-identical traces to
        the pre-redesign `PriceBook(cfg, seed)`."""
        m = cls([Provider.from_cloud_config(cfg)])
        m._add_synthetic_zones(m.providers[DEFAULT_PROVIDER],
                               cfg.spot_rate_mean, cfg.spot_rate_sigma,
                               cfg.on_demand_rate, cfg.n_zones,
                               _REGIONS, seed)
        return m

    def _add_synthetic_zones(self, provider: Provider, mean: float,
                             sigma: float, on_demand: float, n_zones: int,
                             regions: Sequence[str], seed: int):
        for i in range(n_zones):
            region = regions[i % len(regions)]
            z = Zone(f"{region}{chr(ord('a') + i // len(regions))}",
                     region, provider.name)
            # zone-specific mean wiggle so zones genuinely differ
            zmean = mean * (1.0 + 0.02 * ((i % 3) - 1))
            self.add_zone(z, SyntheticOUSource(zmean, sigma, on_demand,
                                               seed=seed + i))

    @classmethod
    def from_market_config(cls, mcfg: MarketConfig,
                           seed: int = 0) -> "SpotMarket":
        """Build a (possibly multi-provider) market. Providers with a
        `price_trace` path get trace-driven zones (cloud.traces); the
        rest synthesize OU zones off a provider-indexed seed. Providers
        with an `interruption_trace` additionally register recorded
        interruption timestamps for the replay preemption model, on the
        same market clock as the price histories."""
        from repro_torch.cloud.traces import (build_interruption_schedule,
                                        build_zone_sources,
                                        parse_interruption_file,
                                        parse_price_file)
        m = cls()
        # parse each history file once; every trace-driven provider then
        # shares one market epoch so their histories stay aligned on the
        # simulated clock
        parsed = {pc.name: parse_price_file(pc.price_trace)
                  for pc in mcfg.providers if pc.price_trace is not None}
        interruptions = {pc.name: parse_interruption_file(
                             pc.interruption_trace)
                         for pc in mcfg.providers
                         if pc.interruption_trace is not None}
        stamps = ([r.timestamp for recs in parsed.values() for r in recs]
                  or [r.timestamp for recs in interruptions.values()
                      for r in recs])
        epoch = min(stamps) if stamps else None
        for pi, pc in enumerate(mcfg.providers):
            prov = m.add_provider(Provider.from_provider_config(pc))
            if pc.price_trace is not None:
                for zone, source in build_zone_sources(
                        parsed[pc.name], provider=pc.name, epoch=epoch):
                    m.add_zone(zone, source)
            else:
                m._add_synthetic_zones(
                    prov, pc.spot_rate_mean, pc.spot_rate_sigma,
                    pc.on_demand_rate, pc.n_zones, pc.regions,
                    seed + 1000 * pi)
            if pc.name in interruptions:
                for zone_name, times in build_interruption_schedule(
                        interruptions[pc.name], epoch=epoch).items():
                    m.add_interruptions(pc.name, zone_name, times)
        if mcfg.scenario is not None:
            # lazy import: scenarios build on this module's sources
            from repro_torch.cloud.scenarios import apply_scenario
            apply_scenario(m, mcfg.scenario)
        return m

    @classmethod
    def for_cloud_config(cls, cfg: CloudConfig,
                         seed: int = 0) -> "SpotMarket":
        """The market a `CloudConfig` describes: its explicit
        `MarketConfig` when set, else the legacy scalar fields as a
        single synthetic provider."""
        if cfg.market is not None:
            return cls.from_market_config(cfg.market, seed=seed)
        return cls.synthetic(cfg, seed=seed)

    # ------------------------------------------------------------------
    # Lookups.
    # ------------------------------------------------------------------
    def provider_of(self, name: Optional[str]) -> Provider:
        """The named provider's descriptor (None -> the default)."""
        return self.providers[name or self.default_provider]

    def resolve_provider(self, zone: Optional[str] = None,
                         provider: Optional[str] = None) -> str:
        """Which provider a lookup means: the explicit `provider` when
        given, else the (first-registered) owner of `zone`, else the
        default provider — so a pinned zone name alone is enough to
        reach the right provider's prices and billing rules."""
        if provider is not None:
            return provider
        if zone is not None and zone in self._zone_owner:
            return self._zone_owner[zone]
        return self.default_provider

    def source(self, zone: str,
               provider: Optional[str] = None) -> PriceSource:
        """The zone's price source (provider resolved per
        `resolve_provider`)."""
        return self._sources[(self.resolve_provider(zone, provider),
                              zone)]

    def spot_price(self, zone: str, t: float,
                   provider: Optional[str] = None) -> float:
        """Spot price ($/hr) of a zone at time `t`."""
        return self.source(zone, provider).price(t)

    def on_demand_price(self, zone: str, t: float,
                        provider: Optional[str] = None) -> float:
        """On-demand rate ($/hr) of the zone's provider (flat in t)."""
        return self.provider_of(
            self.resolve_provider(zone, provider)).on_demand_rate

    def price(self, zone: str, t: float, on_demand: bool,
              provider: Optional[str] = None) -> float:
        """`on_demand_price` or `spot_price`, by market kind."""
        return (self.on_demand_price(zone, t, provider) if on_demand
                else self.spot_price(zone, t, provider))

    def cheapest_zone(self, t: float,
                      allowed: Optional[List[str]] = None,
                      providers: Optional[Sequence[str]] = None,
                      ) -> Tuple[Zone, float]:
        """Cheapest spot placement at `t` across `providers` (default:
        every registered provider), optionally restricted to `allowed`
        zone names. Ties break to the first-registered zone."""
        best: Optional[Zone] = None
        best_p = float("inf")
        for z in self.zones:
            if providers is not None and z.provider not in providers:
                continue
            if allowed is not None and z.name not in allowed:
                continue
            p = self.spot_price(z.name, t, z.provider)
            if p < best_p:                  # strict: first-lowest wins
                best, best_p = z, p
        if best is None:
            raise ValueError("no zone matches the placement constraints")
        return best, best_p

    def cost(self, zone: str, t0: float, t1: float, on_demand: bool,
             provider: Optional[str] = None) -> float:
        """Dollars accrued over [t0, t1] (per-second billing)."""
        if on_demand:
            rate = self.on_demand_price(zone, t0, provider)
            return rate * max(t1 - t0, 0.0) / 3600.0
        return self.source(zone, provider).integral(t0, t1) / 3600.0

    def cost_batch(self, zone: str, t0s: np.ndarray, t1s: np.ndarray,
                   on_demand: bool,
                   provider: Optional[str] = None) -> np.ndarray:
        """Vectorized `cost` over aligned segment arrays for one zone —
        the fleet core settles a whole step's billing segments with two
        prefix-sum lookups instead of a Python call per instance. Falls
        back to a scalar loop for custom `PriceSource` implementations
        without `integral_batch`."""
        t0s = np.asarray(t0s, dtype=np.float64)
        t1s = np.asarray(t1s, dtype=np.float64)
        if on_demand:
            rate = self.on_demand_price(zone, 0.0, provider)
            return rate * np.maximum(t1s - t0s, 0.0) / 3600.0
        src = self.source(zone, provider)
        batch = getattr(src, "integral_batch", None)
        if batch is not None:
            return batch(t0s, t1s) / 3600.0
        return np.array([src.integral(a, b) / 3600.0
                         for a, b in zip(t0s, t1s)])

    def mean_spot_price(self, zone: str,
                        provider: Optional[str] = None) -> float:
        """Time-averaged spot price of a zone over its recorded horizon
        (trace sources) or the synthetic 7-day horizon — the reference
        level the price-coupled preemption model measures spikes
        against."""
        src = self.source(zone, provider)
        horizon = getattr(src, "horizon", None)
        if horizon is not None and horizon[1] > horizon[0]:
            t0, t1 = horizon
        else:
            t0, t1 = 0.0, 7 * 86400.0
        mean = src.integral(t0, t1) / (t1 - t0)
        return mean if mean > 0.0 else src.price(t0)


def PriceBook(cfg: CloudConfig, seed: int = 0) -> SpotMarket:
    """Pre-redesign constructor: the single-provider synthetic market."""
    return SpotMarket.synthetic(cfg, seed=seed)
