"""Adversarial market scenario generators: seeded stress markets.

One spiky fixture trace and two recorded market days are thin coverage
for a scheduler whose claims are statistical — Multi-FedLS shows spot
price and interruption behavior varies sharply across providers,
regions and time. This module turns a built `SpotMarket` into a stress
market by reshaping its zone price sources (piecewise-constant
`TracePriceSource` traces on a seeded step grid) and, where the
scenario calls for it, registering correlated reclaim schedules for
the replay/correlated preemption models. Four generators:

  flash_crash      — step price spikes with exponential decay. Spike
                     onset times are shared across a provider's zones
                     (one market-wide demand shock), amplitudes drawn
                     per zone; `strength` scales spike count and size.
  capacity_crunch  — provider-wide capacity squeezes: during each
                     crunch window the flagged provider's prices rise
                     and *every* one of its zones receives reclaims at
                     nearly the same instants (within `CRUNCH_JITTER_S`
                     of each other — the cross-zone correlation a
                     per-zone Poisson process cannot produce). Other
                     providers see neither. Pair with the "replay" or
                     "correlated" preemption model.
  diurnal          — daily demand cycle (business-hours peak, night
                     trough) plus a weekend discount, per zone with a
                     seeded phase jitter.
  price_inversion  — persistent cross-provider inversions: alternating
                     multi-hour blocks in which the flagged provider
                     prices above the rest, then below — the regime
                     that rewards cross-provider placement and punishes
                     provider-pinned policies. Needs >= 2 providers.

Every generator is a pure function of (market, `ScenarioConfig`): fully
seeded, no global state, so the same config always produces
byte-identical traces and schedules (pinned by tests/test_scenarios.py
down to the recorded event log). Scenarios are applied by
`SpotMarket.from_market_config` when `MarketConfig.scenario` is set, so
any benchmark reaches a stress market by configuration alone; the sweep
harness (`repro_torch.sweep`) fans the same registry out over policies and
seeds.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from repro_torch.common.config import ScenarioConfig
from repro_torch.cloud.pricing import SpotMarket, TracePriceSource

# cross-zone reclaim jitter inside one capacity-crunch hit: every zone
# of the flagged provider falls within this window of the hit time
CRUNCH_JITTER_S = 30.0
# spacing between successive reclaim hits inside one crunch window
CRUNCH_RECLAIM_EVERY_S = 1200.0
# e-folding time of a flash-crash spike's decay
FLASH_DECAY_TAU_S = 1800.0


def _grid(cfg: ScenarioConfig) -> np.ndarray:
    """The scenario's sampling grid: `step_s`-spaced times covering
    [0, horizon_s]."""
    n = max(int(cfg.horizon_s / cfg.step_s), 2)
    return np.arange(n + 1, dtype=np.float64) * cfg.step_s


def _base_prices(market: SpotMarket, provider: str, zone: str,
                 ts: np.ndarray) -> np.ndarray:
    """The zone's current source sampled on the grid (vectorized when
    the source supports it)."""
    src = market.source(zone, provider)
    prices_at = getattr(src, "prices_at", None)
    if prices_at is not None:
        return np.asarray(prices_at(ts), dtype=np.float64)
    return np.array([src.price(float(t)) for t in ts])


def _provider_zones(market: SpotMarket,
                    provider: str) -> List[str]:
    """Zone names of one provider, in registration order."""
    return [z.name for z in market.zones if z.provider == provider]


def _flagged(market: SpotMarket, cfg: ScenarioConfig) -> str:
    """The provider a scenario squeezes: the explicit flag or the
    market's first-registered provider."""
    name = cfg.provider or market.default_provider
    if name not in market.providers:
        raise ValueError(f"scenario provider {name!r} not in market "
                         f"({sorted(market.providers)})")
    return name


# ---------------------------------------------------------------------------
# Generators. Each mutates `market` in place via `replace_source` /
# `add_interruptions` and draws only from its own seeded RandomState.
# ---------------------------------------------------------------------------
def flash_crash(market: SpotMarket, cfg: ScenarioConfig) -> None:
    """Step spikes with exponential decay on every provider's zones.

    Spike onsets are drawn once per provider (zones of one provider
    spike together, as a real demand shock would hit a region-wide
    market); each (spike, zone) pair gets its own amplitude. A spike
    multiplies the base price by `1 + A * exp(-(t - t0) / tau)` from
    its onset step, with A in [1.5, 2.5] * strength.
    """
    ts = _grid(cfg)
    for pi, pname in enumerate(market.providers):
        rng = np.random.RandomState(cfg.seed + 1000 * pi)
        n_spikes = max(1, int(round(3 * cfg.strength)))
        onsets = rng.uniform(0.1, 0.9, size=n_spikes) * cfg.horizon_s
        # snap onsets to the grid so the spike is a clean price step
        onsets = np.floor(onsets / cfg.step_s) * cfg.step_s
        for zone in _provider_zones(market, pname):
            base = _base_prices(market, pname, zone, ts)
            boost = np.zeros_like(ts)
            for t0 in onsets:
                amp = (1.5 + rng.uniform(0.0, 1.0)) * cfg.strength
                live = ts >= t0
                boost[live] += amp * np.exp(-(ts[live] - t0)
                                            / FLASH_DECAY_TAU_S)
            market.replace_source(
                zone, TracePriceSource(ts, base * (1.0 + boost)),
                provider=pname)


def capacity_crunch(market: SpotMarket, cfg: ScenarioConfig) -> None:
    """Provider-wide capacity squeezes with correlated reclaims.

    Crunch windows are drawn once for the flagged provider; inside each
    window its zone prices scale by `1 + 1.5 * strength` and reclaim
    hits land every `CRUNCH_RECLAIM_EVERY_S`, each hit reclaiming every
    zone of the provider within `CRUNCH_JITTER_S` (per-zone jitter is
    seeded). Other providers' prices and schedules are untouched —
    cross-provider placement is the escape hatch the scenario rewards.
    """
    flagged = _flagged(market, cfg)
    rng = np.random.RandomState(cfg.seed)
    ts = _grid(cfg)
    n_windows = max(1, int(round(2 * cfg.strength)))
    starts = np.sort(rng.uniform(0.1, 0.75, size=n_windows)) * cfg.horizon_s
    starts = np.floor(starts / cfg.step_s) * cfg.step_s
    length = 3600.0 * (1.0 + cfg.strength)
    squeeze = 1.0 + 1.5 * cfg.strength
    in_window = np.zeros(len(ts), dtype=bool)
    for t0 in starts:
        in_window |= (ts >= t0) & (ts < t0 + length)
    zones = _provider_zones(market, flagged)
    for zone in zones:
        base = _base_prices(market, flagged, zone, ts)
        market.replace_source(
            zone, TracePriceSource(ts, np.where(in_window, base * squeeze,
                                                base)),
            provider=flagged)
    # reclaim schedule: hits at fixed offsets inside each window, every
    # zone within CRUNCH_JITTER_S of the hit (drawn per zone and hit)
    hits = [float(t0 + k * CRUNCH_RECLAIM_EVERY_S)
            for t0 in starts
            for k in range(max(int(length / CRUNCH_RECLAIM_EVERY_S), 1))]
    times_by_zone: Dict[str, List[float]] = {z: [] for z in zones}
    for hit in hits:
        jitter = rng.uniform(0.0, CRUNCH_JITTER_S, size=len(zones))
        for z, j in zip(zones, jitter):
            times_by_zone[z].append(hit + float(j))
    for z, times in times_by_zone.items():
        merged = list(market.interruptions.get((flagged, z), ())) + times
        market.add_interruptions(flagged, z, merged)


def diurnal(market: SpotMarket, cfg: ScenarioConfig) -> None:
    """Daily demand cycle + weekend discount on every zone.

    Price scales by `1 + a * sin(2*pi*(t - phase)/day)` with
    a = 0.25 * strength (clipped below 0.9 so prices stay positive),
    peaking mid-afternoon; Saturdays and Sundays additionally scale by
    0.8. Each zone gets a seeded phase jitter of up to one hour so
    zones do not move in lockstep.
    """
    ts = _grid(cfg)
    day = 86400.0
    a = min(0.25 * cfg.strength, 0.9)
    for pi, pname in enumerate(market.providers):
        rng = np.random.RandomState(cfg.seed + 1000 * pi)
        for zone in _provider_zones(market, pname):
            base = _base_prices(market, pname, zone, ts)
            phase = 14 * 3600.0 + rng.uniform(-3600.0, 3600.0)
            cycle = 1.0 + a * np.sin(2 * np.pi * (ts - phase) / day)
            weekend = np.where((ts // day) % 7 >= 5, 0.8, 1.0)
            market.replace_source(
                zone, TracePriceSource(ts, base * cycle * weekend),
                provider=pname)


def price_inversion(market: SpotMarket, cfg: ScenarioConfig) -> None:
    """Persistent cross-provider price inversions.

    The horizon is cut into 6-hour blocks; in even blocks the flagged
    provider's zones price `1 + 0.5 * strength` above their base while
    every other provider prices the same factor below, and odd blocks
    swap the roles — so at any instant one provider is decisively
    cheaper, and which one it is keeps flipping. Needs a market with at
    least two providers (there is nothing to invert otherwise).
    """
    if len(market.providers) < 2:
        raise ValueError("price_inversion needs >= 2 providers")
    flagged = _flagged(market, cfg)
    ts = _grid(cfg)
    block_s = 6 * 3600.0
    factor = 1.0 + 0.5 * cfg.strength
    even = (ts // block_s) % 2 == 0
    for pname in market.providers:
        up = np.where(even, factor, 1.0 / factor)
        mult = up if pname == flagged else 1.0 / up
        for zone in _provider_zones(market, pname):
            base = _base_prices(market, pname, zone, ts)
            market.replace_source(
                zone, TracePriceSource(ts, base * mult), provider=pname)


# name -> generator; `MarketConfig.scenario.name` resolves here
SCENARIOS: Dict[str, Callable[[SpotMarket, ScenarioConfig], None]] = {
    "flash_crash": flash_crash,
    "capacity_crunch": capacity_crunch,
    "diurnal": diurnal,
    "price_inversion": price_inversion,
}


def apply_scenario(market: SpotMarket, cfg: ScenarioConfig) -> SpotMarket:
    """Reshape `market` in place through the named generator; returns
    the market for chaining. Unknown names raise, listing the
    registry."""
    try:
        gen = SCENARIOS[cfg.name]
    except KeyError:
        raise ValueError(f"unknown scenario {cfg.name!r}; known: "
                         f"{sorted(SCENARIOS)}") from None
    gen(market, cfg)
    return market
