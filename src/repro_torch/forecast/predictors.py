"""Online interruption/price predictors behind one `Forecaster`
protocol.

Both predictors learn incrementally — one O(1) update per observed
event, no batch refits — and are fully deterministic given their
constructor arguments (the `seed` is stored for provenance; no
randomness is consumed, so identical event streams always reproduce
identical predictions, which `tests/test_properties.py` pins).

  HazardEwmaForecaster  an exponentially weighted moving average over
                        the gaps between observed reclaims, per
                        (provider, zone). The hazard estimate is the
                        reciprocal mean gap; before the first reclaim
                        it falls back to the prior `base_rate_per_hr`.
  QuantileForecaster    per-zone online quantile regression: each
                        price sample takes one pinball-loss
                        subgradient step per tracked quantile, and
                        the learned median splits the market into a
                        calm and a spike *regime*. Reclaim counts and
                        market exposure are attributed to the regime
                        in force, giving two smoothed per-regime
                        hazard rates — high in spikes, low in calm —
                        which is exactly the structure of the
                        price-coupled reclaim process it observes.
                        `miscalibrate=True` swaps the two regimes'
                        rates at query time: the deliberately wrong
                        forecaster `benchmarks/forecast_quality.py`
                        uses to show that bad calibration loses real
                        dollars.

Interruption probability within a horizon follows from the hazard via
the exponential survival function `p = 1 - exp(-lambda * h)`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

_SPIKE = "spike"
_CALM = "calm"


class Forecaster:
    """Protocol every online predictor implements.

    Observations arrive through `observe_price` / `observe_reclaim`
    (forwarded by an `ObservableFeed`); queries never mutate state, so
    prediction at time `t` reflects only events observed strictly
    before the query.
    """

    #: short identifier recorded in `ForecastUpdated` telemetry
    name: str = "forecaster"

    def observe_price(self, provider: str, zone: str, t: float,
                      price: float) -> None:
        """One spot-price sample for a zone."""

    def observe_reclaim(self, provider: str, zone: str,
                        t: float) -> None:
        """One observed reclaim in a zone."""

    def hazard_per_hr(self, provider: str, zone: str,
                      t: float) -> float:
        """Current reclaim-hazard estimate (events/hour)."""
        raise NotImplementedError

    def interruption_probability(self, provider: str, zone: str,
                                 t: float, horizon_s: float) -> float:
        """P(at least one reclaim within `horizon_s`), exponential
        survival on the current hazard estimate."""
        lam = self.hazard_per_hr(provider, zone, t)
        if lam <= 0.0 or horizon_s <= 0.0:
            return 0.0
        return 1.0 - math.exp(-lam * horizon_s / 3600.0)

    def price_quantiles(self, provider: str, zone: str
                        ) -> Optional[Dict[float, float]]:
        """Learned price quantiles (tau -> $/hr) when the predictor
        models them; None otherwise."""
        return None


class HazardEwmaForecaster(Forecaster):
    """EWMA over observed inter-reclaim gaps, per (provider, zone).

    The first gap is measured from the zone's first price sample (the
    earliest moment the tenant was watching); subsequent gaps are
    reclaim-to-reclaim. The hazard estimate is `3600 / ewma_gap`
    events/hour, falling back to the prior `base_rate_per_hr` before
    any reclaim is seen.
    """

    name = "ewma"

    def __init__(self, base_rate_per_hr: float = 0.2,
                 alpha: float = 0.3, seed: int = 0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.base_rate_per_hr = base_rate_per_hr
        self.alpha = alpha
        self.seed = seed                     # provenance only
        self._first_seen: Dict[Tuple[str, str], float] = {}
        self._last_reclaim: Dict[Tuple[str, str], float] = {}
        self._ewma_gap: Dict[Tuple[str, str], float] = {}

    def observe_price(self, provider: str, zone: str, t: float,
                      price: float) -> None:
        """Prices only anchor the first observation time here."""
        self._first_seen.setdefault((provider, zone), t)

    def observe_reclaim(self, provider: str, zone: str,
                        t: float) -> None:
        """Fold one reclaim gap into the zone's EWMA."""
        key = (provider, zone)
        prev = self._last_reclaim.get(key,
                                      self._first_seen.get(key, t))
        gap = max(t - prev, 1.0)     # degenerate same-tick reclaims
        cur = self._ewma_gap.get(key)
        self._ewma_gap[key] = (gap if cur is None
                               else (1.0 - self.alpha) * cur
                               + self.alpha * gap)
        self._last_reclaim[key] = t

    def hazard_per_hr(self, provider: str, zone: str,
                      t: float) -> float:
        """Reciprocal EWMA gap; the prior before any reclaim."""
        gap = self._ewma_gap.get((provider, zone))
        if gap is None:
            return self.base_rate_per_hr
        return 3600.0 / gap


class _ZoneQuantiles:
    """Per-zone online quantile-regression + regime-hazard state."""

    def __init__(self, taus: Tuple[float, ...]):
        self.q: Dict[float, float] = {}       # tau -> estimate
        self.taus = taus
        self.last_t: Optional[float] = None
        self.regime: str = _CALM
        self.exposure_h = {_CALM: 0.0, _SPIKE: 0.0}
        self.reclaims = {_CALM: 0, _SPIKE: 0}
        self.n_samples = 0


class QuantileForecaster(Forecaster):
    """Online quantile regression over spot prices + regime-conditioned
    hazard rates, per zone.

    Each price sample takes one pinball-loss subgradient step per
    tracked quantile: `q += lr_t * (tau - 1{price <= q})` with a step
    size proportional to the price scale. The learned median defines
    the market *regime* — spike when the price exceeds the median by
    `spike_margin` relative — and reclaims/exposure are attributed to
    the regime in force when they were observed. The per-regime hazard
    is the smoothed occurrence rate

        lambda_r = (reclaims_r + w * base) / (exposure_hours_r + w)

    with `w = prior_weight` pseudo-hours of the prior
    `base_rate_per_hr`, so the estimate starts at the prior and
    converges to the empirical rate as evidence accumulates.
    """

    name = "quantile"

    def __init__(self, taus: Tuple[float, ...] = (0.1, 0.5, 0.9),
                 lr: float = 0.05, spike_margin: float = 0.15,
                 base_rate_per_hr: float = 0.2,
                 prior_weight: float = 1.0,
                 miscalibrate: bool = False, seed: int = 0):
        if 0.5 not in taus:
            raise ValueError("taus must include the 0.5 median "
                             "(regime split point)")
        self.taus = tuple(taus)
        self.lr = lr
        self.spike_margin = spike_margin
        self.base_rate_per_hr = base_rate_per_hr
        self.prior_weight = prior_weight
        self.miscalibrate = miscalibrate
        self.seed = seed                     # provenance only
        self._zones: Dict[Tuple[str, str], _ZoneQuantiles] = {}

    def _zone(self, provider: str, zone: str) -> _ZoneQuantiles:
        key = (provider, zone)
        if key not in self._zones:
            self._zones[key] = _ZoneQuantiles(self.taus)
        return self._zones[key]

    def _classify(self, z: _ZoneQuantiles, price: float) -> str:
        mid = z.q.get(0.5)
        if mid is None or mid <= 0.0:
            return _CALM
        return _SPIKE if price > mid * (1.0 + self.spike_margin) \
            else _CALM

    def observe_price(self, provider: str, zone: str, t: float,
                      price: float) -> None:
        """Accrue regime exposure for the elapsed interval, then take
        one pinball step per quantile and reclassify the regime."""
        z = self._zone(provider, zone)
        if z.last_t is not None and t > z.last_t:
            # the price was piecewise-constant at its previous level
            # over (last_t, t], so the elapsed exposure belongs to the
            # regime that level implied
            z.exposure_h[z.regime] += (t - z.last_t) / 3600.0
        if not z.q:
            z.q = {tau: price for tau in self.taus}
        else:
            step = self.lr * max(abs(price), 1e-3)
            for tau in self.taus:
                grad = tau - (1.0 if price <= z.q[tau] else 0.0)
                z.q[tau] += step * grad
        z.regime = self._classify(z, price)
        z.last_t = t
        z.n_samples += 1

    def observe_reclaim(self, provider: str, zone: str,
                        t: float) -> None:
        """Attribute the reclaim to the regime currently in force."""
        z = self._zone(provider, zone)
        z.reclaims[z.regime] += 1

    def _regime_hazard(self, z: _ZoneQuantiles, regime: str) -> float:
        w = self.prior_weight
        return ((z.reclaims[regime] + w * self.base_rate_per_hr)
                / (z.exposure_h[regime] + w))

    def hazard_per_hr(self, provider: str, zone: str,
                      t: float) -> float:
        """The hazard of the zone's current regime (events/hour);
        `miscalibrate=True` answers with the *other* regime's rate —
        confidently wrong in both directions."""
        z = self._zone(provider, zone)
        regime = z.regime
        if self.miscalibrate:
            regime = _CALM if regime == _SPIKE else _SPIKE
        return self._regime_hazard(z, regime)

    def price_quantiles(self, provider: str, zone: str
                        ) -> Optional[Dict[float, float]]:
        """The zone's learned quantiles, or None before any sample."""
        z = self._zone(provider, zone)
        return dict(z.q) if z.q else None


def make_forecaster(kind: str, **kwargs) -> Forecaster:
    """Factory keyed on the spec-level `forecaster` name."""
    if kind == "ewma":
        return HazardEwmaForecaster(**kwargs)
    if kind == "quantile":
        return QuantileForecaster(**kwargs)
    raise ValueError(f"unknown forecaster kind {kind!r} "
                     f"(expected 'ewma' or 'quantile')")
