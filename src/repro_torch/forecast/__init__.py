"""Online interruption/price forecasting learned from the event bus.

The `ForecastPrewarmStrategy` shipped in the strategy-API redesign
thresholds the *true* preemption-model hazard — a signal no real
tenant can read, and one that does not even exist when a run replays
recorded interruptions. This package replaces the oracle with
forecasters that learn online from exactly what a tenant observes:

  ObservableFeed       (`feed`) subscribes to the bus's reclaim events
                       and samples zone spot prices on demand — the
                       tenant-visible market surface, no model
                       internals. It also hosts the price-derived
                       hazard estimate the runner's replay fallback
                       uses, so "oracle" vs "observable" is an explicit
                       property of every recorded trace.
  Forecaster protocol  (`predictors`) with two online implementations:
                       `HazardEwmaForecaster` (EWMA over observed
                       inter-reclaim gaps) and `QuantileForecaster`
                       (per-zone online quantile regression via pinball
                       updates + regime-conditioned hazard rates).
                       Both are deterministic given a seed and update
                       incrementally per event.
  CalibrationTracker   (`calibration`) scores the forecasts online:
                       Brier score for interruption-within-horizon
                       predictions, empirical coverage of the quantile
                       price bands.
  decide               (`decision`) the explicit cost-of-error rule:
                       expected lost-work dollars vs standby /
                       checkpoint dollars, priced from the live market
                       rates the strategy context exposes.
  LearnedForecastStrategy
                       (`strategy`) the composition: a
                       `SchedulingStrategy` (zero engine edits) that
                       turns predicted interruption probability into
                       PreWarm / Checkpoint / Drain directives and
                       publishes `ForecastUpdated` telemetry
                       (eventlog schema v8).

Layering: this package depends on `core.*`, `common.config` and
`checkpoint.snapshots` only — never on `fl.*` or `cloud.*`. Market
access reaches the feed as plain callables, wired by the composition
root (`repro_torch.fl.runner`) or by `ObservableFeed.for_market` over any
duck-typed market object.
"""
from repro_torch.forecast.calibration import CalibrationTracker
from repro_torch.forecast.decision import Decision, DecisionConfig, decide
from repro_torch.forecast.feed import ObservableFeed
from repro_torch.forecast.predictors import (Forecaster, HazardEwmaForecaster,
                                       QuantileForecaster, make_forecaster)
from repro_torch.forecast.strategy import (LearnedForecastSpec,
                                     LearnedForecastStrategy,
                                     register_learned_policy)

__all__ = [
    "CalibrationTracker", "Decision", "DecisionConfig", "decide",
    "ObservableFeed", "Forecaster", "HazardEwmaForecaster",
    "QuantileForecaster", "make_forecaster", "LearnedForecastSpec",
    "LearnedForecastStrategy", "register_learned_policy",
]
