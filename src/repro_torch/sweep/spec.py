"""Sweep cell coordinates and the named-market registry.

A `ScenarioSpec` pins everything one cell run depends on, as plain
scalars — picklable across `multiprocessing` workers and hashable as a
dict key. The market axis is a *name* resolved through `MARKETS` at run
time (a `MarketConfig` holds no live objects, but shipping names keeps
specs tiny and the JSON report self-describing).

Every named market shares one 2-provider synthetic base (aws priced
like the paper's Table-I g5.xlarge row, gcp slightly off it) so
cross-market cost differences come from the scenario shaping, not from
different base economics. The scenario's own seed is the spec seed:
each Monte-Carlo repetition sees a *different draw of the same
adversarial weather*, which is exactly what the bootstrap CIs need.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.common.config import (MarketConfig, ProviderConfig,
                                 ScenarioConfig)

# default preemption model per market: crunch markets carry scheduled
# correlated reclaims (the "correlated" model folds them in on top of
# background churn); everywhere else the price-coupled hazard ties
# reclaims to the scenario's price shape
MARKET_MODELS: Dict[str, str] = {
    "baseline": "price_coupled",
    "flash_crash": "price_coupled",
    "capacity_crunch": "correlated",
    "diurnal": "price_coupled",
    "price_inversion": "price_coupled",
}

MARKETS: Dict[str, Optional[str]] = {
    "baseline": None,                       # un-shaped 2-provider base
    "flash_crash": "flash_crash",
    "capacity_crunch": "capacity_crunch",
    "diurnal": "diurnal",
    "price_inversion": "price_inversion",
}


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Coordinates of one sweep cell run (one policy on one market
    under one preemption model at one seed). Frozen + scalar-only, so
    specs pickle to workers and key result dicts."""
    policy: str                    # repro_torch.core.policies registry name
    market: str                    # MARKETS registry name
    preemption_model: str          # repro_torch.cloud.preemption.MODEL_NAMES
    seed: int
    n_clients: int = 8             # cross-silo pool per run
    n_epochs: int = 6              # FL rounds per run
    preemption_rate_per_hr: float = 0.15   # background churn
    # round-engine override: "" keeps the policy's own engine (so
    # fedcostaware_async stays async); "sync" / "async_buffered" pin it
    # regardless of policy — the sweep's engine axis
    engine: str = ""
    # when non-empty, the cell run records its full event stream to
    # `<record_dir>/<cell_slug>.events.jsonl` — what `sweep --audit`
    # replays through the dollar-exact reconciler
    record_dir: str = ""

    def cell_slug(self) -> str:
        """Filesystem-safe cell identity: the grid coordinates joined
        in grid order, naming audit traces and audit failures."""
        return (f"{self.policy}__{self.market}__{self.preemption_model}"
                f"__{self.engine or 'default'}__s{self.seed}")

    def trace_path(self) -> Optional[Path]:
        """Where this cell records its event stream (None when the
        sweep is not recording)."""
        if not self.record_dir:
            return None
        return Path(self.record_dir) / f"{self.cell_slug()}.events.jsonl"


def market_config(name: str, seed: int) -> MarketConfig:
    """The named sweep market at `seed`: the shared 2-provider base,
    shaped by the registered scenario generator (None for the
    baseline). Unknown names raise, listing the registry."""
    if name not in MARKETS:
        raise ValueError(f"unknown sweep market {name!r}; known: "
                         f"{sorted(MARKETS)}")
    scenario = MARKETS[name]
    return MarketConfig(
        providers=(
            ProviderConfig(name="aws", on_demand_rate=1.008,
                           spot_rate_mean=0.3951, spot_rate_sigma=0.02,
                           n_zones=3),
            ProviderConfig(name="gcp", on_demand_rate=1.11,
                           spot_rate_mean=0.4200, spot_rate_sigma=0.02,
                           min_billing_s=30.0, n_zones=2),
        ),
        scenario=(None if scenario is None
                  # run-scale horizon: sweep runs finish in a few
                  # simulated hours, so the adversarial weather must
                  # land inside them, not somewhere in a 48 h default
                  else ScenarioConfig(name=scenario, seed=seed,
                                      horizon_s=4 * 3600.0,
                                      step_s=60.0)))


def build_grid(policies: Sequence[str], markets: Sequence[str],
               seeds: Sequence[int],
               models: Optional[Sequence[str]] = None,
               n_clients: int = 8, n_epochs: int = 6,
               engines: Optional[Sequence[str]] = None,
               ) -> List[ScenarioSpec]:
    """The full sweep grid, in deterministic (policy, market, model,
    engine, seed) order. `models=None` gives each market its registered
    default (`MARKET_MODELS`); an explicit list crosses every model
    with every market. `engines=None` keeps each policy's own round
    engine; an explicit list (e.g. ``["sync", "async_buffered"]``)
    crosses the engine override into the grid as a fourth axis."""
    specs: List[ScenarioSpec] = []
    cell_engines = list(engines) if engines is not None else [""]
    for policy in policies:
        for market in markets:
            cell_models = (models if models is not None
                           else [MARKET_MODELS.get(market,
                                                   "price_coupled")])
            for model in cell_models:
                for engine in cell_engines:
                    for seed in seeds:
                        specs.append(ScenarioSpec(
                            policy=policy, market=market,
                            preemption_model=model, seed=seed,
                            n_clients=n_clients, n_epochs=n_epochs,
                            engine=engine))
    return specs
