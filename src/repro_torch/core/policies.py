"""Scheduling policies compared in the paper's Table I — now declarative
compositions of `SchedulingStrategy` components (`repro_torch.core.strategy`).

  on_demand          — on-demand instances, kept running for the whole
                       job; no strategies.
  spot               — spot instances, kept running for the whole job
                       (fault-tolerant but no lifecycle management); no
                       strategies.
  fedcostaware       — spot instances + the FedCostAware discipline
                       (§III) as `LifecycleSpec() + BudgetScreenSpec()`
                       under the paper's synchronous round barrier.
  fedcostaware_async — beyond-paper fourth column: the same strategy
                       composition, but rounds run on the FedBuff-style
                       async buffered engine (aggregate after K results;
                       stragglers roll into the next round).

Each policy names the `RoundEngine` implementation that owns its round
semantics (see `repro_torch.fl.engines`) and the strategy components that own
its scheduling decisions; both plug in without touching engine or cloud
internals. `register_policy` adds beyond-paper compositions under new
names — e.g. the oracle/observable forecast-pre-warming variants
(`benchmarks/forecast_prewarm.py`) or the learned-forecast composition
(`repro_torch.forecast.register_learned_policy`, whose strategy lives
entirely outside this package yet plugs into `Policy.strategies` like
any core spec).

Legacy boolean construction — `Policy(name, on_demand,
manage_lifecycle, enforce_budgets, pick_cheapest_zone)` — still works:
the flags map onto the equivalent strategy list with a
`DeprecationWarning`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

from repro_torch.common.config import SchedulerConfig
from repro_torch.core.budget import BudgetLedger
from repro_torch.core.estimator import TimeEstimator
from repro_torch.core.scheduler import FedCostAwareScheduler
from repro_torch.core.strategy import (BudgetScreenSpec, LifecycleSpec,
                                 StrategySpec)


# valid engine reactions to a provider's preemption-notice warning
ON_WARNING_MODES = ("ignore", "checkpoint", "drain")


def _known_engines() -> Optional[Tuple[str, ...]]:
    """The `RoundEngine` registry keys, or None while the registry is
    still importing (the one circular-bootstrap window: building the
    module-level `POLICIES` below triggers `repro_torch.fl.engines`, whose
    import chain re-enters this module)."""
    try:
        from repro_torch.fl.engines import ENGINES
    except ImportError:
        return None
    return tuple(sorted(ENGINES))


@dataclasses.dataclass(frozen=True, init=False)
class Policy:
    """One scheduling policy: which market, strategy composition, round
    engine, placement scope and warning reaction a run uses."""
    name: str
    on_demand: bool              # instance market
    pick_cheapest_zone: bool     # cheapest-zone placement vs pinned
    engine: str                  # RoundEngine registry key
    # whether cheapest-zone placement arbitrates across *every* provider
    # in the SpotMarket (Multi-FedLS-style) or stays on the market's
    # default provider. Moot on single-provider markets, so the default
    # preserves all existing behavior; `FLRunConfig.cross_provider`
    # overrides it per run.
    cross_provider: bool
    # how engines react to a provider's preemption-notice warning
    # (`ClientPreemptionWarning`): "ignore" (historical behavior — work
    # since the last periodic checkpoint is lost on reclaim),
    # "checkpoint" (snapshot training state inside the notice window,
    # resume the replacement from it), or "drain" (snapshot, then
    # proactively terminate and re-request before the reclaim lands).
    # `FLRunConfig.on_warning` overrides it per run.
    on_warning: str
    # the declarative strategy composition (repro_torch.core.strategy specs);
    # the composition root builds a StrategyStack from it per run
    strategies: Tuple[StrategySpec, ...]

    def __init__(self, name: str, on_demand: bool = False,
                 manage_lifecycle: Optional[bool] = None,
                 enforce_budgets: Optional[bool] = None,
                 pick_cheapest_zone: bool = False, engine: str = "sync",
                 cross_provider: bool = True, on_warning: str = "ignore",
                 strategies: Optional[Tuple[StrategySpec, ...]] = None):
        """Construct a policy; `manage_lifecycle`/`enforce_budgets` are
        the deprecated boolean spelling of the strategy list (kept so
        pre-redesign `Policy(name, od, lifecycle, budgets, cheapest)`
        call sites keep working)."""
        if manage_lifecycle is not None or enforce_budgets is not None:
            if strategies is not None:
                raise ValueError(
                    f"policy {name!r}: pass either the deprecated "
                    f"boolean flags or `strategies=`, not both")
            warnings.warn(
                f"policy {name!r}: boolean Policy flags "
                f"(manage_lifecycle/enforce_budgets) are deprecated; "
                f"compose strategies instead, e.g. "
                f"Policy({name!r}, strategies=(LifecycleSpec(), "
                f"BudgetScreenSpec()))",
                DeprecationWarning, stacklevel=2)
            mapped = []
            if manage_lifecycle:
                mapped.append(LifecycleSpec())
            if enforce_budgets:
                mapped.append(BudgetScreenSpec())
            strategies = tuple(mapped)
        strategies = tuple(strategies or ())
        for s in strategies:
            if not isinstance(s, StrategySpec):
                raise ValueError(
                    f"policy {name!r}: strategies must be StrategySpec "
                    f"instances, got {type(s).__name__}")
        if on_warning not in ON_WARNING_MODES:
            raise ValueError(
                f"policy {name!r}: unknown on_warning mode "
                f"{on_warning!r}; known: {ON_WARNING_MODES}")
        known = _known_engines()
        if known is not None and engine not in known:
            raise ValueError(
                f"policy {name!r}: unknown round engine {engine!r}; "
                f"known: {list(known)}")
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "on_demand", on_demand)
        object.__setattr__(self, "pick_cheapest_zone", pick_cheapest_zone)
        object.__setattr__(self, "engine", engine)
        object.__setattr__(self, "cross_provider", cross_provider)
        object.__setattr__(self, "on_warning", on_warning)
        object.__setattr__(self, "strategies", strategies)

    # ------------------------------------------------------------------
    # Backwards-compatible boolean views of the composition.
    # ------------------------------------------------------------------
    @property
    def manage_lifecycle(self) -> bool:
        """Does the composition include Listing-1 lifecycle management
        (the old `manage_lifecycle` flag)?"""
        return any(isinstance(s, LifecycleSpec) for s in self.strategies)

    @property
    def enforce_budgets(self) -> bool:
        """Does the composition include §III-E budget screening (the
        old `enforce_budgets` flag)?"""
        return any(isinstance(s, BudgetScreenSpec)
                   for s in self.strategies)


POLICIES = {
    "on_demand": Policy("on_demand", on_demand=True),
    "spot": Policy("spot", pick_cheapest_zone=True),
    "fedcostaware": Policy(
        "fedcostaware", pick_cheapest_zone=True,
        strategies=(LifecycleSpec(), BudgetScreenSpec())),
    "fedcostaware_async": Policy(
        "fedcostaware_async", pick_cheapest_zone=True,
        strategies=(LifecycleSpec(), BudgetScreenSpec()),
        engine="async_buffered"),
}


def get_policy(name: str) -> Policy:
    """Look up a registered policy by name."""
    return POLICIES[name]


def register_policy(policy: Policy, overwrite: bool = False) -> Policy:
    """Register a beyond-Table-I policy composition under its name so
    string-keyed plumbing (`FLRunConfig.policy`, benchmarks) can reach
    it. Re-registering an existing name raises unless `overwrite`."""
    if policy.name in POLICIES and not overwrite:
        raise ValueError(f"policy {policy.name!r} already registered")
    POLICIES[policy.name] = policy
    return policy


def make_scheduler(policy: Policy, sched_cfg: SchedulerConfig,
                   spin_up_prior: float = 150.0) -> FedCostAwareScheduler:
    """Fresh FedCostAware decision core (estimator + budget ledger) for
    a run under `policy` — the shared state every strategy component
    reads (`StrategyContext.sched`)."""
    est = TimeEstimator(sched_cfg.ema_alpha, spin_up_prior)
    ledger = BudgetLedger()
    return FedCostAwareScheduler(sched_cfg, est, ledger)
