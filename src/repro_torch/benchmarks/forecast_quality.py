"""Forecast calibration -> dollars saved: learned vs reactive vs
oracle vs deliberately miscalibrated.

The learned-forecast subsystem (`repro_torch.forecast`) predicts
interruptions from signals a real tenant observes — published prices
and its own reclaims — instead of thresholding model internals. This
benchmark prices that difference on the pinned spiky-trace scenario of
`benchmarks/forecast_prewarm.py` (three clients, recorded burst
reclaims replayed identically under every policy, AWS-style 120 s
notice):

  reactive_ckpt   WarningReaction("checkpoint") only — no forecasting;
                  every reclaim costs a full cold spin-up gap.
  oracle_prewarm  `ForecastPrewarmSpec(oracle=True)` — the privileged
                  hazard formula with the *generator's own*
                  sensitivity and base rate. The cost floor a
                  forecaster can approach but has no business beating.
  learned         `LearnedForecastSpec` (online quantile regression +
                  regime-conditioned hazard, `repro_torch.forecast`): starts
                  ignorant, learns the spike regime from the first
                  burst's reclaims, pre-warms through later bursts.
  miscalibrated   the same forecaster with its regime hazards swapped
                  at query time: confidently pays for standbys in calm
                  markets and holds through spikes.

Asserted orderings (pinned by tests/test_forecast_quality.py and CI):

  cost(learned) <  cost(reactive)            forecasting pays
  cost(learned) <= cost(oracle) * (1+slack)  approaches, within 25%
  cost(learned) >= cost(oracle)              ... but never beats it
  cost(miscalibrated) > cost(learned)        bad calibration burns $

The run also reports each forecaster's final online calibration
(Brier score, quantile-band coverage) extracted from its recorded
`ForecastUpdated` telemetry — the chain from calibration quality to
dollars is the whole point.

Flags (documented in benchmarks/README.md):
  --price-trace DIR   spot-history fixture directory (spiky_early.csv)
  --epochs N          FL rounds (default 8)
  --seed N            simulator seed
  --horizon S         forecast/decision horizon in seconds (default 600)
  --oracle-slack F    allowed cost overshoot vs oracle (default 0.25)
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from repro_torch.benchmarks.forecast_prewarm import (CLIENTS, SCHED,
                                         DEFAULT_TRACE_DIR,
                                         spiky_market, spinup_gap_s)
from repro_torch.common.config import CloudConfig, FLRunConfig
from repro_torch.core.policies import Policy, register_policy
from repro_torch.core.strategy import ForecastPrewarmSpec
from repro_torch.fl.runner import FLCloudRunner
from repro_torch.forecast import register_learned_policy

POLICY_NAMES = ("reactive_ckpt", "oracle_prewarm", "learned_forecast",
                "miscalibrated_forecast")


def register_policies(horizon_s: float = 600.0,
                      threshold_per_hr: float = 2.0
                      ) -> Dict[str, Policy]:
    """Register the four compared compositions (idempotent)."""
    out = {}
    out["reactive_ckpt"] = register_policy(Policy(
        "reactive_ckpt", pick_cheapest_zone=True,
        on_warning="checkpoint"), overwrite=True)
    out["oracle_prewarm"] = register_policy(Policy(
        "oracle_prewarm", pick_cheapest_zone=True,
        on_warning="checkpoint",
        strategies=(ForecastPrewarmSpec(
            hazard_threshold_per_hr=threshold_per_hr, poll_s=30.0,
            oracle=True),)), overwrite=True)
    # lr=0.01 keeps the online median anchored to the calm price over
    # a 600 s burst (a larger step lets the median chase the burst
    # level and flip the regime back to calm mid-burst, releasing the
    # standby just before the reclaim lands).
    out["learned_forecast"] = register_learned_policy(
        "learned_forecast", forecaster="quantile",
        horizon_s=horizon_s, poll_s=30.0, prior_rate_per_hr=1.0,
        lr=0.01)
    out["miscalibrated_forecast"] = register_learned_policy(
        "miscalibrated_forecast", forecaster="quantile",
        horizon_s=horizon_s, poll_s=30.0, prior_rate_per_hr=1.0,
        lr=0.01, miscalibrate=True)
    return out


def forecast_metrics(records) -> Dict[str, float]:
    """Final online calibration + action counts from a recorded
    stream's `ForecastUpdated` telemetry (zeros/-1 when the policy
    published none)."""
    brier = coverage = -1.0
    n = prewarms = checkpoints = 0
    for rec in records:
        if rec["type"] != "ForecastUpdated":
            continue
        n += 1
        brier, coverage = rec["brier"], rec["coverage"]
        if "prewarm" in rec["action"]:
            prewarms += 1
        if "checkpoint" in rec["action"]:
            checkpoints += 1
    return {"n_forecasts": n, "brier": brier, "coverage": coverage,
            "n_prewarm_polls": prewarms, "n_ckpt_polls": checkpoints}


def run_policy(policy: str,
               trace_dir: Union[str, Path] = DEFAULT_TRACE_DIR,
               n_epochs: int = 8, rate_per_hr: float = 1.0,
               seed: int = 0, horizon_s: float = 600.0
               ) -> Dict[str, float]:
    """One pinned run; every policy faces the identical replayed
    reclaim schedule (`preemption_rate_per_hr` only seeds the
    estimators' priors)."""
    register_policies(horizon_s)
    cloud = CloudConfig(spot_rate_sigma=0.0, spin_up_sigma=0.0,
                        spin_up_mean_s=450.0,
                        preemption_model="replay",
                        preemption_rate_per_hr=rate_per_hr,
                        market=spiky_market(trace_dir))
    cfg = FLRunConfig(dataset="forecast_quality", clients=CLIENTS,
                      n_epochs=n_epochs, policy=policy, seed=seed)
    r = FLCloudRunner(cfg, cloud_cfg=cloud, sched_cfg=SCHED, record=True)
    res = r.run()
    out = {"total_cost": res.total_cost,
           "spinup_gap_s": spinup_gap_s(r.recorder.records),
           "n_preemptions": res.n_preemptions,
           "lost_work_s": res.lost_work_s,
           "rounds_completed": res.rounds_completed,
           "makespan_s": res.makespan_s}
    out.update(forecast_metrics(r.recorder.records))
    return out


def compare(trace_dir: Union[str, Path] = DEFAULT_TRACE_DIR,
            n_epochs: int = 8, seed: int = 0,
            horizon_s: float = 600.0
            ) -> Dict[str, Dict[str, float]]:
    """All four compositions on the identical seeded scenario."""
    return {name: run_policy(name, trace_dir, n_epochs, seed=seed,
                             horizon_s=horizon_s)
            for name in POLICY_NAMES}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--price-trace", metavar="DIR",
                    default=str(DEFAULT_TRACE_DIR),
                    help="spot-history fixture directory holding "
                         "spiky_early.csv")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=float, default=600.0,
                    help="forecast/decision horizon (seconds)")
    ap.add_argument("--oracle-slack", type=float, default=0.25,
                    help="allowed learned-cost overshoot vs the oracle "
                         "(fraction)")
    args = ap.parse_args(argv)

    results = compare(args.price_trace, args.epochs, args.seed,
                      args.horizon)
    print("policy,total_cost,spinup_gap_s,n_preemptions,lost_work_s,"
          "rounds_completed,brier,coverage,n_forecasts")
    for name, r in results.items():
        print(f"{name},{r['total_cost']:.4f},{r['spinup_gap_s']:.1f},"
              f"{r['n_preemptions']},{r['lost_work_s']:.1f},"
              f"{r['rounds_completed']},{r['brier']:.4f},"
              f"{r['coverage']:.4f},{r['n_forecasts']}")
    rc = results["reactive_ckpt"]
    oc = results["oracle_prewarm"]
    lc = results["learned_forecast"]
    mc = results["miscalibrated_forecast"]
    assert rc["n_preemptions"] > 0, \
        "scenario must actually exercise reclaims"
    assert lc["n_forecasts"] > 0 and mc["n_forecasts"] > 0, \
        "learned policies must publish ForecastUpdated telemetry"
    assert lc["total_cost"] < rc["total_cost"], (
        f"learned forecasting must beat the reactive baseline: "
        f"{lc['total_cost']:.4f} vs {rc['total_cost']:.4f}")
    assert lc["total_cost"] >= oc["total_cost"], (
        f"learned must not beat the oracle it approximates: "
        f"{lc['total_cost']:.4f} vs {oc['total_cost']:.4f}")
    assert lc["total_cost"] <= oc["total_cost"] * (1 + args.oracle_slack), (
        f"learned must approach the oracle within "
        f"{args.oracle_slack:.0%}: {lc['total_cost']:.4f} vs "
        f"{oc['total_cost']:.4f}")
    assert mc["total_cost"] > lc["total_cost"], (
        f"miscalibration must measurably lose money: "
        f"{mc['total_cost']:.4f} vs {lc['total_cost']:.4f}")
    return results


if __name__ == "__main__":
    main()
