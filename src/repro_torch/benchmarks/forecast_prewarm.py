"""Interruption-forecast pre-warming vs reactive warning handling.

The price-coupled preemption model (`repro_torch.cloud.preemption`) makes the
reclaim hazard *observable before the reclaim*: on a spiky market day
the hazard jumps the moment the spot price does, minutes before the
thinned reclaim actually lands. `ForecastPrewarmStrategy`
(`repro_torch.core.strategy`) exploits that: when a client's hazard crosses a
threshold it pre-warms a *standby* replacement next to the doomed
instance, and the reclaim recovery promotes the standby instead of
launching cold — the spin-up gap (client-seconds between `ClientLost`
and the replacement's `ClientReady`) collapses.

This benchmark runs the same pinned scenario — three clients on the
spiky_early.csv market day, price-coupled reclaims concentrated in the
1h–3h price spike, an AWS-style 120 s reclaim notice — under two
registered policy compositions:

  reactive_ckpt     WarningReaction("checkpoint") only: snapshots
                    inside the notice window, but the replacement is
                    requested *at* the reclaim (gap = full spin-up)
  forecast_prewarm  the same + ForecastPrewarmSpec: standbys pre-warm
                    when the hazard spikes

and asserts (pinned by tests/test_forecast_prewarm.py):

  (a) the forecast run's total spin-up gap is strictly lower, and
  (b) its total cost is no higher — the standby seconds cost less than
      the barrier idle time the gaps inflict on the other clients.

Both policies are pure strategy compositions: zero edits in
`fl/engines/` or `cloud/` (the acceptance criterion of the strategy
API redesign).

Flags (documented in benchmarks/README.md):
  --price-trace DIR   spot-history fixture directory (spiky_early.csv)
  --epochs N          FL rounds (default 8)
  --seed N            simulator seed
  --threshold H       hazard threshold, events/hour (default 2.0)
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from repro_torch.common.config import (ClientProfile, CloudConfig, FLRunConfig,
                                 MarketConfig, ProviderConfig,
                                 SchedulerConfig)
from repro_torch.core.policies import Policy, register_policy
from repro_torch.core.strategy import ForecastPrewarmSpec
from repro_torch.fl.runner import FLCloudRunner

# the checkout's price fixtures (this file is
# src/repro_torch/benchmarks/forecast_prewarm.py), read in place
DEFAULT_TRACE_DIR = (Path(__file__).resolve().parents[3]
                     / "tests" / "fixtures" / "prices")

# Pinned scenario: three heterogeneous clients, deterministic epochs,
# all placed in the spiky_early.csv zone. The 0.30 -> 0.45 price
# bursts last 10 min at the top of each of four hours; with
# sensitivity 16 the off-burst hazard estimate clamps to zero, so the
# forecast signal fires exactly inside the bursts — where the
# recorded reclaims land.
CLIENTS = (
    ClientProfile("a", mean_epoch_s=1100.0, jitter=0.0, n_samples=3),
    ClientProfile("b", mean_epoch_s=900.0, jitter=0.0, n_samples=2),
    ClientProfile("c", mean_epoch_s=700.0, jitter=0.0, n_samples=1),
)
SCHED = SchedulerConfig(checkpoint_every_s=600.0,
                        warning_ckpt_write_s=10.0)


def spiky_market(trace_dir: Union[str, Path],
                 notice_s: float = 120.0,
                 sensitivity: float = 16.0) -> MarketConfig:
    """The spiky_early.csv market day with an AWS-style reclaim
    notice, the recorded burst reclaims attached, and a price
    sensitivity steep enough that the estimated hazard is zero outside
    the bursts."""
    trace_dir = Path(trace_dir)
    return MarketConfig(providers=(ProviderConfig(
        name="spiky",
        price_trace=str(trace_dir / "spiky_early.csv"),
        interruption_trace=str(trace_dir
                               / "spiky_early.interruptions.csv"),
        preemption_notice_s=notice_s,
        preemption_price_sensitivity=sensitivity),))


def register_policies(threshold_per_hr: float = 2.0) -> Dict[str, Policy]:
    """Register the two compared compositions (idempotent) and return
    them: reactive warning handling vs forecast pre-warming."""
    reactive = register_policy(Policy(
        "reactive_ckpt", pick_cheapest_zone=True,
        on_warning="checkpoint"), overwrite=True)
    forecast = register_policy(Policy(
        "forecast_prewarm", pick_cheapest_zone=True,
        on_warning="checkpoint",
        strategies=(ForecastPrewarmSpec(
            hazard_threshold_per_hr=threshold_per_hr, poll_s=30.0,
            oracle=True),)),
        overwrite=True)
    return {"reactive_ckpt": reactive, "forecast_prewarm": forecast}


def spinup_gap_s(records) -> float:
    """Total client-seconds between each `ClientLost` and the same
    client's next *recovery* `ClientReady` (one carrying a resume
    token) in a recorded event stream — the time mid-epoch training
    sat stalled waiting for a replacement to boot. Idle-instance
    reclaims (no resume) stall nobody and are excluded."""
    open_loss: Dict[str, float] = {}
    gap = 0.0
    for rec in records:
        if rec["type"] == "ClientLost":
            open_loss[rec["client"]] = rec["t"]
        elif rec["type"] == "ClientReady" and rec["client"] in open_loss:
            t0 = open_loss.pop(rec["client"])
            if rec.get("resume_token") is not None:
                gap += rec["t"] - t0
    return gap


def run_policy(policy: str,
               trace_dir: Union[str, Path] = DEFAULT_TRACE_DIR,
               n_epochs: int = 8, rate_per_hr: float = 1.0,
               seed: int = 0,
               threshold_per_hr: float = 2.0) -> Dict[str, float]:
    """One pinned run; returns cost, spin-up gap, reclaim count and
    rounds completed. Reclaims replay the recorded burst schedule —
    both compared policies face the *identical* fault pattern — while
    the forecast strategy estimates the hazard from the observable
    price trace (`preemption_rate_per_hr` is the estimator's base
    rate)."""
    register_policies(threshold_per_hr)
    cloud = CloudConfig(spot_rate_sigma=0.0, spin_up_sigma=0.0,
                        spin_up_mean_s=450.0,
                        preemption_model="replay",
                        preemption_rate_per_hr=rate_per_hr,
                        market=spiky_market(trace_dir))
    cfg = FLRunConfig(dataset="forecast_prewarm", clients=CLIENTS,
                      n_epochs=n_epochs, policy=policy, seed=seed)
    r = FLCloudRunner(cfg, cloud_cfg=cloud, sched_cfg=SCHED, record=True)
    res = r.run()
    return {"total_cost": res.total_cost,
            "spinup_gap_s": spinup_gap_s(r.recorder.records),
            "n_preemptions": res.n_preemptions,
            "lost_work_s": res.lost_work_s,
            "rounds_completed": res.rounds_completed,
            "makespan_s": res.makespan_s}


def compare(trace_dir: Union[str, Path] = DEFAULT_TRACE_DIR,
            n_epochs: int = 8, seed: int = 0,
            threshold_per_hr: float = 2.0
            ) -> Dict[str, Dict[str, float]]:
    """Both compositions on the identical seeded scenario."""
    return {name: run_policy(name, trace_dir, n_epochs, seed=seed,
                             threshold_per_hr=threshold_per_hr)
            for name in ("reactive_ckpt", "forecast_prewarm")}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--price-trace", metavar="DIR",
                    default=str(DEFAULT_TRACE_DIR),
                    help="spot-history fixture directory holding "
                         "spiky_early.csv")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threshold", type=float, default=2.0,
                    help="forecast hazard threshold (events/hour)")
    args = ap.parse_args(argv)

    results = compare(args.price_trace, args.epochs, args.seed,
                      args.threshold)
    print("policy,total_cost,spinup_gap_s,n_preemptions,lost_work_s,"
          "rounds_completed")
    for name, r in results.items():
        print(f"{name},{r['total_cost']:.4f},{r['spinup_gap_s']:.1f},"
              f"{r['n_preemptions']},{r['lost_work_s']:.1f},"
              f"{r['rounds_completed']}")
    rc, fc = results["reactive_ckpt"], results["forecast_prewarm"]
    assert rc["n_preemptions"] > 0, \
        "scenario must actually exercise reclaims"
    assert fc["spinup_gap_s"] < rc["spinup_gap_s"], \
        "forecast pre-warming must strictly reduce the spin-up gap"
    assert fc["total_cost"] <= rc["total_cost"], \
        "forecast pre-warming must not cost more than reactive handling"
    return results


if __name__ == "__main__":
    main()
