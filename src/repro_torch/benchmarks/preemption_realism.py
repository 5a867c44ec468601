"""Preemption realism + notice-aware checkpointing: cost and lost-work
under flat, price-coupled, and replayed-interruption reclaim models.

Two claims, both asserted by tests/test_preemption_realism.py:

  (a) Under the price-coupled model (`CloudConfig.
      preemption_model="price_coupled"`), interruptions concentrate
      into trace price spikes: the mean spot price observed at the
      reclaim instants is well above the zone's time-averaged price
      (`interruption_price_lift`, driven by the
      tests/fixtures/prices/spiky.csv market day).
  (b) Notice-aware checkpointing strictly reduces lost client-seconds
      *and* total dollars vs periodic-only checkpointing
      (`compare_modes`, a pinned replayed-interruption scenario where
      a recorded reclaim lands mid-epoch inside a 120 s AWS-style
      warning window while the periodic checkpoint cadence is coarse).

The default report runs (b) across every preemption model x every
`on_warning` engine policy and prints one table row per combination.

Flags (documented in benchmarks/README.md):
  --price-trace DIR   spot-history fixture directory
  --model NAME        constant | price_coupled | replay (default: all)
  --on-warning MODE   ignore | checkpoint | drain (default: all)
  --policy NAME       spot | fedcostaware | fedcostaware_async
  --epochs N          FL rounds in the pinned scenario
  --seed N            simulator seed
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.common.config import (ClientProfile, CloudConfig, FLRunConfig,
                                 MarketConfig, ProviderConfig,
                                 SchedulerConfig)
from repro_torch.cloud.simulator import CloudSimulator
from repro_torch.core.events import InstancePreempted
from repro_torch.fl.runner import FLCloudRunner

# the checkout's price fixtures (this file is
# src/repro_torch/benchmarks/preemption_realism.py), read in place
DEFAULT_TRACE_DIR = (Path(__file__).resolve().parents[3]
                     / "tests" / "fixtures" / "prices")
MODELS = ("constant", "price_coupled", "replay")
MODES = ("ignore", "checkpoint", "drain")

# Pinned scenario: two pinned-zone clients on the real aws.csv market
# day; the recorded reclaim at t=700 s (aws.interruptions.csv) lands
# ~550 s into client a's 900 s epoch. The periodic checkpoint cadence
# is deliberately coarse (600 s), so without the 120 s notice the whole
# epoch-so-far is lost.
CLIENTS = (
    ClientProfile("a", mean_epoch_s=900.0, jitter=0.0, n_samples=2,
                  zone="us-east-1a"),
    ClientProfile("b", mean_epoch_s=400.0, jitter=0.0, n_samples=1,
                  zone="us-east-1b"),
)
SCHED = SchedulerConfig(checkpoint_every_s=600.0, warning_ckpt_write_s=10.0)


def notice_market(trace_dir: Union[str, Path],
                  notice_s: float = 120.0,
                  sensitivity: float = 4.0) -> MarketConfig:
    """The aws.csv market day with an AWS-style reclaim notice and the
    recorded interruption schedule attached."""
    trace_dir = Path(trace_dir)
    return MarketConfig(providers=(ProviderConfig(
        name="aws",
        price_trace=str(trace_dir / "aws.csv"),
        interruption_trace=str(trace_dir / "aws.interruptions.csv"),
        preemption_notice_s=notice_s,
        preemption_price_sensitivity=sensitivity),))


def run_mode(model: str, mode: str,
             trace_dir: Union[str, Path] = DEFAULT_TRACE_DIR,
             policy: str = "spot", n_epochs: int = 3,
             rate_per_hr: float = 2.0, seed: int = 0) -> Dict[str, float]:
    """One pinned run: preemption `model` x engine `on_warning` mode.
    Returns total cost, lost client-seconds, reclaim count, rounds."""
    cloud = CloudConfig(spot_rate_sigma=0.0, spin_up_sigma=0.0,
                        preemption_model=model,
                        preemption_rate_per_hr=rate_per_hr,
                        market=notice_market(trace_dir))
    cfg = FLRunConfig(dataset="preemption_realism", clients=CLIENTS,
                      n_epochs=n_epochs, policy=policy, seed=seed,
                      on_warning=mode)
    res = FLCloudRunner(cfg, cloud_cfg=cloud, sched_cfg=SCHED).run()
    return {"total_cost": res.total_cost,
            "lost_work_s": res.lost_work_s,
            "n_preemptions": res.n_preemptions,
            "rounds_completed": res.rounds_completed}


def compare_modes(model: str = "replay",
                  trace_dir: Union[str, Path] = DEFAULT_TRACE_DIR,
                  policy: str = "spot", n_epochs: int = 3,
                  seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Claim (b): the pinned scenario across every `on_warning` mode
    under one preemption model. With the recorded mid-epoch reclaim,
    "checkpoint" strictly beats "ignore" on both lost work and cost,
    and "drain" additionally stops paying for the doomed instance."""
    return {mode: run_mode(model, mode, trace_dir, policy, n_epochs,
                           seed=seed)
            for mode in MODES}


def interruption_price_lift(trace_dir: Union[str, Path] = DEFAULT_TRACE_DIR,
                            sensitivity: float = 8.0,
                            rate_per_hr: float = 1.0,
                            horizon_s: float = 48 * 3600.0,
                            seed: int = 0) -> Dict[str, float]:
    """Claim (a): keep one spot probe instance alive on the spiky.csv
    market day under the price-coupled model and measure where the
    reclaims land. Returns the interruption count, the mean price at
    the reclaim instants, the zone's time-averaged price, and their
    ratio (`lift` — > 1 means interruptions cluster in spikes)."""
    zone = "us-east-1a"
    market = MarketConfig(providers=(ProviderConfig(
        name="spiky", price_trace=str(Path(trace_dir) / "spiky.csv"),
        preemption_price_sensitivity=sensitivity),))
    cloud = CloudConfig(preemption_model="price_coupled",
                        preemption_rate_per_hr=rate_per_hr,
                        spin_up_sigma=0.0, market=market)
    sim = CloudSimulator(cloud, seed=seed)
    hit_times = []

    def replace(ev):
        hit_times.append(ev.t)
        if ev.t < horizon_s:
            sim.request_instance("probe", zone=zone)

    sim.bus.subscribe(InstancePreempted, replace)
    sim.request_instance("probe", zone=zone)
    sim.run_until_idle(t_max=horizon_s)

    mean_ref = sim.market.mean_spot_price(zone)
    if hit_times:
        at_hits = sum(sim.market.spot_price(zone, t)
                      for t in hit_times) / len(hit_times)
    else:
        at_hits = 0.0
    return {"n_interruptions": len(hit_times),
            "mean_price_at_interrupt": at_hits,
            "mean_price": mean_ref,
            "lift": at_hits / mean_ref if mean_ref else 0.0}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--price-trace", metavar="DIR",
                    default=str(DEFAULT_TRACE_DIR),
                    help="spot-history fixture directory holding "
                         "aws.csv, aws.interruptions.csv and spiky.csv")
    ap.add_argument("--model", default=None, choices=MODELS,
                    help="run a single preemption model (default: all)")
    ap.add_argument("--on-warning", default=None, choices=MODES,
                    help="run a single engine warning mode "
                         "(default: all)")
    ap.add_argument("--policy", default="spot",
                    choices=["spot", "fedcostaware",
                             "fedcostaware_async"])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    lift = interruption_price_lift(args.price_trace)
    print(f"# price-coupled interruptions on spiky.csv: "
          f"{lift['n_interruptions']} reclaims, mean price at reclaim "
          f"{lift['mean_price_at_interrupt']:.3f} vs time-avg "
          f"{lift['mean_price']:.3f} (lift {lift['lift']:.2f}x)")
    assert lift["n_interruptions"] > 0
    assert lift["lift"] > 1.2, \
        "price-coupled interruptions must cluster in price spikes"

    models = [args.model] if args.model else list(MODELS)
    modes = [args.on_warning] if args.on_warning else list(MODES)
    print("model,on_warning,total_cost,lost_work_s,n_preemptions,"
          "rounds_completed")
    results = {}
    for model in models:
        for mode in modes:
            r = run_mode(model, mode, args.price_trace, args.policy,
                         args.epochs, seed=args.seed)
            results[(model, mode)] = r
            print(f"{model},{mode},{r['total_cost']:.4f},"
                  f"{r['lost_work_s']:.1f},{r['n_preemptions']},"
                  f"{r['rounds_completed']}")
    if "replay" in models and {"ignore", "checkpoint"} <= set(modes):
        ign, ck = results[("replay", "ignore")], \
            results[("replay", "checkpoint")]
        assert ck["lost_work_s"] < ign["lost_work_s"], \
            "notice-aware checkpointing must reduce lost client-seconds"
        assert ck["total_cost"] < ign["total_cost"], \
            "notice-aware checkpointing must reduce total cost"
    return results


if __name__ == "__main__":
    main()
