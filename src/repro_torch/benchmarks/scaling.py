"""Scaling study for the struct-of-arrays fleet core, plus the original
beyond-paper savings-vs-skew experiment (paper future-work §V).

Default mode times fleet-path runs over growing client populations
(10^2 .. 10^5, the last as a sampled-cohort cross-device round) and
writes `build/BENCH_scaling_torch.json` under the checkout (never the
JAX package's root `BENCH_scaling.json`) with one
`{n_clients, wall_s, peak_rss_mb, cost}` row per size.  A per-object
reference run at `--per-object-at` clients pins the speedup ratio the
fleet core buys (tests/test_torch_benchmarks.py asserts >= 20x at
10^4).

`--savings` instead runs the legacy savings-vs-pool-size/skew CSV
report comparing plain spot against FedCostAware.
"""
from __future__ import annotations

import argparse
import json
import platform
import resource
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.cloud.fleet import ClientArrays
from repro_torch.common.config import (ClientProfile, CloudConfig, FLRunConfig,
                                 PopulationConfig)
from repro_torch.fl.runner import FLCloudRunner

CLOUD = CloudConfig(spot_rate_sigma=0.0)
# under the checkout's build/ (this file is
# src/repro_torch/benchmarks/scaling.py)
DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "build"
               / "BENCH_scaling_torch.json")
DEFAULT_SIZES = (100, 1_000, 10_000, 100_000)
# populations at or above this size run as sampled cohorts (cross-device
# mode) instead of full participation, so the 100k row exercises the
# cohort sampler the way a real cross-device deployment would
COHORT_ABOVE = 100_000
COHORT_SIZE = 10_000


def _peak_rss_mb() -> float:
    """Process high-water RSS in MiB (`ru_maxrss` is KiB on Linux).

    A high-water mark only ever rises, so per-row values are a running
    maximum over all sizes run so far in this process — run sizes in
    increasing order (the default) to read the column as a curve.
    """
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def run_fleet(n_clients: int, n_epochs: int = 3, seed: int = 0,
              cohort_size=None) -> dict:
    """Time one fleet-path "spot" run over an `n_clients` population."""
    pop = PopulationConfig(n_clients=n_clients, seed=seed)
    cfg = FLRunConfig(dataset="scal", clients=(), n_epochs=n_epochs,
                      policy="spot", population=pop,
                      cohort_size=cohort_size, seed=seed)
    t0 = time.perf_counter()
    res = FLCloudRunner(cfg, cloud_cfg=CLOUD).run()
    return {"n_clients": n_clients, "wall_s": time.perf_counter() - t0,
            "peak_rss_mb": _peak_rss_mb(), "cost": res.total_cost,
            "cohort_size": cohort_size, "path": "fleet"}


def run_per_object(n_clients: int, n_epochs: int = 3, seed: int = 0) -> dict:
    """Time the legacy per-object path on the *same* client population
    the fleet path would expand (materialized as `ClientProfile`s)."""
    arr = ClientArrays.from_population(
        PopulationConfig(n_clients=n_clients, seed=seed))
    clients = tuple(
        ClientProfile(arr.name(i), float(arr.warm_mean[i]),
                      cold_multiplier=float(arr.cold_mult[i]),
                      jitter=float(arr.jitter[i]))
        for i in range(arr.n))
    cfg = FLRunConfig(dataset="scal", clients=clients, n_epochs=n_epochs,
                      policy="spot", fleet=False, seed=seed)
    t0 = time.perf_counter()
    res = FLCloudRunner(cfg, cloud_cfg=CLOUD).run()
    return {"n_clients": n_clients, "wall_s": time.perf_counter() - t0,
            "peak_rss_mb": _peak_rss_mb(), "cost": res.total_cost,
            "cohort_size": None, "path": "per_object"}


def scaling_report(sizes, n_epochs: int = 3, seed: int = 0,
                   per_object_at=10_000) -> dict:
    """Run the curve and return the `BENCH_scaling_torch.json`
    payload."""
    rows = []
    for n in sizes:
        cohort = COHORT_SIZE if n >= COHORT_ABOVE else None
        row = run_fleet(n, n_epochs=n_epochs, seed=seed, cohort_size=cohort)
        rows.append(row)
        print(f"fleet      n={n:>7} wall={row['wall_s']:8.3f}s "
              f"rss={row['peak_rss_mb']:7.1f}MiB cost=${row['cost']:.2f}"
              + (f" cohort={cohort}" if cohort else ""))
    report = {
        "meta": {
            "policy": "spot", "n_epochs": n_epochs, "seed": seed,
            "cohort_above": COHORT_ABOVE, "cohort_size": COHORT_SIZE,
            "python": platform.python_version(),
            "numpy": np.__version__,
            "note": "peak_rss_mb is a process high-water mark, "
                    "monotone across rows",
        },
        "rows": rows,
    }
    if per_object_at:
        ref = run_per_object(per_object_at, n_epochs=n_epochs, seed=seed)
        print(f"per-object n={per_object_at:>7} wall={ref['wall_s']:8.3f}s")
        report["per_object"] = ref
        fleet_wall = next((r["wall_s"] for r in rows
                           if r["n_clients"] == per_object_at), None)
        if fleet_wall:
            report["meta"]["speedup_at_per_object_n"] = (
                ref["wall_s"] / fleet_wall)
            print(f"speedup at n={per_object_at}: "
                  f"{report['meta']['speedup_at_per_object_n']:.1f}x")
    return report


# ---------------------------------------------------------------- savings
def run_pool(n_clients, skew, n_epochs=10, seed=0):
    """skew: ratio slowest/fastest epoch time (log-spaced in between)."""
    times = np.exp(np.linspace(np.log(900.0), np.log(900.0 / skew),
                               n_clients))
    clients = tuple(ClientProfile(f"c{i}", float(t), jitter=0.0)
                    for i, t in enumerate(times))
    costs = {}
    for policy in ("spot", "fedcostaware"):
        cfg = FLRunConfig(dataset="scal", clients=clients,
                          n_epochs=n_epochs, policy=policy, seed=seed)
        costs[policy] = FLCloudRunner(cfg, cloud_cfg=CLOUD).run().total_cost
    return costs


def oracle_lower_bound(n_clients, skew, n_epochs=10):
    """Work-conserving lower bound: every client billed only for its own
    training seconds (what an algorithm-level rebalancer like FedCompass
    could at best achieve, at the cost of changing the FL semantics the
    paper deliberately preserves)."""
    times = np.exp(np.linspace(np.log(900.0), np.log(900.0 / skew),
                               n_clients))
    rate = CLOUD.spot_rate_mean * 0.98   # cheapest zone
    return float(times.sum()) * n_epochs * rate / 3600.0


def savings_report():
    """Legacy CSV report: extra savings vs spot across pool size/skew."""
    print("n_clients,skew,spot_cost,fca_cost,extra_savings_vs_spot_pct,"
          "oracle_cost,fca_gap_to_oracle_pct")
    for n in (3, 6, 12, 24):
        for skew in (1.5, 3.0, 6.0):
            c = run_pool(n, skew)
            extra = 100 * (1 - c["fedcostaware"] / c["spot"])
            lb = oracle_lower_bound(n, skew)
            gap = 100 * (c["fedcostaware"] / lb - 1)
            print(f"{n},{skew},{c['spot']:.3f},"
                  f"{c['fedcostaware']:.3f},{extra:.1f},{lb:.3f},{gap:.1f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default=",".join(str(s) for s in DEFAULT_SIZES),
                   help="comma-separated population sizes for the fleet "
                        "curve (default: 100,1000,10000,100000)")
    p.add_argument("--rounds", type=int, default=3,
                   help="FL rounds per timed run (default 3)")
    p.add_argument("--seed", type=int, default=0,
                   help="run + population seed (default 0)")
    p.add_argument("--per-object-at", type=int, default=10_000,
                   help="also time the per-object path at this size for "
                        "the speedup ratio; 0 disables (default 10000)")
    p.add_argument("--out", type=Path, default=DEFAULT_OUT,
                   help="where to write the report (default: "
                        "build/BENCH_scaling_torch.json in the checkout)")
    p.add_argument("--savings", action="store_true",
                   help="run the legacy savings-vs-skew CSV report "
                        "instead of the fleet scaling curve")
    args = p.parse_args(argv)

    if args.savings:
        savings_report()
        return 0

    sizes = sorted(int(s) for s in args.sizes.split(",") if s)
    report = scaling_report(sizes, n_epochs=args.rounds, seed=args.seed,
                            per_object_at=args.per_object_at)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
