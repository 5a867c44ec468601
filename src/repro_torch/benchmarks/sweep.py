"""Monte-Carlo scenario sweep: policies x adversarial markets x
preemption models x seeds, aggregated into BENCH_sweep.json.

Fans the `repro_torch.sweep` grid out over a process pool (each cell one
deterministic `FLCloudRunner` run), summarizes every (policy, market,
model) cell across its seeds — mean, p10/p50/p90, seeded-bootstrap 95%
CI — and writes the canonical report plus a per-market ranking table.
Two runs of the same grid produce byte-identical JSON (no timestamps,
sorted keys, seeded bootstrap), so CI can diff the artifact itself as a
determinism check.

Flags (documented in benchmarks/README.md):
  --policies P [P ...]  policy columns (default: on_demand spot
                        fedcostaware)
  --markets M [M ...]   named sweep markets (default: all five)
  --models M [M ...]    preemption models crossed with every market
                        (default: each market's registered default)
  --engines E [E ...]   round-engine overrides crossed into the grid
                        (sync / async_buffered; default: each policy's
                        own engine)
  --seeds N             Monte-Carlo repetitions per cell
  --clients N           cross-silo pool size per run
  --epochs N            FL rounds per run
  --serial              disable the process pool (debugging / timing)
  --processes N         pool size (default: cpu_count)
  --out PATH            report path (default: BENCH_sweep.json)
  --metric NAME         ranking-table metric
  --assert-crunch-win   exit nonzero unless fedcostaware's mean cost
                        beats plain spot on capacity_crunch with
                        non-overlapping bootstrap CIs (the CI smoke
                        gate)
  --report              ranking tables for every metric + the pointer
                        to the per-trace audit CLI (repro_torch.cloud.report)
  --audit               record every cell's event stream and replay
                        each through the dollar-exact reconciler
                        (repro_torch.cloud.report); exit nonzero naming the
                        cell and its first divergent event on any
                        mismatch
  --audit-dir DIR       keep the recorded audit traces under DIR
                        (default: a temporary directory, deleted after
                        the audit)
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.sweep import build_grid, run_sweep
from repro_torch.sweep.report import build_report, dumps, ranking_table
from repro_torch.sweep.runner import METRICS
from repro_torch.sweep.spec import MARKETS, ScenarioSpec
from repro_torch.cloud.preemption import MODEL_NAMES

DEFAULT_POLICIES = ("on_demand", "spot", "fedcostaware")


def assert_crunch_win(report: dict) -> None:
    """The sweep's headline gate: on the capacity_crunch market,
    fedcostaware's mean cost must beat plain spot and the two bootstrap
    CIs must not overlap — a statistical win, not a lucky seed."""
    cells = report["cells"]
    fed = next((cells[k] for k in cells
                if k.startswith("fedcostaware|capacity_crunch|")), None)
    spot = next((cells[k] for k in cells
                 if k.startswith("spot|capacity_crunch|")), None)
    if fed is None or spot is None:
        raise SystemExit("--assert-crunch-win needs both fedcostaware "
                         "and spot on the capacity_crunch market")
    f, s = fed["cost"], spot["cost"]
    if not (f["mean"] < s["mean"] and f["ci_hi"] < s["ci_lo"]):
        raise SystemExit(
            f"crunch win not established: fedcostaware mean "
            f"{f['mean']:.4f} CI [{f['ci_lo']:.4f}, {f['ci_hi']:.4f}] "
            f"vs spot mean {s['mean']:.4f} CI "
            f"[{s['ci_lo']:.4f}, {s['ci_hi']:.4f}]")
    print(f"# crunch win: fedcostaware {f['mean']:.4f} "
          f"[{f['ci_lo']:.4f}, {f['ci_hi']:.4f}] < spot {s['mean']:.4f} "
          f"[{s['ci_lo']:.4f}, {s['ci_hi']:.4f}] (CIs disjoint)")


def audit_cells(specs: Sequence[ScenarioSpec]) -> None:
    """Replay every recorded cell trace through the dollar-exact
    reconciler (`repro_torch.cloud.report.reconcile_path`). A Monte-Carlo
    mean is only as trustworthy as each settled cell behind it, so one
    divergent cell fails the whole sweep — the exit names the cell's
    grid coordinates and the first event at which its category folds
    disagreed."""
    from repro_torch.cloud.report import RECONCILE_TOL, reconcile_path
    failures = []
    for s in specs:
        rec = reconcile_path(s.trace_path())
        if not rec.ok:
            failures.append(f"{s.cell_slug()}: {rec.first_divergence}")
    if failures:
        raise SystemExit(
            f"audit failed for {len(failures)}/{len(specs)} cells:\n  "
            + "\n  ".join(failures))
    print(f"# audit: {len(specs)}/{len(specs)} cells reconciled "
          f"dollar-exact (tol {RECONCILE_TOL:.0e})")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--policies", nargs="+", default=list(DEFAULT_POLICIES),
                    help="policy columns of the grid")
    ap.add_argument("--markets", nargs="+", default=sorted(MARKETS),
                    choices=sorted(MARKETS),
                    help="named sweep markets (repro_torch.sweep.spec.MARKETS)")
    ap.add_argument("--models", nargs="+", default=None,
                    choices=list(MODEL_NAMES),
                    help="preemption models crossed with every market "
                         "(default: per-market registered default)")
    ap.add_argument("--engines", nargs="+", default=None,
                    choices=["sync", "async_buffered"],
                    help="round-engine overrides crossed into the grid "
                         "(default: each policy's own engine)")
    ap.add_argument("--seeds", type=int, default=5,
                    help="Monte-Carlo repetitions per cell")
    ap.add_argument("--clients", type=int, default=8,
                    help="cross-silo pool size per run")
    ap.add_argument("--epochs", type=int, default=6,
                    help="FL rounds per run")
    ap.add_argument("--serial", action="store_true",
                    help="run cells in-process instead of a pool")
    ap.add_argument("--processes", type=int, default=None,
                    help="process-pool size (default: cpu_count)")
    ap.add_argument("--out", default="BENCH_sweep.json",
                    help="report output path")
    ap.add_argument("--metric", default="cost", choices=list(METRICS),
                    help="ranking-table metric")
    ap.add_argument("--assert-crunch-win", action="store_true",
                    help="fail unless fedcostaware beats spot on "
                         "capacity_crunch with disjoint CIs")
    ap.add_argument("--report", action="store_true",
                    help="print the ranking table for every metric "
                         "(not just --metric) plus the pointer to the "
                         "per-trace audit CLI, repro_torch.cloud.report")
    ap.add_argument("--audit", action="store_true",
                    help="record every cell and replay it through the "
                         "dollar-exact reconciler; nonzero exit naming "
                         "the cell and first divergent event on any "
                         "mismatch")
    ap.add_argument("--audit-dir", metavar="DIR", default=None,
                    help="keep the recorded audit traces under DIR "
                         "(default: a temporary directory deleted "
                         "after the audit)")
    args = ap.parse_args(argv)

    specs = build_grid(args.policies, args.markets,
                       seeds=range(args.seeds), models=args.models,
                       n_clients=args.clients, n_epochs=args.epochs,
                       engines=args.engines)
    audit_tmp = None
    if args.audit:
        audit_dir = args.audit_dir
        if audit_dir is None:
            audit_tmp = tempfile.mkdtemp(prefix="sweep_audit_")
            audit_dir = audit_tmp
        Path(audit_dir).mkdir(parents=True, exist_ok=True)
        specs = [dataclasses.replace(s, record_dir=str(audit_dir))
                 for s in specs]
    engines_part = (f" x {len(args.engines)} engines"
                    if args.engines else "")
    print(f"# sweep: {len(specs)} cells "
          f"({len(args.policies)} policies x {len(args.markets)} markets"
          f"{engines_part} x {args.seeds} seeds)")
    results = run_sweep(specs, parallel=not args.serial,
                        processes=args.processes)
    report = build_report(specs, results)
    out = Path(args.out)
    out.write_text(dumps(report))
    print(f"# wrote {out} ({len(report['cells'])} cells)")
    if args.report:
        for metric in METRICS:
            print(ranking_table(report, metric=metric))
        print("# per-trace dollar audit: record runs with "
              "`python -m repro_torch.benchmarks.table1 --record-dir DIR` "
              "and inspect them with `python -m repro_torch.cloud.report "
              "summary/trends/reconcile` (docs/reporting.md)")
    else:
        print(ranking_table(report, metric=args.metric))
    if args.audit:
        try:
            audit_cells(specs)
        finally:
            if audit_tmp is not None:
                shutil.rmtree(audit_tmp, ignore_errors=True)
    if args.assert_crunch_win:
        assert_crunch_win(report)
    return report


if __name__ == "__main__":
    main()
