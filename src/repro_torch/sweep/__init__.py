"""Monte-Carlo scenario sweep: deterministic fan-out of policies x
markets x preemption models x seeds.

One seeded benchmark run answers "what did policy P cost on market M
once"; the paper's claim is statistical — FedCostAware should win *in
expectation, with a margin wider than the noise*. This package turns
that claim into a measured grid:

  spec    — `ScenarioSpec`, the picklable coordinates of one cell run
            (policy, named market, preemption model, seed, run shape),
            plus the registry of named sweep markets (the adversarial
            generators of `repro_torch.cloud.scenarios` over a shared
            2-provider base).
  runner  — `run_cell` (one deterministic `FLCloudRunner` run per
            spec) and `run_sweep` (serial or `multiprocessing` fan-out
            with order-stable results — parallel output is
            byte-identical to serial).
  stats   — mean / percentile / seeded-bootstrap-CI summaries per
            (policy, market) cell across seeds.
  report  — the deterministic `BENCH_sweep.json` payload (sorted keys,
            no timestamps; two identical sweeps diff clean) and the
            human-readable per-market ranking table.

`benchmarks/sweep.py` is the CLI; docs/sweep.md documents the spec
format, the JSON schema and the CI thresholds.
"""
from repro_torch.sweep.spec import (MARKETS, ScenarioSpec, build_grid,
                              market_config)
from repro_torch.sweep.runner import run_cell, run_sweep
from repro_torch.sweep.stats import bootstrap_ci, summarize
from repro_torch.sweep.report import build_report, ranking_table

__all__ = ["MARKETS", "ScenarioSpec", "build_grid", "market_config",
           "run_cell", "run_sweep", "bootstrap_ci", "summarize",
           "build_report", "ranking_table"]
