"""Deterministic sweep report: the BENCH_sweep.json payload and the
human-readable per-market ranking table.

The JSON is a pure function of (specs, results): sorted keys, no
timestamps, no host information — two identical sweeps diff clean,
which is what lets CI treat the artifact itself as a determinism check.
Schema (documented in docs/sweep.md):

  {
    "grid": {"policies": [...], "markets": [...], "models": [...],
             "engines": [...], "seeds": [...],
             "n_clients": N, "n_epochs": N},
    "cells": {
      "<policy>|<market>|<model>": {
        "<metric>": {mean, p10, p50, p90, ci_lo, ci_hi, n}, ...
      }, ...
    }
  }

Cells swept with an explicit engine override carry a fourth key part,
`<policy>|<market>|<model>|<engine>`; default-engine cells keep the
3-part key, so pre-engine-axis reports diff clean against new ones.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Sequence

from repro_torch.sweep.runner import METRICS
from repro_torch.sweep.spec import ScenarioSpec
from repro_torch.sweep.stats import summarize


def cell_key(spec: ScenarioSpec) -> str:
    """The report key of a spec's (policy, market, model[, engine])
    cell. The engine part appears only when the spec pins one, keeping
    default-engine keys (and every pre-engine-axis report) unchanged."""
    key = f"{spec.policy}|{spec.market}|{spec.preemption_model}"
    if spec.engine:
        key += f"|{spec.engine}"
    return key


def build_report(specs: Sequence[ScenarioSpec],
                 results: Sequence[Dict[str, float]]) -> Dict:
    """Aggregate aligned (spec, result) pairs into the report dict:
    group by cell, summarize each metric across the cell's seeds.
    Deterministic — the bootstrap seed is derived from the cell key, so
    the same grid always yields the same CIs."""
    if len(specs) != len(results):
        raise ValueError(f"{len(specs)} specs vs {len(results)} results")
    by_cell: Dict[str, List[Dict[str, float]]] = defaultdict(list)
    seeds_by_cell: Dict[str, List[int]] = defaultdict(list)
    for spec, res in zip(specs, results):
        by_cell[cell_key(spec)].append(res)
        seeds_by_cell[cell_key(spec)].append(spec.seed)
    cells = {}
    for key in sorted(by_cell):
        rows = by_cell[key]
        boot_seed = hash_seed(key)
        cells[key] = {
            m: summarize([r[m] for r in rows], seed=boot_seed)
            for m in METRICS}
        cells[key]["seeds"] = sorted(seeds_by_cell[key])
    return {
        "grid": {
            "policies": sorted({s.policy for s in specs}),
            "markets": sorted({s.market for s in specs}),
            "models": sorted({s.preemption_model for s in specs}),
            "engines": sorted({s.engine for s in specs}),
            "seeds": sorted({s.seed for s in specs}),
            "n_clients": specs[0].n_clients if specs else 0,
            "n_epochs": specs[0].n_epochs if specs else 0,
        },
        "cells": cells,
    }


def hash_seed(key: str) -> int:
    """Stable (non-PYTHONHASHSEED) bootstrap seed from a cell key."""
    h = 0
    for ch in key:
        h = (h * 131 + ord(ch)) % (2 ** 31 - 1)
    return h


def dumps(report: Dict) -> str:
    """Canonical serialization: sorted keys, fixed separators — the
    bytes CI diffs between two runs of the same grid."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


def ranking_table(report: Dict, metric: str = "cost") -> str:
    """Per-market policy ranking by mean `metric`, cheapest first, with
    the bootstrap CI alongside — the terminal summary `benchmarks/
    sweep.py` prints."""
    by_market: Dict[str, List] = defaultdict(list)
    for key, cell in report["cells"].items():
        policy, market, model, *rest = key.split("|")
        engine = rest[0] if rest else ""
        label = f"{policy}[{engine}]" if engine else policy
        s = cell[metric]
        by_market[market].append((s["mean"], label, model, s))
    lines = []
    for market in sorted(by_market):
        lines.append(f"{market}:")
        for rank, (mean, label, model, s) in enumerate(
                sorted(by_market[market]), start=1):
            lines.append(
                f"  {rank}. {label:<20} {mean:>10.4f} "
                f"[{s['ci_lo']:.4f}, {s['ci_hi']:.4f}]  "
                f"(p10 {s['p10']:.4f} / p90 {s['p90']:.4f}, "
                f"model={model}, n={s['n']})")
    return "\n".join(lines)
