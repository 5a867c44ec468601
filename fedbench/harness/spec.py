"""Find what a cell needs by the names in `BENCHMARK.json`.

A cell names a configuration (its `file` under `configs`) and a traffic
mix (`fedbench/traffic/<mix>.json`); a configuration names its model
family (`fedbench/families/<family>.py`); a cell's correctness limits lie
in `fedbench/limits/<cell>.json`; a per-layer metric's reader is
`fedbench/metrics/<metric>.py`; the card's published peaks are
`fedbench/peaks/<card name, spaces as _>.json`. A new cell, mix,
configuration, family or metric is new files and new entries, never an
edit.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    """A name that `BENCHMARK.json` or the benchmark's files do not hold."""


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r}; known: "
                    f"{[w['name'] for w in spec['workloads']]}")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _load_json(root / c["file"])
    raise SpecError(f"no configuration {name!r}")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _load_json(bench_dir / "traffic" / f"{name}.json")


def limits(cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _load_json(bench_dir / "limits" / f"{cell_name}.json")


def peaks(device_kind: str, bench_dir: Path = BENCH_DIR) -> Optional[dict]:
    """The card's published peaks, or None for a card the table lacks."""
    path = bench_dir / "peaks" / f"{device_kind.replace(' ', '_')}.json"
    return json.loads(path.read_text()) if path.is_file() else None


def _module(path: Path, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The `read(ctx)` function of a per-layer metric's own file."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"no reader for the metric {metric!r} at "
                        f"{path.relative_to(ROOT)}")
    return _module(path, f"fedbench_metric_{metric.replace('.', '_')}").read


def family(cfg: dict, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module of the model family that a configuration names under
    `"family"`: `dims`, `schema`, `INITS`, `loss`, `model_flops` and
    `port_config` (see `fedbench/families/dense.py`)."""
    name = cfg.get("family")
    if name is None:
        raise SpecError(f"the configuration {cfg.get('name')!r} names no "
                        f"family")
    path = bench_dir / "families" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no family {name!r}: {path} is missing")
    return _module(path, f"fedbench_family_{name.replace('.', '_')}")


def end_to_end(spec: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics the cell reports: those that list it, and
    those without a list."""
    return [m for m in spec["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(spec: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics the cell reports: those whose `workloads`
    list names it."""
    return [m for m in spec["per_layer"] if cell_name in m["workloads"]]
