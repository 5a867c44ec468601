"""Cell execution + fan-out for the Monte-Carlo sweep.

`run_cell` is a pure function of its `ScenarioSpec`: it builds the
named market, a seeded client pool and one `FLCloudRunner`, runs it,
and returns plain-scalar metrics. Purity is what makes the sweep both
deterministic (same spec -> same numbers, pinned by tests/test_sweep.py
down to the serialized report) and trivially parallel — `run_sweep`
fans cells over a `multiprocessing` pool and `Pool.map` preserves
submission order, so the parallel result list is byte-identical to the
serial one.

The pool uses the "spawn"-safe module-level worker (`run_cell` itself);
workers re-import this module rather than inheriting interpreter state,
so nothing about the parent process can leak into a cell.

The port starts its workers with "spawn", never "fork" (Linux's
default): its simulator imports torch at import time
(`common/config.py`), and a parent that has torch loaded, or CUDA up,
must not be forked. Each worker starts a fresh interpreter and imports
this module. A cell's result is a pure function of its spec, so the
list is the one "fork" or serial execution gives.
"""
from __future__ import annotations

import multiprocessing
from typing import Dict, List, Optional, Sequence

from repro_torch.common.config import ClientProfile, CloudConfig, FLRunConfig
from repro_torch.sweep.spec import ScenarioSpec, market_config

# every metric a cell reports; stats/report aggregate exactly these
METRICS = ("cost", "makespan_s", "lost_work_s", "n_preemptions")


def _clients(spec: ScenarioSpec):
    """A heterogeneous cross-silo pool: epoch times spread over a ~2x
    range (deterministic in the index, so every cell of a sweep trains
    the same workload; per-seed variation comes from the run's jitter
    and the market's scenario draw)."""
    return tuple(
        ClientProfile(name=f"c{i}",
                      mean_epoch_s=600.0 + 90.0 * (i % 7),
                      cold_multiplier=1.15, jitter=0.08)
        for i in range(spec.n_clients))


def run_cell(spec: ScenarioSpec) -> Dict[str, float]:
    """One deterministic run at the spec's coordinates -> metric dict
    (plain floats, picklable). The run seed and the scenario seed are
    both `spec.seed`: each Monte-Carlo repetition re-draws the client
    jitter *and* the adversarial market weather. A spec with
    `record_dir` set also persists the cell's event stream to
    `spec.trace_path()` for the sweep's `--audit` reconciliation."""
    from repro_torch.fl.runner import FLCloudRunner  # deferred: worker import
    cloud = CloudConfig(
        market=market_config(spec.market, spec.seed),
        preemption_model=spec.preemption_model,
        preemption_rate_per_hr=spec.preemption_rate_per_hr)
    cfg = FLRunConfig(dataset="sweep", clients=_clients(spec),
                      n_epochs=spec.n_epochs, policy=spec.policy,
                      engine=(spec.engine or None), seed=spec.seed)
    res = FLCloudRunner(cfg, cloud_cfg=cloud,
                        record_to=spec.trace_path()).run()
    return {
        "cost": float(res.total_cost),
        "makespan_s": float(res.makespan_s),
        "lost_work_s": float(res.lost_work_s),
        "n_preemptions": float(res.n_preemptions),
    }


def run_sweep(specs: Sequence[ScenarioSpec], parallel: bool = True,
              processes: Optional[int] = None) -> List[Dict[str, float]]:
    """Run every spec; results align with `specs` by index. `parallel`
    fans out over a process pool (capped at the grid size); serial mode
    produces the identical list — the equivalence tests pin that, and
    the speedup benchmark measures the gap on multi-core hosts."""
    specs = list(specs)
    if not parallel or len(specs) <= 1:
        return [run_cell(s) for s in specs]
    n_proc = processes or multiprocessing.cpu_count()
    n_proc = max(1, min(n_proc, len(specs)))
    if n_proc == 1:
        return [run_cell(s) for s in specs]
    with multiprocessing.get_context("spawn").Pool(n_proc) as pool:
        return pool.map(run_cell, specs)
