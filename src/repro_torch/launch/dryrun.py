"""Dry run on the meta device: every (arch x shape) cell's FULL step,
counted, with its specs resolved on the production meshes. The port of
the JAX package's `launch/dryrun.py`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both --peak-flops 989e12 --hbm-bw 3.35e12

The JAX package lowers and compiles each cell for a mesh of 512 fake
devices and reads the compiled program's memory, cost and collective
analyses. The port runs each cell's step (`launch/steps.py::step_for`)
eagerly on meta tensors (`configs/shapes.py::input_specs`, shapes and
dtypes, no data) under `launch/roofline.py::WorkCounter`: the forward and
the backward with remat for train, the forward for prefill, one decode
step. Nothing is allocated, and the kernel wrappers add their work
without launching. So:

  - the counts are the whole program's on one device: the mesh changes
    the specs, not what one device would run, and per-chip counts of a
    512-chip program the port cannot run are not made up;
  - the specs are resolved on the chosen mesh (`sharding/rules.py`), and
    the per-device argument and output bytes (the `memory` entry, the
    stand-in for `memory_analysis`) divide each leaf's bytes by its
    shard factor;
  - `compile_s` holds the meta run's seconds (nothing compiles);
  - collective bytes are those `fl/mesh_fl.py` counts (`--fl-agg`,
    `--fl-round`), over n_pods stacked clients.

The peaks are the caller's: `--peak-flops` and `--hbm-bw` (and
`--link-bw` for the collective term), or `--device cuda`, which measures
them on the card (`fl/training.py::_measure_peaks`). Records keep the
JAX package's keys, and go to `--out` (default build/dryrun_torch.json),
merged with the records already there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.common.bridge import flatten_with_paths, tree_map
from repro_torch.common.config import SHAPES
from repro_torch.configs.shapes import input_specs
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RF
from repro_torch.launch import steps as ST
from repro_torch.models import lm
from repro_torch.optim import optimizers
from repro_torch.sharding import rules as R

# the FL cells' sizes, the JAX package's
FL_ARCH, FL_B_LOCAL, FL_SEQ, FL_LOCAL_STEPS, FL_OPT = \
    "phi3-mini-3.8b", 16, 4096, 4, 3e-4


def abstract_opt_state(cfg):
    return optimizers.adamw().init(lm.abstract_params(cfg))


def cell_args(cfg, shape):
    """The positional arguments of the cell's step, on meta."""
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        return (lm.abstract_params(cfg), abstract_opt_state(cfg),
                specs["batch"])
    if shape.kind == "prefill":
        return tuple([lm.abstract_params(cfg), specs["tokens"]]
                     + ([specs["cond"]] if cfg.family == "vlm" else []))
    return (lm.abstract_params(cfg), specs["tokens"], specs["pos"],
            specs["cache"])


def per_device_bytes(tree, spec_tree, mesh) -> int:
    """Bytes of `tree`'s tensors on one device when each is laid out by
    its spec in `spec_tree` (a spec standing for a whole subtree is a
    prefix); a tensor's bytes are divided by its shard factor."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes // R.shard_factor(spec_tree, mesh)
    if R.is_spec(spec_tree):
        return sum(per_device_bytes(t, spec_tree, mesh)
                   for _, t in flatten_with_paths(tree))
    if isinstance(tree, dict):
        return sum(per_device_bytes(tree[k], spec_tree[k], mesh)
                   for k in tree)
    return sum(per_device_bytes(t, s, mesh) for t, s in zip(tree, spec_tree))


def count_cell(arch: str, shape_name: str):
    """Run the cell's step on meta under `WorkCounter`: (counter, seconds,
    the step's outputs)."""
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    step, _, _ = ST.step_for(cfg, shape, M.make_cpu_mesh())
    args = cell_args(cfg, shape)
    t0 = time.perf_counter()
    with RF.WorkCounter() as wc:
        out = step(*args)
    return wc, time.perf_counter() - t0, out


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, *,
             peak_flops: float, hbm_bw: float, rule_overrides=None,
             counted=None, verbose: bool = True):
    """One cell's record on `mesh`. `counted` is a (counter, seconds,
    outputs) of the same cell from `count_cell`, which the mesh does not
    change, or None to count it here."""
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    _, in_specs, out_specs = ST.step_for(cfg, shape, mesh,
                                         rule_overrides=rule_overrides)
    wc, secs, out = counted or count_cell(arch, shape_name)
    mem = {"argument_size_in_bytes": per_device_bytes(
               cell_args(cfg, shape), in_specs, mesh),
           "output_size_in_bytes": per_device_bytes(out, out_specs, mesh)}
    rl = RF.analyze(wc, n_chips=1, model_flops_global=RF.model_flops(
        cfg, shape), peak_flops=peak_flops, hbm_bw=hbm_bw)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": M.mesh_chips(mesh), "compile_s": round(secs, 1),
        "memory": mem, "roofline": rl.as_dict(),
        "params": lm.param_count(cfg),
    }
    if verbose:
        print(f"[OK] {arch:24s} {shape_name:12s} {mesh_name:6s} "
              f"meta={secs:6.1f}s flops={rl.flops:.3e} "
              f"bytes={rl.bytes_accessed:.3e} dom={rl.dominant} "
              f"useful={rl.useful_ratio:.2f} args/dev="
              f"{mem['argument_size_in_bytes']:.3e}")
    return rec


def _fl_setup(mesh):
    from repro_torch.fl import mesh_fl
    cfg = configs.get_config(FL_ARCH)
    n_clients = max(mesh.shape.get("pod", 1), 1)
    params = lm.abstract_params(cfg)
    stk = mesh_fl.stack_params_for_clients(params, n_clients)
    weights = torch.empty((n_clients,), dtype=torch.float32, device="meta")
    return mesh_fl, cfg, n_clients, params, stk, weights


def _fl_record(cfg, mesh, mesh_name, label, wc, secs, stats, model_flops,
               peak_flops, hbm_bw, link_bw):
    rl = RF.analyze(wc, n_chips=1, model_flops_global=model_flops,
                    peak_flops=peak_flops, hbm_bw=hbm_bw, link_bw=link_bw,
                    collective_bytes=stats)
    return {"arch": FL_ARCH, "shape": label, "mesh": mesh_name,
            "chips": M.mesh_chips(mesh), "compile_s": round(secs, 1),
            "roofline": rl.as_dict()}


def run_fl_round(mesh, mesh_name: str, *, peak_flops, hbm_bw, link_bw=None,
                 local_steps: int = FL_LOCAL_STEPS, compressed: bool = False,
                 verbose: bool = True):
    """The FL round step (`mesh_fl.make_fl_round_step`) of n_pods stacked
    clients, B_local 16 x S 4096, `local_steps` steps, on meta."""
    mesh_fl, cfg, n, _, stk, weights = _fl_setup(mesh)
    mu = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                        device="meta"), stk)
    tok = torch.empty((n, local_steps, FL_B_LOCAL, FL_SEQ),
                      dtype=torch.int32, device="meta")
    step = mesh_fl.make_fl_round_step(cfg, FL_OPT, local_steps=local_steps,
                                      compressed=compressed, n_pods=n)
    mesh_fl.reset_collective_stats()
    t0 = time.perf_counter()
    with RF.WorkCounter() as wc:
        step(stk, mu, {"tokens": tok, "labels": tok}, weights)
    secs = time.perf_counter() - t0
    rec = _fl_record(cfg, mesh, mesh_name,
                     f"fl_round(ls={local_steps},compressed={compressed})",
                     wc, secs, mesh_fl.collective_stats(),
                     6.0 * lm.param_count(cfg) * n * local_steps
                     * FL_B_LOCAL * FL_SEQ, peak_flops, hbm_bw, link_bw)
    if verbose:
        print(f"[OK] FL-round {FL_ARCH} {mesh_name} compressed={compressed}"
              f" meta={secs:.1f}s coll={rec['roofline']['collective_bytes']:.3e}")
    return rec


def run_fl_agg(mesh, mesh_name: str, *, peak_flops, hbm_bw, link_bw=None,
               compressed: bool = False, verbose: bool = True):
    """The synchronous FedAvg aggregation alone (the round barrier) of
    n_pods stacked clients, plain or the int8 ring, on meta."""
    mesh_fl, cfg, n, params, stk, weights = _fl_setup(mesh)
    mesh_fl.reset_collective_stats()
    t0 = time.perf_counter()
    with RF.WorkCounter() as wc:
        if compressed:
            mesh_fl.fedavg_sync_compressed(stk, params, weights, n_pods=n)
        else:
            mesh_fl.fedavg_sync(stk, weights)
    secs = time.perf_counter() - t0
    stats = mesh_fl.collective_stats()
    rec = _fl_record(cfg, mesh, mesh_name, f"fl_agg(compressed={compressed})",
                     wc, secs, stats, 0.0, peak_flops, hbm_bw, link_bw)
    if verbose:
        print(f"[OK] FL-agg {FL_ARCH} {mesh_name} compressed={compressed} "
              f"coll={rec['roofline']['collective_bytes']:.3e} "
              f"by_kind={rec['roofline']['collective_by_kind']}")
    return rec


def _meshes(which):
    out = []
    if which in ("single", "both"):
        out.append(("single", M.make_production_mesh(multi_pod=False)))
    if which in ("multi", "both"):
        out.append(("multi", M.make_production_mesh(multi_pod=True)))
    return out


def write_records(path, records):
    """Merge `records` into the JSON list at `path` (made if missing),
    one record a (arch, shape, mesh): a new record replaces the old."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    keyed = {(r["arch"], r["shape"], r["mesh"]): r for r in existing}
    for r in records:
        keyed[(r["arch"], r["shape"], r["mesh"])] = r
    with open(path, "w") as f:
        json.dump(list(keyed.values()), f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--fl-round", action="store_true")
    ap.add_argument("--fl-agg", action="store_true")
    ap.add_argument("--compressed", action="store_true")
    ap.add_argument("--out", default="build/dryrun_torch.json")
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--peak-flops", type=float,
                    help="peak FLOP/s of one device (the caller's)")
    ap.add_argument("--hbm-bw", type=float,
                    help="memory bytes/s of one device (the caller's)")
    ap.add_argument("--link-bw", type=float,
                    help="bytes/s of a device's link, for the FL cells' "
                    "collective term")
    ap.add_argument("--device",
                    help="measure --peak-flops and --hbm-bw on this device "
                    "(e.g. cuda) instead")
    args = ap.parse_args(argv)

    if args.device:
        from repro_torch.common.device import require_device
        from repro_torch.fl.training import _measure_peaks
        peak_flops, hbm_bw = _measure_peaks(require_device(args.device,
                                                           "dryrun"))
        print(f"[peaks] measured on {args.device}: {peak_flops:.4e} FLOP/s, "
              f"{hbm_bw:.4e} B/s")
    elif args.peak_flops and args.hbm_bw:
        peak_flops, hbm_bw = args.peak_flops, args.hbm_bw
    else:
        ap.error("pass --peak-flops and --hbm-bw, or --device to measure "
                 "them: the port keeps no hardware constant")
    peaks = dict(peak_flops=peak_flops, hbm_bw=hbm_bw)

    meshes = _meshes(args.mesh)
    records, failures = [], []
    if args.fl_agg:
        for name, mesh in meshes:
            records.append(run_fl_agg(mesh, name, compressed=args.compressed,
                                      link_bw=args.link_bw, **peaks))
    elif args.fl_round:
        for name, mesh in meshes:
            records.append(run_fl_round(mesh, name,
                                        compressed=args.compressed,
                                        link_bw=args.link_bw, **peaks))
    else:
        archs = configs.ARCH_IDS if args.arch == "all" else [args.arch]
        for arch in archs:
            shapes = (configs.applicable_shapes(arch)
                      if args.shape == "all" else [args.shape])
            for shape_name in shapes:
                try:
                    counted = count_cell(arch, shape_name)
                    for mesh_name, mesh in meshes:
                        records.append(run_cell(arch, shape_name, mesh,
                                                mesh_name, counted=counted,
                                                **peaks))
                except Exception as e:
                    failures.append((arch, shape_name, repr(e)))
                    print(f"[FAIL] {arch} {shape_name}: {e}",
                          file=sys.stderr)
                    traceback.print_exc()
                    if args.fail_fast:
                        raise
                finally:
                    counted = None

    write_records(args.out, records)
    print(f"\n{len(records)} cells OK, {len(failures)} failed "
          f"-> {args.out}")
    if failures:
        for f_ in failures:
            print("  FAILED:", *f_)
        sys.exit(1)


if __name__ == "__main__":
    main()
