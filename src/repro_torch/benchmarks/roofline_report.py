"""Roofline report: reads the port's dry-run artifacts
(build/dryrun_torch*.json in the checkout) and prints the per-(arch x
shape x mesh) three-term roofline table used in EXPERIMENTS.md
§Roofline, in the JAX package's CSV format."""
from __future__ import annotations

import json
import os
from pathlib import Path

# the checkout's build/ (this file is
# src/repro_torch/benchmarks/roofline_report.py), where
# `python -m repro_torch.launch.dryrun` writes by default
RESULTS = str(Path(__file__).resolve().parents[3] / "build")
NOTE = ("# counted by WorkCounter over the whole program on one device "
        "(bytes_accessed sums the aten ops' inputs and outputs), where the "
        "JAX package reads its compiled, sharded HLO: only model_flops "
        "compares between the two; compile_s holds the seconds of the "
        "meta count")


def load(fname="dryrun_torch.json"):
    path = os.path.join(RESULTS, fname)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def main():
    recs = load()
    recs += load("dryrun_torch_fl.json")
    recs += load("dryrun_torch_fl_comp.json")
    if not recs:
        print("no dry-run results found; run: "
              "PYTHONPATH=src python -m repro_torch.launch.dryrun with "
              "--peak-flops and --hbm-bw, or --device cuda")
        return
    recs.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    print(NOTE)
    print("arch,shape,mesh,chips,compute_s,memory_s,collective_s,"
          "dominant,model_flops,useful_ratio,peak_fraction,compile_s")
    for r in recs:
        rl = r["roofline"]
        print(f"{r['arch']},{r['shape']},{r['mesh']},{r['chips']},"
              f"{rl['compute_s']:.4g},{rl['memory_s']:.4g},"
              f"{rl['collective_s']:.4g},{rl['dominant']},"
              f"{rl['model_flops']:.3e},{rl['useful_ratio']:.3f},"
              f"{rl['peak_fraction']:.3f},{r.get('compile_s', '')}")


if __name__ == "__main__":
    main()
