"""Read what a cell's correctness limits are set from, on the card at the
cell's own size (one process, so set-up is paid once a seed):

- the program's readings over many seeds: the first round of the window's
  own call against the plain reference (the lower readings);
- the control: the reference with every dense product's operands in fp8
  (`reference/model.py::Fp8Products`), the nearest precision below the
  configuration's bf16, put in the program's place;
- each fault a training cell can have, planted in the reference put in
  the program's place (`reference/fl_round.py::FAULTS`).

    python3 fedbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out build/limits_<cell>.json]

It prints one line a reading and, last, a JSON summary. The benchmark's
own runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def calibrate(cell_name, seeds, control_seeds, device="cuda", root=None,
              bench_dir=None, log=print):
    import torch

    from fedbench.harness import compare, session, spec as S, weights
    from fedbench.harness.program import Program
    from fedbench.reference import fl_round
    from fedbench.reference.model import Fp8Products
    root = root or S.ROOT
    bench_dir = bench_dir or S.BENCH_DIR
    spec = S.benchmark(root)
    cell = S.cell(spec, cell_name)
    cfg = S.config(spec, cell["config"], root)
    fam = S.family(cfg, bench_dir)
    mix = S.traffic(cell["traffic"], bench_dir)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # the codec exists on the int8 arm only, and a batch of one row has no
    # half to leave out
    faults = [f for f in fl_round.FAULTS
              if (f != "codec_altered" or mix["arm"] == "int8")
              and (f != "half_batch" or mix["batch"] >= 2)]
    out = {"cell": cell_name, "program": {}, "control": {},
           "faults": {f: {} for f in faults}}
    refs = {}
    for seed in seeds:
        t0 = time.perf_counter()
        w0 = weights.make(fam, cfg, seed, dev)
        prog = Program(fam, cfg, mix, seed, w0, device=dev)
        prog.run_round()
        prog_r = session.program_readings(prog, w0)
        del prog, w0
        session.free_device(dev)
        refs[seed] = session.reference_readings(fam, cfg, mix, seed, dev)
        gap = compare.gaps(prog_r, refs[seed])
        out["program"][seed] = gap
        log(f"program seed {seed}: {gap} ({time.perf_counter() - t0:.1f} s)")
        log(f"  widest grad leaves: "
            f"{compare.worst_leaves(prog_r, refs[seed])}")
    for seed in control_seeds:
        ref = refs.get(seed) or session.reference_readings(fam, cfg, mix,
                                                           seed, dev)
        ctl = session.reference_readings(fam, cfg, mix, seed, dev,
                                         prec=Fp8Products())
        out["control"][seed] = compare.gaps(ctl, ref)
        log(f"control seed {seed}: {out['control'][seed]}")
        log(f"  widest grad leaves: {compare.worst_leaves(ctl, ref)}")
        for f in faults:
            bad = session.reference_readings(fam, cfg, mix, seed, dev,
                                             fault=f)
            out["faults"][f][seed] = compare.gaps(bad, ref)
            log(f"fault {f} seed {seed}: {out['faults'][f][seed]}")
    summary = {"lower": {k: max(g[k] for g in out["program"].values())
                         for k in compare.NUMBERS} if seeds else {},
               "control_least": {k: min(g[k] for g in out["control"].values())
                                 for k in compare.NUMBERS}
               if control_seeds else {}}
    out["summary"] = summary
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    res = calibrate(args.workload, ints(args.seeds), ints(args.control_seeds),
                    log=lambda s: print(s, flush=True))
    res["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
