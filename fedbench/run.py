"""Run one cell of the port's benchmark on the card and print its result
as the last line of standard output (see `harness/session.py`).

    python3 fedbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It needs an NVIDIA card and the port under `src/`: without either it
exits non-zero and prints no result. Every cache it writes lies inside
the checkout (the port's kernels in `build/kernels/`) or under TMPDIR.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for name, sub in (("TRITON_CACHE_DIR", "triton"),
                      ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[name] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from fedbench.harness import spec

    cell = spec.cell(spec.benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"fedbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    src = ROOT / "src" / "repro_torch"
    if not src.is_dir():
        print(f"fedbench: the port is not at {src}", file=sys.stderr)
        return 3
    from fedbench.harness import session
    return session.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
