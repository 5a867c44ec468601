"""One run of one cell: set-up, the measured (or traced) window, and the
comparison with the plain reference; the result as one JSON line.

Set-up builds the port's hooks, gives them the weights the benchmark made
from the seed, and drives them through `WARMUP_ROUNDS` rounds of the
window's own call: the first is the round the reference follows, the
rest warm every shape the window uses. The window then drives the same
object round after round until the round that crosses `seconds` ends.
After it the program's state is freed and the reference works the first
round out again from the seed.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from fedbench.harness import compare, spec as S, trace as T, weights
from fedbench.harness.program import Program, hook_seed
from fedbench.reference import fl_round

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 120
# set-up's rounds: the first is the round the reference follows, the
# second warms what the first compiled or allocated
WARMUP_ROUNDS = 2
# the rounds of a traced window (device ops only), before one more round
# traced with the host's events for the breakdown's idle gaps
TRACE_ROUNDS = 2


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (`repro_torch` is not `repro`)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def card_info(device_index: int = 0) -> dict:
    """The card's name, clocks and power limit as nvidia-smi reads them."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader",
             f"--id={device_index}"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return dict(zip(("smi_name", "power_limit", "clocks_sm", "clocks_max_sm",
                     "temperature"), (v.strip() for v in out.split(","))))


def _device(dev: torch.device, n_chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": n_chips, **card_info(dev.index or 0)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _max_mem(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free_device(dev):
    """Drop what Python no longer holds and return cached device memory."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _metric(value, unit):
    return {"value": value, "unit": unit}


def program_readings(prog: Program, before: Dict[str, torch.Tensor]):
    return compare.readings(prog.losses()[-1], prog.momentum(), before,
                            prog.params())


def reference_readings(family, cfg, mix, seed, dev, prec=None, fault=None):
    """The plain reference's first round of a run seeded `seed`, from the
    weights the benchmark makes again from the seed. Its float32
    products run in float32, not TF32."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        stored = weights.make(family, cfg, seed, dev)
        out = fl_round.run_round(family, cfg, mix, stored, hook_seed(seed),
                                 prec=prec, fault=fault)
        r = compare.readings(out["mean_loss"], out["mu"], stored,
                             out["params"])
        del out, stored
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    free_device(dev)
    return r


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: Optional[float] = None, root=S.ROOT,
        bench_dir=S.BENCH_DIR, out=sys.stdout, err=sys.stderr) -> int:
    """Run the cell; print the result line. Returns the exit code."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = S.benchmark(root)
    cell = S.cell(spec, cell_name)
    cfg = S.config(spec, cell["config"], root)
    fam = S.family(cfg, bench_dir)
    mix = S.traffic(cell["traffic"], bench_dir)
    lim = S.limits(cell_name, bench_dir)
    e2e = S.end_to_end(spec, cell_name)
    layer = S.per_layer(spec, cell_name)
    dev = torch.device(device)
    marks = [("start", time.perf_counter())]

    def mark(name):
        _sync(dev)
        marks.append((name, time.perf_counter()))

    w0 = weights.make(fam, cfg, seed, dev)
    mark("weights")
    prog = Program(fam, cfg, mix, seed, w0, device=dev)
    mark("hooks")
    prog.run_round()
    mark("round 1")
    prog_r = program_readings(prog, w0)
    del w0
    mark("readings")
    for _ in range(WARMUP_ROUNDS - 1):
        prog.run_round()
    mark("warm-up")
    setup_s = time.perf_counter() - t_start
    print("setup: " + ", ".join(
        f"{n} {t - marks[i][1]:.3f} s" for i, (n, t) in
        enumerate(marks[1:])) + f"; before them {marks[0][1] - t_start:.3f}"
          f" s; setup_s {setup_s:.3f} s", file=err)
    peak_setup = _max_mem(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    first = prog.round
    result_metrics, dev_extra, breakdown = {}, {}, None
    if not trace:
        t0 = time.perf_counter()
        ends = []
        while True:
            prog.run_round()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        _sync(dev)
        window_s = time.perf_counter() - t0
        rounds = prog.round - first
        each = [b - a for a, b in zip([0.0] + ends, ends)]
        print(f"window: {rounds} rounds in {window_s:.4f} s; a round "
              f"(host clock at its return) min {min(each):.4f}, median "
              f"{statistics.median(each):.4f}, max {max(each):.4f} s",
              file=err)
        peak_window = _max_mem(dev)
        values = {"round_s": window_s / rounds,
                  "peak_mem_gb": peak_window / 1e9, "setup_s": setup_s}
        for m in e2e:
            result_metrics[m["name"]] = _metric(values[m["name"]], m["unit"])
    else:
        tr = T.profile_rounds(prog.run_round, TRACE_ROUNDS, dev)
        rounds = TRACE_ROUNDS
        labelled = T.profile_rounds(prog.run_round, 1, dev, host=True)
        peak_window = _max_mem(dev)
        intervals = T.busy_intervals(tr["device"])
        busy_s = sum(b - a for a, b in intervals) / 1e6
        ctx = {"cfg": cfg, "mix": mix, "family": fam,
               "dims": fam.dims(cfg), "device": tr["device"],
               "window_s": tr["window_s"], "busy_s": busy_s,
               "rounds": rounds,
               "peaks": (S.peaks(torch.cuda.get_device_name(dev), bench_dir)
                         if dev.type == "cuda" else None),
               "leaf_sizes": [math.prod(s)
                              for _, s, *_ in fam.schema(cfg)]}
        for m in layer:
            v = S.reader(m["name"], bench_dir)(ctx)
            if v is not None:
                result_metrics[m["name"]] = _metric(v, m["unit"])
        dev_extra = {"busy_s": busy_s, "window_s": tr["window_s"]}
        gaps = T.idle_by_host(T.busy_intervals(labelled["device"]),
                              labelled["host"])
        breakdown = {"device_ops": [[n[:NAME_CHARS], t] for n, t in
                                    T.device_ops(tr["device"])],
                     "idle_gaps": [[n[:NAME_CHARS], t] for n, t in gaps]}
    window_losses = prog.losses()[first:]
    failed = sum(1 for v in window_losses if not math.isfinite(v))

    found = forbidden_modules()
    if found:
        print(f"fedbench: JAX or the JAX package is loaded: {found}",
              file=err)
        return 4
    device_info = {**_device(dev, cell["chips"]),
                   "memory_peak_bytes": max(peak_setup, peak_window),
                   **dev_extra}
    del prog
    free_device(dev)

    t_ref = time.perf_counter()
    ref_r = reference_readings(fam, cfg, mix, seed, dev)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=err)
    gap = compare.gaps(prog_r, ref_r)
    correct = compare.judge(gap, lim)
    line = {"correct": correct, "attempted": len(window_losses),
            "failed": failed, "metrics": result_metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = {k: {"value": gap[k], "limit": lim[k]}
                        for k in compare.NUMBERS}
    for text in compare.lines(gap, lim):
        print(text, file=err)
    print(json.dumps(line), file=out)
    return 0
