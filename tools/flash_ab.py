#!/usr/bin/env python3
"""Time a kernel of the port, and one FL round of each main path that runs
it, for one checkout of the port on one CUDA card.

    python3 tools/flash_ab.py [--kernel flash|ssd|rglru] [--src DIR]
                              [--label NAME]

DIR is the `src` directory of the checkout to time (default: this
checkout's; its package must define
`repro_torch.benchmarks.table1.MAIN_PATHS`, whose sizes the rounds
take). The kernel shapes and device timing are `chip_smoke.py`'s
(`device_ms`: the calls queued behind a sleep kernel, so the host's
time to issue them is left out); `kernel_ms` is the same calls issued
as fast as the host issues them, with nothing queued before. With
`--kernel flash` (the default): the bf16 flash-attention forward's mean
milliseconds (CUDA events) at phi3-mini-3.8b's shape and at
recurrentgemma-2b's local attention, and `measure_round_s` of those two
main paths (int8 arm). With `--kernel ssd`: the bf16 SSD forward at
mamba2-1.3b's layer (`SSD_MAIN`) and the mamba2-1.3b round. With
`--kernel rglru`: at recurrentgemma-2b's layer (`RGLRU_MAIN`) the RG-LRU
scan forward, the whole scan backward (`torch.autograd.grad` through
`rglru_scan` on a graph built once, so a checkout whose backward is the
reverse scan plus plain passes is timed the same way), and the
recurrentgemma-2b round. Prints one JSON line with them and the card's
name and power limit as `nvidia-smi` gives them. To compare two
checkouts on one card, run it on each in turns (A, B, B, A) on that
card. It needs a card and exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402


def _flash_calls(gen):
    """Each flash shape's kernel call on fresh bf16 inputs, by path."""
    from repro_torch.kernels.flash_attention import ops as fa
    shapes = {"phi3-mini-3.8b": (smoke.MAIN_B, smoke.MAIN_S, smoke.MAIN_N,
                                 smoke.MAIN_H, None),
              "recurrentgemma-2b": smoke.FLASH_RG}
    for arch, (B, S, N, H, window) in shapes.items():
        q, k, v = (smoke._randn(gen, B, S, N, H, dtype=torch.bfloat16)
                   for _ in range(3))
        yield arch, lambda: fa.flash_attention_fwd(q, k, v, window=window)


def _ssd_calls(gen):
    """The ssd kernel call at mamba2-1.3b's layer on fresh bf16 inputs."""
    from repro_torch.kernels.ssd import ops as sd
    b, s, h, p, g, n, chunk = smoke.SSD_MAIN
    x, la, B, C = smoke._ssd_inputs(gen, b, s, h, p, g, n, torch.bfloat16)
    yield "mamba2-1.3b", lambda: sd.ssd_fwd(x, la, B, C, chunk=chunk)


def _rglru_calls(gen):
    """The RG-LRU scan's forward and its whole backward at
    recurrentgemma-2b's layer, fp32."""
    from repro_torch.kernels.rglru import ops as rg
    la, u = smoke._rglru_inputs(gen, *smoke.RGLRU_MAIN)
    gh = smoke._randn(gen, *smoke.RGLRU_MAIN)
    yield "forward", lambda: rg.rglru_scan_fwd(la, u)
    la_, u_ = (x.clone().requires_grad_() for x in (la, u))
    h = rg.rglru_scan(la_, u_)
    yield "backward", lambda: torch.autograd.grad(h, (la_, u_), gh,
                                                  retain_graph=True)


def _host_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of `fn` between CUDA events around calls issued
    as fast as the host issues them: where the host takes longer to issue
    a call than the card to run it (autograd's engine around the scan's
    backward), the host's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# each kernel's calls, and the main paths whose rounds are timed with it
KERNELS = {"flash": (_flash_calls, ("phi3-mini-3.8b", "recurrentgemma-2b")),
           "ssd": (_ssd_calls, ("mamba2-1.3b",)),
           "rglru": (_rglru_calls, ("recurrentgemma-2b",))}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=tuple(KERNELS),
                        default="flash")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_ab: no CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.benchmarks.table1 import LOCAL_STEPS, main_path
    from repro_torch.fl.training import TorchTrainerHooks

    gen = torch.Generator(device="cuda").manual_seed(0)
    calls, archs = KERNELS[args.kernel]
    result = {"label": args.label, "src": args.src, "kernel": args.kernel,
              "kernel_ms": {}, "device_ms": {}, "round_s": {}}
    for name, call in calls(gen):
        result["kernel_ms"][name] = _host_ms(call)
        result["device_ms"][name] = smoke._time_ms(call, iters=20, warmup=3)
    torch.cuda.empty_cache()
    for arch in archs:
        cfg, batch, seq = main_path(arch)
        hooks = TorchTrainerHooks(smoke.CLIENTS, cfg=cfg,
                                  local_steps=LOCAL_STEPS,
                                  batch=batch, seq=seq, lr=smoke.LR,
                                  quantize=True, seed=0, device="cuda")
        result["round_s"][arch] = hooks.measure_round_s(warmup=1, iters=2)
        del hooks
        torch.cuda.empty_cache()
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
