#!/usr/bin/env python3
"""How far teacher-forced decode lies from the forward at the LM main
paths' full width, on the card and on the CPU: the spread behind the
reading of `chip_smoke.py`'s `phase_serve`.

    python3 tools/decode_card_spread.py [--arch ...] [--seq 256] \\
        [--batch 4] [--dtype float32 bfloat16]

Needs the card. For each main path (`repro_torch.benchmarks.table1.
MAIN_PATHS`, full width, its depth cut) and each dtype: the port's
seed-0 weights and a prompt from `np.random.RandomState(0)`, the forward
once and `lm.decode_step` once a position, on the card and on the CPU
(an MoE with the capacity factor E/K, so its forward drops no slot, as a
decode step never does). Printed for each: max |a - b| over the largest
logit of b, and how many (row, position) pairs lie over 5% of it, for
the card's decode against its forward, the CPU's, and the card's forward
and decode against the CPU's.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.benchmarks.table1 import MAIN_PATHS, main_path  # noqa: E402
from repro_torch.common.bridge import tree_map  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def _run(cfg, params, toks):
    """(teacher-forced decode logits, forward logits), fp32 on the CPU."""
    B, S = toks.shape
    with torch.no_grad():
        full = lm.forward(params, cfg, toks)[0].float()
    cache = lm.init_cache(cfg, B, S, device=toks.device)
    outs = []
    for t in range(S):
        logits, cache = lm.decode_step(
            params, cfg, toks[:, t:t + 1],
            torch.full((B,), t, device=toks.device), cache)
        outs.append(logits[:, 0].float())
    return torch.stack(outs, dim=1).cpu(), full.cpu()


def _gap(a, b):
    d = (a - b).abs()
    top = b.abs().max()
    over = int((d.amax(-1) / top > 0.05).sum())
    return f"{(d.max() / top).item():.3e} ({over} of {d[..., 0].numel()} over 5%)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(MAIN_PATHS))
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", nargs="*", default=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("decode_card_spread: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    for arch in args.arch:
        for dt in args.dtype:
            cfg = dataclasses.replace(main_path(arch)[0], dtype=dt,
                                      param_dtype=dt)
            if cfg.moe:
                m = cfg.moe
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    m, capacity_factor=m.num_experts / m.top_k))
            toks = torch.from_numpy(np.random.RandomState(0).randint(
                0, cfg.vocab_size, (args.batch, args.seq))).long()
            cpu = lm.init_params(cfg, 0, "cpu")
            t0 = time.perf_counter()
            dec_g, fwd_g = _run(cfg, tree_map(lambda t: t.cuda(), cpu),
                                toks.cuda())
            dec_c, fwd_c = _run(cfg, cpu, toks)
            print(f"{arch} ({cfg.num_layers} layers) {dt} batch {args.batch} "
                  f"x {args.seq}: decode vs forward, card {_gap(dec_g, fwd_g)}"
                  f", CPU {_gap(dec_c, fwd_c)}; card vs CPU, forward "
                  f"{_gap(fwd_g, fwd_c)}, decode {_gap(dec_g, dec_c)} "
                  f"({time.perf_counter() - t0:.0f} s; "
                  f"{torch.cuda.get_device_name(0)})", flush=True)


if __name__ == "__main__":
    main()
