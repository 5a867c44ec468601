"""Serving driver of the port: batched prefill + greedy decode for any
``--arch``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --batch 4 --prompt-len 16 --gen 32 --device cpu

As the JAX package's driver: SMOKE size always (`--smoke` cannot be
turned off), seed-0 weights, a prompt from `np.random.RandomState(0)`,
prefill by decode steps (teacher forcing over the prompt), then greedy
decode; a vlm model serves with the zero `cond_k`/`cond_v` of a fresh
cache. Without `--device` the driver runs on the card, and raises when
there is none.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import configs
from repro_torch.common.device import require_device, synchronize
from repro_torch.models import lm


def serve(cfg, params, batch: int, prompt_len: int, gen: int,
          device="cuda", keep_prompt_logits: bool = False,
          log: Callable[[str], None] = print) -> dict:
    """Prefill a random prompt through `lm.decode_step` one token at a
    time, then decode `gen` greedy tokens. Returns the `prompt` (B, P),
    the generated `tokens` (B, gen), `prefill_s` and `decode_s` on the
    host clock, and with `keep_prompt_logits` the teacher-forced
    `prompt_logits` (B, P, V)."""
    dev = require_device(device, "serve")
    B = batch
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, prompt_len))).long().to(dev)
    cache = lm.init_cache(cfg, B, prompt_len + gen, device=dev)

    # prefill via decode steps (teacher forcing over the prompt)
    kept = []
    t0 = time.perf_counter()
    for t in range(prompt_len):
        logits, cache = lm.decode_step(
            params, cfg, prompt[:, t:t + 1],
            torch.full((B,), t, dtype=torch.long, device=dev), cache)
        if keep_prompt_logits:
            kept.append(logits[:, 0])
    synchronize(dev)
    prefill_s = time.perf_counter() - t0

    # greedy decode
    outs = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(gen):
        outs.append(tok)
        logits, cache = lm.decode_step(
            params, cfg, tok,
            torch.full((B,), prompt_len + i, dtype=torch.long, device=dev),
            cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    synchronize(dev)
    decode_s = time.perf_counter() - t0

    tokens = torch.cat(outs, dim=1)
    log(f"arch={cfg.name} batch={B} prompt={prompt_len} gen={gen}")
    log(f"prefill: {prefill_s*1e3:.0f} ms  decode: "
        f"{decode_s/gen*1e3:.1f} ms/token")
    for b in range(min(B, 2)):
        log(f"seq{b}: {tokens[b, :16].tolist()} ...")
    out = {"prompt": prompt, "tokens": tokens, "prefill_s": prefill_s,
           "decode_s": decode_s}
    if keep_prompt_logits:
        out["prompt_logits"] = torch.stack(kept, dim=1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default cuda; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    dev = require_device(args.device, "serve")
    serve(cfg, lm.init_params(cfg, 0, dev), args.batch, args.prompt_len,
          args.gen, device=dev)


if __name__ == "__main__":
    main()
