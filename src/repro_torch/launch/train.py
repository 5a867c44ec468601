"""Training driver of the port: real steps of any ``--arch`` (SMOKE size on
the CPU, full width on the card) with checkpoint/restart fault tolerance.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir build/ckpt --device cpu

Restart the same command after killing it mid-run: training resumes from
the latest checkpoint (the FedCostAware fault-tolerance path, §III-D).
The checkpoints are the JAX package's bytes, so either package resumes
the other's. Without `--device` the driver runs on the card, and raises
when there is none.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.checkpoint.store import FileStore
from repro_torch.common.device import require_device, synchronize
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import steps as ST
from repro_torch.models import lm


def train(cfg, name: str, steps: int, batch: int, seq: int, lr: float,
          ckpt_dir: str = "", ckpt_every: int = 20, log_every: int = 10,
          device="cuda", log: Callable[[str], None] = print) -> dict:
    """Train `cfg` from seed-0 weights, or from the latest checkpoint of
    `name` under `ckpt_dir`, up to step `steps`, saving every
    `ckpt_every` steps there. Returns the final `params` and `opt` state,
    the `start_step`, and the `losses` (floats) and host-clock `step_s`
    of the steps this call took."""
    dev = require_device(device, "train")
    train_step, opt = ST.make_train_step(cfg, lr=lr)
    params = lm.init_params(cfg, 0, dev)
    opt_state = opt.init(params)
    start_step = 0

    ck: Optional[Checkpointer] = None
    if ckpt_dir:
        ck = Checkpointer(FileStore(ckpt_dir))
        latest = ck.latest_step(name)
        if latest is not None:
            tpl = {"params": params, "opt": opt_state}
            saved = ck.restore(f"{name}/step={latest}", template=tpl)
            params, opt_state = saved["params"], saved["opt"]
            start_step = latest
            log(f"resumed from checkpoint step {latest}")

    stream = token_stream(cfg.vocab_size, batch, seq, seed=1)
    for _ in range(start_step):      # keep the data stream deterministic
        next(stream)

    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        t_step = time.perf_counter()
        b = {k: torch.from_numpy(v).long().to(dev)
             for k, v in next(stream).items()}
        if cfg.family == "audio":
            rng = np.random.RandomState(step)
            b["tokens"] = torch.from_numpy(
                rng.randn(batch, seq, cfg.d_model).astype(np.float32)).to(dev)
        if cfg.family == "vlm":
            b["cond"] = torch.zeros((batch, cfg.n_cond_tokens, cfg.d_model),
                                    dtype=cfg.activation_dtype, device=dev)
        params, opt_state, metrics = train_step(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        synchronize(dev)
        step_s.append(time.perf_counter() - t_step)
        if (step + 1) % log_every == 0:
            dt = (time.perf_counter() - t0) / log_every
            log(f"step {step+1:5d} loss {losses[-1]:.4f} "
                f"({dt*1e3:.0f} ms/step)")
            t0 = time.perf_counter()
        if ck is not None and (step + 1) % ckpt_every == 0:
            ck.save(f"{name}/step={step+1}",
                    {"params": params, "opt": opt_state})
    return {"params": params, "opt": opt_state, "start_step": start_step,
            "losses": losses, "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where to train (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    train(cfg, args.arch, args.steps, args.batch, args.seq, args.lr,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          log_every=args.log_every, device=args.device)
    print("done.")


if __name__ == "__main__":
    main()
