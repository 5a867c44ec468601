#!/usr/bin/env python3
"""How far teacher-forced bf16 decode lies from the bf16 forward, in the
JAX package and in the port. At random weights these gaps reach 1e-2 to
1e-1 of the largest logit (the JAX forward of an MoE keeps its capacity
drops, which a decode step never makes), too wide to tell a decode fault
from rounding, so `chip_smoke.py`'s `phase_serve` holds the decode to the
forward in fp32 instead.

    PYTHONPATH=src python3 tools/decode_bf16_spread.py [--arch ...] \\
        [--seq 64] [--batch 1] [--seeds 0 1]

On the CPU, for each LM main path (`repro_torch.benchmarks.table1.
MAIN_PATHS`) at its full width in bf16 with the depth cut to 2 layers
(recurrentgemma-2b 3, one (RG-LRU, RG-LRU, local attention) block): the
port's seed-0 weights, carried to the JAX package by the bridge, and a
prompt of `--seq` tokens from `np.random.RandomState(seed)`. Each package
runs its forward once (the JAX package its reference path, the port its
kernels' plain versions) and its `decode_step` once a token over the
same prompt. Printed for each: max |decode - forward| over the forward
logits' largest entry, at every position, for the JAX package, for the
port, and between the two packages' forwards. Needs both packages (JAX on
the CPU); a full-width model takes a few GB of host memory.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.benchmarks.table1 import MAIN_PATHS, main_path  # noqa: E402
from repro_torch.common import bridge  # noqa: E402
from repro_torch.models import lm  # noqa: E402

# the depth of each run: 2 layers, but 3 for recurrentgemma-2b, whose
# local attention is the third layer of its block
LAYERS = {"recurrentgemma-2b": 3}


def _gap(dec, fwd):
    """max |dec - fwd| over max |fwd|, both (B, S, V) float32 numpy."""
    return float(np.max(np.abs(dec - fwd)) / np.max(np.abs(fwd)))


def _jax(jcfg, jp, toks):
    fwd, _ = jax.jit(lambda p, t: jlm.forward(p, jcfg, t))(jp, toks)
    step = jax.jit(lambda p, t, pos, c: jlm.decode_step(p, jcfg, t, pos, c))
    B, S = toks.shape
    cache = jlm.init_cache(jcfg, B, S)
    outs = []
    for t in range(S):
        logits, cache = step(jp, toks[:, t:t + 1],
                             jnp.full((B,), t, jnp.int32), cache)
        outs.append(logits[:, 0])
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(jnp.stack(outs, axis=1)), f32(fwd)


def _port(cfg, params, toks):
    B, S = toks.shape
    with torch.no_grad():
        fwd, _ = lm.forward(params, cfg, toks)
    cache = lm.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = lm.decode_step(params, cfg, toks[:, t:t + 1],
                                       torch.full((B,), t), cache)
        outs.append(logits[:, 0])
    return (torch.stack(outs, dim=1).float().numpy(), fwd.float().numpy())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(MAIN_PATHS))
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    args = ap.parse_args(argv)
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    for arch in args.arch:
        cfg = main_path(arch, layers=LAYERS.get(arch, 2))[0]
        jcfg = dataclasses.replace(jconfigs.get_config(arch),
                                   num_layers=cfg.num_layers)
        params = lm.init_params(cfg, 0, "cpu")
        jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))
        for seed in args.seeds:
            rng = np.random.RandomState(seed)
            toks = rng.randint(0, cfg.vocab_size, (args.batch, args.seq))
            jdec, jfwd = _jax(jcfg, jp, jnp.asarray(toks, jnp.int32))
            pdec, pfwd = _port(cfg, params, torch.from_numpy(toks).long())
            print(f"{arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
                  f"{cfg.dtype}) batch {args.batch} x {args.seq} seed {seed}: "
                  f"decode vs forward, of the largest logit: JAX "
                  f"{_gap(jdec, jfwd):.3e}, port {_gap(pdec, pfwd):.3e}; "
                  f"port forward vs JAX forward {_gap(pfwd, jfwd):.3e}",
                  flush=True)
        del params, jp


if __name__ == "__main__":
    main()
