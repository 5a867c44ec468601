#!/usr/bin/env python3
"""How far two correct fp32 runs of the LM SMOKE configs part ways: the
numbers behind the bars `tests/test_torch_families.py` holds the port's
logits and gradients to.

    PYTHONPATH=src python3 tools/lm_fp32_spread.py [--seeds 0 1 2 3] \\
        [--arch llama-3.2-vision-90b ...] \\
        [--rounds [--lr LR] [--seq SEQ] [--schedule one_round ...]]

On the CPU, for each SMOKE config and each `make_batch` seed of
`tests/test_models.py`, on the JAX package's initial weights: the
logits and the parameter gradients of the JAX package in fp32, of the
port in fp32, and of the port in float64 (every `.float()` of the port
made a `.double()` for that run). Printed for each pair: the logits'
max |difference| over the float64 logits' largest entry, and the worst
leaf's max |difference| over that leaf's largest float64 gradient entry.

With `--rounds`, for the models of `tests/test_torch_training.py`
instead: the hook rounds of its `TestHooksMatchJaxReference` (every
schedule, both arms), each round's mean-loss gap between the port and
the JAX reference, the worst leaf's final parameter gap over the test's
bar (2% of the leaf's update plus 2 ulps of its largest entry), and on
the int8 arm how many int8 values of the first round's client deltas
the two packages' codecs set differently; `--lr` and `--seq` replace the
test's 2e-4 and 8 (`chip_smoke.py` holds the card to the CPU over one
round at the hooks' default lr 5e-3 and 64 tokens).
Needs both packages (JAX on the CPU).
"""
import argparse
import contextlib
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.common import bridge  # noqa: E402
from repro_torch.common.float64 import float_is_double  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_models import make_batch  # noqa: E402


def _port(arch, jp, batch, f64):
    """The port's logits and gradients (float64 numpy, by leaf)."""
    cfg = configs.get_config(arch, smoke=True)
    dt = torch.float64 if f64 else torch.float32
    if f64:
        cfg = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    leaves = {k: bridge._to_tensor(np.asarray(v)).to(dt).requires_grad_()
              for k, v in bridge.flatten_with_paths(jp)}
    tb = {k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
              else torch.from_numpy(v).to(dt)) for k, v in batch.items()}
    with float_is_double() if f64 else contextlib.nullcontext():
        params = bridge.unflatten(leaves)
        logits, _ = lm.forward(params, cfg, tb["tokens"], cond=tb.get("cond"))
        grads = torch.autograd.grad(lm.loss_fn(params, cfg, tb),
                                    list(leaves.values()), allow_unused=True)
    return (logits.detach().double().numpy(),
            {k: (np.zeros(v.shape) if g is None else g.double().numpy())
             for (k, v), g in zip(leaves.items(), grads)})


def _jax(arch, jp, batch):
    cfg = jconfigs.get_config(arch, smoke=True)
    p = jax.tree.map(jnp.asarray, jp)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = jlm.forward(p, cfg, b["tokens"], cond=b.get("cond"))
    grads = jax.grad(lambda q: jlm.loss_fn(q, cfg, b))(p)
    return (np.asarray(logits, np.float64),
            {k: np.asarray(v, np.float64) for k, v in
             bridge.flatten_with_paths(jax.tree.map(np.asarray, grads))})


def _apart(a, b, truth):
    """(logits apart / max |truth logits|, worst leaf's gradient apart /
    that leaf's max |truth gradient|, the leaf)."""
    logits = np.max(np.abs(a[0] - b[0])) / np.max(np.abs(truth[0]))
    leaf = max(truth[1], key=lambda k: np.max(np.abs(a[1][k] - b[1][k]))
               / max(np.max(np.abs(truth[1][k])), 1e-30))
    grad = (np.max(np.abs(a[1][leaf] - b[1][leaf]))
            / max(np.max(np.abs(truth[1][leaf])), 1e-30))
    return logits, grad, leaf


def _round_gaps(model, quantize, schedule):
    """Per-round |mean loss gap| of the hook rounds, the worst leaf's
    final parameter gap in units of the test's bar, and the int8 values
    of round 1's deltas that differ between the packages."""
    import test_torch_training as TT
    from repro.kernels.grad_quant import ops as jgq

    hooks = TT._hooks(quantize, model=model)
    init = bridge.unflatten(dict(bridge.flatten_with_paths(
        bridge.params_to_numpy(hooks.global_params()))))
    port_d, jax_d = [], []
    if quantize:
        roundtrip = hooks._quant_roundtrip
        hooks._quant_roundtrip = lambda d: (port_d.append(d.numpy().copy())
                                            or roundtrip(d))
        jquant = TT.jgq.quantize
        TT.jgq.quantize = lambda x, *a, **k: (jax_d.append(np.asarray(x))
                                              or jquant(x, *a, **k))
    try:
        TT._play(hooks, TT.SCHEDULES[schedule])
        want_p, want = TT._jax_rounds(init, TT.SCHEDULES[schedule],
                                      quantize, model=model)
    finally:
        if quantize:
            TT.jgq.quantize = jquant
    got = [r["mean_loss"] for r in hooks.losses]
    final = dict(bridge.flatten_with_paths(
        bridge.params_to_numpy(hooks.global_params())))
    start = dict(bridge.flatten_with_paths(init))
    params = max(
        (np.max(np.abs(final[k] - w)) / (
            2e-2 * np.max(np.abs(w - start[k]))
            + 2 * np.spacing(np.max(np.abs(w)))), k)
        for k, w in bridge.flatten_with_paths(want_p))
    # round 1 trains every slot in both packages, in the same leaf order
    n = len(bridge.flatten_with_paths(init)) * len(TT.NAMES)
    flips = sum(int(np.sum(np.asarray(jgq.quantize(jnp.asarray(a))[0])
                           != np.asarray(jgq.quantize(jnp.asarray(b))[0])))
                for a, b in zip(port_d[:n], jax_d[:n]))
    size = sum(a.size for a in port_d[:n])
    return [abs(a - b) for a, b in zip(got, want)], params, flips, size


def rounds(models, lr=None, seq=None, schedules=None):
    import test_torch_training as TT
    TT.LR = lr or TT.LR
    TT.SEQ = seq or TT.SEQ
    print(f"hook rounds at lr {TT.LR:g}, batch {TT.BATCH} x {TT.SEQ} tokens")
    for model in models or TT.MODELS:
        for quantize in (False, True):
            for schedule in schedules or TT.SCHEDULES:
                gaps, (bar, leaf), flips, size = _round_gaps(
                    model, quantize, schedule)
                codec = (f"; round 1's int8 values that differ: {flips} of "
                         f"{size}" if quantize else "")
                print(f"{model} {'int8' if quantize else 'fp32'} {schedule}: "
                      f"mean-loss gap by round "
                      f"{[float(f'{g:.3e}') for g in gaps]}; parameters "
                      f"{bar:.3f} of the bar ({leaf}){codec}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--seeds", nargs="*", type=int, default=[0, 1, 2, 3])
    ap.add_argument("--rounds", action="store_true")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--schedule", nargs="*", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    if args.rounds:
        rounds(args.arch, args.lr, args.seq, args.schedule)
        return
    for arch in args.arch or configs.ARCH_IDS:
        jcfg = jconfigs.get_config(arch, smoke=True)
        jp = jax.tree.map(np.asarray,
                          jlm.init_params(jcfg, jax.random.PRNGKey(0)))
        for seed in args.seeds:
            batch = {k: np.asarray(v)
                     for k, v in make_batch(jcfg, seed=seed).items()}
            port32 = _port(arch, jp, batch, False)
            port64 = _port(arch, jp, batch, True)
            jax32 = _jax(arch, jp, batch)
            for name, a, b in [("port fp32 vs JAX fp32", port32, jax32),
                               ("port fp32 vs port float64", port32, port64),
                               ("JAX fp32 vs port float64", jax32, port64)]:
                logits, grad, leaf = _apart(a, b, port64)
                print(f"{arch} seed {seed}: {name}: logits {logits:.3e} of "
                      f"max |logits|; gradients {grad:.3e} of the leaf's "
                      f"largest entry ({leaf})")


if __name__ == "__main__":
    main()
