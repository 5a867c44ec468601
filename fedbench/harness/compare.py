"""What decides `correct`: the first round of the run, read from the
program and worked out again by the plain reference, compared as three
numbers, each against a limit of its own.

- `loss`: the gap between the round's mean losses, over the reference's.
- `grad`: each client's momentum after its local steps (0.9 g1 + g2, the
  gradients as the optimizer got them), by the worst leaf: the gap
  between the program's norm of the leaf and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger.
- `grad_median`: the same leaf gaps' median over every client and leaf.
  The worst leaf of a Mamba2 stack is one of its per-head scalars (A_log,
  D, dt_bias: 64 a layer), whose gradients come through the bf16 scan
  and swing from seed to seed as much under bf16 as under the fp8
  control; the median leaf is steady.
- `update`: the change of the global parameters over the round, after
  the codec and the fold, by the worst leaf in the same way. Leaves whose
  reference gradient is under a thousandth of the median leaf's move
  under rounding alone and are left out.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

NUMBERS = ("loss", "grad", "grad_median", "update")
# a leaf whose reference gradient is below this share of the median
# leaf's is nought to rounding; its change is not compared
ROUNDING_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def readings(mean_loss: float, mus: List[Dict[str, torch.Tensor]],
             before: Dict[str, torch.Tensor],
             after: Dict[str, torch.Tensor]) -> dict:
    """The round's numbers on one side: its mean loss, each client's
    momentum norm a leaf, and the norm of each leaf's change."""
    return {"loss": float(mean_loss),
            "grad": [{k: _norm(v) for k, v in mu.items()} for mu in mus],
            "update": {k: _norm(after[k].double() - before[k].double())
                       for k in before}}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, whichever is larger; a NaN reads infinite."""
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    gaps = (abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys)
    return [math.inf if math.isnan(g) else g for g in gaps]


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    return max(_leaf_gaps(prog, ref, keys))


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of a program's readings against the
    reference's; a NaN (a side that diverged) reads infinite."""
    loss = abs(prog["loss"] - ref["loss"]) / abs(ref["loss"])
    loss = math.inf if math.isnan(loss) else loss
    leaves = [g for p, r in zip(prog["grad"], ref["grad"])
              for g in _leaf_gaps(p, r, r)]
    top = {k: max(r[k] for r in ref["grad"]) for k in ref["update"]}
    median = statistics.median(top.values())
    moved = [k for k, g in top.items() if g >= ROUNDING_LEAF * median]
    update = _worst(prog["update"], ref["update"], moved)
    return {"loss": loss, "grad": max(leaves),
            "grad_median": statistics.median(leaves), "update": update}


def worst_leaves(prog: dict, ref: dict, n: int = 6) -> List[tuple]:
    """The `n` leaves that read the widest `grad` gaps: (gap, client,
    key)."""
    rows = [(g, i, k) for i, (p, r) in enumerate(zip(prog["grad"],
                                                     ref["grad"]))
            for g, k in zip(_leaf_gaps(p, r, r), r)]
    return sorted(rows, reverse=True)[:n]


def judge(gap: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every number lies at or under its limit. A number whose
    limit is None is read and printed but not compared: no control or
    fault of the cell separates it from sound runs."""
    return all(gap[k] <= limits[k] for k in NUMBERS
               if limits[k] is not None)


def lines(gap: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """One line a number: its name, its reading and its limit."""
    return [f"{k} {gap[k]!r} limit "
            + ("none (not compared)" if limits[k] is None else repr(limits[k]))
            for k in NUMBERS]
