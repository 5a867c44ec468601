"""Weight carry-over between the port and the JAX package, through numpy.

The port's parameters are a nested dict of tensors with the JAX
package's keys, shapes and layouts: `wq (d, nq, h)`, `wo (nq, h, d)`,
`wi_gate (d, f)`, and the stacked leading layer dim of every
`blocks/*` leaf. A leaf is named by the `/`-joined path that
`checkpoint/ckpt.py::_flatten_with_paths` gives it in the JAX package
(for example `blocks/00_attn/mix/wq`), with dict keys visited in sorted
order as `jax.tree_util` visits them; `flatten_with_paths` is a local
copy of that rule.

bfloat16 crosses as its bits: a numpy `bfloat16` array (the ml_dtypes
type JAX hands out) is viewed as `uint16`, and a torch bf16 tensor is
viewed the same way on the way back, so a round trip is bit-identical.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(`/`-joined key, leaf) pairs of a nested dict, in sorted-key order."""
    if not isinstance(tree, dict):
        return [("", tree)]
    out = []
    for k in sorted(tree):
        for sub, leaf in flatten_with_paths(tree[k]):
            out.append((f"{k}/{sub}" if sub else str(k), leaf))
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The nested dict whose `flatten_with_paths` gives `flat`."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 type, as the JAX package uses
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Dict[str, Any], cfg,
                      device: str = "cuda") -> Dict[str, Any]:
    """The port's parameters from a JAX parameter tree given as numpy
    arrays (`jax.tree.map(np.asarray, params)`). Every key, shape and
    dtype must be the one `models.lm.param_schema(cfg)` declares."""
    from repro_torch.models import lm
    want = dict(lm.param_shapes(cfg))
    flat = dict(flatten_with_paths(tree))
    if set(flat) != set(want):
        raise ValueError(
            f"parameter keys differ: missing {sorted(set(want) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(want))}")
    out = {}
    for key, arr in flat.items():
        t = _to_tensor(np.asarray(arr))
        shape, dtype = want[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{key}: got {tuple(t.shape)} {t.dtype}, "
                             f"schema says {shape} {dtype}")
        out[key] = t.to(device)
    return unflatten(out)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters as a nested dict of numpy arrays, keyed and
    laid out as the JAX package's parameter tree."""
    return unflatten({k: _to_numpy(t)
                      for k, t in flatten_with_paths(params)})
