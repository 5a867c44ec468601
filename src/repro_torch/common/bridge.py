"""Pytree paths, and weight carry-over between the port and the JAX
package through numpy.

The port's parameters are nested dicts and lists of tensors with the JAX
package's keys, shapes and layouts: `wq (d, nq, h)`, `wo (nq, h, d)`,
`wi_gate (d, f)`, and the stacked leading layer dim of every
`blocks/*` leaf of an LM; HWIO conv weights and `(in, out)` dense
weights of a CNN. A leaf is named by the `/`-joined path that
`checkpoint/ckpt.py::_flatten_with_paths` gives it in the JAX package
(for example `blocks/00_attn/mix/wq`, `stages/0/1/bn1/scale`, or
`opt_state/.mu/c1` for a NamedTuple field), with dict keys visited in
sorted order and sequence items in order, as `jax.tree_util` visits
them; `flatten_with_paths` is a local copy of that rule, and `leaves`,
`tree_map` and `unflatten_as` walk trees in the same order.

bfloat16 crosses as its bits: a numpy `bfloat16` array (the ml_dtypes
type JAX hands out) is viewed as `uint16`, and a torch bf16 tensor is
viewed the same way on the way back, so a round trip is bit-identical.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import require_device

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of a container node in flatten order, or None
    for a leaf. None is a node without children, as in `jax.tree_util`."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(`/`-joined key, leaf) pairs of a pytree of dicts, lists, tuples
    and NamedTuples, in `jax.tree_util`'s order."""
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    out = []
    for k, child in kids:
        for sub, leaf in flatten_with_paths(child):
            out.append((f"{k}/{sub}" if sub else k, leaf))
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves of `tree` in flatten order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and of the trees in `rest`, which
    have its structure; the result has it too."""
    if _children(tree) is None:
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    items = [tree_map(fn, x, *(r[i] for r in rest))
             for i, x in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)


def unflatten_as(template: Any, new_leaves: Sequence[Any]) -> Any:
    """`template`'s structure with `new_leaves` (in flatten order) in
    place of its leaves."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def unflatten(flat: Dict[str, Any]) -> Any:
    """The nested dicts and lists whose `flatten_with_paths` gives `flat`:
    a node whose keys are 0, 1, ... n-1 becomes a list."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _lists(out)


def _lists(node):
    if not isinstance(node, dict):
        return node
    kids = {k: _lists(v) for k, v in node.items()}
    if kids and sorted(kids) == sorted(map(str, range(len(kids)))):
        return [kids[str(i)] for i in range(len(kids))]
    return kids


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


def _from_numpy(tree: Dict[str, Any], want: Dict[str, Any], device,
                what: str) -> Dict[str, Any]:
    """The port's tensors from a tree of numpy arrays whose every key,
    shape and dtype must be those of `want` (key -> (shape, dtype))."""
    flat = dict(flatten_with_paths(tree))
    if set(flat) != set(want):
        raise ValueError(
            f"{what} keys differ: missing {sorted(set(want) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(want))}")
    out = {}
    for key, arr in flat.items():
        t = _to_tensor(np.asarray(arr))
        shape, dtype = want[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{key}: got {tuple(t.shape)} {t.dtype}, "
                             f"the {what} says {shape} {dtype}")
        out[key] = t.to(device)
    return unflatten(out)


def params_from_numpy(tree: Dict[str, Any], cfg,
                      device: str = "cuda") -> Dict[str, Any]:
    """The port's parameters from a JAX parameter tree given as numpy
    arrays (`jax.tree.map(np.asarray, params)`). Every key, shape and
    dtype must be the one `models.lm.param_schema(cfg)` declares."""
    from repro_torch.models import lm
    return _from_numpy(tree, dict(lm.param_shapes(cfg)), device,
                       "parameter schema")


def cache_from_numpy(tree: Dict[str, Any], cfg, batch: int, max_len: int,
                     device: str = "cuda") -> Dict[str, Any]:
    """The port's decode cache from a JAX cache tree given as numpy
    arrays (`lm.init_cache(cfg, batch, max_len)` of the JAX package, or
    one `decode_step` returned). Every key, shape and dtype must be the
    one `models.lm.cache_shapes(cfg, batch, max_len)` declares."""
    from repro_torch.models import lm
    return _from_numpy(tree, dict(lm.cache_shapes(cfg, batch, max_len)),
                       device, "cache layout")


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters (or a decode cache) as a nested dict of
    numpy arrays, keyed and laid out as the JAX package's tree."""
    return unflatten({k: _to_numpy(t)
                      for k, t in flatten_with_paths(params)})


def cnn_params_from_numpy(tree: Any, name: str,
                          device: str = "cuda") -> Any:
    """The port's parameters of CNN `name` (`models/cnn.py`) from a JAX
    parameter tree given as numpy arrays. EfficientNet's JAX tree holds
    each block as `(params, stride)`; the port keeps the strides out of
    its tree (`cnn.EFF_STRIDES`), so each JAX stride is checked against
    the port's and dropped."""
    from repro_torch.models import cnn     # it imports this module
    dev = require_device(device, "cnn_params_from_numpy")
    tree = dict(tree)
    if name == "efficientnet":
        strides = [int(s) for _, s in tree["blocks"]]
        if strides != cnn.EFF_STRIDES:
            raise ValueError(f"efficientnet strides {strides}, the port's "
                             f"are {cnn.EFF_STRIDES}")
        tree["blocks"] = [p for p, _ in tree["blocks"]]
    elif name not in cnn.MODELS:
        raise ValueError(f"unknown CNN {name!r}")

    def carry(arr):
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            raise ValueError(f"CNN parameters are float32, got {arr.dtype}")
        return _to_tensor(arr).to(dev)

    return tree_map(carry, tree)


def cnn_params_to_numpy(params: Any, name: str) -> Any:
    """The port's parameters of CNN `name` as the JAX package's parameter
    tree of numpy arrays, EfficientNet's strides put back as int leaves."""
    from repro_torch.models import cnn
    out = tree_map(_to_numpy, params)
    if name == "efficientnet":
        out["blocks"] = [(p, s) for p, s in zip(out["blocks"],
                                                cnn.EFF_STRIDES)]
    return out
