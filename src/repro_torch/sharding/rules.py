"""Logical-axis sharding rules (MaxText style), the port of the JAX
package's `sharding/rules.py`.

Parameters and activations are annotated with *logical* axis names; a rule
table maps each logical name to zero-or-more mesh axes. The tables,
`make_rules` and `resolve_spec` are copies: the same claims in the same
priority order, the same divisibility drops, the same trailing-`None`
trim. What they resolve on is the port's own:

  a mesh  `MeshShape`: axis names and sizes, no devices (`launch/mesh.py`
          builds the production ones); only `mesh.shape[a]` and
          `mesh.axis_names` are read, as in the reference;
  a spec  a plain tuple in the canonical form of JAX's `PartitionSpec`:
          one entry a dim, each None, a mesh axis name, or a tuple of
          names, trailing Nones dropped (`P()` is `()`).

One process drives one device, so nothing of the port shards a tensor by
these specs: the dry run (`launch/dryrun.py`) reports them and divides
each argument's bytes by its shard factor. `ShardingCtx` is therefore an
identity, and the port's model code takes no `shard` argument. A later
port onto several cards would make `ShardingCtx.__call__` lay `x` out as
a DTensor by `resolve_spec(logical_axes, rules, mesh, x.shape)`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh without devices: its axis names and their sizes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))


# ---------------------------------------------------------------------------
# Default rule tables.
# ---------------------------------------------------------------------------
# Standard data+model parallel training (pods act as extra DP):
TRAIN_RULES: Rules = {
    "batch": ("pod", "data"),
    "fl_clients": ("pod",),       # FL-in-mesh: client axis lives on pods
    "fl_batch": ("data",),        # FL-in-mesh: per-client batch
    # Megatron-style sequence parallelism for the residual stream; inside
    # attention the `model` axis is re-used by heads, so resolve_spec
    # drops the seq constraint there (= all-gather at the block boundary).
    "seq": ("model",),
    "embed": ("data",),           # FSDP shard of the d_model weight dim
    "embed_act": None,            # activations keep d_model unsharded
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),
    "experts": ("model",),
    "expert_cap": None,
    "ssm_inner": ("model",),      # mamba2 inner channels
    "ssm_heads": ("model",),
    "ssm_state": None,
    "lru_width": ("model",),
    "conv_width": None,
    "layers": None,               # stacked leading layer dim
    "cache_len": None,
    "cond": None,                 # conditioning (image/audio) tokens
    "norm": None,
}

# Decode: KV cache dominates memory -> shard cache length over `model`
# (flash-decode style); batch over `data`.
DECODE_RULES: Rules = dict(
    TRAIN_RULES,
    batch=("data",),
    cache_len=("model",),
    kv_heads=None,        # heads often < model axis; length-sharding instead
    heads=("model",),
)


def make_rules(kind: str, overrides: Optional[Rules] = None) -> Rules:
    base = dict(TRAIN_RULES if kind in ("train", "prefill") else DECODE_RULES)
    if overrides:
        base.update(overrides)
    return base


# ---------------------------------------------------------------------------
# Resolution helpers.
# ---------------------------------------------------------------------------
def _axis_size(mesh: MeshShape, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


# Mesh axes are claimed by logical axes in PRIORITY order, not positional
# order: compute-parallel dims (heads/mlp/experts/...) outrank sequence
# parallelism, which outranks everything else. An arch whose head count
# does not divide the model axis (musicgen/granite: 24 heads on a 16-way
# axis) then falls back to sequence sharding.
_CLAIM_PRIORITY = {
    "batch": 0, "fl_clients": 0, "fl_batch": 0,
    "heads": 1, "kv_heads": 1, "mlp": 1, "experts": 1, "ssm_inner": 1,
    "ssm_heads": 1, "lru_width": 1, "vocab": 1, "embed": 1,
    "cache_len": 1,
    "seq": 3,
}


def resolve_spec(logical_axes: Sequence[Optional[str]], rules: Rules,
                 mesh: MeshShape, shape: Optional[Sequence[int]] = None) -> Spec:
    """Map logical axis names to a spec valid on `mesh`.

    Mesh axes are claimed in priority order (see _CLAIM_PRIORITY). When
    `shape` is given, any mapping whose dim is not divisible by the
    mesh-axis extent is dropped (e.g. 8 kv heads on a 16-way model axis,
    or granite's 40 experts), freeing the axis for lower-priority
    claimants.
    """
    order = sorted(
        (i for i, n in enumerate(logical_axes) if n is not None),
        key=lambda i: (_CLAIM_PRIORITY.get(logical_axes[i], 2), i))
    used = set()
    out: list = [None] * len(logical_axes)
    for i in order:
        name = logical_axes[i]
        mesh_axes = rules.get(name, None)
        if mesh_axes is None:
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        # keep only axes present in this mesh and not already used
        mesh_axes = tuple(a for a in mesh_axes
                          if a in mesh.axis_names and a not in used)
        if shape is not None and mesh_axes:
            # drop axes (right-to-left) until the dim divides evenly
            while mesh_axes and shape[i] % _axis_size(mesh, mesh_axes) != 0:
                mesh_axes = mesh_axes[:-1]
        used.update(mesh_axes)
        if not mesh_axes:
            out[i] = None
        elif len(mesh_axes) == 1:
            out[i] = mesh_axes[0]
        else:
            out[i] = mesh_axes
    # trailing Nones can be dropped (canonical form)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shard_factor(spec: Spec, mesh: MeshShape) -> int:
    """The number of pieces a tensor laid out by `spec` is cut into."""
    n = 1
    for entry in spec:
        if entry is not None:
            n *= _axis_size(mesh, (entry,) if isinstance(entry, str)
                            else entry)
    return n


def is_spec(x) -> bool:
    """A logical-axes tuple or a resolved spec (a leaf of a spec tree)."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str)
        or (isinstance(a, tuple) and all(isinstance(b, str) for b in a))
        for a in x)


def tree_shardings(logical_tree, rules: Rules, mesh: MeshShape,
                   abstract_tree=None):
    """Map a nested dict of logical-axis tuples to specs; when the
    matching tree of tensors (meta or real) is given, the specs are
    shape-validated."""
    if is_spec(logical_tree):
        shape = None if abstract_tree is None else tuple(abstract_tree.shape)
        return resolve_spec(logical_tree, rules, mesh, shape)
    return {k: tree_shardings(v, rules, mesh,
                              None if abstract_tree is None
                              else abstract_tree[k])
            for k, v in logical_tree.items()}


class ShardingCtx:
    """Mesh + rules, or inert. An identity on one device: `__call__`
    returns `x` (see the module docstring for the DTensor hook)."""

    def __init__(self, mesh: Optional[MeshShape] = None,
                 rules: Optional[Rules] = None):
        self.mesh = mesh
        self.rules = rules

    def __call__(self, x, *logical_axes):
        return x

    @property
    def active(self) -> bool:
        return self.mesh is not None and self.rules is not None


INERT = ShardingCtx()
