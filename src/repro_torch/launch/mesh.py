"""Production meshes, as shapes: the port of the JAX package's
`launch/mesh.py`.

Single pod : (data=16, model=16)        = 256 chips
Multi-pod  : (pod=2, data=16, model=16) = 512 chips

The port drives one device a process, so a mesh here holds no devices:
it is the `sharding.rules.MeshShape` that the sharding rules resolve on
and the dry run reports against. The reference's hardware constants
(peak rate, memory and link bandwidths) are not carried over: peaks are
always the caller's (`launch/roofline.py`).
"""
from __future__ import annotations

import math

from repro_torch.sharding.rules import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_cpu_mesh() -> MeshShape:
    """The 1-device mesh of the smoke tests."""
    return MeshShape(("data", "model"), (1, 1))


def mesh_chips(mesh: MeshShape) -> int:
    return math.prod(mesh.sizes)
