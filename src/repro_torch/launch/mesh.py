"""The port's mesh: one card (counterpart of `repro.launch.mesh`).

The reference lays its chips out as a (16, 16) pod, axes ("data",
"model"), or a (2, 16, 16) multi-pod mesh, axes ("pod", "data",
"model"), and tests on small meshes of host devices.  The port runs on
one NVIDIA H100, so its mesh is a mapping of axis names to sizes,
`single_card_mesh()` = ``{"data": 1, "model": 1}``, which
`sharding.rules.ShardCtx` reads where the reference reads
``mesh.shape``.  `dp_axes`, `dp_size` and `model_axis_size` take any such
mapping, so the tests can hold the port's sharding rules against the
reference's on its multi-device meshes.

Left out: `make_production_mesh` and `make_test_mesh`.  One card has no
pod or multi-pod mesh, and the port has no host devices to lay out.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

MeshShape = Mapping[str, int]


def single_card_mesh() -> Dict[str, int]:
    """The axis sizes of one card: data and model parallelism of 1."""
    return {"data": 1, "model": 1}


def dp_axes(mesh: MeshShape) -> Tuple[str, ...]:
    return tuple(a for a in mesh if a in ("pod", "data"))


def dp_size(mesh: MeshShape) -> int:
    return int(math.prod(mesh[a] for a in dp_axes(mesh)))


def model_axis_size(mesh: MeshShape) -> int:
    return int(mesh.get("model", 1))
