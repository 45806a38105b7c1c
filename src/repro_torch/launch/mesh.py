"""Production meshes.

Single pod: 16×16 = 256 positions, axes ("data", "model").
Multi-pod:  2×16×16 = 512 positions, axes ("pod", "data", "model") — the
"pod" axis is data-parallel across pods.

One position per visible CUDA device: a host with fewer cards than the
mesh has positions is refused. Defined as a function, so importing this
module touches no device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import Mesh, make_mesh

__all__ = ["make_production_mesh", "mesh_device_count"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    found = torch.cuda.device_count()
    if found < n:
        raise RuntimeError(
            f"need {n} CUDA devices for mesh {shape}, found {found} — a "
            "smaller mesh of one card's positions comes from "
            "repro_torch.dist.make_mesh"
        )
    return make_mesh(shape, axes, [torch.device("cuda", i) for i in range(n)])


def mesh_device_count(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256
