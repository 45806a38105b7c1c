"""Production meshes.

Single pod: 16×16 = 256 positions, axes ("data", "model").
Multi-pod:  2×16×16 = 512 positions, axes ("pod", "data", "model") — the
"pod" axis is data-parallel across pods.

One position per visible CUDA device: a host with fewer cards than the
mesh has positions is refused. :func:`make_dryrun_mesh` builds the same
two meshes on positions of ``torch.device("meta")``, for the dry run
(:mod:`repro_torch.launch.dryrun`): the counterpart of the reference's 512
forced host devices, on any host. Defined as functions, so importing this
module touches no device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import Mesh, make_mesh

__all__ = ["make_production_mesh", "make_dryrun_mesh", "mesh_device_count"]


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


def make_dryrun_mesh(multi_pod: bool = False) -> Mesh:
    """The production mesh's shape and axes on ``meta`` positions: tensors
    laid over it hold no data, so a full-size cell is built and counted
    without a card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device("meta")])


def mesh_device_count(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256
