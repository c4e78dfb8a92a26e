"""Production mesh builders (counterpart of ``repro.launch.mesh``).

The mesh is a ``torch.distributed`` ``DeviceMesh`` over the default
process group's ranks, one rank a device, kept in a
``repro_torch.sharding.Mesh``.  Functions, not module constants: importing
this module touches no process group.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding import Mesh
from repro_torch.solver.system import resolve_device


def mesh_over_ranks(shape: Sequence[int], axes: Sequence[str], *,
                    device=None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    default process group, in rank order.  Every rank of the group calls
    it (the mesh's groups are made collectively); a rank outside the mesh
    gets it too, with no coordinate in it.  ``device`` picks the device
    type, the CUDA device unless the caller asks for the CPU."""
    device_type = resolve_device(device).type
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return Mesh.from_device_mesh(
        DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes)))


def production_shape(*, multi_pod: bool = False) -> tuple:
    """``(shape, axes)`` of the production mesh: 16x16 = 256 devices a pod
    ("data", "model"); 2 pods = 512 with a leading "pod" axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The ``production_shape`` mesh over the default group's ranks."""
    shape, axes = production_shape(multi_pod=multi_pod)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — run under "
            f"torchrun with {n} ranks (one a device), or call "
            f"torch.distributed.init_process_group at that world size")
    return mesh_over_ranks(shape, axes, device=device)


def make_local_mesh(axes=("data", "model")) -> Mesh:
    """Single-device mesh for CPU tests/examples."""
    return Mesh.local(axes)
