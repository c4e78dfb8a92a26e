"""``sharded`` backend: the paper's single-LHS idea across ranks.

Counterpart of ``repro.solver.sharded``, on ``torch.distributed``: one
copy of the factored LHS per RANK (replicated: the paper's kN-word saving
applied per rank), the M system axis sharded over a mesh axis, and no
collective in the solve: systems are independent, so each rank solves its
own columns.

  * The mesh is a ``repro_torch.sharding.Mesh`` over a ``DeviceMesh``;
    without one, ``default_mesh()``: 1-D, named ``"batch"``, over the
    default process group's world.  There is no implicit one-rank group:
    without ``init_process_group`` (or ``torchrun``) ``factorize`` raises.
  * M is split as DTensor's ``Shard(1)`` splits it: ``ceil(M / n)``
    columns a rank and fewer on the last ones (uneven shards, no padding),
    so there is no padded lane to reach the output.  A tuple
    ``batch_axis`` shards M over several mesh dims, nested in mesh order.
  * ``rhs`` (N, M) is a DTensor or a plain tensor, taken as the same on
    every rank; ``x`` comes back a DTensor, ``Shard(1)`` over the batch
    axis.  A DTensor already sharded so costs nothing to lay out.  An
    (N,) rhs is solved as one column (the first rank's; the others hold
    none) and comes back (N,), a DTensor replicated on every rank.
  * Each rank runs the ``cuda`` backend on its columns (the hand-written
    kernels on CUDA tensors, their plain versions on CPU tensors) or the
    ``reference`` sweeps: the ``kernels`` policy, resolved at factorize
    time.  In ``mode="batch"`` a rank holds only its own systems'
    diagonals, each a DTensor ``Shard(1)``.
  * The adjoint runs the same way on the same stored factor.  The
    diagonals' gradient ``-Σ_m λ·roll(x)`` sums over the sharded M: each
    rank sums its own columns and ONE all-reduce over the batch axis adds
    the ranks' sums; it is the only collective on the path.  A plain
    ``rhs`` that requires grad gets its gradient through DTensor's layout
    change back to replicated (an all-gather of λ); a DTensor ``rhs`` gets
    λ in its own layout, with no collective.
  * Each rank's device is ``cuda:{LOCAL_RANK % device_count()}`` for a
    system on CUDA, so that ranks can share a card, and the system's own
    device (the CPU) otherwise.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate

from ..kernels import ops as _kops
from ..sharding import Mesh, ranked_mesh
from . import cuda as _cuda
from . import reference as _ref
from .autodiff import diagonal_cotangents
from .registry import register_backend, register_pure_backend
from .system import BandedSystem

#: What each shard runs.  "auto" = the cuda backend wherever it has a
#: kernel (every mode but periodic batch), else the reference sweeps;
#: "cuda" forces it (raising where it has none); "reference" keeps the
#: plain-torch sweeps.
KERNEL_POLICIES = ("auto", "cuda", "reference")

_NO_GROUP = (
    "the sharded backend spans the ranks of a torch.distributed process "
    "group and none is initialised: call "
    "torch.distributed.init_process_group first, or launch with torchrun "
    "(there is no implicit one-rank group)")


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(_NO_GROUP)


def default_mesh(axis_name: str = "batch", *,
                 device_type: str = "cuda") -> Mesh:
    """1-D mesh over every rank of the default process group."""
    _require_group()
    return Mesh.from_device_mesh(init_device_mesh(
        device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,)))


def _axes(batch_axis) -> tuple:
    return batch_axis if isinstance(batch_axis, tuple) else (batch_axis,)


def resolve_mesh(mesh, batch_axis, device_type: str = "cuda"):
    """(mesh, batch_axis, n_shards) with the JAX package's defaulting: no
    mesh means ``default_mesh()`` on its one axis; no ``batch_axis`` means
    the mesh's last axis.  ``mesh`` is a ``Mesh`` or a named
    ``DeviceMesh``."""
    if mesh is None:
        mesh = default_mesh(device_type=device_type)
        batch_axis = mesh.axis_names[0]
    else:
        mesh = ranked_mesh(mesh)
        if batch_axis is None:
            batch_axis = mesh.axis_names[-1]
    n_shards = math.prod(mesh.axis_sizes[a] for a in _axes(batch_axis))
    return mesh, batch_axis, n_shards


def shard_lanes(m: int, n_shards: int) -> int:
    """Columns of the fullest shard: M split as ``Shard(1)`` gives
    ``ceil(M / n)`` to the first shards and what is left to the last."""
    return -(-m // n_shards)


def lane_range(m: int, mesh: Mesh, batch_axis) -> tuple:
    """This rank's columns ``[lo, hi)`` of M, as DTensor's ``Shard(1)``
    over the batch axes cuts them: ``ceil(len / size)`` a shard over each
    mesh dim in turn, in mesh order.  Possibly empty."""
    coords = mesh.device_mesh.get_coordinate()
    lo, length = 0, m
    for i in sorted(mesh.axis_names.index(a) for a in _axes(batch_axis)):
        chunk = shard_lanes(length, mesh.shape[i])
        start = min(coords[i] * chunk, length)
        lo, length = lo + start, min(start + chunk, length) - start
    return lo, lo + length


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count()}`` for a
    system on CUDA, else the system's own."""
    if device.type != "cuda":
        return device
    # an environment string or the rank, a Python int
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))  # speclint: allow-concretize
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def local_system(system: BandedSystem, device: torch.device,
                 lanes: int | None = None) -> BandedSystem:
    """The spec one RANK sees: the same N and diagonals (the sweep axis is
    never sharded) on the rank's device and, in batch mode, its own
    ``lanes`` systems."""
    local = dataclasses.replace(
        system, diagonals=tuple(d.to(device) for d in system.diagonals))
    if system.mode == "batch":
        local = dataclasses.replace(local, batch=lanes)
    return local


def _placements(mesh: Mesh, batch_axis) -> tuple:
    """``Shard(1)`` on the batch axes, ``Replicate()`` elsewhere."""
    return mesh.placements((None, batch_axis))


def _sharded(local: torch.Tensor, mesh: Mesh, batch_axis,
             m: int) -> DTensor:
    n = local.shape[0]
    return DTensor.from_local(local, mesh.device_mesh,
                              _placements(mesh, batch_axis), run_check=False,
                              shape=torch.Size((n, m)), stride=(m, 1))


def place_rhs(meta, rhs):
    """``rhs`` (N, M) as a DTensor ``Shard(1)`` over the batch axes: a
    DTensor is redistributed (free from ``Shard(1)`` or ``Replicate()``),
    a plain tensor is taken as replicated and cut without communication.
    Differentiable, so the gradient comes back in the caller's layout."""
    if rhs.ndim != 2:
        raise ValueError(
            f"the sharded backend shards the M axis of an (N, M) rhs, or "
            f"solves an (N,) rhs as one column; got {tuple(rhs.shape)}")
    mesh, batch_axis = meta.opt("mesh"), meta.opt("batch_axis")
    dm = mesh.device_mesh
    if not isinstance(rhs, DTensor):
        rhs = DTensor.from_local(rhs.to(meta.opt("device")), dm,
                                 (Replicate(),) * dm.ndim, run_check=False)
    elif rhs.device_mesh != dm:
        raise ValueError("rhs lies on another device mesh than the "
                         "factorization's")
    return rhs.redistribute(dm, _placements(mesh, batch_axis))


def _dispatch(meta, stored, rhs, *, transposed: bool) -> DTensor:
    # `kernels` is RESOLVED at factorize time: the stored factor's layout
    # is bound to the policy that built it (recorded as `shard_build`), so
    # a later `with_options(fact, kernels=...)` would dispatch a mismatched
    # factor.
    if rhs.ndim == 1:                # one column, returned (N,) as JAX's
        return _dispatch(meta, stored, rhs[:, None],
                         transposed=transposed)[:, 0]
    kernels = meta.opt("kernels")
    if kernels != meta.opt("shard_build"):
        raise ValueError(
            "the sharded backend's `kernels` policy is resolved at factorize "
            "time and cannot be overridden per call; re-factorize with "
            f"kernels={kernels!r} instead")
    rhs = place_rhs(meta, rhs)
    local = rhs.to_local().contiguous()
    if meta.mode == "batch":
        stored = {k: v.to_local() for k, v in stored.items()}
    if local.shape[1] == 0:          # a rank past the last column
        x = torch.empty_like(local)
    elif kernels == "cuda":
        fn = (_cuda.transpose_solve_stored if transposed
              else _cuda.solve_stored)
        x = fn(meta.bandwidth, meta.mode, meta.periodic, stored, local,
               storage_dtype=meta.opt("storage_dtype"))
    else:
        fn = _ref.transpose_solve_stored if transposed else _ref.solve_stored
        x = fn(meta.bandwidth, meta.mode, meta.periodic, meta.n, stored,
               local, method=meta.opt("method", "scan"))
    return _sharded(x, meta.opt("mesh"), meta.opt("batch_axis"),
                    rhs.shape[1])


# -- the pure-function contract (repro_torch.solver.functional) --------------

def _pure_build(system: BandedSystem, *, mesh=None, batch_axis=None,
                kernels: str = "auto", method: str = "scan",
                storage_dtype=None, **_ignored):
    if kernels == "pallas":
        raise ValueError("kernels='pallas' names the TPU kernels; the "
                         "port's per-shard kernels are kernels='cuda'")
    if kernels not in KERNEL_POLICIES:
        raise ValueError(f"kernels must be one of {KERNEL_POLICIES}, "
                         f"got {kernels!r}")
    _require_group()
    device = rank_device(system.device)
    mesh, batch_axis, n_shards = resolve_mesh(mesh, batch_axis, device.type)
    if mesh.device_mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_mesh.device_type} mesh for a "
                         f"system on {device.type}")
    if kernels == "auto":
        kernels = ("reference" if system.mode == "batch" and system.periodic
                   else "cuda")
    lanes = None
    if system.mode == "batch":
        lo, hi = lane_range(system.batch, mesh, batch_axis)
        lanes = hi - lo
    local = local_system(system, device, lanes)
    if kernels == "cuda":
        stored = _cuda.build_stored(local)
    else:
        stored = _ref.build_stored(local, method=method)
    if system.mode == "batch":
        stored = {k: _sharded(v, mesh, batch_axis, system.batch)
                  for k, v in stored.items()}
    return stored, {
        "mesh": mesh, "batch_axis": batch_axis, "n_shards": n_shards,
        "device": device, "kernels": kernels, "shard_build": kernels,
        "method": method,
        "storage_dtype": _kops.canonical_storage_dtype(storage_dtype)}


def _pure_solve(meta, stored, rhs):
    return _dispatch(meta, stored, rhs, transposed=False)


def _pure_transpose(meta, stored, rhs):
    # The adjoint is sharded too: transposed systems are just as
    # independent over M, so each rank runs the transposed sweeps on its
    # columns, reusing the SAME stored factor as the forward solve.
    return _dispatch(meta, stored, rhs, transposed=True)


def _pure_cotangents(meta, lam: DTensor, x: DTensor) -> tuple:
    """``autodiff.diagonal_cotangents`` over this rank's columns, then one
    all-reduce (a sum) of the stacked (bw, N) sums over the batch axis.  A
    group of batch axes reduces over each of its mesh dims in turn."""
    local = torch.stack(diagonal_cotangents(meta, lam.to_local(),
                                            x.to_local()))
    dm = meta.opt("mesh").device_mesh
    for axis in _axes(meta.opt("batch_axis")):
        dist.all_reduce(local, group=dm.get_group(axis))
    return tuple(local.unbind(0))


register_pure_backend("sharded", build=_pure_build, solve=_pure_solve,
                      transpose_solve=_pure_transpose, place=place_rhs,
                      cotangents=_pure_cotangents)


@register_backend("sharded")
class ShardedBackend:
    """The sharded solve behind ``plan``: the LHS replicated per rank
    (batch mode: sharded with its systems), each rank running the
    ``kernels`` policy's sweeps on its columns."""

    def __init__(self, system: BandedSystem, **opts):
        from .functional import factorize
        self.system = system
        self.fact = factorize(system, backend="sharded", **opts)
        self.stored = self.fact.stored
        meta = self.fact.meta
        self.mesh = meta.opt("mesh")
        self.batch_axis = meta.opt("batch_axis")
        self.n_shards = meta.opt("n_shards")
        self.kernels = meta.opt("kernels")

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        from .autodiff import solve as _solve
        return _solve(self.fact, rhs)
