"""Logical-axis sharding with divisibility-aware first-fit resolution.

Counterpart of ``repro.sharding.logical``.  Every tensor dimension carries
a logical name; rules map names to an ordered list of CANDIDATE mesh-axis
groups.  Resolution walks the dims of a tensor in order and assigns the
first candidate whose mesh axes (a) all exist in the mesh, (b) are not
already used by another dim of the same tensor, and (c) divide the
dimension size evenly.  Unresolvable dims stay replicated.

A mesh here is its axis names and sizes (``Mesh``), with the
``torch.distributed`` ``DeviceMesh`` behind it when it spans ranks
(``Mesh.from_device_mesh``); ``resolve_spec`` returns a tuple with one
entry a dim — a mesh-axis name, a tuple of names for a group, or ``None``
— where JAX returns a ``PartitionSpec``.  Where JAX has a
``NamedSharding``, the port has the mesh and a DTensor placement list
(``NamedSharding.placements``): ``Shard(d)`` on each mesh dim that tensor
dim d takes, ``Replicate()`` on the others; a group such as
``("pod", "data")`` is ``Shard(d)`` on both.  ``ShardingCtx.constrain`` is
``with_sharding_constraint``: the identity on a one-device mesh, else a
DTensor redistributed (or a plain tensor distributed, taken as the same
on every rank) to the resolved placements.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

AxisGroup = tuple[str, ...]


def _as_group(cand) -> AxisGroup:
    if isinstance(cand, str):
        return (cand,)
    return tuple(cand)


# Candidates are ordered: first-fit. Params use FSDP-style data sharding on
# the "embed"-like dims and tensor parallelism on heads/mlp/vocab/experts;
# activations shard batch over data axes and heads/mlp over model.
DEFAULT_RULES: dict[str, list] = {
    # ---- parameter dims ----
    "vocab": ["model"],
    "embed": [("pod", "data")],          # ZeRO-3 / FSDP shard of weights
    "mlp": ["model"],
    "heads": ["model"],
    "kv": ["model"],
    "head_dim": ["model"],
    "experts": ["model"],                # expert parallelism
    "expert_mlp": [],                    # within-expert ff dim (EP already used)
    "layers": [],                        # stacked-layer axis — never sharded
    "conv": [],
    "state": [],                         # SSM state dim
    # ---- activation dims ----
    "act_batch": [("pod", "data")],
    "act_seq": [],                       # attention-internal seq dim
    "act_res_seq": [],                   # residual stream between blocks;
                                         # ["model"] = Megatron sequence-parallel
    "act_embed": [],
    "act_heads": ["model"],
    "act_mlp": ["model"],
    "act_experts": ["model"],
    "act_kv": ["model"],
    "act_kv_seq": ["model"],             # decode-cache fallback chain kv -> kv_seq
    "act_head_dim": ["model"],
    "act_vocab": ["model"],
    "act_state": [],
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh by its axis names and sizes, and the ``DeviceMesh``
    of ranks behind it (``None``: names and sizes only, which resolve
    specs but place nothing on more than one device)."""

    axis_names: tuple
    shape: tuple
    device_mesh: DeviceMesh | None = dataclasses.field(default=None,
                                                       compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} vs shape "
                             f"{self.shape}")

    @classmethod
    def local(cls, axes: Sequence[str] = ("data", "model")) -> "Mesh":
        """The one-device mesh with every axis of size 1."""
        return cls(tuple(axes), (1,) * len(axes))

    @classmethod
    def from_device_mesh(cls, device_mesh: DeviceMesh) -> "Mesh":
        """The mesh of a named ``DeviceMesh``, which it keeps."""
        if device_mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        return cls(tuple(device_mesh.mesh_dim_names),
                   tuple(device_mesh.mesh.shape), device_mesh)

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def placements(self, spec: Sequence) -> tuple:
        """The DTensor placements of a resolved spec: one a mesh dim,
        ``Shard(d)`` where tensor dim d takes the mesh dim, else
        ``Replicate()``.  A group shards its dim over its mesh dims in
        mesh order (DTensor's nesting), so it must name them in that
        order, as every rule does."""
        out = [Replicate()] * len(self.axis_names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            group = _as_group(entry)
            dims = [self.axis_names.index(a) for a in group]
            if dims != sorted(dims):
                raise ValueError(f"axis group {group} is not in the mesh's "
                                 f"order {self.axis_names}: a DTensor "
                                 "shards one dim over mesh dims in order")
            for i in dims:
                out[i] = Shard(d)
        return tuple(out)


def ranked_mesh(mesh) -> Mesh:
    """``mesh`` (a ``Mesh`` or a named ``DeviceMesh``) as a ``Mesh`` with
    ranks behind it; a mesh of names and sizes only is refused."""
    if isinstance(mesh, DeviceMesh):
        mesh = Mesh.from_device_mesh(mesh)
    if mesh.device_mesh is None:
        raise ValueError("a mesh of names and sizes only has no ranks "
                         "behind it: build it from a DeviceMesh "
                         "(Mesh.from_device_mesh)")
    return mesh


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Counterpart of ``jax.sharding.NamedSharding``: a mesh and one
    DTensor placement a mesh dim."""

    mesh: Mesh
    placements: tuple


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, (Replicate(),) * len(mesh.axis_names))


def place(x, sharding: NamedSharding):
    """``x`` laid out as ``sharding`` says (``device_put``): a DTensor is
    redistributed; a plain tensor, the same on every rank, is cut into
    this rank's shard without communication.  The identity on a
    one-device mesh."""
    if sharding.mesh.size == 1:
        return x
    dm = ranked_mesh(sharding.mesh).device_mesh
    if isinstance(x, DTensor):
        return x.redistribute(dm, sharding.placements)
    return distribute_tensor(x, dm, sharding.placements, src_data_rank=None)


def _column_placements(mesh: Mesh, batch_axis) -> tuple:
    """``Shard(1)`` on the batch axes, ``Replicate()`` elsewhere."""
    return mesh.placements((None, batch_axis))


def sharded_columns(local: torch.Tensor, mesh: Mesh, batch_axis,
                    m: int) -> DTensor:
    """This rank's columns ``local`` (N, cols) of an (N, M) tensor as the
    DTensor ``Shard(1)`` over the batch axes they belong to."""
    n = local.shape[0]
    return DTensor.from_local(local, mesh.device_mesh,
                              _column_placements(mesh, batch_axis),
                              run_check=False, shape=torch.Size((n, m)),
                              stride=(m, 1))


def shard_rhs(rhs, mesh: Mesh, batch_axis, device=None) -> DTensor:
    """``rhs`` (N, M) as a DTensor ``Shard(1)`` over the batch axes of
    ``mesh``: a DTensor is redistributed (free from ``Shard(1)`` or
    ``Replicate()``), a plain tensor (moved to ``device`` when given) is
    taken as replicated and cut without communication.  Differentiable, so
    the gradient comes back in the caller's layout."""
    if rhs.ndim != 2:
        raise ValueError(
            f"the sharded backend shards the M axis of an (N, M) rhs, or "
            f"solves an (N,) rhs as one column; got {tuple(rhs.shape)}")
    dm = mesh.device_mesh
    if not isinstance(rhs, DTensor):
        rhs = DTensor.from_local(rhs if device is None else rhs.to(device),
                                 dm, (Replicate(),) * dm.ndim,
                                 run_check=False)
    elif rhs.device_mesh != dm:
        raise ValueError("rhs lies on another device mesh than the "
                         "factorization's")
    return rhs.redistribute(dm, _column_placements(mesh, batch_axis))


def place_tree(tree, shardings):
    """``place`` on every leaf of a tree (nested dicts, tuples and lists)
    against the matching leaf of ``shardings``; a ``None`` sharding leaves
    its leaf as it is."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        if not isinstance(shardings, dict) or set(tree) != set(shardings):
            raise ValueError(f"tree keys {sorted(tree)} do not match the "
                             "shardings' keys")
        return {k: place_tree(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, (tuple, list)):
        if len(tree) != len(shardings):
            raise ValueError(f"a sequence of {len(tree)} leaves against "
                             f"{len(shardings)} shardings")
        return type(tree)(place_tree(t, s) for t, s in zip(tree, shardings))
    return place(tree, shardings)


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    table: Mapping[str, list]

    @classmethod
    def default(cls) -> "LogicalRules":
        return cls(dict(DEFAULT_RULES))

    def override(self, **updates) -> "LogicalRules":
        t = dict(self.table)
        t.update(updates)
        return LogicalRules(t)

    def candidates(self, name: str) -> list[AxisGroup]:
        return [_as_group(c) for c in self.table.get(name, [])]


def resolve_spec(names: Sequence[str | None], shape: Sequence[int],
                 mesh: Mesh, rules: LogicalRules) -> tuple:
    """First-fit resolution of logical dim names -> one entry a dim: a
    mesh-axis name, a tuple of them, or ``None`` (replicated)."""
    if len(names) != len(shape):
        raise ValueError(f"names {names} vs shape {shape}")
    used: set[str] = set()
    out: list = []
    axis_sizes = mesh.axis_sizes
    for name, dim in zip(names, shape):
        assigned = None
        if name is not None:
            for cand in rules.candidates(name):
                axes = tuple(a for a in cand if a in axis_sizes)
                if not axes or any(a in used for a in axes):
                    continue
                size = math.prod(axis_sizes[a] for a in axes)
                if size > 1 and dim % size == 0:
                    assigned = axes if len(axes) > 1 else axes[0]
                    used.update(axes)
                    break
        out.append(assigned)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Carries (mesh, rules) through model code."""

    mesh: Mesh
    rules: LogicalRules

    @classmethod
    def local(cls) -> "ShardingCtx":
        """One device, the default rules."""
        return cls(mesh=Mesh.local(), rules=LogicalRules.default())

    def spec(self, names: Sequence[str | None], shape: Sequence[int]) -> tuple:
        return resolve_spec(names, shape, self.mesh, self.rules)

    def sharding(self, names: Sequence[str | None],
                 shape: Sequence[int]) -> NamedSharding:
        return NamedSharding(self.mesh,
                             self.mesh.placements(self.spec(names, shape)))

    def constrain(self, x, names: Sequence[str | None]):
        """``with_sharding_constraint`` by logical names: the identity on
        a one-device mesh (the names are still checked against x's
        rank), else ``x`` placed on the resolved placements."""
        return place(x, self.sharding(names, x.shape))

    def tree_shardings(self, spec_tree) -> Any:
        """Map a nested dict of ParamSpec-likes (objects with .shape and
        .names) to NamedShardings."""
        if isinstance(spec_tree, dict):
            return {k: self.tree_shardings(v) for k, v in spec_tree.items()}
        return self.sharding(spec_tree.names, spec_tree.shape)
