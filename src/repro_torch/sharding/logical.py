"""Logical-axis sharding with divisibility-aware first-fit resolution.

Counterpart of ``repro.sharding.logical``.  Every tensor dimension carries
a logical name; rules map names to an ordered list of CANDIDATE mesh-axis
groups.  Resolution walks the dims of a tensor in order and assigns the
first candidate whose mesh axes (a) all exist in the mesh, (b) are not
already used by another dim of the same tensor, and (c) divide the
dimension size evenly.  Unresolvable dims stay replicated.

A mesh here is its axis names and sizes (``Mesh``); ``resolve_spec``
returns a tuple with one entry a dim — a mesh-axis name, a tuple of names
for a group, or ``None`` — where JAX returns a ``PartitionSpec``.  The
port runs on one device: ``ShardingCtx.constrain`` is the identity on a
one-device mesh and refuses a larger one, since no multi-device backend
is ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

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
    """A device mesh by its axis names and sizes (no devices attached)."""

    axis_names: tuple
    shape: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} vs shape "
                             f"{self.shape}")

    @classmethod
    def local(cls, axes: Sequence[str] = ("data", "model")) -> "Mesh":
        """The one-device mesh with every axis of size 1."""
        return cls(tuple(axes), (1,) * len(axes))

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


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

    def constrain(self, x, names: Sequence[str | None]):
        """The placement of ``x`` by logical names: the identity on a
        one-device mesh (the names are still checked against x's rank)."""
        self.spec(names, x.shape)
        if self.mesh.size != 1:
            raise NotImplementedError(
                f"a {self.mesh.size}-device mesh: repro_torch runs on one "
                "device; multi-device placement comes with the "
                "torch.distributed backend (ROADMAP Queue 1)")
        return x
