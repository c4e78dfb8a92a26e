"""Logical-axis sharding rules, meshes and their DTensor placements
(counterpart of ``repro.sharding``)."""

from .logical import (
    DEFAULT_RULES,
    LogicalRules,
    Mesh,
    NamedSharding,
    ShardingCtx,
    place,
    place_tree,
    ranked_mesh,
    replicated,
    resolve_spec,
)

__all__ = ["DEFAULT_RULES", "LogicalRules", "Mesh", "NamedSharding",
           "ShardingCtx", "place", "place_tree", "ranked_mesh",
           "replicated", "resolve_spec"]
