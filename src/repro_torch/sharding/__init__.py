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
    shard_rhs,
    sharded_columns,
)

__all__ = ["DEFAULT_RULES", "LogicalRules", "Mesh", "NamedSharding",
           "ShardingCtx", "place", "place_tree", "ranked_mesh",
           "replicated", "resolve_spec", "shard_rhs", "sharded_columns"]
