"""Logical-axis sharding rules and the one-device sharding context
(counterpart of ``repro.sharding``)."""

from .logical import (
    DEFAULT_RULES,
    LogicalRules,
    Mesh,
    ShardingCtx,
    resolve_spec,
)

__all__ = ["DEFAULT_RULES", "LogicalRules", "Mesh", "ShardingCtx",
           "resolve_spec"]
