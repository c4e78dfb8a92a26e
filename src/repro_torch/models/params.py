"""Parameter specification trees: one definition -> init / cache / checks.

Counterpart of ``repro.models.params``.  Model builders return nested
dicts of ``ParamSpec``; ``abstract_params`` gives their shapes and dtypes
as ``meta`` tensors (no allocation); ``init_params`` materialises them on
an explicit device from an explicit ``torch.Generator``, by JAX's rule:
zeros, ones, or ``scale · N(0, 1)`` drawn in fp32 with ``scale = 1 /
sqrt(fan_in)``, fan-in ``shape[-2]``, unless the spec gives one.  The
draws cannot match
JAX's random stream; ``repro_torch.convert`` carries JAX-made parameters
over where the two packages must compute with the same weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    names: tuple                 # logical axis names, len == len(shape)
    dtype: Any = torch.bfloat16
    init: str = "normal"         # normal | zeros | ones
    scale: float | None = None   # overrides the fan-in default

    def __post_init__(self):
        assert len(self.shape) == len(self.names), (self.shape, self.names)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in sorted-key order (JAX's)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves) -> dict:
    """``tree``'s nesting with ``leaves`` (in ``tree_leaves``' sorted-key
    order) at its leaves."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(tree)


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_zip_map(fn, tree, *rest):
    """``fn`` applied to every leaf of ``tree`` and the matching leaves of
    ``rest``, nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_zip_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    return fn(tree, *rest)


def check_tree(spec_tree, tree, path: str = "") -> None:
    """Raise unless ``tree`` has ``spec_tree``'s keys, and a tensor of each
    spec's shape and dtype at every leaf."""
    if isinstance(spec_tree, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec_tree):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'tree'}: keys {got}, expected "
                             f"{sorted(spec_tree)}")
        for k in spec_tree:
            check_tree(spec_tree[k], tree[k], f"{path}/{k}")
        return
    if tuple(tree.shape) != tuple(spec_tree.shape) or \
            tree.dtype != spec_tree.dtype:
        raise ValueError(f"{path}: {tuple(tree.shape)} {tree.dtype}, expected "
                         f"{tuple(spec_tree.shape)} {spec_tree.dtype}")


def tree_size(spec_tree) -> int:
    """The number of parameters ``spec_tree`` describes."""
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


def abstract_params(spec_tree) -> dict:
    """``spec_tree`` with a ``meta``-device tensor of each spec's shape and
    dtype at every leaf: the shapes of the parameters with nothing
    allocated (the counterpart of JAX's ``ShapeDtypeStruct`` stand-ins, on
    which the dry-run never materialises the 1T-parameter configs)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def init_params(spec_tree, generator: torch.Generator, *, device) -> dict:
    """Materialise ``spec_tree`` on ``device`` (the generator's device),
    leaf by leaf in sorted-key order."""
    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        scale = s.scale if s.scale is not None else 1.0 / math.sqrt(
            max(fan_in, 1))
        draw = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                           device=device)
        # scaled in place: a bf16 leaf costs 4 + 2 B an element at its
        # peak, not 4 + 4 + 2 (kimi-k2's one-layer experts: 5.6 G each)
        return draw.mul_(scale).to(s.dtype)

    values = iter([one(s) for s in tree_leaves(spec_tree)])

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(values)

    return rebuild(spec_tree)
