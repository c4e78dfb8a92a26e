"""``plan(system, backend=...) -> Plan`` — the stateful convenience shim.

Counterpart of ``repro.solver.plan``: ``Plan`` resolves the backend,
builds the ``Factorization`` (held by the backend class as ``impl.fact``)
and forwards ``Plan.solve`` to the same differentiable solve.
``storage_bytes`` measures the bytes the plan's LHS state holds, so the
paper's storage claim (~75 % saved by one shared LHS) is measured.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .functional import Factorization, check_options, resolve_backend_name
from .registry import get_backend
from .system import BandedSystem


def _tensors(tree: Any):
    """Every tensor inside a stored factor (dataclasses, dicts, tuples)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for field in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, field.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """A prepared solve: spec + resolved backend + backend state."""

    system: BandedSystem
    backend: str
    impl: Any

    @property
    def factorization(self) -> Factorization:
        return self.impl.fact

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """rhs: (N,) or (N, M) interleaved batch -> x of the same shape."""
        return self.impl.solve(rhs)

    def storage_bytes(self, *, rhs_batch: int | None = None,
                      itemsize: int | None = None) -> dict:
        """Bytes held by the plan's LHS state (and, given ``rhs_batch``,
        by an (N, rhs_batch) RHS at ``itemsize``, default the system
        dtype's)."""
        if itemsize is None:
            itemsize = torch.empty((), dtype=self.system.dtype).element_size()
        lhs = _nbytes(self.impl.stored)
        out = {"lhs_bytes": lhs, "mode": self.system.mode,
               "n": self.system.n, "backend": self.backend}
        if rhs_batch is not None:
            out["rhs_bytes"] = self.system.n * rhs_batch * itemsize
            out["total_bytes"] = lhs + out["rhs_bytes"]
        return out


def plan(system: BandedSystem, backend: str = "auto", **opts) -> Plan:
    """Prepare a solve for ``system`` on ``backend`` (``reference`` or its
    alias ``core``, ``cuda`` or ``"auto"``); ``**opts`` as for
    ``factorize``."""
    check_options(opts)
    backend = resolve_backend_name(system, backend)
    impl = get_backend(backend)(system, **opts)
    return Plan(system=system, backend=backend, impl=impl)
