"""Backend registry for ``repro_torch.solver``.

Counterpart of ``repro.solver.registry``, with the same two surfaces:

1. The class registry (``register_backend``) — what ``plan(...)``
   resolves.  A backend class is built as ``Backend(system, **opts)``,
   holds ``stored`` (the factor) and answers ``solve(rhs)``.
2. The pure-function registry (``register_pure_backend``) — what
   ``factorize`` / ``solve`` resolve: three functions

       build(system, **opts) -> (stored, options)   # factor once
       solve(meta, stored, rhs) -> x
       transpose_solve(meta, stored, rhs) -> x      # adjoint, same stored

   and two optional ones, for a backend whose solves span ranks:
   ``place(meta, rhs) -> rhs`` lays the rhs out before the differentiable
   solve (so its gradient comes back in the caller's layout), and
   ``cotangents(meta, lam, x) -> tuple`` gives the diagonals' gradients
   in place of ``autodiff.diagonal_cotangents``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

_REGISTRY: dict = {}
_PURE_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class PureBackend:
    """The pure-function contract behind ``factorize``/``solve``."""

    name: str
    build: Callable[..., tuple]          # (system, **opts) -> (stored, options)
    solve: Callable[..., Any]            # (meta, stored, rhs) -> x
    transpose_solve: Callable[..., Any]  # (meta, stored, rhs) -> x  (A^T x = rhs)
    place: Callable[..., Any] | None = None       # (meta, rhs) -> rhs
    cotangents: Callable[..., Any] | None = None  # (meta, lam, x) -> tuple


def register_pure_backend(name: str, *, build, solve, transpose_solve,
                          place=None, cotangents=None):
    """Register the pure factor/solve/transpose functions for ``name``."""
    _PURE_REGISTRY[name] = PureBackend(name=name, build=build, solve=solve,
                                       transpose_solve=transpose_solve,
                                       place=place, cotangents=cotangents)
    return _PURE_REGISTRY[name]


def get_pure_backend(name: str) -> PureBackend:
    """The pure hooks behind ``factorize``/``solve`` for ``name``."""
    try:
        return _PURE_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"backend {name!r} has no pure factorize/solve registration; "
            f"available: {sorted(_PURE_REGISTRY)}") from None


def register_backend(name: str):
    """Class decorator: register a solver backend under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_backend(name: str):
    """The backend class registered under ``name`` (what ``plan`` uses)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver backend {name!r}; available: "
            f"{available_backends()}") from None


def available_backends() -> list:
    """Sorted names of every class-registered backend."""
    return sorted(_REGISTRY)


def available_pure_backends() -> list:
    """Sorted names of every pure-registered backend — what ``factorize``
    accepts, and what ``repro_torch.analysis.tracecheck`` enumerates so a
    newly registered backend is held to the host-sync contract
    automatically."""
    return sorted(_PURE_REGISTRY)
