"""``reference`` backend: the plain-torch sweeps of ``repro_torch.core``.

Counterpart of ``repro.solver.reference``: the oracle the other backend
is tested against, and the only backend of periodic ``batch`` mode.
Module-level functions carry the logic:

  * ``build_stored(system)``   — factor once (constant/uniform) or tile the
    per-system LHS copies (batch);
  * ``expand_uniform(...)``    — re-broadcast the scalar diagonal of a
    uniform-mode factor to a vector;
  * ``solve_stored(...)`` / ``transpose_solve_stored(...)`` — A x = rhs
    and A^T x = rhs from the SAME stored factor.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import penta as _penta
from ..core import tridiag as _tridiag
from .registry import register_backend, register_pure_backend
from .system import BandedSystem


def build_stored(system: BandedSystem, *, method: str = "scan",
                 scalarize_uniform: bool = True):
    """Factor (constant/uniform) or materialise per-system copies (batch).

    ``scalarize_uniform=False`` keeps uniform-mode factors full-vector (the
    cuda backend stacks them into the kernel's LHS)."""
    n, diags = system.n, system.diagonals

    if system.mode == "batch":
        m = system.batch
        return {k: v[:, None].expand(n, m).clone()
                for k, v in zip(system.diagonal_names, diags)}

    uniform = system.mode == "uniform" and scalarize_uniform

    if system.bandwidth == 3:
        if system.periodic:
            f = _tridiag.periodic_thomas_factor(*diags, method=method)
            if uniform:
                # all-equal diagonals: store `a` as 0-d (O(2N) storage)
                f = dataclasses.replace(f, factor=dataclasses.replace(
                    f.factor, a=f.factor.a[1]))
        else:
            f = _tridiag.thomas_factor(*diags, method=method)
            if uniform:
                f = dataclasses.replace(f, a=f.a[1])
        return f

    if system.periodic:
        f = _penta.periodic_penta_factor(*diags)
        if uniform:
            # cuPentUniformBatch: drop the eps (= a) vector -> scalar
            f = dataclasses.replace(f, factor=dataclasses.replace(
                f.factor, eps=f.factor.eps[2]))
    else:
        f = _penta.penta_factor(*diags)
        if uniform:
            f = dataclasses.replace(f, eps=f.eps[2])
    return f


def expand_uniform(bandwidth: int, periodic: bool, n: int, stored):
    """Uniform mode stores one diagonal as a scalar; expand it for solving."""
    inner = stored.factor if periodic else stored
    if bandwidth == 3:
        a = inner.a.expand(n).clone()
        a.select(0, 0).fill_(0)      # no host copy of the 0
        inner = dataclasses.replace(inner, a=a)
    else:
        eps = inner.eps.expand(n).clone()
        eps[:2] = 0
        inner = dataclasses.replace(inner, eps=eps)
    return dataclasses.replace(stored, factor=inner) if periodic else inner


def _expand_if_scalarized(bandwidth: int, periodic: bool, n: int, stored):
    """Expand a uniform-scalarized factor; pass full factors through."""
    inner = stored.factor if periodic else stored
    leaf = inner.a if bandwidth == 3 else inner.eps
    if leaf.ndim == 0:
        return expand_uniform(bandwidth, periodic, n, stored)
    return stored


def batch_diagonals(bandwidth: int, stored: dict) -> tuple:
    """The per-system (N, M) diagonal copies of a batch-mode stored state,
    sub-most first."""
    names = ("a", "b", "c") if bandwidth == 3 else ("a", "b", "c", "d", "e")
    return tuple(stored[k] for k in names)


def transposed_batch_diagonals(bandwidth: int, stored: dict) -> tuple:
    """The per-system diagonals of A^T: sub-diagonal k of A^T is
    super-diagonal k of A shifted down k rows.  The entries ``torch.roll``
    wraps across a Dirichlet boundary only ever multiply a zero carry of
    the sweeps, so they are inert."""
    s = stored
    if bandwidth == 3:
        return (torch.roll(s["c"], 1, 0), s["b"], torch.roll(s["a"], -1, 0))
    return (torch.roll(s["e"], 2, 0), torch.roll(s["d"], 1, 0), s["c"],
            torch.roll(s["b"], -1, 0), torch.roll(s["a"], -2, 0))


def _per_column(one, diags: tuple, rhs: torch.Tensor) -> torch.Tensor:
    """Run ``one(*diagonals, rhs)`` on each system of a batch-mode stack
    (the periodic factor couples a system's corners, so it factors alone)."""
    cols = [one(*(v[:, j] for v in diags), rhs[:, j])
            for j in range(rhs.shape[1])]
    return torch.stack(cols, dim=1)


def _batch_solve(bandwidth: int, periodic: bool, diags: tuple, rhs,
                 method: str):
    """cuThomasBatch / cuPentBatch semantics: factor fused into the solve."""
    if bandwidth == 3:
        if periodic:
            def one(a, b, c, r):
                pf = _tridiag.periodic_thomas_factor(a, b, c, method=method)
                return _tridiag.periodic_thomas_solve(pf, r, method=method)
            return _per_column(one, diags, rhs)
        f = _tridiag.thomas_factor(*diags, method=method)
        return _tridiag.thomas_solve(f, rhs, method=method)
    if periodic:
        def one(a, b, c, d, e, r):
            pf = _penta.periodic_penta_factor(a, b, c, d, e)
            return _penta.periodic_penta_solve(pf, r, method=method)
        return _per_column(one, diags, rhs)
    return _penta.penta_solve(_penta.penta_factor(*diags), rhs, method=method)


def solve_stored(bandwidth: int, mode: str, periodic: bool, n: int, stored,
                 rhs: torch.Tensor, *, method: str = "scan") -> torch.Tensor:
    """Solve given (meta, stored factor, rhs). rhs: (N,) or (N, M)."""
    if mode == "batch":
        return _batch_solve(bandwidth, periodic,
                            batch_diagonals(bandwidth, stored), rhs, method)
    f = _expand_if_scalarized(bandwidth, periodic, n, stored)
    if bandwidth == 3:
        if periodic:
            return _tridiag.periodic_thomas_solve(f, rhs, method=method)
        return _tridiag.thomas_solve(f, rhs, method=method)
    if periodic:
        return _penta.periodic_penta_solve(f, rhs, method=method)
    return _penta.penta_solve(f, rhs, method=method)


def transpose_solve_stored(bandwidth: int, mode: str, periodic: bool, n: int,
                           stored, rhs: torch.Tensor, *,
                           method: str = "scan") -> torch.Tensor:
    """Solve A^T x = rhs from the SAME stored factor (the adjoint sweeps).

    constant/uniform: A = L·U means A^T = U^T·L^T from the forward's
    vectors.  batch mode has no stored factor, so the transposed diagonals
    are the per-system copies rolled (``transposed_batch_diagonals``)."""
    if mode == "batch":
        return _batch_solve(bandwidth, periodic,
                            transposed_batch_diagonals(bandwidth, stored),
                            rhs, method)
    f = _expand_if_scalarized(bandwidth, periodic, n, stored)
    if bandwidth == 3:
        if periodic:
            return _tridiag.periodic_thomas_solve_t(f, rhs, method=method)
        return _tridiag.thomas_solve_t(f, rhs, method=method)
    if periodic:
        return _penta.periodic_penta_solve_t(f, rhs, method=method)
    return _penta.penta_solve_t(f, rhs, method=method)


# -- the pure-function contract (repro_torch.solver.functional) --------------

def _pure_build(system: BandedSystem, *, method: str = "scan", **_ignored):
    return build_stored(system, method=method), {"method": method}


def _pure_solve(meta, stored, rhs):
    return solve_stored(meta.bandwidth, meta.mode, meta.periodic, meta.n,
                        stored, rhs, method=meta.opt("method", "scan"))


def _pure_transpose(meta, stored, rhs):
    return transpose_solve_stored(meta.bandwidth, meta.mode, meta.periodic,
                                  meta.n, stored, rhs,
                                  method=meta.opt("method", "scan"))


register_pure_backend("reference", build=_pure_build, solve=_pure_solve,
                      transpose_solve=_pure_transpose)


@register_backend("reference")
class ReferenceBackend:
    """Plain-torch sweep backend: holds a ``Factorization`` and routes
    ``solve`` through the differentiable entry point."""

    def __init__(self, system: BandedSystem, **opts):
        from .functional import factorize
        self.system = system
        self.fact = factorize(system, backend="reference", **opts)
        self.stored = self.fact.stored

    def factor_for_solve(self):
        """The stored factor as the sweeps read it: a uniform-mode factor's
        scalar diagonal broadcast back to a vector (``expand_uniform``), any
        other mode's as stored."""
        if self.system.mode == "uniform":
            return expand_uniform(self.system.bandwidth, self.system.periodic,
                                  self.system.n, self.stored)
        return self.stored

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        from .autodiff import solve as _solve
        return _solve(self.fact, rhs)
