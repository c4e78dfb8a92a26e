"""Differentiable solves: a ``torch.autograd.Function`` over ``solve_impl``.

Counterpart of ``repro.solver.autodiff``.  For x = A^{-1} d:

    lambda   = A^{-T} g                 (one TRANSPOSED banded solve)
    bar(d)   = lambda
    bar(A)   = -lambda x^T    =>    bar(diag_k)[i] = -sum_m lambda[i,m]
                                                      * x[(i+k) mod N, m]

The transposed solve runs on the SAME stored factor (A = L·U gives
A^T = U^T·L^T from the forward's vectors), so the backward pass needs no
second factor.  The gradient of A goes to the spec's (N,) diagonals that
require grad; the stored factor is derived data and gets none.  The
forward is the span ``solver.solve``, the backward ``solver.solve_backward``
(``repro_torch.spans``).
"""

from __future__ import annotations

import torch

from ..spans import span
from .functional import Factorization, solve_impl, transpose_solve
from .registry import get_pure_backend

_OFFSETS = {3: (-1, 0, 1), 5: (-2, -1, 0, 1, 2)}


def diagonal_cotangents(meta, lam: torch.Tensor, x: torch.Tensor) -> tuple:
    """bar(diag_k)[i] = -sum_m lam[i, m] * x[(i + off_k) mod N, m].

    Matrix row i holds ``diag_k[i]`` at column i + off_k.  Periodic wraps
    the column index; Dirichlet zeroes the rows whose column falls outside
    the matrix (those spec entries are outside the operator).  The span
    ``solver.diag_cotangents``."""
    sum_dims = tuple(range(1, lam.ndim))
    cots = []
    with span("solver.diag_cotangents"):
        for off in _OFFSETS[meta.bandwidth]:
            xs = torch.roll(x, -off, dims=0)
            if not meta.periodic and off > 0:
                xs[-off:] = 0
            elif not meta.periodic and off < 0:
                xs[:-off] = 0
            bar = -(lam * xs)
            cots.append(bar.sum(dim=sum_dims) if sum_dims else bar)
    return tuple(cots)


class _Solve(torch.autograd.Function):
    """x = A^{-1} rhs; the inputs are the rhs and the spec's diagonals."""

    @staticmethod
    def forward(ctx, fact: Factorization, rhs: torch.Tensor, *diagonals):
        with span("solver.solve"):
            x = solve_impl(fact, rhs)
        ctx.fact = fact
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        fact = ctx.fact
        with span("solver.solve_backward"):
            lam = transpose_solve(fact, g.contiguous())
            needs_diag = ctx.needs_input_grad[2:]
            cotangents = (get_pure_backend(fact.meta.backend).cotangents
                          or diagonal_cotangents)
            cots = (cotangents(fact.meta, lam, x) if any(needs_diag)
                    else (None,) * len(needs_diag))
            bars = tuple(c.to(device=d.device, dtype=d.dtype) if need
                         else None for c, d, need in
                         zip(cots, fact.diagonals, needs_diag))
        return (None, lam if ctx.needs_input_grad[1] else None) + bars


def solve(factorization: Factorization, rhs: torch.Tensor) -> torch.Tensor:
    """Differentiable solve: ``A x = rhs`` -> x, rhs (N,) or (N, M).

    ``torch.autograd`` reaches ``rhs`` and the spec diagonals of
    ``factorization`` through one transposed solve on the same stored
    factor.  A backend that spans ranks lays ``rhs`` out first (its
    ``place`` hook), so the gradient of ``rhs`` comes back in the layout
    the caller gave; it solves an (N,) rhs as one column."""
    place = get_pure_backend(factorization.meta.backend).place
    if place is not None:
        if rhs.ndim == 1:
            return solve(factorization, rhs[:, None])[:, 0]
        rhs = place(factorization.meta, rhs)
    return _Solve.apply(factorization, rhs, *factorization.diagonals)
