"""Plain reference for ``cn-diffusion``: one Crank–Nicolson step of the
periodic 1-D heat equation, and the solve's adjoint, in dense fp64.

    (I - sigma D2) C^{n+1} = (I + sigma D2) C^n,   sigma = dt / (2 dx^2),

D2 the periodic second difference on N points (paper Eqs. 9 and 11).
The LHS matrix A has row i = (-sigma, 1 + 2 sigma, -sigma) at columns
(i - 1, i, i + 1) mod N; the RHS matrix B has (sigma, 1 - 2 sigma, sigma).
A step is x = A^{-1} (B f).  For x = A^{-1} d and a cotangent g, the
adjoint is lambda = A^{-T} g, the rhs's gradient is lambda, and the
gradient of the diagonal at offset k is -sum_m lambda[i, m] x[(i + k) mod
N, m].

Everything here is plain torch on dense matrices: no banded solver, no
code of the program.  ``*_low`` are the same computations in bfloat16, the
precision below the configuration's fp32 (the control).
"""

from __future__ import annotations

import torch

OFFSETS = (-1, 0, 1)     # the sub, main and super diagonals


def circulant(n: int, weights, *, dtype=torch.float64, device=None):
    """The periodic (N, N) matrix with ``weights`` at offsets -1, 0, +1."""
    i = torch.arange(n, device=device)
    m = torch.zeros((n, n), dtype=dtype, device=device)
    for off, w in zip(OFFSETS, weights):
        m[i, (i + off) % n] = w
    return m


def lhs(n: int, sigma: float, **kw):
    return circulant(n, (-sigma, 1.0 + 2.0 * sigma, -sigma), **kw)


def rhs(n: int, sigma: float, **kw):
    return circulant(n, (sigma, 1.0 - 2.0 * sigma, sigma), **kw)


def inverse(n: int, sigma: float, *, device=None):
    """A^{-1} in fp64 (a dense LU solve against the identity)."""
    a = lhs(n, sigma, device=device)
    return torch.linalg.solve(a, torch.eye(n, dtype=torch.float64,
                                           device=device))


def step_matrix(n: int, sigma: float, *, device=None):
    """T = A^{-1} B in fp64: one step is x = T f."""
    return inverse(n, sigma, device=device) @ rhs(n, sigma, device=device)


def diagonal_cotangents(lam, x):
    """(N,) gradients of the three diagonals for x = A^{-1} d, lambda =
    A^{-T} g, summed over the columns given."""
    return tuple(-(lam * torch.roll(x, -off, dims=0)).sum(dim=1)
                 for off in OFFSETS)


def step_low(f, sigma: float, ainv_low):
    """One step with every operation in bfloat16: the explicit stencil on
    the bf16 field, then the bf16 product with A^{-1} (stored in bf16)."""
    fl = f.to(torch.bfloat16)
    r = (sigma * torch.roll(fl, 1, dims=0) + (1.0 - 2.0 * sigma) * fl
         + sigma * torch.roll(fl, -1, dims=0))
    return (ainv_low @ r).to(f.dtype)


def adjoint_low(d, g, ainv_low):
    """x, lambda and the diagonals' gradients, every operation in
    bfloat16."""
    x = ainv_low @ d.to(torch.bfloat16)
    lam = ainv_low.t() @ g.to(torch.bfloat16)
    cots = diagonal_cotangents(lam, x)
    return (x.to(d.dtype), lam.to(d.dtype),
            tuple(c.to(d.dtype) for c in cots))
