"""Pre-factorised Thomas solver with a single shared LHS (paper §III).

Counterpart of ``repro.core.tridiag``.  RHS batches are interleaved
``(N, M)``: unknown index ``i`` major, system index ``m`` minor.  The
factored LHS is three ``(N,)`` vectors stored once (constant mode) or
three ``(N, M)`` arrays (per-system baseline); both go through the same
code by broadcasting.

Factored form (storage O(3N)):
    a         : sub-diagonal (a[0] unused, forced to 0)
    inv_denom : 1 / (b_i - a_i * c_hat_{i-1})      (inv_denom[0] = 1/b_0)
    c_hat     : c_i * inv_denom_i                   (c_hat[N-1] unused)

Solve:
    forward   d_hat_i = (d_i - a_i d_hat_{i-1}) * inv_denom_i
    backward  x_i     = d_hat_i - c_hat_i * x_{i+1}
"""

from __future__ import annotations

import dataclasses

import torch

from .recurrence import _align, _shift_down, _shift_up, linear_recurrence


@dataclasses.dataclass(frozen=True)
class TridiagFactor:
    a: torch.Tensor          # (N,) or (N, M); 0-d in uniform reference storage
    inv_denom: torch.Tensor  # (N,) or (N, M)
    c_hat: torch.Tensor      # (N,) or (N, M)


@dataclasses.dataclass(frozen=True)
class PeriodicTridiagFactor:
    factor: TridiagFactor        # factor of the Sherman-Morrison core A'
    z: torch.Tensor              # A'^{-1} u
    v_last: torch.Tensor         # a_0 / gamma (v = e_0 + v_last e_{N-1})
    inv_denom_sm: torch.Tensor   # 1 / (1 + v . z)
    zt: torch.Tensor             # A'^{-T} v — the adjoint's corner aux


def _set(v: torch.Tensor, idx, value) -> torch.Tensor:
    """Out-of-place ``v[idx] = value`` (JAX's ``.at[idx].set``)."""
    v = v.clone()
    v[idx] = value
    return v


def thomas_factor(a, b, c, *, method: str = "scan") -> TridiagFactor:
    """Pre-factorisation (paper Eqs. 1-2). a, b, c: (N,) shared or (N, M).

    ``method="assoc"`` (N,) diagonals only: c_hat_i = c_i / (b_i - a_i
    c_hat_{i-1}) is a Möbius recurrence, tracked as the ratio num_i / den_i
    of the 2×2 companion products
    ``(num_i, den_i) = [[0, c_i], [-a_i, b_i]] @ (num_{i-1}, den_{i-1})``
    from (0, 1), unscaled, as the JAX package forms them: the running
    ``den`` grows like the product of the pivots and overflows for large
    diagonals or N (b = 1e3 overflows fp32 by N = 40).  The JAX package's
    product has no batch axis and refuses (N, M) diagonals; so does this
    one."""
    if method not in ("scan", "assoc"):
        raise ValueError(f"unknown method {method!r}")
    a = _set(torch.as_tensor(a), 0, 0)   # a_0 is outside the matrix
    b = torch.as_tensor(b)
    c = torch.as_tensor(c)
    if method == "assoc":
        return _thomas_factor_assoc(a, b, c)
    inv_denom = torch.empty_like(b)
    c_hat = torch.empty_like(b)
    c_hat_prev = torch.zeros_like(b[0])
    for i in range(b.shape[0]):
        inv = 1.0 / (b[i] - a[i] * c_hat_prev)
        c_hat_prev = c[i] * inv
        inv_denom[i] = inv
        c_hat[i] = c_hat_prev
    return TridiagFactor(a=a, inv_denom=inv_denom, c_hat=c_hat)


def _thomas_factor_assoc(a, b, c) -> TridiagFactor:
    """The factor from the prefix products of the 2×2 companion matrices
    (``thomas_factor(method="assoc")``): c_hat = num / den and inv_denom =
    den_{i-1} / den_i."""
    if not a.ndim == b.ndim == c.ndim == 1:
        raise ValueError("thomas_factor(method='assoc') takes (N,) "
                         f"diagonals, got shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}: its 2×2 "
                         "companion product has no batch axis (the JAX "
                         "package's einsum refuses (N, M) diagonals too)")
    zero = torch.zeros_like(b)
    companion = torch.stack([torch.stack([zero, c], 1),
                             torch.stack([-a, b], 1)], 1)   # (N, 2, 2)
    prod = torch.eye(2, dtype=b.dtype, device=b.device)
    num, den = torch.empty_like(b), torch.empty_like(b)
    for i in range(b.shape[0]):
        prod = companion[i] @ prod
        num[i], den[i] = prod[0, 1], prod[1, 1]   # applied to (0, 1)
    den_prev = torch.cat([torch.ones_like(den[:1]), den[:-1]])
    return TridiagFactor(a=a, inv_denom=den_prev / den, c_hat=num / den)


def thomas_solve(f: TridiagFactor, d, *, method: str = "scan") -> torch.Tensor:
    """Solve A x = d given the factorisation. d: (N,) or (N, M...)."""
    d = torch.as_tensor(d)
    a = _align(f.a, d)
    inv_denom = _align(f.inv_denom, d)
    c_hat = _align(f.c_hat, d)
    d_hat = linear_recurrence(-a * inv_denom, d * inv_denom, method=method)
    return linear_recurrence(-c_hat, d_hat, reverse=True, method=method)


def thomas_solve_t(f: TridiagFactor, g, *, method: str = "scan") -> torch.Tensor:
    """Solve the TRANSPOSED system A^T x = g from the SAME factorisation.

    A = L U (L: diagonal 1/inv_denom, sub-diagonal a; U: unit upper with
    super-diagonal c_hat), so A^T = U^T L^T needs no second factor:

        U^T y = g :  y_i = g_i - c_hat_{i-1} y_{i-1}
        L^T x = y :  x_i = (y_i - a_{i+1} x_{i+1}) * inv_denom_i
    """
    g = torch.as_tensor(g)
    a = _align(f.a, g)
    inv_denom = _align(f.inv_denom, g)
    c_hat = _align(f.c_hat, g)
    y = linear_recurrence(-_shift_down(c_hat, 1), g, method=method)
    return linear_recurrence(-_shift_up(a, 1) * inv_denom, y * inv_denom,
                             reverse=True, method=method)


# ---------------------------------------------------------------------------
# Periodic boundaries — Sherman-Morrison, paper §III.C (rank 1)
# ---------------------------------------------------------------------------

def periodic_thomas_factor(a, b, c, *,
                           method: str = "scan") -> PeriodicTridiagFactor:
    """Factor the periodic tridiagonal system (corners A[0,N-1] = a_0,
    A[N-1,0] = c_{N-1}) via Sherman-Morrison, A = A' + u v^T with
        gamma = -b_0,  u = gamma e_0 + c_{N-1} e_{N-1},
        v = e_0 + (a_0/gamma) e_{N-1},
        A'[0,0] = 2 b_0,  A'[N-1,N-1] = b_{N-1} - c_{N-1} a_0 / gamma.
    The auxiliary solves A' z = u and A'^T zt = v happen once, here."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    c = torch.as_tensor(c)
    gamma = -b[0]
    b_mod = b.clone()
    b_mod[0] = b_mod[0] - gamma
    b_mod[-1] = b_mod[-1] - c[-1] * a[0] / gamma
    f = thomas_factor(a, b_mod, c, method=method)

    u = torch.zeros_like(b)
    u[0] = gamma
    u[-1] = c[-1]
    z = thomas_solve(f, u, method=method)
    v_last = a[0] / gamma
    v_dot_z = z[0] + v_last * z[-1]
    v = torch.zeros_like(b)
    v[0] = 1.0
    v[-1] = v_last
    zt = thomas_solve_t(f, v, method=method)
    return PeriodicTridiagFactor(factor=f, z=z, v_last=v_last,
                                 inv_denom_sm=1.0 / (1.0 + v_dot_z), zt=zt)


def _broadcast_aux(aux: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _align(aux, y) if aux.ndim < y.ndim else aux


def periodic_thomas_solve(pf: PeriodicTridiagFactor, d, *,
                          method: str = "scan") -> torch.Tensor:
    """x = y - (v.y / (1 + v.z)) z  with  y = A'^{-1} d  (paper Eq. 15)."""
    y = thomas_solve(pf.factor, d, method=method)
    corr = (y[0] + pf.v_last * y[-1]) * pf.inv_denom_sm
    return y - corr * _broadcast_aux(pf.z, y)


def periodic_corner_correction_t(pf: PeriodicTridiagFactor,
                                 y: torch.Tensor) -> torch.Tensor:
    """Transposed Sherman-Morrison corner step on y = A'^{-T} g.

    A^T = A'^T + v u^T, so x = y - (u . y) / (1 + u . w) * w with
    w = A'^{-T} v = ``pf.zt``; 1 + u.w = 1 + v.z is the stored
    ``inv_denom_sm``; u comes from the factor itself (gamma = -b_0 =
    -1/(2 inv_denom_0), c_{N-1} = c_hat_{N-1} / inv_denom_{N-1})."""
    f = pf.factor
    gamma = -0.5 / f.inv_denom[0]
    c_last = f.c_hat[-1] / f.inv_denom[-1]
    corr = (gamma * y[0] + c_last * y[-1]) * pf.inv_denom_sm
    return y - corr * _broadcast_aux(pf.zt, y)


def periodic_thomas_solve_t(pf: PeriodicTridiagFactor, g, *,
                            method: str = "scan") -> torch.Tensor:
    """Transposed periodic solve A^T x = g from the SAME stored factor."""
    y = thomas_solve_t(pf.factor, g, method=method)
    return periodic_corner_correction_t(pf, y)


def dense_tridiag(a, b, c, periodic: bool = False) -> torch.Tensor:
    """Materialise the (N, N) matrix — test oracle only."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    c = torch.as_tensor(c)
    n = b.shape[0]
    A = torch.diag(b) + torch.diag(a[1:], -1) + torch.diag(c[:-1], 1)
    if periodic:
        A[0, n - 1] += a[0]
        A[n - 1, 0] += c[-1]
    return A
