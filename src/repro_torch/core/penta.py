"""Pentadiagonal LR solver with a single shared LHS (paper §IV).

Counterpart of ``repro.core.penta``.  Diagonals follow the paper's rows
    a_i x_{i-2} + b_i x_{i-1} + c_i x_i + d_i x_{i+1} + e_i x_{i+2} = f_i
(a_0 = a_1 = b_0 = 0 and d_{N-1} = e_{N-2} = e_{N-1} = 0 lie outside the
matrix and are forced to zero).

Factored form A = L R (storage O(5N); uniform mode drops eps, O(4N)):
    eps = a (L sub-sub), beta (L sub), inv_alpha = 1/alpha (L diagonal),
    gamma (R super), delta (R super-super)

Solve:
    L g = f :  g_i = (f_i - eps_i g_{i-2} - beta_i g_{i-1}) * inv_alpha_i
    R x = g :  x_i = g_i - gamma_i x_{i+1} - delta_i x_{i+2}

Periodic boundaries use a rank-4 Woodbury correction whose four auxiliary
solves happen once per operator.
"""

from __future__ import annotations

import dataclasses

import torch

from .recurrence import _align, linear_recurrence2
from .tridiag import _set, _shift_down, _shift_up


@dataclasses.dataclass(frozen=True)
class PentaFactor:
    eps: torch.Tensor        # equals a; 0-d in uniform reference storage
    beta: torch.Tensor
    inv_alpha: torch.Tensor
    gamma: torch.Tensor
    delta: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PeriodicPentaFactor:
    factor: PentaFactor
    Z: torch.Tensor          # (N, 4)  A'^{-1} U
    Minv: torch.Tensor       # (4, 4)  (I + V^T Z)^{-1}
    vcoef: torch.Tensor      # (6,) corners [a0, b0, a1, eN2, dN1, eN1]
    Zt: torch.Tensor         # (N, 4)  A'^{-T} V — the adjoint's corner aux


def penta_factor(a, b, c, d, e) -> PentaFactor:
    """LR factorisation (paper §IV.A steps 1-14), one loop over N."""
    a = _set(torch.as_tensor(a), [0, 1], 0)
    b = _set(torch.as_tensor(b), 0, 0)
    c = torch.as_tensor(c)
    d = _set(torch.as_tensor(d), -1, 0)
    e = _set(torch.as_tensor(e), [-2, -1], 0)

    beta, inv_alpha = torch.empty_like(c), torch.empty_like(c)
    gamma, delta = torch.empty_like(c), torch.empty_like(c)
    zero = torch.zeros_like(c[0])
    g1 = g2 = d1 = d2 = zero   # gamma_{i-1}, gamma_{i-2}, delta_{i-1}, delta_{i-2}
    for i in range(c.shape[0]):
        beta_i = b[i] - a[i] * g2
        alpha_i = c[i] - a[i] * d2 - beta_i * g1
        inv_i = 1.0 / alpha_i
        gamma_i = (d[i] - beta_i * d1) * inv_i
        delta_i = e[i] * inv_i
        beta[i], inv_alpha[i], gamma[i], delta[i] = beta_i, inv_i, gamma_i, delta_i
        g1, g2, d1, d2 = gamma_i, g1, delta_i, d1
    # entries beyond the band are unused; zero them so storage accounting
    # and the uniform variant stay exact
    gamma.select(0, -1).fill_(0)
    delta[-2:].fill_(0)
    return PentaFactor(eps=a, beta=beta, inv_alpha=inv_alpha, gamma=gamma,
                       delta=delta)


def _aligned(f: PentaFactor, rhs: torch.Tensor) -> tuple:
    eps = torch.broadcast_to(torch.as_tensor(f.eps), f.beta.shape)
    return tuple(_align(v, rhs) for v in
                 (eps, f.beta, f.inv_alpha, f.gamma, f.delta))


def penta_solve(f: PentaFactor, rhs, *, method: str = "scan") -> torch.Tensor:
    """Solve A x = rhs given the LR factorisation. rhs: (N,) or (N, M...)."""
    rhs = torch.as_tensor(rhs)
    eps, beta, inv_alpha, gamma, delta = _aligned(f, rhs)
    g = linear_recurrence2(-beta * inv_alpha, -eps * inv_alpha,
                           rhs * inv_alpha, method=method)
    return linear_recurrence2(-gamma, -delta, g, reverse=True, method=method)


def penta_solve_t(f: PentaFactor, g, *, method: str = "scan") -> torch.Tensor:
    """Solve the TRANSPOSED system A^T x = g from the SAME LR factorisation:

        R^T y = g :  y_i = g_i - gamma_{i-1} y_{i-1} - delta_{i-2} y_{i-2}
        L^T x = y :  x_i = (y_i - beta_{i+1} x_{i+1} - eps_{i+2} x_{i+2})
                           * inv_alpha_i
    """
    g = torch.as_tensor(g)
    eps, beta, inv_alpha, gamma, delta = _aligned(f, g)
    y = linear_recurrence2(-_shift_down(gamma, 1), -_shift_down(delta, 2), g,
                           method=method)
    return linear_recurrence2(-_shift_up(beta, 1) * inv_alpha,
                              -_shift_up(eps, 2) * inv_alpha,
                              y * inv_alpha, reverse=True, method=method)


def penta_factor_solve(a, b, c, d, e, rhs, *,
                       method: str = "scan") -> torch.Tensor:
    """Fused factor+solve (cuPentBatch semantics — re-factors every call)."""
    return penta_solve(penta_factor(a, b, c, d, e), rhs, method=method)


# ---------------------------------------------------------------------------
# Periodic boundaries — rank-4 Woodbury
# ---------------------------------------------------------------------------

def _vty(vcoef: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """V^T y for the rank-4 corner correction. y: (N,) or (N, M) -> (4,) / (4, M)."""
    a0, b0, a1, eN2, dN1, eN1 = vcoef
    return torch.stack([
        a0 * y[-2] + b0 * y[-1],   # v_0: row-0 wrap entries at cols N-2, N-1
        a1 * y[-1],                # v_1: row-1 wrap entry  at col  N-1
        eN2 * y[0],                # v_2: row-(N-2) wrap    at col  0
        dN1 * y[0] + eN1 * y[1],   # v_3: row-(N-1) wraps   at cols 0, 1
    ], dim=0)


def _corner_V(vcoef: torch.Tensor, n: int) -> torch.Tensor:
    """Materialise V (N, 4) of the rank-4 correction P = A' + U V^T."""
    a0, b0, a1, eN2, dN1, eN1 = vcoef
    V = vcoef.new_zeros((n, 4))
    V[-2, 0], V[-1, 0] = a0, b0
    V[-1, 1] = a1
    V[0, 2] = eN2
    V[0, 3], V[1, 3] = dN1, eN1
    return V


def periodic_penta_factor(a, b, c, d, e) -> PeriodicPentaFactor:
    """Factor the periodic pentadiagonal operator P = A' + U V^T, with
    corners P[0,N-2] = a_0, P[0,N-1] = b_0, P[1,N-1] = a_1,
    P[N-2,0] = e_{N-2}, P[N-1,0] = d_{N-1}, P[N-1,1] = e_{N-1},
    U = [e_0, e_1, e_{N-2}, e_{N-1}] and V as in ``_vty``."""
    a, b, c, d, e = (torch.as_tensor(v) for v in (a, b, c, d, e))
    n = c.shape[0]
    vcoef = torch.stack([a[0], b[0], a[1], e[-2], d[-1], e[-1]])
    f = penta_factor(a, b, c, d, e)
    U = c.new_zeros((n, 4))
    for row, col in ((0, 0), (1, 1), (-2, 2), (-1, 3)):
        U[row, col].fill_(1.0)       # fill_: no host copy of the 1.0
    Z = penta_solve(f, U)
    M4 = torch.eye(4, dtype=c.dtype, device=c.device) + _vty(vcoef, Z)
    Zt = penta_solve_t(f, _corner_V(vcoef, n))
    # inv_ex: linalg.inv reads its error code on the host (a sync); a
    # singular M4 gives non-finite entries, as jnp.linalg.inv does
    return PeriodicPentaFactor(factor=f, Z=Z,
                               Minv=torch.linalg.inv_ex(M4).inverse,
                               vcoef=vcoef, Zt=Zt)


def periodic_penta_solve(pf: PeriodicPentaFactor, rhs, *,
                         method: str = "scan") -> torch.Tensor:
    """x = y - Z (I + V^T Z)^{-1} V^T y  with  y = A'^{-1} rhs."""
    y = penta_solve(pf.factor, rhs, method=method)
    w = pf.Minv @ _vty(pf.vcoef, y)
    return y - torch.tensordot(pf.Z, w, dims=([1], [0]))


def periodic_corner_correction_t(pf: PeriodicPentaFactor,
                                 y: torch.Tensor) -> torch.Tensor:
    """Transposed rank-4 Woodbury corner step on y = A'^{-T} g:
    x = y - Zt (I + U^T A'^{-T} V)^{-1} U^T y, and the 4x4 inverse is the
    stored ``Minv`` transposed."""
    uty = torch.stack([y[0], y[1], y[-2], y[-1]], dim=0)
    h = pf.Minv.T @ uty
    return y - torch.tensordot(pf.Zt, h, dims=([1], [0]))


def periodic_penta_solve_t(pf: PeriodicPentaFactor, g, *,
                           method: str = "scan") -> torch.Tensor:
    """Transposed periodic penta solve P^T x = g from the SAME factor."""
    y = penta_solve_t(pf.factor, g, method=method)
    return periodic_corner_correction_t(pf, y)


def dense_penta(a, b, c, d, e, periodic: bool = False) -> torch.Tensor:
    """Materialise the (N, N) matrix — test oracle only."""
    a, b, c, d, e = (torch.as_tensor(v) for v in (a, b, c, d, e))
    n = c.shape[0]
    A = (torch.diag(c) + torch.diag(b[1:], -1) + torch.diag(a[2:], -2)
         + torch.diag(d[:-1], 1) + torch.diag(e[:-2], 2))
    if periodic:
        A[0, n - 2] += a[0]
        A[0, n - 1] += b[0]
        A[1, n - 1] += a[1]
        A[n - 2, 0] += e[n - 2]
        A[n - 1, 0] += d[n - 1]
        A[n - 1, 1] += e[n - 1]
    return A
