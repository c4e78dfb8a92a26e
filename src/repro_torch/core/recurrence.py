"""First- and second-order linear recurrences (the sweeps of the core
solvers), as plain loops over N that are vectorised over the batch.

Counterpart of ``repro.core.recurrence``'s ``method="scan"`` path.  The
other methods (``assoc`` and the kernel methods) arrive with the
recurrence slice; asking for them raises.

Coefficients are (N,) (shared, the paper's constant-LHS case) or
broadcast against the operand; the computation runs in
``torch.result_type`` of the inputs; ``h0`` seeds the incoming carry and
``reverse=True`` runs from i = N-1 down to 0.
"""

from __future__ import annotations

import torch

METHODS = ("scan",)


def _align(coef: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Right-pad ``coef`` with singleton dims so it broadcasts against
    ``ref``: (N,) shared coefficients, or already of ``ref``'s rank."""
    coef = torch.as_tensor(coef)
    if coef.ndim == ref.ndim:
        return coef
    if coef.ndim != 1:
        raise ValueError(f"coefficient rank {coef.ndim} vs operand rank {ref.ndim}")
    return coef.reshape(coef.shape + (1,) * (ref.ndim - 1))


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; valid: {METHODS} "
                         "(assoc and kernel methods arrive with the "
                         "recurrence slice)")


def _order(n: int, reverse: bool) -> range:
    return range(n - 1, -1, -1) if reverse else range(n)


def linear_recurrence(p, q, h0=None, *, reverse: bool = False,
                      method: str = "scan") -> torch.Tensor:
    """Solve h_i = p_i * h_{i-1} + q_i (h_{-1} = h0, default 0).

    p: (N,) or broadcastable against q; q: (N, ...).  ``reverse`` runs
    h_i = p_i * h_{i+1} + q_i from i = N-1 down.  Returns h with q's
    shape in the promoted dtype."""
    _check_method(method)
    q = torch.as_tensor(q)
    p = _align(p, q)
    dtype = torch.result_type(p, q)
    p, q = p.to(dtype), q.to(dtype)
    h = torch.empty_like(q)
    carry = (torch.zeros(q.shape[1:], dtype=dtype, device=q.device)
             if h0 is None else torch.as_tensor(h0, dtype=dtype,
                                                device=q.device))
    pb = p.expand((q.shape[0],) + p.shape[1:])
    for i in _order(q.shape[0], reverse):
        carry = pb[i] * carry + q[i]
        h[i] = carry
    return h


def linear_recurrence2(s, t, u, h0=None, *, reverse: bool = False,
                       method: str = "scan") -> torch.Tensor:
    """Solve h_i = s_i h_{i-1} + t_i h_{i-2} + u_i (seeds default to 0).

    ``reverse=True`` solves h_i = s_i h_{i+1} + t_i h_{i+2} + u_i — the
    pentadiagonal back-substitution shape.  ``h0`` is an optional
    ``(h_{-1}, h_{-2})`` seed pair (``(h_N, h_{N+1})`` when reversed)."""
    _check_method(method)
    u = torch.as_tensor(u)
    s = _align(s, u)
    t = _align(t, u)
    dtype = torch.promote_types(torch.result_type(s, t), u.dtype)
    s, t, u = s.to(dtype), t.to(dtype), u.to(dtype)
    if h0 is None:
        zeros = torch.zeros(u.shape[1:], dtype=dtype, device=u.device)
        h1, h2 = zeros, zeros
    else:
        if len(h0) != 2:
            raise ValueError("h0 must be a (h_{-1}, h_{-2}) pair")
        h1, h2 = (torch.as_tensor(x, dtype=dtype, device=u.device)
                  for x in h0)
    h = torch.empty_like(u)
    sb = s.expand((u.shape[0],) + s.shape[1:])
    tb = t.expand((u.shape[0],) + t.shape[1:])
    for i in _order(u.shape[0], reverse):
        h_new = sb[i] * h1 + tb[i] * h2 + u[i]
        h[i] = h_new
        h1, h2 = h_new, h1
    return h
