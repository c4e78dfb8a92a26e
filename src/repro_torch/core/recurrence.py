"""First- and second-order gated linear recurrences.

Counterpart of ``repro.core.recurrence``: the sweeps of the core solvers
and the recurrences of the sequence models (RG-LRU, the SSD inter-chunk
state scan) share this front end.  Methods:

  * ``"scan"``  — a plain loop over N, vectorised over the batch;
  * ``"assoc"`` — a log-step (Hillis–Steele) scan in plain torch: over
    (p, q) pairs for order 1, over 2×2 companion matrices for order 2;
  * ``"cuda"``  — the hand-written Hopper kernel
    (``kernels/csrc/recurrence_sweep.cu``), the counterpart of JAX's
    ``"pallas"``.  Its backward runs the same kernel in the other
    direction on gates shifted by their lags (``_Recur1`` / ``_Recur2``).
    On CPU tensors it runs the kernel's plain version; on a CUDA tensor
    it launches the kernel or raises;
  * ``"auto"``  — ``"cuda"`` for the floating dtypes (float32, float64,
    bfloat16, float16: the ones the kernel takes), ``"scan"`` otherwise,
    as JAX's ``auto`` does.

Coefficients are (N,) (shared, the paper's constant-LHS case) or
broadcast against the operand (singleton dims allowed); the computation
runs in the promoted dtype of the inputs (bf16 operands with fp32 gates
run fp32); ``h0`` seeds the incoming carry and ``reverse=True`` runs from
i = N-1 down to 0.  JAX's TPU knobs (``unroll``, ``block_m``,
``block_n``, ``interpret``) are not accepted.
"""

from __future__ import annotations

import math

import torch

METHODS = ("scan", "assoc", "cuda", "auto")
_KERNEL_DTYPES = (torch.float32, torch.float64, torch.bfloat16,
                  torch.float16)


def _align(coef: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Right-pad ``coef`` with singleton dims so it broadcasts against
    ``ref``: (N,) shared coefficients, or already of ``ref``'s rank."""
    coef = torch.as_tensor(coef)
    if coef.ndim == ref.ndim:
        return coef
    if coef.ndim != 1:
        raise ValueError(f"coefficient rank {coef.ndim} vs operand rank {ref.ndim}")
    return coef.reshape(coef.shape + (1,) * (ref.ndim - 1))


def _resolve(method: str, dtype) -> str:
    """The ``auto`` policy: the kernel for the dtypes it takes, the scan
    otherwise (integer and bool recurrences stay exact)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; valid: {METHODS}")
    if method != "auto":
        return method
    return "cuda" if dtype in _KERNEL_DTYPES else "scan"


def _shift_up(v: torch.Tensor, k: int) -> torch.Tensor:
    """Row i reads v at i+k (zeros shift in at the bottom)."""
    return torch.cat([v[k:], torch.zeros_like(v[:k])], dim=0)


def _shift_down(v: torch.Tensor, k: int) -> torch.Tensor:
    """Row i reads v at i-k (zeros shift in at the top)."""
    return torch.cat([torch.zeros_like(v[:k]), v[:-k]], dim=0)


def _order(n: int, reverse: bool) -> range:
    return range(n - 1, -1, -1) if reverse else range(n)


def _seeds(h0, shape, dtype, device, order: int) -> tuple:
    """``h0`` broadcast over the batch dims at ``dtype`` (zeros for None)."""
    if h0 is None:
        return (torch.zeros(shape, dtype=dtype, device=device),) * order
    return tuple(torch.broadcast_to(torch.as_tensor(h, device=device),
                                    shape).to(dtype) for h in h0)


# ---------------------------------------------------------------------------
# The kernel method: flattening onto the (N, M) layout, and the adjoint
# ---------------------------------------------------------------------------

class _Recur1(torch.autograd.Function):
    """Order-1 kernel recurrence on flattened (N, M) operands; ``h0`` is an
    (M,) seed or None (zero carries)."""

    @staticmethod
    def forward(ctx, reverse, p, q, h0):
        from ..kernels import ops as _kops
        h = _kops.recurrence(p, q, h0=h0, reverse=reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(p, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        """Adjoint of h_i = p_i h_{i-1} + q_i: the SAME recurrence walked
        the other way with the gate shifted one step (lambda_i = g_i +
        p_{i+1} lambda_{i+1}), on the same kernel; then dp_i = lambda_i
        h_{i-1}, dq = lambda, dh0 = lambda_0 p_0."""
        from ..kernels import ops as _kops
        p, h, h0 = ctx.saved_tensors
        if h0 is None:
            h0 = torch.zeros_like(h[0])
        if ctx.reverse:
            p_adj, lam_rev = _shift_down(p, 1), False
            h_prev = torch.cat([h[1:], h0[None]], dim=0)
        else:
            p_adj, lam_rev = _shift_up(p, 1), True
            h_prev = torch.cat([h0[None], h[:-1]], dim=0)
        lam = _kops.recurrence(p_adj, g, reverse=lam_rev)
        edge = -1 if ctx.reverse else 0
        dh0 = lam[edge] * p[edge] if ctx.needs_input_grad[3] else None
        return None, lam * h_prev, lam, dh0


class _Recur2(torch.autograd.Function):
    """Order-2 kernel recurrence on flattened (N, M) operands; ``h1, h2``
    are the (M,) seeds (h_{-1}, h_{-2}), or both None."""

    @staticmethod
    def forward(ctx, reverse, s, t, u, h1, h2):
        from ..kernels import ops as _kops
        h0 = None if h1 is None else (h1, h2)
        h = _kops.recurrence(s, t, u, h0=h0, reverse=reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(s, t, h, h1, h2)
        return h

    @staticmethod
    def backward(ctx, g):
        """Adjoint of the order-2 recurrence: lambda_i = g_i +
        s_{i+1} lambda_{i+1} + t_{i+2} lambda_{i+2}, the reverse
        recurrence with each gate shifted by its own lag."""
        from ..kernels import ops as _kops
        s, t, h, h1, h2 = ctx.saved_tensors
        if h1 is None:
            h1 = h2 = torch.zeros_like(h[0])
        n = h.shape[0]
        if ctx.reverse:
            s_adj, t_adj, lam_rev = _shift_down(s, 1), _shift_down(t, 2), False
            hp1 = torch.cat([h[1:], h1[None]], dim=0)
            # the LAST n rows: at n = 1, row 0 reads h_{N+1} = h2 (JAX's
            # ``[:n]`` keeps h1 there, a fault of the reference at N = 1)
            hp2 = torch.cat([h[2:], h1[None], h2[None]], dim=0)[-n:]
            e0, e1 = n - 1, n - 2
        else:
            s_adj, t_adj, lam_rev = _shift_up(s, 1), _shift_up(t, 2), True
            hp1 = torch.cat([h1[None], h[:-1]], dim=0)
            hp2 = torch.cat([h2[None], h1[None], h[:-2]], dim=0)[:n]
            e0, e1 = 0, 1
        lam = _kops.recurrence(s_adj, t_adj, g, reverse=lam_rev)
        dh1 = dh2 = None
        if ctx.needs_input_grad[4] or ctx.needs_input_grad[5]:
            dh1 = lam[e0] * s[e0]
            if n > 1:
                dh1 = dh1 + lam[e1] * t[e1]
            dh2 = lam[e0] * t[e0]
        return None, lam * hp1, lam * hp2, lam, dh1, dh2


def _cuda_dispatch(gates: tuple, q: torch.Tensor, h0, *,
                   reverse: bool) -> torch.Tensor:
    """Flatten (N, ...) operands onto the kernel's (N, M) layout and run
    the differentiable kernel recurrence.  Gates are ``expand``ed to the
    operand's shape BEFORE the autograd Function, so their gradients sum
    back down to the gate's own shape (a shared (N,) gate, or the SSD
    decay (N, B, H, 1, 1))."""
    order = len(gates)
    shape = q.shape
    n, m = shape[0], math.prod(shape[1:])
    gates = tuple(g.expand(shape).reshape(n, m) for g in gates)
    qf = q.reshape(n, m)
    seeds = ((None,) * order if h0 is None else
             tuple(h.reshape(m) for h in _seeds(h0, shape[1:], q.dtype,
                                                q.device, order)))
    if order == 1:
        h = _Recur1.apply(reverse, gates[0], qf, seeds[0])
    else:
        h = _Recur2.apply(reverse, gates[0], gates[1], qf, *seeds)
    return h.reshape(shape)


# ---------------------------------------------------------------------------
# The log-step scan
# ---------------------------------------------------------------------------

def _hillis_steele(elems: tuple, combine, reverse: bool) -> tuple:
    """Inclusive scan of the tuple of (N, ...) tensors ``elems`` along
    axis 0 with ``combine(earlier, later)``, in ceil(log2 N) out-of-place
    steps; ``reverse`` scans from row N-1 down."""
    if reverse:
        elems = tuple(e.flip(0) for e in elems)
    n, d = elems[0].shape[0], 1
    while d < n:
        merged = combine(tuple(e[:-d] for e in elems),
                         tuple(e[d:] for e in elems))
        elems = tuple(torch.cat([e[:d], c], dim=0)
                      for e, c in zip(elems, merged))
        d *= 2
    if reverse:
        elems = tuple(e.flip(0) for e in elems)
    return elems


def _combine1(fst, snd):
    """h -> p2*(p1*h + q1) + q2 = (p1*p2)*h + (p2*q1 + q2)."""
    p1, q1 = fst
    p2, q2 = snd
    return p1 * p2, p2 * q1 + q2


def _combine2(fst, snd):
    """(A1, b1) then (A2, b2) -> (A2 A1, A2 b1 + b2), with the 2x2 A as
    its four entries (a00, a01, a10, a11) and b as (b0, b1)."""
    x00, x01, x10, x11, c0, c1 = fst
    y00, y01, y10, y11, d0, d1 = snd
    return (y00 * x00 + y01 * x10, y00 * x01 + y01 * x11,
            y10 * x00 + y11 * x10, y10 * x01 + y11 * x11,
            y00 * c0 + y01 * c1 + d0, y10 * c0 + y11 * c1 + d1)


# ---------------------------------------------------------------------------
# Public front end
# ---------------------------------------------------------------------------

def linear_recurrence(p, q, h0=None, *, reverse: bool = False,
                      method: str = "scan") -> torch.Tensor:
    """Solve h_i = p_i * h_{i-1} + q_i (h_{-1} = h0, default 0).

    p: (N,) or broadcastable against q; q: (N, ...).  ``reverse`` runs
    h_i = p_i * h_{i+1} + q_i from i = N-1 down.  ``method``: ``scan``,
    ``assoc``, ``cuda`` or ``auto`` (module docstring).  Returns h with
    q's shape in the promoted dtype."""
    q = torch.as_tensor(q)
    p = _align(p, q)
    dtype = torch.result_type(p, q)
    p, q = p.to(dtype), q.to(dtype)
    method = _resolve(method, dtype)
    if method == "cuda":
        return _cuda_dispatch((p,), q, None if h0 is None else (h0,),
                              reverse=reverse)
    seed = None if h0 is None else _seeds((h0,), q.shape[1:], dtype,
                                          q.device, 1)[0]
    if method == "scan":
        carry = (torch.zeros(q.shape[1:], dtype=dtype, device=q.device)
                 if seed is None else seed)
        pb = p.expand((q.shape[0],) + p.shape[1:])
        rows = [None] * q.shape[0]
        for i in _order(q.shape[0], reverse):
            carry = pb[i] * carry + q[i]
            rows[i] = carry
        return torch.stack(rows) if rows else torch.empty_like(q)
    pp, qq = _hillis_steele((p.expand(q.shape), q), _combine1, reverse)
    return qq if seed is None else pp * seed + qq


def linear_recurrence2(s, t, u, h0=None, *, reverse: bool = False,
                       method: str = "scan") -> torch.Tensor:
    """Solve h_i = s_i h_{i-1} + t_i h_{i-2} + u_i (seeds default to 0).

    ``reverse=True`` solves h_i = s_i h_{i+1} + t_i h_{i+2} + u_i — the
    pentadiagonal back-substitution shape.  ``h0`` is an optional
    ``(h_{-1}, h_{-2})`` seed pair (``(h_N, h_{N+1})`` when reversed).
    Methods and dtype rules match ``linear_recurrence``."""
    u = torch.as_tensor(u)
    s = _align(s, u)
    t = _align(t, u)
    dtype = torch.promote_types(torch.result_type(s, t), u.dtype)
    s, t, u = s.to(dtype), t.to(dtype), u.to(dtype)
    method = _resolve(method, dtype)
    if h0 is not None and len(h0) != 2:
        raise ValueError("h0 must be a (h_{-1}, h_{-2}) pair")
    if method == "cuda":
        return _cuda_dispatch((s, t), u, h0, reverse=reverse)
    seeds = _seeds(h0, u.shape[1:], dtype, u.device, 2)
    if method == "scan":
        h1, h2 = seeds
        sb = s.expand((u.shape[0],) + s.shape[1:])
        tb = t.expand((u.shape[0],) + t.shape[1:])
        rows = [None] * u.shape[0]
        for i in _order(u.shape[0], reverse):
            h_new = sb[i] * h1 + tb[i] * h2 + u[i]
            rows[i] = h_new
            h1, h2 = h_new, h1
        return torch.stack(rows) if rows else torch.empty_like(u)
    # assoc: H_i = [[s_i, t_i], [1, 0]] H_{i-1} + [u_i, 0], H = (h_i, h_{i-1})
    s, t = s.expand(u.shape), t.expand(u.shape)
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    a00, a01, _, _, b0, _ = _hillis_steele(
        (s, t, one, zero, u, torch.zeros_like(u)), _combine2, reverse)
    if h0 is None:
        return b0
    return a00 * seeds[0] + a01 * seeds[1] + b0
