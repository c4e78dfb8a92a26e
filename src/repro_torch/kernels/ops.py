"""Entry points of the sweep kernels.

Counterpart of ``repro.kernels.ops``.  The shared-LHS half:

  * ``stack_tridiag_lhs`` / ``stack_penta_lhs`` stack the stored factor
    into the kernel's (rows, N) LHS — including the host-side row SHIFTS
    that turn the forward factor into the transposed sweep's rows
    (A^T = U^T·L^T needs c_hat_{i-1}, a_{i+1}, …, never a second factor);
  * ``thomas_constant`` / ``penta_constant`` solve one shared factor over
    an interleaved (N, M) batch;
  * ``shared_sweep`` dispatches on where the tensors lie: a CUDA tensor
    goes to the hand-written kernel (``csrc/shared_sweep.cu``) or raises,
    a CPU tensor goes to ``shared_sweep_plain``, the same arithmetic in
    plain torch.  There is no fallback from one to the other.

The per-system-LHS half (cuThomasBatch / cuPentBatch):

  * ``thomas_batch`` / ``penta_batch`` solve M systems that each carry
    their own (N, M)-interleaved diagonals, with the factorisation fused
    into the solve;
  * ``batch_sweep`` dispatches the same way, to ``csrc/batch_sweep.cu``
    or to ``batch_sweep_plain``.

The gated recurrences (``h_i = p_i h_{i-1} + q_i`` and order 2):

  * ``recurrence`` folds a nonzero ``h0`` into the boundary rows of q on
    the host, as the JAX dispatcher does, so the kernel always starts
    from zero carries;
  * ``recurrence_sweep`` dispatches the same way, to
    ``csrc/recurrence_sweep.cu`` or to ``recurrence_plain``.

``LAUNCHES`` counts the kernels' launches by spec name; it is bumped
where a kernel launches and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.recurrence import _shift_down, _shift_up
from . import build
from .engine import (EPS_PARAM, RecurrenceSpec, SweepSpec, compute_dtype,
                     find_recurrence_spec, find_spec)

_C_INT, _C_PTR, _C_I64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
# The C entry point of each kernel library, by name.
_ARGTYPES = {
    # dtype, lhs, rows, rhs, out, eps, n, m, desc, threads, chunk_n, stream
    "shared_sweep": [_C_INT, _C_PTR, _C_INT, _C_PTR, _C_PTR, _C_PTR, _C_I64,
                     _C_I64, ctypes.POINTER(_C_INT), _C_INT, _C_INT, _C_PTR],
    # dtype, bandwidth, diags, rhs, out, work, n, m, threads, stream
    "batch_sweep": [_C_INT, _C_INT, ctypes.POINTER(_C_PTR), _C_PTR, _C_PTR,
                    _C_PTR, _C_I64, _C_I64, _C_INT, _C_PTR],
    # dtype, order, reverse, gates, q, out, n, m, threads, stream
    "recurrence_sweep": [_C_INT, _C_INT, _C_INT, ctypes.POINTER(_C_PTR),
                         _C_PTR, _C_PTR, _C_I64, _C_I64, _C_INT, _C_PTR],
    # dtype, bandwidth, chunks (0: the global route), lhs, z, minv,
    # params, c, x, n, m, threads, stream
    "fused_cn": [_C_INT, _C_INT, _C_INT, _C_PTR, _C_PTR, _C_PTR, _C_PTR,
                 _C_PTR, _C_PTR, _C_I64, _C_I64, _C_INT, _C_PTR],
}

#: Kernel launches by spec name (``thomas_constant``, ``penta_uniform_t``…).
LAUNCHES: dict = {}

DEFAULT_THREADS = 256
DEFAULT_CHUNK_N = 512
_SMEM_LIMIT = 48 * 1024   # bytes of shared memory a block gets by default
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
#: The recurrence kernel also takes fp16 (fp32 carries, as for bf16).
RECURRENCE_DTYPES = {**_DTYPE_CODES, torch.float16: 3}
_STORAGE_ALIASES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                    "float32": torch.float32, "float64": torch.float64}


def reset_launches() -> None:
    LAUNCHES.clear()


def canonical_storage_dtype(storage_dtype):
    """``None`` (store at the operand dtype), a torch dtype, or a name
    (``"bf16"``) -> a floating torch dtype the kernel stores."""
    if storage_dtype is None:
        return None
    dt = _STORAGE_ALIASES.get(storage_dtype, storage_dtype)
    if dt not in _DTYPE_CODES:
        raise ValueError(f"storage_dtype must be float32, float64 or bf16, "
                         f"got {storage_dtype!r}")
    return dt


def stack_tridiag_lhs(f, *, transposed: bool = False) -> torch.Tensor:
    """(3, N) kernel LHS: [a, inv_denom, c_hat], or the transposed rows
    [c_hat_{i-1}, inv_denom, a_{i+1}] — same stored vectors, shifted."""
    if transposed:
        return torch.stack([_shift_down(f.c_hat, 1), f.inv_denom,
                            _shift_up(f.a, 1)])
    return torch.stack([f.a, f.inv_denom, f.c_hat])


def stack_penta_lhs(f, uniform: bool = False, *,
                    transposed: bool = False) -> torch.Tensor:
    """(5, N) kernel LHS [eps, beta, inv_alpha, gamma, delta] ((4, N) when
    ``uniform`` drops the eps row); transposed: [delta_{i-2}, gamma_{i-1},
    inv_alpha, beta_{i+1}(, eps_{i+2})]."""
    eps = torch.broadcast_to(f.eps, f.beta.shape)
    if transposed:
        rows = [_shift_down(f.delta, 2), _shift_down(f.gamma, 1),
                f.inv_alpha, _shift_up(f.beta, 1)]
        if not uniform:
            rows.append(_shift_up(eps, 2))
        return torch.stack(rows)
    if uniform:
        return torch.stack([f.beta, f.inv_alpha, f.gamma, f.delta])
    return torch.stack([eps, f.beta, f.inv_alpha, f.gamma, f.delta])


def _uniform_eps_param(f, dtype) -> torch.Tensor:
    """The all-equal eps value as a 1-element DEVICE tensor (no ``.item()``,
    no host sync).  Index 2 because the factor forces eps[0] = eps[1] = 0;
    below N = 3 eps only ever multiplies zero carries, and the last entry
    stands in (as JAX's clamped index does)."""
    eps = torch.broadcast_to(f.eps, f.beta.shape)
    return eps[min(2, eps.shape[0] - 1)].reshape(1).to(dtype)


# ---------------------------------------------------------------------------
# The sweep: kernel, plain version, dispatch
# ---------------------------------------------------------------------------

def shared_sweep_plain(spec: SweepSpec, lhs: torch.Tensor, rhs: torch.Tensor,
                       eps: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain torch: the same passes, the same
    subtraction order, one row of the batch at a time.  Operands stored
    at bf16 compute (and return) fp32, as the kernel does."""
    cdt = compute_dtype(rhs.dtype)
    coef = lhs.to(cdt)
    eps_c = None if eps is None else eps.to(cdt)[0]
    n, m = rhs.shape
    out = torch.empty((n, m), dtype=cdt, device=rhs.device)
    zeros = torch.zeros((m,), dtype=cdt, device=rhs.device)

    def at(src, i):
        return eps_c if src == EPS_PARAM else coef[src, i]

    def run(pspec, source, rows):
        carries = (zeros,) * spec.order
        for i in rows:
            acc = source[i].to(cdt)
            for src, lag in pspec.terms:
                acc = acc - at(src, i) * carries[lag - 1]
            if pspec.scale is not None:
                acc = acc * at(pspec.scale, i)
            out[i] = acc
            carries = (acc,) + carries[:spec.order - 1]

    fwd, bwd = spec.passes()
    run(fwd, rhs, range(n))
    run(bwd, out, range(n - 1, -1, -1))
    return out


def _pass_desc(pspec, rows: int) -> list:
    """[src0, lag0, src1, lag1, scale] for the kernel; the eps sentinel
    becomes the staged row after the factor rows."""
    words = []
    for t in range(2):
        if t < len(pspec.terms):
            src, lag = pspec.terms[t]
            words += [rows if src == EPS_PARAM else src, lag]
        else:
            words += [-1, 1]
    return words + [-1 if pspec.scale is None else pspec.scale]


def sweep_desc(spec: SweepSpec) -> list:
    """The 11 ints the kernel reads: the order, then each pass."""
    fwd, bwd = spec.passes()
    return ([spec.order] + _pass_desc(fwd, spec.lhs_rows)
            + _pass_desc(bwd, spec.lhs_rows))


def _kernel(name: str):
    """The C entry point ``name`` of the library of the same name, built
    and loaded at first use."""
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def shared_sweep_cuda(spec: SweepSpec, lhs: torch.Tensor, rhs: torch.Tensor,
                      eps: torch.Tensor | None = None, *,
                      threads: int | None = None,
                      chunk_n: int | None = None) -> torch.Tensor:
    """Launch ``csrc/shared_sweep.cu`` on the current stream.  Validates
    device, dtype, shape and contiguity and raises on what the kernel
    does not take; raises when the launch reports a CUDA error."""
    threads = DEFAULT_THREADS if threads is None else int(threads)
    chunk_n = DEFAULT_CHUNK_N if chunk_n is None else int(chunk_n)
    n, m = rhs.shape
    operands = [lhs, rhs] + ([] if eps is None else [eps])
    if any(not t.is_cuda or t.device != rhs.device for t in operands):
        raise ValueError("shared_sweep: every operand must lie on one CUDA "
                         "device")
    if any(t.dtype != rhs.dtype for t in operands):
        raise TypeError("shared_sweep: lhs, rhs and eps must share a dtype")
    if rhs.dtype not in _DTYPE_CODES:
        raise TypeError(f"shared_sweep: unsupported dtype {rhs.dtype}")
    if lhs.shape != (spec.lhs_rows, n) or (eps is None) != (not spec.uniform):
        raise ValueError(f"shared_sweep: {spec.name} takes lhs "
                         f"({spec.lhs_rows}, {n}) and "
                         f"{'an' if spec.uniform else 'no'} eps operand")
    if eps is not None and eps.numel() != 1:
        raise ValueError("shared_sweep: eps must hold one element")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("shared_sweep: operands must be contiguous")
    if not (0 < threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"shared_sweep: threads={threads} must be a "
                         "multiple of 32 in (0, 1024]")
    cdt = compute_dtype(rhs.dtype)
    stage_rows = spec.lhs_rows + (eps is not None)
    smem = stage_rows * chunk_n * torch.empty((), dtype=cdt).element_size()
    if chunk_n <= 0 or smem > _SMEM_LIMIT:
        raise ValueError(f"shared_sweep: chunk_n={chunk_n} stages {smem} "
                         f"bytes of factor; at most {_SMEM_LIMIT} fit")
    out = torch.empty((n, m), dtype=cdt, device=rhs.device)
    if n == 0 or m == 0:
        return out
    fn = _kernel("shared_sweep")
    desc = (ctypes.c_int * 11)(*sweep_desc(spec))
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODES[rhs.dtype], lhs.data_ptr(), spec.lhs_rows,
                rhs.data_ptr(), out.data_ptr(),
                None if eps is None else eps.data_ptr(), n, m, desc,
                threads, chunk_n, stream)
    if rc != 0:
        raise RuntimeError(f"shared_sweep launch failed: CUDA error {rc}")
    LAUNCHES[spec.name] = LAUNCHES.get(spec.name, 0) + 1
    return out


def shared_sweep(spec: SweepSpec, lhs: torch.Tensor, rhs: torch.Tensor,
                 eps: torch.Tensor | None = None) -> torch.Tensor:
    """The sweep on the kernel for CUDA tensors, on the plain version for
    CPU tensors; any other device raises."""
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"shared_sweep: factor dtype {lhs.dtype} and rhs "
                        f"dtype {rhs.dtype} differ")
    if rhs.is_cuda:
        return shared_sweep_cuda(spec, lhs, rhs, eps)
    if rhs.device.type != "cpu":
        raise ValueError(f"shared_sweep: no kernel for device {rhs.device}")
    return shared_sweep_plain(spec, lhs, rhs, eps)


# ---------------------------------------------------------------------------
# The batch sweep: kernel, plain version, dispatch
# ---------------------------------------------------------------------------

def batch_sweep_plain(spec: SweepSpec, diags, rhs: torch.Tensor
                      ) -> torch.Tensor:
    """The batch kernel's function in plain torch, one row at a time:
    the factorisation fused into the forward substitution in
    ``_factor_pass``'s arithmetic order (``repro.kernels.engine``), the
    per-system coefficients kept in a workspace, then the descending
    ``_BATCH_BWD`` pass.  ``diags`` are the ``bandwidth`` (N, M)
    diagonals, sub-most first.  bf16 operands compute (and return) fp32,
    as the kernel does."""
    cdt = compute_dtype(rhs.dtype)
    n, m = rhs.shape
    out = torch.empty((n, m), dtype=cdt, device=rhs.device)
    coefs = torch.empty((spec.n_coefs, n, m), dtype=cdt, device=rhs.device)
    zeros = torch.zeros((m,), dtype=cdt, device=rhs.device)

    def at(r, i):
        return diags[r][i].to(cdt)

    if spec.order == 1:
        chat_p = dh_p = zeros
        for i in range(n):
            a_i = at(0, i)
            inv = 1 / (at(1, i) - a_i * chat_p)
            chat_p = at(2, i) * inv
            dh_p = (rhs[i].to(cdt) - a_i * dh_p) * inv
            coefs[0, i], out[i] = chat_p, dh_p
    else:
        # carries: gamma, delta and g at lags 1 and 2
        g1 = g2 = dl1 = dl2 = gg1 = gg2 = zeros
        for i in range(n):
            a_i = at(0, i)
            beta = at(1, i) - a_i * g2
            alpha = at(2, i) - a_i * dl2 - beta * g1
            inv = 1 / alpha
            gamma = (at(3, i) - beta * dl1) * inv
            delta = at(4, i) * inv
            g = (rhs[i].to(cdt) - a_i * gg2 - beta * gg1) * inv
            coefs[0, i], coefs[1, i], out[i] = gamma, delta, g
            g1, g2, dl1, dl2, gg1, gg2 = gamma, g1, delta, dl1, g, gg1

    _, bwd = spec.passes()
    carries = (zeros,) * spec.order
    for i in range(n - 1, -1, -1):
        acc = out[i]
        for src, lag in bwd.terms:
            acc = acc - coefs[src, i] * carries[lag - 1]
        out[i] = acc
        carries = (acc,) + carries[:spec.order - 1]
    return out


def batch_sweep_cuda(spec: SweepSpec, diags, rhs: torch.Tensor
                     ) -> torch.Tensor:
    """Launch ``csrc/batch_sweep.cu`` on the current stream, with the
    (order, N, M) coefficient workspace allocated here.  Validates device,
    dtype, shape and contiguity and raises on what the kernel does not
    take; raises when the launch reports a CUDA error."""
    n, m = rhs.shape
    operands = [*diags, rhs]
    if spec.layout != "batch" or len(diags) != spec.bandwidth:
        raise ValueError(f"batch_sweep: {spec.name} is not a batch spec of "
                         f"{len(diags)} diagonals")
    if any(not t.is_cuda or t.device != rhs.device for t in operands):
        raise ValueError("batch_sweep: every operand must lie on one CUDA "
                         "device")
    if any(t.dtype != rhs.dtype for t in operands):
        raise TypeError("batch_sweep: diagonals and rhs must share a dtype")
    if rhs.dtype not in _DTYPE_CODES:
        raise TypeError(f"batch_sweep: unsupported dtype {rhs.dtype}")
    if any(t.shape != (n, m) for t in diags):
        raise ValueError(f"batch_sweep: every diagonal must be ({n}, {m})")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("batch_sweep: operands must be contiguous")
    cdt = compute_dtype(rhs.dtype)
    out = torch.empty((n, m), dtype=cdt, device=rhs.device)
    if n == 0 or m == 0:
        return out
    # ``work`` is freed on return while the kernel may still run: the
    # caching allocator reuses the block only for work queued after the
    # kernel on the same stream.
    work = torch.empty((spec.n_coefs, n, m), dtype=cdt, device=rhs.device)
    fn = _kernel("batch_sweep")
    ptrs = (ctypes.c_void_p * spec.bandwidth)(*(t.data_ptr() for t in diags))
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODES[rhs.dtype], spec.bandwidth, ptrs,
                rhs.data_ptr(), out.data_ptr(), work.data_ptr(), n, m,
                DEFAULT_THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"batch_sweep launch failed: CUDA error {rc}")
    LAUNCHES[spec.name] = LAUNCHES.get(spec.name, 0) + 1
    return out


def batch_sweep(spec: SweepSpec, diags, rhs: torch.Tensor) -> torch.Tensor:
    """The batch solve on the kernel for CUDA tensors, on the plain version
    for CPU tensors; any other device raises."""
    if any(t.dtype != rhs.dtype for t in diags):
        raise TypeError(f"batch_sweep: diagonal dtypes "
                        f"{[t.dtype for t in diags]} and rhs dtype "
                        f"{rhs.dtype} differ")
    if rhs.is_cuda:
        return batch_sweep_cuda(spec, diags, rhs)
    if rhs.device.type != "cpu":
        raise ValueError(f"batch_sweep: no kernel for device {rhs.device}")
    return batch_sweep_plain(spec, diags, rhs)


# ---------------------------------------------------------------------------
# The gated recurrence: kernel, plain version, dispatch
# ---------------------------------------------------------------------------

def same_dtype(name: str, operands, ref: torch.Tensor) -> None:
    """Raise unless every operand has ``ref``'s dtype (a kernel reads them
    all as one type)."""
    if any(t.dtype != ref.dtype for t in operands):
        raise TypeError(f"{name}: operand dtypes "
                        f"{[t.dtype for t in operands]} differ from "
                        f"{ref.dtype}")


def recurrence_plain(spec: RecurrenceSpec, gates, q: torch.Tensor
                     ) -> torch.Tensor:
    """The recurrence kernel's function in plain torch, one row at a time,
    from zero carries: ``acc = q_i + g0_i h1 (+ g1_i h2)`` in the kernel's
    term order.  bf16 and fp16 operands carry fp32 and store h at their
    own type, as the kernel does."""
    cdt = compute_dtype(q.dtype)
    n, m = q.shape
    out = torch.empty((n, m), dtype=q.dtype, device=q.device)
    carries = (torch.zeros((m,), dtype=cdt, device=q.device),) * spec.order
    (pspec,) = spec.passes()
    rows = range(n - 1, -1, -1) if spec.reverse else range(n)
    for i in rows:
        acc = q[i].to(cdt)
        for src, lag in pspec.terms:
            acc = acc + gates[src][i].to(cdt) * carries[lag - 1]
        out[i] = acc
        carries = (acc,) + carries[:spec.order - 1]
    return out


def recurrence_cuda(spec: RecurrenceSpec, gates, q: torch.Tensor
                    ) -> torch.Tensor:
    """Launch ``csrc/recurrence_sweep.cu`` on the current stream.
    Validates device, dtype, shape and contiguity and raises on what the
    kernel does not take; raises when the launch reports a CUDA error."""
    n, m = q.shape
    operands = [*gates, q]
    if len(gates) != spec.order:
        raise ValueError(f"recurrence: {spec.name} takes {spec.order} "
                         f"gate(s), got {len(gates)}")
    if any(not t.is_cuda or t.device != q.device for t in operands):
        raise ValueError("recurrence: every operand must lie on one CUDA "
                         "device")
    same_dtype("recurrence", gates, q)
    if q.dtype not in RECURRENCE_DTYPES:
        raise TypeError(f"recurrence: unsupported dtype {q.dtype}")
    if any(t.shape != (n, m) for t in gates):
        raise ValueError(f"recurrence: every gate must be ({n}, {m})")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("recurrence: operands must be contiguous")
    out = torch.empty((n, m), dtype=q.dtype, device=q.device)
    if n == 0 or m == 0:
        return out
    fn = _kernel("recurrence_sweep")
    ptrs = (ctypes.c_void_p * spec.order)(*(t.data_ptr() for t in gates))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(RECURRENCE_DTYPES[q.dtype], spec.order, int(spec.reverse),
                ptrs, q.data_ptr(), out.data_ptr(), n, m, DEFAULT_THREADS,
                stream)
    if rc != 0:
        raise RuntimeError(f"recurrence launch failed: CUDA error {rc}")
    LAUNCHES[spec.name] = LAUNCHES.get(spec.name, 0) + 1
    return out


def recurrence_sweep(spec: RecurrenceSpec, gates, q: torch.Tensor
                     ) -> torch.Tensor:
    """The recurrence on the kernel for CUDA tensors (which validates its
    operands), on the plain version for CPU tensors; any other device
    raises."""
    if q.is_cuda:
        return recurrence_cuda(spec, gates, q)
    if q.device.type != "cpu":
        raise ValueError(f"recurrence: no kernel for device {q.device}")
    same_dtype("recurrence", gates, q)
    return recurrence_plain(spec, gates, q)


def recurrence(*operands, h0=None, reverse: bool = False) -> torch.Tensor:
    """Gated linear recurrence over an interleaved (N, M) batch.

    ``operands`` is ``(p, q)`` for ``h_i = p_i h_{i-1} + q_i`` or
    ``(s, t, u)`` for ``h_i = s_i h_{i-1} + t_i h_{i-2} + u_i``: per-token
    (N, M) gates and the additive operand, one dtype.  ``reverse=True``
    runs from i = N-1 down (carries index i+1, i+2).

    ``h0`` (an array broadcastable over the lanes for order 1, a
    ``(h_{-1}, h_{-2})`` pair for order 2) is folded into the boundary
    rows of q here, on the host, as ``repro.kernels.ops.recurrence``
    does, so the kernel keeps its zero carries.  There is no lane or sweep
    padding: the kernel masks the ragged edge of M and walks all N."""
    *gates, q = operands
    order = len(gates)
    if order not in (1, 2):
        raise ValueError(
            f"recurrence takes (p, q) or (s, t, u); got {order + 1} operands")
    n = q.shape[0]
    if h0 is not None:
        hs = (h0,) if order == 1 and not isinstance(h0, (tuple, list)) \
            else tuple(h0)
        if len(hs) != order:
            raise ValueError(f"h0 must carry {order} state(s), got {len(hs)}")
        hs = tuple(torch.broadcast_to(torch.as_tensor(h, device=q.device),
                                      q.shape[1:]).to(q.dtype) for h in hs)
        e0 = n - 1 if reverse else 0
        fold = gates[0][e0] * hs[0]
        if order == 2:
            fold = fold + gates[1][e0] * hs[1]
        q = q.clone()
        q[e0] += fold
        if order == 2 and n > 1:
            e1 = n - 2 if reverse else 1
            q[e1] += gates[1][e1] * hs[0]
    spec = find_recurrence_spec(order, reverse=reverse)
    return recurrence_sweep(spec, [g.contiguous() for g in gates],
                            q.contiguous())


# ---------------------------------------------------------------------------
# Solver-facing entry points
# ---------------------------------------------------------------------------

def _as_stored(tensors, storage_dtype) -> list:
    """The operands as the kernels read them: cast to ``storage_dtype``
    (when given) and contiguous."""
    sdt = canonical_storage_dtype(storage_dtype)
    if sdt is not None:
        tensors = [t.to(sdt) for t in tensors]
    return [t.contiguous() for t in tensors]


def thomas_constant(f, d: torch.Tensor, *, transposed: bool = False,
                    storage_dtype=None) -> torch.Tensor:
    """Constant-LHS batched Thomas solve (cuThomasConstantBatch). d: (N, M).

    ``transposed=True`` solves A^T x = d from the SAME stored factor.
    ``storage_dtype="bf16"`` stores the factor and RHS at bf16 (fp32
    accumulation; the solve returns fp32)."""
    spec = find_spec(3, "constant", transposed=transposed)
    lhs, d = _as_stored((stack_tridiag_lhs(f, transposed=transposed), d),
                        storage_dtype)
    return shared_sweep(spec, lhs, d)


def penta_constant(f, rhs: torch.Tensor, *, uniform: bool = False,
                   transposed: bool = False,
                   storage_dtype=None) -> torch.Tensor:
    """Constant-LHS batched penta solve (cuPentConstantBatch, or
    cuPentUniformBatch when ``uniform``: eps rides as a 1-element tensor).
    ``transposed=True`` solves A^T x = rhs from the SAME stored factor."""
    spec = find_spec(5, "uniform" if uniform else "constant",
                     transposed=transposed)
    lhs, rhs = _as_stored(
        (stack_penta_lhs(f, uniform=uniform, transposed=transposed), rhs),
        storage_dtype)
    eps = _uniform_eps_param(f, lhs.dtype) if uniform else None
    return shared_sweep(spec, lhs, rhs, eps)


def thomas_batch(a, b, c, d, *, storage_dtype=None) -> torch.Tensor:
    """Per-system-LHS batched Thomas solve (cuThomasBatch).  a/b/c/d: (N, M),
    system m's diagonals in column m; the factorisation is fused into the
    solve.  ``storage_dtype="bf16"`` stores diagonals and RHS at bf16 (fp32
    accumulation; the solve returns fp32).

    Unlike the JAX package there is no lane or sweep padding (and so no
    identity padding of the main diagonal): the kernel masks the ragged
    edge of M itself and walks all N rows."""
    *diags, d = _as_stored((a, b, c, d), storage_dtype)
    return batch_sweep(find_spec(3, "batch"), diags, d)


def penta_batch(a, b, c, d, e, rhs, *, storage_dtype=None) -> torch.Tensor:
    """Per-system-LHS batched penta solve (cuPentBatch).  a..e and rhs:
    (N, M), ``c`` the main diagonal; no padding, as for ``thomas_batch``."""
    *diags, rhs = _as_stored((a, b, c, d, e, rhs), storage_dtype)
    return batch_sweep(find_spec(5, "batch"), diags, rhs)
