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
    plain torch.  There is no fallback from one to the other;
  * ``shared_route(N, dtype)`` picks the kernel's route: on chip (a tile
    of all N rows in shared memory, swept in ``chunk_count`` row chunks
    from zero carries and fixed up by each chunk's carry responses) up to
    ``onchip_max_rows`` (1614 at float32 and bf16, 807 at float64), else
    partitioned (row blocks of ``ROW_BLOCK_BYTES`` of column, in four
    launches: coefficients K0, summaries K1, chain K2, finish K3).  The
    plain version takes the same row blocks and chunks and repeats that
    order.  ``shared_sweep_cuda`` takes a forced ``route=`` (also
    ``"serial"``, the first one-thread-a-column kernel, which nothing
    else reaches), ``chunks=`` and ``tile_m=``, to time them.

The per-system-LHS half (cuThomasBatch / cuPentBatch):

  * ``thomas_batch`` / ``penta_batch`` solve M systems that each carry
    their own (N, M)-interleaved diagonals, with the factorisation fused
    into the solve;
  * ``batch_sweep`` dispatches the same way, to ``csrc/batch_sweep.cu``
    or to ``batch_sweep_plain``;
  * ``batch_route(N, dtype, bandwidth)`` picks the kernel's route: on chip
    for tridiagonal systems up to ``batch_onchip_max_rows`` (512 at
    float32 and bf16, 256 at float64: each system's rows split into row
    chunks whose factor is joined by a fold of 2×2 companion products,
    every intermediate kept on the SM), else stream (one thread walks a
    whole system, the factor and intermediate through device memory).
    The plain version takes the same chunks and repeats that order (and,
    pentadiagonal, any chunks in the six-minor split's order, which no
    kernel runs yet); ``batch_sweep_cuda`` takes a forced ``route=`` to
    time one against the other.

The gated recurrences (``h_i = p_i h_{i-1} + q_i`` and order 2):

  * ``recurrence`` folds a nonzero ``h0`` into the boundary rows of q on
    the host, as the JAX dispatcher does, so the kernel always starts
    from zero carries;
  * ``recurrence_sweep`` dispatches the same way, to
    ``csrc/recurrence_sweep.cu`` or to ``recurrence_plain``;
  * ``recurrence_route(N, M, dtype, order)`` picks the kernel's route:
    the tile (a block of 32 columns walks N in windows of row chunks, each
    chunk walked from a zero carry with its unit-carry responses, joined
    by a linear fold, and walked again from its true carry) from
    ``RECURRENCE_TILE_MIN_ROWS`` rows up to
    ``RECURRENCE_TILE_MAX_COLUMNS[order]`` columns, else the walk (one thread a
    column).  The plain version takes the same chunks and repeats that
    order; ``recurrence_cuda`` takes a forced ``route=`` and ``chunks=``,
    to time them.

``LAUNCHES`` counts the kernels' launches by spec name, and
``LAUNCH_BYTES`` the least bytes those launches must move (each input read
once, each output written once); both are bumped where a kernel launches
and nowhere else.  The ``*_cuda`` wrappers take an internal ``out=``, a
buffer the kernel writes x into, so that a check can fill it first
(``repro_torch.analysis.nansweep`` fills it with NaN to show every element
written).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.recurrence import _shift_down, _shift_up
from . import build
from .engine import (EPS_PARAM, RecurrenceSpec, SweepSpec, compute_dtype,
                     find_recurrence_spec, find_spec)

_C_INT, _C_PTR, _C_I64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
# The C entry point of each kernel library, by name.
_ARGTYPES = {
    # dtype, route, blocks, chunks, tile, stage, lhs, rows, rhs, out, eps,
    # work, n, m, desc, stream
    "shared_sweep": [_C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_PTR,
                     _C_INT, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_I64, _C_I64,
                     ctypes.POINTER(_C_INT), _C_PTR],
    # dtype, bandwidth, route, chunks, diags, rhs, out, work, n, m,
    # threads, stream
    "batch_sweep": [_C_INT, _C_INT, _C_INT, _C_INT, ctypes.POINTER(_C_PTR),
                    _C_PTR, _C_PTR, _C_PTR, _C_I64, _C_I64, _C_INT, _C_PTR],
    # dtype, order, reverse, route, chunks, rows, gates, q, out, n, m,
    # threads, stream
    "recurrence_sweep": [_C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT,
                         ctypes.POINTER(_C_PTR), _C_PTR, _C_PTR, _C_I64,
                         _C_I64, _C_INT, _C_PTR],
    # dtype, bandwidth, route, blocks, chunks, stage, lhs, z, minv, params,
    # c, x, work, desc, n, m, threads, stream
    "fused_cn": [_C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_PTR,
                 _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR,
                 ctypes.POINTER(_C_INT), _C_I64, _C_I64, _C_INT, _C_PTR],
}

#: Kernel launches by spec name (``thomas_constant``, ``penta_uniform_t``…).
LAUNCHES: dict = {}
#: The byte floor of those launches by spec name: the traffic a launch
#: must move at its operands' shapes and types.
LAUNCH_BYTES: dict = {}

DEFAULT_THREADS = 256
# The tile kernels' geometry, as in ``csrc/shared_sweep.cu`` and
# ``csrc/fused_cn.cu``: columns of a tile (one warp wide), rows of carry
# responses stored after its N rows, and at most MAX_CHUNKS row chunks a
# block.
TILE_M = 32
RESP_ROWS = 4
MAX_CHUNKS = 16
#: Bytes of shared memory a block may opt in to on Hopper (sm_90).
SMEM_PER_BLOCK = 232_448
#: Bytes of column in one row block of the shared sweep's partitioned route.
ROW_BLOCK_BYTES = 2048
SHARED_ROUTES = ("onchip", "partition", "serial")
#: The batch sweep's routes (``csrc/batch_sweep.cu``): on chip (tridiagonal,
#: at most ``batch_onchip_chunks`` row chunks of BATCH_ROWS rows a block of
#: TILE_M systems) and stream (one thread a system).
BATCH_ROUTES = ("onchip", "stream")
BATCH_ROWS = 16
_BATCH_ROUTE_CODES = {"stream": 0, "onchip": 1}
#: A chunk's companion product is rescaled by a power of two when its
#: largest entry leaves [1 / RESCALE_AT, RESCALE_AT].
RESCALE_AT = 2.0 ** 60
_ROUTE_CODES = {"serial": 0, "onchip": 1, "partition": 2}
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
#: The recurrence kernel also takes fp16 (fp32 carries, as for bf16).
RECURRENCE_DTYPES = {**_DTYPE_CODES, torch.float16: 3}
#: The recurrence kernel's routes (``csrc/recurrence_sweep.cu``): walk (one
#: thread a column) and tile (TILE_M columns a block, in row chunks of
#: RECURRENCE_ROWS rows joined by carry folds).
RECURRENCE_ROUTES = ("walk", "tile")
_RECURRENCE_ROUTE_CODES = {"walk": 0, "tile": 1}
#: Rows a chunk of the tile route (compile-time in the kernel), and the
#: chunks (warps) a block holds at most.
RECURRENCE_ROWS = 8
RECURRENCE_MAX_CHUNKS = 16
#: The tile route's chunks a block by order: order 2 carries three times
#: the summaries and half again the registers, and ran fastest at 8.
RECURRENCE_TILE_CHUNKS = {1: RECURRENCE_MAX_CHUNKS, 2: 8}
#: The tile takes N from this many rows (one window of 16 chunks; below it
#: the walk ran as fast or faster on an H100) and M up to this many columns
#: by order (the last M where the tile ran faster: the walk's grid then
#: keeps too few loads in flight; past it the walk ran as fast or faster;
#: PERF.md §6, ``chip_smoke.py --routes``).
RECURRENCE_TILE_MIN_ROWS = RECURRENCE_MAX_CHUNKS * RECURRENCE_ROWS
RECURRENCE_TILE_MAX_COLUMNS = {1: 98304, 2: 49152}
_STORAGE_ALIASES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                    "float32": torch.float32, "float64": torch.float64}


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCH_BYTES.clear()


def count_launch(name: str, nbytes: int) -> None:
    """One launch of ``name``, moving at least ``nbytes``."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    LAUNCH_BYTES[name] = LAUNCH_BYTES.get(name, 0) + nbytes


def output_buffer(name: str, out, shape: tuple, dtype, device
                  ) -> torch.Tensor:
    """``out`` once it is a contiguous ``shape`` tensor of ``dtype`` on
    ``device``; a new ``torch.empty`` when it is None."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {tuple(shape)} "
                         f"{dtype} tensor on {device}")
    return out


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
# The sweep: routes, plain version, kernel, dispatch
# ---------------------------------------------------------------------------

def _compute_itemsize(dtype) -> int:
    return compute_dtype(dtype).itemsize


def onchip_max_rows(dtype) -> int:
    """The largest N whose tile (``TILE_M`` columns and ``RESP_ROWS``
    response rows over N rows, at the compute type) fits one block's shared
    memory: 1614 at float32 and bf16, 807 at float64."""
    return SMEM_PER_BLOCK // ((TILE_M + RESP_ROWS) * _compute_itemsize(dtype))


def chunk_count(n: int, dtype) -> int:
    """Row chunks (thread groups) of a tile over ``n`` rows: one for every
    256 bytes of a column at the compute type, at most ``MAX_CHUNKS``; 8 at
    N = 512 float32, 16 at float64."""
    return max(1, min(MAX_CHUNKS, n * _compute_itemsize(dtype) // 256))


def chunk_bounds(n: int, chunks: int) -> list:
    """Row bounds ``[s_0 = 0, s_1, …, s_P = n]``: part k is rows
    ``[k·n // P, (k + 1)·n // P)`` (row blocks and chunks alike)."""
    return [k * n // chunks for k in range(chunks + 1)]


@dataclasses.dataclass(frozen=True)
class SharedRoute:
    """How ``csrc/shared_sweep.cu`` solves one (N, dtype): the route, its
    row blocks (1 on chip), row chunks a block and columns a tile."""

    name: str
    row_blocks: int
    chunks: int
    tile_m: int


def shared_route(n: int, dtype, which: str | None = None) -> SharedRoute:
    """The route of the shared sweep at (N, dtype): ``"onchip"`` while a
    tile over all N rows fits one block (``onchip_max_rows``), else
    ``"partition"``, in row blocks of ``ROW_BLOCK_BYTES`` of column (512
    rows at float32 and bf16, 256 at float64).  ``which`` names a route to
    take instead (``"serial"``: one thread a column, one chunk); one that
    cannot take N raises.  A pure function of its arguments."""
    n_max = onchip_max_rows(dtype)
    which = ("onchip" if n <= n_max else "partition") if which is None \
        else which
    if which == "onchip":
        if n > n_max:
            raise ValueError(f"shared_sweep: N = {n} is past the on-chip "
                             f"route's {n_max} rows at {dtype}")
        return SharedRoute("onchip", 1, chunk_count(n, dtype), TILE_M)
    if which == "partition":
        blocks = max(1, -(-n // (ROW_BLOCK_BYTES // _compute_itemsize(dtype))))
        return SharedRoute("partition", blocks,
                           chunk_count(n // blocks, dtype), TILE_M)
    if which == "serial":
        return SharedRoute("serial", 1, 1, TILE_M)
    raise ValueError(f"shared_sweep: route must be one of {SHARED_ROUTES}, "
                     f"got {which!r}")


def _check_split(n: int, blocks: int, chunks: int) -> None:
    """Raise unless ``blocks`` row blocks of ``chunks`` chunks split N rows
    with at least one row in every chunk."""
    if not (blocks >= 1 and 1 <= chunks <= MAX_CHUNKS
            and n // blocks >= chunks):
        raise ValueError(f"shared_sweep: {blocks} row blocks of {chunks} "
                         f"chunks do not split N = {n} (1..{MAX_CHUNKS} "
                         "chunks, a row each)")


def _sweep(pspec, order: int, coef, eps_c, spans: list, reverse: bool,
           src: torch.Tensor | None = None) -> tuple:
    """Every span of rows swept by ``pspec`` from zero carries, all spans at
    once, in the kernel's term order, over ``src`` (N, K) (K = 0 when None)
    and, beside it, over zeros from a unit carry at lag 1 and at lag 2.
    Returns (the sweep of ``src``, the spans' carry responses (N, order))."""
    dev, cdt = coef.device, coef.dtype
    rows_at, short = _walk(spans, reverse, dev)
    k = 0 if src is None else src.shape[1]
    n = max(e for _, e in spans)
    ext = torch.zeros((n, k + order), dtype=cdt, device=dev)
    if k:
        ext[:, :k] = src
    unit = torch.zeros((order, k + order), dtype=cdt, device=dev)
    unit[:, k:] = torch.eye(order, dtype=cdt, device=dev)
    carries = tuple(unit[lag].expand(len(spans), -1) for lag in range(order))
    out = torch.empty_like(ext)
    for rows, live in zip(rows_at, short):
        acc = ext[rows]
        for row, lag in pspec.terms:
            c = eps_c if row == EPS_PARAM else coef[row, rows][:, None]
            acc = acc - c * carries[lag - 1]
        if pspec.scale is not None:
            acc = acc * coef[pspec.scale, rows][:, None]
        if live is None:
            out[rows] = acc
        else:
            out[rows[live]] = acc[live]
        carries = (acc,) + carries[:order - 1]
    return out[:, :k], out[:, k:]


def _chain(span: tuple, values, resp, carry: list, down: bool):
    """The carries the rows ``span`` pass on: ``values`` + ``resp`` ·
    ``carry`` at the span's last ``order`` rows (first rows when
    ``down``), a row outside the span passing the lag-1 carry on."""
    s, e = span
    out = []
    for r in range(len(carry)):
        i = s + r if down else e - 1 - r
        if s <= i < e:
            v = values[i]
            for lag, g in enumerate(carry):
                v = v + resp[i, lag] * g
            out.append(v)
        else:
            out.append(carry[0])
    return out


def _tile_sweeps(spec, coef, eps_c, rhs, blocks: int, chunks: int,
                 fin=None, yin=None) -> torch.Tensor:
    """What the tile kernel does to each row block, in plain torch: sweep
    its ``chunks`` chunks from zero carries, chain the carries over the
    chunk ends from the block's entry carries ``fin`` (zero when None), fix
    the rows up, and the same backward from ``yin``.  Returns x."""
    n, m = rhs.shape
    order = spec.order
    fwd, bwd = spec.passes()
    spans = split_spans(n, blocks, chunks)
    per_block = [spans[b * chunks:(b + 1) * chunks] for b in range(blocks)]
    zero = [torch.zeros((m,), dtype=coef.dtype, device=rhs.device)] * order

    x, resp = _sweep(fwd, order, coef, eps_c, spans, False, rhs)
    gin = []
    for b, block in enumerate(per_block):
        g = zero if fin is None else fin[b]
        for span in block:
            gin.append(g)
            g = _chain(span, x, resp, g, down=False)
    for (s, e), g in zip(spans, gin):
        for lag in range(order):
            x[s:e] = x[s:e] + resp[s:e, lag:lag + 1] * g[lag]

    x, resp = _sweep(bwd, order, coef, eps_c, spans, True, x)
    yins = [None] * len(spans)
    at = len(spans)
    for b in range(blocks - 1, -1, -1):
        y = zero if yin is None else yin[b]
        for span in reversed(per_block[b]):
            at -= 1
            yins[at] = y
            y = _chain(span, x, resp, y, down=True)
    for (s, e), y in zip(spans, yins):
        for lag in range(order):
            x[s:e] = x[s:e] + resp[s:e, lag:lag + 1] * y[lag]
    return x


def split_spans(n: int, blocks: int, chunks: int) -> list:
    """The row spans ``[(s, e), …]`` of ``chunks`` chunks in each of
    ``blocks`` row blocks over N rows, in row order."""
    spans = []
    bounds = chunk_bounds(n, blocks)
    for s, e in zip(bounds[:-1], bounds[1:]):
        cb = chunk_bounds(e - s, chunks)
        spans += [(s + a, s + b) for a, b in zip(cb[:-1], cb[1:])]
    return spans


def carry_responses(spec, lhs: torch.Tensor, eps: torch.Tensor | None = None,
                    *, blocks: int = 1, chunks: int = 1) -> torch.Tensor:
    """Each chunk's sweep of a unit carry, from the factor rows alone, as
    the tile kernels compute them (at the compute type, in the pass's term
    order): (2·order, N), the forward responses to a unit carry at lag 1
    (and 2), then the backward ones."""
    order = spec.order
    coef = lhs.to(compute_dtype(lhs.dtype))
    eps_c = None if eps is None else eps.to(coef.dtype)[0]
    spans = split_spans(lhs.shape[1], blocks, chunks)
    fwd, bwd = spec.passes()
    return torch.cat([_sweep(fwd, order, coef, eps_c, spans, False)[1].T,
                      _sweep(bwd, order, coef, eps_c, spans, True)[1].T])


def _walk(spans: list, descending: bool, dev) -> tuple:
    """(rows, short): the row of each span at each step, walked ascending
    or descending (a span past its end repeats its first row), and each
    step's mask of spans still in their rows (None while all are)."""
    lens = [e - s for s, e in spans]
    rows = torch.tensor([[(e - 1 - t if descending else s + t)
                          if t < e - s else s for s, e in spans]
                         for t in range(max(lens))], device=dev)
    short = [None if t < min(lens) else
             torch.tensor([t < ln for ln in lens], device=dev)
             for t in range(max(lens))]
    return rows, short


def _adjoint(pspec, coef, eps_c, spans: list, descending: bool,
             seed: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``pspec`` over each span, from zero carries outside
    it, all spans at once: d/d in_i of Σ_k seed_k out_k for each column of
    ``seed`` (N, K), walked against the pass in K0's arithmetic order:
    u_i = (seed_i + pending_i) · scale(i), and each term hands
    −coef_t(i) · u_i on to the row lag_t back along the walk."""
    rows_at, short = _walk(spans, descending, coef.device)
    zeros = torch.zeros((len(spans), seed.shape[1]), dtype=coef.dtype,
                        device=coef.device)
    out = torch.zeros_like(seed)
    p1 = p2 = zeros
    for rows, live in zip(rows_at, short):
        u = seed[rows] + p1
        if pspec.scale is not None:
            u = u * coef[pspec.scale, rows][:, None]
        if live is None:
            out[rows] = u
        else:
            out[rows[live]] = u[live]
        n1, n2 = p2, zeros
        for row, lag in pspec.terms:
            c = eps_c if row == EPS_PARAM else coef[row, rows][:, None]
            if lag == 1:
                n1 = n1 - c * u
            else:
                n2 = n2 - c * u
        p1, p2 = n1, n2
    return out


def summary_weights(spec, coef, eps_c, n: int, blocks: int) -> torch.Tensor:
    """K0's summary weights, (N, 2·order): column r gives each row block's
    forward end value f_{e−1−r}, column order + r its backward start value
    y_{s+r}, both swept from zero carries, as weights on the block's rows
    of the RHS (the adjoints of the block's sweeps)."""
    order = spec.order
    fwd, bwd = spec.passes()
    spans = split_spans(n, blocks, 1)
    seed_end = torch.zeros((n, order), dtype=coef.dtype, device=coef.device)
    seed_start = torch.zeros_like(seed_end)
    for s, e in spans:
        for r in range(min(order, e - s)):
            seed_end[e - 1 - r, r] = 1
            seed_start[s + r, r] = 1
    ends = _adjoint(fwd, coef, eps_c, spans, True, seed_end)
    starts = _adjoint(bwd, coef, eps_c, spans, False, seed_start)
    starts = _adjoint(fwd, coef, eps_c, spans, True, starts)
    return torch.cat([ends, starts], 1)


def _summaries(weights: torch.Tensor, rhs: torch.Tensor, blocks: int,
               order: int) -> tuple:
    """K1: each row block's forward end and backward start values, Σ
    weight · rhs over its rows in row order.  Returns (fend, bstart), per
    block a list of ``order`` (M,) tensors."""
    n = rhs.shape[0]
    spans = split_spans(n, blocks, 1)
    rows_at, short = _walk(spans, False, rhs.device)
    acc = [torch.zeros((blocks, rhs.shape[1]), dtype=weights.dtype,
                       device=rhs.device)] * (2 * order)
    for rows, live in zip(rows_at, short):
        x = rhs[rows].to(weights.dtype)
        w = weights[rows]
        if live is not None:
            w = w * live[:, None]
        acc = [a + w[:, k:k + 1] * x for k, a in enumerate(acc)]
    return ([[acc[r][b] for r in range(order)] for b in range(blocks)],
            [[acc[order + r][b] for r in range(order)]
             for b in range(blocks)])


def block_coefficients(spec, coef, eps_c, n: int, blocks: int) -> list:
    """Each row block's ``(phi, w, psi)``, order × order nested lists of
    0-d tensors, from the factor alone: ``phi[r][l]`` the forward response
    to a unit carry at lag l + 1 at the block's row e − 1 − r, ``w[r][l]``
    the backward sweep of that response from zero carries at row s + r,
    ``psi[r][l]`` the backward response to a unit carry at lag l + 1 at
    row s + r; each swept over the whole block, as K1 computes them."""
    order = spec.order
    fwd, bwd = spec.passes()
    bounds = chunk_bounds(n, blocks)
    spans = list(zip(bounds[:-1], bounds[1:]))
    rf = _sweep(fwd, order, coef, eps_c, spans, False)[1]
    w, rb = _sweep(bwd, order, coef, eps_c, spans, True, rf)
    # a row outside a one-row block is the carry it passes on: the unit
    # carry's lag-1 value for the responses, zero for w
    unit = torch.eye(2, dtype=coef.dtype, device=coef.device)[0]
    out = []
    for s, e in spans:
        def at(table, i, lag, outside):
            return table[i, lag] if s <= i < e else outside[lag]
        out.append((
            [[at(rf, e - 1 - r, lag, unit) for lag in range(order)]
             for r in range(order)],
            [[at(w, s + r, lag, 0 * unit) for lag in range(order)]
             for r in range(order)],
            [[at(rb, s + r, lag, unit) for lag in range(order)]
             for r in range(order)]))
    return out


def shared_sweep_plain(spec: SweepSpec, lhs: torch.Tensor, rhs: torch.Tensor,
                       eps: torch.Tensor | None = None, *,
                       blocks: int | None = None,
                       chunks: int | None = None) -> torch.Tensor:
    """The kernel's function in plain torch, in the kernel's order of
    operations: ``blocks`` row blocks (default: ``shared_route``'s), each
    swept in ``chunks`` row chunks (default: ``chunk_count`` of a block's
    rows) from zero carries, the chunk carries chained and the rows fixed
    up; past one block, K0's ``summary_weights`` and
    ``block_coefficients``, K1's summaries, K2's chain over the blocks and
    K3's sweeps from the entry carries.  One block of one chunk is the
    plain sequential sweep.  Operands stored at
    bf16 compute (and return) fp32, as the kernel does."""
    n, m = rhs.shape
    cdt = compute_dtype(rhs.dtype)
    if n == 0 or m == 0:
        return torch.empty((n, m), dtype=cdt, device=rhs.device)
    if blocks is None:
        blocks = shared_route(n, rhs.dtype).row_blocks
    if chunks is None:
        chunks = chunk_count(n // blocks, rhs.dtype)
    _check_split(n, blocks, chunks)
    coef = lhs.to(cdt)
    eps_c = None if eps is None else eps.to(cdt)[0]
    if blocks == 1:
        return _tile_sweeps(spec, coef, eps_c, rhs, 1, chunks)
    fin, yin, _, _ = chain_blocks(spec, coef, eps_c, rhs, blocks)
    return _tile_sweeps(spec, coef, eps_c, rhs, blocks, chunks, fin, yin)


def chain_blocks(spec, coef, eps_c, rhs: torch.Tensor, blocks: int) -> tuple:
    """K0–K2 of the partitioned route in plain torch: K0's
    ``summary_weights`` and ``block_coefficients``, K1's summaries of
    ``rhs`` and K2's chain over the row blocks.  Returns ``(fin, yin,
    fend, ystart)``: each block's entry carries, forward (f_{s−1},
    f_{s−2}) and backward (y_e, y_{e+1}), and the chain's ends, the
    forward values (f_{N−1}, f_{N−2}) and y (y_0, y_1); ``order`` (M,)
    tensors each."""
    n, m = rhs.shape
    order = spec.order
    fend, bstart = _summaries(
        summary_weights(spec, coef, eps_c, n, blocks), rhs, blocks, order)
    coefs = block_coefficients(spec, coef, eps_c, n, blocks)
    zero = [torch.zeros((m,), dtype=coef.dtype, device=rhs.device)] * order
    f, fin = zero, []
    for b in range(blocks):
        fin.append(f)
        phi = coefs[b][0]
        f = [_dot(fend[b][r], phi[r], f) for r in range(order)]
    y, yin = zero, [None] * blocks
    for b in range(blocks - 1, -1, -1):
        yin[b] = y
        _, w, psi = coefs[b]
        y = [_dot(_dot(bstart[b][r], w[r], fin[b]), psi[r], y)
             for r in range(order)]
    return fin, yin, f, y


def _dot(v, weights, carries):
    """``v + weights[0]·carries[0] (+ weights[1]·carries[1])``, in that
    order."""
    for wgt, c in zip(weights, carries):
        v = v + wgt * c
    return v


def _pass_desc(pspec, rows: int) -> list:
    """[src0, lag0, src1, lag1, scale] for the kernel; the eps sentinel
    becomes the row index one past the factor rows."""
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


def _shared_launch(spec, lhs, rhs, eps, route, chunks, tile_m,
                   out=None) -> tuple:
    """Validate the operands and the route, allocate x (and the partitioned
    route's workspace); returns ``(launch(stage), x)``, where
    ``launch(stage)`` runs the whole solve (stage 0) or one of K0–K3
    (stages 1–4) and raises on a CUDA error.  Counts nothing."""
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
    picked = shared_route(n, rhs.dtype, route)
    if picked.name == "serial" and (chunks not in (None, 1)
                                    or tile_m is not None):
        raise ValueError("shared_sweep: the serial route sweeps whole "
                         "columns; it takes no chunks or tile")
    # chunks and tile_m are Python arguments, never tensors
    chunks = picked.chunks if chunks is None else int(chunks)  # speclint: allow-concretize
    tile_m = picked.tile_m if tile_m is None else int(tile_m)  # speclint: allow-concretize
    if tile_m not in (16, 32):
        raise ValueError(f"shared_sweep: tile_m={tile_m} must be 16 or 32")
    if n and m:
        _check_split(n, picked.row_blocks, chunks)
    cdt = compute_dtype(rhs.dtype)
    out = output_buffer("shared_sweep", out, (n, m), cdt, rhs.device)
    work = None
    if picked.name == "partition" and m:
        order, b = spec.order, picked.row_blocks
        work = torch.empty(4 * b * order * m + 3 * b * order * order
                           + 2 * order * n, dtype=cdt, device=rhs.device)
    fn = _kernel("shared_sweep")
    desc = (ctypes.c_int * 11)(*sweep_desc(spec))

    def launch(stage: int = 0) -> None:
        if n == 0 or m == 0:
            return
        with torch.cuda.device(rhs.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(_DTYPE_CODES[rhs.dtype], _ROUTE_CODES[picked.name],
                    picked.row_blocks, chunks, tile_m, stage, lhs.data_ptr(),
                    spec.lhs_rows, rhs.data_ptr(), out.data_ptr(),
                    None if eps is None else eps.data_ptr(),
                    None if work is None else work.data_ptr(), n, m, desc,
                    stream)
        if rc != 0:
            raise RuntimeError(f"shared_sweep ({picked.name} route) launch "
                               f"failed: CUDA error {rc}")

    return launch, out


def shared_sweep_cuda(spec: SweepSpec, lhs: torch.Tensor, rhs: torch.Tensor,
                      eps: torch.Tensor | None = None, *,
                      route: str | None = None, chunks: int | None = None,
                      tile_m: int | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/shared_sweep.cu`` on the current stream, on the route
    ``shared_route(N, dtype)`` picks.  ``route``, ``chunks`` and ``tile_m``
    force another choice, to time one against another; a route that cannot
    take N raises, and nothing falls back.  Validates device, dtype, shape
    and contiguity and raises on what the kernel does not take; raises when
    a launch reports a CUDA error.  Counts one launch a solve."""
    launch, out = _shared_launch(spec, lhs, rhs, eps, route, chunks, tile_m,
                                 out)
    launch()
    count_launch(spec.name, spec.traffic_bytes(*rhs.shape, rhs.dtype))
    return out


def partition_stages(spec: SweepSpec, lhs: torch.Tensor, rhs: torch.Tensor,
                     eps: torch.Tensor | None = None) -> dict:
    """``{"k0": f, …, "k3": f}``: each call launches one of the
    partitioned route's kernels alone, on one workspace, to time them;
    each reads what the last launch of the one before it wrote.  Not
    counted in ``LAUNCHES``: a stage is not a solve."""
    launch, _ = _shared_launch(spec, lhs, rhs, eps, "partition", None, None)
    return {f"k{stage - 1}": (lambda stage=stage: launch(stage))
            for stage in (1, 2, 3, 4)}


def shared_tile_blocks_per_sm(rows: int, dtype, order: int, chunks: int,
                              tile_m: int = TILE_M) -> int:
    """Blocks of the tile kernel over ``rows`` rows that one SM holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the
    card."""
    fn = build.load("shared_sweep").shared_sweep_tile_blocks
    fn.restype = ctypes.c_int
    fn.argtypes = [_C_INT, _C_INT, _C_I64, _C_INT, _C_INT,
                   ctypes.POINTER(_C_INT)]
    blocks = ctypes.c_int(0)
    rc = fn(_DTYPE_CODES[dtype], order, rows, chunks, tile_m,
            ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"shared_sweep_tile_blocks: CUDA error {rc}")
    return blocks.value


def shared_sweep(spec: SweepSpec, lhs: torch.Tensor, rhs: torch.Tensor,
                 eps: torch.Tensor | None = None) -> torch.Tensor:
    """The sweep on the kernel for CUDA tensors, on the plain version (in
    the chunks and row blocks of the route the kernel would take) for CPU
    tensors; any other device raises."""
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

def batch_onchip_chunks(dtype) -> int:
    """Row chunks a block of the batch sweep's on-chip route takes at
    most: 32 at float compute (float32 and bf16 storage), 16 at float64,
    whose registers are twice as wide."""
    return 32 if _compute_itemsize(dtype) == 4 else 16


def batch_onchip_max_rows(dtype) -> int:
    """The largest N of the batch sweep's on-chip route: 512 at float32
    and bf16 storage, 256 at float64."""
    return batch_onchip_chunks(dtype) * BATCH_ROWS


@dataclasses.dataclass(frozen=True)
class BatchRoute:
    """How ``csrc/batch_sweep.cu`` solves one (N, dtype, bandwidth): the
    route, its row chunks a system and the rows of a chunk (``rows`` =
    ceil(N / chunks), the last chunk ragged; the whole column on the
    stream route)."""

    name: str
    chunks: int
    rows: int


def batch_route(n: int, dtype, bandwidth: int,
                which: str | None = None) -> BatchRoute:
    """The route of the batch sweep at (N, dtype, bandwidth): ``"onchip"``
    for tridiagonal systems up to ``batch_onchip_max_rows``, in the fewest
    chunks of at most ``BATCH_ROWS`` rows, else ``"stream"``: a
    shape rule, not a fallback.  ``which`` names a route to take instead;
    ``"onchip"`` past its rows or for a pentadiagonal system raises.  A
    pure function of its arguments."""
    n_max = batch_onchip_max_rows(dtype)
    if which is None:
        which = "onchip" if bandwidth == 3 and n <= n_max else "stream"
    if which == "onchip":
        if bandwidth != 3:
            raise ValueError("batch_sweep: the on-chip route solves "
                             "tridiagonal systems only; pentadiagonal ones "
                             "take the stream route")
        if n > n_max:
            raise ValueError(f"batch_sweep: N = {n} is past the on-chip "
                             f"route's {n_max} rows at {dtype}")
        chunks = max(1, -(-n // BATCH_ROWS))
        return BatchRoute("onchip", chunks, max(1, -(-n // chunks)))
    if which == "stream":
        return BatchRoute("stream", 1, n)
    raise ValueError(f"batch_sweep: route must be one of {BATCH_ROUTES}, "
                     f"got {which!r}")


def _pow2_scale(big: torch.Tensor) -> torch.Tensor:
    """The power of two that brings a product whose largest entry is
    ``big`` into [1/2, 1) where ``big`` leaves [1 / RESCALE_AT,
    RESCALE_AT], else 1 (zero and non-finite products stay)."""
    out = (big > RESCALE_AT) | ((big < 1 / RESCALE_AT) & (big > 0))
    e = torch.where(out, torch.frexp(big).exponent, 0).to(big.dtype)
    return torch.exp2(-e)


def _rescaled(p: list) -> list:
    """The 2×2 products ``p`` = [p00, p01, p10, p11], each column of
    systems whose largest entry leaves [1 / RESCALE_AT, RESCALE_AT] scaled
    by the power of two that brings it into [1/2, 1) (exact; zero and
    non-finite products stay)."""
    scale = _pow2_scale(torch.stack([q.abs() for q in p]).amax(0))
    return [q * scale for q in p]


def batch_chunk_spans(n: int, chunks: int) -> list:
    """The row spans ``[(s, e), …]`` of the batch sweep's on-chip chunks
    over N rows, in row order: chunk k holds rows ``[k·R, min((k + 1)·R,
    N))``, R = ceil(N / chunks), the last ragged (a chunk past N holds
    none, at N), as ``batch_onchip_kernel`` cuts them
    (``csrc/batch_sweep.cu``)."""
    rows = -(-n // chunks)
    return [(min(k * rows, n), min((k + 1) * rows, n))
            for k in range(chunks)]


def _slabs(x: torch.Tensor, spans: list, rows: int,
           fill: float) -> torch.Tensor:
    """``x`` (N, M) cut into one slab of ``rows`` rows a span ``(s, e)``:
    rows ``[s, e)``, then ``fill``."""
    pad = x.new_full((rows, x.shape[1]), fill)
    return torch.stack([torch.cat([x[s:e], pad[:rows - (e - s)]])
                        for s, e in spans])


def _unslab(out: torch.Tensor, spans: list, n: int) -> torch.Tensor:
    """``_slabs`` undone: slab k's first ``e - s`` rows back to rows
    ``[s, e)`` of an (N, M) result."""
    res = out.new_empty((n, out.shape[-1]))
    for k, (s, e) in enumerate(spans):
        res[s:e] = out[k, :e - s]
    return res


def _batch_chunked(diags, rhs: torch.Tensor, chunks: int) -> torch.Tensor:
    """The on-chip route's order, all chunks at once: each chunk's
    companion product (rescaled row by row), the fold to each chunk's true
    c^ start, the factor from it with d^ from a zero carry and its
    response, the fold of the d^ carries, d^ from them; back substitution
    from a zero carry with its response, the fold, and x from the true
    carries.  Every row in ``_factor_pass``'s arithmetic."""
    cdt = compute_dtype(rhs.dtype)
    n, m = rhs.shape
    spans = batch_chunk_spans(n, chunks)
    rows = max(e - s for s, e in spans)
    a, b, c, d = (_slabs(x.to(cdt), spans, rows, f) for x, f in
                  zip((*diags, rhs), (0.0, 1.0, 0.0, 0.0)))
    live = (torch.arange(rows, device=rhs.device) < torch.tensor(
        [e - s for s, e in spans], device=rhs.device)[:, None])[..., None]
    ones = torch.ones((chunks, m), dtype=cdt, device=rhs.device)
    zeros = torch.zeros_like(ones)

    def keep(t, new: list, old: list) -> list:
        return [torch.where(live[:, t], x, y) for x, y in zip(new, old)]

    p = [ones, zeros, zeros, ones]
    for t in range(rows):
        at, bt, ct = a[:, t], b[:, t], c[:, t]
        p = keep(t, _rescaled([ct * p[2], ct * p[3], bt * p[2] - at * p[0],
                               bt * p[3] - at * p[1]]), p)
    starts, chat = [zeros[0]], zeros[0]
    for k in range(chunks - 1):
        chat = (p[0][k] * chat + p[1][k]) / (p[2][k] * chat + p[3][k])
        starts.append(chat)

    chat, g, rho = torch.stack(starts), zeros, ones
    inv_all = torch.empty_like(a)
    chat_all = torch.empty_like(a)
    for t in range(rows):
        at = a[:, t]
        inv = 1 / (b[:, t] - at * chat)
        chat, g, rho = keep(t, [c[:, t] * inv, (d[:, t] - at * g) * inv,
                                -at * inv * rho], [chat, g, rho])
        inv_all[:, t], chat_all[:, t] = inv, chat
    dh, carries = zeros[0], []
    for k in range(chunks):
        carries.append(dh)
        dh = g[k] + rho[k] * dh

    dh = torch.stack(carries)
    dhat = torch.empty_like(a)
    for t in range(rows):
        (dh,) = keep(t, [(d[:, t] - a[:, t] * dh) * inv_all[:, t]], [dh])
        dhat[:, t] = dh
    y, sg = zeros, ones
    for t in range(rows - 1, -1, -1):
        y, sg = keep(t, [dhat[:, t] - chat_all[:, t] * y,
                         -chat_all[:, t] * sg], [y, sg])
    x, carries = zeros[0], [None] * chunks
    for k in range(chunks - 1, -1, -1):
        carries[k] = x
        x = y[k] + sg[k] * x

    x = torch.stack(carries)
    out = torch.empty_like(a)
    for t in range(rows - 1, -1, -1):
        (x,) = keep(t, [dhat[:, t] - chat_all[:, t] * x], [x])
        out[:, t] = x
    return _unslab(out, spans, n)


def _plucker_row(p: list, a, b, c, d, e) -> list:
    """Row (a, b, c, d, e) over (x_{i-2} … x_{i+2}) applied to the six
    Plücker coordinates p = [p01, p02, p03, p12, p13, p23] (the 2×2 minors
    of U rows i − 2 and i − 1 over x_{i-2} … x_{i+1}): those of U rows
    i − 1 and i, up to a common factor (α_i where p01 = 1).  Linear and
    free of divisions, so defined where e = 0."""
    p01, p02, p03, p12, p13, p23 = p
    return [p01 * c - p02 * b + p12 * a, p01 * d - p03 * b + p13 * a,
            p01 * e, p02 * d - p03 * c + p23 * a, p02 * e, p03 * e]


def _penta_chunked(diags, rhs: torch.Tensor, chunks: int) -> torch.Tensor:
    """The pentadiagonal six-minor split's order, all chunks at once: a
    chunked plain version of the penta batch sweep that no kernel runs yet
    (every penta batch system streams; a split tile of 16 systems a block
    lost to the stream kernel, PERF.md §6).

    1. Each chunk's 6×6 product of its rows' ``_plucker_row`` maps,
       rescaled row by row by a power of two (chunk 0 keeps only its
       product applied to the start state p01 = 1, rescaled on that
       column alone); a fold from that column through the later chunks'
       products (the folded vector rescaled alike) gives each chunk's
       start state, taken in echelon form u = −p12/p01, v = −p13/p01,
       γ_{s−1} = p02/p01, δ_{s−1} = p03/p01.
    2. The factor re-run from it: a chunk's first row s in that form
       (α_s = c − a u − b γ_{s−1}, γ_s = (d − a v − b δ_{s−1}) / α_s),
       later rows in ``_factor_pass``'s arithmetic, with g from a zero
       carry and its responses to the unit carries (g′_{s−2}, g_{s−1}),
       g′_{s−2} = g_{s−2} − γ_{s−2} g_{s−1}; one linear fold over the
       chunks and a walk from the true carry give g.
    3. Back substitution alike, from a zero carry (x_e, x_{e+1}) with its
       responses, one fold and a walk from the true carry.
    A chunk with no rows passes every carry on unchanged."""
    cdt = compute_dtype(rhs.dtype)
    n, m = rhs.shape
    rows = -(-n // chunks)
    pad = chunks * rows - n
    dev = rhs.device

    def tiled(x: torch.Tensor, fill: float) -> torch.Tensor:
        x = torch.cat([x.to(cdt), torch.full((pad, m), fill, dtype=cdt,
                                             device=dev)])
        return x.reshape(chunks, rows, m)

    a, b, c, d, e, r = (tiled(x, f) for x, f in
                        zip((*diags, rhs), (0.0, 0.0, 1.0, 0.0, 0.0, 0.0)))
    live = (torch.arange(chunks * rows, device=dev) < n).reshape(
        chunks, rows, 1)
    ones = torch.ones((chunks, m), dtype=cdt, device=dev)
    zeros = torch.zeros_like(ones)

    def keep(t, new: list, old: list) -> list:
        return [torch.where(live[:, t], x, y) for x, y in zip(new, old)]

    # 1. products: entry [k][j] is Plücker row k of column j, (6, P, M)
    eye = torch.eye(6, dtype=cdt, device=dev)
    prod = [eye[k][:, None, None].expand(6, chunks, m) for k in range(6)]
    counted = torch.ones((6, chunks, 1), dtype=torch.bool, device=dev)
    counted[1:, 0] = False          # chunk 0: the start column alone
    for t in range(rows):
        q = _plucker_row(prod, a[:, t], b[:, t], c[:, t], d[:, t], e[:, t])
        big = torch.zeros_like(a[:, t])
        for x in q:
            big = torch.maximum(big, torch.where(counted, x.abs(), 0).amax(0))
        scale = _pow2_scale(big)
        prod = [torch.where(live[:, t], x * scale, y)
                for x, y in zip(q, prod)]
    p = [x[0, 0] for x in prod]
    starts = [[zeros[0]] * 4]
    for k in range(1, chunks):
        inv = 1 / p[0]
        starts.append([-p[3] * inv, -p[4] * inv, p[1] * inv, p[2] * inv])
        if k < chunks - 1:
            q = []
            for i in range(6):
                acc = prod[i][0, k] * p[0]
                for j in range(1, 6):
                    acc = acc + prod[i][j, k] * p[j]
                q.append(acc)
            scale = _pow2_scale(torch.stack([x.abs() for x in q]).amax(0))
            p = [x * scale for x in q]
    u, v, gam1, dl1 = (torch.stack(x) for x in zip(*starts))

    # 2. the factor from each chunk's start; g from a zero carry and its
    # responses to the unit carries g'_{s-2} (A) and g_{s-1} (B)
    gam2 = dl2 = zeros
    y2, y1, ya2, ya1, yb2, yb1 = zeros, zeros, ones, zeros, zeros, ones
    beta_all, inv_all, gam_all, dl_all = (torch.empty_like(a)
                                          for _ in range(4))
    for t in range(rows):
        at, bt, ct, dt, et, rt = (x[:, t] for x in (a, b, c, d, e, r))
        if t == 0:
            beta = bt
            inv = 1 / (ct - at * u - bt * gam1)
            gam = (dt - at * v - bt * dl1) * inv
        else:
            beta = bt - at * gam2
            inv = 1 / (ct - at * dl2 - beta * gam1)
            gam = (dt - beta * dl1) * inv
        dl = et * inv
        y = (rt - at * y2 - beta * y1) * inv
        ya = (-at * ya2 - beta * ya1) * inv
        yb = (-at * yb2 - beta * yb1) * inv
        gam2, gam1, dl2, dl1, y2, y1, ya2, ya1, yb2, yb1 = keep(
            t, [gam1, gam, dl1, dl, y1, y, ya1, ya, yb1, yb],
            [gam2, gam1, dl2, dl1, y2, y1, ya2, ya1, yb2, yb1])
        beta_all[:, t], inv_all[:, t] = beta, inv
        gam_all[:, t], dl_all[:, t] = gam, dl
    summ = [y2 - gam2 * y1, y1, ya2 - gam2 * ya1, ya1, yb2 - gam2 * yb1,
            yb1]
    carry, carries = [zeros[0], zeros[0]], []
    for k in range(chunks):
        carries.append(carry)
        z0, z1, ra0, ra1, rb0, rb1 = (x[k] for x in summ)
        carry = [z0 + ra0 * carry[0] + rb0 * carry[1],
                 z1 + ra1 * carry[0] + rb1 * carry[1]]
    g2, g1 = (torch.stack(x) for x in zip(*carries))
    g_all = torch.empty_like(a)
    for t in range(rows):
        g = (r[:, t] - a[:, t] * g2 - beta_all[:, t] * g1) * inv_all[:, t]
        g2, g1 = keep(t, [g1, g], [g2, g1])
        g_all[:, t] = g

    # 3. back substitution: from a zero carry (x_e, x_{e+1}) with its
    # responses, the fold, and from the true carry into x
    x1, x2, xa1, xa2, xb1, xb2 = zeros, zeros, ones, zeros, zeros, ones
    for t in range(rows - 1, -1, -1):
        gt, dt = gam_all[:, t], dl_all[:, t]
        x1, x2, xa1, xa2, xb1, xb2 = keep(
            t, [g_all[:, t] - gt * x1 - dt * x2, x1,
                -gt * xa1 - dt * xa2, xa1, -gt * xb1 - dt * xb2, xb1],
            [x1, x2, xa1, xa2, xb1, xb2])
    summ = [x1, x2, xa1, xa2, xb1, xb2]
    carry, carries = [zeros[0], zeros[0]], [None] * chunks
    for k in range(chunks - 1, -1, -1):
        carries[k] = carry
        z0, z1, ra0, ra1, rb0, rb1 = (x[k] for x in summ)
        carry = [z0 + ra0 * carry[0] + rb0 * carry[1],
                 z1 + ra1 * carry[0] + rb1 * carry[1]]
    x1, x2 = (torch.stack(x) for x in zip(*carries))
    out = torch.empty_like(a)
    for t in range(rows - 1, -1, -1):
        x = g_all[:, t] - gam_all[:, t] * x1 - dl_all[:, t] * x2
        x1, x2 = keep(t, [x, x1], [x1, x2])
        out[:, t] = x
    return out.reshape(chunks * rows, m)[:n]


def batch_sweep_plain(spec: SweepSpec, diags, rhs: torch.Tensor, *,
                      chunks: int | None = None) -> torch.Tensor:
    """The batch kernel's function in plain torch, in the order of the
    route's ``chunks`` row chunks (default: ``batch_route``'s).  One chunk
    is the stream route's sequential sweep, one row at a time: the
    factorisation fused into the forward substitution in ``_factor_pass``'s
    arithmetic order (``repro.kernels.engine``), the per-system
    coefficients kept in a workspace, then the descending ``_BATCH_BWD``
    pass.  More chunks run a chunked order: the tridiagonal on-chip
    route's (``_batch_chunked``) or, pentadiagonal, the six-minor split's
    (``_penta_chunked``), which no kernel runs yet.  ``diags`` are the
    ``bandwidth`` (N, M) diagonals, sub-most first.  bf16 operands compute
    (and return) fp32, as the kernel does."""
    cdt = compute_dtype(rhs.dtype)
    n, m = rhs.shape
    if chunks is None:
        chunks = batch_route(n, rhs.dtype, spec.bandwidth).chunks
    if chunks != 1:
        if not 1 <= chunks <= max(n, 1):
            raise ValueError(f"batch_sweep: {chunks} row chunks do not "
                             f"split {spec.name} over N = {n} (at most N "
                             "chunks)")
        return (_batch_chunked if spec.order == 1 else _penta_chunked)(
            diags, rhs, chunks)
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


def batch_sweep_cuda(spec: SweepSpec, diags, rhs: torch.Tensor, *,
                     route: str | None = None, chunks: int | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/batch_sweep.cu`` on the current stream, on the route
    ``batch_route(N, dtype, bandwidth)`` picks, in its chunks; the stream
    route's (order, N, M) coefficient workspace is allocated here, the
    on-chip route needs none.  ``route`` forces the other route, to time
    one against the other, and ``chunks`` the on-chip route's row chunks
    (1..``batch_onchip_chunks``, at most ``BATCH_ROWS`` rows each); a route
    that cannot take the system raises, and nothing falls back.  Validates
    device, dtype, shape and contiguity and raises on what the kernel does
    not take; raises when the launch reports a CUDA error.  Counts one
    launch a solve under the spec's name."""
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
    picked = batch_route(n, rhs.dtype, spec.bandwidth, route)
    if chunks is not None:
        most = batch_onchip_chunks(rhs.dtype)
        if picked.name != "onchip" or not (
                1 <= chunks <= most and -(-n // chunks) <= BATCH_ROWS):
            raise ValueError(f"batch_sweep: chunks={chunks} needs the "
                             f"on-chip route, 1..{most} chunks of at most "
                             f"{BATCH_ROWS} rows")
        picked = dataclasses.replace(picked, chunks=chunks,
                                     rows=-(-n // chunks))
    cdt = compute_dtype(rhs.dtype)
    out = output_buffer("batch_sweep", out, (n, m), cdt, rhs.device)
    if n == 0 or m == 0:
        return out
    # ``work`` is freed on return while the kernel may still run: the
    # caching allocator reuses the block only for work queued after the
    # kernel on the same stream.
    work = None if picked.name == "onchip" else torch.empty(
        (spec.n_coefs, n, m), dtype=cdt, device=rhs.device)
    fn = _kernel("batch_sweep")
    ptrs = (ctypes.c_void_p * spec.bandwidth)(*(t.data_ptr() for t in diags))
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODES[rhs.dtype], spec.bandwidth,
                _BATCH_ROUTE_CODES[picked.name], picked.chunks, ptrs,
                rhs.data_ptr(), out.data_ptr(),
                None if work is None else work.data_ptr(), n, m,
                DEFAULT_THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"batch_sweep ({picked.name} route) launch "
                           f"failed: CUDA error {rc}")
    count_launch(spec.name, spec.traffic_bytes(n, m, rhs.dtype))
    return out


def batch_onchip_blocks_per_sm(dtype, chunks: int) -> int:
    """Blocks of the batch sweep's on-chip kernel in ``chunks`` chunks
    that one SM holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    needs the card."""
    fn = build.load("batch_sweep").batch_sweep_onchip_blocks
    fn.restype = ctypes.c_int
    fn.argtypes = [_C_INT, _C_INT, ctypes.POINTER(_C_INT)]
    blocks = ctypes.c_int(0)
    rc = fn(_DTYPE_CODES[dtype], chunks, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"batch_sweep_onchip_blocks: CUDA error {rc}")
    return blocks.value


def batch_sweep(spec: SweepSpec, diags, rhs: torch.Tensor) -> torch.Tensor:
    """The batch solve on the kernel for CUDA tensors, on the plain version
    (in the chunks of the route the kernel would take) for CPU tensors;
    any other device raises."""
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


@dataclasses.dataclass(frozen=True)
class RecurrenceRoute:
    """How ``csrc/recurrence_sweep.cu`` walks one (N, M, dtype, order): the
    route, its row chunks a window and the rows of a chunk (the tile: a
    block of TILE_M columns walks N in windows of ``chunks · rows`` rows;
    the walk: one chunk of all N rows), and the threads of a block."""

    name: str
    chunks: int
    rows: int
    threads: int


def recurrence_route(n: int, m: int, dtype, order: int,
                     which: str | None = None) -> RecurrenceRoute:
    """The route of the recurrence kernel at (N, M, dtype, order):
    ``"tile"`` from ``RECURRENCE_TILE_MIN_ROWS`` rows and up to
    ``RECURRENCE_TILE_MAX_COLUMNS[order]`` columns, in chunks of
    ``RECURRENCE_ROWS`` rows, ``RECURRENCE_TILE_CHUNKS[order]`` chunks a
    block or as many as N fills; else ``"walk"``, one thread a column in
    blocks of ``DEFAULT_THREADS``.  A shape rule, not a
    fallback.  ``which`` names a route to take instead; an unknown one, a
    dtype the kernel does not take or an order other than 1 and 2 raises.
    A pure function of its arguments."""
    if dtype not in RECURRENCE_DTYPES:
        raise TypeError(f"recurrence: unsupported dtype {dtype}")
    if order not in (1, 2):
        raise ValueError(f"recurrence: order must be 1 or 2, got {order}")
    if which is None:
        which = ("tile" if n >= RECURRENCE_TILE_MIN_ROWS
                 and m <= RECURRENCE_TILE_MAX_COLUMNS[order] else "walk")
    if which == "walk":
        return RecurrenceRoute("walk", 1, max(n, 1), DEFAULT_THREADS)
    if which == "tile":
        rows = RECURRENCE_ROWS
        chunks = max(1, min(RECURRENCE_TILE_CHUNKS[order], -(-n // rows)))
        return RecurrenceRoute("tile", chunks, rows, TILE_M * chunks)
    raise ValueError(f"recurrence: route must be one of {RECURRENCE_ROUTES}, "
                     f"got {which!r}")


def recurrence_windows(n: int, chunks: int, rows: int) -> list:
    """The tile route's windows over N rows, in walk order: window v's
    chunk w walks the positions ``[v·S + w·rows, …)`` (S = chunks·rows)
    up to N, ceil(N / S) windows, the last ragged (a chunk past N walks
    none, at N), as ``recurrence_tile_kernel`` cuts them
    (``csrc/recurrence_sweep.cu``).  Position s is row s ascending, row
    N − 1 − s descending.  A list of windows, each a list of ``(s, e)``
    a chunk."""
    span = chunks * rows
    return [[(min(v * span + w * rows, n), min(v * span + (w + 1) * rows, n))
             for w in range(chunks)]
            for v in range(-(-n // span))]


def _recurrence_chunked(spec: RecurrenceSpec, gates, q: torch.Tensor,
                        chunks: int, rows: int) -> torch.Tensor:
    """The tile route's order, all columns at once: N cut, in walk order,
    into windows of ``chunks`` chunks of ``rows`` rows; every chunk walked
    from a zero carry with its responses to a unit carry (all windows at
    once: they need no carry); then window by window, the linear fold of
    the chunk summaries from the previous window's last ``order`` values to
    each chunk's carry, and the walk from it that writes h.  Every row in
    the kernel's term order; rows past N (the last window's padding) feed
    only chunks that write nothing."""
    cdt = compute_dtype(q.dtype)
    n, m = q.shape
    order = spec.order
    spans = [c for w in recurrence_windows(n, chunks, rows) for c in w]
    windows = len(spans) // chunks
    dev = q.device

    def walked(x: torch.Tensor) -> torch.Tensor:
        x = x.flip(0) if spec.reverse else x
        return _slabs(x.to(cdt), spans, rows, 0.0).reshape(
            windows, chunks, rows, m)

    g = [walked(t) for t in gates]
    u = walked(q)
    zeros = torch.zeros((windows, chunks, m), dtype=cdt, device=dev)
    ones = torch.ones_like(zeros)
    # walks from zero: the end state z and its responses to a unit h_{-1}
    # (a) and to a unit h_{-2} (b)
    z, a, b = [zeros, zeros], [ones, zeros], [zeros, ones]
    for t in range(rows):
        if order == 1:
            z = [u[:, :, t] + g[0][:, :, t] * z[0]]
            a = [g[0][:, :, t] * a[0]]
        else:
            g0, g1 = g[0][:, :, t], g[1][:, :, t]
            z = [u[:, :, t] + g0 * z[0] + g1 * z[1], z[0]]
            a = [g0 * a[0] + g1 * a[1], a[0]]
            b = [g0 * b[0] + g1 * b[1], b[0]]
    out = torch.empty((windows, chunks, rows, m), dtype=q.dtype, device=dev)
    carry = (zeros[0, 0],) * 2
    for v in range(windows):
        starts, (h1, h2) = [], carry
        for k in range(chunks):
            starts.append((h1, h2))
            if order == 1:
                h1 = z[0][v, k] + a[0][v, k] * h1
            else:
                h1, h2 = (z[0][v, k] + a[0][v, k] * h1 + b[0][v, k] * h2,
                          z[1][v, k] + a[1][v, k] * h1 + b[1][v, k] * h2)
        h1 = torch.stack([s[0] for s in starts])
        h2 = torch.stack([s[1] for s in starts])
        for t in range(rows):
            acc = u[v, :, t] + g[0][v, :, t] * h1
            if order == 2:
                acc = acc + g[1][v, :, t] * h2
            out[v, :, t] = acc
            h1, h2 = acc, h1
        carry = (h1[-1], h2[-1])
    out = _unslab(out.reshape(windows * chunks, rows, m), spans, n)
    return out.flip(0) if spec.reverse else out


def recurrence_plain(spec: RecurrenceSpec, gates, q: torch.Tensor,
                     chunks: int | None = None,
                     rows: int | None = None) -> torch.Tensor:
    """The recurrence kernel's function in plain torch, from zero carries:
    ``acc = q_i + g0_i h1 (+ g1_i h2)`` in the kernel's term order.  bf16
    and fp16 operands carry fp32 and store h at their own type, as the
    kernel does.  With no ``chunks`` it is the walk route's order, one row
    at a time; with ``chunks`` and ``rows`` the tile route's
    (``_recurrence_chunked``)."""
    if (chunks is None) != (rows is None):
        raise ValueError("recurrence_plain: give both chunks and rows, or "
                         "neither")
    if chunks is not None:
        if chunks < 1 or rows < 1:
            raise ValueError(f"recurrence_plain: {chunks} chunks of {rows} "
                             "rows")
        return _recurrence_chunked(spec, gates, q, chunks, rows)
    cdt = compute_dtype(q.dtype)
    n, m = q.shape
    out = torch.empty((n, m), dtype=q.dtype, device=q.device)
    carries = (torch.zeros((m,), dtype=cdt, device=q.device),) * spec.order
    (pspec,) = spec.passes()
    rows_at = range(n - 1, -1, -1) if spec.reverse else range(n)
    for i in rows_at:
        acc = q[i].to(cdt)
        for src, lag in pspec.terms:
            acc = acc + gates[src][i].to(cdt) * carries[lag - 1]
        out[i] = acc
        carries = (acc,) + carries[:spec.order - 1]
    return out


def route_plain(spec: RecurrenceSpec, gates, q: torch.Tensor,
                picked: RecurrenceRoute) -> torch.Tensor:
    """The plain version in the order of the route ``picked``."""
    if picked.name == "tile":
        return recurrence_plain(spec, gates, q, picked.chunks, picked.rows)
    return recurrence_plain(spec, gates, q)


def recurrence_cuda(spec: RecurrenceSpec, gates, q: torch.Tensor, *,
                    route: str | None = None, chunks: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/recurrence_sweep.cu`` on the current stream, on the
    route ``recurrence_route`` picks or on ``route`` forced; ``chunks``
    overrides the tile's chunks a block, to time it.  Validates device, dtype, shape and contiguity and raises on what
    the kernel does not take; raises when the launch reports a CUDA error.
    Counts one launch under the spec's name."""
    n, m = q.shape
    operands = [*gates, q]
    if len(gates) != spec.order:
        raise ValueError(f"recurrence: {spec.name} takes {spec.order} "
                         f"gate(s), got {len(gates)}")
    if any(not t.is_cuda or t.device != q.device for t in operands):
        raise ValueError("recurrence: every operand must lie on one CUDA "
                         "device")
    same_dtype("recurrence", gates, q)
    if any(t.shape != (n, m) for t in gates):
        raise ValueError(f"recurrence: every gate must be ({n}, {m})")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("recurrence: operands must be contiguous")
    picked = recurrence_tuned(n, m, q.dtype, spec.order, route, chunks)
    out = output_buffer("recurrence", out, (n, m), q.dtype, q.device)
    if n == 0 or m == 0:
        return out
    fn = _kernel("recurrence_sweep")
    ptrs = (ctypes.c_void_p * spec.order)(*(t.data_ptr() for t in gates))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        # spec.reverse is a field of the frozen spec, a Python bool
        rc = fn(RECURRENCE_DTYPES[q.dtype], spec.order, int(spec.reverse),  # speclint: allow-concretize
                _RECURRENCE_ROUTE_CODES[picked.name], picked.chunks,
                picked.rows, ptrs, q.data_ptr(), out.data_ptr(), n, m,
                picked.threads, stream)
    if rc != 0:
        raise RuntimeError(f"recurrence ({picked.name} route) launch "
                           f"failed: CUDA error {rc}")
    count_launch(spec.name, spec.traffic_bytes(n, m, q.dtype))
    return out


def recurrence_tuned(n: int, m: int, dtype, order: int,
                     route: str | None = None, chunks: int | None = None
                     ) -> RecurrenceRoute:
    """``recurrence_route(n, m, dtype, order, route)`` with the tile's
    chunks replaced; raises where the kernel has no such geometry."""
    picked = recurrence_route(n, m, dtype, order, route)
    if chunks is not None:
        if picked.name != "tile" or not 1 <= chunks <= RECURRENCE_MAX_CHUNKS:
            raise ValueError(f"recurrence: chunks={chunks} needs the tile "
                             f"route and 1..{RECURRENCE_MAX_CHUNKS} chunks")
        picked = dataclasses.replace(picked, chunks=chunks,
                                     threads=TILE_M * chunks)
    return picked


def recurrence_tile_blocks_per_sm(dtype, order: int, chunks: int) -> int:
    """Blocks of the recurrence kernel's tile route in ``chunks`` chunks
    that one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the card."""
    fn = build.load("recurrence_sweep").recurrence_tile_blocks
    fn.restype = ctypes.c_int
    fn.argtypes = [_C_INT, _C_INT, _C_INT, ctypes.POINTER(_C_INT)]
    blocks = ctypes.c_int(0)
    rc = fn(RECURRENCE_DTYPES[dtype], order, chunks, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"recurrence_tile_blocks: CUDA error {rc}")
    return blocks.value


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
    edge of M itself, and ``batch_route`` picks how it walks the N rows
    (on chip in row chunks up to ``batch_onchip_max_rows``, else
    streamed)."""
    *diags, d = _as_stored((a, b, c, d), storage_dtype)
    return batch_sweep(find_spec(3, "batch"), diags, d)


def penta_batch(a, b, c, d, e, rhs, *, storage_dtype=None) -> torch.Tensor:
    """Per-system-LHS batched penta solve (cuPentBatch).  a..e and rhs:
    (N, M), ``c`` the main diagonal; no padding, as for ``thomas_batch``;
    always on the stream route."""
    *diags, rhs = _as_stored((a, b, c, d, e, rhs), storage_dtype)
    return batch_sweep(find_spec(5, "batch"), diags, rhs)
