"""Fused periodic Crank–Nicolson steps: stencil RHS, banded solve and
periodic correction in ONE kernel (``csrc/fused_cn.cu``).

Counterpart of ``repro.kernels.fused_cn`` / ``fused_cn_penta`` and their
``ops.fused_cn_step`` / ``fused_cn_penta_step``.  The paper's pipeline is
a stencil kernel (writes the RHS), the constant-LHS solve (reads it,
writes y) and the corner correction (reads y, writes x); the fused step
reads the field and writes the next one from one kernel.

  * ``fused_cn_step(pf, sigma, c)`` — one CN diffusion step on the
    periodic tridiagonal factor ``pf`` (its core A' and the
    Sherman–Morrison terms);
  * ``fused_cn_penta_step(pf, sigma, c)`` — one CN hyperdiffusion step on
    the periodic penta factor (the rank-4 Woodbury terms);
  * ``fused_cn_tridiag`` / ``fused_cn_penta`` dispatch on where the field
    lies: a CUDA tensor goes to the kernel or raises, a CPU tensor to
    ``fused_cn_tridiag_plain`` / ``fused_cn_penta_plain`` — the kernel's
    arithmetic in the kernel's order (stencil, forward sweep, backward
    sweep, correction), not a call of the periodic solve.

The kernel has three routes, picked from (N, dtype) by ``route``.  The
on-chip route holds a tile of ``TILE_M`` columns over all N rows in shared
memory through the three passes, so device memory sees the field read once
and the next one written once, up to ``onchip_max_rows(dtype)`` rows (1614
at float32, 807 at float64).  It splits each column's rows into
``chunk_count(N, dtype)`` chunks swept at once from zero carries, then
adds each chunk's response to a unit carry (``carry_responses``, from the
factor alone) times the carry chained over the chunk ends.  Past
``onchip_max_rows`` the partitioned route cuts each column into
``row_blocks`` row blocks (512 rows at float32, 256 at float64, as the
shared sweep's partitioned route cuts them) in four launches: K0 the
blocks' coefficients from the factor alone, K1 each block's summaries of
the stencil RHS formed from the field, K2 the chain over the blocks, which
also yields the corner correction's inputs (y_0, y_1, y_{N−2}, y_{N−1}),
and K3 each block's tile swept from its true entry carries with the
correction subtracted: about 3NM words against the 6NM of the global
route, the first design, one thread walking each whole column three times
through device memory, which only a forced ``route="global"`` reaches.  The
plain versions take the row blocks and chunks of any route (``blocks=``,
``chunks=``; the global route's are one of each, the plain sequential
sweep) and repeat its order.  ``LAUNCHES`` counts ``fused_cn_tridiag`` /
``fused_cn_penta`` (on chip), ``fused_cn_*_partition`` and
``fused_cn_*_global``, one a step.  Only the ``*_cuda`` wrappers take a
forced ``route=`` (and the tile routes' ``chunks=``), to time one choice
against another; a route that cannot take N raises, and nothing falls
back.  ``partition_stages`` times K0–K3 alone.

The JAX package defines no VJP for these steps, so neither does the
port: a call on an input that requires grad raises.  Storage is float32
(the JAX steps' type) or float64.
"""

from __future__ import annotations

import ctypes

import torch

from ..spans import span
from . import build
from . import ops as _ops
from .engine import find_spec
# The on-chip tile's geometry and chunk rules, shared with the shared
# sweep's tile kernels (``ops``).
from .ops import (MAX_CHUNKS, RESP_ROWS, TILE_M, chunk_bounds,
                  chunk_count, onchip_max_rows)

_FUSED_DTYPES = {torch.float32: 0, torch.float64: 1}
ROUTES = ("onchip", "partition", "global")
_ROUTE_CODES = {"global": 0, "onchip": 1, "partition": 2}


def _refuse_grad(name: str, tensors) -> None:
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the fused CN step has no backward (nor "
                           "has the JAX package's); call it on tensors that "
                           "do not require grad, or under torch.no_grad()")


def tridiag_params(pf, sigma: float, dtype) -> torch.Tensor:
    """(8,) ``[sl, sc, sr, v_last, inv_sm, 0, 0, 0]``: the explicit CN
    stencil (σ, 1−2σ, σ) and the Sherman–Morrison scalars, on the factor's
    device.  One host sync a call on a CUDA device: the stencil's
    ``torch.tensor([...], device=...)`` is a pageable copy, which waits for
    the stream (``host_sync`` counts 1 in the span ``fused_cn.params``)."""
    dev = pf.z.device
    with span("fused_cn.params"):
        stencil = torch.tensor([sigma, 1 - 2 * sigma, sigma], dtype=dtype,
                               device=dev)
        sm = torch.stack([torch.as_tensor(pf.v_last), torch.as_tensor(
            pf.inv_denom_sm)]).to(dtype=dtype, device=dev)
        return torch.cat([stencil, sm,
                          torch.zeros(3, dtype=dtype, device=dev)])


def penta_params(pf, sigma: float, dtype) -> torch.Tensor:
    """(16,) ``[w0..w4, a0, b0, a1, eN2, dN1, eN1, 0 …]``: the CN stencil
    (−σ, 4σ, 1−6σ, 4σ, −σ) and the six wrap coefficients.  One host sync a
    call on a CUDA device, as in ``tridiag_params`` (``host_sync`` counts 1
    in the span ``fused_cn.params``)."""
    dev = pf.Z.device
    with span("fused_cn.params"):
        stencil = torch.tensor([-sigma, 4 * sigma, 1 - 6 * sigma, 4 * sigma,
                                -sigma], dtype=dtype, device=dev)
        return torch.cat([stencil, pf.vcoef.to(dtype),
                          torch.zeros(5, dtype=dtype, device=dev)])


# ---------------------------------------------------------------------------
# Routes and chunks
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    return dtype.itemsize


def route(n: int, dtype) -> tuple:
    """``(name, shared-memory bytes of a tile)``: ``"onchip"`` when a tile
    over all ``n`` rows fits one block's shared memory, else
    ``"partition"``, whose tiles hold the largest row block."""
    if n <= onchip_max_rows(dtype):
        return "onchip", n * (TILE_M + RESP_ROWS) * _itemsize(dtype)
    rows = -(-n // row_blocks(n, dtype, "partition"))
    return "partition", rows * (TILE_M + RESP_ROWS) * _itemsize(dtype)


def row_blocks(n: int, dtype, which: str | None = None) -> int:
    """Row blocks of route ``which`` (default: the one ``route`` picks):
    the shared sweep's partitioned row blocks (``ops.shared_route``) on the
    partitioned route, one on the others."""
    if which is None:
        which = "onchip" if n <= onchip_max_rows(dtype) else "partition"
    if which == "partition":
        return _ops.shared_route(n, dtype, "partition").row_blocks
    return 1


def sweep_chunks(n: int, dtype, which: str | None = None) -> int:
    """The chunks the kernel sweeps each tile in on route ``which``
    (default: the one ``route`` picks): ``chunk_count`` of a row block's
    rows on the tile routes, 1 on the global route."""
    if which == "global":
        return 1
    return chunk_count(n // row_blocks(n, dtype, which), dtype)


def _spec(kind: str):
    """The shared sweep whose passes the step's solve runs on A'."""
    return find_spec(3 if kind == "tridiag" else 5, "constant")


def carry_responses(kind: str, lhs: torch.Tensor, chunks: int
                    ) -> torch.Tensor:
    """Each chunk's sweep of a unit carry, from the factor rows ``lhs``
    alone, as the kernel computes them: the rows and passes of the shared
    ``thomas_constant`` / ``penta_constant`` sweep (``ops.carry_responses``).
    Tridiag (2, N): the forward response to d^_{s-1} = 1 and the backward
    one to y_e = 1; penta (4, N): the forward responses to g_{s-1} = 1 and
    to g_{s-2} = 1, the backward ones to y_e = 1 and to y_{e+1} = 1."""
    return _ops.carry_responses(_spec(kind), lhs, chunks=chunks)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic, one row at a time
# ---------------------------------------------------------------------------

def _responses(kind: str, lhs: torch.Tensor, chunks: int) -> torch.Tensor:
    """``carry_responses``, or zeros for one chunk: its carries are zero,
    so the fix-ups add nothing either way (a response of a long column
    may overflow, and inf · 0 is no zero)."""
    if chunks == 1:
        return torch.zeros((2 if kind == "tridiag" else 4, lhs.shape[1]),
                           dtype=lhs.dtype, device=lhs.device)
    return carry_responses(kind, lhs, chunks)


def _split(name: str, n: int, dtype, bandwidth: int, blocks, chunks
           ) -> tuple:
    """(blocks, chunks), by default the route's (``row_blocks``,
    ``sweep_chunks``), once every chunk of every row block has the rows
    its carries need (two for penta)."""
    blocks = row_blocks(n, dtype) if blocks is None else blocks
    chunks = chunk_count(n // blocks, dtype) if chunks is None else chunks
    if blocks < 1 or chunks < 1 or n // blocks < chunks * (bandwidth // 2):
        raise ValueError(f"{name}: {blocks} row blocks of {chunks} chunks "
                         f"do not split N = {n} ({bandwidth // 2} rows a "
                         "chunk at least)")
    return blocks, chunks


def stencil_rhs(weights: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The explicit CN stencil of c (N, M) with periodic wrap: weights
    (2r + 1,) on the rows from offset −r up, summed in that order, as the
    kernels form the RHS."""
    half = (weights.shape[0] - 1) // 2
    r = weights[0] * torch.roll(c, half, 0)
    for t in range(1, weights.shape[0]):
        r = r + weights[t] * torch.roll(c, half - t, 0)
    return r


def partition_chain(kind: str, lhs: torch.Tensor, rhs: torch.Tensor,
                    blocks: int) -> tuple:
    """K0–K2 of the partitioned route on the stencil RHS ``rhs``
    (``ops.chain_blocks``).  Returns ``(fin, yin, ends)``: the blocks'
    entry carries and ``ends``, the rows of y that the corner correction
    reads, by row: y_0 and y_{N−1} (tridiag), also y_1 and y_{N−2}
    (penta), with y_{N−1} = f_{N−1} and y_{N−2} = f_{N−2} − γ_{N−2}
    y_{N−1}, the backward pass's first two rows."""
    n = rhs.shape[0]
    fin, yin, fend, ystart = _ops.chain_blocks(_spec(kind), lhs, None, rhs,
                                               blocks)
    ends = {0: ystart[0], n - 1: fend[0]}
    if kind == "penta":
        ends[1] = ystart[1]
        ends[n - 2] = fend[1] - lhs[3, n - 2] * fend[0]
    return fin, yin, ends


def _partition_sweep(kind: str, lhs, params, c, blocks: int, chunks: int
                     ) -> tuple:
    """The partitioned route's K0–K3 without the correction: (y, ends)."""
    weights = params[:3] if kind == "tridiag" else params[:5]
    rhs = stencil_rhs(weights, c)
    fin, yin, ends = partition_chain(kind, lhs, rhs, blocks)
    y = _ops._tile_sweeps(_spec(kind), lhs, None, rhs, blocks, chunks, fin,
                          yin)
    return y, ends


def _woodbury(minv, params, y0, y_1, yN2, yN1) -> list:
    """Minv V^T y from y's corner rows, in the kernels' order."""
    a0, b0, a1, eN2, dN1, eN1 = params[5:11]
    vty = (a0 * yN2 + b0 * yN1, a1 * yN1, eN2 * y0, dN1 * y0 + eN1 * y_1)
    wv = []
    for r_i in range(4):
        acc = minv[r_i, 0] * vty[0]
        for c_i in range(1, 4):
            acc = acc + minv[r_i, c_i] * vty[c_i]
        wv.append(acc)
    return wv


def fused_cn_tridiag_plain(lhs, z, params, c, chunks: int | None = None,
                           blocks: int | None = None) -> torch.Tensor:
    """lhs (3, N) ``[a, inv_denom, c_hat]`` of A', z (N,), params (8,),
    c (N, M) -> the next field (N, M), in ``blocks`` row blocks of
    ``chunks`` row chunks (default: the route's, ``row_blocks`` and
    ``sweep_chunks``).  One block is the on-chip route's order (one chunk:
    the sequential sweep, the global route's); more are the partitioned
    route's."""
    n, m = c.shape
    blocks, chunks = _split("fused_cn_tridiag", n, c.dtype, 3, blocks,
                            chunks)
    sl, sc, sr, v_last, inv_sm = params[:5]
    if blocks > 1:
        y, ends = _partition_sweep("tridiag", lhs, params, c, blocks, chunks)
        corr = (ends[0] + v_last * ends[n - 1]) * inv_sm
        return y - corr[None, :] * z[:, None]
    bounds = chunk_bounds(n, chunks)
    spans = list(zip(bounds[:-1], bounds[1:]))
    a, inv, chat = lhs
    resp_f, resp_b = _responses("tridiag", lhs, chunks)
    zero = torch.zeros((m,), dtype=c.dtype, device=c.device)
    x = torch.empty_like(c)
    for s, e in spans:                          # forward, zero carry
        dh = zero
        for i in range(s, e):
            r = sl * c[(i - 1) % n] + sc * c[i] + sr * c[(i + 1) % n]
            dh = (r - a[i] * dh) * inv[i]
            x[i] = dh
    carry_in, carry = [], zero                  # d^_{s-1} of each chunk
    for s, e in spans:
        carry_in.append(carry)
        carry = x[e - 1] + resp_f[e - 1] * carry
    y_last = carry
    for (s, e), cin in zip(spans, carry_in):    # backward, zero carry
        y = zero
        for i in range(e - 1, s - 1, -1):
            d = x[i] + resp_f[i] * cin
            y = d - chat[i] * y
            x[i] = y
    ycarry_in, ycarry = [zero] * chunks, zero   # y_e of each chunk
    for q in range(chunks - 1, -1, -1):
        ycarry_in[q] = ycarry
        s = spans[q][0]
        ycarry = x[s] + resp_b[s] * ycarry
    corr = (ycarry + v_last * y_last) * inv_sm
    out = torch.empty_like(c)
    for (s, e), yin in zip(spans, ycarry_in):
        out[s:e] = ((x[s:e] + resp_b[s:e, None] * yin)
                    - corr[None, :] * z[s:e, None])
    return out


def fused_cn_penta_plain(lhs, zz, minv, params, c, chunks: int | None = None,
                         blocks: int | None = None) -> torch.Tensor:
    """lhs (5, N) ``[eps, beta, inv_alpha, gamma, delta]`` of A', Z (N, 4),
    Minv (4, 4), params (16,), c (N, M) -> the next field; N ≥ 2, in the
    row blocks and chunks of ``fused_cn_tridiag_plain``."""
    n, m = c.shape
    if n < 2:
        raise ValueError(f"fused_cn_penta: the 5-point stencil needs N >= 2, "
                         f"got {n}")
    blocks, chunks = _split("fused_cn_penta", n, c.dtype, 5, blocks, chunks)
    if blocks > 1:
        y, ends = _partition_sweep("penta", lhs, params, c, blocks, chunks)
        wv = _woodbury(minv, params, ends[0], ends[1], ends[n - 2],
                       ends[n - 1])
        return y - _z_times(zz, wv)
    bounds = chunk_bounds(n, chunks)
    spans = list(zip(bounds[:-1], bounds[1:]))
    eps, beta, inv_alpha, gamma, delta = lhs
    w = params[:5]
    ru, rv, rw, rq = _responses("penta", lhs, chunks)
    zero = torch.zeros((m,), dtype=c.dtype, device=c.device)
    x = torch.empty_like(c)
    for s, e in spans:                          # forward, zero carries
        g1 = g2 = zero
        for i in range(s, e):
            r = w[0] * c[(i - 2) % n]
            for t, off in enumerate((-1, 0, 1, 2), start=1):
                r = r + w[t] * c[(i + off) % n]
            g = (r - eps[i] * g2 - beta[i] * g1) * inv_alpha[i]
            x[i] = g
            g1, g2 = g, g1
    carry_in, G1, G2 = [], zero, zero           # (g_{s-1}, g_{s-2})
    for s, e in spans:
        carry_in.append((G1, G2))
        l1, l2 = e - 1, e - 2
        G1, G2 = (x[l1] + ru[l1] * G1 + rv[l1] * G2,
                  x[l2] + ru[l2] * G1 + rv[l2] * G2)
    yN1 = G1
    for (s, e), (in1, in2) in zip(spans, carry_in):   # backward
        y1 = y2 = zero
        for i in range(e - 1, s - 1, -1):
            g = x[i] + ru[i] * in1 + rv[i] * in2
            y = g - gamma[i] * y1 - delta[i] * y2
            x[i] = y
            y1, y2 = y, y1
    ycarry_in, Y1, Y2 = [None] * chunks, zero, zero   # (y_e, y_{e+1})
    for q in range(chunks - 1, -1, -1):
        ycarry_in[q] = (Y1, Y2)
        f0, f1 = spans[q][0], spans[q][0] + 1
        Y1, Y2 = (x[f0] + rw[f0] * Y1 + rq[f0] * Y2,
                  x[f1] + rw[f1] * Y1 + rq[f1] * Y2)
    wv = _woodbury(minv, params, Y1, Y2, x[n - 2], yN1)
    corr = _z_times(zz, wv)
    out = torch.empty_like(c)
    for (s, e), (yi1, yi2) in zip(spans, ycarry_in):
        out[s:e] = ((x[s:e] + rw[s:e, None] * yi1 + rq[s:e, None] * yi2)
                    - corr[s:e])
    return out


def _z_times(zz, wv) -> torch.Tensor:
    """Z (N, 4) times the Woodbury weights (4 of (M,)): Σ_k Z[:, k] w_k in
    k order."""
    corr = zz[:, 0:1] * wv[0]
    for k in range(1, 4):
        corr = corr + zz[:, k:k + 1] * wv[k]
    return corr


# ---------------------------------------------------------------------------
# Kernels and dispatch
# ---------------------------------------------------------------------------

def launch_name(kind: str, which: str) -> str:
    """The ``LAUNCHES`` key of ``kind`` ("tridiag" or "penta") on a route:
    ``fused_cn_{kind}`` on chip, ``fused_cn_{kind}_partition`` and
    ``fused_cn_{kind}_global`` on the others."""
    return f"fused_cn_{kind}" + ("" if which == "onchip" else f"_{which}")


def _check_chunks(name: str, rows: int, dtype, bandwidth: int,
                  chunks: int | None) -> int:
    """``chunks``, or ``chunk_count(rows, dtype)`` when None, once it is
    one a tile of ``rows`` rows (the smallest row block's) takes:
    1..MAX_CHUNKS, each at least one row (two for the penta carries)."""
    chunks = chunk_count(rows, dtype) if chunks is None else chunks
    if not 1 <= chunks <= MAX_CHUNKS or rows < chunks * (bandwidth // 2):
        raise ValueError(f"{name}: {chunks} chunks do not split {rows} rows "
                         f"(1..{MAX_CHUNKS}, at least {bandwidth // 2} "
                         "rows each)")
    return chunks


def _fused_launch(kind: str, bandwidth: int, operands: dict, c: torch.Tensor,
                  which: str | None, chunks: int | None, out=None,
                  work=None) -> tuple:
    """Validate device, dtype and contiguity, pick the route (``which``, or
    ``route(N, dtype)`` when None), its row blocks and the tile routes'
    chunks (``chunks``, or ``chunk_count`` of a block's rows), allocate x
    (and the partitioned route's workspace; x is ``out`` and the workspace
    ``work`` when given, each validated).
    ``operands`` are lhs, z / Z,
    [Minv,] params in the C argument order.  Returns ``(launch(stage), x,
    route)``: ``launch(stage)`` runs the ``fused_cn`` entry point of
    ``csrc/fused_cn.cu``, the whole step (stage 0) or one of the
    partitioned route's K0–K3 (stages 1–4), in the span
    ``kernel.<launch_name>``, and raises on a CUDA error.  Counts
    nothing."""
    name = f"fused_cn_{kind}"
    tensors = [*operands.values(), c]
    if any(not t.is_cuda or t.device != c.device for t in tensors):
        raise ValueError(f"{name}: every operand must lie on one CUDA device")
    if c.dtype not in _FUSED_DTYPES:
        raise TypeError(f"{name}: unsupported dtype {c.dtype}; the fused "
                        "step takes float32 or float64")
    _ops.same_dtype(name, operands.values(), c)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    n, m = c.shape
    picked = route(n, c.dtype)[0]
    which = picked if which is None else which
    if which not in ROUTES:
        raise ValueError(f"{name}: route must be one of {ROUTES}, got "
                         f"{which!r}")
    blocks = row_blocks(n, c.dtype, which)
    if which == "global":
        if chunks is not None:
            raise ValueError(f"{name}: the global route sweeps whole "
                             "columns; it takes no chunks")
        chunks = 1
    else:
        if which == "onchip" and picked != "onchip":
            raise ValueError(f"{name}: N = {n} is past the on-chip route's "
                             f"{onchip_max_rows(c.dtype)} rows at {c.dtype}")
        if which == "partition" and blocks < 2:
            raise ValueError(f"{name}: N = {n} is one row block at "
                             f"{c.dtype}; the partitioned route needs two")
        chunks = _check_chunks(name, n // blocks, c.dtype, bandwidth, chunks)
        if bandwidth == 5 and operands["Z"].data_ptr() % 16:
            raise ValueError(f"{name}: the tile routes read a row of Z as "
                             "16-byte loads; Z must be 16-byte aligned")
    x = _ops.output_buffer(name, out, (n, m), c.dtype, c.device)
    work = _ops.partition_work(name, work, which == "partition",
                               work_elems(kind, n, m, blocks), c.dtype,
                               c.device)
    ptrs = [t.data_ptr() for t in operands.values()]
    if bandwidth == 3:
        ptrs.insert(2, None)   # no Minv
    desc = (ctypes.c_int * 11)(*_ops.sweep_desc(_spec(kind)))
    fn = _ops._kernel("fused_cn")
    where = f"kernel.{launch_name(kind, which)}"

    def launch(stage: int = 0) -> None:
        if m == 0:
            return
        with torch.cuda.device(c.device), span(where):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(_FUSED_DTYPES[c.dtype], bandwidth, _ROUTE_CODES[which],
                    blocks, chunks, stage, *ptrs, c.data_ptr(), x.data_ptr(),
                    None if work is None else work.data_ptr(), desc, n, m,
                    _ops.DEFAULT_THREADS, stream)
        if rc != 0:
            raise RuntimeError(f"{name} ({which} route) launch failed: CUDA "
                               f"error {rc}")

    return launch, x, which


def work_elems(kind: str, n: int, m: int, blocks: int) -> int:
    """Elements of the partitioned route's workspace for ``kind``'s step
    at (N, M) in ``blocks`` row blocks: ``ops.partition_work_elems`` with
    the corner corrections (1 row of M for the diffusion step, 4 for
    hyperdiffusion)."""
    return _ops.partition_work_elems(1 if kind == "tridiag" else 2, blocks,
                                     n, m, 1 if kind == "tridiag" else 4)


def _launch(kind: str, bandwidth: int, operands: dict, c: torch.Tensor,
            which: str | None, chunks: int | None, out=None,
            work=None) -> torch.Tensor:
    """One step on the route ``which`` (default: ``route``'s), counted
    once in ``LAUNCHES`` under ``launch_name``."""
    launch, x, which = _fused_launch(kind, bandwidth, operands, c, which,
                                     chunks, out, work)
    launch()
    traffic = tridiag_traffic_bytes if kind == "tridiag" \
        else penta_traffic_bytes
    _ops.count_launch(launch_name(kind, which),
                      traffic(*c.shape, c.dtype)["fused"])
    return x


def _operands(kind: str, operands: tuple, c: torch.Tensor) -> dict:
    """The step's operands by name, once their shapes fit c (N, M): lhs
    (3, N), z (N,), params (8,) (tridiag); lhs (5, N), Z (N, 4), Minv
    (4, 4), params (16,) (penta, N >= 2)."""
    name = f"fused_cn_{kind}"
    min_n = 1 if kind == "tridiag" else 2
    if c.ndim != 2 or c.shape[0] < min_n:
        raise ValueError(f"{name}: c must be (N, M) with N >= {min_n}, got "
                         f"{tuple(c.shape)}")
    n = c.shape[0]
    if kind == "tridiag":
        names, shapes = ("lhs", "z", "params"), ((3, n), (n,), (8,))
    else:
        names = ("lhs", "Z", "Minv", "params")
        shapes = ((5, n), (n, 4), (4, 4), (16,))
    if len(operands) != len(names) or any(
            tuple(t.shape) != want for t, want in zip(operands, shapes)):
        raise ValueError(f"{name}: " + ", ".join(
            f"{k} {want}" for k, want in zip(names, shapes)) + " expected")
    return dict(zip(names, operands))


def partition_stages(kind: str, *operands, out=None, work=None) -> dict:
    """``{"k0": f, …, "k3": f}`` for the partitioned route on ``operands``
    (those of ``fused_cn_tridiag_cuda`` / ``fused_cn_penta_cuda``, the
    field last): each call launches one of K0–K3 alone, on one workspace
    (``work`` when given) and into one x (``out``), to time or probe them;
    each reads what the last launch of the one before it wrote.  Not
    counted in ``LAUNCHES``: a stage is not a step."""
    *ops_, c = operands
    launch, _, _ = _fused_launch(kind, 3 if kind == "tridiag" else 5,
                                 _operands(kind, ops_, c), c, "partition",
                                 None, out, work)
    return {f"k{stage - 1}": (lambda stage=stage: launch(stage))
            for stage in (1, 2, 3, 4)}


def onchip_blocks_per_sm(n: int, dtype, bandwidth: int,
                         chunks: int | None = None) -> int:
    """Blocks of the on-chip kernel (``chunks`` warps each, by default
    ``chunk_count``) one SM holds at once at this N
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs the card."""
    chunks = _check_chunks("fused_cn_onchip_blocks", n, dtype, bandwidth,
                           chunks)
    fn = build.load("fused_cn").fused_cn_onchip_blocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    blocks = ctypes.c_int(0)
    rc = fn(_FUSED_DTYPES[dtype], bandwidth, n, chunks, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"fused_cn_onchip_blocks: CUDA error {rc}")
    return blocks.value


def fused_cn_tridiag_cuda(lhs, z, params, c, *, route: str | None = None,
                          chunks: int | None = None,
                          out: torch.Tensor | None = None,
                          work: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the diffusion step of ``csrc/fused_cn.cu`` on the route
    ``route(N, dtype)`` picks, or on the one forced here (``"onchip"``,
    ``"partition"`` or ``"global"``); the tile routes in ``chunk_count``
    chunks of a row block, or in ``chunks`` (to time others); the
    partitioned route on ``work`` when given (``work_elems`` elements).
    Raises on a route that cannot take N; nothing falls back."""
    return _launch("tridiag", 3, _operands("tridiag", (lhs, z, params), c),
                   c, route, chunks, out, work)


def fused_cn_penta_cuda(lhs, zz, minv, params, c, *,
                        route: str | None = None,
                        chunks: int | None = None,
                        out: torch.Tensor | None = None,
                        work: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the hyperdiffusion step of ``csrc/fused_cn.cu`` as
    ``fused_cn_tridiag_cuda`` launches the diffusion step."""
    return _launch("penta", 5,
                   _operands("penta", (lhs, zz, minv, params), c), c, route,
                   chunks, out, work)


def _dispatch(name: str, cuda_fn, plain_fn, operands: tuple, c):
    """A CUDA field goes to the kernel wrapper (which validates its
    operands), a CPU field to the plain version."""
    if c.is_cuda:
        return cuda_fn(*operands, c)
    if c.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {c.device}")
    _ops.same_dtype(name, operands, c)
    return plain_fn(*operands, c)


def fused_cn_tridiag(lhs, z, params, c) -> torch.Tensor:
    """The fused diffusion step on the kernel for CUDA tensors, on the
    plain version for CPU tensors."""
    return _dispatch("fused_cn_tridiag", fused_cn_tridiag_cuda,
                     fused_cn_tridiag_plain, (lhs, z, params), c)


def fused_cn_penta(lhs, zz, minv, params, c) -> torch.Tensor:
    """The fused hyperdiffusion step on the kernel for CUDA tensors, on
    the plain version for CPU tensors."""
    return _dispatch("fused_cn_penta", fused_cn_penta_cuda,
                     fused_cn_penta_plain, (lhs, zz, minv, params), c)


def fused_cn_step(pf, sigma: float, c: torch.Tensor) -> torch.Tensor:
    """One fused periodic CN diffusion step.  ``pf`` is the periodic
    tridiagonal factor (``core.periodic_thomas_factor``) of the CN LHS,
    at c's dtype and device; c: (N, M) -> (N, M)."""
    _refuse_grad("fused_cn_step", (c, pf.factor.a, pf.factor.inv_denom,
                                   pf.factor.c_hat, pf.z, pf.v_last,
                                   pf.inv_denom_sm))
    lhs = _ops.stack_tridiag_lhs(pf.factor).contiguous()
    params = tridiag_params(pf, sigma, c.dtype)
    return fused_cn_tridiag(lhs, pf.z.contiguous(), params, c.contiguous())


def fused_cn_penta_step(pf, sigma: float, c: torch.Tensor) -> torch.Tensor:
    """One fused periodic CN hyperdiffusion step.  ``pf`` is the periodic
    penta factor (``core.periodic_penta_factor``); c: (N, M) -> (N, M)."""
    f = pf.factor
    _refuse_grad("fused_cn_penta_step", (c, f.eps, f.beta, f.inv_alpha,
                                         f.gamma, f.delta, pf.Z, pf.Minv,
                                         pf.vcoef))
    lhs = _ops.stack_penta_lhs(f).contiguous()
    params = penta_params(pf, sigma, c.dtype)
    return fused_cn_penta(lhs, pf.Z.contiguous(), pf.Minv.contiguous(),
                          params, c.contiguous())


# (order, factor rows, z / Z columns, correction rows, params, Minv) of each
# step's operands
_STEP_SHAPES = {"tridiag": (1, 3, 1, 1, 8, 0), "penta": (2, 5, 4, 4, 16, 16)}


def route_words(kind: str, n: int, m: int, route: str,
                blocks: int = 1) -> int:
    """Words one step of ``kind`` moves through device memory on ``route``
    (``csrc/fused_cn.cu``), each word a launch reads or writes counted once
    a launch and a small operand (the parameters, Minv) counted whole;
    ``blocks`` is the partitioned route's row blocks B.  With order o, k
    factor rows and z (tridiag, 1 column) or Z (penta, 4):

      * ``"onchip"``: the floor, the field read once and the next written
        once, the factor, z / Z, Minv and the parameters read once
        (``"fused"`` of the traffic dicts).  A chunk's stencil halo rows
        are its neighbour chunk's rows, which the neighbour's warp loads
        at the same time: L2 serves them;
      * ``"partition"`` (K0–K3 over B row blocks): K0 reads the factor and
        writes the block coefficients (3Bo²) and the summary weights
        (2oN); K1 reads the field, the parameters and the weights and
        writes the summaries (2BoM); K2 reads the summaries, the
        coefficients, the parameters (and, penta, Minv and one factor
        word), writes the entry carries (2BoM), reads their forward half
        back (BoM) and writes the corrections (1 or 4 rows of M); K3 reads
        the field again, the factor, z / Z, the parameters, the carries and
        the corrections and writes x.  A block's halo rows are its
        neighbours' rows, counted with them as on chip.  So 3NM + 9BoM +
        2·corrections·M + (2k + 4o + columns of Z)·N + 6Bo² + three reads
        of the parameters (+ Minv and one word, penta);
      * ``"global"``: the forward pass reads c and writes d^ (g) into x,
        the backward pass reads and writes x, the correction reads and
        writes x again: 6NM with the factor, z / Z, Minv and the
        parameters read once, the words of the paper's three-kernel
        pipeline (``"unfused_pipeline"``)."""
    o, rows, zcols, corr, params, minv = _STEP_SHAPES[kind]
    small = params + minv
    if route == "onchip":
        return 2 * n * m + (rows + zcols) * n + small
    if route == "global":
        return 6 * n * m + (rows + zcols) * n + small
    if route == "partition":
        return (3 * n * m + 9 * blocks * o * m + 2 * corr * m
                + (2 * rows + 4 * o + zcols) * n + 6 * blocks * o * o
                + 3 * params + minv + (1 if kind == "penta" else 0))
    raise ValueError(f"fused_cn_{kind}: route must be one of {ROUTES}, got "
                     f"{route!r}")


def route_traffic_bytes(kind: str, n: int, m: int, route: str,
                        dtype=torch.float32) -> int:
    """``route_words`` in bytes at ``dtype``, the partitioned route in the
    row blocks ``row_blocks`` cuts at (N, dtype)."""
    return route_words(kind, n, m, route,
                       row_blocks(n, dtype, "partition")) * _itemsize(dtype)


def _traffic(kind: str, n: int, m: int, dtype) -> dict:
    return {"fused": route_traffic_bytes(kind, n, m, "onchip", dtype),
            "unfused_pipeline": route_traffic_bytes(kind, n, m, "global",
                                                    dtype),
            "partition": route_traffic_bytes(kind, n, m, "partition",
                                             dtype)}


def tridiag_traffic_bytes(n: int, m: int, dtype=torch.float32) -> dict:
    """Bytes of one CN diffusion step: ``"fused"`` (the on-chip route, the
    floor: the field read once, the next written once, the factor and the
    parameters read once) and the paper's three-kernel pipeline
    (``"unfused_pipeline"``), ``repro.kernels.fused_cn``'s
    ``hbm_traffic_bytes``, which the global route moves; beside them what
    the partitioned route moves (``"partition"``, ``route_words``)."""
    return _traffic("tridiag", n, m, dtype)


def penta_traffic_bytes(n: int, m: int, dtype=torch.float32) -> dict:
    """The same for one CN hyperdiffusion step (``"fused"`` and
    ``"unfused_pipeline"``: ``repro.kernels.fused_cn_penta``'s
    ``hbm_traffic_bytes``)."""
    return _traffic("penta", n, m, dtype)
