"""gridcheck — every route's row spans, held against the CUDA sources.

Counterpart of ``repro.analysis.gridcheck``.  The reference enumerates its
Pallas ``BlockSpec`` index maps over the streamed grid; the port's grid is
the row spans each route cuts N into: the shared sweep's and the fused CN
steps' row blocks and chunks, the batch sweep's on-chip chunks and the
recurrence tile's windows.  A split that drops or doubles a row at some N
gives wrong values and no error, and ``nansweep``'s three shapes reach
three N.  So, for every route rule at every N it can pick (each N up to
4096 and a stride past it to 16,384 where the rule has no upper limit),
the spans it gives must:

  * **cover rows [0, N) exactly once, in order** (a bijection onto the
    rows, ascending; the recurrence tile's in walk order, descending when
    reversed), every read inside the operand;
  * **fit the kernel**: each row block at most ceil(N / B) rows (the tile
    the kernel sizes its shared memory for) and the parts of one split
    within a row of each other (``chunk_bounds``' contract), every chunk a
    row (two for the penta CN step's carries), at most ``MAX_CHUNKS``
    chunks; the batch chunks at most ``BATCH_ROWS`` rows; and the
    route's validity check (``ops._check_split``,
    ``fused_cn._check_chunks``) accepts what the rule picks;
  * **fit shared memory**: the tile at the largest N the rule sends on
    chip (and the partitioned route's largest row block) within
    ``SMEM_PER_BLOCK`` at each dtype.  In Python this only restates the
    formula ``ops.onchip_max_rows`` is defined by (``_smem``), so it fails
    when that rule is edited, not when a kernel's layout changes.  The
    real check is the card leg's: each export refuses a geometry its
    source's own ``tiles_fit`` refuses (``tile_smem`` of ``shared_sweep.cu``
    and ``fused_cn.cu``), and the shared sweep's is asked at both orders
    and at the tile width the rule picks.

The spans are read from the functions the plain versions cut their rows
by (``ops.split_spans`` over ``chunk_bounds`` for the shared sweep and
the fused steps; ``ops.batch_chunk_spans`` and ``ops.recurrence_windows``,
whose every span ``_batch_chunked`` and ``_recurrence_chunked`` slice),
so the check holds the rule the port runs, not a copy.  Those are mirrors
of the device arithmetic, so ``sweep(device="cuda")`` also loads each
source's ``extern "C" <source>_spans`` export (``kernels/build.py``),
which writes the spans that the kernels' own helpers (``part_begin``,
``onchip_rows`` / ``chunk_len``, ``WINDOW_COUNT`` / ``WINDOW_LEFT`` /
``WALK_ROW``) give, and refuses a geometry the launch would refuse; a
difference at any N of the grid is a finding.  The exports are host
functions that need only the built library, launching nothing; the leg
asks for a card all the same, as every entry point of the port does
unless told ``device="cpu"``, which runs the Python leg alone.

JAX's carry-protocol probe (a sentinel carry at ``k == 0``) has no
counterpart here.  Its port analogue is that a partitioned row block's
entry carries come only from K1–K2: on the card K3 reads them from a
workspace that ``ops._shared_launch`` / ``fused_cn._fused_launch``
allocate inside the call and K2 writes whole, which no caller can seed
with a sentinel; in the plain versions (``ops.chain_blocks``) block 0's
carries are a literal zero, so a probe there would test the literal.  A
K2 that skipped a block would leave garbage that ``nansweep``'s card leg
does not see either (it fills the output, not the workspace): an open
item (ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, fused_cn, ops

from . import Finding

#: Every N up to this on the routes with no upper limit, then a stride.
DENSE_TOP, STRIDE, TOP = 4096, 61, 16384
#: Past their on-chip limit, the batch sweep's stream route and the
#: recurrence tile's windows are checked this far (the windows repeat with
#: the window's rows, at most 128).
BATCH_PAST, RECURRENCE_TOP = 64, 1024
SHARED_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
FUSED_DTYPES = (torch.float32, torch.float64)
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_ROUTE_CODES = {"serial": 0, "global": 0, "stream": 0, "walk": 0,
                "onchip": 1, "tile": 1, "partition": 2}


@dataclasses.dataclass
class Checked:
    """What a sweep covered, beside its findings."""

    findings: list
    rules: int = 0         # (rule, N, dtype, …) points checked
    spans: int = 0         # spans checked in Python
    compared: int = 0      # of them held against a CUDA export


def grid(lo: int, hi: int | None) -> list:
    """N from ``lo``: every N to ``hi`` (or ``DENSE_TOP`` when None), then
    every ``STRIDE``-th to ``TOP`` and ``TOP`` itself."""
    if hi is not None:
        return list(range(lo, hi + 1))
    dense = list(range(lo, DENSE_TOP + 1))
    return dense + list(range(DENSE_TOP + STRIDE, TOP, STRIDE)) + [TOP]


def _parts_ok(sizes: list, rows: int) -> bool:
    """``len(sizes)`` parts of ``rows`` rows within a row of each other
    (each floor or ceil of the share)."""
    p = len(sizes)
    return all(rows // p <= s <= -(-rows // p) for s in sizes)


def check_spans(sub: str, n: int, spans: list, out: list, *,
                blocks: int = 1, chunks: int | None = None,
                min_rows: int = 0, max_rows: int | None = None) -> None:
    """Spans ``[(s, e), …]`` in row order: a bijection onto rows [0, N),
    each inside it; with ``chunks`` (``len(spans) == blocks · chunks``) the
    row blocks and each block's chunks split evenly, every chunk at least
    ``min_rows`` rows; every span at most ``max_rows``."""
    at = 0
    for s, e in spans:
        if not (0 <= s <= e <= n):
            out.append(Finding("gridcheck", sub,
                               f"span [{s}, {e}) reads outside rows "
                               f"[0, {n})"))
            return
        if s != at:
            what = "skips" if s > at else "doubles"
            out.append(Finding("gridcheck", sub,
                               f"span [{s}, {e}) {what} rows from {at}: the "
                               f"spans are not a bijection onto [0, {n})"))
            return
        at = e
        if max_rows is not None and e - s > max_rows:
            out.append(Finding("gridcheck", sub,
                               f"span [{s}, {e}) holds {e - s} rows, more "
                               f"than the kernel's {max_rows}"))
    if at != n:
        out.append(Finding("gridcheck", sub,
                           f"rows [{at}, {n}) are never written"))
        return
    if chunks is None:
        return
    if len(spans) != blocks * chunks:
        out.append(Finding("gridcheck", sub,
                           f"{len(spans)} spans for {blocks} row blocks of "
                           f"{chunks} chunks"))
        return
    per = [spans[b * chunks:(b + 1) * chunks] for b in range(blocks)]
    sizes = [blk[-1][1] - blk[0][0] for blk in per]
    if not _parts_ok(sizes, n):
        out.append(Finding("gridcheck", sub,
                           f"row blocks of {min(sizes)}..{max(sizes)} rows: "
                           f"uneven, and past ceil(N / B) = "
                           f"{-(-n // blocks)} a tile overruns the shared "
                           f"memory the kernel sizes"))
    for blk, size in zip(per, sizes):
        lens = [e - s for s, e in blk]
        if not _parts_ok(lens, size) or min(lens) < max(min_rows, 1):
            out.append(Finding("gridcheck", sub,
                               f"chunks of {min(lens)}..{max(lens)} rows over "
                               f"a block of {size}: uneven, or short of the "
                               f"{max(min_rows, 1)} row(s) a chunk's carries "
                               f"need"))
            return


def _smem(sub: str, rows: int, itemsize: int, out: list) -> None:
    """A tile of ``TILE_M`` columns and ``RESP_ROWS`` response rows over
    ``rows`` rows fits one block's shared memory."""
    need = rows * (ops.TILE_M + ops.RESP_ROWS) * itemsize
    if need > ops.SMEM_PER_BLOCK:
        out.append(Finding("gridcheck", sub,
                           f"the tile over {rows} rows needs {need} bytes of "
                           f"shared memory, past the {ops.SMEM_PER_BLOCK} a "
                           f"block may hold (shared memory)"))


class _Exports:
    """The ``<source>_spans`` exports of the four CUDA sources."""

    def __init__(self):
        i, p, ll = ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_longlong
        sigs = {"shared_sweep": [i, i, i, ll, i, i, i, p, i],
                "fused_cn": [i, i, i, ll, i, i, p, i],
                "batch_sweep": [i, i, ll, i, p, i],
                "recurrence_sweep": [i, i, ll, i, p, i]}
        self.fns = {}
        for name, argtypes in sigs.items():
            fn = getattr(build.load(name), f"{name}_spans")
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
            self.fns[name] = fn

    def spans(self, name: str, *args, cap: int) -> list | None:
        """The export's spans as ``(a, b)`` pairs, None where it refuses."""
        buf = (ctypes.c_int * (2 * cap))()
        got = self.fns[name](*args, buf, cap)
        if got < 0:
            return None
        return [(buf[2 * k], buf[2 * k + 1]) for k in range(got)]


def _compare(sub: str, mine: list, theirs, source: str, res: Checked, *,
             tally: bool = True) -> None:
    """``mine`` against the export's spans; ``tally`` counts them as
    compared (once a span, where one span is asked at two orders)."""
    res.compared += len(mine) if tally else 0
    if theirs is None:
        res.findings.append(Finding(
            "gridcheck", sub, f"{source}.cu refuses the geometry the rule "
            f"picks (its launch would fail)"))
    elif theirs != mine:
        diff = next((k, a, b) for k, (a, b) in enumerate(
            zip(mine + [None] * len(theirs), theirs + [None] * len(mine)))
            if a != b)
        res.findings.append(Finding(
            "gridcheck", sub, f"the Python rule's span {diff[0]} is "
            f"{diff[1]}, {source}.cu's is {diff[2]}"))


def _shared(res: Checked, cuda) -> None:
    for dtype in SHARED_DTYPES:
        size = ops._compute_itemsize(dtype)
        n_max = ops.onchip_max_rows(dtype)
        tag = str(dtype).split(".")[-1]
        for n in grid(1, None):
            r = ops.shared_route(n, dtype)
            sub = f"shared_route[n={n} {tag} {r.name}]"
            res.rules += 1
            want = "onchip" if n <= n_max else "partition"
            if r.name != want:
                res.findings.append(Finding(
                    "gridcheck", sub, f"route {r.name}, expected {want}"))
                continue
            try:
                ops._check_split(n, r.row_blocks, r.chunks)
            except ValueError as exc:
                res.findings.append(Finding("gridcheck", sub,
                                            f"the rule's split is refused: "
                                            f"{exc}"))
                continue
            spans = ops.split_spans(n, r.row_blocks, r.chunks)
            res.spans += len(spans)
            check_spans(sub, n, spans, res.findings, blocks=r.row_blocks,
                        chunks=r.chunks)
            if r.chunks > ops.MAX_CHUNKS:
                res.findings.append(Finding("gridcheck", sub,
                                            f"{r.chunks} chunks, past "
                                            f"{ops.MAX_CHUNKS}"))
            _smem(sub, -(-n // r.row_blocks), size, res.findings)
            blocks = ops.split_spans(n, r.row_blocks, 1)
            if r.name == "partition":
                res.spans += len(blocks)
                check_spans(sub + " K0-K2 blocks", n, blocks, res.findings,
                            blocks=r.row_blocks, chunks=1)
            if cuda is None:
                continue
            code = _DTYPE_CODES[dtype]
            for order in (1, 2):
                _compare(f"{sub} order={order}", spans, cuda.spans(
                    "shared_sweep", code, order, _ROUTE_CODES[r.name], n,
                    r.row_blocks, r.chunks, r.tile_m, cap=len(spans)),
                    "shared_sweep", res, tally=order == 2)
                if r.name == "partition":
                    _compare(f"{sub} order={order} K0-K2 blocks", blocks,
                             cuda.spans("shared_sweep", code, order, 2, n,
                                        r.row_blocks, 1, r.tile_m,
                                        cap=len(blocks)),
                             "shared_sweep", res, tally=order == 2)
        for n in (1, 2, n_max, n_max + 1, DENSE_TOP):
            r = ops.shared_route(n, dtype, "serial")
            spans = ops.split_spans(n, r.row_blocks, r.chunks)
            sub = f"shared_route[n={n} {tag} serial]"
            res.rules += 1
            res.spans += len(spans)
            check_spans(sub, n, spans, res.findings)
            if cuda is not None:
                _compare(sub, spans, cuda.spans(
                    "shared_sweep", _DTYPE_CODES[dtype], 2, 0, n, 1, 1,
                    r.tile_m, cap=1), "shared_sweep", res)


def _batch(res: Checked, cuda) -> None:
    for dtype in SHARED_DTYPES:
        tag = str(dtype).split(".")[-1]
        n_max = ops.batch_onchip_max_rows(dtype)
        most = ops.batch_onchip_chunks(dtype)
        storage = dtype.itemsize
        for bw in (3, 5):
            top = n_max + BATCH_PAST if bw == 3 else BATCH_PAST
            for n in range(1, top + 1):
                r = ops.batch_route(n, dtype, bw)
                sub = f"batch_route[n={n} {tag} bw={bw} {r.name}]"
                res.rules += 1
                want = "onchip" if bw == 3 and n <= n_max else "stream"
                if r.name != want:
                    res.findings.append(Finding(
                        "gridcheck", sub, f"route {r.name}, expected {want}"))
                    continue
                if r.name == "stream":
                    spans = [(0, n)]
                else:
                    spans = ops.batch_chunk_spans(n, r.chunks)
                    if r.rows != -(-n // r.chunks) or r.chunks > most:
                        res.findings.append(Finding(
                            "gridcheck", sub, f"{r.chunks} chunks of "
                            f"{r.rows} rows: at most {most} chunks of "
                            f"ceil(N / chunks)"))
                    # the planes of batch_onchip_kernel (batch_sweep.cu's
                    # onchip_smem): a and d at the storage type, eight
                    # summary words at the compute type, a chunk and lane
                    smem = (2 * r.chunks * ops.BATCH_ROWS * storage
                            + 8 * r.chunks * ops._compute_itemsize(dtype)) \
                        * ops.TILE_M
                    if smem > ops.SMEM_PER_BLOCK:
                        res.findings.append(Finding(
                            "gridcheck", sub, f"{smem} bytes of shared "
                            f"memory, past {ops.SMEM_PER_BLOCK} (shared "
                            f"memory)"))
                res.spans += len(spans)
                check_spans(sub, n, spans, res.findings,
                            max_rows=ops.BATCH_ROWS if r.name == "onchip"
                            else None)
                if cuda is not None:
                    _compare(sub, spans, cuda.spans(
                        "batch_sweep", _DTYPE_CODES[dtype],
                        _ROUTE_CODES[r.name], n, r.chunks,
                        cap=len(spans)), "batch_sweep", res)


def _recurrence_spans(n: int, windows: list, reverse: bool) -> list:
    """``(first row, rows)`` of every chunk in walk order (first row −1
    for a chunk with none), the export's form."""
    return [((n - 1 - s if reverse else s) if e > s else -1, e - s)
            for window in windows for s, e in window]


def _recurrence(res: Checked, cuda) -> None:
    dtype = torch.float32
    for order in (1, 2):
        wide = ops.RECURRENCE_TILE_MAX_COLUMNS[order]
        for n in range(1, RECURRENCE_TOP + 1):
            for m in (1, wide, wide + 1):
                r = ops.recurrence_route(n, m, dtype, order)
                want = ("tile" if n >= ops.RECURRENCE_TILE_MIN_ROWS
                        and m <= wide else "walk")
                res.rules += 1
                if r.name != want:
                    res.findings.append(Finding(
                        "gridcheck", f"recurrence_route[n={n} m={m} "
                        f"order={order}]", f"route {r.name}, expected "
                        f"{want}"))
            r = ops.recurrence_route(n, 1, dtype, order)
            for reverse in (False, True):
                sub = (f"recurrence_route[n={n} order={order} "
                       f"{'reverse' if reverse else 'forward'} {r.name}]")
                if r.name == "walk":
                    windows = [[(0, n)]]
                else:
                    windows = ops.recurrence_windows(n, r.chunks, r.rows)
                    span = r.chunks * r.rows
                    if r.chunks > ops.RECURRENCE_MAX_CHUNKS or any(
                            len(w) != r.chunks for w in windows) or \
                            not windows or windows[-1][0][0] >= n:
                        res.findings.append(Finding(
                            "gridcheck", sub, f"{len(windows)} windows of "
                            f"{r.chunks} chunks for {n} rows in windows of "
                            f"{span}"))
                flat = [se for w in windows for se in w]
                res.spans += len(flat)
                # walk positions: row s ascending, row N - 1 - s descending,
                # so a bijection onto [0, N) in walk order either way
                check_spans(sub, n, flat, res.findings,
                            max_rows=r.rows if r.name == "tile" else None)
                if cuda is not None:
                    mine = _recurrence_spans(n, windows, reverse)
                    _compare(sub, mine, cuda.spans(
                        "recurrence_sweep", _ROUTE_CODES[r.name],
                        int(reverse), n, r.chunks, cap=len(mine)),
                        "recurrence_sweep", res)


def _fused(res: Checked, cuda) -> None:
    for kind, bw in (("tridiag", 3), ("penta", 5)):
        name = f"fused_cn_{kind}"
        for dtype in FUSED_DTYPES:
            tag = str(dtype).split(".")[-1]
            n_max = ops.onchip_max_rows(dtype)
            for n in grid(bw // 2 + 1 if bw == 5 else 1, None):
                which, smem = fused_cn.route(n, dtype)
                sub = f"fused_cn.route[{kind} n={n} {tag} {which}]"
                res.rules += 1
                want = "onchip" if n <= n_max else "partition"
                if which != want:
                    res.findings.append(Finding(
                        "gridcheck", sub, f"route {which}, expected {want}"))
                    continue
                blocks = fused_cn.row_blocks(n, dtype)
                chunks = fused_cn.sweep_chunks(n, dtype)
                try:
                    fused_cn._check_chunks(name, n // blocks, dtype, bw,
                                           chunks)
                except ValueError as exc:
                    res.findings.append(Finding(
                        "gridcheck", sub, f"the rule's chunks are refused: "
                        f"{exc}"))
                    continue
                spans = ops.split_spans(n, blocks, chunks)
                res.spans += len(spans)
                check_spans(sub, n, spans, res.findings, blocks=blocks,
                            chunks=chunks, min_rows=bw // 2)
                if smem > ops.SMEM_PER_BLOCK:
                    res.findings.append(Finding(
                        "gridcheck", sub, f"fused_cn.route gives {smem} "
                        f"bytes of shared memory, past "
                        f"{ops.SMEM_PER_BLOCK} (shared memory)"))
                if cuda is not None:
                    _compare(sub, spans, cuda.spans(
                        "fused_cn", _DTYPE_CODES[dtype], bw,
                        _ROUTE_CODES[which], n, blocks, chunks,
                        cap=len(spans)), "fused_cn", res)


def sweep(device: str = "cuda") -> Checked:
    """Every rule's spans over the grid, in Python and (``"cuda"``, the
    default, which raises without a card) against the CUDA exports."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"gridcheck: device must be cpu or cuda, got "
                         f"{device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gridcheck's card leg needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    res = Checked(findings=[])
    cuda = _Exports() if device == "cuda" else None
    for part in (_shared, _batch, _recurrence, _fused):
        part(res, cuda)
    return res


def run(device: str = "cuda") -> list:
    """The findings of ``sweep(device)``."""
    return sweep(device).findings
