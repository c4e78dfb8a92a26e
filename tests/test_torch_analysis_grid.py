"""The port's route geometry and traffic checks (``repro_torch.analysis.
gridcheck`` and ``capture``), on the CPU.

``gridcheck``'s Python leg runs clean over every rule's N grid, with its
coverage counted; its span check reports a gap, an overlap, a read
outside the operand, an uneven split and a short chunk; the span
functions the plain versions now call give the spans the plain versions
cut before.  ``capture``'s operand recount equals the port's traffic model
for every spec and fused step at each storage type, and JAX's word count
for every spec.  The partitioned routes' workspace: its one size function
(``ops.partition_work_elems``, ``fused_cn.work_elems``) equals the
formulas both wrappers allocated by before, at every partitioned geometry
the sweep checks; ``ops.partition_work`` refuses a workspace of the wrong
size, dtype or layout, or one handed to another route; the carry probe's
cells each make three row blocks and it needs a card.  The card legs (the
CUDA sources' ``_spans`` exports, the carry probe itself) are in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import pytest
import torch

from repro.kernels import engine as jengine

from repro_torch.analysis import (capture, carryprobe, gridcheck, nansweep,
                                  speccheck)
from repro_torch.kernels import fused_cn, ops


def _want_rules() -> int:
    """The rule points the sweep's grid holds (one per rule, N, dtype and
    the other arguments each rule takes)."""
    dense = len(gridcheck.grid(1, None))
    shared = 3 * (dense + 5)
    batch = sum(ops.batch_onchip_max_rows(d, bw) + gridcheck.BATCH_PAST
                for d in gridcheck.SHARED_DTYPES for bw in (3, 5))
    recurrence = 2 * gridcheck.RECURRENCE_TOP * 3
    fused = 2 * (dense + len(gridcheck.grid(3, None)))
    return shared + batch + recurrence + fused


def test_gridcheck_clean_on_every_rule_with_its_coverage():
    res = gridcheck.sweep("cpu")
    assert res.findings == []
    assert res.rules == _want_rules()
    assert res.spans > 10 ** 6 and res.compared == 0
    assert gridcheck.run("cpu") == []


def test_gridcheck_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        gridcheck.run()


@pytest.mark.parametrize("spans,kw,phrase", (
    ([(0, 3), (4, 8)], {}, "skips rows"),
    ([(0, 5), (4, 8)], {}, "doubles rows"),
    ([(0, 4), (4, 9)], {}, "outside rows"),
    ([(0, 4), (4, 6)], {}, "never written"),
    ([(0, 2), (2, 8)], {"blocks": 1, "chunks": 2}, "uneven"),
    ([(0, 1), (1, 8)], {"blocks": 2, "chunks": 1}, "uneven"),
    ([(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8)],
     {"blocks": 1, "chunks": 8, "min_rows": 2}, "short of the 2 row"),
    ([(0, 8)], {"max_rows": 4}, "more than the kernel's 4"),
))
def test_check_spans_reports_each_defect(spans, kw, phrase):
    out = []
    gridcheck.check_spans("probe", 8, spans, out, **kw)
    assert len(out) == 1 and phrase in out[0].message, out
    clean = []
    gridcheck.check_spans("probe", 8, [(0, 4), (4, 8)], clean, blocks=2,
                          chunks=1, min_rows=2, max_rows=4)
    assert clean == []


@pytest.mark.parametrize("n,chunks", ((1, 1), (17, 2), (33, 4), (45, 4),
                                      (481, 31), (512, 32), (256, 16)))
def test_batch_chunk_spans_are_the_plain_versions_cut(n, chunks):
    rows = -(-n // chunks)
    spans = ops.batch_chunk_spans(n, chunks)
    assert spans == [(min(k * rows, n), min((k + 1) * rows, n))
                     for k in range(chunks)]
    assert spans[0] == (0, rows) and spans[-1][1] == n


@pytest.mark.parametrize("n,chunks,rows", ((1, 1, 8), (45, 2, 8),
                                           (128, 16, 8), (129, 16, 8),
                                           (1000, 8, 8)))
def test_recurrence_windows_cover_the_walk(n, chunks, rows):
    windows = ops.recurrence_windows(n, chunks, rows)
    span = chunks * rows
    assert len(windows) == -(-n // span)
    flat = [se for w in windows for se in w]
    assert flat[0][0] == 0 and flat[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(flat, flat[1:]))


@pytest.mark.parametrize("subject,layout,spec",
                         [(s, lay, sp) for s, lay, sp in nansweep.kinds()])
def test_recount_equals_the_traffic_model(subject, layout, spec):
    dtypes = capture.FUSED_DTYPES if layout == "fused" else capture.DTYPES
    n, m = capture.TRACE_N, capture.TRACE_M
    for dtype in dtypes:
        rec = capture.recount(layout, spec, dtype)
        assert rec.total_bytes == capture.modelled_bytes(subject, n, m,
                                                         dtype)
    assert rec.words == capture.modelled_words(subject, n, m)
    if layout == "fused":
        model = (fused_cn.tridiag_traffic_bytes if spec == nansweep.FUSED[0]
                 else fused_cn.penta_traffic_bytes)(n, m)["fused"]
        assert capture.recount(layout, spec, torch.float32).total_bytes \
            == model
    else:
        assert rec.words == jengine.REGISTRY[subject].traffic_words(n, m)
        assert rec.total_bytes == spec.traffic_bytes(n, m, torch.bfloat16)


def test_speccheck_reports_traffic_drift(monkeypatch):
    real = fused_cn.penta_traffic_bytes

    def stale(n, m, dtype=torch.float32):
        out = real(n, m, dtype)
        return {**out, "fused": out["fused"] + 4}

    monkeypatch.setattr(fused_cn, "penta_traffic_bytes", stale)
    found = speccheck.run()
    assert [f.subject for f in found] == ["fused_cn_penta",
                                          "fused_cn_penta[float32]",
                                          "fused_cn_penta[float64]"]
    assert all("HBM traffic drift" in f.message for f in found)


def _old_shared_work(order: int, b: int, n: int, m: int) -> int:
    """The shared sweep wrapper's workspace before the size function."""
    return 4 * b * order * m + 3 * b * order * order + 2 * order * n


def _old_fused_work(kind: str, blocks: int, n: int, m: int) -> int:
    """The fused steps' wrapper's workspace before the size function."""
    order = 1 if kind == "tridiag" else 2
    return (4 * blocks * order * m + 3 * blocks * order ** 2 + 2 * order * n
            + (1 if kind == "tridiag" else 4) * m)


def test_work_size_equals_the_old_formulas_at_every_partitioned_geometry():
    checked = 0
    for m in (1, 70, (1 << 20) + 3):
        for dtype in gridcheck.SHARED_DTYPES:
            for n in gridcheck.grid(ops.onchip_max_rows(dtype) + 1, None):
                b = ops.shared_route(n, dtype).row_blocks
                for order in (1, 2):
                    assert ops.partition_work_elems(order, b, n, m) == \
                        _old_shared_work(order, b, n, m)
                    checked += 1
        for kind in ("tridiag", "penta"):
            for dtype in gridcheck.FUSED_DTYPES:
                for n in gridcheck.grid(ops.onchip_max_rows(dtype) + 1, None):
                    blocks = fused_cn.row_blocks(n, dtype)
                    assert fused_cn.work_elems(kind, n, m, blocks) == \
                        _old_fused_work(kind, blocks, n, m)
                    checked += 1
    assert checked > 10 ** 4


@pytest.mark.parametrize("bad,phrase", (
    ({"size": 99}, "work must be a contiguous"),
    ({"dtype": torch.float64}, "work must be a contiguous"),
    ({"shape": (10, 10)}, "work must be a contiguous"),
    ({"strided": True}, "work must be a contiguous"),
    ({"route": "onchip"}, "only the partitioned route"),
))
def test_work_refused_before_any_launch(bad, phrase, monkeypatch):
    """``partition_work``, which both wrappers call before they launch,
    refuses a workspace it cannot hand the kernel; no kernel is loaded."""
    monkeypatch.setattr(ops, "_kernel", lambda name: pytest.fail(
        "a kernel was loaded"))
    size = bad.get("size", 100)
    shape = bad.get("shape", (2 * size,) if bad.get("strided") else (size,))
    work = torch.zeros(shape, dtype=bad.get("dtype", torch.float32))
    if bad.get("strided"):
        work = work[::2]
    with pytest.raises(ValueError, match=phrase):
        ops.partition_work("shared_sweep", work,
                           bad.get("route", "partition") == "partition", 100,
                           torch.float32, torch.device("cpu"))
    fresh = ops.partition_work("shared_sweep", None, True, 100,
                               torch.float32, torch.device("cpu"))
    assert fresh.shape == (100,) and fresh.dtype == torch.float32
    assert ops.partition_work("shared_sweep", None, False, 100,
                              torch.float32, torch.device("cpu")) is None


def test_partition_carries_view_is_k2s_slot():
    blocks, order, m, n = 3, 2, 5, 7
    size = ops.partition_work_elems(order, blocks, n, m)
    work = torch.zeros(size, dtype=torch.float64)
    carries = ops.partition_carries(work, blocks, order, m)
    assert carries.shape == (blocks, 2, order, m)
    assert carries.data_ptr() == work[2 * blocks * order * m:].data_ptr()
    carries[1] = carryprobe.SENTINEL
    hit = (work == carryprobe.SENTINEL).nonzero().flatten()
    start = 2 * blocks * order * m + 2 * order * m
    assert hit.tolist() == list(range(start, start + 2 * order * m))


@pytest.mark.parametrize("subject,layout,spec", carryprobe.cells())
def test_carry_probe_cells_make_three_row_blocks(subject, layout, spec):
    blocks, order, size, name = carryprobe.geometry(
        layout, spec, carryprobe.N_ROWS, carryprobe.M_COLS)
    assert blocks == 3 and order in (1, 2)
    assert carryprobe.M_COLS % 32
    assert size >= 4 * blocks * order * carryprobe.M_COLS
    assert name.endswith("_partition") == (layout == "fused")


def test_carry_probe_covers_every_partitioned_kind_and_needs_the_card():
    kinds = {s for s, lay, _ in nansweep.kinds() if lay in ("shared",
                                                            "fused")}
    assert {s for s, _, _ in carryprobe.cells()} == kinds
    assert {sp.order for _, lay, sp in carryprobe.cells()
            if lay == "shared"} == {1, 2}
    with pytest.raises(ValueError, match="card only"):
        carryprobe.run("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        carryprobe.run()
