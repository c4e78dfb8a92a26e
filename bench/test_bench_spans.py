"""The readers of the program's spans (``benchkit/spans.py`` and the six
metrics that name its functions): nothing without spans, the right value
from a hand-made snapshot."""

from types import SimpleNamespace

import pytest

from benchkit import manifest

METRICS = ["host_syncs.step", "cotangent_ms.adjoint", "forward_ms.train",
           "backward_ms.train", "optimizer_ms.train", "ssd_ms.prefill"]


def _span(id_, name, parent=None, step=None, device_ms=None, **counts):
    return {"name": name, "id": id_, "parent": parent,
            "step": id_ if step is None else step,
            "start_ns": 0, "end_ns": 1, "device_ms": device_ms,
            "counts": counts}


def _run(records, steps=2):
    return SimpleNamespace(trace_steps=steps, program_spans=records)


# two traced steps of each cell's program
SNAPSHOT = [
    _span(1, "pde.step", device_ms=2.0),
    _span(2, "fused_cn.params", 1, 1, 0.01, host_sync=1),
    _span(3, "kernel.fused_cn_tridiag", 1, 1, 1.98),
    _span(4, "pde.step", device_ms=2.1),
    _span(5, "fused_cn.params", 4, 4, 0.01, host_sync=1),
    _span(6, "solver.solve_backward", device_ms=20.0),
    _span(7, "solver.diag_cotangents", 6, 6, 16.0),
    _span(8, "solver.diag_cotangents", device_ms=18.0),
    _span(9, "train.step", device_ms=980.0),
    _span(10, "train.forward", 9, 9, 300.0),
    _span(11, "ssm.ssd", 10, 9, 100.0),
    _span(12, "train.backward", 9, 9, 650.0, host_sync=2),
    _span(13, "train.optimizer", 9, 9, 20.0),
    _span(14, "train.forward", device_ms=310.0),
    _span(15, "train.backward", device_ms=640.0),
    _span(16, "train.optimizer", device_ms=30.0),
    _span(17, "prefill.step", device_ms=700.0),
    _span(18, "ssm.ssd", 17, 17, 400.0),
]
WANT = {"host_syncs.step": 1.0, "cotangent_ms.adjoint": 17.0,
        "forward_ms.train": 305.0, "backward_ms.train": 645.0,
        "optimizer_ms.train": 25.0, "ssd_ms.prefill": 250.0}


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_finds_nothing_without_spans(metric):
    read = manifest.reader(metric)
    assert read(_run(None)) is None            # a program without spans
    assert read(_run([])) is None              # spans recorded none
    assert read(_run(SNAPSHOT, steps=0)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_reads_a_hand_made_snapshot(metric):
    assert manifest.reader(metric)(_run(SNAPSHOT)) == pytest.approx(
        WANT[metric])


def test_a_step_without_syncs_reads_zero():
    quiet = [dict(r, counts={}) for r in SNAPSHOT]
    assert manifest.reader("host_syncs.step")(_run(quiet)) == 0.0


def test_the_snapshot_is_taken_once_a_run(monkeypatch):
    """The first reader takes the program's snapshot and keeps it on the
    run; the others read the same one (a snapshot clears the store)."""
    from benchkit import spans as reader
    from repro_torch import spans
    taken = []

    def snapshot():
        taken.append(1)
        return SNAPSHOT
    monkeypatch.setattr(spans, "snapshot", snapshot)
    run = SimpleNamespace(trace_steps=2)
    got = {m: manifest.reader(m)(run) for m in METRICS}
    assert got == pytest.approx(WANT) and len(taken) == 1
    assert reader.records(run) is SNAPSHOT


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent of the spans has no ``repro_torch.spans``: every reader
    returns None and none raises."""
    import sys

    import repro_torch
    from benchkit import spans as reader
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    run = SimpleNamespace(trace_steps=2)
    assert [manifest.reader(m)(run) for m in METRICS] == [None] * 6
    assert reader.records(run) is None
