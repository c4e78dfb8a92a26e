"""The port's spans and counts (``repro_torch.spans``) and the trace
reader's join of them with a profiler trace
(``launch.trace_analysis.read_trace(..., spans=)``).

On the CPU: the off path, ids, parents and steps (nested, across a
thread and through an autograd backward), spans switched on by a
profiler, the shared clock against ``record_function``'s own events, the
layers' spans on a CPU run, and the reader on a hand-made trace.  Marked
``cuda`` (skipped without a card; the file imports no JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py

``host_sync`` against the trace's synchronising calls in 20 fused steps,
every ``kernel.fused_cn_tridiag`` span around its launch call in a trace
of device activity alone, and a span's event ms against the profiler's
ms for its kernel.
"""

from __future__ import annotations

import json
import statistics
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.launch.trace_analysis import launch_name, read_trace
from repro_torch.models import Model
from repro_torch.pde import DiffusionCN
from repro_torch.sharding import ShardingCtx
from repro_torch.solver import BandedSystem, factorize, solve
from repro_torch.train import AdamW, make_prefill_step, make_train_step


@pytest.fixture(autouse=True)
def clean_store():
    """Spans off and the store empty before and after each test."""
    spans.disable()
    spans.snapshot()
    yield
    spans.disable()
    spans.snapshot()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused CN kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _by_name(records: list) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


# -- the module on the CPU ----------------------------------------------------

def test_the_off_path_records_nothing_and_returns_the_shared_context():
    a, b = spans.span("a"), spans.span("b")
    assert a is b is spans._OFF
    with spans.span("a"):
        spans.count(spans.HOST_SYNC)
        with spans.span("b"):
            pass
    assert spans.snapshot() == []


def test_parents_steps_and_counts_nest():
    spans.enable()
    with spans.span("root") as root:
        spans.count("n")
        with spans.span("child"):
            spans.count("n", 2)
            with spans.span("leaf"):
                pass
        with spans.span("sibling"):
            pass
    with spans.span("next"):
        pass
    got = _by_name(spans.snapshot())
    assert [r["name"] for v in got.values() for r in v] == [
        "leaf", "child", "sibling", "root", "next"]
    r, c, leaf, s, nxt = (got[k][0] for k in ("root", "child", "leaf",
                                              "sibling", "next"))
    assert r["id"] == root.id and r["parent"] is None and r["step"] == r["id"]
    assert c["parent"] == r["id"] and s["parent"] == r["id"]
    assert leaf["parent"] == c["id"]
    assert {x["step"] for x in (c, leaf, s)} == {r["id"]}
    assert nxt["parent"] is None and nxt["step"] == nxt["id"] != r["id"]
    assert r["counts"] == {"n": 1} and c["counts"] == {"n": 2}
    assert leaf["counts"] == {}
    assert r["start_ns"] <= c["start_ns"] <= leaf["start_ns"] \
        <= leaf["end_ns"] <= c["end_ns"] <= r["end_ns"]
    # device time from the events where there is a card, none without
    if torch.cuda.is_available():
        assert r["device_ms"] >= c["device_ms"] >= 0.0
    else:
        assert r["device_ms"] is None and c["device_ms"] is None
    assert spans.snapshot() == []


def test_a_span_on_another_thread_takes_the_open_span_as_parent():
    spans.enable()

    def worker():
        with spans.span("worker"):
            with spans.span("worker.inner"):
                pass

    with spans.span("caller"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    got = _by_name(spans.snapshot())
    caller, w, inner = got["caller"][0], got["worker"][0], \
        got["worker.inner"][0]
    assert w["parent"] == caller["id"] and w["step"] == caller["id"]
    assert inner["parent"] == w["id"] and inner["step"] == caller["id"]


def test_the_solvers_backward_nests_in_the_span_that_takes_the_gradient():
    """``solver.solve`` in the forward, ``solver.solve_backward`` with
    ``solver.diag_cotangents`` inside it in the backward, both under the
    spans open where the caller runs them."""
    n, m, s = 12, 5, 0.3
    diags = tuple(torch.full((n,), v, dtype=torch.float64,
                             requires_grad=True)
                  for v in (-s, 1 + 2 * s, -s))
    fact = factorize(BandedSystem.tridiag(*diags, n=n, periodic=True,
                                          dtype=torch.float64, device="cpu"),
                     backend="cuda")
    d = torch.randn(n, m, dtype=torch.float64, requires_grad=True)
    spans.enable()
    with spans.span("step"):
        x = solve(fact, d)
        with spans.span("grad"):
            torch.autograd.grad(x, (d, *diags), torch.ones_like(x))
    got = _by_name(spans.snapshot())
    step, grad = got["step"][0], got["grad"][0]
    fwd, bwd = got["solver.solve"][0], got["solver.solve_backward"][0]
    cot = got["solver.diag_cotangents"][0]
    assert fwd["parent"] == step["id"]
    assert bwd["parent"] == grad["id"] and cot["parent"] == bwd["id"]
    assert {r["step"] for r in (fwd, grad, bwd, cot)} == {step["id"]}


def test_a_profiler_turns_spans_on_and_off():
    assert spans.span("x") is spans._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        inside = spans.span("on")
        with inside:
            pass
    assert inside is not spans._OFF
    with spans.span("off"):
        pass
    assert spans.span("x") is spans._OFF
    assert [r["name"] for r in spans.snapshot()] == ["on"]


def test_exported_spans_sit_on_the_trace_clock(tmp_path):
    """Each span's exported start and end lie within 50 us (median) of
    its own profiler record (a user annotation, as ``record_function``
    makes) in a CPU-activity trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(20):
            with spans.span(f"probe.{k}"):
                torch.ones(256).cumsum(0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    mine = {e["name"]: e for e in spans.chrome_events(
        trace["baseTimeNanoseconds"])}
    theirs = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("probe.")}
    assert sorted(mine) == sorted(theirs) and len(mine) == 20
    starts = [abs(mine[k]["ts"] - theirs[k]["ts"]) for k in mine]
    ends = [abs(mine[k]["ts"] + mine[k]["dur"]
                - theirs[k]["ts"] - theirs[k]["dur"]) for k in mine]
    assert statistics.median(starts) < 50, starts
    assert statistics.median(ends) < 50, ends
    e = mine["probe.0"]
    assert e["ph"] == "X" and e["cat"] == "program_span"
    assert set(e["args"]) == {"id", "parent", "step", "device_ms", "counts"}


def test_spans_leave_the_trace_readers_host_ops_as_they_were(tmp_path):
    """The spans' records are annotations: ``read_trace`` counts no span
    as a host op, books no device time to one, and starts its window at
    the first op, not at a span's record."""
    def work():
        with spans.span("outer"):
            time.sleep(0.002)
            with spans.span("inner"):
                torch.ones(64).cumsum(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = read_trace({"traceEvents": events})
    plain = read_trace({"traceEvents": [
        e for e in events if e.get("cat") != "user_annotation"]})
    assert got == plain
    assert not {"outer", "inner"} & set(got["host_ops"])
    assert got["window_ms"] < 2.0
    assert {e["name"] for e in events if e.get("cat") == "user_annotation"} \
        >= {"outer", "inner"}


def test_the_store_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(spans, "KEEP", 3)
    spans.enable()
    for k in range(5):
        with spans.span(f"s{k}"):
            pass
    assert [r["name"] for r in spans.snapshot()] == ["s2", "s3", "s4"]


def test_the_fused_step_records_its_spans_on_the_cpu():
    pde = DiffusionCN(n=16, dt=1e-3, backend="fused", device="cpu")
    _, step = pde.step_fn()
    field = torch.randn(16, 8)
    spans.enable()
    for _ in range(3):
        field = step(field)
    got = _by_name(spans.snapshot())
    assert len(got["pde.step"]) == 3 and len(got["fused_cn.params"]) == 3
    roots = {r["id"] for r in got["pde.step"]}
    assert {r["parent"] for r in got["fused_cn.params"]} == roots
    # the CPU runs the plain version: no kernel launch, no kernel span
    assert set(got) == {"pde.step", "fused_cn.params"}


def test_a_train_and_a_prefill_step_record_the_model_spans():
    """``train.step`` around forward, backward and optimizer; remat runs
    the SSD layer again inside the backward; ``prefill.step`` around one
    ``ssm.ssd`` a layer."""
    cfg = get_smoke_config("mamba2-130m")
    model = Model(cfg, device="cpu", seed=0)
    params = model.params.tree()
    opt = AdamW(lr=lambda step: 1e-3)
    sctx = ShardingCtx.local()
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens}
    train = make_train_step(model, sctx, opt)
    prefill = make_prefill_step(model, sctx)
    spans.enable()
    train(params, opt.init(params), batch, 0)
    prefill(params, {"tokens": tokens})
    got = _by_name(spans.snapshot())
    step, pre = got["train.step"][0], got["prefill.step"][0]
    parts = [got[k][0] for k in ("train.forward", "train.backward",
                                 "train.optimizer")]
    assert all(p["parent"] == step["id"] for p in parts)
    fwd, bwd = parts[0], parts[1]
    ssd = got["ssm.ssd"]
    layers = cfg.n_layers
    in_fwd = [r for r in ssd if r["parent"] == fwd["id"]]
    in_bwd = [r for r in ssd if r["step"] == step["id"]
              and r["parent"] != fwd["id"]]
    in_pre = [r for r in ssd if r["step"] == pre["id"]]
    assert len(in_fwd) == layers and len(in_pre) == layers
    assert len(in_bwd) == (layers if cfg.remat else 0)
    assert all(r["parent"] == bwd["id"] for r in in_bwd)
    assert all(r["parent"] == pre["id"] for r in in_pre)


# -- the trace reader's join ---------------------------------------------------

def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "program_span", "name": name, "pid": 7,
            "tid": tid, "ts": ts, "dur": dur, "args": {}}


def test_read_trace_books_device_and_idle_time_by_span():
    """A step (tid 1) holding a kernel span and a backward whose launches
    come from a worker thread (tid 2, one of them inside a span of its
    own, each booked by time to the innermost span open), a launch outside
    every span, and the gaps between."""
    fused = "void fused_cn_tridiag_onchip<float>(float const*)"
    events = [
        _x("cudaLaunchKernel", "cuda_runtime", 12.0, 4.0, correlation=1),
        _x("cudaMemcpyAsync", "cuda_runtime", 20.0, 2.0, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 50.0, 4.0, tid=2,
           correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 70.0, 4.0, tid=2,
           correlation=4),
        _x("cudaLaunchKernel", "cuda_runtime", 200.0, 4.0, correlation=5),
        _x(fused, "kernel", 100.0, 50.0, tid=9, correlation=1),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 160.0, 10.0,
           tid=9, correlation=2),
        _x("elementwise", "kernel", 180.0, 20.0, tid=9, correlation=3),
        _x("reduce", "kernel", 230.0, 10.0, tid=9, correlation=4),
        _x("fill", "gpu_memset", 300.0, 20.0, tid=9, correlation=5),
    ]
    marks = [_span("pde.step", 0.0, 170.0),
             _span("kernel.fused_cn_tridiag", 10.0, 8.0),
             _span("train.backward", 40.0, 130.0),
             _span("solver.solve_backward", 65.0, 15.0, tid=2)]
    plain = read_trace({"traceEvents": events})
    got = read_trace({"traceEvents": events}, spans=marks)
    assert {k: v for k, v in got.items()
            if k not in ("device_ms_by_span", "idle_ms_by_span")} == plain
    assert "device_ms_by_span" not in plain
    assert got["device_ms_by_span"] == pytest.approx({
        "kernel.fused_cn_tridiag": 0.05, "pde.step": 0.01,
        "train.backward": 0.02, "solver.solve_backward": 0.01, None: 0.02})
    # gaps 150-160 (mid 155: train.backward), 170-180 (175: none open),
    # 200-230 (215: none), 240-300 (270: none)
    assert got["idle_ms_by_span"] == pytest.approx({
        "train.backward": 0.01, None: 0.1})
    assert launch_name(fused) == "fused_cn_tridiag"


# -- on the card ---------------------------------------------------------------

_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaMemcpy", "cudaMemcpy2D")


def _cuda_trace(tmp_path, fn):
    """Run ``fn`` under a profile of device activity alone; return the
    trace's events and the program's spans on its clock.  ``fn`` runs once
    before, under a profile that is thrown away, so that nothing in the
    measured run is built, allocated or profiled for the first time."""
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    spans.snapshot()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    records = spans.snapshot()
    marks = spans.chrome_events(trace["baseTimeNanoseconds"], records)
    return trace["traceEvents"], records, marks


def _fused_steps(device, m, steps, kind="tridiag"):
    """``steps`` fused steps at 512 x ``m`` fp32: the diffusion step of
    ``pde.DiffusionCN`` (each a ``pde.step``), or the hyperdiffusion step
    (``fused_cn_penta_step``, each in a root span ``penta.step``)."""
    from repro_torch.core import periodic_penta_factor
    from repro_torch.kernels.fused_cn import fused_cn_penta_step
    n = 512
    if kind == "tridiag":
        _, step = DiffusionCN(n=n, dt=0.8 / n ** 2, backend="fused",
                              device=device).step_fn()
    else:
        sg = 0.1
        pf = periodic_penta_factor(*(torch.full((n,), v, device=device)
                                     for v in (sg, -4 * sg, 1 + 6 * sg,
                                               -4 * sg, sg)))

        def step(field):
            with spans.span("penta.step"):
                return fused_cn_penta_step(pf, sg, field)
    field = torch.randn(n, m, device=device)
    step(field)                                  # build and warm up
    torch.cuda.synchronize()

    def run():
        f = field
        for _ in range(steps):
            f = step(f)
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("kind,root", [("tridiag", "pde.step"),
                                       ("penta", "penta.step")])
def test_host_sync_counts_the_traced_syncs_where_they_happen(
        cuda_device, tmp_path, kind, root):
    """20 fused steps at 512 x 4096: each span's ``host_sync`` count is the
    number of synchronising runtime calls the trace shows inside it and
    in none of its children."""
    from repro_torch.launch.trace_analysis import _Spans
    events, records, marks = _cuda_trace(
        tmp_path, _fused_steps(cuda_device, 4096, 20, kind))
    found = _Spans(marks)
    traced = [e["ts"] + e["dur"] / 2 for e in events
              if e.get("cat") == "cuda_runtime" and e["name"] in _SYNC_CALLS]
    roots = [r for r in records if r["name"] == root]
    assert len(roots) == 20
    by_id = {m["args"]["id"]: m for m in marks}
    for r in records:
        m = by_id[r["id"]]
        inside = sum(1 for t in traced if found.at(t) == r["name"] and
                     m["ts"] <= t <= m["ts"] + m["dur"])
        assert r["counts"].get(spans.HOST_SYNC, 0) == inside, (r, inside)
    total = sum(r["counts"].get(spans.HOST_SYNC, 0) for r in records)
    assert total == sum(1 for t in traced if found.at(t) is not None)


@pytest.mark.cuda
def test_the_sync_counter_is_set_once_for_a_traced_region(cuda_device):
    """The first root span under a profiler sets torch's sync debug mode;
    later roots find it set and leave it; the first span opened after the
    profiler stops unsets it."""
    run = _fused_steps(cuda_device, 4096, 1)
    modes, armed = [], []
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(3):
            run()
            modes.append(torch.cuda.get_sync_debug_mode())
            armed.append(spans._armed)
    assert modes == [1, 1, 1]
    assert armed[0] is not None and armed == [armed[0]] * 3
    assert spans.span("after") is spans._OFF
    assert torch.cuda.get_sync_debug_mode() == 0 and spans._armed is None
    got = [r["counts"].get(spans.HOST_SYNC, 0) for r in spans.snapshot()
           if r["name"] == "fused_cn.params"]
    assert got == [1, 1, 1]


@pytest.mark.cuda
def test_read_trace_books_a_real_trace_by_span(cuda_device, tmp_path):
    """20 fused steps at 512 x 4096 in a trace of device activity alone:
    every fused kernel is booked to its launch span, the parameters'
    pageable copy to ``fused_cn.params``, all device time to some key,
    and the idle gaps sum to the device's window less its busy time."""
    events, _, marks = _cuda_trace(tmp_path,
                                   _fused_steps(cuda_device, 4096, 20))
    got = read_trace({"traceEvents": events}, spans=marks)
    by_span, by_kernel = got["device_ms_by_span"], got["device_ms_by_kernel"]
    assert by_span["kernel.fused_cn_tridiag"] == pytest.approx(
        by_kernel["fused_cn_tridiag"])
    copies = sum(v for k, v in by_kernel.items()
                 if k.startswith("Memcpy HtoD"))
    assert by_span["fused_cn.params"] >= copies > 0
    assert sum(by_span.values()) == pytest.approx(sum(by_kernel.values()))
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    window_ms = (max(b for _, b in device) - min(a for a, _ in device)) / 1e3
    assert sum(got["idle_ms_by_span"].values()) == pytest.approx(
        window_ms - got["busy_ms"], rel=1e-6, abs=1e-6)


@pytest.mark.cuda
def test_each_launch_span_encloses_its_launch_call(cuda_device, tmp_path):
    """In a trace of device activity alone, every
    ``kernel.fused_cn_tridiag`` span encloses the runtime call that
    launched its kernel, to within 50 us."""
    events, _, marks = _cuda_trace(tmp_path,
                                   _fused_steps(cuda_device, 4096, 20))
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and
             "correlation" in e.get("args", {})}
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and
                      launch_name(e["name"]) == "fused_cn_tridiag"),
                     key=lambda e: e["ts"])
    launches = [calls[k["args"]["correlation"]] for k in kernels]
    mine = sorted((m for m in marks
                   if m["name"] == "kernel.fused_cn_tridiag"),
                  key=lambda m: m["ts"])
    assert len(mine) == len(launches) == 20
    for m, c in zip(mine, launches):
        assert m["ts"] - 50 <= c["ts"], (m, c)
        assert c["ts"] + c["dur"] <= m["ts"] + m["dur"] + 50, (m, c)


@pytest.mark.cuda
def test_a_spans_event_ms_matches_the_profilers_kernel_ms(cuda_device,
                                                          tmp_path):
    """Ten fused kernels at 512 x 2^20 (2 ms each) launched back to back:
    the ``kernel.fused_cn_tridiag`` span around each traced kernel's
    launch call (after the first, whose start may find the device idle)
    reads event ms within 5 % of the profiler's ms for that kernel."""
    from repro_torch.kernels import fused_cn, ops
    from repro_torch.launch.trace_analysis import _Spans
    pde = DiffusionCN(n=512, dt=0.8 / 512 ** 2, device=cuda_device)
    pf = pde.factor()
    operands = (ops.stack_tridiag_lhs(pf.factor).contiguous(),
                pf.z.contiguous(),
                fused_cn.tridiag_params(pf, pde.sigma, torch.float32))
    field = torch.randn(512, 2 ** 20, device=cuda_device)
    fused_cn.fused_cn_tridiag(*operands, field)          # build, warm up
    torch.cuda.synchronize()

    def run():
        for _ in range(10):
            fused_cn.fused_cn_tridiag(*operands, field)
    events, _, marks = _cuda_trace(tmp_path, run)
    found = _Spans(marks)
    ms = {m["ts"]: m["args"]["device_ms"] for m in marks}
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and
             "correlation" in e.get("args", {})}
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and
                      launch_name(e["name"]) == "fused_cn_tridiag"),
                     key=lambda e: e["ts"])
    pairs = []
    for k in kernels:
        c = calls[k["args"]["correlation"]]
        t = c["ts"] + c["dur"] / 2
        around = [m for m in marks if m["ts"] <= t <= m["ts"] + m["dur"]]
        assert [m["name"] for m in around] == ["kernel.fused_cn_tridiag"]
        assert found.at(t) == "kernel.fused_cn_tridiag"
        pairs.append((ms[around[0]["ts"]], k["dur"] / 1e3))
    assert len(marks) == 10 and len(pairs) >= 9
    for got, want in pairs[1:]:
        assert abs(got - want) <= 0.05 * want, (got, want)
