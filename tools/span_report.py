#!/usr/bin/env python3
"""What the port's spans cost on the host, what a trace of device
activity alone shows of them, and device and idle ms a step by span for
the four paths the benchmark's cells run, at the cells' sizes.

    python3 tools/span_report.py [--spans 100000] [--out PATH]
    python3 tools/span_report.py --cell mamba2-130m.train_4k [--cell ...]
        [--seed N] [--seconds S]

Run from the root of a checkout on a machine with one CUDA device and
``nvcc`` (the kernels build at first use).  Prints the card's name and
power limit, then one JSON line (also written to ``--out``):

  * ``costs``: host µs a span, the median of five turns of ``--spans``
    empty spans (``with span("x"): pass``) less the same loop around the
    shared no-op context: off; on (``spans.enable()``) nested inside an
    open root span, two CUDA events each; a tenth as many root spans on,
    the first of which sets the sync debug mode (``host_sync``) for the
    rest; a tenth as many nested spans under a profiler of device activity
    alone, as the
    benchmark's traced steps run them (each also enters a profiler
    record); and ``snapshot()`` a span;
  * ``device_only_trace``: ten spans around one small kernel each under a
    profiler of device activity alone: whether the trace holds the spans'
    own records, and how far each span's start and end, on the trace's
    clock (``spans.chrome_events``), lie around its kernel's launch call;
  * one entry a path, each warmed up untraced and then traced with device
    activity alone, the trace read with ``launch.trace_analysis.
    read_trace(trace, spans=spans.chrome_events(baseTimeNanoseconds))``:
    each device op booked to the span around its launch call, each idle
    gap to the span open on the host at its midpoint (``None``: outside
    every span), and the spans' own event ms, all a step.  The paths: the
    fused CN step (512 x 2^20 fp32, 50 steps); a shared-factor solve and
    its adjoint through ``torch.autograd.grad`` (512 x 2^20, 10
    iterations); mamba2-130m's training step (published config, remat,
    AdamW with fp32 moments, B 8 x S 4096, 2 steps) and its prefill (B 4 x
    S 32768, 2 steps), with the package's own seeded weights and uniform
    random tokens.

With ``--cell``, the paths are the benchmark's cells instead, run as
``bench/benchkit/cell.py`` runs a traced cell (``bench/`` unchanged: the
cell's set-up from ``--seed``, a window of ``--seconds``, ``depth`` steps
ahead untraced, then ``trace_steps`` traced with device activity alone),
each read as above and with ``by_root``: each root span's event ms and
the idle ms inside it (gaps whose midpoint its host interval holds).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.launch.trace_analysis import read_trace  # noqa: E402


def _profiled(fn, activities=(ProfilerActivity.CUDA,)) -> dict:
    """The chrome trace of ``fn()`` under the profiler."""
    with profile(activities=list(activities)) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _loop_us(n: int, make) -> float:
    """Median over five turns of the host µs one pass of ``with make():
    pass`` takes; the spans of each turn are read (``snapshot``, untimed)
    before the next, so the event pool is warm after the first."""
    turns = []
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with make():
                pass
        turns.append((time.perf_counter_ns() - t0) / n / 1e3)
        spans.snapshot()
    return statistics.median(turns)


def costs(n: int) -> dict:
    def off():
        return spans._OFF
    base = _loop_us(n, off)
    out = {"loop_us": base,
           "off_us": _loop_us(n, lambda: spans.span("x")) - base}
    spans.enable()
    with spans.span("root"):
        out["on_nested_us"] = _loop_us(n, lambda: spans.span("x")) - base
        for _ in range(n):
            with spans.span("x"):
                pass
    t0 = time.perf_counter_ns()
    records = spans.snapshot()
    out["snapshot_us_per_span"] = (time.perf_counter_ns() - t0) / \
        len(records) / 1e3
    out["on_root_us"] = _loop_us(n // 10, lambda: spans.span("x")) - base
    spans.disable()
    with profile(activities=[ProfilerActivity.CUDA]):
        with spans.span("root"):
            out["profiled_nested_us"] = _loop_us(
                n // 10, lambda: spans.span("x")) - base
    spans.snapshot()
    return out


def device_only_trace() -> dict:
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()

    def probes():
        for k in range(10):
            with spans.span(f"probe.{k}"):
                x.mul_(1.0)
    trace = _profiled(probes)
    events = trace["traceEvents"]
    marks = sorted(spans.chrome_events(trace["baseTimeNanoseconds"]),
                   key=lambda e: e["ts"])
    calls = sorted((e for e in events if e.get("cat") == "cuda_runtime" and
                    e["name"].startswith("cudaLaunchKernel")),
                   key=lambda e: e["ts"])
    lead = [c["ts"] - m["ts"] for m, c in zip(marks, calls)]
    tail = [m["ts"] + m["dur"] - c["ts"] - c["dur"]
            for m, c in zip(marks, calls)]
    return {"annotations_in_trace": sum(
                1 for e in events if str(e.get("name", "")).startswith(
                    "probe.")),
            "spans": len(marks), "launch_calls": len(calls),
            "span_start_before_launch_us": lead,
            "span_end_after_launch_us": tail}


def traced(step, steps: int, activities=(ProfilerActivity.CUDA,)) -> dict:
    """``step(i)`` for ``steps`` steps under the profiler; ms a step by
    span, the busy union a step, and the spans' own device ms a step."""
    trace = _profiled(lambda: [step(i) for i in range(steps)], activities)
    records = spans.snapshot()
    got = read_trace(trace, spans=spans.chrome_events(
        trace["baseTimeNanoseconds"], records))
    own: dict = {}
    for r in records:
        if r["device_ms"] is not None:
            own[r["name"]] = own.get(r["name"], 0.0) + r["device_ms"]

    def per_step(ms: dict) -> dict:
        return {str(k): v / steps for k, v in
                sorted(ms.items(), key=lambda kv: -kv[1])}
    return {"steps": steps, "busy_ms": got["busy_ms"] / steps,
            "device_ms_by_span": per_step(got.get("device_ms_by_span", {})),
            "idle_ms_by_span": per_step(got.get("idle_ms_by_span", {})),
            "span_event_ms": per_step(own)}


def _by_root(events: list, marks: list) -> list:
    """Each root span's name, event ms and the idle ms between device ops
    whose midpoint lies inside its host interval."""
    busy = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    gaps, end = [], None
    for a, b in busy:
        if end is not None and a > end:
            gaps.append(((a + end) / 2, (a - end) / 1e3))
        end = b if end is None else max(end, b)
    roots = sorted((m for m in marks if m["args"]["parent"] is None),
                   key=lambda m: m["ts"])
    return [{"name": m["name"], "event_ms": m["args"]["device_ms"],
             "idle_ms": sum(ms for t, ms in gaps
                            if m["ts"] <= t <= m["ts"] + m["dur"])}
            for m in roots]


def bench_cell(name: str, seed: int, seconds: float) -> dict:
    """The benchmark's traced window of the cell ``name``, read by span."""
    import importlib
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench"))
    from benchkit import manifest, window
    bench = manifest.load_manifest()
    conf_file = manifest.ROOT / manifest.config_entry(
        bench, manifest.cell(bench, name)["config"])["file"]
    wl = manifest.read_json(manifest.workload_file(name))
    kind = importlib.import_module(f"benchkit.kinds.{wl['driver']}")
    sut = kind.Cell(manifest.read_json(conf_file), wl, seed, "cuda",
                    manifest.reference(conf_file))
    win = window.measure(sut.step, seconds, depth=wl["depth"],
                         device="cuda")
    sut.close()
    for i in range(wl["depth"]):
        sut.step(win.steps + i)
    start, steps = win.steps + wl["depth"], wl["trace_steps"]
    spans.snapshot()
    trace = _profiled(lambda: [sut.step(start + i) for i in range(steps)])
    records = spans.snapshot()
    marks = spans.chrome_events(trace["baseTimeNanoseconds"], records)
    got = read_trace(trace, spans=marks)
    own: dict = {}
    for r in records:
        if r["device_ms"] is not None:
            own[r["name"]] = own.get(r["name"], 0.0) + r["device_ms"]

    def per_step(ms: dict) -> dict:
        return {str(k): v / steps for k, v in
                sorted(ms.items(), key=lambda kv: -kv[1])}
    by_root = _by_root(trace["traceEvents"], marks)
    return {"steps": steps, "window_steps": win.steps,
            "window_ms_a_step": win.window_s * 1e3 / max(win.steps, 1),
            "busy_ms": got["busy_ms"] / steps,
            "device_ms_by_span": per_step(got.get("device_ms_by_span", {})),
            "idle_ms_by_span": per_step(got.get("idle_ms_by_span", {})),
            "span_event_ms": per_step(own),
            "by_root": by_root if len(by_root) <= 20 else by_root[:10]}


def cn_step(device, n: int, m: int):
    from repro_torch.pde import DiffusionCN
    _, step = DiffusionCN(n=n, dt=0.8 / n ** 2, backend="fused",
                          device=device).step_fn()
    field = [torch.randn(n, m, device=device)]

    def run(i):
        field[0] = step(field[0])
    return run


def cn_adjoint(device, n: int, m: int):
    from repro_torch.solver import BandedSystem, factorize, solve
    s = 0.4
    diags = tuple(torch.full((n,), v, device=device, requires_grad=True)
                  for v in (-s, 1 + 2 * s, -s))
    fact = factorize(BandedSystem.tridiag(*diags, n=n, periodic=True,
                                          device=device), backend="cuda")
    pool = [(torch.randn(n, m, device=device).requires_grad_(),
             torch.randn(n, m, device=device)) for _ in range(2)]

    def run(i):
        d, g = pool[i % 2]
        torch.autograd.grad(solve(fact, d), (d, *diags), g)
    return run


def lm(device, kind: str, batch: int, seq: int, cfg=None):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.sharding import ShardingCtx
    from repro_torch.train import (AdamW, make_prefill_step, make_train_step,
                                   warmup_cosine)
    cfg = cfg or get_config("mamba2-130m")
    model = Model(cfg, device=device, seed=0)
    params = model.params.tree()
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen,
                           device=device)
    sctx = ShardingCtx.local()
    if kind == "prefill":
        prefill = make_prefill_step(model, sctx)

        def run(i):
            prefill(params, {"tokens": tokens[:, :-1]})
        return run
    opt = AdamW(lr=warmup_cosine(3e-3, 5, 10000), opt_dtype=torch.float32)
    train = make_train_step(model, sctx, opt)
    state = [params, opt.init(params)]
    batch_ = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def run(i):
        state[0], state[1], _ = train(*state, batch_, i)
    return run


PATHS = {"cn_step": (lambda d: cn_step(d, 512, 2 ** 20), 3, 50),
         "cn_adjoint": (lambda d: cn_adjoint(d, 512, 2 ** 20), 2, 10),
         "train_4k": (lambda d: lm(d, "train", 8, 4096), 2, 2),
         "prefill_32k": (lambda d: lm(d, "prefill", 4, 32768), 1, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", type=int, default=100_000)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--cell", action="append", default=[],
                    help="a benchmark cell to run instead of the paths")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    torch.ones(1, device="cuda")
    result = {"card": smi, "torch": torch.__version__,
              "costs": costs(args.spans)}
    for name in args.cell:
        result[name] = bench_cell(name, args.seed, args.seconds)
        gc.collect()
        torch.cuda.empty_cache()
    if args.cell:
        return _report(result, args.out)
    result["device_only_trace"] = device_only_trace()
    for name, (make, warm, steps) in PATHS.items():
        step = make("cuda")
        for i in range(warm):
            step(i)
        torch.cuda.synchronize()
        spans.snapshot()
        result[name] = traced(lambda i: step(warm + i), steps)
        del step
        torch.cuda.empty_cache()
    return _report(result, args.out)


def _report(result: dict, out: Path | None) -> int:
    line = json.dumps(result)
    print(line)
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
