"""Read a ``torch.profiler`` trace: device time by class and kernel, the
busy union, the longest idle gaps by the runtime call (or host op) the
host was in.

The busy-union arithmetic, the class split, the hand kernels' launch names
and the matmul / launcher attribution are a frozen copy of
``src/repro_torch/launch/trace_analysis.py`` (``_symbol``,
``launch_name``, ``_HAND_PREFIXES``, ``_RECURRENCE_SYMBOL``,
``_GEMM_SYMBOL``, ``MATMUL_OPS``, ``_union_us`` and the launcher half of
``_nesting``) at commit 3b55662, so that a change to the program cannot
change how its trace is read.  The profiler's chrome trace is written
under ``TMPDIR`` and deleted once read.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import re
import tempfile

MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
_RECURRENCE_SYMBOL = re.compile(
    r"recurrence(?:_tile)?_kernel<[^,<>]+,\s*[^,<>]+,\s*(\d+),\s*(true|false)")
_HAND_PREFIXES = (("shared_", "shared_sweep"), ("batch_", "batch_sweep"),
                  ("fused_cn_tridiag", "fused_cn_tridiag"),
                  ("fused_cn_penta", "fused_cn_penta"),
                  ("fused_", "fused_cn"))
_GEMM_SYMBOL = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce",
                          re.IGNORECASE)


def _symbol(name: str) -> str:
    """``void (anonymous namespace)::foo<float, 1>(float const*)`` ->
    ``foo<float, 1>``."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].strip()
    head = head[len("void "):] if head.startswith("void ") else head
    base, sep, args = head.partition("<")
    return base.rsplit("::", 1)[-1] + sep + args


def launch_name(kernel: str) -> str | None:
    """The launch name of a hand kernel of the port (``recur1``,
    ``recur1_rev``, ``shared_sweep``, ``batch_sweep``,
    ``fused_cn_tridiag``, ``fused_cn_penta``, ``fused_cn``), or None."""
    sym = _symbol(kernel)
    m = _RECURRENCE_SYMBOL.match(sym)
    if m:
        return f"recur{m.group(1)}" + ("_rev" if m.group(2) == "true" else "")
    for prefix, name in _HAND_PREFIXES:
        if sym.startswith(prefix):
            return name
    return None


def _union(intervals: list) -> list:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union_us(intervals: list) -> float:
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _launched_by(events: list) -> dict:
    """By correlation id, the innermost host op around the runtime call
    that launched a device op (None in a trace without host ops)."""
    by_tid: dict = {}
    for e in events:
        if e.get("cat") in _HOST_CATS:
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    launched_by = {}
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: list = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) \
                    <= e["ts"]:
                stack.pop()
            if e["cat"] in ("cpu_op", "user_annotation"):
                stack.append(e)
            elif "correlation" in e.get("args", {}):
                ops = [o for o in stack if o["cat"] == "cpu_op"]
                launched_by[e["args"]["correlation"]] = \
                    ops[-1]["name"] if ops else None
    return launched_by


def _host_at(host: list, starts: list, t: float) -> str:
    """The innermost host op, annotation or runtime call running at time
    ``t``: the latest-starting one of ``host`` (sorted by start) that
    contains it, looked for among the 4096 that started last before
    ``t``."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - 4096):i]):
        if e["ts"] + e.get("dur", 0) >= t:
            return e["name"]
    return "host idle"


def summarize(events: list) -> dict:
    """``window_s`` (from the first device op's start to the last one's
    end: the device's own span, without the profiler's start-up before
    the first launch), ``busy_s`` (the union of the device ops in it), ``class_ms`` (``hand:<launch name>``,
    ``gemm``, ``collective``, ``other``), ``hand_ms`` and
    ``hand_launches`` by launch name, ``kernel_ms`` by kernel (a hand
    kernel under its launch name), ``top_ops`` and ``idle_gaps`` (each
    at most 10 ``[name, seconds]``, largest first)."""
    events = [e for e in events if e.get("ph") == "X"]
    launched_by = _launched_by(events)
    class_ms: dict = {}
    kernel_ms: dict = {}
    hand_ms: dict = {}
    hand_launches: dict = {}
    busy, host = [], []
    for e in events:
        cat = e.get("cat")
        start, dur = float(e["ts"]), float(e.get("dur", 0))
        if cat in _DEVICE_CATS:
            busy.append((start, start + dur))
            ms = dur / 1e3
            hand = launch_name(e["name"]) if cat == "kernel" else None
            name = hand or (_symbol(e["name"]) if cat == "kernel"
                            else e["name"])
            op = launched_by.get(e.get("args", {}).get("correlation"))
            if hand:
                cls = f"hand:{hand}"
                hand_ms[hand] = hand_ms.get(hand, 0.0) + ms
                hand_launches[hand] = hand_launches.get(hand, 0) + 1
            elif cat == "kernel" and "nccl" in e["name"].lower():
                cls = "collective"
            elif cat == "kernel" and (op in MATMUL_OPS
                                      or _GEMM_SYMBOL.search(e["name"])):
                cls = "gemm"
            else:
                cls = "other"
            kernel_ms[name] = kernel_ms.get(name, 0.0) + ms
            class_ms[cls] = class_ms.get(cls, 0.0) + ms
        elif cat in _HOST_CATS:
            host.append(e)
    window_us = (max(e for _, e in busy) - min(s for s, _ in busy)) \
        if busy else 0.0
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    gaps: dict = {}
    merged = _union(busy)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        who = _host_at(host, starts, (end + nxt) / 2)
        gaps[who] = gaps.get(who, 0.0) + (nxt - end) / 1e6
    return {"window_s": window_us / 1e6, "busy_s": _union_us(busy) / 1e6,
            "class_ms": class_ms, "kernel_ms": kernel_ms,
            "hand_ms": hand_ms, "hand_launches": hand_launches,
            "top_ops": [[k, v / 1e3] for k, v in sorted(
                kernel_ms.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]]}


def profile(fn) -> dict:
    """Run ``fn()`` under ``torch.profiler``, write the chrome trace under
    ``TMPDIR``, read it, delete it, and return ``summarize`` of it.

    Only the device's activity is traced (its ops and the CUDA runtime
    calls that launch them): recording every host op as well slows a
    training step's host past its device (about 2.4 s a step against
    0.97), and the device would idle for the profiler's sake."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events)
