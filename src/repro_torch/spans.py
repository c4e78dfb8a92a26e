"""Spans and counts at the port's layer boundaries.

``with span("train.forward"): ...`` marks a layer's work.  While no
profiler runs and ``enable()`` was not called, ``span`` checks two flags
and returns one shared no-op context: nothing is recorded or allocated,
and nothing is called in torch.  While a ``torch.profiler`` runs (any
activities) or after ``enable()``, each span records

  * its name, an id, its parent (the innermost span open on its thread;
    on a thread with none open, such as autograd's worker inside
    ``torch.autograd.grad``, the innermost span open on any thread) and
    its step (the id of its outermost ancestor, its own for a root);
  * its host start and end, ``time.time_ns()``: the clock of the
    profiler's chrome trace, whose event ``ts`` is
    ``(time_ns - baseTimeNanoseconds) / 1e3`` microseconds;
  * a pair of CUDA events (taken from a pool, which the first root span
    with spans on fills to ``READY``, and read only by ``snapshot``, so
    nothing waits inside a step) on the stream that was
    current when its thread's outermost open span began.  The span's
    device time is the stream's time from the end of the work queued
    before it to the end of its own: its kernels, and any time the stream
    waits inside it for the host to queue more;
  * while a profiler runs, a user annotation of its name (as
    ``record_function`` makes, without its operator call), so that a
    profile of CPU activity shows it around the operators it holds, and
    books no device time to it as an operator.

``count(name, n)`` books ``n`` against the innermost open span.  The
port's one counter is ``host_sync``: the first root span opened with
spans on (and torch's sync debug mode unset) sets the mode to ``"warn"``
for as long as spans stay on, and each warning it raises (one a blocking
host synchronisation: a pageable copy, ``.item()``, a stream synchronise)
is counted where it happens and not shown.  The mode is unset again by
``snapshot``, ``disable``, or the first ``span`` or ``count`` called once
spans are off.

``snapshot()`` synchronises the device once, reads the events, returns
the closed spans and clears the store, which keeps the newest ``KEEP``
closed spans; ``chrome_events(base_ns)`` gives a snapshot as chrome-trace
``X`` events on a trace's clock, which
``launch.trace_analysis.read_trace(trace, spans=...)`` joins with the
trace's device ops.

The module imports nothing of the package, so any layer can import it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
import warnings

import torch
from torch._C._autograd import (
    _record_function_with_args_enter as _annotate,
    _record_function_with_args_exit as _annotated)
from torch.autograd import profiler as _prof

#: Counted once a blocking host synchronisation, in the innermost open span.
HOST_SYNC = "host_sync"
#: The closed spans kept for ``snapshot``; older ones are dropped.
KEEP = 1 << 16
#: CUDA events the first root span with spans on makes ready, so that the
#: spans after it rarely create one (a creation is a runtime call, which a
#: profiler of device activity intercepts, inside the traced steps).
READY = 2048
#: The sync debug mode's warning (``c10/cuda/CUDAFunctions.cpp``).
_SYNC_WARNING = "called a synchronizing CUDA operation"
#: What torch says each time the mode is set.
_PROTOTYPE_WARNING = "Synchronization debug mode is a prototype"

_OFF = contextlib.nullcontext()
_on = False
_armed = None         # since the first root span with spans on: the sync
                      # counter (``_SyncCount``), or True if not set
_lock = threading.Lock()
_local = threading.local()
_open: list = []      # spans open on any thread, in the order they opened
_done = collections.deque()   # closed spans, not yet read by ``snapshot``
_pool: list = []      # CUDA events free for reuse
_ids = itertools.count(1)
_cuda: bool | None = None


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _on
    _on = True


def disable() -> None:
    """Record spans only while a profiler runs."""
    global _on
    _on = False
    _disarm()


def span(name: str):
    """A context that records the span ``name`` while spans are on, and
    the shared no-op context otherwise."""
    if not (_on or _prof._is_profiler_enabled):
        if _armed is not None:
            _disarm()
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Book ``n`` of ``name`` against the innermost open span (none when
    spans are off or no span is open)."""
    if not (_on or _prof._is_profiler_enabled):
        if _armed is not None:
            _disarm()
        return
    s = _innermost()
    if s is not None:
        s.counts[name] = s.counts.get(name, 0) + n


def _has_cuda() -> bool:
    global _cuda
    if _cuda is None:
        _cuda = torch.cuda.is_available()
    return _cuda


def _stack() -> list:
    """This thread's open spans."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _innermost():
    stack = _stack()
    if stack:
        return stack[-1]
    with _lock:
        return _open[-1] if _open else None


def _event():
    try:
        return _pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _SyncCount:
    """Sets the sync debug mode and counts its warnings as ``host_sync``
    until ``close``; other warnings pass on to the handler that was
    there."""

    def __init__(self):
        self.caught = warnings.catch_warnings()
        self.caught.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        warnings.filterwarnings("ignore", message=_PROTOTYPE_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING in str(message):
                count(HOST_SYNC)
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")

    def close(self) -> None:
        torch.cuda.set_sync_debug_mode(0)
        self.caught.__exit__(None, None, None)


def _arm() -> None:
    """At the first root span with spans on: fill the event pool to
    ``READY`` and set the sync counter, unless the caller set a sync debug
    mode of its own."""
    global _armed
    stream = torch.cuda.current_stream()
    while len(_pool) < READY:
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)      # creates it
        _pool.append(e)
    _armed = (_SyncCount() if torch.cuda.get_sync_debug_mode() == 0
              else True)


def _disarm() -> None:
    global _armed
    armed, _armed = _armed, None
    if isinstance(armed, _SyncCount):
        armed.close()


class _Span:
    __slots__ = ("name", "id", "parent", "step", "start_ns", "end_ns",
                 "stream", "events", "counts", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        with _lock:
            outer = stack[-1] if stack else (_open[-1] if _open else None)
            self.id = next(_ids)
            _open.append(self)
        cuda = _has_cuda()
        if cuda and not stack:
            _local.stream = torch.cuda.current_stream()
        stack.append(self)
        self.parent = None if outer is None else outer.id
        self.step = self.id if outer is None else outer.step
        self.counts = {}
        if cuda and outer is None and _armed is None:
            _arm()
        self.record = (_annotate(self.name) if _prof._is_profiler_enabled
                       else None)
        self.events = (_event(), _event()) if cuda else None
        self.stream = _local.stream if cuda else None
        self.start_ns = time.time_ns()
        if self.events:
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc) -> bool:
        if self.events:
            self.events[1].record(self.stream)
        self.end_ns = time.time_ns()
        if self.record is not None:
            _annotated(self.record)
        _stack().pop()
        with _lock:
            _open.remove(self)
            _done.append(self)
            if len(_done) > KEEP:
                _done.popleft()
        return False


def snapshot() -> list:
    """The spans closed since the last snapshot (the newest ``KEEP``), in
    the order they closed, and clears them: dicts of ``name``, ``id``,
    ``parent``, ``step``, ``start_ns`` / ``end_ns`` (``time.time_ns()``),
    ``device_ms`` (the events' interval, idle included; None without
    CUDA) and ``counts`` (by counter name).  Unsets the sync counter, and
    synchronises the device once when any span has events."""
    _disarm()
    with _lock:
        done = list(_done)
        _done.clear()
    if any(s.events for s in done):
        torch.cuda.synchronize()
    out = []
    for s in done:
        out.append({"name": s.name, "id": s.id, "parent": s.parent,
                    "step": s.step, "start_ns": s.start_ns,
                    "end_ns": s.end_ns, "device_ms": (
                        s.events[0].elapsed_time(s.events[1])
                        if s.events else None),
                    "counts": s.counts})
        if s.events:
            _pool.extend(s.events)
    return out


def chrome_events(base_ns: int, records: list | None = None) -> list:
    """``records`` (a ``snapshot``; taken now when None) as chrome-trace
    ``X`` events (category ``program_span``, thread 0) on the clock of a
    trace whose ``baseTimeNanoseconds`` is ``base_ns``; ``args`` holds the
    id, parent, step, device ms and the counts."""
    records = snapshot() if records is None else records
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": r["name"],
             "pid": pid, "tid": 0,
             "ts": (r["start_ns"] - base_ns) / 1e3,
             "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
             "args": {"id": r["id"], "parent": r["parent"],
                      "step": r["step"], "device_ms": r["device_ms"],
                      "counts": r["counts"]}}
            for r in records]
