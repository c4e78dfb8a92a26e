"""The measured window: steps dispatched ahead, timed by CUDA events.

An event is recorded before the first step and after every step; the
window runs from the first event to the last, and a step's time is the
interval between the events on either side of it, so a stall or a gap in
the host's dispatch shows in it.  The host never waits for the device
inside the window except to stay at most ``depth`` steps ahead of it (it
waits for the event ``depth`` steps back, while the device still has
those steps queued).  The host's own time to enqueue each step is
recorded beside.  What set-up made is frozen out of the garbage
collector's scans while the window is open.
"""

from __future__ import annotations

import dataclasses
import gc
import time


@dataclasses.dataclass
class Window:
    steps: int          # steps completed in the window
    window_s: float     # first event to last
    step_ms: list       # each step's interval
    host_ms: list       # each step's enqueue time on the host


def measure(step, seconds: float, *, depth: int, device) -> Window:
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` of host time
    have passed, then wait for the device.  On a CPU device (the tests)
    the steps run as they are called and the host clock times them."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    host_ms, marks = [], []
    # set-up's objects go to the permanent generation: the collector still
    # frees the steps' own cycles, but no longer rescans the whole heap
    gc.collect()
    gc.freeze()
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[0].record()
    else:
        marks.append(time.perf_counter())
    t0 = time.perf_counter()
    i = 0
    while True:
        h = time.perf_counter()
        step(i)
        host_ms.append((time.perf_counter() - h) * 1e3)
        i += 1
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            if i > depth:
                marks[i - depth].synchronize()
        else:
            marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    gc.unfreeze()
    if cuda:
        marks[-1].synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        window_s = marks[0].elapsed_time(marks[-1]) / 1e3
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        window_s = marks[-1] - marks[0]
    return Window(i, window_s, step_ms, host_ms)


def p95(values: list) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    k = max(0, -(-95 * len(s) // 100) - 1)
    return s[k]
