"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, the metrics."""

from __future__ import annotations

import dataclasses
import importlib
import subprocess
import sys
import time

from . import trace, window
from .check import verdict

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    config: dict
    workload: dict
    setup_s: float
    window: window.Window
    peak_bytes: int
    units_per_step: float
    floors: dict
    card: object = None          # benchkit.cards.Card, None off the card
    trace: dict | None = None    # trace.summarize of the traced steps
    trace_steps: int = 0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def smi() -> str:
    """The card's name, power limit, clocks, draw and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cell(config: dict, workload: dict, ref, *, seed: int,
             seconds: float, traced: bool, device: str, t0: float,
             control: bool = False):
    """Set the cell up, measure, trace if asked, compare.  Returns
    ``(Run, correct, rows, attempted)``; ``rows`` are (name, number,
    limit)."""
    import torch

    kind = importlib.import_module(f"benchkit.kinds.{workload['driver']}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sut = kind.Cell(config, workload, seed, device, ref, control=control)
    setup_s = time.time() - t0
    win = window.measure(sut.step, seconds, depth=workload["depth"],
                         device=device)
    sut.close()
    summary, n_traced = None, 0
    if traced:
        # the traced steps start with as many steps in flight as the window
        # allows (``depth``, enqueued untraced), so the profiler's own cost
        # on the host does not starve the device at their start
        n_traced, ahead = workload["trace_steps"], workload["depth"]
        for i in range(ahead):
            sut.step(win.steps + i)
        start = win.steps + ahead
        summary = trace.profile(
            lambda: [sut.step(start + i) for i in range(n_traced)])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(config, workload, setup_s, win, peak,
              sut.units_per_step, sut.floors, trace=summary,
              trace_steps=n_traced)
    # the references' fp32 products stay fp32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    correct, rows = verdict(sut.check(), workload["limits"])
    return run, correct, rows, sut.attempted
