"""What the program's own spans and counts say of the traced steps.

The port records spans at its layer boundaries while a profiler runs
(``repro_torch.spans``): each span's name, parent, step (its outermost
span), the device ms between a pair of CUDA events around it, and counts
booked against it (``host_sync``, one a blocking host synchronisation).
The benchmark traces ``trace_steps`` steps after the window, so the
spans recorded in the run are those of the traced steps; they are read
once, after the trace, and kept on the run (``program_spans``).  A
program without ``repro_torch.spans`` records none, and every reader
here then returns None.
"""

from __future__ import annotations


def records(run) -> list | None:
    """The program's spans of the run (``repro_torch.spans.snapshot()``,
    taken at the first call and kept on ``run``), or None when the
    program has no spans."""
    if "program_spans" not in vars(run):
        try:
            from repro_torch import spans
        except ImportError:
            run.program_spans = None
        else:
            run.program_spans = spans.snapshot()
    return run.program_spans


def device_ms(run, name: str):
    """Device ms a traced step in the spans named ``name``: their CUDA
    event intervals summed over the run, over ``trace_steps``; None when
    no such span was recorded.  An interval runs from the end of the work
    queued before the span to the end of its own, so it holds the span's
    device work and any time the device waits inside it for the host."""
    ms = [r["device_ms"] for r in records(run) or ()
          if r["name"] == name and r["device_ms"] is not None]
    if not ms or not run.trace_steps:
        return None
    return sum(ms) / run.trace_steps


def count(run, counter: str, step: str):
    """``counter`` a traced step: its counts in every span of the steps
    whose outermost span is named ``step``, over ``trace_steps``; None
    when no such step was recorded."""
    recs = records(run) or ()
    steps = {r["id"] for r in recs if r["name"] == step and
             r["parent"] is None}
    if not steps or not run.trace_steps:
        return None
    return sum(r["counts"].get(counter, 0) for r in recs
               if r["step"] in steps) / run.trace_steps
