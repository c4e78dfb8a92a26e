"""What the metric readers under ``bench/metrics/`` compute, one function
a quantity.  A quantity that cells with different end-to-end metrics
report has a file a kind of cell (``idle_share.step``,
``idle_share.train``, ...), each naming its function here, so that each
moves the end-to-end metric of its own cells.  Each returns None where
the run has nothing to read."""


def rate(run):
    """Work a second: the work of one step (unknowns or tokens) times
    every step the window completed, over the window's seconds (CUDA
    events, first step to last)."""
    return run.units_per_step * run.window.steps / run.window.window_s


def host_ms(run):
    """The host's time to enqueue one step (no sync inside it), the mean
    over the window's steps, from the benchmark's own span around each
    step call (host clock)."""
    ms = run.window.host_ms
    return sum(ms) / len(ms) if ms else None


def plain_ms_outside_hand(run):
    """Device ms a step outside the port's hand kernels (the stencil, the
    periodic correction, the cotangents, copies, fills), from the traced
    steps."""
    if not run.trace or not run.trace_steps:
        return None
    ms = sum(v for k, v in run.trace["class_ms"].items()
             if not k.startswith("hand:"))
    return ms / run.trace_steps


def plain_ms_other(run):
    """Device ms a step in elementwise, copy and fill kernels (the trace's
    ``other`` class: neither a hand kernel nor a GEMM)."""
    if not run.trace or not run.trace_steps:
        return None
    return run.trace["class_ms"].get("other", 0.0) / run.trace_steps


def idle_share(run):
    """The share of the traced window in which no operation ran on the
    device, in %: 1 - the union of the device ops over the window from the
    first traced device op's start to the last one's end."""
    if not run.trace or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mfu(run):
    """The whole step's useful FLOPs over the window's seconds a step
    times the card's bf16 peak, in %.  The FLOPs are reckoned from the
    configuration and the cell's batch and sequence (``benchkit.floors.
    mamba2_step_flops``), never from what the program ran."""
    if not run.card or not run.window.steps:
        return None
    step_s = run.window.window_s / run.window.steps
    return 100.0 * run.floors["flops"] / (step_s * run.card.bf16_flops)


def recur_roofline(run):
    """The recurrence kernel's share of its roofline, in %: the byte floor
    of the scans a step needs (each layer's chunk states read once and
    running states written once, forward and, in training, adjoint) over
    the card's memory rate, divided by the traced device ms a step of the
    ``recur*`` launches.  Nothing when none ran."""
    if not run.trace or not run.card:
        return None
    ms = sum(v for k, v in run.trace["hand_ms"].items()
             if k.startswith("recur"))
    if not ms:
        return None
    floor_ms = run.floors["recur_bytes"] / run.card.hbm_bytes_s * 1e3
    return 100.0 * floor_ms / (ms / run.trace_steps)
