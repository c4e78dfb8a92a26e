"""The 95th percentile (nearest rank) over every step of the window of
a step's time: the interval between the CUDA events recorded at the step
boundaries on either side of it."""

from benchkit.window import p95


def read(run):
    return p95(run.window.step_ms)
