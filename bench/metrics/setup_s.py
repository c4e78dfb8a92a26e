"""Seconds from the process's start to the first timed step: imports,
loading the built kernels, the seeded data and weights, the factor or
model, and warm-up (host clock)."""


def read(run):
    return run.setup_s
