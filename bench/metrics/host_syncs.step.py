"""Front end, fused CN step: blocking host synchronisations a traced
step, the program's ``host_sync`` count over every span of each
``pde.step``."""

from benchkit.spans import count


def read(run):
    return count(run, "host_sync", "pde.step")
