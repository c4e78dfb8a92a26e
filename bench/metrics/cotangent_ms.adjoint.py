"""Backend, solve and adjoint: device ms an iteration in the program's
span ``solver.diag_cotangents`` (the three diagonals' gradients, from
the end of the work before it to the end of its own, CUDA events; idle
inside the span included)."""

from benchkit.spans import device_ms


def read(run):
    return device_ms(run, "solver.diag_cotangents")
