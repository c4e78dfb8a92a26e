"""End to end, `cn-diffusion.adjoint`: unknowns solved a second, N x M
for each of the two solves (forward and adjoint) of every iteration the
window completed, over its seconds."""

from benchkit.readers import rate as read  # noqa: F401
