"""End to end, `cn-diffusion.step`: unknowns solved a second, N x M for
every step of the whole batch the window completed, over its seconds."""

from benchkit.readers import rate as read  # noqa: F401
