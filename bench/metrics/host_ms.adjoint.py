"""Front end, solve and adjoint: the host's ms to enqueue one iteration."""

from benchkit.readers import host_ms as read  # noqa: F401
