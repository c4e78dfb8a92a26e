"""Front end, fused CN step: the host's ms to enqueue one step."""

from benchkit.readers import host_ms as read  # noqa: F401
