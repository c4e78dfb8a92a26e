"""Model, prefill: device ms a step in elementwise, copy and fill
kernels."""

from benchkit.readers import plain_ms_other as read  # noqa: F401
