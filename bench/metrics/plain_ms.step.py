"""Backend, fused CN step: device ms a step outside the hand kernels."""

from benchkit.readers import plain_ms_outside_hand as read  # noqa: F401
