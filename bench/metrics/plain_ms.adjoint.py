"""Backend, solve and adjoint: device ms an iteration outside the hand
kernels (the periodic correction, the cotangents, copies, fills)."""

from benchkit.readers import plain_ms_outside_hand as read  # noqa: F401
