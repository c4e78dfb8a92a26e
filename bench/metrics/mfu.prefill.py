"""Model, prefill: the whole step's useful FLOPs (2 x parameters x tokens,
the head at the last token, the SSD's scan terms) over the window's
seconds a step times the bf16 peak, in %."""

from benchkit.readers import mfu as read  # noqa: F401
