"""Model, training: the whole step's useful FLOPs (6 x parameters x
tokens and the SSD's scan terms x 3) over the window's seconds a step
times the bf16 peak, in %."""

from benchkit.readers import mfu as read  # noqa: F401
