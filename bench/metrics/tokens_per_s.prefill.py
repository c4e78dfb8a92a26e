"""End to end, prefill cells: batch x sequence of every prefill the window
completed, over its seconds."""

from benchkit.readers import rate as read  # noqa: F401
