"""End to end, training cells: batch x sequence of every step the window
completed, over its seconds."""

from benchkit.readers import rate as read  # noqa: F401
