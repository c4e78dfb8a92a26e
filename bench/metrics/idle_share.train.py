"""Device, the train cells: the idle share of the traced window, in %."""

from benchkit.readers import idle_share as read  # noqa: F401
