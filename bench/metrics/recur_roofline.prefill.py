"""Kernel, prefill: the recurrence kernel's share of the floor of the
forward scans, in %."""

from benchkit.readers import recur_roofline as read  # noqa: F401
