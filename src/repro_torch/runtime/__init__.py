"""Fault-tolerance runtime (counterpart of ``repro.runtime``): the straggler
monitor, the retry wrapper and heartbeats.  ``compression``, ``elastic``
and ``pipeline`` wait for ROADMAP Queue 1 item 5."""

from .fault import Heartbeat, StragglerMonitor, with_retries

__all__ = ["Heartbeat", "StragglerMonitor", "with_retries"]
