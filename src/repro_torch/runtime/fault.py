"""Fault-tolerance runtime: straggler detection, retry wrapper, heartbeats.

Counterpart of ``repro.runtime.fault`` (plain Python, the same classes).
At 1000+ nodes the failure model is: slow host (straggler), dead host
(heartbeat timeout), transient error (preemption/network).  The remedies
wired into ``launch/train.py``:
  * transient  -> ``with_retries`` around the step (the step is a pure
                  function of its inputs, so a retry sees no half-updated
                  state);
  * straggler  -> ``StragglerMonitor`` flags; remedy = elastic re-mesh
                  without the slow host (``runtime/elastic.py``);
  * dead host  -> heartbeat timeout -> restart from the latest committed
                  checkpoint (``ckpt/`` is atomic + auto-resume).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flags hosts persistently slower than the
    fleet median by ``threshold``x."""

    threshold: float = 1.5
    alpha: float = 0.2
    patience: int = 5

    def __post_init__(self):
        self._ewma: dict[int, float] = {}
        self._strikes: dict[int, int] = {}

    def update(self, host_times: dict[int, float]) -> list[int]:
        for h, t in host_times.items():
            prev = self._ewma.get(h, t)
            self._ewma[h] = (1 - self.alpha) * prev + self.alpha * t
        if len(self._ewma) < 2:
            return []
        med = sorted(self._ewma.values())[len(self._ewma) // 2]
        flagged = []
        for h, v in self._ewma.items():
            if v > self.threshold * med:
                self._strikes[h] = self._strikes.get(h, 0) + 1
                if self._strikes[h] >= self.patience:
                    flagged.append(h)
            else:
                self._strikes[h] = 0
        return flagged


def with_retries(fn: Callable, *, max_retries: int = 3, backoff_s: float = 0.5,
                 retriable=(RuntimeError, OSError), on_retry=None):
    """Wrap a step function against transient failures."""
    def wrapped(*a, **kw):
        err = None
        for attempt in range(max_retries + 1):
            try:
                return fn(*a, **kw)
            except retriable as e:   # pragma: no cover - timing dependent
                err = e
                if on_retry:
                    on_retry(attempt, e)
                time.sleep(backoff_s * (2 ** attempt))
        raise err
    return wrapped


class Heartbeat:
    """File-based liveness: each host touches its file; the coordinator
    treats silence > timeout as host death (triggering elastic restart)."""

    def __init__(self, directory: str, host_id: int):
        self.path = os.path.join(directory, f"host_{host_id}.hb")
        os.makedirs(directory, exist_ok=True)
        self.host_id = host_id

    def beat(self, step: int):
        with open(self.path, "w") as f:
            json.dump({"step": step, "t": time.time()}, f)

    @staticmethod
    def dead_hosts(directory: str, timeout_s: float) -> list[int]:
        now = time.time()
        dead = []
        if not os.path.isdir(directory):
            return dead
        for fn in os.listdir(directory):
            if not fn.endswith(".hb"):
                continue
            try:
                with open(os.path.join(directory, fn)) as f:
                    t = json.load(f)["t"]
            except Exception:
                t = 0
            if now - t > timeout_s:
                dead.append(int(fn.split("_")[1].split(".")[0]))
        return sorted(dead)
