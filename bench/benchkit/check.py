"""What decides ``correct``: numbers compared with the plain reference,
each beside its limit (the workload file's ``limits``)."""

from __future__ import annotations

import math
import random


def sample_steps(seed: int, count: int, span: int) -> list:
    """Step 0 and ``count - 1`` further steps drawn from the seed in
    [1, span): the window steps whose answers are compared."""
    rng = random.Random(seed)
    return sorted({0, *rng.sample(range(1, span), count - 1)})


def rel_max(got, want) -> float:
    """max |got - want| over max |want|, in fp64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def norm_gap(got: list, want: list, keep=None) -> float:
    """The worst leaf's gap between two lists of per-leaf norms: |got -
    want| over the larger of that leaf's reference norm and the median
    leaf's; ``keep`` (a list of bools) leaves some leaves out."""
    want_sorted = sorted(want)
    median = want_sorted[len(want_sorted) // 2]
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if keep is not None and not keep[i]:
            continue
        gap = abs(g - w) / max(w, median)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number finite and within
    its limit, and a limit for every number."""
    rows = [(k, float(v), float(limits[k])) for k, v in numbers.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and set(numbers) == set(limits), rows
