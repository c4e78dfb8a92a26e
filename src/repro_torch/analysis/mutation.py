"""Mutation self-test: prove the checkers actually catch defects.

Counterpart of ``repro.analysis.mutation``.  A checker that never fires is
indistinguishable from one that works, so this module seeds one
representative defect per class the checkers claim to cover, by patching
the REAL port object in place (a pass table entry, a span function, a
method, the eps plumbing), runs the checker that owns the class and
requires a finding that names it.  Each mutation is a context manager
that puts the original object back, the very same one, however the probe
ends.  Everything runs on the CPU (``tracecheck`` at ``device="cpu"``,
``gridcheck``'s Python leg).

Defect classes:

  1. **swapped-subtraction-order** — the penta forward pass's terms
     reversed: right in exact arithmetic, off the plain versions' and the
     kernels' order; ``speccheck`` ("subtraction order").
  2. **moved-scale** — ``thomas_constant``'s inverse-diagonal scale moved
     from its forward pass to its backward pass; ``speccheck``.
  3. **swapped-gate-lags** — the order-2 recurrence wiring the lag-1 carry
     to the second gate operand; ``speccheck`` ("gate operand").
  4. **stale-traffic-constant** — ``SweepSpec.storage_words`` off by N·M
     (the launch counter's ``traffic_bytes`` is built from it and
     ``compute_words``); ``speccheck``'s operand recount (``capture``,
     "HBM traffic drift").
  5. **span-off-by-one** — ``ops.chunk_bounds`` with each inner bound one
     row on (JAX's off-by-one index map): every row still covered, the
     first part a row long, which past ceil(N / B) overruns the tile;
     ``gridcheck`` ("uneven").
  6. **skipped-ragged-edge** — ``ops.recurrence_windows`` counting its
     windows as ``N // span``: the ragged tail is never walked;
     ``gridcheck`` ("never written").
  7. **onchip-past-smem** — ``ops.onchip_max_rows`` one row on: the tile
     at the rule's last on-chip N overruns shared memory; ``gridcheck``
     ("shared memory").
  8. **baked-host-sync** — ``ops._uniform_eps_param`` reading
     ``eps.item()`` (JAX's baked ``float(eps)``).  Caught twice: by
     ``tracecheck`` on the uniform penta cells and by the lint on the
     mutated ``ops.py`` text; both must fire.

JAX's ``dropped-reset-carry`` and ``forgotten-descend-mirror`` seed Pallas
grid defects (a ``reset_carry`` that does nothing, a fused kernel's output
index map that forgets to mirror the descend walk): the port has no
carry scratch between grid steps and no ascend/descend index map, and
``gridcheck`` has no carry probe (its docstring says why), so they have
no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib

import torch

from repro_torch.kernels import engine, ops

from . import Finding
from . import gridcheck, lint, speccheck, tracecheck


@dataclasses.dataclass(frozen=True)
class MutationResult:
    name: str
    detected: bool
    evidence: tuple  # the matching Finding(s), empty when undetected


# ---------------------------------------------------------------------------
# The seeded defects
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _table_entry(table: dict, key, value):
    orig = table[key]
    table[key] = value
    try:
        yield
    finally:
        table[key] = orig


@contextlib.contextmanager
def _attribute(owner, name: str, value):
    orig = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _swapped_subtraction_order():
    key = (5, False, False)
    fwd, bwd = engine._PASS_TABLE[key]
    return _table_entry(engine._PASS_TABLE, key, (
        engine.PassSpec(tuple(reversed(fwd.terms)), fwd.scale), bwd))


def _moved_scale():
    key = (3, False, False)
    fwd, bwd = engine._PASS_TABLE[key]
    return _table_entry(engine._PASS_TABLE, key, (
        engine.PassSpec(fwd.terms, None), engine.PassSpec(bwd.terms,
                                                          fwd.scale)))


def _swapped_gate_lags():
    return _table_entry(engine._RECUR_TABLE, 2,
                        engine.PassSpec(((1, 1), (0, 2)), None))


def _stale_traffic_constant():
    orig = engine.SweepSpec.__dict__["storage_words"]

    def bad(self, n, m):
        return orig(self, n, m) + n * m

    return _attribute(engine.SweepSpec, "storage_words", bad)


def _span_off_by_one():
    orig = ops.__dict__["chunk_bounds"]

    def bad(n, chunks):
        return [b + (0 < k < chunks) for k, b in enumerate(orig(n, chunks))]

    return _attribute(ops, "chunk_bounds", bad)


def _skipped_ragged_edge():
    def bad(n, chunks, rows):
        span = chunks * rows
        return [[(min(v * span + w * rows, n),
                  min(v * span + (w + 1) * rows, n)) for w in range(chunks)]
                for v in range(n // span)]

    return _attribute(ops, "recurrence_windows", bad)


def _onchip_past_smem():
    orig = ops.__dict__["onchip_max_rows"]
    return _attribute(ops, "onchip_max_rows", lambda dtype: orig(dtype) + 1)


def _baked_host_sync():
    def bad(f, dtype):
        eps = torch.broadcast_to(f.eps, f.beta.shape)
        return torch.full((1,), eps[min(2, eps.shape[0] - 1)].item(),
                          dtype=dtype, device=eps.device)

    return _attribute(ops, "_uniform_eps_param", bad)


def patch_targets() -> dict:
    """Everything the defects patch, by name: the self-test leaves each
    the very object it found."""
    return {
        "engine._PASS_TABLE[(5, False, False)]":
            engine._PASS_TABLE[(5, False, False)],
        "engine._PASS_TABLE[(3, False, False)]":
            engine._PASS_TABLE[(3, False, False)],
        "engine._RECUR_TABLE[2]": engine._RECUR_TABLE[2],
        "engine.SweepSpec.storage_words":
            engine.SweepSpec.__dict__["storage_words"],
        "ops.chunk_bounds": ops.__dict__["chunk_bounds"],
        "ops.recurrence_windows": ops.__dict__["recurrence_windows"],
        "ops.onchip_max_rows": ops.__dict__["onchip_max_rows"],
        "ops._uniform_eps_param": ops.__dict__["_uniform_eps_param"],
    }


# ---------------------------------------------------------------------------
# Per-class detection probes
# ---------------------------------------------------------------------------

#: The source site the lint leg rewrites.
EPS_SITE = "return eps[min(2, eps.shape[0] - 1)].reshape(1).to(dtype)"
EPS_BAKED = ("return torch.full((1,), eps[min(2, eps.shape[0] - 1)].item(), "
             "dtype=dtype)")


def _trace_uniform_penta() -> list:
    """tracecheck restricted to the cells the eps mutation can reach."""
    out: list = []
    with tracecheck.one_rank_group("cpu"):
        for case in tracecheck.contract_cases():
            if case[1] == 5 and case[2] == "uniform":
                out.extend(tracecheck.check_case(*case, device="cpu")[0])
    return out


def _lint_mutated_ops() -> list:
    """The lint on the real ``ops.py`` text with the eps site rewritten to
    read ``.item()``."""
    src = pathlib.Path(ops.__file__).read_text()
    mutated = src.replace(EPS_SITE, EPS_BAKED)
    if mutated == src:
        return [Finding("mutation", "ops.py",
                        "eps site not found: the source-level mutation no "
                        "longer applies; update mutation.EPS_SITE")]
    return lint.lint_source(mutated, "ops.py(mutated)")


def _host_sync_probe() -> list:
    """Both detection layers of the baked host sync must fire."""
    traced = _trace_uniform_penta()
    linted = _lint_mutated_ops()
    if any(f.checker == "mutation" for f in linted):
        return linted  # the mutation itself is broken: surface that
    if not traced or not linted:
        return []  # one layer missed: undetected
    return traced + linted


def _gridcheck() -> list:
    return gridcheck.run("cpu")


_MUTATIONS = (
    ("swapped-subtraction-order", _swapped_subtraction_order,
     speccheck.run, "subtraction order"),
    ("moved-scale", _moved_scale, speccheck.run, "inverse-diagonal scale"),
    ("swapped-gate-lags", _swapped_gate_lags, speccheck.run,
     "gate operand"),
    ("stale-traffic-constant", _stale_traffic_constant, speccheck.run,
     "HBM traffic drift"),
    ("span-off-by-one", _span_off_by_one, _gridcheck, "uneven"),
    ("skipped-ragged-edge", _skipped_ragged_edge, _gridcheck,
     "never written"),
    ("onchip-past-smem", _onchip_past_smem, _gridcheck, "shared memory"),
    ("baked-host-sync", _baked_host_sync, _host_sync_probe, "host"),
)


def self_test(verbose: bool = False) -> list:
    """Run every seeded defect; returns one MutationResult per class."""
    results = []
    for name, mutate, probe, match in _MUTATIONS:
        with mutate():
            findings = probe()
        hits = tuple(f for f in findings if match in f.message)
        results.append(MutationResult(name, bool(hits), hits))
        if verbose:
            mark = "caught" if hits else "MISSED"
            print(f"  {name:28s} {mark} ({len(hits)} finding(s))")
    return results
