"""``repro_torch.analysis`` — verification of the port's sweep registry.

Counterpart of ``repro.analysis``, its registry half:

  * ``speccheck`` — the structural invariants of ``kernels/engine.py``'s
    pass tables (carry lags bounded by the order, coefficient rows inside
    the stacked LHS, exactly one inverse-diagonal scale per pass pair,
    canonical subtraction order, transposed and reversed twins the same
    machine) and the accounting checks that have a counterpart: the bf16
    storage pricing and the per-rank traffic of the sharded backend.
  * ``nansweep`` — a registry-driven sweep of every spec over every route
    the port has for it, at ragged, dead-lane and aligned shapes: on the
    CPU each route's plain version under a dispatch mode that raises on
    the first non-finite intermediate (the counterpart of
    ``jax_debug_nans``); on the card the kernels with the route forced,
    each output buffer filled with NaN first and fenced by NaN guards, so
    an element no thread writes, or a write outside the output, shows.

The reference's ``capture`` / ``gridcheck`` (Pallas BlockSpec index maps),
``tracecheck`` (the jit contract), ``lint`` and the ``mutation`` self-test
have no counterpart here yet.

CLI: ``python -m repro_torch.analysis`` (add ``--nan-sweep`` / ``--all``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verification failure: which checker, on what, and why."""

    checker: str   # "speccheck" | "nansweep"
    subject: str   # spec name, or spec[route case n= m=]
    message: str

    def __str__(self) -> str:
        return f"[{self.checker}] {self.subject}: {self.message}"


def run_all(verbose: bool = False) -> list:
    """Every static checker over the full current registry; returns the
    findings (empty: the registry is clean)."""
    from . import speccheck

    findings = []
    for name, runner in (("speccheck", speccheck.run),):
        got = runner()
        if verbose:
            print(f"{name}: {len(got)} finding(s)")
        findings.extend(got)
    return findings


__all__ = ["Finding", "run_all"]
