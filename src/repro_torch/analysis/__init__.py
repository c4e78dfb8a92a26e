"""``repro_torch.analysis`` — verification of the port's sweep layer.

Counterpart of ``repro.analysis``.  The declarative engine
(``kernels/engine.py``) makes every sweep kernel a table lookup, and the
route rules (``kernels/ops.py``, ``kernels/fused_cn.py``) cut every
column into the row spans the CUDA kernels sweep: a one-character edit to
either can break bit-exactness, the traffic model or the write coverage
with no error.  The checkers:

  * ``speccheck`` — the structural invariants of the pass tables (carry
    lags bounded by the order, coefficient rows inside the stacked LHS,
    exactly one inverse-diagonal scale per pass pair, canonical
    subtraction order, transposed and reversed twins the same machine),
    the bf16 storage pricing and the sharded backend's per-rank traffic,
    and the traffic model against ``capture``'s operand recount (what each
    kernel's entry point is handed and returns, at fp32 and bf16).
  * ``gridcheck`` — every route rule's row spans at every N it can pick:
    a bijection onto [0, N) in order, reads inside the operand, even
    splits, shared memory; on the card held against each CUDA source's
    ``<source>_spans`` export, the kernels' own span helpers.
  * ``tracecheck`` — the host-sync contract: every pure backend x mode x
    boundary condition solved, transposed and differentiated under a
    dispatch mode that raises on the first value brought to the host (on
    the card also under ``torch.cuda.set_sync_debug_mode("error")``),
    ``SolveMeta`` hashable, the gated recurrences alike; then ``lint``, an
    AST lint of the calls that bring a value to the host in the solve
    packages (``# speclint: allow-concretize`` marks a host-side site).
  * ``carryprobe`` — on the card, the partitioned routes' carry
    workspace: a NaN- and a zero-filled workspace give the same finite
    output, and a sentinel in a row block's entry carries changes that
    block's rows and nothing else.
  * ``mutation`` — a self-test that seeds one defect per class in the
    real port objects and requires its checker to report it (eight
    classes on the CPU, two more on the card for ``carryprobe``).
  * ``nansweep`` — a registry-driven sweep of every spec over every route
    the port has for it, at ragged, dead-lane and aligned shapes: on the
    CPU each route's plain version under a dispatch mode that raises on
    the first non-finite intermediate (the counterpart of
    ``jax_debug_nans``); on the card the kernels with the route forced,
    each output buffer filled with NaN first and fenced by NaN guards.

What has no counterpart: the reference's capture of ``pl.pallas_call``
records and its VMEM recount (the port traces no kernel; ``capture``
recounts operands) and its streamed and fused sibling specs.

CLI: ``python -m repro_torch.analysis`` (add ``--self-test`` /
``--nan-sweep`` / ``--all``, and ``--device cpu`` off the card).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verification failure: which checker, on what, and why."""

    checker: str   # "speccheck" | "gridcheck" | "tracecheck" | "astlint"
                   # | "nansweep" | "carryprobe" | "mutation"
    subject: str   # spec name, rule[n= …], backend/mode combo, file:line
    message: str

    def __str__(self) -> str:
        return f"[{self.checker}] {self.subject}: {self.message}"


def run_all(verbose: bool = False, device: str = "cuda") -> list:
    """Every checker over the full current registry and route rules, on
    ``device`` (``"cuda"``, the default, raises without a card, and adds
    ``carryprobe``; the CPU runs the plain versions and gridcheck's Python
    leg); returns the findings (empty: clean)."""
    from . import carryprobe, gridcheck, speccheck, tracecheck

    findings = []
    runners = [("speccheck", speccheck.run),
               ("gridcheck", lambda: gridcheck.run(device)),
               ("tracecheck", lambda: tracecheck.run(device))]
    if device == "cuda":
        runners.append(("carryprobe", carryprobe.run))
    for name, runner in runners:
        got = runner()
        if verbose:
            print(f"{name}: {len(got)} finding(s)")
        findings.extend(got)
    return findings


__all__ = ["Finding", "run_all"]
