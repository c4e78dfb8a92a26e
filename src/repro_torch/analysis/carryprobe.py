"""carryprobe — the partitioned routes' entry carries, probed on the card.

Counterpart of the carry-protocol probe of ``repro.analysis.gridcheck``
(a sentinel carry at ``k == 0``).  The port's partitioned routes (the
shared sweep's and both fused CN steps') pass each row block's entry
carries from K1–K2 to K3 through a workspace: K2 writes them into the
(B, 2, order, M) carries of ``ops.partition_carries``, K3 reads them.  A
K2 that skipped a block, or a K3 that read another block's carries, would
leave wrong values that no other check sees: ``nansweep`` fills the
output, not the workspace.  So, on every partitioned cell of phase
``analysis`` (every shared spec of the registry, orders 1 and 2 and their
transposed and uniform twins, and both fused steps) at ``N_ROWS`` rows
(three row blocks at float32) and a ragged M, the workspace is handed in
through the wrappers' ``work=`` and:

  * **dead stale state** (JAX's ``reset_carry`` half): the solve run once
    on a NaN-filled workspace and once on a zero-filled one gives finite
    outputs, bitwise equal: nothing K3 reads was left from before K0–K2;
  * **carries take part** (JAX's "carry is actually used" half): K0–K2
    run alone (``partition_stages``), then for each row block b >= 1 its
    entry carries, forward and backward, are overwritten with ``SENTINEL``
    and K3 runs again: the output changes in every column of block b's
    rows and nowhere else.

``analysis.mutation``'s card classes seed the two defects this catches
(a launch that skips K2; a K3 that reads the mirrored block's backward
carries) and require it to.  Runs on the card only: the plain versions
chain the blocks in Python (``ops.chain_blocks``), where block 0's
carries are a literal zero and there is no workspace to seed.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import fused_cn, ops

from . import Finding, nansweep

#: JAX's sentinel carry.
SENTINEL = 0.37
#: Rows and columns of every probed cell: three row blocks at float32 (the
#: last ragged) and a ragged M.
N_ROWS, M_COLS = 2 * nansweep.BLOCK_ROWS + 45, 70


@dataclasses.dataclass
class Probed:
    """What the probe covered, beside its findings."""

    findings: list
    cells: int = 0          # partitioned cells probed
    blocks: int = 0         # row blocks whose carries were seeded
    launches: dict = dataclasses.field(default_factory=dict)


def cells() -> list:
    """``(subject, layout, spec)`` of every partitioned cell: the
    registry's shared specs, then the fused steps."""
    return [(s, lay, sp) for s, lay, sp in nansweep.kinds()
            if lay in ("shared", "fused")]


def geometry(layout: str, spec, n: int, m: int, dtype=torch.float32
             ) -> tuple:
    """``(blocks, order, work elements, launch name)`` of a cell's
    partitioned route at (N, M)."""
    if layout == "shared":
        blocks = ops.shared_route(n, dtype, "partition").row_blocks
        return (blocks, spec.order,
                ops.partition_work_elems(spec.order, blocks, n, m), spec.name)
    kind = spec.split("_")[-1]
    blocks = fused_cn.row_blocks(n, dtype, "partition")
    return (blocks, 1 if kind == "tridiag" else 2,
            fused_cn.work_elems(kind, n, m, blocks),
            fused_cn.launch_name(kind, "partition"))


def _solve(layout: str, spec, args: list, rhs, work) -> torch.Tensor:
    """One counted solve on the partitioned route, on ``work``."""
    if layout == "shared":
        lhs, eps = args
        return ops.shared_sweep_cuda(spec, lhs, rhs, eps, route="partition",
                                     work=work)
    fn = fused_cn.fused_cn_tridiag_cuda if spec == nansweep.FUSED[0] \
        else fused_cn.fused_cn_penta_cuda
    return fn(*args, rhs, route="partition", work=work)


def _stages(layout: str, spec, args: list, rhs, out, work) -> dict:
    if layout == "shared":
        lhs, eps = args
        return ops.partition_stages(spec, lhs, rhs, eps, out=out, work=work)
    return fused_cn.partition_stages(spec.split("_")[-1], *args, rhs,
                                     out=out, work=work)


def probe_cell(subject: str, layout: str, spec, res: Probed) -> None:
    """Both halves of the probe on one cell; findings into ``res``."""
    n, m = N_ROWS, M_COLS
    dev = torch.device("cuda")
    args, rhs = nansweep.operands(layout, spec, n, m)
    args = [None if a is None else a.to(dev).contiguous() for a in args]
    rhs = rhs.to(dev)
    blocks, order, size, name = geometry(layout, spec, n, m, rhs.dtype)
    sub = f"{subject}[partition n={n} m={m} blocks={blocks}]"
    res.cells += 1
    if blocks < 3:
        res.findings.append(Finding("carryprobe", sub,
                                    f"{blocks} row blocks: the probe needs "
                                    "three"))
        return

    # dead stale state: a NaN-filled and a zero-filled workspace
    dirty = _solve(layout, spec, args, rhs, torch.full(
        (size,), float("nan"), dtype=rhs.dtype, device=dev))
    clean = _solve(layout, spec, args, rhs, torch.zeros(
        (size,), dtype=rhs.dtype, device=dev))
    res.launches[name] = res.launches.get(name, 0) + 2
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(dirty).all()) and bool(
        torch.isfinite(clean).all())
    if not finite or not torch.equal(dirty, clean):
        res.findings.append(Finding(
            "carryprobe", sub, "the NaN- and zero-filled workspaces give "
            f"{'non-finite' if not finite else 'different'} outputs: K3 "
            "reads stale state that K0-K2 did not write"))

    # carries take part: each block's entry carries set to the sentinel
    work = torch.zeros((size,), dtype=rhs.dtype, device=dev)
    x = torch.empty_like(clean)
    stages = _stages(layout, spec, args, rhs, x, work)
    for k in ("k0", "k1", "k2"):
        stages[k]()
    carries = ops.partition_carries(work, blocks, order, m)
    kept = carries.clone()
    stages["k3"]()
    base = x.clone()
    spans = ops.split_spans(n, blocks, 1)
    for b in range(1, blocks):
        carries.copy_(kept)
        carries[b] = SENTINEL
        stages["k3"]()
        torch.cuda.synchronize()
        res.blocks += 1
        s, e = spans[b]
        changed = x != base
        inside = changed[s:e].any(0)
        outside = int(changed.sum() - changed[s:e].sum())
        if outside:
            res.findings.append(Finding(
                "carryprobe", f"{sub} block {b}",
                f"the sentinel in block {b}'s entry carries changed {outside} "
                f"output element(s) outside its rows [{s}, {e})"))
        if not bool(inside.all()):
            res.findings.append(Finding(
                "carryprobe", f"{sub} block {b}",
                f"the sentinel in block {b}'s entry carries left "
                f"{int((~inside).sum())} of {m} column(s) of its rows "
                f"[{s}, {e}) unchanged: K3 does not read them"))


def sweep(device: str = "cuda") -> Probed:
    """Every partitioned cell probed; needs the card (there is no plain
    workspace to probe)."""
    if device != "cuda":
        raise ValueError(f"carryprobe runs on the card only, got device "
                         f"{device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("carryprobe needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    res = Probed(findings=[])
    for subject, layout, spec in cells():
        try:
            probe_cell(subject, layout, spec, res)
        except (RuntimeError, ValueError, TypeError) as exc:
            res.findings.append(Finding("carryprobe", subject,
                                        f"raised {type(exc).__name__}: "
                                        f"{exc}"))
    return res


def run(device: str = "cuda") -> list:
    """The findings of ``sweep(device)``."""
    return sweep(device).findings
