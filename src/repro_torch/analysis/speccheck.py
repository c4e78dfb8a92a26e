"""speccheck — structural invariants of the pass tables + accounting audit.

Counterpart of ``repro.analysis.speccheck`` over the port's
``kernels/engine.py``: ``_PASS_TABLE`` (the shared sweeps), ``_BATCH_BWD``
(the batch back substitution), ``_RECUR_TABLE`` (the gated recurrences)
and ``REGISTRY``.  Nothing solves anything.  The CUDA sources read these
tables (``ops.sweep_desc``), so an edit to them changes every kernel.

Structural invariants:

  * every carry lag lies in ``[1, order]`` and each pass touches the full
    lag range (an order-2 sweep that never reads lag 2 is a different —
    wrong — recurrence);
  * every integer coefficient row index addresses a real row of the
    stacked LHS (``< lhs_rows``; batch back-substitution rows
    ``< n_coefs``); the EPS sentinel appears exactly once, and only in
    uniform specs;
  * exactly ONE inverse-diagonal scale across each pass pair, on the
    stored-inverse row (``scale_row``) — forward variants scale the
    forward pass, transposed variants the backward pass (A = L·U vs
    A^T = U^T·L^T);
  * subtraction order is canonical: forward-pass lags strictly
    descending, backward-pass lags strictly ascending (float subtraction
    is not associative; the plain versions and the kernels follow it);
  * the transposed twin is the same machine with the scale moved, and a
    recurrence's reversed twin runs the same pass table;
  * every registry key is its spec's ``name``.

Accounting: ``traffic_bytes`` prices bf16 storage at 2 bytes a stored word
and 4 a computed one, and the per-rank traffic of the sharded backend
(``solver.sharded``: M split as ``Shard(1)``, the factor replicated a
rank) is the single-device count at ``shard_lanes`` columns, the
replicated LHS rows the only words that do not split.

The traffic model is held against an independent recount: the port does
not trace its CUDA sources, so ``capture`` stands in for the reference's
captured Pallas builders by reading what each kernel's entry point is
handed (every spec and both fused CN steps, at the trace size, at fp32
and bf16 storage, the fused steps at fp32 and fp64) and summing the bytes
of every operand read once and of the output written once.  The recount
must equal ``traffic_words`` / ``traffic_bytes`` as the launch counter
books them, and ``fused_cn.{tridiag,penta}_traffic_bytes``: the floors
``kernel_floors`` and the benchmark's bounds read cannot drift from the
operands.  The reference's streamed and fused sibling checks have no
counterpart: the port registers no streamed or fused spec (one Hopper
kernel serves each tiling).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import engine
from repro_torch.kernels.engine import EPS_PARAM, RecurrenceSpec, SweepSpec
from repro_torch.solver.sharded import shard_lanes

from . import Finding, capture
from .capture import TRACE_N, TRACE_M  # the (N, M) the accounting prices


def scale_row(spec: SweepSpec) -> int:
    """Row index of the stored inverse diagonal in the stacked LHS — the
    ONLY row a pass's ``scale`` may point at (0 for the batch layout,
    where the fused factorisation holds the inverse).  Uniform stacks drop
    the eps row, so the inverse sits one row lower on the forward side
    ([beta, inv_alpha, gamma, delta]) but keeps row 2 on the transposed
    side ([delta, gamma, inv_alpha, beta])."""
    if spec.layout == "batch":
        return 0
    if spec.bandwidth == 3:
        return 1
    if spec.uniform and not spec.transposed:
        return 1
    return 2


def _twin(spec):
    """The transposed twin of a shared spec, the reversed twin of a
    recurrence."""
    if isinstance(spec, RecurrenceSpec):
        return dataclasses.replace(spec, reverse=not spec.reverse)
    return dataclasses.replace(spec, transposed=not spec.transposed)


def _lags(pspec) -> tuple:
    return tuple(lag for _src, lag in pspec.terms)


def _check_terms(spec: SweepSpec, pspec, which: str, out: list) -> None:
    """Lag bounds, row bounds, EPS placement, subtraction order."""
    sub = f"{spec.name}.{which}"
    max_row = spec.lhs_rows if spec.layout == "shared" else spec.n_coefs
    for src, lag in pspec.terms:
        if not (1 <= lag <= spec.order):
            out.append(Finding("speccheck", sub,
                               f"carry lag {lag} outside [1, {spec.order}] "
                               f"(order-{spec.order} recurrence)"))
        if src == EPS_PARAM:
            if not spec.uniform:
                out.append(Finding("speccheck", sub,
                                   "EPS parameter term in a non-uniform "
                                   "spec (eps rides a 1-element operand "
                                   "only for cuPentUniformBatch variants)"))
        elif not (isinstance(src, int) and 0 <= src < max_row):
            out.append(Finding("speccheck", sub,
                               f"coefficient row {src!r} outside the "
                               f"stacked LHS (valid rows: 0..{max_row - 1})"))
    lags = _lags(pspec)
    if sorted(lags) != list(range(1, spec.order + 1)):
        out.append(Finding("speccheck", sub,
                           f"pass lags {lags} do not cover the carry range "
                           f"1..{spec.order} exactly once"))
    want = tuple(sorted(lags, reverse=(which == "fwd")))
    if lags != want:
        out.append(Finding("speccheck", sub,
                           f"subtraction order {lags} violates the "
                           f"canonical order {want} (fwd descending / bwd "
                           f"ascending)"))
    if pspec.scale is not None and pspec.scale != scale_row(spec):
        out.append(Finding("speccheck", sub,
                           f"scale row {pspec.scale!r} is not the stored "
                           f"inverse-diagonal row {scale_row(spec)}"))


def _check_structure(spec: SweepSpec, out: list) -> None:
    fwd, bwd = spec.passes()
    if spec.layout == "batch":
        if fwd is not None:
            out.append(Finding("speccheck", spec.name,
                               "batch layout has a forward PassSpec (the "
                               "fused factorisation owns the forward pass)"))
        if bwd.scale is not None:
            out.append(Finding("speccheck", spec.name,
                               "batch back-substitution is scaled (the "
                               "fused factorisation already divided)"))
        _check_terms(spec, bwd, "bwd", out)
        return

    _check_terms(spec, fwd, "fwd", out)
    _check_terms(spec, bwd, "bwd", out)

    # exactly one inverse-diagonal scale, on the transposed-dependent side
    scaled = [name for name, p in (("fwd", fwd), ("bwd", bwd))
              if p.scale is not None]
    want_side = "bwd" if spec.transposed else "fwd"
    if scaled != [want_side]:
        why = ("A^T = U^T*L^T scales back-substitution" if spec.transposed
               else "A = L*U scales forward substitution")
        out.append(Finding(
            "speccheck", spec.name,
            f"inverse-diagonal scale on {scaled or ['neither pass']}, "
            f"expected exactly one on the {want_side} pass ({why})"))

    # EPS placement: uniform specs read eps in the unscaled outer-band term
    eps_in = [name for name, p in (("fwd", fwd), ("bwd", bwd))
              for src, _lag in p.terms if src == EPS_PARAM]
    if spec.uniform:
        want_eps = ["bwd" if spec.transposed else "fwd"]
        if eps_in != want_eps:
            out.append(Finding("speccheck", spec.name,
                               f"EPS parameter read in {eps_in or 'no'} "
                               f"pass(es), expected exactly once in the "
                               f"{want_eps[0]} pass"))
    elif eps_in:
        out.append(Finding("speccheck", spec.name,
                           "non-uniform spec reads the EPS parameter"))


def _check_recurrence_structure(spec: RecurrenceSpec, out: list) -> None:
    """The gate-operand contract: a recurrence is ONE unscaled pass whose
    multiplicative coefficients are per-token gate operands, wired so the
    lag-k carry reads gate operand k-1 (the order ``ops.recurrence``
    passes them), lags ascending — the term order of the kernel and its
    plain version."""
    passes = spec.passes()
    if len(passes) != 1:
        out.append(Finding("speccheck", spec.name,
                           f"recurrence spec runs {len(passes)} passes — a "
                           f"gated recurrence has no back-substitution "
                           f"partner, it must be a single pass"))
        return
    (pspec,) = passes
    sub = f"{spec.name}.pass"
    if pspec.scale is not None:
        out.append(Finding("speccheck", sub,
                           f"recurrence pass is scaled by {pspec.scale!r} — "
                           f"gated recurrences have no stored inverse "
                           f"diagonal"))
    lags = _lags(pspec)
    if lags != tuple(range(1, spec.order + 1)):
        out.append(Finding("speccheck", sub,
                           f"pass lags {lags} are not the ascending carry "
                           f"range 1..{spec.order} (the gate-operand order "
                           f"is the kernel's term order)"))
    for src, lag in pspec.terms:
        if src == EPS_PARAM:
            out.append(Finding("speccheck", sub,
                               "recurrence pass reads the EPS parameter "
                               "(a uniform-penta concept)"))
        elif src != lag - 1:
            out.append(Finding("speccheck", sub,
                               f"lag-{lag} carry reads gate operand {src!r}, "
                               f"expected operand {lag - 1} — the gate "
                               f"operands are wired to the wrong lags"))


def _check_recurrence_twin(spec: RecurrenceSpec, out: list) -> None:
    """The reversed twin is the same machine walked the other way: same
    pass table, only the walk direction differs."""
    if spec.reverse:
        return
    twin = engine.REGISTRY.get(_twin(spec).name)
    if twin is None:
        out.append(Finding("speccheck", spec.name,
                           f"reversed twin {_twin(spec).name!r} is not "
                           f"registered"))
        return
    if spec.passes() != twin.passes():
        out.append(Finding("speccheck", spec.name,
                           f"reversed twin {twin.name} runs a different "
                           f"pass table — reversal only mirrors the walk, "
                           f"it never re-wires the gate terms"))


def _check_twin(spec: SweepSpec, out: list) -> None:
    """Transposed twin = the same machine with the scale moved."""
    if spec.layout == "batch" or spec.transposed:
        return
    twin_name = _twin(spec).name
    twin = engine.REGISTRY.get(twin_name)
    if twin is None:
        out.append(Finding("speccheck", spec.name,
                           f"transposed twin {twin_name!r} is not "
                           f"registered"))
        return
    fwd, bwd = spec.passes()
    tfwd, tbwd = twin.passes()
    if (_lags(fwd), _lags(bwd)) != (_lags(tfwd), _lags(tbwd)):
        out.append(Finding("speccheck", spec.name,
                           f"twin {twin_name} runs different lag sequences "
                           f"({(_lags(tfwd), _lags(tbwd))} vs "
                           f"{(_lags(fwd), _lags(bwd))}) — not the same "
                           f"sweep machine"))
    if not spec.uniform and (fwd.terms, bwd.terms) != (tfwd.terms,
                                                       tbwd.terms):
        out.append(Finding("speccheck", spec.name,
                           f"twin {twin_name} reads different coefficient "
                           f"terms — transposition only shifts rows on the "
                           f"host and moves the scale, it never re-wires "
                           f"the term table"))
    if (fwd.scale, tbwd.scale) != (scale_row(spec), scale_row(twin)) or \
            (bwd.scale, tfwd.scale) != (None, None):
        out.append(Finding("speccheck", spec.name,
                           f"scale not moved fwd->bwd between {spec.name} "
                           f"and {twin_name}"))


def _check_storage_pricing(spec, out: list) -> None:
    """Mixed-precision pricing: ``traffic_bytes`` must price the STORED
    operand words at the storage itemsize and the writes at the fp32
    compute itemsize — the per-operand split the bf16 storage path's
    halved-bytes claim rests on."""
    n, m = TRACE_N, TRACE_M
    f32 = spec.traffic_bytes(n, m, torch.float32)
    bf16 = spec.traffic_bytes(n, m, torch.float32, torch.bfloat16)
    want = 2 * spec.storage_words(n, m) + 4 * spec.compute_words(n, m)
    if bf16 != want:
        out.append(Finding(
            "speccheck", spec.name,
            f"bf16-storage pricing drift: traffic_bytes says {bf16} but "
            f"storage_words x 2 + compute_words x 4 = {want} — the "
            f"per-operand itemsize split no longer holds"))
    if not bf16 < f32:
        out.append(Finding(
            "speccheck", spec.name,
            f"bf16 storage does not reduce modelled bytes ({bf16} vs "
            f"{f32} at fp32) — the spec stores nothing at the storage "
            f"dtype?"))


def _check_sharded_traffic(spec, out: list) -> None:
    """The per-rank model is the single-device model at the rank's
    columns: the fullest rank holds ``shard_lanes`` columns of the
    ``Shard(1)`` split, and over all ranks only the replicated LHS rows
    (``lhs_rows · N`` words, and eps) are counted more than once."""
    n, m = TRACE_N, TRACE_M
    for n_shards in (1, 3, 5):
        cols = [t.shape[1] for t in torch.empty((0, m)).chunk(n_shards, 1)]
        if max(cols) != shard_lanes(m, n_shards):
            out.append(Finding(
                "speccheck", spec.name,
                f"shard_lanes({m}, {n_shards}) = "
                f"{shard_lanes(m, n_shards)}, but Shard(1) gives the "
                f"fullest rank {max(cols)} columns"))
        replicated = spec.storage_words(n, 0) + spec.compute_words(n, 0)
        got = sum(spec.traffic_words(n, c) for c in cols)
        want = spec.traffic_words(n, m) + (len(cols) - 1) * replicated
        if got != want:
            out.append(Finding(
                "speccheck", spec.name,
                f"sharded traffic over {n_shards} rank(s) is {got} words, "
                f"expected the single-device {spec.traffic_words(n, m)} "
                f"plus the replicated LHS words once a further rank "
                f"({want})"))


def _check_traffic_recount(out: list) -> None:
    """``capture``'s operand recount against the model, in words and in
    bytes, for every spec and fused step at each storage type."""
    n, m = TRACE_N, TRACE_M
    for rec in capture.recount_all():
        tag = str(rec.dtype).split(".")[-1]
        words = capture.modelled_words(rec.subject, n, m)
        nbytes = capture.modelled_bytes(rec.subject, n, m, rec.dtype)
        if rec.dtype == torch.float32 and rec.words != words:
            out.append(Finding(
                "speccheck", rec.subject,
                f"HBM traffic drift: the kernel is handed and writes "
                f"{rec.words} words at N={n}, M={m}, the model says "
                f"{words} (delta {words - rec.words:+d})"))
        if rec.total_bytes != nbytes:
            out.append(Finding(
                "speccheck", f"{rec.subject}[{tag}]",
                f"HBM traffic drift: the operands weigh {rec.total_bytes} "
                f"bytes read once and written once, the model books "
                f"{nbytes} (delta {nbytes - rec.total_bytes:+d})"))


def run() -> list:
    """All speccheck invariants over every registered spec, and the traffic
    recount."""
    out: list = []
    for name in sorted(engine.REGISTRY):
        spec = engine.REGISTRY[name]
        if spec.name != name:
            out.append(Finding("speccheck", name,
                               f"registry key disagrees with spec.name "
                               f"({spec.name!r})"))
        if isinstance(spec, RecurrenceSpec):
            _check_recurrence_structure(spec, out)
            _check_recurrence_twin(spec, out)
        else:
            _check_structure(spec, out)
            _check_twin(spec, out)
        _check_storage_pricing(spec, out)
        _check_sharded_traffic(spec, out)
    _check_traffic_recount(out)
    return out
