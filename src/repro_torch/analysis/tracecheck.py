"""tracecheck — the host-sync contract of every registered backend x mode.

Counterpart of ``repro.analysis.tracecheck``.  JAX proves with
``jax.eval_shape`` on fully traced leaves that no solve concretizes a
leaf.  Torch has no tracing: a value reaches the host the moment code asks
for it, so the port proves the same property by RUNNING every cell of the
support matrix under ``nansweep.HostSyncMode``, which raises on the first
op through which a tensor's value reaches the host (``.item()``,
``float(t)``, ``bool(t)``, ``nonzero``, ``equal``, a copy from the card
to the host).  A host sync on the solve path stalls the launch queue
behind every kernel before it, and a CUDA graph capture fails on it.

  * ``contract_cases()`` — JAX's matrix: every pure backend
    (``solver.registry.available_pure_backends``, so a new backend is
    checked with no edit here) x bandwidth (3, 5) x mode (constant,
    uniform, batch) x periodic, on JAX's systems (N 32, M 16, the same
    seeds and values; batch-mode diagonals (N,)).
  * ``check_case`` — ``hash(fact.meta)`` works (a meta that cannot be a
    dict key cannot key a cache); then, under the mode, ``solve`` and
    ``transpose_solve`` on an (N, M) rhs and a backward through ``solve``
    (whose backward is ``transpose_solve`` on the same factor) to the rhs
    and the diagonals, with every shape checked.  A ``NotImplementedError``
    from ``factorize`` is a declared skip, not a finding: ``cuda`` on
    periodic x batch, as JAX's ``pallas`` there.
  * ``recurrence_cases()`` — JAX's 8: order (1, 2) x reverse x seeded /
    zero-carry, through ``core.recurrence`` with ``method="cuda"``,
    forward and backward.

``sweep(device)`` runs it all and returns what it covered beside the
findings; ``run(device)`` returns the findings alone, after the lint
(``lint.run``), as JAX's does.  ``device="cuda"`` (the default) raises
without a card; there the ``cuda`` backend launches the real kernels and
every cell also runs under ``torch.cuda.set_sync_debug_mode("error")``
(restored afterwards), which sees what the dispatch mode cannot: a sync
inside a kernel's own code or a tensor subclass.  One cell is the
exception: the ``sharded`` backend's one-rank group is gloo
(``"cpu:gloo,cuda:gloo"``, as phase ``sharded``'s case (r1) opens it), and
gloo moves a CUDA tensor through the host for its all-reduce, so that
backend's cells run under ``HostSyncMode`` alone.  ``device="cpu"`` runs
the plain versions.  ``sweep`` opens the one-rank group only if none is
open, over a ``FileStore`` in a temporary directory (no network), and
closes what it opened.
"""

from __future__ import annotations

import contextlib
import dataclasses
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import engine

from . import Finding, lint
from .nansweep import HostSyncMode

#: (n, m) of the contract-check systems.
CHECK_N, CHECK_M = 32, 16
MODES = ("constant", "uniform", "batch")


@dataclasses.dataclass
class Checked:
    """What a sweep covered, beside its findings."""

    findings: list
    cases: int = 0                      # matrix cells run to the end
    skips: list = dataclasses.field(default_factory=list)   # declared
    recurrences: int = 0                # recurrence cases run
    lint_findings: int = 0
    launches: dict = dataclasses.field(default_factory=dict)  # expected


def subject(backend: str, bandwidth: int, mode: str, periodic: bool) -> str:
    """``backend/tridiag|penta/dirichlet|periodic/mode``."""
    return (f"{backend}/{'tridiag' if bandwidth == 3 else 'penta'}/"
            f"{'periodic' if periodic else 'dirichlet'}/{mode}")


def _case_system(bandwidth: int, mode: str, periodic: bool, device: str):
    """JAX's well-conditioned system for one matrix cell, its diagonals
    leaves that require grad."""
    from repro_torch.solver import BandedSystem

    rng = np.random.default_rng(bandwidth)
    n = CHECK_N
    if mode == "uniform":
        if bandwidth == 3:
            diags = (-1.0, 4.0, -1.0)
        else:
            s = 0.11
            diags = (s, -4 * s, 1 + 6 * s, -4 * s, s)
        diags = tuple(np.full(n, v, np.float32) for v in diags)
    else:
        off = [rng.uniform(-1, 1, n).astype(np.float32)
               for _ in range(bandwidth - 1)]
        main = (sum(np.abs(o) for o in off)
                + np.float32(bandwidth - 1.0)).astype(np.float32)
        diags = (*off[:bandwidth // 2], main, *off[bandwidth // 2:])
    diags = tuple(torch.tensor(d, device=device).requires_grad_()
                  for d in diags)
    ctor = BandedSystem.tridiag if bandwidth == 3 else BandedSystem.penta
    return ctor(*diags, n=n, periodic=periodic, mode=mode,
                batch=CHECK_M if mode == "batch" else None, device=device)


def contract_cases() -> list:
    """(backend, bandwidth, mode, periodic) for the full support matrix."""
    from repro_torch.solver.registry import available_pure_backends

    return [(backend, bw, mode, periodic)
            for backend in available_pure_backends()
            for bw in (3, 5)
            for mode in MODES
            for periodic in (False, True)]


def case_launches(backend: str, bandwidth: int, mode: str,
                  periodic: bool) -> dict:
    """The kernel launches one cell makes on the card: ``solve`` runs the
    forward spec, ``transpose_solve`` and the backward the transposed one
    (the batch layout's adjoint is the forward batch sweep on rolled
    diagonals).  None on the ``reference`` backend, and none where the
    ``sharded`` backend's shards run the reference sweeps (periodic
    batch)."""
    if backend == "reference" or (mode == "batch" and periodic):
        return {}
    fwd = engine.find_spec(bandwidth, mode)
    adj = fwd if mode == "batch" else engine.find_spec(bandwidth, mode,
                                                       transposed=True)
    out = {fwd.name: 1}
    out[adj.name] = out.get(adj.name, 0) + 2
    return out


@contextlib.contextmanager
def _sync_guards(device: str, backend: str):
    """``HostSyncMode``, and on the card the sync debug mode too (not for
    the ``sharded`` backend, whose gloo all-reduce goes through the
    host)."""
    debug = device == "cuda" and backend != "sharded"
    old = torch.cuda.get_sync_debug_mode() if debug else None
    if debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with HostSyncMode():
            yield
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode(old)


def _first_line(exc: Exception) -> str:
    """The exception's type and first line, and the innermost line of the
    port's own code it came through."""
    text = str(exc).strip()
    where = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
             for f in traceback.extract_tb(exc.__traceback__)
             if "repro_torch" in f.filename and "analysis" not in f.filename]
    at = f" (at {where[-1]})" if where else ""
    return (f"{type(exc).__name__}: {text.splitlines()[0] if text else ''}"
            f"{at}")


def _like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``x``'s mesh when ``x`` is one (a
    sharded solve's output), else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def check_case(backend: str, bandwidth: int, mode: str, periodic: bool,
               device: str = "cpu") -> tuple:
    """``(findings, skipped)`` for one backend x mode x bc cell: empty
    findings when the contract holds; ``skipped`` when the backend
    declared the cell unsupported (``NotImplementedError``)."""
    from repro_torch.solver import factorize, solve, transpose_solve

    sub = subject(backend, bandwidth, mode, periodic)
    system = _case_system(bandwidth, mode, periodic, device)
    try:
        fact = factorize(system, backend=backend)
    except NotImplementedError:
        return [], True          # declared unsupported: not a violation
    except Exception as exc:  # noqa: BLE001 — every failure is a finding
        return [Finding("tracecheck", sub,
                        f"factorize raised {_first_line(exc)}")], False
    try:
        hash(fact.meta)
    except TypeError as exc:
        return [Finding("tracecheck", sub,
                        f"SolveMeta is unhashable ({exc}): the factorization "
                        f"cannot key a cache")], False

    rng = np.random.default_rng(100 + bandwidth)
    want = (system.n, CHECK_M)
    rhs = torch.tensor(rng.uniform(-1, 1, want).astype(np.float32),
                       device=device)
    weight = torch.tensor(rng.uniform(-1, 1, want).astype(np.float32),
                          device=device)
    rhs_g = rhs.clone().requires_grad_()
    out: list = []
    try:
        with _sync_guards(device, backend):
            x = solve(fact, rhs_g)
            lam = transpose_solve(fact, rhs)
            (x * _like(x, weight)).sum().backward()
    except Exception as exc:  # noqa: BLE001
        return [Finding("tracecheck", sub,
                        f"solve / transpose_solve / backward brings a value "
                        f"to the host or fails — {_first_line(exc)}")], False
    for name, got, shape in (
            ("solve", x, want), ("transpose_solve", lam, want),
            ("the rhs gradient", rhs_g.grad, want),
            *((f"diagonal {k}'s gradient", d.grad, (system.n,))
              for k, d in enumerate(system.diagonals))):
        if got is None or tuple(got.shape) != shape:
            out.append(Finding("tracecheck", sub,
                               f"{name} has shape "
                               f"{None if got is None else tuple(got.shape)}"
                               f", expected {shape}"))
    return out, False


def recurrence_cases() -> list:
    """(order, reverse, with_h0) for the gated recurrences: both walk
    directions, seeded and zero-carry."""
    return [(order, reverse, with_h0)
            for order in (1, 2)
            for reverse in (False, True)
            for with_h0 in (False, True)]


def recurrence_launches(order: int, reverse: bool) -> dict:
    """One forward launch and one adjoint launch, walked the other way."""
    fwd = engine.find_recurrence_spec(order, reverse=reverse)
    adj = engine.find_recurrence_spec(order, reverse=not reverse)
    return {fwd.name: 1, adj.name: 1}


def check_recurrence_case(order: int, reverse: bool, with_h0: bool,
                          device: str = "cpu") -> list:
    """``core.recurrence`` with ``method="cuda"``, forward and backward to
    every operand, under the host-sync guards."""
    from repro_torch.core.recurrence import (linear_recurrence,
                                             linear_recurrence2)

    sub = (f"cuda/recur{order}/{'reverse' if reverse else 'forward'}/"
           f"{'seeded' if with_h0 else 'zero-carry'}")
    rng = np.random.default_rng(order)
    shape = (CHECK_N, CHECK_M)

    def leaf(scale, size=shape):
        return torch.tensor(rng.uniform(-scale, scale, size).astype(
            np.float32), device=device).requires_grad_()

    gates = [leaf(0.9)] if order == 1 else [leaf(0.6), leaf(0.3)]
    q = leaf(1.0)
    seeds = [leaf(1.0, (CHECK_M,)) for _ in range(order)] if with_h0 else []
    weight = torch.tensor(rng.uniform(-1, 1, shape).astype(np.float32),
                          device=device)
    try:
        with _sync_guards(device, "cuda"):
            if order == 1:
                h = linear_recurrence(gates[0], q, *seeds, reverse=reverse,
                                      method="cuda")
            else:
                h = linear_recurrence2(gates[0], gates[1], q,
                                       tuple(seeds) or None,
                                       reverse=reverse, method="cuda")
            (h * weight).sum().backward()
    except Exception as exc:  # noqa: BLE001
        return [Finding("tracecheck", sub,
                        f"the recurrence or its backward brings a value to "
                        f"the host or fails — {_first_line(exc)}")]
    out = []
    for t in (h, *gates, q, *seeds):
        got = t if t is h else t.grad
        want = tuple(t.shape)
        if got is None or tuple(got.shape) != want:
            out.append(Finding("tracecheck", sub,
                               f"an output or gradient has shape "
                               f"{None if got is None else tuple(got.shape)}"
                               f", expected {want}"))
    return out


@contextlib.contextmanager
def one_rank_group(device: str):
    """A one-rank default process group for the ``sharded`` cells when none
    is open (gloo over a ``FileStore`` in a temporary directory: no
    network), closed again on exit; the open one otherwise."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(f"{tmp}/store", 1)
        dist.init_process_group(
            "cpu:gloo,cuda:gloo" if device == "cuda" else "gloo",
            store=store, rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def sweep(device: str = "cuda") -> Checked:
    """The full matrix, the recurrence cases and the AST lint,
    on the card (the default, which raises without one) or on the CPU;
    returns the findings and what ran."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"tracecheck: device must be cpu or cuda, got "
                         f"{device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tracecheck on the kernels needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    res = Checked(findings=[])

    def expect(launches: dict) -> None:
        for name, k in launches.items():
            res.launches[name] = res.launches.get(name, 0) + k

    cases = contract_cases()
    with one_rank_group(device) if any(c[0] == "sharded" for c in cases) \
            else contextlib.nullcontext():
        for case in cases:
            found, skipped = check_case(*case, device=device)
            res.findings.extend(found)
            if skipped:
                res.skips.append(subject(*case))
            elif not found:
                res.cases += 1
                expect(case_launches(*case))
    for rcase in recurrence_cases():
        found = check_recurrence_case(*rcase, device=device)
        res.findings.extend(found)
        if not found:
            res.recurrences += 1
            expect(recurrence_launches(*rcase[:2]))
    linted = lint.run()
    res.lint_findings = len(linted)
    res.findings.extend(linted)
    return res


def run(device: str = "cuda") -> list:
    """The full host-sync matrix + the AST lint; the findings."""
    return sweep(device).findings

