"""The port's host-sync checks (``repro_torch.analysis.lint`` and
``tracecheck``) against the JAX package's ``repro.analysis``, on the CPU.

The lint flags what JAX's flags on JAX's probe strings, and the torch
calls that bring a value to the host besides; it is clean on the port.
``tracecheck`` spans every pure backend x 2 x 3 x 2, declares its skips on
the cells where JAX's ``pallas`` declares them (``cuda`` stands where
``pallas`` stands), and runs clean with forward, transposed and backward
solves and the 8 recurrence cases under ``HostSyncMode``, which trips on
the conversions an AST cannot see.  The card leg is in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import pathlib

import pytest
import torch

from repro.analysis import lint as jlint

from repro_torch.analysis import lint, nansweep, tracecheck
from repro_torch.solver.registry import available_pure_backends

#: JAX's probes (``tests/test_analysis.py``), then the marker and a
#: syntax error.
PROBES = (
    "def f(x):\n    return float(x) + y.item() + np.asarray(z)\n",
    "n = int(3.5)\n",
    "n = float(-1)\n",
    f"n = int(x)  # {lint.ALLOW_MARKER}\n",
    "def f(:\n",
)
#: The port's own calls, each flagged, and its literal form, not.
TORCH_CALLS = (
    ("bool(x)", "bool(...)"),
    ("x.tolist()", ".tolist()"),
    ("x.numpy()", ".numpy()"),
    ("x.cpu()", ".cpu()"),
    ("torch.cuda.synchronize(dev)", "torch.cuda.synchronize(...)"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize(...)"),
)
#: JAX's ``pallas`` stands where the port's ``cuda`` stands.
JAX_NAMES = {"cuda": "pallas"}


def _kinds(findings) -> list:
    return sorted((f.checker, f.subject, f.message.split(" ", 1)[0])
                  for f in findings)


@pytest.mark.parametrize("probe", PROBES)
def test_lint_flags_what_jax_flags_on_its_probes(probe):
    assert lint.ALLOW_MARKER == jlint.ALLOW_MARKER
    assert lint.TRACED_PACKAGES == jlint.TRACED_PACKAGES
    mine = lint.lint_source(probe, "probe.py")
    assert _kinds(mine) == _kinds(jlint.lint_source(probe, "probe.py"))
    assert all("host sync" in f.message for f in mine
               if "syntax error" not in f.message)


@pytest.mark.parametrize("call,flag", TORCH_CALLS)
def test_lint_flags_the_torch_host_calls(call, flag):
    found = lint.lint_source(f"def f(x, dev):\n    return {call}\n", "t.py")
    assert [(f.subject, f.message.split(" ", 1)[0]) for f in found] == [
        ("t.py:2", flag)]
    assert "waits for the device" in found[0].message
    marked = f"y = {call}  # {lint.ALLOW_MARKER}\n"
    assert lint.lint_source(marked) == []


def test_lint_passes_literals_and_sees_no_conversion():
    assert lint.lint_source("a = bool(0)\nb = int(-2)\n") == []
    # documented limit: Tensor.__bool__ has no call in the source; the
    # run-time leg (HostSyncMode) is what catches it
    assert lint.lint_source("if (x > 0).any():\n    pass\n") == []


def test_lint_clean_on_the_port_with_each_site_marked():
    assert lint.run() == []
    root = pathlib.Path(lint.__file__).resolve().parents[1]
    marked = sorted(
        f"{p.relative_to(root)}"
        for pkg in lint.TRACED_PACKAGES for p in (root / pkg).rglob("*.py")
        for line in p.read_text().splitlines() if lint.ALLOW_MARKER in line)
    assert marked == ["kernels/ops.py"] * 3 + ["solver/sharded.py"]


@pytest.mark.parametrize("name,fn", (
    ("item", lambda t: t.sum().item()),
    ("float", lambda t: float(t[0])),
    ("if t.any()", lambda t: 1 if t.any() else 0),
    ("nonzero", torch.nonzero),
    ("equal", lambda t: torch.equal(t, t)),
))
def test_host_sync_mode_trips(name, fn):
    t = torch.ones(3)
    with pytest.raises(nansweep.HostSyncError, match="to the host"):
        with nansweep.HostSyncMode():
            fn(t)
    with nansweep.HostSyncMode():                  # device-side ops pass
        (t * 2 + t).sum()


def test_host_sync_mode_sees_a_backward():
    class Planted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            g.sum().item()
            return 2 * g

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(nansweep.HostSyncError, match="_local_scalar_dense"):
        with nansweep.HostSyncMode():
            Planted.apply(x).sum().backward()


def test_contract_cases_span_every_pure_backend():
    cases = tracecheck.contract_cases()
    assert available_pure_backends() == ["cuda", "reference", "sharded"]
    assert {c[0] for c in cases} == set(available_pure_backends())
    assert len(cases) == len(available_pure_backends()) * 2 * 3 * 2
    assert len(tracecheck.recurrence_cases()) == 8


def test_declared_skips_fall_on_jax_cells():
    """The port's ``NotImplementedError`` cells are JAX's, backend for
    backend: ``cuda`` (JAX's ``pallas``) on periodic batch, both
    bandwidths, and no other."""
    from repro.analysis import tracecheck as jtracecheck
    from repro.solver import factorize as jfactorize

    assert sorted(JAX_NAMES.get(b, b) for b in available_pure_backends()) \
        == sorted({c[0] for c in jtracecheck.contract_cases()})
    mine, theirs = [], []
    for backend, bw, mode, periodic in tracecheck.contract_cases():
        if backend != "cuda":
            continue
        if tracecheck.check_case(backend, bw, mode, periodic)[1]:
            mine.append((bw, mode, periodic))
        try:
            jfactorize(jtracecheck._case_system(bw, mode, periodic),
                       backend=JAX_NAMES[backend])
        except NotImplementedError:
            theirs.append((bw, mode, periodic))
    assert mine == theirs == [(3, "batch", True), (5, "batch", True)]


def test_tracecheck_runs_clean_on_the_cpu():
    res = tracecheck.sweep("cpu")
    assert res.findings == []
    assert res.cases == len(tracecheck.contract_cases()) - 2
    assert res.skips == ["cuda/tridiag/periodic/batch",
                         "cuda/penta/periodic/batch"]
    assert res.recurrences == 8 and res.lint_findings == 0
    # what those cases launch on the card: a forward solve, then the
    # transposed solve and the backward's on the same factor
    assert res.launches["thomas_constant"] == 8            # cuda + sharded
    assert res.launches["thomas_constant_t"] == 16
    assert res.launches["thomas_batch"] == 6               # Dirichlet only
    assert res.launches["recur2_rev"] == 4
    assert not torch.distributed.is_initialized()


def test_tracecheck_reports_a_host_sync_on_the_solve_path(monkeypatch):
    from repro_torch.kernels import ops

    def synced(f, d, **kw):
        d.abs().max().item()
        return real(f, d, **kw)

    real = ops.thomas_constant
    monkeypatch.setattr(ops, "thomas_constant", synced)
    found, skipped = tracecheck.check_case("cuda", 3, "constant", False)
    assert not skipped and len(found) == 1
    assert found[0].subject == "cuda/tridiag/dirichlet/constant"
    assert "HostSyncError" in found[0].message


def test_tracecheck_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tracecheck.run()
