"""The port's registry checks (``repro_torch.analysis``) against the JAX
package's ``repro.analysis``, on the CPU.

``speccheck`` runs clean on the port's registry; the port's pass tables
are JAX's term for term; a seeded defect in a copied table is caught; the
``nansweep`` cases (every spec and fused step x every route x the
reference's three shape classes) run each route's plain version under the
non-finite guard without a finding, as ``tests/test_nan_sweep.py`` runs
the reference's.  The card half of the sweep (NaN-filled outputs) is in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.kernels import engine as jengine

from repro_torch import analysis
from repro_torch.analysis import Finding, mutation, nansweep, run_all, speccheck
from repro_torch.analysis.__main__ import main
from repro_torch.kernels import engine, ops

SWEEP = [(subject, route[0], case[0])
         for subject, layout, spec in nansweep.kinds()
         for route in nansweep.routes(layout, spec)
         for case in nansweep.CASES]


def _plain_data(table: dict) -> dict:
    """A pass table as plain Python data: key -> ((terms, scale), ...)."""
    def one(p):
        return None if p is None else (tuple(p.terms), p.scale)
    return {k: tuple(one(p) for p in (v if isinstance(v, tuple) else (v,)))
            for k, v in table.items()}


def test_speccheck_clean():
    assert speccheck.run() == []
    assert run_all(device="cpu") == []


def test_pass_tables_match_jax_term_for_term():
    assert engine.EPS_PARAM == jengine.EPS_PARAM
    assert _plain_data(engine._PASS_TABLE) == _plain_data(
        jengine._PASS_TABLE)
    assert _plain_data(engine._BATCH_BWD) == _plain_data(jengine._BATCH_BWD)
    assert _plain_data(engine._RECUR_TABLE) == _plain_data(
        jengine._RECUR_TABLE)


def test_registry_is_jax_resident_specs_with_their_passes():
    resident = {name: s for name, s in jengine.REGISTRY.items()
                if not getattr(s, "streamed", False)
                and not getattr(s, "fused", False)}
    assert sorted(engine.REGISTRY) == sorted(resident)
    for name, spec in engine.REGISTRY.items():
        assert _plain_data({0: spec.passes()}) == _plain_data(
            {0: resident[name].passes()})
        if not isinstance(spec, engine.RecurrenceSpec):
            assert speccheck.scale_row(spec) == resident[name].scale_row
        assert spec.traffic_words(48, 24) == \
            resident[name].traffic_words(48, 24)


def _swapped(pspec):
    return dataclasses.replace(pspec, terms=tuple(reversed(pspec.terms)))


@pytest.mark.parametrize("defect", ("pass_table", "batch_bwd", "recurrence",
                                    "scale_row"))
def test_seeded_defect_in_a_copied_table_is_caught(defect, monkeypatch):
    if defect == "pass_table":
        table = dict(engine._PASS_TABLE)
        fwd, bwd = table[(5, False, False)]
        table[(5, False, False)] = (_swapped(fwd), bwd)
        monkeypatch.setattr(engine, "_PASS_TABLE", table)
        want = ("penta_constant.fwd", "subtraction order")
    elif defect == "batch_bwd":
        table = dict(engine._BATCH_BWD)
        table[2] = _swapped(table[2])
        monkeypatch.setattr(engine, "_BATCH_BWD", table)
        want = ("penta_batch.bwd", "subtraction order")
    elif defect == "recurrence":
        table = dict(engine._RECUR_TABLE)
        table[2] = dataclasses.replace(table[2], terms=((1, 1), (0, 2)))
        monkeypatch.setattr(engine, "_RECUR_TABLE", table)
        want = ("recur2.pass", "wrong lags")
    else:
        table = dict(engine._PASS_TABLE)
        fwd, bwd = table[(3, False, True)]
        table[(3, False, True)] = (dataclasses.replace(fwd, scale=1),
                                   dataclasses.replace(bwd, scale=None))
        monkeypatch.setattr(engine, "_PASS_TABLE", table)
        want = ("thomas_constant_t", "expected exactly one on the bwd pass")
    found = speccheck.run()
    assert any(f.subject == want[0] and want[1] in f.message
               for f in found), found


@pytest.mark.parametrize("subject,route,case", SWEEP)
def test_nansweep_plain_route_is_finite(subject, route, case):
    layout, spec = next((lay, s) for sub, lay, s in nansweep.kinds()
                        if sub == subject)
    picked = next(r for r in nansweep.routes(layout, spec) if r[0] == route)
    _, n, m = next(c for c in nansweep.CASES if c[0] == case)
    args, rhs = nansweep.operands(layout, spec, n, m)
    with nansweep.NonFiniteMode():
        x = nansweep.plain(layout, spec, picked, args, rhs)
    assert x.shape == (n, m) and torch.isfinite(x).all()


def test_nansweep_covers_every_route_and_runs_clean():
    assert {s for s, _, _ in SWEEP} == set(engine.REGISTRY) | set(
        nansweep.FUSED)
    assert {(s, r) for s, r, _ in SWEEP if s == "thomas_constant"} == {
        ("thomas_constant", r) for r in ops.SHARED_ROUTES}
    assert {r for s, r, _ in SWEEP if s == "penta_batch"} == set(
        ops.BATCH_ROUTES)
    assert nansweep.run("cpu") == []


def test_nansweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default sweep runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        nansweep.run()


def test_non_finite_mode_trips_on_an_intermediate():
    with pytest.raises(FloatingPointError, match="aten::div"):
        with nansweep.NonFiniteMode():
            torch.zeros(3) / torch.zeros(3)
    with nansweep.NonFiniteMode():                # a partial write into
        out = torch.empty(4, 2)                   # an empty buffer is
        out[torch.tensor([0, 1, 2, 3])] = 1.0     # checked on its values
    with pytest.raises(FloatingPointError, match="index_put"):
        with nansweep.NonFiniteMode():
            out[torch.tensor([0])] = float("nan")


def test_nansweep_reports_a_route_that_raises(monkeypatch):
    def broken(*args, **kwargs):
        raise ValueError("no such geometry")
    monkeypatch.setattr(nansweep, "plain", broken)
    found = nansweep.run("cpu")
    assert len(found) == len(SWEEP)
    assert all("ValueError: no such geometry" in f.message for f in found)
    assert str(found[0]).startswith("[nansweep] ")


def test_output_buffer_checks_what_it_is_given():
    good = torch.empty(3, 4)
    assert ops.output_buffer("x", good, (3, 4), torch.float32,
                             good.device) is good
    with pytest.raises(ValueError, match="contiguous"):
        ops.output_buffer("x", good.t(), (4, 3), torch.float32, good.device)
    with pytest.raises(ValueError, match="out must be"):
        ops.output_buffer("x", good, (3, 4), torch.float64, good.device)


def test_cli_checks_and_its_card_default(capsys, monkeypatch):
    assert main(["--device", "cpu"]) == 0
    assert "speclint clean on cpu: 12 registered specs" in \
        capsys.readouterr().out
    monkeypatch.setattr(nansweep, "run", lambda device: [])
    monkeypatch.setattr(analysis, "run_all", lambda **kw: [])
    monkeypatch.setattr(mutation, "self_test", lambda verbose: [])
    assert main(["--all", "--device", "cpu"]) == 0
    assert "nan-sweep clean on cpu" in capsys.readouterr().out
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            main(["--nan-sweep", "-q"])
        with pytest.raises(RuntimeError, match="CUDA card"):
            main(["-q"])
    assert Finding("a", "b", "c").__str__() == "[a] b: c"
