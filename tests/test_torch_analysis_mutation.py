"""The port's mutation self-test (``repro_torch.analysis.mutation``), on
the CPU, as ``tests/test_analysis.py`` runs the JAX package's: every
seeded defect class is caught by its checker, the host sync by both
``tracecheck`` and the lint, and the self-test leaves every patched table,
function and method the very object it found."""

from __future__ import annotations

import pytest

from repro_torch.analysis import mutation, speccheck

NAMES = [m[0] for m in mutation._MUTATIONS]


@pytest.fixture(scope="module")
def results():
    before = mutation.patch_targets()
    got = {r.name: r for r in mutation.self_test()}
    return got, before, mutation.patch_targets()


@pytest.mark.parametrize("defect", NAMES)
def test_mutation_detected(results, defect):
    got, _, _ = results
    assert got[defect].detected, f"the checkers missed {defect!r}"
    assert got[defect].evidence


def test_mutation_covers_the_eight_classes():
    assert NAMES == ["swapped-subtraction-order", "moved-scale",
                     "swapped-gate-lags", "stale-traffic-constant",
                     "span-off-by-one", "skipped-ragged-edge",
                     "onchip-past-smem", "baked-host-sync"]


def test_baked_host_sync_caught_by_both_layers(results):
    got, _, _ = results
    checkers = {f.checker for f in got["baked-host-sync"].evidence}
    assert checkers == {"tracecheck", "astlint"}
    subjects = {f.subject for f in got["baked-host-sync"].evidence
                if f.checker == "tracecheck"}
    assert subjects == {f"{b}/penta/{bc}/uniform" for b in ("cuda",
                                                             "sharded")
                        for bc in ("dirichlet", "periodic")}


def test_mutations_fully_reverted(results):
    _, before, after = results
    assert sorted(before) == sorted(after)
    for name in before:
        assert after[name] is before[name], name
    assert speccheck.run() == []
