"""The port's mutation self-test (``repro_torch.analysis.mutation``), on
the CPU, as ``tests/test_analysis.py`` runs the JAX package's: every
seeded defect class is caught by its checker, the host sync by both
``tracecheck`` and the lint, and the self-test leaves every patched table,
function and method the very object it found.  The two card classes (the
carry workspace's) are listed, patch the two launch builders and put them
back, and need the card; they run in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import pytest
import torch

from repro_torch.analysis import mutation, speccheck
from repro_torch.kernels import fused_cn, ops

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


def test_card_classes_listed_apart_from_the_eight():
    assert [m[0] for m in mutation.CARD_MUTATIONS] == [
        "dropped-reset-carry", "forgotten-descend-mirror"]
    assert not set(NAMES) & {m[0] for m in mutation.CARD_MUTATIONS}
    assert all(m[2] is mutation._carry_probe
               for m in mutation.CARD_MUTATIONS)


@pytest.mark.parametrize("defect", mutation.CARD_MUTATIONS,
                         ids=[m[0] for m in mutation.CARD_MUTATIONS])
def test_card_class_patches_the_launch_builders_and_restores_them(defect):
    _, mutate, _, _ = defect
    before = mutation.card_patch_targets()
    with mutate():
        assert ops._shared_launch is not before["ops._shared_launch"]
        assert fused_cn._fused_launch is not before["fused_cn._fused_launch"]
    after = mutation.card_patch_targets()
    for key in before:
        assert after[key] is before[key], key


def test_card_self_test_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card classes run there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        mutation.card_self_test()
