"""Whole runs of every cell at a CPU test's size, past the look for a
card: a sound run is correct; each fault the cell can have, planted under
the timed path, and the control (the reference one precision below the
configuration's in the program's place) come out not correct; and no run
loads JAX or the JAX package."""

import json
import subprocess
import sys
import time

import pytest

from benchkit import faults, manifest
from benchkit.cell import run_cell

CELLS = ["cn-diffusion.step", "cn-diffusion.adjoint",
         "mamba2-130m.train_4k", "mamba2-130m.prefill_32k"]
SEED = 2 ** 31 + 11


def _run(tiny, cell, seed=SEED, control=False):
    config, workload, ref = tiny(cell)
    _, correct, rows, _ = run_cell(config, workload, ref, seed=seed,
                                   seconds=0.2, traced=False, device="cpu",
                                   t0=time.time(), control=control)
    return correct, rows


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    correct, rows = _run(tiny, cell)
    assert correct, rows


@pytest.mark.parametrize("cell", ["cn-diffusion.step",
                                  "cn-diffusion.adjoint",
                                  "mamba2-130m.prefill_32k"])
def test_the_control_is_not_correct(tiny, cell):
    correct, rows = _run(tiny, cell, control=True)
    assert not correct, rows


def test_the_training_control_is_not_correct(tiny):
    from benchkit.check import verdict
    from benchkit.kinds import lm_train
    config, workload, ref = tiny("mamba2-130m.train_4k")
    cell = lm_train.Cell(config, workload, SEED, "cpu", ref, control=True)
    correct, rows = verdict(cell.check(), workload["limits"])
    assert not correct, rows


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny, cell, kind):
    with faults.planted(tiny(cell)[1]["driver"], kind):
        correct, rows = _run(tiny, cell)
    assert not correct, (kind, rows)


# -- nothing of JAX in a run's process -------------------------------------

def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every driver, run whole in a fresh process, leaves no module whose
    top-level name is jax, jaxlib, flax or repro (compared whole: the
    port's repro_torch is allowed)."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(manifest.BENCH)!r}, {str(manifest.ROOT / 'src')!r}]
import conftest
from benchkit import manifest
from benchkit.cell import forbidden_modules, run_cell
for cell in {CELLS!r}:
    entry = manifest.cell(manifest.load_manifest(), cell)
    conf = manifest.ROOT / manifest.config_entry(
        manifest.load_manifest(), entry["config"])["file"]
    config = dict(manifest.read_json(conf), **conftest.TINY[entry["config"]])
    wl = dict(manifest.read_json(manifest.workload_file(cell)),
              **conftest.TINY_WORKLOADS[cell])
    run_cell(config, wl, manifest.reference(conf), seed=3,
             seconds=0.1, traced=False, device="cpu", t0=time.time())
print(json.dumps([forbidden_modules(),
                  "repro_torch" in {{m.split(".")[0] for m in sys.modules}}]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=manifest.BENCH)
    assert out.returncode == 0, out.stderr[-3000:]
    found, port_loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and port_loaded


def test_misaligned_labels_in_the_feed_are_not_correct(tiny, monkeypatch):
    """The reference reads each step's labels off the token sequence it
    is handed, so labels fed to the program one place off (each token its
    own label) come out not correct."""
    from benchkit.kinds import lm_train
    real = lm_train.Cell._feed

    def feed(self, seq):
        batch = real(self, seq)
        return dict(batch, labels=batch["tokens"].clone())
    monkeypatch.setattr(lm_train.Cell, "_feed", feed)
    correct, rows = _run(tiny, "mamba2-130m.train_4k")
    assert not correct, rows
