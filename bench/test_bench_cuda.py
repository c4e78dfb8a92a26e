"""On the card: every cell at a small size through the port's kernels is
correct, and its control is not; and one whole run of ``run.py`` prints
a result line the driver can read.  Skipped without a CUDA device.

    PYTHONPATH=src python -m pytest -q -m cuda bench/test_bench_cuda.py
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchkit import manifest
from benchkit.cell import run_cell
from benchkit.check import verdict

CELLS = ["cn-diffusion.step", "cn-diffusion.adjoint",
         "mamba2-130m.train_4k", "mamba2-130m.prefill_32k"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_the_card_is_correct_and_its_control_is_not(
        card, tiny, cell):
    config, workload, ref = tiny(cell)
    _, correct, rows, _ = run_cell(config, workload, ref, seed=5,
                                   seconds=0.5, traced=False, device="cuda",
                                   t0=time.time())
    assert correct, rows
    if workload["driver"] == "lm_train":
        from benchkit.kinds import lm_train
        ctl = lm_train.Cell(config, workload, 6, "cuda", ref, control=True)
        correct, rows = verdict(ctl.check(), workload["limits"])
    else:
        _, correct, rows, _ = run_cell(config, workload, ref, seed=6,
                                       seconds=0.5, traced=False,
                                       device="cuda", t0=time.time(),
                                       control=True)
    assert not correct, rows


@pytest.mark.cuda
def test_run_prints_a_readable_result(card):
    out = subprocess.run(
        [sys.executable, str(manifest.BENCH / "run.py"), "--workload",
         "cn-diffusion.step", "--seed", str(2 ** 31 + 3), "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, timeout=900,
        cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["fused_cn_roofline"]["value"] <= 105
