"""The port stands alone: importing every ``repro_torch`` module loads no
``jax`` and nothing of the JAX package ``repro``, and its entry points run on
the CUDA device unless the caller asks for the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.models import Model, build_model
from repro_torch.solver import BandedSystem

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
subpackages = sorted({n.split(".")[1] for n in names if n.count(".") >= 1})
print(len(names), ",".join(subpackages), ",".join(leaked))
"""

# every subpackage of the port, and its modules: the ten configs, the model
# layers (the MoE layer among them), the serving and training drivers, the
# sharding rules, the data, optimizer, checkpoint and fault-tolerance
# modules, and the multi-device ones on torch.distributed (the sharded
# solver, the mesh builders, the compressed mean, the pipeline and elastic
# restore) among them, the cost model and profiler report
# (``launch.{analytic_cost,trace_analysis,dryrun,roofline_report}``) and
# the checks (``analysis``: its package, ``__main__``, ``speccheck``,
# ``nansweep``, and since the last module slice ``capture``,
# ``gridcheck``, ``lint``, ``mutation``, ``tracecheck``)
SUBPACKAGES = ["analysis", "ckpt", "configs", "convert", "core", "data",
               "kernels", "launch", "models", "pde", "runtime", "sharding",
               "solver", "train"]
MODULES = 77


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    count, subpackages, leaked = int(out[0]), out[1].split(","), out[2:]
    assert subpackages == SUBPACKAGES
    assert count == MODULES, f"{count} modules imported, expected {MODULES}"
    assert leaked == [], f"repro_torch pulled in {leaked}"


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_entry_points_default_to_cuda(kind):
    diags = (-0.4, 1.8, -0.4) if kind == "tridiag" else (0.1, -0.4, 1.6,
                                                         -0.4, 0.1)
    ctor = getattr(BandedSystem, kind)
    if torch.cuda.is_available():
        assert ctor(*diags, n=8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctor(*diags, n=8)
    assert ctor(*diags, n=8, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ("build_model", "Model", "serve", "train"))
def test_model_entry_points_default_to_cuda(entry, tmp_path):
    cfg = get_smoke_config("mamba2-130m")
    make = {"build_model": lambda **kw: build_model(cfg, **kw),
            "Model": lambda **kw: Model(cfg, **kw),
            "serve": lambda **kw: serve.serve(
                cfg, requests=1, batch=1, prompt_len=16, gen=2,
                log=lambda _: None, **kw)["cache"]["state"],
            "train": lambda **kw: train.train(
                cfg, steps=1, batch=1, seq=16, ckpt_dir=str(tmp_path / "run"),
                log=lambda _: None, **kw)["params"]["embed"]}[entry]

    def device(obj):
        return obj.device.type

    if torch.cuda.is_available():
        assert device(make()) == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert device(make(device="cpu")) == "cpu"


def test_serve_main_defaults_to_cuda():
    argv = ["--arch", "mamba2-130m", "--smoke", "--requests", "1",
            "--batch", "1", "--prompt-len", "16", "--gen", "2"]
    if torch.cuda.is_available():
        assert serve.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(argv)


def test_train_main_defaults_to_cuda(tmp_path):
    argv = ["--arch", "mamba2-130m", "--smoke", "--steps", "1", "--batch",
            "1", "--seq", "16", "--ckpt-dir", str(tmp_path / "run")]
    if torch.cuda.is_available():
        assert train.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(argv)
