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
print(len(names), ",".join(leaked))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    count, leaked = int(out[0]), out[1:]
    assert count >= 17, f"only {count} modules imported"
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
