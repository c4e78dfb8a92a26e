"""Fixtures of the benchmark's own tests: its configurations and
workloads cut to sizes a CPU test can hold, and their references."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchkit import manifest  # noqa: E402

TINY = {
    "cn-diffusion": {"n": 16, "m": 256},
    "mamba2-130m": {"d_model": 64, "n_layer": 4, "vocab_size": 128,
                    "d_state": 16, "headdim": 16, "chunk_size": 16},
}
TINY_WORKLOADS = {
    "cn-diffusion.step": {"check_span": 20, "trace_steps": 2},
    "cn-diffusion.adjoint": {"check_span": 10, "trace_steps": 2},
    "mamba2-130m.train_4k": {"batch": 2, "seq": 64, "ref_rows": 1},
    "mamba2-130m.prefill_32k": {"batch": 2, "seq": 64, "check_span": 3},
}


@pytest.fixture(scope="session")
def bench():
    return manifest.load_manifest()


@pytest.fixture(scope="session")
def tiny():
    """``tiny(cell) -> (config, workload, ref)`` at a CPU test's size."""
    cache = {}

    def get(cell):
        entry = manifest.cell(manifest.load_manifest(), cell)
        conf_file = manifest.ROOT / manifest.config_entry(
            manifest.load_manifest(), entry["config"])["file"]
        if conf_file not in cache:
            cache[conf_file] = manifest.reference(conf_file)
        config = dict(manifest.read_json(conf_file), **TINY[entry["config"]])
        workload = dict(manifest.read_json(manifest.workload_file(cell)),
                        **TINY_WORKLOADS[cell])
        return config, workload, cache[conf_file]
    return get
