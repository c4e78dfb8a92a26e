"""repro_torch.kernels against repro.kernels on the same numpy inputs.

  * the pass table and the byte accounting are the JAX engine's;
  * the stacked (and host-shifted, for the transposed variants) kernel LHS
    equals ``repro.kernels.ops.stack_*_lhs``;
  * ``thomas_constant`` / ``penta_constant`` — on CPU tensors, the plain
    version of the CUDA sweep — equal the Pallas kernels (interpret mode)
    for all six shared variants, at fp32 (≤ 1e-5 relative), fp64 (≤ 1e-12,
    JAX x64 switched on for that test only) and bf16 storage (≤ 1e-2
    relative, the JAX suite's bar for bf16 storage).

The batch layout (``thomas_batch`` / ``penta_batch``) is held against JAX
in ``tests/test_torch_batch.py``.

The kernel itself is held against this plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import penta as jpenta
from repro.core import tridiag as jtri
from repro.kernels import engine as jengine
from repro.kernels import ops as jops
from repro_torch.core import penta as tpenta
from repro_torch.core import tridiag as ttri
from repro_torch.kernels import engine as tengine
from repro_torch.kernels import ops as tops

N, M = 37, 130
SPECS = sorted(n for n, s in tengine.REGISTRY.items() if s.layout == "shared")
STORAGES = {"float32": 1e-5, "float64": 1e-12, "bf16": 1e-2}


@contextlib.contextmanager
def _jax_x64(enabled: bool):
    if not enabled:
        yield
        return
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _diags(bandwidth: int, uniform: bool, n: int = N):
    rng = np.random.default_rng(bandwidth * 10 + uniform)
    if bandwidth == 3:
        return [rng.uniform(-1, 1, n), 4 + rng.uniform(0, 1, n),
                rng.uniform(-1, 1, n)]
    if uniform:
        return [np.full(n, v) for v in (0.4, -1.6, 3.4, -1.6, 0.4)]
    diags = [rng.uniform(-0.5, 0.5, n) for _ in range(5)]
    diags[2] = diags[2] + 6
    return diags


def _factors(spec, dtype):
    """(JAX factor, port factor) of the same diagonals at ``dtype``."""
    diags = [d.astype(dtype) for d in _diags(spec.bandwidth, spec.uniform)]
    if spec.bandwidth == 3:
        jf = jtri.thomas_factor(*(jnp.asarray(d) for d in diags))
        tf = ttri.thomas_factor(*(torch.from_numpy(d) for d in diags))
    else:
        jf = jpenta.penta_factor(*(jnp.asarray(d) for d in diags))
        tf = tpenta.penta_factor(*(torch.from_numpy(d) for d in diags))
    return jf, tf


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _as_tuple(pspec):
    return (tuple(tuple(t) for t in pspec.terms), pspec.scale)


def test_pass_table_is_the_jax_engines():
    jax_table = {k: tuple(_as_tuple(p) for p in v)
                 for k, v in jengine.pass_table().items()}
    port_table = {k: tuple(_as_tuple(p) for p in v)
                  for k, v in tengine.pass_table().items()}
    assert port_table == jax_table
    assert tengine.EPS_PARAM == jengine.EPS_PARAM


@pytest.mark.parametrize("name", SPECS)
def test_spec_structure_and_traffic_match_jax(name):
    spec = tengine.REGISTRY[name]
    jspec = jengine.REGISTRY[name]          # the resident JAX variant
    assert (spec.order, spec.lhs_rows, spec.mode, spec.transposed,
            spec.uniform) == (jspec.order, jspec.lhs_rows, jspec.mode,
                              jspec.transposed, jspec.uniform)
    assert _as_tuple(spec.passes()[0]) == _as_tuple(jspec.passes()[0])
    assert _as_tuple(spec.passes()[1]) == _as_tuple(jspec.passes()[1])
    for n, m in ((1, 1), (512, 65536), (16384, 1 << 20)):
        assert spec.traffic_words(n, m) == jspec.traffic_words(n, m)
        assert spec.traffic_words(n, m) == (
            2 * n * m + spec.lhs_rows * n + spec.uniform)
    assert spec.traffic_bytes(512, 4096, torch.float32) == \
        jspec.traffic_bytes(512, 4096, jnp.float32)
    assert spec.traffic_bytes(512, 4096, torch.float64) == \
        jspec.traffic_bytes(512, 4096, jnp.float64)
    assert spec.traffic_bytes(512, 4096, torch.float32, torch.bfloat16) == \
        jspec.traffic_bytes(512, 4096, jnp.float32, jnp.bfloat16)
    assert tengine.find_spec(spec.bandwidth, spec.mode,
                             transposed=spec.transposed) == spec


def test_find_spec_routes_and_refuses():
    assert tengine.find_spec(3, "uniform").name == "thomas_constant"
    assert tengine.find_spec(3, "batch").name == "thomas_batch"
    assert tengine.find_spec(5, "batch") == tengine.REGISTRY["penta_batch"]
    with pytest.raises(ValueError, match="rolling"):
        tengine.find_spec(5, "batch", transposed=True)
    with pytest.raises(ValueError):
        tengine.find_spec(7, "constant")
    with pytest.raises(ValueError):
        tengine.find_spec(5, "bogus")


@pytest.mark.parametrize("name", SPECS)
def test_sweep_desc_encodes_the_pass_table(name):
    spec = tengine.REGISTRY[name]
    desc = tops.sweep_desc(spec)
    assert len(desc) == 11 and desc[0] == spec.order
    for pspec, words in zip(spec.passes(), (desc[1:6], desc[6:11])):
        for t, (src, lag) in enumerate(pspec.terms):
            row = spec.lhs_rows if src == tengine.EPS_PARAM else src
            assert words[2 * t:2 * t + 2] == [row, lag]
        if len(pspec.terms) == 1:
            assert words[2] == -1
        assert words[4] == (-1 if pspec.scale is None else pspec.scale)


@pytest.mark.parametrize("transposed", (False, True))
@pytest.mark.parametrize("kind", ("tri", "penta", "penta_uniform"))
def test_stacked_lhs_matches_jax(kind, transposed):
    bandwidth = 3 if kind == "tri" else 5
    uniform = kind == "penta_uniform"
    spec = tengine.find_spec(bandwidth, "uniform" if uniform else "constant",
                             transposed=transposed)
    jf, tf = _factors(spec, np.float32)
    if bandwidth == 3:
        want = jops.stack_tridiag_lhs(jf, transposed=transposed)
        got = tops.stack_tridiag_lhs(tf, transposed=transposed)
    else:
        want = jops.stack_penta_lhs(jf, uniform=uniform, transposed=transposed)
        got = tops.stack_penta_lhs(tf, uniform=uniform, transposed=transposed)
    assert got.shape == (spec.lhs_rows, N)
    assert _rel(got, want) <= 1e-6
    if uniform:
        assert _rel(tops._uniform_eps_param(tf, torch.float32),
                    jops._uniform_eps_param(jf, jnp.float32).reshape(1)) == 0


@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("name", SPECS)
def test_constant_solves_match_pallas(name, storage):
    spec = tengine.REGISTRY[name]
    dtype = np.float64 if storage == "float64" else np.float32
    sdt = "bf16" if storage == "bf16" else None
    rhs = np.random.default_rng(3).normal(size=(N, M)).astype(dtype)
    with _jax_x64(storage == "float64"):
        jf, tf = _factors(spec, dtype)
        if spec.bandwidth == 3:
            want = jops.thomas_constant(jf, jnp.asarray(rhs),
                                        transposed=spec.transposed,
                                        storage_dtype=sdt)
        else:
            want = jops.penta_constant(jf, jnp.asarray(rhs),
                                       uniform=spec.uniform,
                                       transposed=spec.transposed,
                                       storage_dtype=sdt)
        want = np.asarray(want)
    tops.reset_launches()
    if spec.bandwidth == 3:
        got = tops.thomas_constant(tf, torch.from_numpy(rhs),
                                   transposed=spec.transposed,
                                   storage_dtype=sdt)
    else:
        got = tops.penta_constant(tf, torch.from_numpy(rhs),
                                  uniform=spec.uniform,
                                  transposed=spec.transposed,
                                  storage_dtype=sdt)
    assert tops.LAUNCHES == {}, "the plain version counted a kernel launch"
    assert got.dtype == (torch.float64 if storage == "float64"
                         else torch.float32)
    assert _rel(got, want) <= STORAGES[storage]


def test_plain_sweep_refuses_mixed_dtypes():
    spec = tengine.REGISTRY["thomas_constant"]
    with pytest.raises(TypeError, match="dtype"):
        tops.shared_sweep(spec, torch.zeros(3, 4, dtype=torch.float64),
                          torch.zeros(4, 2))


def test_kernel_wrapper_refuses_cpu_tensors():
    spec = tengine.REGISTRY["penta_uniform"]
    with pytest.raises(ValueError, match="CUDA"):
        tops.shared_sweep_cuda(spec, torch.zeros(4, 8), torch.zeros(8, 2),
                               torch.zeros(1))


def test_storage_dtype_names():
    assert tops.canonical_storage_dtype("bf16") is torch.bfloat16
    assert tops.canonical_storage_dtype(None) is None
    with pytest.raises(ValueError):
        tops.canonical_storage_dtype("int8")
