"""The per-system-LHS batch mode of repro_torch against the JAX package.

cuThomasBatch / cuPentBatch: every system carries its own diagonals,
interleaved (N, M) like the RHS, and the factorisation is fused into every
solve.  On the same numpy inputs, made from a seed:

  * the batch specs' structure and byte accounting are the JAX engine's;
  * ``ops.thomas_batch`` / ``penta_batch`` on CPU tensors — the plain
    version of ``csrc/batch_sweep.cu`` — equal JAX's Pallas kernels in
    interpret mode (resident, the streamed pair, the fused call) and its
    ``kernels.ref`` oracles, with DISTINCT per-system diagonals, at N = 37
    and a ragged M = 130.  Tolerances (max|Δ| / max|x|): fp32 1e-5, fp64
    1e-12 (JAX x64 switched on for that test only), bf16 storage 1e-5
    (both read the same bf16 operands and compute in fp32);
  * one case at N = 12288 against JAX's reference solve (not interpret
    mode), and small N against dense numpy solves;
  * the rolled adjoint on distinct per-system diagonals against dense
    transposed solves: the entries ``torch.roll`` wraps across the
    Dirichlet boundary are inert;
  * the solver: ``factorize(mode="batch", backend="auto")`` is ``cuda``;
    ``solve``, ``transpose_solve`` and the gradients of the rhs and the
    (N,) diagonals agree with JAX's ``pallas`` solve and ``jax.grad`` at
    1e-5; periodic batch stays on ``reference``.

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

import repro.solver as jsolver
from repro.kernels import engine as jengine
from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro_torch.kernels import engine as tengine
from repro_torch.kernels import ops as tops
from repro_torch.solver import (BandedSystem, factorize, plan, solve,
                                transpose_solve)
from repro_torch.solver import reference as tref

N, M = 37, 130
BATCH_SPECS = ("thomas_batch", "penta_batch")
STORAGES = {"float32": 1e-5, "float64": 1e-12, "bf16": 1e-5}
# JAX's three TPU tilings of the batch kernel, and its jnp oracle
JAX_VARIANTS = {"resident": {}, "streamed": {"block_n": 16},
                "fused": {"block_n": 16, "fused": True}, "ref": None}


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


def _batch_inputs(bw: int, n: int = N, m: int = M, dtype=np.float32,
                  seed: int = 0) -> list:
    """Distinct, diagonally dominant per-system diagonals (n, m), sub-most
    first, then an (n, m) RHS.  The entries outside the matrix (a_0, the
    last super-diagonal entries, …) are random too: they must be inert."""
    rng = np.random.default_rng(seed + bw)
    if bw == 3:
        diags = [rng.uniform(-1, 1, (n, m)), 4 + rng.uniform(0, 1, (n, m)),
                 rng.uniform(-1, 1, (n, m))]
    else:
        diags = [rng.uniform(-0.5, 0.5, (n, m)) for _ in range(5)]
        diags[2] = diags[2] + 6
    return [x.astype(dtype) for x in (*diags, rng.normal(size=(n, m)))]


def _bf16_rounded(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _dense(diags: list, j: int) -> np.ndarray:
    """System j's matrix: row i holds diag_k[i, j] at column i + off_k."""
    n = diags[0].shape[0]
    half = len(diags) // 2
    out = np.zeros((n, n))
    for off, diag in zip(range(-half, half + 1), diags):
        if abs(off) >= n:
            continue
        v = diag[:, j].astype(np.float64)
        out += np.diag(v[-off:] if off < 0 else v[:n - off], off)
    return out


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _port_batch(bw: int, arrays: list, storage_dtype=None) -> torch.Tensor:
    fn = tops.thomas_batch if bw == 3 else tops.penta_batch
    return fn(*(torch.from_numpy(x) for x in arrays),
              storage_dtype=storage_dtype)


# -- accounting ----------------------------------------------------------------

def test_batch_backward_table_is_the_jax_engines():
    def as_tuple(p):
        return tuple(tuple(t) for t in p.terms), p.scale
    assert ({k: as_tuple(p) for k, p in tengine.batch_backward_table().items()}
            == {k: as_tuple(p)
                for k, p in jengine.batch_backward_table().items()})


@pytest.mark.parametrize("name", BATCH_SPECS)
def test_batch_spec_structure_and_traffic_match_jax(name):
    spec, jspec = tengine.REGISTRY[name], jengine.REGISTRY[name]
    assert (spec.layout, spec.order, spec.n_coefs, spec.lhs_rows,
            spec.mode) == (jspec.layout, jspec.order, jspec.n_coefs,
                           jspec.lhs_rows, jspec.mode)
    assert spec.passes()[0] is None and jspec.passes()[0] is None
    assert spec.passes()[1] == tengine.batch_backward_table()[spec.order]
    for n, m in ((1, 1), (37, 130), (512, 1 << 20), (16384, 4096)):
        assert spec.traffic_words(n, m) == jspec.traffic_words(n, m)
        assert spec.traffic_words(n, m) == (spec.bandwidth + 2) * n * m
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.float64, jnp.float64)):
        assert spec.traffic_bytes(512, 4096, dt) == \
            jspec.traffic_bytes(512, 4096, jdt)
    assert spec.traffic_bytes(512, 4096, torch.float32, torch.bfloat16) == \
        jspec.traffic_bytes(512, 4096, jnp.float32, jnp.bfloat16)
    assert tengine.find_spec(spec.bandwidth, "batch") == spec


def test_batch_spec_refuses_transposed_and_uniform():
    with pytest.raises(ValueError, match="rolling"):
        tengine.SweepSpec(3, layout="batch", transposed=True)
    with pytest.raises(ValueError, match="uniform"):
        tengine.SweepSpec(5, layout="batch", uniform=True)
    with pytest.raises(ValueError, match="layout"):
        tengine.SweepSpec(3, layout="banded")


# -- kernel level: the plain version against JAX ------------------------------

@pytest.mark.parametrize("variant", sorted(JAX_VARIANTS))
@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("name", BATCH_SPECS)
def test_batch_solves_match_jax(name, storage, variant):
    bw = tengine.REGISTRY[name].bandwidth
    dtype = np.float64 if storage == "float64" else np.float32
    sdt = "bf16" if storage == "bf16" else None
    arrays = _batch_inputs(bw, dtype=dtype)
    with _jax_x64(storage == "float64"):
        if variant == "ref":
            # the jnp oracle reads the bf16-rounded operands in fp32
            ref_in = [_bf16_rounded(x) for x in arrays] if sdt else arrays
            fn = kref.thomas_batch_ref if bw == 3 else kref.penta_batch_ref
            want = fn(*map(jnp.asarray, ref_in))
        else:
            fn = jops.thomas_batch if bw == 3 else jops.penta_batch
            want = fn(*map(jnp.asarray, arrays), storage_dtype=sdt,
                      **JAX_VARIANTS[variant])
        want = np.asarray(want)
    tops.reset_launches()
    got = _port_batch(bw, arrays, sdt)
    assert tops.LAUNCHES == {}, "the plain version counted a kernel launch"
    assert got.dtype == (torch.float64 if storage == "float64"
                         else torch.float32)
    assert _rel(got, want) <= STORAGES[storage]


@pytest.mark.parametrize("name", BATCH_SPECS)
def test_batch_solve_at_large_n_matches_jax_reference(name):
    bw = tengine.REGISTRY[name].bandwidth
    arrays = _batch_inputs(bw, n=12288, m=8, seed=7)
    fn = kref.thomas_batch_ref if bw == 3 else kref.penta_batch_ref
    want = np.asarray(fn(*map(jnp.asarray, arrays)))
    assert _rel(_port_batch(bw, arrays), want) <= 1e-5


@pytest.mark.parametrize("n", (1, 2, 3, 5))
@pytest.mark.parametrize("name", BATCH_SPECS)
def test_batch_solve_matches_dense_at_small_n(name, n):
    bw = tengine.REGISTRY[name].bandwidth
    *diags, rhs = _batch_inputs(bw, n=n, m=7, dtype=np.float64, seed=n)
    got = _port_batch(bw, [*diags, rhs])
    want = np.stack([np.linalg.solve(_dense(diags, j), rhs[:, j])
                     for j in range(rhs.shape[1])], axis=1)
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("name", BATCH_SPECS)
def test_rolled_adjoint_solves_the_transposed_systems(name):
    """The forward batch sweep on the rolled per-system diagonals solves
    A^T x = rhs for every system, though the roll wraps entries across the
    Dirichlet boundary."""
    bw = tengine.REGISTRY[name].bandwidth
    *diags, rhs = _batch_inputs(bw, m=11, dtype=np.float64, seed=3)
    names = ("a", "b", "c", "d", "e")[:bw]
    stored = {k: torch.from_numpy(v) for k, v in zip(names, diags)}
    rolled = tref.transposed_batch_diagonals(bw, stored)
    got = _port_batch(bw, [t.numpy() for t in rolled] + [rhs])
    want = np.stack([np.linalg.solve(_dense(diags, j).T, rhs[:, j])
                     for j in range(rhs.shape[1])], axis=1)
    assert _rel(got, want) <= 1e-12


def test_batch_sweep_refuses_mixed_dtypes_and_cpu_kernel_calls():
    spec = tengine.REGISTRY["thomas_batch"]
    diags = [torch.zeros(4, 2) for _ in range(3)]
    with pytest.raises(TypeError, match="dtype"):
        tops.batch_sweep(spec, diags, torch.zeros(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        tops.batch_sweep_cuda(spec, diags, torch.zeros(4, 2))
    with pytest.raises(ValueError, match="batch spec"):
        tops.batch_sweep_cuda(tengine.REGISTRY["penta_batch"], diags,
                              torch.zeros(4, 2))


# -- solver level ----------------------------------------------------------------

def _diags_1d(bw: int) -> list:
    rng = np.random.default_rng(20 + bw)
    if bw == 3:
        diags = [rng.uniform(-1, 1, N), 4 + rng.uniform(0, 1, N),
                 rng.uniform(-1, 1, N)]
    else:
        diags = [rng.uniform(-0.5, 0.5, N) for _ in range(5)]
        diags[2] = diags[2] + 6
    return [d.astype(np.float32) for d in diags]


@pytest.mark.parametrize("bw", (3, 5))
def test_batch_solver_and_grads_match_jax_pallas(bw):
    diags = _diags_1d(bw)
    rhs = np.random.default_rng(5).normal(size=(N, M)).astype(np.float32)
    jctor = (jsolver.BandedSystem.tridiag if bw == 3
             else jsolver.BandedSystem.penta)
    jfact = jsolver.factorize(jctor(*diags, n=N, mode="batch", batch=M),
                              backend="pallas")
    jrhs = jnp.asarray(rhs)
    want_x = np.asarray(jsolver.solve(jfact, jrhs))
    want_xt = np.asarray(jsolver.transpose_solve(jfact, jrhs))
    jbar, jrhs_bar = jax.grad(
        lambda f, r: jnp.sum(jsolver.solve(f, r) ** 2),
        argnums=(0, 1))(jfact, jrhs)

    ctor = BandedSystem.tridiag if bw == 3 else BandedSystem.penta
    tdiags = [torch.tensor(d, requires_grad=True) for d in diags]
    system = ctor(*tdiags, n=N, mode="batch", batch=M, device="cpu")
    fact = factorize(system, backend="auto")
    assert fact.backend == "cuda"
    assert plan(system, backend="auto").backend == "cuda"
    trhs = torch.tensor(rhs, requires_grad=True)
    x = solve(fact, trhs)
    assert _rel(x, want_x) <= 1e-5
    assert _rel(transpose_solve(fact, trhs.detach()), want_xt) <= 1e-5
    (x ** 2).sum().backward()
    assert _rel(trhs.grad, jrhs_bar) <= 1e-5
    for got, want in zip(tdiags, jbar.diagonals):
        assert _rel(got.grad, want) <= 1e-5


@pytest.mark.parametrize("bw", (3, 5))
def test_periodic_batch_stays_on_reference(bw):
    ctor = BandedSystem.tridiag if bw == 3 else BandedSystem.penta
    diags = [torch.from_numpy(d) for d in _diags_1d(bw)]
    system = ctor(*diags, n=N, periodic=True, mode="batch", batch=M,
                  device="cpu")
    assert factorize(system, backend="auto").backend == "reference"
    assert plan(system, backend="auto").backend == "reference"
    with pytest.raises(NotImplementedError, match="periodic"):
        factorize(system, backend="cuda")


def test_batch_storage_dtype_rides_in_the_meta():
    ctor = BandedSystem.penta
    diags = [torch.from_numpy(d) for d in _diags_1d(5)]
    fact = factorize(ctor(*diags, n=N, mode="batch", batch=M, device="cpu"),
                     backend="cuda", storage_dtype="bf16")
    assert fact.meta.opt("storage_dtype") is torch.bfloat16
    rhs = np.random.default_rng(6).normal(size=(N, M)).astype(np.float32)
    want = solve(factorize(ctor(*diags, n=N, mode="batch", batch=M,
                                device="cpu"), backend="cuda"),
                 torch.from_numpy(rhs))
    got = solve(fact, torch.from_numpy(rhs))
    assert got.dtype == torch.float32
    assert _rel(got, want.numpy()) <= 1e-2
