"""The pentadiagonal batch sweep's six-minor split, in plain torch,
against the JAX package and dense solves.

``csrc/batch_sweep.cu`` solves a pentadiagonal batch system (cuPentBatch)
on chip up to ``ops.batch_onchip_max_rows(dtype, 5)`` (512 rows at float32
and bf16 storage, 256 at float64; ``batch_penta_kernel``) only when that
route is forced: ``ops.batch_route`` streams every pentadiagonal system
(one chunk in the sequential sweep's order).  The six-minor split cuts each system's rows
into P chunks of ceil(N / P) rows, the last one ragged; each chunk's 6×6
product of its rows' maps on the six Plücker coordinates of the factor's
state plane (rescaled by powers of two), a fold to each chunk's start in
echelon form, the factor re-run from it (its first row in that form), and
linear folds of two carries for g and for x.
``ops.batch_sweep_plain(..., chunks=P)`` runs that order in plain torch
(the CPU dispatch in the route's chunks); here it is held, on seeded numpy
inputs with distinct per-system diagonals and a ragged M, against

  * JAX's batch kernels in interpret mode (resident, the streamed pair,
    the fused call) up to N = 37, and JAX's ``kernels.ref`` oracle at
    1, 2, 3, L − 1, L, L + 1, 37, 512, N_max and N_max + 1 (L = 16 rows a
    chunk, N_max the tridiagonal on-chip route's last N: 512 at float32
    and bf16 storage, 256 at float64), in that route's chunks of L rows
    and in counts that leave a ragged last chunk or one-row chunks;
  * dense solves where the outer band vanishes (e = 0 on every other row,
    on every chunk's first row, on the row before it), with one-row
    chunks, and for the rolled adjoint (whose wrapped entries hold a_0,
    a_1, here also zero);
  * systems whose unscaled chunk products overflow fp32 (c in [1e3, 2e3]);
  * at the on-chip route's own edges (N = 1, 2, 3, a chunk's rows L_p − 1,
    L_p, L_p + 1, its last N and the first past it; L_p = 32 at float32
    and bf16 and float64), in the route's chunks with e = 0 on every
    third row, on every chunk's first row and on the row before it: JAX's
    resident kernel in interpret mode up to N = 64, its oracle past that.

Tolerances (max|Δ| / max|x|): fp32 1e-5, fp64 1e-12 (JAX x64 switched on
for that case only), bf16 storage 1e-5 (both read the same bf16 operands
and compute in fp32).
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro_torch.kernels import engine as tengine
from repro_torch.kernels import ops as tops
from repro_torch.solver import reference as tref

SPEC = tengine.REGISTRY["penta_batch"]
M = 130
STORAGES = {"float32": 1e-5, "float64": 1e-12, "bf16": 1e-5}
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "bf16": torch.bfloat16}
JAX_VARIANTS = {"resident": {}, "streamed": {"block_n": 16},
                "fused": {"block_n": 16, "fused": True}}


def _edge_ns(storage: str) -> list:
    """The N held at ``storage``: a chunk's rows L either side, 37, 512,
    N_max and the first N past it."""
    rows, n_max = tops.BATCH_ROWS, tops.batch_onchip_max_rows(
        _TORCH[storage])
    return sorted({1, 2, 3, rows - 1, rows, rows + 1, 37, 512, n_max,
                   n_max + 1})


def _chunkings(n: int, storage: str) -> list:
    """The penta route's chunks, the tridiagonal on-chip route's chunks of
    L rows (up to N_max), counts whose last chunk is ragged, 32 chunks
    and, up to 37 rows, one row a chunk."""
    dt = _TORCH[storage]
    counts = {tops.batch_route(n, dt, 5).chunks}
    if n <= tops.batch_onchip_max_rows(dt):
        counts.add(tops.batch_route(n, dt, 3).chunks)
    counts |= {p for p in (2, 3, 5, 32) if p <= n}
    if n <= 37:
        counts.add(n)
    return sorted(counts)


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


def _inputs(n: int, m: int = M, dtype=np.float64, seed: int = 0,
            c_range=(4.0, 5.0)) -> list:
    """Distinct per-system diagonals (n, m), sub-most first, then an RHS.
    The entries outside the matrix (a_0, a_1, b_0, d_{N-1}, e_{N-2},
    e_{N-1}) are random too."""
    rng = np.random.default_rng(seed + 1000 * n)
    arrays = [rng.uniform(-1, 1, (n, m)) for _ in range(5)]
    arrays[2] = rng.uniform(*c_range, (n, m))
    arrays.append(rng.normal(size=(n, m)))
    return [x.astype(dtype) for x in arrays]


def _bf16_rounded(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _stored(arrays: list, storage: str) -> list:
    return [torch.from_numpy(x).to(_TORCH[storage]) for x in arrays]


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _jax_solution(n: int, storage: str, variant: str) -> np.ndarray:
    """JAX's penta batch solve on ``_inputs(n)`` at ``storage``: one of its
    kernels in interpret mode, or its jnp oracle (``"ref"``), which reads
    bf16-rounded operands in fp32."""
    dtype = np.float64 if storage == "float64" else np.float32
    arrays = _inputs(n, dtype=dtype)
    with _jax_x64(storage == "float64"):
        if variant == "ref":
            if storage == "bf16":
                arrays = [_bf16_rounded(x) for x in arrays]
            return np.asarray(kref.penta_batch_ref(*map(jnp.asarray,
                                                        arrays)))
        return np.asarray(jops.penta_batch(
            *map(jnp.asarray, arrays),
            storage_dtype="bf16" if storage == "bf16" else None,
            **JAX_VARIANTS[variant]))


def _port(n: int, storage: str, chunks: int) -> torch.Tensor:
    dtype = np.float64 if storage == "float64" else np.float32
    *diags, rhs = _stored(_inputs(n, dtype=dtype), storage)
    tops.reset_launches()
    got = tops.batch_sweep_plain(SPEC, diags, rhs, chunks=chunks)
    assert tops.LAUNCHES == {}, "the plain version counted a kernel launch"
    assert got.dtype == tengine.compute_dtype(_TORCH[storage])
    return got


_SMALL = [(storage, n, variant) for storage in sorted(STORAGES)
          for n in _edge_ns(storage) if n <= 37
          for variant in sorted(JAX_VARIANTS)]


@pytest.mark.parametrize("storage,n,variant", _SMALL)
def test_penta_chunked_order_matches_jax_kernels(storage, n, variant):
    want = _jax_solution(n, storage, variant)
    for chunks in _chunkings(n, storage):
        assert _rel(_port(n, storage, chunks), want) <= STORAGES[storage], \
            chunks


_ALL = [(storage, n) for storage in sorted(STORAGES)
        for n in _edge_ns(storage)]


@pytest.mark.parametrize("storage,n", _ALL)
def test_penta_chunked_order_matches_jax_reference(storage, n):
    want = _jax_solution(n, storage, "ref")
    for chunks in _chunkings(n, storage):
        assert _rel(_port(n, storage, chunks), want) <= STORAGES[storage], \
            chunks


def _dense(diags: list, j: int) -> np.ndarray:
    n = diags[0].shape[0]
    out = np.zeros((n, n))
    for off, d in zip(range(-2, 3), diags):
        rows = np.arange(max(0, -off), min(n, n - off))
        out[rows, rows + off] = d[rows, j]
    return out


def _dense_solution(diags: list, rhs: np.ndarray, transposed=False):
    def one(j):
        a = _dense(diags, j)
        return np.linalg.solve(a.T if transposed else a, rhs[:, j])
    return np.stack([one(j) for j in range(rhs.shape[1])], axis=1)


def _chunk_starts(n: int, chunks: int) -> list:
    rows = -(-n // chunks)
    return list(range(0, n, rows))


_ZERO_E = ("alternate", "chunk_starts", "before_chunk_starts", "all")


@pytest.mark.parametrize("pattern", _ZERO_E)
@pytest.mark.parametrize("chunks", (2, 3, 5, 32, 37))
def test_zero_outer_band_rows_match_dense(pattern, chunks):
    """e = 0 where a chunk's start cannot be recovered from (γ, δ) at lags
    1 and 2 (δ_{s−1} = 0 on the row before a chunk's first) and elsewhere:
    the chunked order divides by nothing there and solves the same
    systems as dense numpy."""
    n = 37
    *diags, rhs = _inputs(n, m=11, seed=11)
    starts = _chunk_starts(n, chunks)
    rows = {"alternate": list(range(0, n, 2)), "chunk_starts": starts,
            "before_chunk_starts": [s - 1 for s in starts if s > 0],
            "all": list(range(n))}[pattern]
    diags[4][rows] = 0
    got = tops.batch_sweep_plain(SPEC, _stored(diags, "float64"),
                                 torch.from_numpy(rhs), chunks=chunks)
    assert _rel(got, _dense_solution(diags, rhs)) <= 1e-12


@pytest.mark.parametrize("n", (2, 3, 5, 16, 17, 37))
def test_one_row_chunks_match_dense(n):
    """One row a chunk: a chunk's row s − 2 lies two chunks back, and its
    g carry g′_{s−2} = g_{s−2} − γ_{s−2} g_{s−1} takes γ_{s−2} from the
    fold's start."""
    *diags, rhs = _inputs(n, m=11, seed=12)
    got = tops.batch_sweep_plain(SPEC, _stored(diags, "float64"),
                                 torch.from_numpy(rhs), chunks=n)
    assert _rel(got, _dense_solution(diags, rhs)) <= 1e-12


@pytest.mark.parametrize("zero_wrap", (False, True))
@pytest.mark.parametrize("chunks", (1, 3, 5, 32, 37))
def test_rolled_adjoint_matches_dense_transposed(chunks, zero_wrap):
    """The chunked order on the rolled diagonals (the adjoint's batch
    system: rolled e holds a_0 and a_1 in its last two rows, rolled a and
    b hold e and d's last entries in their first) solves A^T x = rhs for
    every system, also where a_0 = a_1 = 0 puts e = 0 rows at the end."""
    *diags, rhs = _inputs(37, m=11, seed=6)
    if zero_wrap:
        diags[0][:2] = 0
    stored = dict(zip("abcde", _stored(diags, "float64")))
    rolled = tref.transposed_batch_diagonals(5, stored)
    got = tops.batch_sweep_plain(SPEC, list(rolled), torch.from_numpy(rhs),
                                 chunks=chunks)
    assert _rel(got, _dense_solution(diags, rhs, transposed=True)) <= 1e-12


def _unscaled_product(diags: list, s: int, e: int) -> torch.Tensor:
    """The unscaled 6×6 product of rows [s, e) (every column from the
    identity), without the power-of-two rescale."""
    eye = torch.eye(6, dtype=diags[0].dtype)
    p = [eye[k][:, None].expand(6, diags[0].shape[1]) for k in range(6)]
    for i in range(s, e):
        p = tops._plucker_row(p, *(d[i] for d in diags))
    return torch.stack(p)


@pytest.mark.parametrize("n,chunks", ((40, 3), (512, 32), (512, 5)))
def test_rescaled_products_stay_finite_where_unscaled_overflow(n, chunks):
    """c in [1e3, 2e3]: a chunk's unscaled 6×6 product overflows fp32; the
    rescaled order stays finite and agrees with the sequential sweep and
    JAX's oracle."""
    arrays = _inputs(n, dtype=np.float32, seed=7, c_range=(1e3, 2e3))
    *diags, rhs = _stored(arrays, "float32")
    rows = -(-n // chunks)
    assert not torch.isfinite(_unscaled_product(diags, rows, 2 * rows)).all()
    got = tops.batch_sweep_plain(SPEC, diags, rhs, chunks=chunks)
    assert torch.isfinite(got).all()
    seq = tops.batch_sweep_plain(SPEC, diags, rhs, chunks=1)
    assert _rel(got, seq.numpy()) <= 1e-5
    want = np.asarray(kref.penta_batch_ref(*map(jnp.asarray, arrays)))
    assert _rel(got, want) <= 1e-5


def test_plucker_row_is_the_factor_step():
    """From the state of U rows i − 2 and i − 1 with p01 = 1, one row's
    map gives α_i p01 and α_i (γ_i, δ_i) in p02, p03: the sequential
    factor's pivot and coefficients (``_factor_pass``, order 2)."""
    rng = np.random.default_rng(3)
    g2, d2, g1, d1 = rng.uniform(-1, 1, 4)
    a, b, c, d, e = rng.uniform(-1, 1, 5) + np.array([0, 0, 4, 0, 0])
    # the 2x2 minors of [[1, g2, d2, 0], [0, 1, g1, d1]]
    p = [1.0, g1, d1, g2 * g1 - d2, g2 * d1, d2 * d1]
    q = tops._plucker_row(p, a, b, c, d, e)
    beta = b - a * g2
    alpha = c - a * d2 - beta * g1
    np.testing.assert_allclose(q[0], alpha, rtol=1e-13)
    np.testing.assert_allclose(q[1] / q[0], (d - beta * d1) / alpha,
                               rtol=1e-13)
    np.testing.assert_allclose(q[2] / q[0], e / alpha, rtol=1e-13)


@pytest.mark.parametrize("storage", sorted(STORAGES))
def test_cpu_dispatch_runs_the_penta_routes_order(storage):
    """On CPU tensors ``batch_sweep`` runs the plain version in the chunks
    the kernel's route takes: the stream route's one chunk at every N, up
    to the on-chip tile's last N and past it, the sequential sweep's
    order."""
    dtype = np.float64 if storage == "float64" else np.float32
    n_max = tops.batch_onchip_max_rows(_TORCH[storage], 5)
    for n in (37, n_max, n_max + 1):
        *diags, rhs = _stored(_inputs(n, m=9, dtype=dtype), storage)
        assert tops.batch_route(n, rhs.dtype, 5) == tops.BatchRoute(
            "stream", 1, n)
        assert torch.equal(
            tops.batch_sweep(SPEC, diags, rhs),
            tops.batch_sweep_plain(SPEC, diags, rhs, chunks=1))


def _route_edges(storage: str) -> list:
    """The on-chip route's edges at ``storage``: 1, 2, 3, a chunk's rows
    L_p either side, its last N and the first N past it."""
    dt = _TORCH[storage]
    rows = tops.batch_onchip_rows(dt, 5)
    n_max = tops.batch_onchip_max_rows(dt, 5)
    return sorted({1, 2, 3, rows - 1, rows, rows + 1, n_max, n_max + 1})


def _route_chunks(n: int, storage: str) -> int:
    """The chunks the on-chip tile takes at N, forced (the rule streams),
    one past its last N."""
    dt = _TORCH[storage]
    if n > tops.batch_onchip_max_rows(dt, 5):
        return tops.batch_route(n, dt, 5).chunks
    return tops.batch_route(n, dt, 5, "onchip").chunks


def _zero_e_inputs(n: int, storage: str) -> list:
    """``_inputs(n)`` with e = 0 on every third row, on the route's chunks'
    first rows and on the rows before them."""
    dtype = np.float64 if storage == "float64" else np.float32
    arrays = _inputs(n, dtype=dtype, seed=21)
    starts = _chunk_starts(n, _route_chunks(n, storage))
    rows = set(range(0, n, 3)) | set(starts) | {s - 1 for s in starts if s}
    arrays[4][sorted(rows)] = 0
    return arrays


_ROUTE_CASES = [(storage, n) for storage in sorted(STORAGES)
                for n in _route_edges(storage)]


@pytest.mark.parametrize("storage,n", [c for c in _ROUTE_CASES if c[1] <= 64])
def test_route_order_matches_jax_kernel_at_its_edges(storage, n):
    """The route's chunked order on zero-e rows against JAX's resident
    penta batch kernel in interpret mode (one jit a case)."""
    arrays = _zero_e_inputs(n, storage)
    with _jax_x64(storage == "float64"):
        want = np.asarray(jops.penta_batch(
            *map(jnp.asarray, arrays),
            storage_dtype="bf16" if storage == "bf16" else None))
    *diags, rhs = _stored(arrays, storage)
    got = tops.batch_sweep_plain(SPEC, diags, rhs,
                                 chunks=_route_chunks(n, storage))
    assert _rel(got, want) <= STORAGES[storage]


@pytest.mark.parametrize("storage,n", [c for c in _ROUTE_CASES if c[1] > 64])
def test_route_order_matches_jax_reference_at_its_edges(storage, n):
    """Past N = 64 (the route's last N and the first past it, a chunk's
    rows + 1 at float32 and bf16): against JAX's jnp oracle, which reads
    bf16-rounded operands in fp32."""
    arrays = _zero_e_inputs(n, storage)
    ref = [_bf16_rounded(x) for x in arrays] if storage == "bf16" \
        else arrays
    with _jax_x64(storage == "float64"):
        want = np.asarray(kref.penta_batch_ref(*map(jnp.asarray, ref)))
    *diags, rhs = _stored(arrays, storage)
    got = tops.batch_sweep_plain(SPEC, diags, rhs,
                                 chunks=_route_chunks(n, storage))
    assert _rel(got, want) <= STORAGES[storage]
