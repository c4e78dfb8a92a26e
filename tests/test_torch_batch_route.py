"""The batch sweep's on-chip route, in plain torch, against the JAX package.

``csrc/batch_sweep.cu`` solves a tridiagonal batch system (cuThomasBatch)
on chip up to ``ops.batch_onchip_max_rows`` (512 rows at float32 and bf16
storage, 256 at float64): each system's rows split into P chunks of
ceil(N / P) rows, the last one ragged; each chunk's 2×2 companion product
(rescaled by powers of two), a fold to each chunk's true c^ start, the
factor re-run from it, and linear folds for the d^ and x carries.
``ops.batch_sweep_plain(..., chunks=P)`` repeats that order in plain
torch; here it is held, on the same seeded numpy inputs with distinct
per-system diagonals and a ragged M, against

  * JAX's batch kernels in interpret mode (resident, the streamed pair,
    the fused call) up to N = 37, and JAX's ``kernels.ref`` oracle at
    every N the route meets: 1, 2, 3, L − 1, L, L + 1, 37, 512, N_max and
    N_max + 1 (L = 16 the rows of a chunk), in the route's chunks and in
    counts that leave a ragged last chunk;
  * dense solves for a Dirichlet last row (c_{N−1} = 0) and for the rolled
    adjoint;
  * a system whose unscaled chunk products overflow fp32 (b in [1e3, 2e3]).

Tolerances (max|Δ| / max|x|): fp32 1e-5, fp64 1e-12 (JAX x64 switched on
for that case only), bf16 storage 1e-5 (both read the same bf16 operands
and compute in fp32).  ``ops.batch_route``'s choices and refusals are
checked too.  The kernel itself is held against this plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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

SPEC = tengine.REGISTRY["thomas_batch"]
M = 130
STORAGES = {"float32": 1e-5, "float64": 1e-12, "bf16": 1e-5}
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "bf16": torch.bfloat16}
JAX_VARIANTS = {"resident": {}, "streamed": {"block_n": 16},
                "fused": {"block_n": 16, "fused": True}}


def _edge_ns(storage: str) -> list:
    """Every N the route meets at ``storage``: a chunk's rows L either side,
    37, 512 and the route's last N and the first past it."""
    dt = _TORCH[storage]
    rows, n_max = tops.BATCH_ROWS, tops.batch_onchip_max_rows(dt)
    return sorted({1, 2, 3, rows - 1, rows, rows + 1, 37, 512, n_max,
                   n_max + 1})


def _chunkings(n: int, storage: str) -> list:
    """The route's chunks (1 on the stream route) and counts whose last
    chunk is ragged (or, past N_max, the on-chip limit's 32 chunks)."""
    route = tops.batch_route(n, _TORCH[storage], 3)
    counts = {route.chunks}
    for p in (2, 3, 5, 32):
        if p <= n:
            counts.add(p)
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
            b_range=(4.0, 5.0)) -> list:
    """Distinct per-system diagonals (n, m), sub-most first, then an RHS.
    The entries outside the matrix (a_0, c_{N-1}) are random too."""
    rng = np.random.default_rng(seed + 1000 * n)
    arrays = [rng.uniform(-1, 1, (n, m)), rng.uniform(*b_range, (n, m)),
              rng.uniform(-1, 1, (n, m)), rng.normal(size=(n, m))]
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
    """JAX's batch solve on ``_inputs(n)`` at ``storage``: one of its
    kernels in interpret mode, or its jnp oracle (``"ref"``), which reads
    bf16-rounded operands in fp32."""
    dtype = np.float64 if storage == "float64" else np.float32
    arrays = _inputs(n, dtype=dtype)
    with _jax_x64(storage == "float64"):
        if variant == "ref":
            if storage == "bf16":
                arrays = [_bf16_rounded(x) for x in arrays]
            return np.asarray(kref.thomas_batch_ref(*map(jnp.asarray,
                                                         arrays)))
        return np.asarray(jops.thomas_batch(
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
def test_chunked_order_matches_jax_kernels(storage, n, variant):
    want = _jax_solution(n, storage, variant)
    for chunks in _chunkings(n, storage):
        assert _rel(_port(n, storage, chunks), want) <= STORAGES[storage], \
            chunks


_ALL = [(storage, n) for storage in sorted(STORAGES)
        for n in _edge_ns(storage)]


@pytest.mark.parametrize("storage,n", _ALL)
def test_chunked_order_matches_jax_reference(storage, n):
    want = _jax_solution(n, storage, "ref")
    for chunks in _chunkings(n, storage):
        assert _rel(_port(n, storage, chunks), want) <= STORAGES[storage], \
            chunks


def _dense(diags: list, j: int) -> np.ndarray:
    a, b, c = (d[:, j] for d in diags)
    return np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)


@pytest.mark.parametrize("chunks", (1, 3, 5, 32))
def test_dirichlet_last_row_matches_dense(chunks):
    """c_{N−1} = 0, as a Dirichlet CN operator's last row has it: the
    chunked order solves the same systems as dense numpy."""
    *diags, rhs = _inputs(37, m=11, seed=5)
    diags[2][-1] = 0
    got = tops.batch_sweep_plain(SPEC, _stored(diags, "float64"),
                                 torch.from_numpy(rhs), chunks=chunks)
    want = np.stack([np.linalg.solve(_dense(diags, j), rhs[:, j])
                     for j in range(rhs.shape[1])], axis=1)
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("chunks", (1, 3, 5, 32))
def test_rolled_adjoint_matches_dense_transposed(chunks):
    """The chunked order on the rolled diagonals (the adjoint's batch
    system; the roll wraps entries across the Dirichlet boundary) solves
    A^T x = rhs for every system."""
    *diags, rhs = _inputs(37, m=11, seed=6)
    stored = dict(zip("abc", _stored(diags, "float64")))
    rolled = tref.transposed_batch_diagonals(3, stored)
    got = tops.batch_sweep_plain(SPEC, list(rolled), torch.from_numpy(rhs),
                                 chunks=chunks)
    want = np.stack([np.linalg.solve(_dense(diags, j).T, rhs[:, j])
                     for j in range(rhs.shape[1])], axis=1)
    assert _rel(got, want) <= 1e-12


def _unscaled_chunk_end(diags: list, s: int, e: int) -> torch.Tensor:
    """The unscaled companion product of rows [s, e) applied to (0, 1), as
    JAX's ``thomas_factor(method="assoc")`` forms it."""
    a, b, c = diags
    num = torch.zeros_like(b[0])
    den = torch.ones_like(b[0])
    for i in range(s, e):
        num, den = c[i] * den, b[i] * den - a[i] * num
    return torch.stack([num, den])


@pytest.mark.parametrize("n,chunks", ((40, 3), (512, 32), (512, 5)))
def test_rescaled_products_stay_finite_where_unscaled_overflow(n, chunks):
    """b in [1e3, 2e3]: a chunk's unscaled companion product overflows
    fp32 (the JAX assoc factor's fault at N = 40); the rescaled order stays
    finite and agrees with the sequential sweep and JAX's oracle."""
    arrays = _inputs(n, dtype=np.float32, seed=7, b_range=(1e3, 2e3))
    *diags, rhs = _stored(arrays, "float32")
    rows = -(-n // chunks)
    assert not torch.isfinite(_unscaled_chunk_end(diags, 0, rows)).all()
    got = tops.batch_sweep_plain(SPEC, diags, rhs, chunks=chunks)
    assert torch.isfinite(got).all()
    seq = tops.batch_sweep_plain(SPEC, diags, rhs, chunks=1)
    assert _rel(got, seq.numpy()) <= 1e-5
    want = np.asarray(kref.thomas_batch_ref(*map(jnp.asarray, arrays)))
    assert _rel(got, want) <= 1e-5


def test_rescaling_is_exact_and_keeps_the_ratio():
    """A product (one column each) out of [2^-60, 2^60] is scaled by one
    power of two into [1/2, 1); one inside, or zero, is left as it is."""
    p = [torch.tensor([2.0 ** 70, 2.0 ** -65, 0.0, 1.5]),
         torch.tensor([3.0, 2.0 ** -63, 0.0, 0.25]),
         torch.tensor([-1.0, 0.0, 0.0, 0.5]),
         torch.tensor([1.0, 2.0 ** -64, 0.0, 1.0])]
    got = tops._rescaled(p)
    big = torch.stack([q.abs() for q in got]).amax(0)
    assert 0.5 <= big[0] < 1 and 0.5 <= big[1] < 1
    assert big[2] == 0 and big[3] == 1.5
    for col in (0, 1):
        ratios = {(r[col] / q[col]).item() for q, r in zip(p, got)
                  if q[col] != 0}
        assert len(ratios) == 1
        assert torch.frexp(torch.tensor(ratios.pop())).mantissa == 0.5
    assert all(torch.equal(q[2:], r[2:]) for q, r in zip(p, got))


@pytest.mark.parametrize("storage", sorted(STORAGES))
def test_cpu_dispatch_runs_the_routes_order(storage):
    """On CPU tensors ``batch_sweep`` runs the plain version in the chunks
    the kernel's route would take."""
    dtype = np.float64 if storage == "float64" else np.float32
    for n in (37, 512):
        *diags, rhs = _stored(_inputs(n, m=9, dtype=dtype), storage)
        route = tops.batch_route(n, rhs.dtype, 3)
        assert torch.equal(
            tops.batch_sweep(SPEC, diags, rhs),
            tops.batch_sweep_plain(SPEC, diags, rhs, chunks=route.chunks))


# -- the route rule ------------------------------------------------------------

@pytest.mark.parametrize("dtype,chunks", ((torch.float32, 32),
                                          (torch.bfloat16, 32),
                                          (torch.float64, 16)))
def test_batch_route_choices(dtype, chunks):
    rows = tops.BATCH_ROWS
    n_max = tops.batch_onchip_max_rows(dtype)
    assert tops.batch_onchip_chunks(dtype) == chunks
    assert n_max == chunks * rows
    assert tops.batch_route(n_max, dtype, 3) == tops.BatchRoute(
        "onchip", chunks, rows)
    assert tops.batch_route(37, dtype, 3) == tops.BatchRoute("onchip", 3, 13)
    assert tops.batch_route(1, dtype, 3) == tops.BatchRoute("onchip", 1, 1)
    assert tops.batch_route(n_max + 1, dtype, 3) == tops.BatchRoute(
        "stream", 1, n_max + 1)
    for n in (1, 37, n_max):   # every pentadiagonal system streams
        assert tops.batch_route(n, dtype, 5).name == "stream"
        assert tops.batch_route(n, dtype, 3, "stream") == tops.BatchRoute(
            "stream", 1, n)
    # (d)'s shape: 32 chunks of 16 rows at float compute, stream at fp64
    assert tops.batch_route(512, dtype, 3).name == (
        "onchip" if chunks == 32 else "stream")


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64,
                                   torch.bfloat16))
def test_batch_route_refusals(dtype):
    n_max = tops.batch_onchip_max_rows(dtype)
    with pytest.raises(ValueError, match="past the on-chip"):
        tops.batch_route(n_max + 1, dtype, 3, "onchip")
    with pytest.raises(ValueError, match="past the on-chip"):
        tops.batch_route(tops.batch_onchip_max_rows(dtype, 5) + 1, dtype, 5,
                         "onchip")
    with pytest.raises(ValueError, match="route must be"):
        tops.batch_route(37, dtype, 3, "partition")


def test_plain_refuses_chunks_it_cannot_take():
    penta = tengine.REGISTRY["penta_batch"]
    diags = [torch.ones(6, 2) for _ in range(5)]
    for spec, bw in ((penta, 5), (SPEC, 3)):
        for chunks in (0, 7):
            with pytest.raises(ValueError, match="at most N"):
                tops.batch_sweep_plain(spec, diags[:bw], torch.ones(6, 2),
                                       chunks=chunks)
