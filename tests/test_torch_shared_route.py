"""The shared sweep's kernel routes and its split sweep, on the CPU.

``repro_torch.kernels.ops.shared_route`` picks, from (N, dtype), the
on-chip route (a tile of 32 columns over all N rows, with the carry
responses after it, in one block's shared memory) or the partitioned route
(row blocks of 512 rows, 256 at fp64: coefficients, summaries, chain and
finish in four launches).  Each tile is swept in row chunks from zero
carries, then fixed up by each chunk's response to a unit carry
(``carry_responses``) times the carry chained over the chunk ends;
``shared_sweep_plain`` repeats that order.  Here:

  * the route rules: N_max = 1614 / 807 / 1614 at fp32 / fp64 / bf16, the
    row blocks and chunks of the partitioned route, a forced route that
    cannot take N raises;
  * the carry responses against the JAX factor (``repro.core``) swept from
    a unit carry by ``jax.lax.scan`` through JAX's own pass table, for all
    six shared specs, at fp64 (max|Δ| ≤ 1e-12 of each response's largest
    value);
  * the split and partitioned plain sweep at chunks ∈ {1, 2, 5, 16} and
    1, 3 or 4 row blocks against the sequential plain sweep (one block, one
    chunk), at N ∈ {1, 2, 3, 37, N_max, N_max + 1} and a ragged M, within
    1e-6 (fp32) / 1e-13 (fp64) of max|x|;
  * the plain sweep in its route's chunks (and in three row blocks)
    against JAX's Pallas shared kernels in interpret mode, for all six
    specs × {fp32, fp64, bf16 storage}, within 1e-5 (1e-12 at fp64).

The kernels themselves are held against this plain version on the card by
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
from repro_torch.kernels import ops

SPECS = sorted(n for n, s in tengine.REGISTRY.items() if s.layout == "shared")
SMEM = 232_448


@contextlib.contextmanager
def _jax_x64(enabled: bool = True):
    if not enabled:
        yield
        return
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _diags(spec, n: int, rng):
    if spec.bandwidth == 3:
        return [rng.uniform(-1, 1, n), 4 + rng.uniform(0, 1, n),
                rng.uniform(-1, 1, n)]
    if spec.uniform:
        return [np.full(n, v) for v in (0.4, -1.6, 3.4, -1.6, 0.4)]
    diags = [rng.uniform(-0.5, 0.5, n) for _ in range(5)]
    diags[2] = diags[2] + 6
    return diags


def _jax_and_port(spec, n: int, dtype, seed: int = 0):
    """(JAX factor, port factor with the JAX factor's own values): both
    stack bitwise the same rows, so bf16 storage rounds them alike."""
    diags = [d.astype(dtype) for d in
             _diags(spec, n, np.random.default_rng(seed + n))]
    if spec.bandwidth == 3:
        jf = jtri.thomas_factor(*(jnp.asarray(d) for d in diags))
        cls = ttri.TridiagFactor
    else:
        jf = jpenta.penta_factor(*(jnp.asarray(d) for d in diags))
        cls = tpenta.PentaFactor
    tf = cls(**{k: torch.from_numpy(np.array(v))
                for k, v in jf._asdict().items()})
    return jf, tf


def _port_operands(spec, tf, dtype):
    """(lhs, eps) as ``ops.thomas_constant`` / ``penta_constant`` stack
    them."""
    if spec.bandwidth == 3:
        lhs = ops.stack_tridiag_lhs(tf, transposed=spec.transposed)
    else:
        lhs = ops.stack_penta_lhs(tf, uniform=spec.uniform,
                                  transposed=spec.transposed)
    eps = ops._uniform_eps_param(tf, dtype) if spec.uniform else None
    return lhs.to(dtype).contiguous(), eps


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

def test_onchip_rows_by_storage():
    assert ops.onchip_max_rows(torch.float32) == 1614
    assert ops.onchip_max_rows(torch.float64) == 807
    assert ops.onchip_max_rows(torch.bfloat16) == 1614   # float tiles


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64,
                                   torch.bfloat16))
def test_route_switches_at_n_max(dtype):
    n_max = ops.onchip_max_rows(dtype)
    itemsize = 8 if dtype == torch.float64 else 4
    assert n_max * (ops.TILE_M + ops.RESP_ROWS) * itemsize <= SMEM
    assert (n_max + 1) * (ops.TILE_M + ops.RESP_ROWS) * itemsize > SMEM
    onchip = ops.shared_route(n_max, dtype)
    assert (onchip.name, onchip.row_blocks) == ("onchip", 1)
    assert onchip.chunks == ops.chunk_count(n_max, dtype) == 16
    past = ops.shared_route(n_max + 1, dtype)
    assert past.name == "partition" and past.row_blocks == 4
    with pytest.raises(ValueError, match="on-chip"):
        ops.shared_route(n_max + 1, dtype, "onchip")
    with pytest.raises(ValueError, match="route"):
        ops.shared_route(64, dtype, "global")


def test_route_at_the_main_path_shapes():
    """(a) and (b) at N = 512 and (k) at N = 1024 take the on-chip route,
    (c) at N = 16384 the partitioned one in 32 row blocks of 512 rows."""
    assert ops.shared_route(512, torch.float32) == ops.SharedRoute(
        "onchip", 1, 8, 32)
    assert ops.shared_route(1024, torch.float32).name == "onchip"
    assert ops.shared_route(1024, torch.float32).chunks == 16
    assert ops.shared_route(16384, torch.float32) == ops.SharedRoute(
        "partition", 32, 8, 32)
    assert ops.shared_route(16384, torch.float64) == ops.SharedRoute(
        "partition", 64, 8, 32)
    assert ops.shared_route(16384, torch.bfloat16).row_blocks == 32
    assert ops.shared_route(16384, torch.float32, "serial") == \
        ops.SharedRoute("serial", 1, 1, 32)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_partition_blocks_are_at_most_a_row_block_and_every_chunk_has_rows(
        dtype):
    rows = ops.ROW_BLOCK_BYTES // (8 if dtype == torch.float64 else 4)
    for n in (1, 2, 3, 37, rows, rows + 1, 1615, 12_000, 16_384, 65_537):
        r = ops.shared_route(n, dtype, "partition")
        bounds = ops.chunk_bounds(n, r.row_blocks)
        assert bounds[0] == 0 and bounds[-1] == n
        assert max(np.diff(bounds)) <= rows
        assert 1 <= r.chunks <= ops.MAX_CHUNKS
        assert n // r.row_blocks >= r.chunks
        spans = ops.split_spans(n, r.row_blocks, r.chunks)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(e > s for s, e in spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_plain_refuses_a_split_without_a_row_per_chunk():
    spec = tengine.REGISTRY["thomas_constant"]
    lhs = torch.ones(3, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="do not split"):
        ops.shared_sweep_plain(spec, lhs, torch.ones(8, 2,
                                                     dtype=torch.float64),
                               blocks=2, chunks=5)


# ---------------------------------------------------------------------------
# Carry responses
# ---------------------------------------------------------------------------

def _jax_unit_carry_sweeps(spec, jf, spans) -> np.ndarray:
    """Each span's forward and backward sweep of a unit carry at each lag,
    run by ``jax.lax.scan`` through JAX's pass table on JAX's stacked rows
    (and its eps operand)."""
    fwd, bwd = jengine.pass_table()[(spec.bandwidth, spec.uniform,
                                     spec.transposed)]
    if spec.bandwidth == 3:
        lhs = jops.stack_tridiag_lhs(jf, transposed=spec.transposed)
        eps = None
    else:
        lhs = jops.stack_penta_lhs(jf, uniform=spec.uniform,
                                   transposed=spec.transposed)
        eps = (jops._uniform_eps_param(jf, jnp.float64)[0, 0]
               if spec.uniform else None)
    order = spec.order
    n = spans[-1][1]
    starts = np.zeros(n, bool)
    ends = np.zeros(n, bool)
    for s, e in spans:
        starts[s] = ends[e - 1] = True

    def sweep(pspec, lag, reverse):
        # one scan over all rows, the carries reset to the unit carry where
        # a span begins (its last row, descending)
        idx = jnp.arange(n)[::-1] if reverse else jnp.arange(n)
        reset = jnp.asarray(ends[::-1] if reverse else starts)
        init = tuple(jnp.asarray(float(lg == lag), jnp.float64)
                     for lg in range(1, order + 1))

        def step(carries, xs):
            i, r = xs
            carries = tuple(jnp.where(r, u, c) for u, c in zip(init, carries))
            acc = jnp.zeros((), jnp.float64)
            for src, lg in pspec.terms:
                c = eps if src == jengine.EPS_PARAM else lhs[src, i]
                acc = acc - c * carries[lg - 1]
            if pspec.scale is not None:
                acc = acc * lhs[pspec.scale, i]
            return (acc,) + carries[:order - 1], acc

        _, vals = jax.lax.scan(step, init, (idx, reset))
        return np.asarray(vals[::-1] if reverse else vals)

    return np.stack([sweep(pspec, lag, reverse)
                     for pspec, reverse in ((fwd, False), (bwd, True))
                     for lag in range(1, order + 1)])


@pytest.mark.parametrize("blocks,chunks", ((1, 1), (1, 5), (3, 4)))
@pytest.mark.parametrize("name", SPECS)
def test_carry_responses_match_the_jax_factor_swept_from_a_unit_carry(
        name, blocks, chunks):
    spec = tengine.REGISTRY[name]
    n = 130
    with _jax_x64():
        jf, tf = _jax_and_port(spec, n, np.float64)
        want = _jax_unit_carry_sweeps(
            spec, jf, ops.split_spans(n, blocks, chunks))
    lhs, eps = _port_operands(spec, tf, torch.float64)
    got = ops.carry_responses(spec, lhs, eps, blocks=blocks, chunks=chunks)
    assert got.dtype == torch.float64 and got.shape == want.shape
    # max|Δ| of each response row against its largest value: a decayed
    # response of the uniform penta factor cancels to ~1e-19 of it
    err = np.abs(got.numpy() - want).max(axis=1)
    assert (err <= 1e-12 * np.abs(want).max(axis=1)).all(), err


# ---------------------------------------------------------------------------
# The split and partitioned sweep
# ---------------------------------------------------------------------------

def _n(n, dtype) -> int:
    if isinstance(n, int):
        return n
    return ops.onchip_max_rows(dtype) + (n == "n_max+1")


@pytest.mark.parametrize("n", (1, 2, 3, 37, "n_max", "n_max+1"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("name", SPECS)
def test_split_sweep_matches_the_sequential_sweep(name, dtype, n):
    """Splits the kernels take (1 or 3 row blocks × 1, 2, 5 or 16 chunks,
    each with a row, and the route's own: 4 row blocks at N_max + 1) give
    the sequential sweep up to rounding."""
    spec = tengine.REGISTRY[name]
    n = _n(n, dtype)
    if spec.bandwidth == 5 and n < 2:
        pytest.skip("the penta factor needs N >= 2")
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with _jax_x64(dtype == torch.float64):
        _, tf = _jax_and_port(spec, n, np_dtype)
    lhs, eps = _port_operands(spec, tf, dtype)
    rhs = torch.from_numpy(
        np.random.default_rng(n).normal(size=(n, 13)).astype(np_dtype))
    want = ops.shared_sweep_plain(spec, lhs, rhs, eps, blocks=1, chunks=1)
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    scale = want.abs().max()
    splits = [(b, c) for b in (1, 3) for c in (1, 2, 5, 16)
              if n // b >= c and (b, c) != (1, 1)]
    # the route's own split, and (N > N_max) the partitioned route's
    route = ops.shared_route(n, dtype)
    splits.append((route.row_blocks, route.chunks))
    for blocks, chunks in splits:
        got = ops.shared_sweep_plain(spec, lhs, rhs, eps, blocks=blocks,
                                     chunks=chunks)
        err = ((got - want).abs().max() / scale).item()
        assert err <= tol, (blocks, chunks, err)


_STORAGE = {"float32": (np.float32, None, 1e-5),
            "float64": (np.float64, None, 1e-12),
            "bf16": (np.float32, "bf16", 1e-5)}


@pytest.mark.parametrize("blocks", (None, 3))
@pytest.mark.parametrize("storage", sorted(_STORAGE))
@pytest.mark.parametrize("name", SPECS)
def test_plain_sweep_matches_pallas(name, storage, blocks):
    """The plain sweep in the chunks of its route (N = 200: 3 chunks at
    fp32, 6 at fp64), or in three row blocks, against JAX's Pallas shared
    kernel (interpret mode) on the same factor and bf16 storage."""
    spec = tengine.REGISTRY[name]
    np_dtype, sdt, tol = _STORAGE[storage]
    n, m = 200, 130
    rhs = np.random.default_rng(5).normal(size=(n, m)).astype(np_dtype)
    with _jax_x64(storage == "float64"):
        jf, tf = _jax_and_port(spec, n, np_dtype)
        kw = {} if spec.bandwidth == 3 else {"uniform": spec.uniform}
        jfn = jops.thomas_constant if spec.bandwidth == 3 \
            else jops.penta_constant
        want = np.asarray(jfn(jf, jnp.asarray(rhs), transposed=spec.transposed,
                              storage_dtype=sdt, **kw))
    stored = ops.canonical_storage_dtype(sdt) or torch.from_numpy(rhs).dtype
    lhs, eps = _port_operands(spec, tf, stored)
    ops.reset_launches()
    if blocks is None:
        fn = ops.thomas_constant if spec.bandwidth == 3 \
            else ops.penta_constant
        got = fn(tf, torch.from_numpy(rhs), transposed=spec.transposed,
                 storage_dtype=sdt, **kw)
        assert ops.shared_route(n, stored).chunks > 1
    else:
        got = ops.shared_sweep_plain(spec, lhs,
                                     torch.from_numpy(rhs).to(stored), eps,
                                     blocks=blocks)
    assert ops.LAUNCHES == {}, "the plain version counted a kernel launch"
    got = got.double().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
