"""The fused CN steps' kernel routes and the split sweep, on the CPU.

``repro_torch.kernels.fused_cn.route`` picks, from (N, dtype), the on-chip
route (a tile of 32 columns over all N rows, with 4 rows of carry
responses, in one block's shared memory) or, past it, the partitioned
route (row blocks of 512 rows at fp32, 256 at fp64: K0 coefficients, K1
summaries of the stencil RHS, K2 the chain and the correction's inputs, K3
each block's tile); the global route (each column walked through device
memory) is reached only when forced.  The tile kernels sweep each column
in ``chunk_count`` row chunks from zero carries and add each chunk's
response to a unit carry (``carry_responses``) times the carry chained
over the chunk ends; the plain versions repeat that order.  Here:

  * the route and chunk rules: N = 512 fp32 goes on chip, N_max + 1 and
    N = 12,000 (which the JAX step takes) go to the partitioned route and
    never to the global one, N_max at fp64 is half that at fp32 within one
    row, and every tile of either route fits the 232,448 bytes of shared
    memory a block may opt in to, with the rows its chunks' carries need;
  * the carry responses against the JAX factor's fields swept from a unit
    carry by ``jax.lax.scan``, at fp64 (1e-12);
  * the split plain sweep against the one-chunk sweep at fp64 (1e-12) and
    against JAX's fused steps (interpret mode) at N = 512, fp32 (1e-5),
    where the on-chip route runs 8 chunks;
  * the partitioned plain step against the sequential one at fp64
    (1e-12), with wrapping halos and ragged blocks, and against JAX's
    fused steps at fp32 (1e-5) in at least three row blocks; K2's
    correction inputs against the sequential backward sweep's end rows;
  * the kernel library's name changes with a header its source includes.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jkernels
from repro.core import periodic_penta_factor as j_penta_factor
from repro.core import periodic_thomas_factor as j_thomas_factor
from repro_torch.convert import from_jax_periodic_factor
from repro_torch.kernels import engine, fused_cn, ops

SMEM = 232_448
DTYPES = (torch.float32, torch.float64)


@contextlib.contextmanager
def _jax_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Routes and chunks
# ---------------------------------------------------------------------------

def test_route_takes_the_main_path_shape_on_chip():
    assert fused_cn.route(512, torch.float32) == ("onchip", 512 * 36 * 4)
    assert fused_cn.route(512, torch.float64) == ("onchip", 512 * 36 * 8)
    assert fused_cn.sweep_chunks(512, torch.float32) == 8
    assert fused_cn.sweep_chunks(512, torch.float64) == 16


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_sends_n_past_shared_memory_to_the_partitioned_route(dtype):
    n_max = fused_cn.onchip_max_rows(dtype)
    rows = 2048 // _itemsize(dtype)      # a row block: 512 fp32, 256 fp64
    assert fused_cn.route(n_max, dtype)[0] == "onchip"
    for n in (n_max + 1, 4096, 12_000):
        blocks = -(-n // rows)
        assert fused_cn.route(n, dtype) == (
            "partition", -(-n // blocks) * 36 * _itemsize(dtype))
        assert fused_cn.row_blocks(n, dtype) == blocks
        assert fused_cn.sweep_chunks(n, dtype) == fused_cn.chunk_count(
            n // blocks, dtype)
    assert fused_cn.row_blocks(12_000, torch.float32) == 24
    # the global route, reached only when forced, sweeps whole columns
    assert all(fused_cn.route(n, dtype)[0] != "global"
               for n in range(1, 20_000, 97))
    assert fused_cn.sweep_chunks(n_max + 1, dtype, "global") == 1
    assert fused_cn.sweep_chunks(512, dtype, "global") == 1
    assert fused_cn.row_blocks(12_000, dtype, "global") == 1
    assert fused_cn.launch_name("tridiag", "onchip") == "fused_cn_tridiag"
    assert fused_cn.launch_name("tridiag", "partition") == \
        "fused_cn_tridiag_partition"
    assert fused_cn.launch_name("penta", "global") == "fused_cn_penta_global"


def test_onchip_rows_halve_at_fp64():
    n32 = fused_cn.onchip_max_rows(torch.float32)
    n64 = fused_cn.onchip_max_rows(torch.float64)
    assert (n32, n64) == (1614, 807)
    assert abs(n64 - n32 / 2) <= 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_onchip_tile_at_n_max_fits_shared_memory(dtype):
    n_max = fused_cn.onchip_max_rows(dtype)
    need = fused_cn.route(n_max, dtype)[1]
    assert need == n_max * (fused_cn.TILE_M + fused_cn.RESP_ROWS) \
        * _itemsize(dtype)
    assert need <= SMEM
    assert (n_max + 1) * (fused_cn.TILE_M + fused_cn.RESP_ROWS) \
        * _itemsize(dtype) > SMEM


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_partitioned_tile_fits_with_the_rows_its_carries_need(dtype):
    """Past N_max, to well past the JAX step's 12,000 rows: the largest row
    block's tile fits shared memory, and every chunk of every block has at
    least two rows (the penta carries span two)."""
    n_max = fused_cn.onchip_max_rows(dtype)
    for n in list(range(n_max + 1, n_max + 600)) + list(range(2 * n_max,
                                                              40_000, 131)):
        which, smem = fused_cn.route(n, dtype)
        assert which == "partition" and smem <= SMEM
        blocks = fused_cn.row_blocks(n, dtype)
        chunks = fused_cn.sweep_chunks(n, dtype)
        assert blocks >= 2 and 1 <= chunks <= fused_cn.MAX_CHUNKS
        spans = ops.split_spans(n, blocks, chunks)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert min(e - s for s, e in spans) >= 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_onchip_chunk_has_the_rows_its_carries_need(dtype):
    """Every N on chip splits into 1..16 chunks of at least two rows (the
    penta carries span two), and the bounds tile [0, N)."""
    for n in range(2, fused_cn.onchip_max_rows(dtype) + 1):
        p = fused_cn.chunk_count(n, dtype)
        assert 1 <= p <= fused_cn.MAX_CHUNKS
        bounds = fused_cn.chunk_bounds(n, p)
        assert bounds[0] == 0 and bounds[-1] == n
        assert min(np.diff(bounds)) >= 2


# ---------------------------------------------------------------------------
# Carry responses
# ---------------------------------------------------------------------------

def _factors(kind: str, n: int, rng, dtype=np.float64):
    """(JAX periodic factor, the port's copy) of a diagonally dominant
    periodic operator with distinct rows."""
    if kind == "tridiag":
        diags = [rng.uniform(-1, 1, n), 4 + rng.uniform(0, 1, n),
                 rng.uniform(-1, 1, n)]
        jf = j_thomas_factor(*(jnp.asarray(d.astype(dtype)) for d in diags))
    else:
        diags = [rng.uniform(-0.5, 0.5, n) for _ in range(5)]
        diags[2] = diags[2] + 6
        jf = j_penta_factor(*(jnp.asarray(d.astype(dtype)) for d in diags))
    fields = {k: np.asarray(v) for k, v in jf._asdict().items()
              if k != "factor"}
    fields["factor"] = {k: np.asarray(v)
                        for k, v in jf.factor._asdict().items()}
    return jf, from_jax_periodic_factor(fields, device="cpu")


def _jax_unit_carry_sweeps(kind: str, jf, bounds) -> np.ndarray:
    """Each chunk's forward and backward sweep of a unit carry, run by
    ``jax.lax.scan`` on the JAX factor's own fields."""
    f = jf.factor
    n = bounds[-1]
    out = []
    if kind == "tridiag":
        fwd = [(f.a, f.inv_denom, (1.0,))]
        bwd = [(f.c_hat, None, (1.0,))]
    else:
        fwd = [((f.eps, f.beta), f.inv_alpha, carry)
               for carry in ((1.0, 0.0), (0.0, 1.0))]
        bwd = [((f.gamma, f.delta), None, carry)
               for carry in ((1.0, 0.0), (0.0, 1.0))]

    def sweep(coefs, scale, carry, s, e, reverse):
        idx = jnp.arange(s, e)[::-1] if reverse else jnp.arange(s, e)

        def step(state, i):
            if kind == "tridiag":
                v = 0.0 - coefs[i] * state[0]
                new = (v * scale[i] if scale is not None else v,)
            else:
                ca, cb = coefs
                v1, v2 = state
                if scale is not None:   # forward: eps v2, then beta v1
                    v = (0.0 - ca[i] * v2 - cb[i] * v1) * scale[i]
                else:                   # backward: gamma v1, then delta v2
                    v = 0.0 - ca[i] * v1 - cb[i] * v2
                new = (v, v1)
            return new, new[0]

        init = tuple(jnp.asarray(x, jnp.float64) for x in carry)
        _, vals = jax.lax.scan(step, init, idx)
        return np.asarray(vals[::-1] if reverse else vals)

    for reverse, table in ((False, fwd), (True, bwd)):
        for coefs, scale, carry in table:
            row = np.empty(n)
            for s, e in zip(bounds[:-1], bounds[1:]):
                row[s:e] = sweep(coefs, scale, carry, s, e, reverse)
            out.append(row)
    return np.stack(out)


@pytest.mark.parametrize("n", (64, 130, 512))
@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_carry_responses_match_the_jax_factor_swept_from_a_unit_carry(
        kind, n):
    with _jax_x64():
        jf, tf = _factors(kind, n, np.random.default_rng(n))
        chunks = fused_cn.chunk_count(n, torch.float64)
        bounds = fused_cn.chunk_bounds(n, chunks)
        want = _jax_unit_carry_sweeps(kind, jf, bounds)
    lhs = (ops.stack_tridiag_lhs(tf.factor) if kind == "tridiag"
           else ops.stack_penta_lhs(tf.factor))
    got = fused_cn.carry_responses(kind, lhs.contiguous(), chunks)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-300)


# ---------------------------------------------------------------------------
# The split sweep
# ---------------------------------------------------------------------------

def _operands(kind: str, tf, sigma: float, dtype):
    if kind == "tridiag":
        return [ops.stack_tridiag_lhs(tf.factor).contiguous(), tf.z,
                fused_cn.tridiag_params(tf, sigma, dtype)]
    return [ops.stack_penta_lhs(tf.factor).contiguous(), tf.Z, tf.Minv,
            fused_cn.penta_params(tf, sigma, dtype)]


@pytest.mark.parametrize("n", (64, 130, 512, 807))
@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_split_sweep_matches_one_chunk_at_fp64(kind, n):
    """The on-chip route's chunked sweep is the sequential sweep up to
    rounding: 1e-12 of max|x| at fp64, on distinct factor rows."""
    with _jax_x64():
        _, tf = _factors(kind, n, np.random.default_rng(n + 1))
    operands = _operands(kind, tf, 0.3, torch.float64)
    assert operands[0].dtype == torch.float64   # the factor too
    plain = getattr(fused_cn, f"fused_cn_{kind}_plain")
    c = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 9)))
    chunks = fused_cn.sweep_chunks(n, torch.float64)
    assert chunks > 1
    got = plain(*operands, c)
    want = plain(*operands, c, chunks=1)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-12


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_split_step_at_the_main_path_rows_matches_jax(kind):
    """N = 512 fp32, the main path's rows, where the port's step sweeps 8
    chunks: against JAX's fused step (interpret mode) on the same factor,
    within 1e-5 of max|x|."""
    n, m = 512, 8
    sigma = 2e-5 / (2 * (1 / n) ** 2) if kind == "tridiag" else 0.13
    one = np.ones(n, np.float32)
    if kind == "tridiag":
        coef = (-sigma, 1 + 2 * sigma, -sigma)
        jf = j_thomas_factor(*(jnp.asarray(v * one) for v in coef))
        jstep, tstep = jkernels.fused_cn_step, fused_cn.fused_cn_step
    else:
        coef = (sigma, -4 * sigma, 1 + 6 * sigma, -4 * sigma, sigma)
        jf = j_penta_factor(*(jnp.asarray(v * one) for v in coef))
        jstep, tstep = jkernels.fused_cn_penta_step, \
            fused_cn.fused_cn_penta_step
    fields = {k: np.asarray(v) for k, v in jf._asdict().items()
              if k != "factor"}
    fields["factor"] = {k: np.asarray(v)
                        for k, v in jf.factor._asdict().items()}
    tf = from_jax_periodic_factor(fields, device="cpu")
    x = np.arange(n) / n
    c = (np.sin(2 * np.pi * x)[:, None] + 0.3 * np.random.default_rng(
        3).normal(size=(n, m))).astype(np.float32)
    assert fused_cn.sweep_chunks(n, torch.float32) == 8
    want = np.asarray(jstep(jf, sigma, jnp.asarray(c), interpret=True))
    got = tstep(tf, sigma, torch.from_numpy(c)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The partitioned route
# ---------------------------------------------------------------------------

def _random_operands(kind: str, n: int, dtype, seed: int) -> list:
    """Factor rows, z / Z, Minv and parameters drawn uniformly in [-1, 1]
    (as ``chip_smoke.py`` draws them): distinct in every row."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape)).to(dtype)
    zeros = torch.zeros(5, dtype=dtype)
    if kind == "tridiag":
        return [u(3, n), u(n), torch.cat([u(5), zeros[:3]])]
    return [u(5, n), u(n, 4), u(4, 4), torch.cat([u(11), zeros])]


# (N, blocks, chunks): halos that wrap across blocks of a few rows, ragged
# blocks (41 = 14 + 13 + 14), and the route's own split past N_max at fp64
# (1700 = 7 blocks of 242–243 rows, 7 chunks each)
_PARTITIONS = ((40, 4, 2), (41, 3, 3), (1700, None, None))


@pytest.mark.parametrize("n,blocks,chunks", _PARTITIONS)
@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_partitioned_step_matches_the_sequential_sweep_at_fp64(kind, n,
                                                                blocks,
                                                                chunks):
    """The partitioned route's order (K0 weights and coefficients, K1
    summaries of the stencil RHS, K2 chain and correction inputs, K3 block
    sweeps) is the one-block, one-chunk sweep up to rounding: 1e-12 of
    max|x| at fp64."""
    operands = _random_operands(kind, n, torch.float64, n)
    plain = getattr(fused_cn, f"fused_cn_{kind}_plain")
    c = torch.from_numpy(np.random.default_rng(n + 1).normal(size=(n, 7)))
    if blocks is None:
        assert fused_cn.route(n, torch.float64)[0] == "partition"
        assert fused_cn.row_blocks(n, torch.float64) == 7
    got = plain(*operands, c, blocks=blocks, chunks=chunks)
    want = plain(*operands, c, blocks=1, chunks=1)
    assert got.dtype == torch.float64 and got.shape == (n, 7)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-12


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_partitioned_step_matches_jax(kind):
    """N = 96 forced into 4 row blocks of 2 chunks, fp32: against JAX's
    fused step (interpret mode) on the same factor, within 1e-5 of
    max|x|."""
    n, m, blocks, chunks = 96, 8, 4, 2
    sigma = 2e-5 / (2 * (1 / 64) ** 2) if kind == "tridiag" else 0.13
    one = np.ones(n, np.float32)
    if kind == "tridiag":
        coef = (-sigma, 1 + 2 * sigma, -sigma)
        jf = j_thomas_factor(*(jnp.asarray(v * one) for v in coef))
        jstep = jkernels.fused_cn_step
    else:
        coef = (sigma, -4 * sigma, 1 + 6 * sigma, -4 * sigma, sigma)
        jf = j_penta_factor(*(jnp.asarray(v * one) for v in coef))
        jstep = jkernels.fused_cn_penta_step
    fields = {k: np.asarray(v) for k, v in jf._asdict().items()
              if k != "factor"}
    fields["factor"] = {k: np.asarray(v)
                        for k, v in jf.factor._asdict().items()}
    tf = from_jax_periodic_factor(fields, device="cpu")
    x = np.arange(n) / n
    c = (np.sin(2 * np.pi * x)[:, None] + 0.3 * np.random.default_rng(
        4).normal(size=(n, m))).astype(np.float32)
    want = np.asarray(jstep(jf, sigma, jnp.asarray(c), interpret=True))
    operands = _operands(kind, tf, sigma, torch.float32)
    plain = getattr(fused_cn, f"fused_cn_{kind}_plain")
    got = plain(*operands, torch.from_numpy(c), blocks=blocks,
                chunks=chunks).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n,blocks", ((40, 4), (41, 3), (1700, 7)))
@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_chain_yields_the_correction_inputs(kind, n, blocks):
    """K2's ends, y_0 and y_{N−1} (and y_1, y_{N−2} for penta), are the
    end rows of the sequential backward sweep of the stencil RHS, within
    1e-12 of max|y| at fp64."""
    operands = _random_operands(kind, n, torch.float64, n + 2)
    lhs, params = operands[0], operands[-1]
    c = torch.from_numpy(np.random.default_rng(n + 3).normal(size=(n, 5)))
    rhs = fused_cn.stencil_rhs(params[:3] if kind == "tridiag"
                               else params[:5], c)
    spec = engine.find_spec(3 if kind == "tridiag" else 5, "constant")
    y = ops.shared_sweep_plain(spec, lhs, rhs, blocks=1, chunks=1)
    _, _, ends = fused_cn.partition_chain(kind, lhs, rhs, blocks)
    rows = (0, n - 1) if kind == "tridiag" else (0, 1, n - 2, n - 1)
    assert sorted(ends) == sorted(rows)
    scale = y.abs().max()
    for row in rows:
        assert ((ends[row] - y[row]).abs().max() / scale).item() <= 1e-12


def test_stencil_rhs_sums_the_terms_from_offset_minus_r_up():
    c = torch.from_numpy(np.random.default_rng(7).normal(size=(6, 3)))
    w = torch.tensor([0.5, -2.0, 3.0, 0.25, -1.0], dtype=torch.float64)
    want = torch.empty_like(c)
    for i in range(6):
        r = w[0] * c[(i - 2) % 6]
        for t in range(1, 5):
            r = r + w[t] * c[(i + t - 2) % 6]
        want[i] = r
    assert torch.equal(fused_cn.stencil_rhs(w, c), want)


def test_plain_refuses_a_split_without_the_rows_its_carries_need():
    operands = _random_operands("penta", 12, torch.float64, 0)
    c = torch.zeros(12, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="do not split"):
        fused_cn.fused_cn_penta_plain(*operands, c, blocks=4, chunks=2)


def test_library_name_changes_with_an_included_header(tmp_path,
                                                      monkeypatch):
    """A source's library name hashes the headers it includes, so an
    edited header never loads a stale kernel."""
    from repro_torch.kernels import build
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = tmp_path / "partition.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    for name in build.SOURCES:
        text = (tmp_path / f"{name}.cu").read_text()
        includes = '#include "partition.cuh"' in text
        assert (before[name] != after[name]) == includes, name
    assert sum(before[name] != after[name] for name in build.SOURCES) == 2
