"""The fused CN steps' two kernel routes and the split sweep, on the CPU.

``repro_torch.kernels.fused_cn.route`` picks, from (N, dtype), the on-chip
route (a tile of 32 columns over all N rows, with 4 rows of carry
responses, in one block's shared memory) or the global route (each column
walked through device memory).  The on-chip kernel sweeps each column in
``chunk_count`` row chunks from zero carries and adds each chunk's
response to a unit carry (``carry_responses``) times the carry chained
over the chunk ends; the plain versions repeat that order.  Here:

  * the route and chunk rules: N = 512 fp32 goes on chip, N = 12,000 (which
    the JAX step takes) and N_max + 1 go to the global route, N_max at
    fp64 is half that at fp32 within one row, and a tile at N_max fits the
    232,448 bytes of shared memory a block may opt in to;
  * the carry responses against the JAX factor's fields swept from a unit
    carry by ``jax.lax.scan``, at fp64 (1e-12);
  * the split plain sweep against the one-chunk sweep at fp64 (1e-12) and
    against JAX's fused steps (interpret mode) at N = 512, fp32 (1e-5),
    where the on-chip route runs 8 chunks.

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
from repro_torch.kernels import fused_cn, ops

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
def test_route_sends_n_past_shared_memory_to_the_global_route(dtype):
    n_max = fused_cn.onchip_max_rows(dtype)
    assert fused_cn.route(n_max, dtype)[0] == "onchip"
    assert fused_cn.route(n_max + 1, dtype) == ("global", 0)
    assert fused_cn.route(12_000, dtype) == ("global", 0)
    # the global route sweeps whole columns: one chunk
    assert fused_cn.sweep_chunks(n_max + 1, dtype) == 1
    assert fused_cn.sweep_chunks(512, dtype, "global") == 1
    assert fused_cn.launch_name("tridiag", "onchip") == "fused_cn_tridiag"
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
