"""The recurrence kernel's routes: the tile route's order against JAX.

``ops.recurrence_route`` picks the recurrence kernel's route from
(N, M, dtype, order): the walk (one thread a column) or the tile (32
columns a block, N in windows of ``chunks`` row chunks of ``rows`` rows,
each chunk walked from a zero carry with its unit-carry responses, a linear
fold of the chunk summaries, and a walk from the true carry).  The plain
version repeats either order (``ops.recurrence_plain(..., chunks=,
rows=)``); on CPU tensors the wrapper runs the sequential walk, and these
tests put the tile's order in its place.  Here, on the same numpy inputs made from a seed, at
a ragged M = 19:

  * the tile route's order, forced at the largest tile (16 chunks of 8
    rows), through ``ops.recurrence`` (h0 folded on the host) against
    JAX's ``linear_recurrence`` / ``linear_recurrence2`` with
    ``method="pallas", interpret=True`` and against the sequential plain
    walk, over order × direction × h0 × N ∈ {1, 2, R − 1, R, R + 1,
    P·R − 1, P·R + 1, 2·P·R + 3} × dtype.  Tolerances, max|Δ| /
    max|h|: fp32 1e-5, fp64 1e-12, bf16 2e-2 and fp16 2e-3 (the bars of
    ``tests/test_torch_recurrence.py``);
  * order-2 gates of a penta back-substitution (x_i = g_i − γ_i x_{i+1}
    − δ_i x_{i+2} of the hyperdiffusion CN factor at σ up to 400), whose
    chunk responses grow past twice a unit carry, in both directions;
  * the route rule's choices at the main-path rows (f)–(o), its purity,
    and that every forced geometry the kernel cannot run raises;
  * ``loss.backward()`` through ``linear_recurrence(..., method="cuda")``
    with the tile route's order forced (a window of 3 chunks of 4 rows, so
    N = 37 spans four windows) against ``jax.grad``.

The kernel itself is held against the plain version in each route's order
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import recurrence as jrec
from repro_torch.core import recurrence as trec
from repro_torch.kernels import engine as tengine
from repro_torch.kernels import ops as tops

M = 19
P, R = tops.RECURRENCE_MAX_CHUNKS, tops.RECURRENCE_ROWS
EDGE_N = (1, 2, R - 1, R, R + 1, P * R - 1, P * R + 1, 2 * P * R + 3)
TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 2e-2, "float16": 2e-3}
_JNP = {"float32": jnp.float32, "float64": jnp.float64,
        "bfloat16": jnp.bfloat16, "float16": jnp.float16}
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "float16": torch.float16}


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


@contextlib.contextmanager
def _tile_order(chunks: int, rows: int, calls: list | None = None):
    """Every recurrence on CPU tensors runs the plain version in the tile
    route's order, ``chunks`` chunks of ``rows`` rows, instead of the
    sequential walk; each such run appends ``(chunks, rows)`` to
    ``calls``."""
    real = tops.recurrence_plain

    def tiled(spec, gates, q, chunks_=None, rows_=None):
        if calls is not None:
            calls.append((chunks, rows))
        return real(spec, gates, q, chunks, rows)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops, "recurrence_plain", tiled)
        yield


def _operands(order: int, n: int, seed: int) -> tuple:
    """(gates, q, h0), numpy float64: |p| < 0.9; |s| < 0.6, |t| < 0.3."""
    rng = np.random.default_rng(seed)
    scales = (0.9,) if order == 1 else (0.6, 0.3)
    gates = [rng.uniform(-sc, sc, (n, M)) for sc in scales]
    q = rng.normal(size=(n, M))
    h0 = [rng.normal(size=M) * 0.5 for _ in range(order)]
    return gates, q, h0


def _penta_gates(n: int, seed: int) -> tuple:
    """(s, t, u, h0) of a penta back-substitution: s = −γ, t = −δ of the
    factor of the hyperdiffusion CN operator (σ, −4σ, 1 + 6σ, −4σ, σ),
    with σ from 1 to 400 across the columns (γ ≈ −1.7, δ ≈ 0.73 at σ 400:
    the order-2 responses grow over a chunk's rows), u random."""
    rng = np.random.default_rng(seed)
    sig = np.geomspace(1.0, 400.0, M)
    a, b, c, d, e = sig, -4 * sig, 1 + 6 * sig, -4 * sig, sig
    gamma, delta = np.zeros((n, M)), np.zeros((n, M))
    g1 = g2 = d1 = d2 = np.zeros(M)
    for i in range(n):
        ai = a if i >= 2 else 0 * a
        bi = b if i >= 1 else 0 * b
        beta = bi - ai * g2
        alpha = c - ai * d2 - beta * g1
        gamma[i] = (d - beta * d1) / alpha if i < n - 1 else 0
        delta[i] = e / alpha if i < n - 2 else 0
        g1, g2, d1, d2 = gamma[i], g1, delta[i], d1
    u = rng.normal(size=(n, M))
    return [-gamma, -delta], u, [rng.normal(size=M) for _ in range(2)]


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _round(a, dtype: str) -> np.ndarray:
    """``a`` rounded to ``dtype``'s values, as float64."""
    return torch.from_numpy(np.asarray(a)).to(_TORCH[dtype]).double().numpy()


def _jax(gates, q, h0, reverse: bool, dtype: str) -> np.ndarray:
    fn = jrec.linear_recurrence if len(gates) == 1 else jrec.linear_recurrence2
    with _jax_x64(dtype == "float64"):
        j = lambda a: jnp.asarray(a).astype(_JNP[dtype])
        seeds = None
        if h0 is not None:
            seeds = j(h0[0]) if len(gates) == 1 else tuple(map(j, h0))
        out = fn(*map(j, gates), j(q), seeds, reverse=reverse,
                 method="pallas", interpret=True)
        assert out.dtype == _JNP[dtype]
        return np.asarray(out.astype(jnp.float64 if dtype == "float64"
                                     else jnp.float32), np.float64)


def _port(gates, q, h0, reverse: bool, dtype: str) -> torch.Tensor:
    t = lambda a: torch.from_numpy(np.asarray(a)).to(_TORCH[dtype])
    tops.reset_launches()
    out = tops.recurrence(*map(t, gates), t(q),
                          h0=None if h0 is None else tuple(map(t, h0)),
                          reverse=reverse)
    assert tops.LAUNCHES == {}, "a CPU run counted a kernel launch"
    assert out.dtype == _TORCH[dtype] and out.shape == np.shape(q)
    return out


@functools.lru_cache(maxsize=None)
def _case(order: int, reverse: bool, with_h0: bool, n: int, dtype: str):
    gates, q, h0 = _operands(order, n, seed=7 * n + order)
    gates, q = [_round(g, dtype) for g in gates], _round(q, dtype)
    h0 = [_round(h, dtype) for h in h0] if with_h0 else None
    with _tile_order(P, R):
        tile = _port(gates, q, h0, reverse, dtype)
    walk = _port(gates, q, h0, reverse, dtype)
    return tile, walk, _jax(gates, q, h0, reverse, dtype)


# ---------------------------------------------------------------------------
# The tile route's order against JAX and against the sequential walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("order", (1, 2))
def test_tile_order_matches_jax_and_the_walk(order, reverse, with_h0, n,
                                             dtype):
    tile, walk, want = _case(order, reverse, with_h0, n, dtype)
    assert _rel(tile, want) <= TOL[dtype]
    assert _rel(tile, walk.double().numpy()) <= TOL[dtype]
    assert _rel(walk, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("reverse", (True, False))
def test_tile_order_on_penta_back_substitution_gates(reverse, dtype):
    n = 2 * P * R + 3
    gates, u, h0 = _penta_gates(n, seed=11)
    gates, u = [_round(g, dtype) for g in gates], _round(u, dtype)
    h0 = [_round(h, dtype) for h in h0]
    # the order-2 responses of a chunk grow past twice a unit carry
    spec = tengine.find_recurrence_spec(2, reverse=reverse)
    z = torch.zeros(R, M, dtype=torch.float64)
    unit = z.clone()
    unit[0 if not reverse else -1] = 1.0
    gate_rows = [torch.from_numpy(g[n // 2:n // 2 + R]) for g in gates]
    resp = tops.recurrence_plain(spec, gate_rows, unit)
    assert resp.abs().max().item() > 2.0
    with _tile_order(P, R):
        tile = _port(gates, u, h0, reverse, dtype)
    walk = _port(gates, u, h0, reverse, dtype)
    want = _jax(gates, u, h0, reverse, dtype)
    assert _rel(tile, want) <= TOL[dtype]
    assert _rel(tile, walk.numpy()) <= TOL[dtype]


@pytest.mark.parametrize("chunks,rows", ((1, 4), (3, 4), (2, 16), (16, 8)))
@pytest.mark.parametrize("order", (1, 2))
def test_any_tile_geometry_matches_the_walk(order, chunks, rows):
    """The chunked plain version in any chunks and rows (every row
    instantiation of the kernel) against the sequential walk, fp64."""
    spec = tengine.find_recurrence_spec(order, reverse=order == 2)
    gates, q, _ = _operands(order, 2 * chunks * rows + 5, seed=31)
    gates = [torch.from_numpy(g) for g in gates]
    q = torch.from_numpy(q)
    got = tops.recurrence_plain(spec, gates, q, chunks=chunks, rows=rows)
    want = tops.recurrence_plain(spec, gates, q)
    assert _rel(got, want.numpy()) <= TOL["float64"]


def test_plain_takes_both_chunks_and_rows_or_neither():
    spec = tengine.find_recurrence_spec(1)
    gates, q = [torch.zeros(4, 3)], torch.zeros(4, 3)
    with pytest.raises(ValueError, match="both"):
        tops.recurrence_plain(spec, gates, q, chunks=2)
    with pytest.raises(ValueError, match="chunks"):
        tops.recurrence_plain(spec, gates, q, chunks=0, rows=4)


def test_cpu_dispatch_runs_the_sequential_walk():
    """On CPU tensors ``recurrence_sweep`` runs the sequential plain walk,
    bitwise, whatever route the kernel would take on the card."""
    spec = tengine.find_recurrence_spec(1)
    n, m = 300, 64
    gen = torch.Generator().manual_seed(5)
    gates = [torch.rand(n, m, generator=gen) * 1.8 - 0.9]
    q = torch.randn(n, m, generator=gen)
    assert tops.recurrence_route(n, m, torch.float32, 1).name == "tile"
    assert torch.equal(tops.recurrence_sweep(spec, gates, q),
                       tops.recurrence_plain(spec, gates, q))


# ---------------------------------------------------------------------------
# The route rule
# ---------------------------------------------------------------------------

# (order, N, M) of the main-path rows and the route each takes
ROUTE_ROWS = {
    "f": ((1, 4096, 65536), ("tile", 16, 8, 512)),
    "g": ((1, 64, 1572864), ("walk", 1, 64, 256)),
    "h": ((2, 4096, 65536), ("walk", 1, 4096, 256)),
    "m": ((1, 16, 1572864), ("walk", 1, 16, 256)),
    "n": ((1, 1984, 32768), ("tile", 16, 8, 512)),
    "o": ((1, 1984, 4096), ("tile", 16, 8, 512)),
}


@pytest.mark.parametrize("row", sorted(ROUTE_ROWS))
def test_route_rule_at_the_main_path_rows(row):
    (order, n, m), want = ROUTE_ROWS[row]
    picked = tops.recurrence_route(n, m, torch.float32, order)
    assert (picked.name, picked.chunks, picked.rows, picked.threads) == want
    # a pure function of its arguments
    assert tops.recurrence_route(n, m, torch.float32, order) == picked
    for which in tops.RECURRENCE_ROUTES:
        forced = tops.recurrence_route(n, m, torch.float32, order, which)
        assert forced.name == which


def test_short_or_wide_operands_take_the_walk():
    short = tops.RECURRENCE_TILE_MIN_ROWS
    assert short == P * R
    for order in (1, 2):
        for n in (1, 2, R, 2 * R, short - 1):
            assert tops.recurrence_route(n, 19, torch.float32,
                                         order).name == "walk"
        assert tops.recurrence_route(short, 19, torch.float32,
                                     order).name == "tile"
        wide = tops.RECURRENCE_TILE_MAX_COLUMNS[order]
        assert tops.recurrence_route(4096, wide, torch.float32,
                                     order).name == "tile"
        assert tops.recurrence_route(4096, wide + 1, torch.float32,
                                     order).name == "walk"
    assert tops.RECURRENCE_TILE_MAX_COLUMNS == {1: 98304, 2: 49152}
    for order in (1, 2):
        for n in (1, 7, 8, 9, 40, 10_000):
            picked = tops.recurrence_route(n, 19, torch.float32, order,
                                           "tile")
            assert picked.chunks == min(tops.RECURRENCE_TILE_CHUNKS[order],
                                        max(1, -(-n // R)))


@pytest.mark.parametrize("kw,match", [
    ({"route": "serial"}, "route must be one of"),
    ({"route": "walk", "chunks": 4}, "tile route"),
    ({"route": "tile", "chunks": 0}, "chunks"),
    ({"route": "tile", "chunks": tops.RECURRENCE_MAX_CHUNKS + 1}, "chunks"),
])
def test_forced_geometry_the_kernel_cannot_run_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        tops.recurrence_tuned(1984, 4096, torch.float32, 1, **kw)


def test_route_refuses_dtype_and_order():
    with pytest.raises(TypeError, match="dtype"):
        tops.recurrence_route(8, 8, torch.int32, 1)
    with pytest.raises(ValueError, match="order"):
        tops.recurrence_route(8, 8, torch.float32, 3)


# ---------------------------------------------------------------------------
# Gradients through the tile route's order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("order", (1, 2))
def test_grads_in_the_tile_order_match_jax_grad(order, reverse):
    n = 37
    gates, q, h0 = (a.astype(np.float32) if isinstance(a, np.ndarray)
                    else [x.astype(np.float32) for x in a]
                    for a in _operands(order, n, seed=17 + order))
    jfn = jrec.linear_recurrence if order == 1 else jrec.linear_recurrence2

    def jloss(*args):
        *gq, s0, s1 = args if order == 2 else (*args, None)
        seeds = s0 if order == 1 else (s0, s1)
        h = jfn(*gq, seeds, reverse=reverse, method="pallas", interpret=True)
        return jnp.sum(jnp.cos(h))

    jargs = [jnp.asarray(a) for a in (*gates, q, *h0)]
    want = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (*gates, q, *h0)]
    seeds = leaves[-1] if order == 1 else tuple(leaves[-2:])
    fn = trec.linear_recurrence if order == 1 else trec.linear_recurrence2
    calls = []
    with _tile_order(3, 4, calls):
        h = fn(*leaves[:order + 1], seeds, reverse=reverse, method="cuda")
        h.cos().sum().backward()
    # the forward and the backward recurrence both ran the tile's order
    assert calls == [(3, 4), (3, 4)]
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= 1e-5
