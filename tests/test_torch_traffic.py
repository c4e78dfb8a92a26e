"""The port's route-aware traffic model (``repro_torch.kernels.engine``
``route_words``, ``ops.traffic_table`` / ``recurrence_traffic_table``,
``ops.solver_hbm_traffic_bytes`` / ``recurrence_hbm_traffic_bytes`` /
``sharded_solver_hbm_traffic_bytes``, ``fused_cn.route_words``) against
the JAX package's per-variant HBM model, on the CPU.

Where a port route moves what a JAX variant moves, the key and the bytes
are JAX's, exactly: the on-chip tiles are JAX's resident variants, the
serial shared kernel and the batch stream kernel its streamed pairs, the
recurrence walk its resident recurrence.  The routes with no JAX
counterpart (the partitioned routes, the recurrence tile) are held to the
word counts their CUDA sources give, and to the floor.
"""

from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import engine as jengine
from repro.kernels import fused_cn as jfused
from repro.kernels import fused_cn_penta as jfused_penta
from repro.kernels import ops as jops

from repro_torch.kernels import engine, fused_cn, ops

_DTYPES = {"float32": (torch.float32, jnp.float32, None, None),
           "float64": (torch.float64, jnp.float64, None, None),
           "bf16": (torch.float32, jnp.float32, torch.bfloat16,
                    jnp.bfloat16)}
# JAX's keys no route of the port moves: its fused single-call tilings
_NO_ROUTE = {"constant_streamed_fused", "constant_streamed_fused_t",
             "uniform_streamed_fused", "uniform_streamed_fused_t",
             "batch_streamed_fused"}


def _jax_table(bw: int, n: int, m: int, jdt, jsdt) -> dict:
    """JAX's ``traffic_table``, or with ``jsdt`` each variant's
    ``traffic_bytes`` at that storage dtype (its table has no storage
    argument)."""
    if jsdt is None:
        return jengine.traffic_table(bw, n, m, jdt)
    prefix = "thomas_" if bw == 3 else "penta_"
    return {s.name[len(prefix):]: s.traffic_bytes(n, m, jdt, jsdt)
            for s in jengine.REGISTRY.values()
            if isinstance(s, jengine.SweepSpec) and s.bandwidth == bw}


@pytest.mark.parametrize("storage", sorted(_DTYPES))
@pytest.mark.parametrize("m", (1, 333))
@pytest.mark.parametrize("n", (5, 512, 2000))
@pytest.mark.parametrize("bw", (3, 5))
def test_traffic_table_equals_jax_on_every_shared_key(bw, n, m, storage):
    tdt, jdt, tsdt, jsdt = _DTYPES[storage]
    got = ops.traffic_table(bw, n, m, tdt, tsdt)
    want = _jax_table(bw, n, m, jdt, jsdt)
    shared = set(got) & set(want)
    assert set(want) - shared == {k for k in _NO_ROUTE if k in want}
    assert {k for k in set(got) - shared} == {
        k for k in got if "_partition" in k}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


@pytest.mark.parametrize("dtype", ("float32", "float64", "bfloat16",
                                   "float16"))
@pytest.mark.parametrize("n,m", ((5, 1), (512, 333), (2000, 333)))
def test_recurrence_traffic_table_equals_jax(n, m, dtype):
    got = ops.recurrence_traffic_table(n, m, getattr(torch, dtype))
    want = jengine.recurrence_traffic_table(n, m, getattr(jnp, dtype))
    shared = set(got) & set(want)
    assert shared == {"recur1", "recur1_rev", "recur2", "recur2_rev"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    # the tile moves the walk's words; JAX's streamed variants the same
    for name in shared:
        tile = name.replace("_rev", "") + "_tile" + (
            "_rev" if name.endswith("_rev") else "")
        assert got[tile] == got[name]
        assert want[name.replace("_rev", "") + "_streamed"
                    + ("_rev" if name.endswith("_rev") else "")] == got[name]


@pytest.mark.parametrize("storage", sorted(_DTYPES))
@pytest.mark.parametrize("n", (5, 512, 2000))
@pytest.mark.parametrize("bw,mode", ((3, "constant"), (3, "uniform"),
                                     (5, "constant"), (5, "uniform"),
                                     (3, "batch"), (5, "batch")))
def test_solver_hbm_traffic_bytes_routes_equal_jax_variants(bw, mode, n,
                                                            storage):
    tdt, jdt, tsdt, jsdt = _DTYPES[storage]
    streamed_route = "stream" if mode == "batch" else "serial"
    for transposed in (False, True):
        kw = dict(dtype=tdt, storage_dtype=tsdt, transposed=transposed)
        jkw = dict(dtype=jdt, storage_dtype=jsdt, transposed=transposed)
        assert ops.solver_hbm_traffic_bytes(bw, mode, n, 333, route="onchip",
                                            **kw) == \
            jops.solver_hbm_traffic_bytes(bw, mode, n, 333, **jkw)
        assert ops.solver_hbm_traffic_bytes(bw, mode, n, 333,
                                            route=streamed_route, **kw) == \
            jops.solver_hbm_traffic_bytes(bw, mode, n, 333, streamed=True,
                                          **jkw)


def test_stream_route_moves_what_batch_sweep_cu_counts():
    """9NM words tridiagonal, 13NM pentadiagonal, against the 5 and 7 the
    function needs (``csrc/batch_sweep.cu``); JAX's streamed pair moves
    the same."""
    n, m = 512, 1 << 20
    for bw, words, floor in ((3, 9, 5), (5, 13, 7)):
        assert ops.solver_hbm_traffic_bytes(bw, "batch", n, m,
                                            route="stream") == words * n * m * 4
        assert ops.solver_hbm_traffic_bytes(bw, "batch", n, m) == (
            words if bw == 5 else floor) * n * m * 4
        assert ops.solver_hbm_traffic_bytes(bw, "batch", n, m,
                                            route="onchip") == floor * n * m * 4
        assert jops.solver_hbm_traffic_bytes(bw, "batch", n, m,
                                             streamed=True) == \
            words * n * m * 4


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64,
                                   torch.bfloat16))
@pytest.mark.parametrize("n", (5, 512, 1614, 1615, 16384))
def test_default_route_is_the_dispatchers(n, dtype):
    for bw, mode in ((3, "constant"), (5, "uniform"), (3, "batch"),
                     (5, "batch")):
        picked = (ops.batch_route(n, dtype, bw) if mode == "batch"
                  else ops.shared_route(n, dtype)).name
        assert ops.solver_hbm_traffic_bytes(bw, mode, n, 77, dtype=dtype) \
            == ops.solver_hbm_traffic_bytes(bw, mode, n, 77, dtype=dtype,
                                            route=picked)
    for order in (1, 2):
        m = 4096
        picked = ops.recurrence_route(n, m, dtype, order).name
        assert ops.recurrence_hbm_traffic_bytes(order, n, m, dtype=dtype) \
            == ops.recurrence_hbm_traffic_bytes(order, n, m, dtype=dtype,
                                                route=picked) \
            == jops.recurrence_hbm_traffic_bytes(
                order, n, m, dtype=getattr(jnp, str(dtype)[6:]))


def test_partitioned_route_words_from_the_sources():
    """K0–K3's words (``SweepSpec.route_words``): 2NM + 2kN (+ 2 eps)
    stored, NM + 4oN + 6Bo² + 9BoM at the compute type, B the row blocks
    ``shared_route`` cuts; above the floor, below the serial kernel's at
    every N past one block."""
    n, m = 16384, 65536
    blocks = ops.shared_route(n, torch.float32, "partition").row_blocks
    assert blocks == 32
    for spec in (s for s in engine.REGISTRY.values()
                 if s.layout == "shared"):
        k, o = spec.lhs_rows, spec.order
        eps = 1 if spec.uniform else 0
        assert spec.route_words(n, m, "partition", blocks) == (
            2 * n * m + 2 * k * n + 2 * eps,
            n * m + 4 * o * n + 6 * blocks * o * o + 9 * blocks * o * m)
        got = ops.solver_hbm_traffic_bytes(
            spec.bandwidth, spec.mode, n, m, transposed=spec.transposed)
        assert got == spec.route_traffic_bytes(n, m, "partition",
                                               blocks=blocks)
        assert spec.traffic_bytes(n, m) < got < spec.route_traffic_bytes(
            n, m, "serial")


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_cn_route_bytes(kind):
    """On chip the floor (JAX's ``fused``), global the pipeline's words
    (JAX's ``unfused_pipeline``), the partitioned route between them."""
    jfn = jfused if kind == "tridiag" else jfused_penta
    for n, m, dtype, jdt in ((512, 1 << 20, torch.float32, jnp.float32),
                             (4096, 65536, torch.float64, jnp.float64)):
        got = getattr(fused_cn, f"{kind}_traffic_bytes")(n, m, dtype)
        want = jfn.hbm_traffic_bytes(n, m, jdt)
        assert got["fused"] == want["fused"] == \
            fused_cn.route_traffic_bytes(kind, n, m, "onchip", dtype)
        assert got["unfused_pipeline"] == want["unfused_pipeline"] == \
            fused_cn.route_traffic_bytes(kind, n, m, "global", dtype)
        assert got["fused"] < got["partition"] < got["unfused_pipeline"]
        blocks = fused_cn.row_blocks(n, dtype, "partition")
        o, corr = (1, 1) if kind == "tridiag" else (2, 4)
        # 3NM (K1's read, K3's read and write), 9BoM of summaries and
        # carries, the corrections written by K2 and read by K3
        assert fused_cn.route_words(kind, n, m, "partition", blocks) \
            - 3 * n * m - 9 * blocks * o * m - 2 * corr * m == \
            fused_cn.route_words(kind, n, 0, "partition", blocks)
    with pytest.raises(ValueError, match="route must be"):
        fused_cn.route_words(kind, 8, 8, "stream")


@pytest.mark.parametrize("n_shards", (1, 2, 3))
@pytest.mark.parametrize("m", (333, 1000, 7))
def test_sharded_traffic_equals_jax(m, n_shards):
    for bw, mode in ((3, "constant"), (5, "uniform"), (3, "batch"),
                     (5, "batch")):
        route = "stream" if mode == "batch" else "serial"
        assert ops.sharded_solver_hbm_traffic_bytes(
            bw, mode, 512, m, n_shards, route="onchip") == \
            jops.sharded_solver_hbm_traffic_bytes(bw, mode, 512, m, n_shards)
        assert ops.sharded_solver_hbm_traffic_bytes(
            bw, mode, 512, m, n_shards, route=route) == \
            jops.sharded_solver_hbm_traffic_bytes(bw, mode, 512, m, n_shards,
                                                  streamed=True)
    for name, spec in engine.REGISTRY.items():
        assert spec.sharded_traffic_words(512, m, n_shards) == \
            jengine.REGISTRY[name].sharded_traffic_words(512, m, n_shards)
    assert engine.shard_lanes(m, n_shards) == -(-m // n_shards)


def test_tpu_tilings_and_unknown_routes_raise():
    with pytest.raises(TypeError, match="route="):
        ops.solver_hbm_traffic_bytes(3, "constant", 8, 8, streamed=True)
    with pytest.raises(TypeError, match="route="):
        ops.solver_hbm_traffic_bytes(3, "batch", 8, 8, fused=False)
    with pytest.raises(TypeError, match="route="):
        ops.recurrence_hbm_traffic_bytes(1, 8, 8, streamed=True)
    with pytest.raises(TypeError, match="route="):
        ops.sharded_solver_hbm_traffic_bytes(3, "constant", 8, 8, 2,
                                             streamed=True)
    with pytest.raises(ValueError, match="no 'stream' route"):
        ops.solver_hbm_traffic_bytes(3, "constant", 8, 8, route="stream")
    with pytest.raises(ValueError, match="no 'partition' route"):
        ops.solver_hbm_traffic_bytes(5, "batch", 8, 8, route="partition")
    with pytest.raises(ValueError, match="no 'onchip' route"):
        ops.recurrence_hbm_traffic_bytes(2, 8, 8, route="onchip")
    with pytest.raises(ValueError, match="bandwidth"):
        ops.solver_hbm_traffic_bytes(7, "constant", 8, 8)


def test_floor_and_launch_bytes_unchanged():
    """The floor stays what ``LAUNCH_BYTES`` books and the bound reads: the
    on-chip routes' words, each input read once and x written once."""
    for spec in engine.REGISTRY.values():
        first = engine.ROUTES[spec.layout][0]     # onchip, or the walk
        for n, m in ((5, 1), (512, 333)):
            assert spec.route_traffic_bytes(n, m, first) == \
                spec.traffic_bytes(n, m)
            for route in engine.ROUTES[spec.layout]:
                assert spec.route_traffic_bytes(n, m, route) >= \
                    spec.traffic_bytes(n, m)
