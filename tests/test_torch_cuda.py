"""The hand-written CUDA kernels on the card, against their plain versions.

``shared_sweep.cu`` (one shared factor, on each of its routes: on chip,
partitioned past ``ops.onchip_max_rows``, and the serial kernel forced),
``batch_sweep.cu`` (per-system
diagonals, factorisation fused into the solve; tested with distinct
diagonals in every system, on its on-chip route up to
``ops.batch_onchip_max_rows`` and its stream route forced, each against
the plain version in the route's own chunks), ``recurrence_sweep.cu`` (the gated
recurrences, distinct gates in every column, on the route
``ops.recurrence_route`` picks and on the walk and the tile forced, each
against the plain version in that route's order, and their autograd),
``fused_cn.cu`` (the two fused CN steps), and the serving paths of
mamba2-130m and recurrentgemma-9b at their smoke configs (the SSD layer on
the card against its CPU run, one ``recur1`` launch an SSD or RG-LRU layer
in a prefill, the hybrid model's log-probs against the CPU's across a
wrapped ring), and one fp32 train step of mamba2-130m at its smoke config
(the loss within 1e-4 relative of the CPU's, every gradient leaf within
1e-3 of its largest entry, and two ``recur1`` launches and one
``recur1_rev`` a layer under remat), and the ``sharded`` backend with two
gloo ranks sharing the card (each rank's columns bit for bit the
single-process backend's, one launch a solve).

Every test here is marked ``cuda`` and needs a CUDA device; without one
they skip.  The file imports torch, numpy and ``repro_torch`` only, so it
runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances (kernel vs plain version, max|Δ| / max|plain|): fp32 1e-5,
fp64 1e-12.  With bf16 storage both read the same bf16 operands and compute
in fp32, so they are held to the fp32 bar, 1e-5; the recurrence also
stores h at bf16 (or fp16), so there the bar is 2e-2
(``tests/test_recurrence.py``'s; 2e-3 at fp16).  The fused CN steps are
held on operands drawn at random, against the largest term the step
forms rather than max|plain|, on each of their three routes (on chip up to
``fused_cn.onchip_max_rows``, partitioned past it, and the global kernel
forced).  ``nvcc`` contracts
``a - b*c`` into an FMA, so the two agree to a few ulps, not bitwise.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import penta, tridiag
from repro_torch.kernels import engine, ops
from repro_torch.solver import BandedSystem, factorize, solve

pytestmark = pytest.mark.cuda

N, M = 37, 1000
SPECS = sorted(n for n, s in engine.REGISTRY.items() if s.layout == "shared")
BATCH_SPECS = sorted(n for n, s in engine.REGISTRY.items()
                     if s.layout == "batch")
STORAGES = {"float32": 1e-5, "float64": 1e-12, "bf16": 1e-5}
CONFIGS = [(bw, mode, periodic) for bw in (3, 5)
           for mode in ("constant", "uniform") for periodic in (False, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    return torch.device("cuda")


def _diags(bw: int, uniform: bool, n: int = N, dtype=np.float64):
    if uniform:
        vals = (-0.4, 1.8, -0.4) if bw == 3 else (0.4, -1.6, 3.4, -1.6, 0.4)
        return [np.full(n, v, dtype) for v in vals]
    rng = np.random.default_rng(bw)
    if bw == 3:
        diags = [rng.uniform(-1, 1, n), 4 + rng.uniform(0, 1, n),
                 rng.uniform(-1, 1, n)]
    else:
        diags = [rng.uniform(-0.5, 0.5, n) for _ in range(5)]
        diags[2] = diags[2] + 6
    return [d.astype(dtype) for d in diags]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    assert got.shape == want.shape
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _to(factor, device):
    return dataclasses.replace(factor, **{
        f.name: getattr(factor, f.name).to(device)
        for f in dataclasses.fields(factor)})


@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("name", SPECS)
def test_kernel_matches_plain(name, storage, cuda_device):
    spec = engine.REGISTRY[name]
    dtype = np.float64 if storage == "float64" else np.float32
    sdt = "bf16" if storage == "bf16" else None
    diags = [torch.from_numpy(d) for d in _diags(spec.bandwidth, spec.uniform,
                                                 dtype=dtype)]
    f = (tridiag.thomas_factor(*diags) if spec.bandwidth == 3
         else penta.penta_factor(*diags))
    rhs = torch.from_numpy(
        np.random.default_rng(4).normal(size=(N, M)).astype(dtype))
    fn = ops.thomas_constant if spec.bandwidth == 3 else ops.penta_constant
    kw = {} if spec.bandwidth == 3 else {"uniform": spec.uniform}
    want = fn(f, rhs, transposed=spec.transposed, storage_dtype=sdt, **kw)
    before = ops.LAUNCHES.get(name, 0)
    got = fn(_to(f, cuda_device), rhs.to(cuda_device),
             transposed=spec.transposed, storage_dtype=sdt, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    assert got.is_cuda and got.dtype == want.dtype
    assert _rel(got, want) <= STORAGES[storage]


def _shared_operands(name: str, n: int, m: int, storage: str, seed: int):
    """(spec, lhs, rhs, eps) of shared spec ``name`` at (n, m), stacked and
    stored as ``ops.thomas_constant`` / ``penta_constant`` hand them to the
    sweep, on the card."""
    spec = engine.REGISTRY[name]
    dtype = np.float64 if storage == "float64" else np.float32
    diags = [torch.from_numpy(d) for d in _diags(spec.bandwidth, spec.uniform,
                                                 n=n, dtype=dtype)]
    if spec.bandwidth == 3:
        f = tridiag.thomas_factor(*diags)
        lhs = ops.stack_tridiag_lhs(f, transposed=spec.transposed)
    else:
        f = penta.penta_factor(*diags)
        lhs = ops.stack_penta_lhs(f, uniform=spec.uniform,
                                  transposed=spec.transposed)
    sdt = _TORCH_STORAGE[storage]
    rhs = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(n, m)).astype(dtype))
    eps = ops._uniform_eps_param(f, sdt) if spec.uniform else None
    return (spec, lhs.to("cuda", sdt).contiguous(), rhs.to("cuda", sdt),
            None if eps is None else eps.to("cuda"))


def _edge_n(n, dtype) -> int:
    """``n``, or the on-chip tile's last N at ``dtype`` ("n_max") and the
    first past it ("n_max+1"); the shared sweep and the fused steps share
    the tile's rows."""
    if isinstance(n, int):
        return n
    return ops.onchip_max_rows(dtype) + (n == "n_max+1")


# (route, chunks, tile_m): every chunk count a block takes, both tile
# widths on chip, and the serial kernel (whole columns)
KNOBS = [("onchip", c, t) for c in (1, 2, 5, 16) for t in (16, 32)] + [
    ("partition", c, t) for c, t in ((1, 32), (5, 32), (16, 16))] + [
    ("serial", None, None)]


@pytest.mark.parametrize("route,chunks,tile_m", KNOBS)
def test_kernel_tiling_knobs_do_not_change_the_answer(route, chunks, tile_m,
                                                      cuda_device):
    """A forced route, chunk count and tile width against the plain version
    in the same row blocks and chunks, at N = 600 (uneven chunks; two row
    blocks on the partitioned route) and a ragged M."""
    spec, lhs, rhs, _ = _shared_operands("penta_constant_t", 600, 77,
                                         "float32", seed=3)
    picked = ops.shared_route(600, torch.float32, route)
    want = ops.shared_sweep_plain(spec, lhs, rhs, blocks=picked.row_blocks,
                                  chunks=chunks or 1)
    got = ops.shared_sweep_cuda(spec, lhs, rhs, route=route, chunks=chunks,
                                tile_m=tile_m)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("m", (333, 1000))
@pytest.mark.parametrize("n", (1, 2, 3, 600, "n_max", "n_max+1", 4096))
@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("name", SPECS)
def test_shared_routes_match_plain(name, storage, n, m, cuda_device):
    """The route the sweep picks, the partitioned route forced and the
    serial kernel forced, each against the plain version in the same row
    blocks and chunks; each solve counted once under the spec's name."""
    spec = engine.REGISTRY[name]
    dtype = torch.float64 if storage == "float64" else torch.float32
    n = _edge_n(n, dtype)
    if spec.bandwidth == 5 and n < 2:
        pytest.skip("the penta factor needs N >= 2")
    spec, lhs, rhs, eps = _shared_operands(name, n, m, storage, seed=n)
    picked = ops.shared_route(n, rhs.dtype)
    assert picked.name == ("onchip" if n <= ops.onchip_max_rows(dtype)
                           else "partition")
    for route in (None, "partition", "serial"):
        r = picked if route is None else ops.shared_route(n, rhs.dtype, route)
        want = ops.shared_sweep_plain(spec, lhs, rhs, eps,
                                      blocks=r.row_blocks, chunks=r.chunks)
        before = ops.LAUNCHES.get(name, 0)
        got = (ops.shared_sweep(spec, lhs, rhs, eps) if route is None
               else ops.shared_sweep_cuda(spec, lhs, rhs, eps, route=route))
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before + 1
        assert got.is_cuda and got.dtype == want.dtype
        assert _rel(got, want) <= STORAGES[storage], r


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64,
                                   torch.bfloat16))
def test_forced_onchip_route_past_n_max_raises(dtype, cuda_device):
    n = ops.onchip_max_rows(dtype) + 1
    spec, lhs, rhs, _ = _shared_operands(
        "thomas_constant", n, 64,
        {torch.float32: "float32", torch.float64: "float64",
         torch.bfloat16: "bf16"}[dtype], seed=1)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="on-chip"):
        ops.shared_sweep_cuda(spec, lhs, rhs, route="onchip")
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("cfg", CONFIGS)
def test_solver_on_card_matches_cpu(cfg, cuda_device):
    bw, mode, periodic = cfg
    ctor = BandedSystem.tridiag if bw == 3 else BandedSystem.penta
    diags = _diags(bw, mode == "uniform", dtype=np.float32)
    card = ctor(*diags, n=N, periodic=periodic, mode=mode)
    host = ctor(*diags, n=N, periodic=periodic, mode=mode, device="cpu")
    assert card.device.type == "cuda"
    rhs = torch.from_numpy(
        np.random.default_rng(5).normal(size=(N, 9)).astype(np.float32))
    fact = factorize(card, backend="auto")
    assert fact.backend == "cuda"
    before = sum(ops.LAUNCHES.values())
    r_card = rhs.to(cuda_device).requires_grad_()
    x = solve(fact, r_card)
    x.pow(2).sum().backward()
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) == before + 2   # forward + transposed
    r_host = rhs.clone().requires_grad_()
    want = solve(factorize(host, backend="cuda"), r_host)
    want.pow(2).sum().backward()
    assert _rel(x, want) <= 1e-5
    assert _rel(r_card.grad, r_host.grad) <= 1e-5


def _batch_operands(bw: int, n: int, m: int, dtype, seed: int = 0) -> list:
    """Distinct, diagonally dominant per-system diagonals and an RHS, all
    (n, m), on the card."""
    rng = np.random.default_rng(seed + bw)
    if bw == 3:
        arrays = [rng.uniform(-1, 1, (n, m)), 4 + rng.uniform(0, 1, (n, m)),
                  rng.uniform(-1, 1, (n, m))]
    else:
        arrays = [rng.uniform(-0.5, 0.5, (n, m)) for _ in range(5)]
        arrays[2] = arrays[2] + 6
    arrays.append(rng.normal(size=(n, m)))
    return [torch.from_numpy(x).to("cuda", dtype) for x in arrays]


_TORCH_STORAGE = {"float32": torch.float32, "float64": torch.float64,
                  "bf16": torch.bfloat16, "float16": torch.float16}


@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("name", BATCH_SPECS)
def test_batch_kernel_matches_plain(name, storage, cuda_device):
    spec = engine.REGISTRY[name]
    *diags, rhs = _batch_operands(spec.bandwidth, N, M,
                                  _TORCH_STORAGE[storage])
    want = ops.batch_sweep_plain(spec, diags, rhs)
    before = ops.LAUNCHES.get(name, 0)
    got = ops.batch_sweep(spec, diags, rhs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    assert got.is_cuda and got.dtype == want.dtype
    assert _rel(got, want) <= STORAGES[storage]


@pytest.mark.parametrize("n", (1, 2, 37, 600))
@pytest.mark.parametrize("name", BATCH_SPECS)
def test_batch_kernel_ragged_m_and_edge_n(name, n, cuda_device):
    spec = engine.REGISTRY[name]
    *diags, rhs = _batch_operands(spec.bandwidth, n, 333, torch.float32,
                                  seed=n)
    want = ops.batch_sweep_plain(spec, diags, rhs)
    got = ops.batch_sweep_cuda(spec, diags, rhs)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("bw", (3, 5))
def test_batch_solver_rolled_adjoint_on_card_matches_cpu(bw, cuda_device):
    ctor = BandedSystem.tridiag if bw == 3 else BandedSystem.penta
    diags = _diags(bw, False, dtype=np.float32)
    m = 301
    card = ctor(*diags, n=N, mode="batch", batch=m)
    host = ctor(*diags, n=N, mode="batch", batch=m, device="cpu")
    rhs = torch.from_numpy(
        np.random.default_rng(6).normal(size=(N, m)).astype(np.float32))
    fact = factorize(card, backend="auto")
    assert fact.backend == "cuda"
    name = "thomas_batch" if bw == 3 else "penta_batch"
    before = ops.LAUNCHES.get(name, 0)
    r_card = rhs.to(cuda_device).requires_grad_()
    x = solve(fact, r_card)
    x.pow(2).sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 2   # forward + rolled adjoint
    r_host = rhs.clone().requires_grad_()
    want = solve(factorize(host, backend="cuda"), r_host)
    want.pow(2).sum().backward()
    assert _rel(x, want) <= 1e-5
    assert _rel(r_card.grad, r_host.grad) <= 1e-5


def _batch_edge_n(n, dtype) -> int:
    """``n``, or the batch sweep's on-chip chunk rows L either side
    ("L-1", "L", "L+1"), its last N ("n_max") and the first past it."""
    if isinstance(n, int):
        return n
    rows = ops.BATCH_ROWS
    n_max = ops.batch_onchip_max_rows(dtype)
    return {"L-1": rows - 1, "L": rows, "L+1": rows + 1, "n_max": n_max,
            "n_max+1": n_max + 1}[n]


@pytest.mark.parametrize("n", (1, 2, 3, "L-1", "L", "L+1", 37, 512, "n_max",
                               "n_max+1"))
@pytest.mark.parametrize("storage", sorted(STORAGES))
def test_batch_routes_match_chunked_plain(storage, n, cuda_device):
    """The route the tridiagonal batch sweep picks (on chip up to N_max)
    and the stream route forced, each against the plain version in its own
    chunks, at a ragged M; each solve counted once under ``thomas_batch``."""
    spec = engine.REGISTRY["thomas_batch"]
    dtype = _TORCH_STORAGE[storage]
    n = _batch_edge_n(n, dtype)
    *diags, rhs = _batch_operands(3, n, 333, dtype, seed=n)
    picked = ops.batch_route(n, dtype, 3)
    assert picked.name == ("onchip" if n <= ops.batch_onchip_max_rows(dtype)
                           else "stream")
    for route in dict.fromkeys((picked.name, "stream")):
        r = ops.batch_route(n, dtype, 3, route)
        want = ops.batch_sweep_plain(spec, diags, rhs, chunks=r.chunks)
        before = ops.LAUNCHES.get(spec.name, 0)
        got = ops.batch_sweep_cuda(spec, diags, rhs, route=route)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[spec.name] == before + 1
        assert got.is_cuda and got.dtype == want.dtype
        assert _rel(got, want) <= STORAGES[storage], r


@pytest.mark.parametrize("n", (40, 512))
def test_batch_onchip_route_rescales_overflowing_products(n, cuda_device):
    """b in [1e3, 2e3]: a chunk's unscaled companion product overflows
    fp32; the kernel stays finite and agrees with the plain version in
    its chunks and with the sequential sweep."""
    spec = engine.REGISTRY["thomas_batch"]
    rng = np.random.default_rng(n)
    arrays = [rng.uniform(-1, 1, (n, 333)), rng.uniform(1e3, 2e3, (n, 333)),
              rng.uniform(-1, 1, (n, 333)), rng.normal(size=(n, 333))]
    *diags, rhs = [torch.from_numpy(x).to("cuda", torch.float32)
                   for x in arrays]
    got = ops.batch_sweep_cuda(spec, diags, rhs)
    torch.cuda.synchronize()
    assert ops.batch_route(n, torch.float32, 3).name == "onchip"
    assert torch.isfinite(got).all()
    assert _rel(got, ops.batch_sweep_plain(spec, diags, rhs)) <= 1e-5
    assert _rel(got, ops.batch_sweep_plain(spec, diags, rhs,
                                           chunks=1)) <= 1e-5


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64,
                                   torch.bfloat16))
def test_batch_forced_onchip_refusals(dtype, cuda_device):
    """A forced on-chip launch past N_max or for a pentadiagonal system
    raises and launches nothing."""
    tri, pen = engine.REGISTRY["thomas_batch"], engine.REGISTRY["penta_batch"]
    n = ops.batch_onchip_max_rows(dtype) + 1
    *diags, rhs = _batch_operands(3, n, 64, dtype, seed=1)
    *pdiags, prhs = _batch_operands(5, 37, 64, dtype, seed=2)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="past the on-chip"):
        ops.batch_sweep_cuda(tri, diags, rhs, route="onchip")
    with pytest.raises(ValueError, match="tridiagonal"):
        ops.batch_sweep_cuda(pen, pdiags, prhs, route="onchip")
    assert ops.LAUNCHES == before


# ---------------------------------------------------------------------------
# recurrence_sweep.cu and fused_cn.cu
# ---------------------------------------------------------------------------

RECUR_SPECS = sorted(n for n, s in engine.REGISTRY.items()
                     if s.layout == "recurrence")
# bf16 and fp16 operands: both read the same values and carry fp32, but h
# is stored at the operand type, so a one-ulp difference in a carry can
# flip a rounding: about two ulps of the storage type (2^-7, 2^-10)
RECUR_TOL = {"float32": 1e-5, "float64": 1e-12, "bf16": 2e-2,
             "float16": 2e-3}


def _recur_operands(order: int, n: int, m: int, dtype, seed: int = 0):
    """Distinct gates in every column, scaled so the recurrence stays
    bounded, and q, on the card."""
    rng = np.random.default_rng(seed + order)
    scales = (0.9,) if order == 1 else (0.6, 0.3)
    gates = [rng.uniform(-sc, sc, (n, m)) for sc in scales]
    q = rng.normal(size=(n, m))
    return ([torch.from_numpy(g).to("cuda", dtype) for g in gates],
            torch.from_numpy(q).to("cuda", dtype))


@pytest.mark.parametrize("n", (1, 2, 3, 600))
@pytest.mark.parametrize("storage", sorted(RECUR_TOL))
@pytest.mark.parametrize("name", RECUR_SPECS)
def test_recurrence_kernel_matches_plain(name, storage, n, cuda_device):
    spec = engine.REGISTRY[name]
    gates, q = _recur_operands(spec.order, n, 333, _TORCH_STORAGE[storage],
                               seed=n)
    picked = ops.recurrence_route(n, 333, q.dtype, spec.order)
    want = ops.route_plain(spec, gates, q, picked)
    before = ops.LAUNCHES.get(name, 0)
    got = ops.recurrence_sweep(spec, gates, q)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    assert got.is_cuda and got.dtype == want.dtype == q.dtype
    assert _rel(got, want) <= RECUR_TOL[storage]


# the tile route's edges at its largest window (16 chunks of R rows) at a
# ragged M, and a window past two at (o)'s and (n)'s M
_P, _R = ops.RECURRENCE_MAX_CHUNKS, ops.RECURRENCE_ROWS
RECUR_ROUTE_SHAPES = [(n, 333) for n in (1, 2, _R - 1, _R, _R + 1,
                                         _P * _R - 1, _P * _R + 1,
                                         2 * _P * _R + 3)] + [
    (2 * _P * _R + 3, 4096), (2 * _P * _R + 3, 8 * 4096)]


@pytest.mark.parametrize("n,m", RECUR_ROUTE_SHAPES)
@pytest.mark.parametrize("storage", sorted(RECUR_TOL))
@pytest.mark.parametrize("name", RECUR_SPECS)
def test_recurrence_routes_match_plain(name, storage, n, m, cuda_device):
    """The walk, the tile and the tile in 16 chunks, each forced, against
    the plain version in that route's order; one launch each."""
    spec = engine.REGISTRY[name]
    gates, q = _recur_operands(spec.order, n, m, _TORCH_STORAGE[storage],
                               seed=n + m)
    for route, chunks in (("walk", None), ("tile", None), ("tile", _P)):
        picked = ops.recurrence_tuned(n, m, q.dtype, spec.order, route,
                                      chunks)
        before = ops.LAUNCHES.get(name, 0)
        got = ops.recurrence_cuda(spec, gates, q, route=route, chunks=chunks)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before + 1
        want = ops.route_plain(spec, gates, q, picked)
        assert _rel(got, want) <= RECUR_TOL[storage], (route, chunks)


@pytest.mark.parametrize("kw", [{"route": "tile", "chunks": 0},
                                {"route": "tile", "chunks": _P + 1},
                                {"route": "walk", "chunks": 2},
                                {"route": "serial"}])
def test_recurrence_forced_route_that_cannot_run_raises(kw, cuda_device):
    spec = engine.find_recurrence_spec(1)
    gates, q = _recur_operands(1, 40, 333, torch.float32)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError):
        ops.recurrence_cuda(spec, gates, q, **kw)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("order", (1, 2))
@pytest.mark.parametrize("reverse", (False, True))
def test_recurrence_autograd_on_card_matches_cpu(order, reverse,
                                                 cuda_device):
    from repro_torch.core.recurrence import (linear_recurrence,
                                             linear_recurrence2)
    gates, q = _recur_operands(order, 37, 19, torch.float32, seed=7)
    h0 = [torch.randn(19) for _ in range(order)]
    fn = linear_recurrence if order == 1 else linear_recurrence2

    def run(device):
        leaves = [t.detach().to(device).requires_grad_()
                  for t in (*gates, q, *h0)]
        seeds = leaves[-order:]
        h = fn(*leaves[:order + 1], seeds[0] if order == 1 else seeds,
               reverse=reverse, method="cuda")
        h.sin().sum().backward()
        return [h] + [t.grad for t in leaves]

    card, host = run(cuda_device), run("cpu")
    torch.cuda.synchronize()
    for got, want in zip(card, host):
        assert _rel(got, want) <= 1e-5


def _periodic_factors(n: int, dtype):
    s = 0.4
    tri = [torch.full((n,), v, dtype=dtype) for v in (-s, 1 + 2 * s, -s)]
    pen = [torch.full((n,), v, dtype=dtype)
           for v in (s, -4 * s, 1 + 6 * s, -4 * s, s)]
    return (tridiag.periodic_thomas_factor(*tri),
            penta.periodic_penta_factor(*pen) if n >= 5 else None)


def _random_fused_operands(kind: str, n: int, dtype, seed: int):
    """Factor rows, z / Z, Minv and parameters drawn uniformly in [-1, 1],
    with no structure of a CN factor, on the card."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return 2 * torch.rand(*shape, generator=g, dtype=dtype) - 1

    zeros = torch.zeros(5, dtype=dtype)
    if kind == "tridiag":
        operands = [u(3, n), u(n), torch.cat([u(5), zeros[:3]])]
    else:
        operands = [u(5, n), u(n, 4), u(4, 4), torch.cat([u(11), zeros])]
    return [t.to("cuda") for t in operands]


def _fused_term_scale(kind: str, operands, c) -> float:
    """The largest term the fused step forms: the stencil's terms, the
    forward-sweep values, y after the backward sweep, and x.  Both the
    kernel and its plain version round each term, so their difference is
    measured against this, not against max|x| alone: random operands can
    make x = y - (correction) cancel to far less than y."""
    from repro_torch.kernels import fused_cn
    plain = getattr(fused_cn, f"fused_cn_{kind}_plain")
    lhs, z, *rest = operands
    back = 2 if kind == "tridiag" else 3    # rows of the backward sweep
    fwd_only = torch.cat([lhs[:back], torch.zeros_like(lhs[back:])])
    terms = [plain(*operands, c),
             plain(lhs, torch.zeros_like(z), *rest, c),        # y
             plain(fwd_only, torch.zeros_like(z), *rest, c)]   # forward
    weights = rest[-1][:3 if kind == "tridiag" else 5]
    return max([t.abs().max().item() for t in terms]
               + [(c.abs().max() * weights.abs().max()).item()])


# the penta stencil wraps by two rows, so it takes N >= 2; M = 333 and 1000
# are ragged and no multiple of the on-chip tile's 32 columns.  Past the
# on-chip rows: the partitioned route at 2 N_max, 4096 and the JAX step's
# 12,000 rows, at M = 333 to keep the sequential plain version short.
_FUSED_NM = [(n, m) for n in (1, 2, 3, 600, "n_max", "n_max+1")
             for m in (333, 1000)] + [
    (n, 333) for n in ("2n_max", 4096, 12_000)]


@pytest.mark.parametrize("kind,n,m", [
    (kind, n, m) for kind in ("tridiag", "penta") for n, m in _FUSED_NM
    if not (kind == "penta" and n == 1)])
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_fused_cn_kernel_matches_plain(kind, dtype, n, m, cuda_device):
    """The route the step picks, the partitioned route forced (where N
    makes two row blocks) and the global route forced, each against the
    plain version in its own row blocks and chunks: max|kernel - plain| ≤
    tol · (the largest term the step forms); each launch counted under its
    route's name, and the on-chip route refused past its rows."""
    from repro_torch.kernels import fused_cn
    n = 2 * ops.onchip_max_rows(dtype) if n == "2n_max" else _edge_n(n, dtype)
    operands = _random_fused_operands(kind, n, dtype, seed=n)
    c = torch.randn(n, m, dtype=dtype, device=cuda_device)
    plain = getattr(fused_cn, f"fused_cn_{kind}_plain")
    kernel = getattr(fused_cn, f"fused_cn_{kind}_cuda")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    scale = _fused_term_scale(kind, operands, c)
    picked = fused_cn.route(n, dtype)[0]
    split = fused_cn.row_blocks(n, dtype, "partition") >= 2
    for which in dict.fromkeys((picked,) + ("partition",) * split
                               + ("global",)):
        want = plain(*operands, c,
                     blocks=fused_cn.row_blocks(n, dtype, which),
                     chunks=fused_cn.sweep_chunks(n, dtype, which))
        before = dict(ops.LAUNCHES)
        got = (getattr(fused_cn, f"fused_cn_{kind}")(*operands, c)
               if which == picked else kernel(*operands, c, route=which))
        torch.cuda.synchronize()
        counted = {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()
                   if v != before.get(k, 0)}
        assert counted == {fused_cn.launch_name(kind, which): 1}
        assert (got - want).abs().max().item() <= tol * scale
    if picked == "partition":
        with pytest.raises(ValueError, match="on-chip"):
            kernel(*operands, c, route="onchip")
    else:
        assert picked == "onchip"


@pytest.mark.parametrize("chunks", (1, 3, 8, 16))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_cn_partitioned_route_in_any_chunks_matches_plain(
        kind, dtype, chunks, cuda_device):
    """The partitioned route forced to ``chunks`` row chunks a block
    against the plain version in the same blocks and chunks, at N = 4096
    (8 or 16 row blocks) and a ragged M = 333; its four launches timed
    alone (``partition_stages``) leave the same x as one step."""
    from repro_torch.kernels import fused_cn
    n = 4096
    operands = _random_fused_operands(kind, n, dtype, seed=chunks)
    c = torch.randn(n, 333, dtype=dtype, device=cuda_device)
    kernel = getattr(fused_cn, f"fused_cn_{kind}_cuda")
    got = kernel(*operands, c, route="partition", chunks=chunks)
    want = getattr(fused_cn, f"fused_cn_{kind}_plain")(
        *operands, c, blocks=fused_cn.row_blocks(n, dtype), chunks=chunks)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert (got - want).abs().max().item() <= tol * _fused_term_scale(
        kind, operands, c)
    before = dict(ops.LAUNCHES)
    stages = fused_cn.partition_stages(kind, *operands, c)
    assert sorted(stages) == ["k0", "k1", "k2", "k3"]
    for stage in ("k0", "k1", "k2", "k3"):
        stages[stage]()
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("chunks", (1, 2, 5, 16))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_cn_onchip_route_in_any_chunks_matches_plain(kind, dtype,
                                                           chunks,
                                                           cuda_device):
    """The on-chip route forced to ``chunks`` row chunks against the plain
    version in the same chunks, at N = 600 (uneven chunks) and M = 333."""
    from repro_torch.kernels import fused_cn
    n = 600
    operands = _random_fused_operands(kind, n, dtype, seed=chunks)
    c = torch.randn(n, 333, dtype=dtype, device=cuda_device)
    got = getattr(fused_cn, f"fused_cn_{kind}_cuda")(
        *operands, c, route="onchip", chunks=chunks)
    want = getattr(fused_cn, f"fused_cn_{kind}_plain")(*operands, c,
                                                       chunks=chunks)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert (got - want).abs().max().item() <= tol * _fused_term_scale(
        kind, operands, c)


# the main path's rows on chip (512) and past them (4096, partitioned)
@pytest.mark.parametrize("n", (512, 4096))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_cn_routes_agree_at_the_main_path_rows(kind, dtype, n,
                                                     cuda_device):
    """At N = 512 the on-chip route (8 or 16 chunks), at N = 4096 the
    partitioned route, and the global route (one chunk) agree within the
    kernel-vs-plain bar."""
    from repro_torch.kernels import fused_cn
    operands = _random_fused_operands(kind, n, dtype, seed=7)
    c = torch.randn(n, 4096, dtype=dtype, device=cuda_device)
    kernel = getattr(fused_cn, f"fused_cn_{kind}_cuda")
    picked = fused_cn.route(n, dtype)[0]
    assert picked == ("onchip" if n == 512 else "partition")
    tiled = kernel(*operands, c, route=picked)
    glob = kernel(*operands, c, route="global")
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert (tiled - glob).abs().max().item() <= tol * _fused_term_scale(
        kind, operands, c)


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_cn_step_on_card_matches_cpu(kind, cuda_device):
    from repro_torch.kernels import fused_cn
    n = 64
    tri, pen = _periodic_factors(n, torch.float32)
    pf = tri if kind == "tridiag" else pen
    step = (fused_cn.fused_cn_step if kind == "tridiag"
            else fused_cn.fused_cn_penta_step)
    c = torch.from_numpy(
        np.random.default_rng(8).normal(size=(n, 300)).astype(np.float32))
    want = step(pf, 0.4, c)
    got = step(_to_device(pf, cuda_device), 0.4, c.to(cuda_device))
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5


def _to_device(factor, device):
    """A (possibly nested) factor dataclass with every tensor on ``device``."""
    return dataclasses.replace(factor, **{
        f.name: (_to_device(v, device) if dataclasses.is_dataclass(v)
                 else v.to(device))
        for f in dataclasses.fields(factor)
        for v in (getattr(factor, f.name),)})


# the serving path of the ssm family (mamba2-130m at its smoke config)
# ---------------------------------------------------------------------------

def _ssm_smoke(dtype: str):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("mamba2-130m"), dtype=dtype)


@pytest.mark.parametrize("dtype,tol", (("float32", 1e-5), ("bfloat16", 3e-2)))
def test_ssd_layer_on_card_matches_cpu(dtype, tol, cuda_device):
    """ssm_apply at the smoke config: the card launches the recurrence
    kernel once, the CPU runs its plain version; out, state and conv tails
    agree (fp32 within 1e-5 of max|x|, TF32 off; bf16 at the JAX suite's
    3e-2)."""
    from repro_torch.models import params, ssm
    from repro_torch.sharding import ShardingCtx
    cfg = _ssm_smoke(dtype)
    p = params.init_params(ssm.ssm_specs(cfg), torch.Generator().manual_seed(1),
                           device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 3 * cfg.ssm_chunk, cfg.d_model)).astype(np.float32) * 0.3
    ).to(getattr(torch, dtype))
    sctx = ShardingCtx.local()
    want = ssm.ssm_apply(p, x, sctx, cfg)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ops.reset_launches()
        got = ssm.ssm_apply({k: v.to(cuda_device) for k, v in p.items()},
                            x.to(cuda_device), sctx, cfg)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert ops.LAUNCHES == {"recur1": 1}
    out, state, tails = got
    assert _rel(out, want[0]) <= tol and _rel(state, want[1]) <= tol
    for k in tails:
        assert _rel(tails[k], want[2][k]) <= tol


def test_prefill_launches_the_recurrence_once_a_layer(cuda_device):
    """One ``recur1`` launch per SSD layer in a prefill (n_layers in all),
    none in a decode step; the card's fp32 log-probs agree with the CPU's."""
    from repro_torch.models import Model
    cfg = _ssm_smoke("float32")
    cpu = Model(cfg, device="cpu", seed=3)
    card = Model(cfg, device=cuda_device,
                 params={k: v for k, v in cpu.params.tree().items()})
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 3 * cfg.ssm_chunk)))
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ops.reset_launches()
        logits, cache = card.prefill({"tokens": toks.to(cuda_device)})
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {"recur1": cfg.n_layers}
        ops.reset_launches()
        card.decode(cache, toks[:, 0].to(cuda_device), toks.shape[1])
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    want, _ = cpu.prefill({"tokens": toks})
    got = torch.log_softmax(logits, -1).cpu()
    assert (got - torch.log_softmax(want, -1)).abs().max().item() <= 1e-3


def test_hybrid_prefill_and_decode_on_card_match_cpu(cuda_device):
    """recurrentgemma-9b at its smoke config, prompt past the window of 32
    (a wrapped ring): one ``recur1`` launch per RG-LRU layer in a prefill
    (4 of the 5 layers), none in decode; the card's fp32 log-probs agree
    with the CPU's after the prefill and after a decode step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              dtype="float32")
    cpu = Model(cfg, device="cpu", seed=4)
    card = Model(cfg, device=cuda_device, params=cpu.params.tree())
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 41)))
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ops.reset_launches()
        logits, cache = card.prefill({"tokens": toks[:, :40].to(cuda_device)})
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {"recur1": 4}
        ops.reset_launches()
        step, _ = card.decode(cache, toks[:, 40].to(cuda_device), 40)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    want, want_cache = cpu.prefill({"tokens": toks[:, :40]})
    want_step, _ = cpu.decode(want_cache, toks[:, 40], 40)
    for got, ref in ((logits, want), (step, want_step)):
        got = torch.log_softmax(got, -1).cpu()
        assert (got - torch.log_softmax(ref, -1)).abs().max().item() <= 1e-3


def test_train_step_on_card_matches_cpu(cuda_device):
    """One fp32 train step at the ssm smoke config: on the card two
    ``recur1`` launches a layer (the forward and its remat recompute) and
    one ``recur1_rev`` (the adjoint), nothing else; its loss and grad
    norm, and ``loss_fn``'s gradients, against the CPU's plain run on the
    same weights and batch (the loss within 1e-4 relative, each gradient
    leaf within 1e-3 of its largest entry, TF32 off)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
    from repro_torch.sharding import ShardingCtx
    from repro_torch.train import AdamW, make_train_step
    cfg = _ssm_smoke("float32")
    assert cfg.remat
    cpu = Model(cfg, device="cpu", seed=5)
    params = {"cpu": cpu.params.tree()}
    params["card"] = tree_map(lambda t: t.to(cuda_device), params["cpu"])
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=4 * cfg.ssm_chunk,
                     global_batch=2, seed=2)
    batches = {"cpu": ds.batch_at(0, device="cpu"),
               "card": ds.batch_at(0, device=cuda_device)}
    sctx = ShardingCtx.local()
    opt = AdamW(lr=lambda s: 1e-3)
    step_fn = make_train_step(cpu, sctx, opt)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out, grads = {}, {}
    try:
        for where in ("card", "cpu"):
            p = params[where]
            ops.reset_launches()
            out[where] = step_fn(p, opt.init(p), batches[where], 0)[2]
            if where == "card":
                torch.cuda.synchronize()
                assert ops.LAUNCHES == {"recur1": 2 * cfg.n_layers,
                                        "recur1_rev": cfg.n_layers}
            leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
            loss, _ = loss_fn(tree_unflatten(p, leaves), batches[where],
                              sctx, cfg)
            grads[where] = torch.autograd.grad(loss, leaves)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    for key in ("loss", "grad_norm"):
        want = float(out["cpu"][key])
        assert abs(float(out["card"][key]) - want) <= 1e-4 * abs(want)
    for got, want in zip(grads["card"], grads["cpu"]):
        assert _rel(got, want) <= 1e-3


# the sharded backend: two gloo ranks on the one card, M ragged over them
SHARDED_RANKS, SHARDED_M = 2, 1001


def _sharded_rank(rank: int, init_file: str, out_dir: str) -> None:
    """Every (bandwidth, mode, boundary) on this rank: its launches and
    whether its x equals the single-process backend's columns bitwise."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.solver.sharded import lane_range
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group("cpu:gloo,cuda:gloo",
                                init_method=f"file://{init_file}", rank=rank,
                                world_size=SHARDED_RANKS)
        out = []
        for bw, mode, periodic in [(bw, mode, periodic) for bw in (3, 5)
                                   for mode in ("constant", "uniform",
                                                "batch")
                                   for periodic in (False, True)]:
            diags = [torch.tensor(v, dtype=torch.float32)
                     for v in _diags(bw, mode == "uniform")]
            ctor = BandedSystem.tridiag if bw == 3 else BandedSystem.penta
            system = ctor(*diags, n=N, periodic=periodic, mode=mode,
                          batch=SHARDED_M if mode == "batch" else None,
                          device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(bw)
            full = torch.randn(N, SHARDED_M, generator=gen, device="cuda")
            fact = factorize(system, backend="sharded")
            mesh = fact.meta.opt("mesh")
            rhs = distribute_tensor(full, mesh.device_mesh,
                                    mesh.placements((None, "batch")),
                                    src_data_rank=None)
            ops.reset_launches()
            x = solve(fact, rhs).to_local()
            launches = sum(ops.LAUNCHES.values())
            lo, hi = lane_range(SHARDED_M, mesh, "batch")
            single = factorize(system, backend=fact.meta.opt("kernels"))
            want = solve(single, full)[:, lo:hi]
            out.append({"case": (bw, mode, periodic),
                        "kernels": fact.meta.opt("kernels"),
                        "launches": launches, "columns": hi - lo,
                        "bitwise": torch.equal(x, want)})
        torch.save(out, Path(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except Exception:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def test_sharded_ranks_on_card_match_single_process(cuda_device, tmp_path):
    """Two gloo ranks share the card (NCCL wants a card a rank): each
    runs the kernel once a solve on its columns (periodic batch, which
    has no kernel, on the reference sweeps) and equals the single-process
    backend's columns bit for bit."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank,
                         args=(r, str(tmp_path / "pg_init"), str(tmp_path)))
             for r in range(SHARDED_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(180)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = [f.read_text() for f in tmp_path.glob("rank*.err")]
    assert not alive and all(p.exitcode == 0 for p in procs), errors
    for r in range(SHARDED_RANKS):
        for row in torch.load(tmp_path / f"rank{r}.pt"):
            bw, mode, periodic = row["case"]
            kernel = not (mode == "batch" and periodic)
            assert row["kernels"] == ("cuda" if kernel else "reference")
            assert row["launches"] == (1 if kernel else 0), row
            assert row["columns"] == (501 if r == 0 else 500)
            assert row["bitwise"], row


def test_nansweep_on_the_card_finds_nothing(cuda_device):
    """Every spec and fused step on every route at the ragged, dead-lane
    and aligned shapes, each output NaN-filled and fenced: every element
    written, finite, and nothing written past it."""
    from repro_torch.analysis import nansweep
    assert nansweep.run("cuda") == []


def test_tracecheck_on_the_card(cuda_device):
    """Every pure backend x mode x boundary condition and the recurrence
    cases on the kernels, under the host-sync dispatch mode and the sync
    debug mode: no finding, JAX's skips, and exactly the launches of the
    cases that ran."""
    from repro_torch.analysis import tracecheck
    ops.reset_launches()
    res = tracecheck.sweep("cuda")
    torch.cuda.synchronize()
    assert res.findings == []
    assert sorted(res.skips) == ["cuda/penta/periodic/batch",
                                 "cuda/tridiag/periodic/batch"]
    assert res.cases + 2 == len(tracecheck.contract_cases())
    assert res.recurrences == 8
    assert dict(ops.LAUNCHES) == res.launches
    assert torch.cuda.get_sync_debug_mode() == 0


def test_gridcheck_against_the_cuda_sources(cuda_device):
    """Every route rule's spans over its N grid equal what each CUDA
    source's ``<source>_spans`` export gives, and no kernel launches."""
    from repro_torch.analysis import gridcheck
    ops.reset_launches()
    res = gridcheck.sweep("cuda")
    assert res.findings == []
    assert res.spans > 10 ** 6 and res.compared == res.spans
    assert not ops.LAUNCHES


def test_run_all_on_the_card(cuda_device):
    from repro_torch.analysis import run_all
    assert run_all() == []


def test_measured_leg_on_the_card(cuda_device):
    """The dry run's measured leg at mamba2-130m's width, 2 layers, B 1:
    one ``recur1`` a layer in the timed and the traced step, the trace's
    launches equal to the counter's, every share in (0, 1]."""
    from repro_torch.launch import dryrun
    rec = dryrun.measure_cell("mamba2-130m", "prefill_32k", layers=2,
                              batch=1)
    assert rec["status"] == "ok"
    assert rec["reduced"] == ["n_layers 24 -> 2", "batch 32 -> 1 (as asked)"]
    assert rec["launches"] == {"timed": {"recur1": 2},
                               "traced": {"recur1": 2}}
    assert rec["trace"]["hand_launches"] == {"recur1": 2}
    for key in ("mfu", "measured_roofline_fraction", "busy_share"):
        assert 0 < rec[key] <= 1, (key, rec[key])
