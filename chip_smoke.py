#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` for
``sm_90a`` and no network.  Phases, each printing one JSON line:

  1. the card (``nvidia-smi`` name and power limit) and torch / CUDA versions;
  2. build every kernel from the checkout's sources (``build/repro_torch/``);
  3. each kernel against its plain-torch version on the card, for every
     sweep variant and storage type, at main-path and edge shapes (the
     batch sweep with distinct diagonals in every system, on the route it
     picks and, for tridiagonal systems, on the stream route forced, each
     in its own chunks, also at a chunk's 16 rows either side, N = 37, its
     on-chip route's last N and the first past it, where a forced on-chip
     launch must raise, and on systems whose unscaled chunk products
     overflow fp32 (b in [1e3, 2e3]); the shared
     sweep on the route it picks, on the partitioned route and, up to
     N = 4096, on the serial kernel forced, each in its own row blocks and
     chunks, also at its on-chip route's last N and the first past it,
     where a forced on-chip launch must raise).  The gated-recurrence
     kernel (4 specs × fp32, fp64, bf16, fp16) and both
     fused CN steps (fp32, fp64) are held the same way, with distinct
     operands in every column, at N ∈ {1, 2, 3, 600}, a ragged M and one
     full-size grid; the fused steps on operands drawn at random, against
     the largest term the step forms, on the route each N takes, on the
     partitioned route forced (where N makes two row blocks) and on the
     global route forced, also at the on-chip route's last N and past it
     (N_max + 1, 2 N_max, 4096 and 12,000 rows, where a forced on-chip
     launch must raise), each route counted under its own name;
  4. the main path at full size through ``repro_torch.solver`` (factorize
     with ``backend="auto"``, solve, and the adjoint through
     ``loss.backward()``), with the launch counts read around each case and
     the residual ``‖A x − d‖ / ‖d‖`` checked: shared-LHS cases (a)–(c)
     and per-system-LHS (batch) cases (d)–(e);
  5. the recurrences and the PDE steps through their public entry points,
     each with its launch counts: (f) the RG-LRU scan at recurrentgemma-9b's
     width, (g) the SSD inter-chunk scan at mamba2-130m's, (h) an order-2
     reverse recurrence with an h0 pair, each forward and backward against
     an fp64 plain scan and its autograd; (i) ``DiffusionCN(backend=
     "fused")`` against the ``cuda`` pipeline and the analytic decay, (j)
     ``fused_cn_penta_step`` against ``HyperdiffusionCN(backend="cuda")``,
     both on the fused steps' on-chip route; (k) ``ADI2D`` against the
     analytic decay; (l) both fused steps at N = 4096, past the on-chip
     route's rows, against the ``cuda`` pipeline (the partitioned route);
  6. kernel, plain-version and library times at the main-path shapes,
     beside the least time the card could take; each batch row also
     times the shared sweep on the same operator and shape, the paper's
     comparison, and holds the batch sweep to its plain version at the
     full grid on distinct diagonals in every system; (d)'s row times the
     on-chip route in turns with the stream route forced (``stream_ms``),
     at fp32 and, once each, at fp64 (256 rows, its on-chip route's last
     N) and bf16 storage, with the tile, its blocks per SM and ptxas
     report, and runs the overflow-prone case at the full grid; each
     recurrence row
     also times the public entry point on the case's own operands (the
     SSD gate broadcast), forward and forward + backward, beside the
     function's own byte floor; each on-chip fused row times the on-chip
     and the global route in turns, at fp32 and fp64, with the rate on
     the floor bytes, the block's occupancy and ptxas report, the on-chip
     route at 1–16 row chunks, and one step of the ``cuda`` pipeline at
     the same shape; (k)'s row times the shared sweep at the ADI half
     step's shape, and (l)'s rows the partitioned route at its own, in
     turns with the global route forced, at fp32 and fp64, with each of
     its four launches timed alone and one ``cuda`` pipeline step.  Each
     shared row ((a), (b), (c), (k)) gives its route (``sweep_route``),
     times it in turns with the serial kernel forced (``serial_ms``),
     with the rate on the floor bytes, the tile's blocks per SM and
     ptxas report; (a) and (k) also at 1–16 row chunks and at 16- and
     32-column tiles, the on-chip rows the partitioned route forced, and
     (c) each of the partitioned route's four launches alone;
  7. (m) serving mamba2-130m at its published config (24 layers, d_model
     768, vocab 50280, bf16, random weights from the seed) through
     ``repro_torch.launch.serve.serve``: 16 requests in waves of 8, prompt
     1024 tokens, 64 generated, counts read around it (24 ``recur1`` a
     prefill, none in decode), prefill ms a wave, decode ms a token,
     tokens/s and peak memory; one prefill timed with CUDA events and
     traced with ``torch.profiler``; the fp32 prefill on the card against
     the CPU's plain run on the same weights (log-probs within 1e-3); and
     teacher-forced decode over a 64-token prompt against the prefill
     (fp32 within the JAX suite's 3e-2 bar, bf16 within three times what
     bf16 rounding alone moves the prefill from its fp32 run).  The
     recurrence kernel's row at (m)'s operand gives its share of a prefill;
  8. one summary line (the run's seconds and peak device memory) and one
     ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; a machine without CUDA fails, it never runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# Peak device-memory rate (bytes/s) and non-tensor-core rate (FLOP/s) by
# the name nvidia-smi reports (NVIDIA's data sheets, dense rates).
_CARDS = {
    "H100 80GB HBM3": (3.35e12, {"float32": 67e12, "float64": 34e12}),
    "H100 PCIe": (2.0e12, {"float32": 51e12, "float64": 26e12}),
    "H100 NVL": (3.9e12, {"float32": 60e12, "float64": 30e12}),
}

# kernel against plain version: max|Δ| ≤ tol · max|plain|.  With bf16
# storage both read the same bf16 operands and compute in fp32, so they are
# held to the fp32 bar.
_TOLERANCE = {"float32": 1e-5, "float64": 1e-12, "bf16": 1e-5}
# The recurrence kernel stores h at the operand type: with bf16 or fp16
# operands both carry fp32, but a one-ulp difference in a carry can flip
# the rounding of h: about two ulps of the storage type (bf16's is the bar
# of tests/test_recurrence.py).
_RECUR_TOLERANCE = {"float32": 1e-5, "float64": 1e-12, "bf16": 2e-2,
                    "float16": 2e-3}
# edge shapes (ragged M) and the full-size grid of the new kernels; the
# fused steps also at the on-chip route's edge, N_max and N_max + 1 rows,
# and past it on the partitioned route (``fused_shapes``)
_RECUR_SHAPES = ((1, 333), (2, 333), (3, 333), (600, 1000), (4096, 65536))
_FUSED_SHAPES = ((1, 333), (2, 333), (3, 333), (600, 1000), (512, 1 << 20))
# the batch sweep's overflow-prone case (b in [1e3, 2e3]) on its on-chip
# route; phase ``times`` also runs it at (d)'s full grid
_OVERFLOW_SHAPES = ((40, 1000), (512, 1000))


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str) -> tuple:
    for key, rates in _CARDS.items():
        if key in name:
            return rates
    raise SmokeFailure(f"no peak rates recorded for card {name!r}")


def rel_err(got, want) -> float:
    scale = want.abs().max().clamp_min(1e-30)
    return ((got.double() - want.double()).abs().max() / scale).item()


def event_times(fn, reps: int, warmup: int = 2) -> list:
    """``reps`` CUDA-event timings (ms) of one call each, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of one call each."""
    return statistics.median(event_times(fn, reps, warmup))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def random_factor(spec, n: int, dtype, gen):
    """A diagonally dominant factor for ``spec`` at size n, on the card."""
    import torch
    from repro_torch.core import penta, tridiag

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device="cuda",
                                           dtype=torch.float64)
    if spec.bandwidth == 3:
        diags = (u(-1, 1), u(4, 5), u(-1, 1))
        return tridiag.thomas_factor(*(d.to(dtype) for d in diags))
    if spec.uniform:
        s = 0.4   # the hyperdiffusion LHS: sigma, -4 sigma, 1 + 6 sigma
        diags = [torch.full((n,), v, device="cuda", dtype=dtype)
                 for v in (s, -4 * s, 1 + 6 * s, -4 * s, s)]
        return penta.penta_factor(*diags)
    diags = [u(-0.5, 0.5) for _ in range(5)]
    diags[2] = diags[2] + 6
    return penta.penta_factor(*(d.to(dtype) for d in diags))


def sweep_operands(spec, f, rhs, storage):
    """(lhs, rhs, eps) exactly as ``ops.thomas_constant``/``penta_constant``
    hand them to the sweep."""
    from repro_torch.kernels import ops
    if spec.bandwidth == 3:
        lhs = ops.stack_tridiag_lhs(f, transposed=spec.transposed)
    else:
        lhs = ops.stack_penta_lhs(f, uniform=spec.uniform,
                                  transposed=spec.transposed)
    lhs, rhs = lhs.to(storage).contiguous(), rhs.to(storage).contiguous()
    eps = ops._uniform_eps_param(f, storage) if spec.uniform else None
    return lhs, rhs, eps


def random_batch_operands(spec, n: int, m: int, storage, gen):
    """Distinct, diagonally dominant (n, m) diagonals for every system and
    an (n, m) RHS, on the card at ``storage``: a kernel that read one
    system's coefficients for another would disagree with its plain
    version."""
    import torch

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, m, generator=gen, device="cuda",
                                           dtype=torch.float64)
    if spec.bandwidth == 3:
        diags = [u(-1, 1), u(4, 5), u(-1, 1)]
    else:
        diags = [u(-0.5, 0.5) for _ in range(5)]
        diags[2] += 6
    rhs = torch.randn(n, m, generator=gen, device="cuda", dtype=torch.float64)
    return [d.to(storage) for d in diags], rhs.to(storage)


def random_recur_operands(order: int, n: int, m: int, storage, gen):
    """Distinct gates in every column, scaled so the recurrence stays
    bounded (|p| < 0.9; |s| < 0.6, |t| < 0.3), and q, on the card."""
    import torch

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, m, generator=gen, device="cuda",
                                           dtype=torch.float64)
    gates = [u(-0.9, 0.9)] if order == 1 else [u(-0.6, 0.6), u(-0.3, 0.3)]
    q = torch.randn(n, m, generator=gen, device="cuda", dtype=torch.float64)
    return [g.to(storage) for g in gates], q.to(storage)


def random_fused_operands(kind: str, n: int, dtype, gen) -> list:
    """Factor rows, z / Z, Minv and parameters drawn uniformly in [-1, 1],
    with no structure of a CN factor, on the card."""
    import torch

    def u(*shape):
        return 2 * torch.rand(*shape, generator=gen, device="cuda",
                              dtype=dtype) - 1
    zeros = torch.zeros(5, device="cuda", dtype=dtype)
    if kind == "tridiag":
        return [u(3, n), u(n), torch.cat([u(5), zeros[:3]])]
    return [u(5, n), u(n, 4), u(4, 4), torch.cat([u(11), zeros])]


def fused_term_scale(kind: str, plain, operands, c) -> float:
    """The largest term a fused step forms: the stencil's terms, the
    forward-sweep values, y after the backward sweep, and x.  The kernel
    and its plain version each round every term, so their difference is
    held against this: on random operands x = y − (correction) can cancel
    to far less than y, and max|x| alone would measure that cancellation,
    not the kernel."""
    import torch
    lhs, z, *rest = operands
    back = 2 if kind == "tridiag" else 3    # rows of the backward sweep
    fwd_only = torch.cat([lhs[:back], torch.zeros_like(lhs[back:])])
    terms = [plain(*operands, c),
             plain(lhs, torch.zeros_like(z), *rest, c),        # y
             plain(fwd_only, torch.zeros_like(z), *rest, c)]   # forward
    weights = rest[-1][:3 if kind == "tridiag" else 5]
    return max([t.abs().max().item() for t in terms]
               + [(c.abs().max() * weights.abs().max()).item()])


def fused_shapes(dtype) -> tuple:
    """``_FUSED_SHAPES`` and the on-chip route's edge at ``dtype``: N_max
    rows (the last on chip) and N_max + 1 (the first on the partitioned
    route), at M = 1000, not a multiple of the tile's 32 columns; then the
    partitioned route at 2 N_max, 4096 and the JAX step's 12,000 rows, at
    M = 333, where the global route's plain version is a sequential loop
    of N steps."""
    from repro_torch.kernels import fused_cn
    n_max = fused_cn.onchip_max_rows(dtype)
    return _FUSED_SHAPES + ((n_max, 1000), (n_max + 1, 1000),
                            (2 * n_max, 333), (4096, 333), (12_000, 333))


def _template_args(mangled: str) -> str:
    """``fLi2ELi32ELb0E`` -> ``f,2,32,0``: a mangled template argument
    list, types as their letter (bf16 as ``bf16``) and integers as such."""
    return ",".join(num or ("bf16" if bf else letter) for num, bf, letter in
                    re.findall(r"L[a-z](\d+)E|(\d+__nv_bfloat16)|([a-z])",
                               mangled))


def ptxas_summary(log: str) -> dict:
    """Registers, spills and shared memory of each kernel in a
    ``-Xptxas -v`` report, by kernel name and template arguments
    (``fused_cn_tridiag_tile_kernel<f>``,
    ``shared_tile_kernel<f,f,1,32,0>``)."""
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"(?:entry function|properties for) .*?\d"
                          r"([a-z][a-z_]*_kernel)I(.+?)EEv", line)
        if found:
            name = f"{found.group(1)}<{_template_args(found.group(2))}>"
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("smem_bytes", r"(\d+) bytes smem")):
            hit = re.search(pattern, line)
            if hit:
                out[name][key] = int(hit.group(1))
    return out


def ops_per_row(spec) -> int:
    """Arithmetic operations per row and system, read off each kernel's
    source, a division counted as one: the shared sweep does 2 per carry
    term in each pass plus the scale; the batch sweep's fused forward pass
    does 7 (tridiag) or 16 (penta), its backward 2 or 4; the recurrence
    2 per carry term."""
    if spec.layout == "recurrence":
        return 2 * spec.order
    if spec.layout == "batch":
        return 9 if spec.order == 1 else 20
    return 4 * spec.order + 1


def shared_edge_shapes(storage) -> tuple:
    """The shared sweep's on-chip route's last N at ``storage`` and the
    first N past it (the partitioned route), at M = 1000, not a multiple
    of a tile's columns."""
    from repro_torch.kernels import ops
    n_max = ops.onchip_max_rows(storage)
    return (n_max, 1000), (n_max + 1, 1000)


def shared_routes_vs_plain(name, label, spec, lhs, rhs, eps, compare) -> None:
    """The shared sweep on the route it picks, on the partitioned route and
    (up to N = 4096, where its plain version is a sequential loop of N
    steps; phase ``times`` holds it at (c)'s full size) on the serial
    kernel forced, each against the plain version in the same row blocks
    and chunks; each solve counted once under the spec's name."""
    from repro_torch.kernels import ops
    n, m = rhs.shape
    picked = ops.shared_route(n, rhs.dtype)
    serial = ("serial",) if n <= 4096 else ()
    for which in dict.fromkeys((picked.name, "partition") + serial):
        r = ops.shared_route(n, rhs.dtype, which)
        ops.reset_launches()
        got = ops.shared_sweep_cuda(spec, lhs, rhs, eps, route=which)
        counted = dict(ops.LAUNCHES)
        check(counted == {name: 1}, f"{name}/{label} N={n} {which}: "
                                    f"launches {counted}")
        want = ops.shared_sweep_plain(spec, lhs, rhs, eps,
                                      blocks=r.row_blocks, chunks=r.chunks)
        compare(f"{name}/{which}", label, n, m, got, want)
        del got, want


def batch_edge_shapes(storage) -> tuple:
    """The batch sweep's on-chip route at ``storage``: a chunk's rows L
    either side, 37, its last N and the first past it (the stream route),
    at M = 1000, not a multiple of a block's 32 systems."""
    from repro_torch.kernels import ops
    rows, n_max = ops.BATCH_ROWS, ops.batch_onchip_max_rows(storage)
    return tuple((n, 1000) for n in (rows - 1, rows, rows + 1, 37, n_max,
                                     n_max + 1))


def overflow_batch_operands(n: int, m: int, gen):
    """Tridiagonal batch operands (fp32) whose unscaled chunk products
    overflow: b in [1e3, 2e3], a and c in [-1, 1]."""
    import torch

    def u(lo, hi):
        return (lo + (hi - lo) * torch.rand(n, m, generator=gen,
                                            device="cuda",
                                            dtype=torch.float64)).float()
    rhs = torch.randn(n, m, generator=gen, device="cuda")
    return [u(-1, 1), u(1e3, 2e3), u(-1, 1)], rhs


def batch_routes_vs_plain(name, label, spec, diags, rhs, compare) -> None:
    """The batch sweep on the route it picks and, for tridiagonal systems,
    on the stream route forced, each against the plain version in the
    route's chunks, each solve counted once under the spec's name; past
    the on-chip route's N, and for pentadiagonal systems, a forced
    on-chip launch must raise."""
    from repro_torch.kernels import ops
    n, m = rhs.shape
    picked = ops.batch_route(n, rhs.dtype, spec.bandwidth)
    routes = (picked.name, "stream") if spec.bandwidth == 3 else ("stream",)
    for which in dict.fromkeys(routes):
        r = ops.batch_route(n, rhs.dtype, spec.bandwidth, which)
        ops.reset_launches()
        got = ops.batch_sweep_cuda(spec, diags, rhs, route=which)
        counted = dict(ops.LAUNCHES)
        check(counted == {name: 1}, f"{name}/{label} N={n} {which}: "
                                    f"launches {counted}")
        compare(f"{name}/{which}", label, n, m, got,
                ops.batch_sweep_plain(spec, diags, rhs, chunks=r.chunks))
        del got
    if picked.name == "stream":
        try:
            ops.batch_sweep_cuda(spec, diags, rhs, route="onchip")
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"{name}/{label} N={n}: the on-chip route "
                               "took a system it cannot hold")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel_vs_plain() -> None:
    import torch
    from repro_torch.kernels import engine, fused_cn, ops

    storages = {"float32": (torch.float32, torch.float32),
                "float64": (torch.float64, torch.float64),
                "bf16": (torch.float32, torch.bfloat16),
                "float16": (torch.float32, torch.float16)}
    shapes = ((512, 65536), (16384, 4096), (1, 1), (2, 3), (3, 130),
              (200, 1000))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    factors, worst = {}, {}

    def compare(name, label, n, m, got, want, tol=None, scale=None):
        """max|got − want| ≤ tol · scale (default: max|want|)."""
        torch.cuda.synchronize()
        tol = _TOLERANCE[label] if tol is None else tol
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name}/{label} N={n} M={m}: dtype or shape differs")
        if scale is None:
            err = rel_err(got, want)
        else:
            err = (got - want).abs().max().item() / scale
        check(err <= tol, f"{name}/{label} N={n} M={m}: kernel vs plain "
                          f"{err:.3e} > {tol}")
        key = f"{name}/{label}"
        worst[key] = max(worst.get(key, 0.0), err)

    for name, spec in engine.REGISTRY.items():
        for label, (dtype, storage) in storages.items():
            if label == "float16" and spec.layout != "recurrence":
                continue   # only the recurrence kernel stores fp16
            if spec.layout == "recurrence":
                for n, m in _RECUR_SHAPES:
                    gates, q = random_recur_operands(spec.order, n, m,
                                                     storage, gen)
                    compare(name, label, n, m,
                            ops.recurrence_cuda(spec, gates, q),
                            ops.recurrence_plain(spec, gates, q),
                            _RECUR_TOLERANCE[label])
                    del gates, q
                continue
            if spec.layout == "batch":
                for n, m in shapes + batch_edge_shapes(storage):
                    diags, rhs = random_batch_operands(spec, n, m, storage,
                                                       gen)
                    batch_routes_vs_plain(name, label, spec, diags, rhs,
                                          compare)
                    del diags, rhs
                continue
            # the shared sweep also at its on-chip route's last N and the
            # first past it
            for n, m in shapes + shared_edge_shapes(storage):
                if spec.bandwidth == 5 and n < 2:
                    continue   # the penta factor needs N >= 2
                fkey = (spec.bandwidth, spec.uniform, n, dtype)
                if fkey not in factors:   # a variant and its transpose share it
                    factors[fkey] = random_factor(spec, n, dtype, gen)
                f = factors[fkey]
                rhs = torch.randn(n, m, generator=gen, device="cuda",
                                  dtype=dtype)
                lhs, rhs, eps = sweep_operands(spec, f, rhs, storage)
                shared_routes_vs_plain(name, label, spec, lhs, rhs, eps,
                                       compare)
                if n > ops.onchip_max_rows(storage):
                    try:
                        ops.shared_sweep_cuda(spec, lhs, rhs, eps,
                                              route="onchip")
                    except ValueError:
                        pass
                    else:
                        raise SmokeFailure(f"{name}/{label} N={n}: the "
                                           "on-chip route took an N past "
                                           "its shared memory")
                del lhs, rhs, eps
        torch.cuda.empty_cache()
    # the batch sweep's on-chip route where unscaled chunk products
    # overflow fp32: finite, and equal to the plain version in its chunks
    # and to the sequential sweep
    spec = engine.REGISTRY["thomas_batch"]
    for n, m in _OVERFLOW_SHAPES:
        diags, rhs = overflow_batch_operands(n, m, gen)
        check(ops.batch_route(n, rhs.dtype, 3).name == "onchip",
              f"overflow case N={n}: not on the on-chip route")
        got = ops.batch_sweep_cuda(spec, diags, rhs)
        check(torch.isfinite(got).all().item(),
              f"overflow case N={n}: the on-chip route is not finite")
        compare("thomas_batch/onchip_overflow", "float32", n, m, got,
                ops.batch_sweep_plain(spec, diags, rhs))
        compare("thomas_batch/onchip_overflow_vs_sequential", "float32", n,
                m, got, ops.batch_sweep_plain(spec, diags, rhs, chunks=1))
        del diags, rhs, got
    for kind in ("tridiag", "penta"):
        name = f"fused_cn_{kind}"
        kernel = getattr(fused_cn, f"{name}_cuda")
        plain = getattr(fused_cn, f"{name}_plain")
        for label in ("float32", "float64"):
            dtype = getattr(torch, label)
            for n, m in fused_shapes(dtype):
                if kind == "penta" and n < 2:
                    continue   # the 5-point stencil wraps by two rows
                operands = random_fused_operands(kind, n, dtype, gen)
                c = torch.randn(n, m, generator=gen, device="cuda",
                                dtype=dtype)
                scale = fused_term_scale(kind, plain, operands, c)
                # the route the step picks, the partitioned route forced
                # (where N makes two row blocks), the global route forced,
                # each against the plain version in its own row blocks and
                # chunks
                picked = fused_cn.route(n, dtype)[0]
                split = fused_cn.row_blocks(n, dtype, "partition") >= 2
                for route in dict.fromkeys(
                        (picked,) + ("partition",) * split + ("global",)):
                    ops.reset_launches()
                    got = kernel(*operands, c,
                                 route=None if route == picked else route)
                    counted = dict(ops.LAUNCHES)
                    want_count = {fused_cn.launch_name(kind, route): 1}
                    check(counted == want_count,
                          f"{name}/{label} N={n}: launches {counted}, "
                          f"expected {want_count}")
                    want = plain(*operands, c,
                                 blocks=fused_cn.row_blocks(n, dtype, route),
                                 chunks=fused_cn.sweep_chunks(n, dtype,
                                                              route))
                    compare(f"{name}/{route}", label, n, m, got, want,
                            scale=scale)
                    del got, want
                if picked == "partition":
                    try:
                        kernel(*operands, c, route="onchip")
                    except ValueError:
                        pass
                    else:
                        raise SmokeFailure(f"{name}/{label} N={n}: the "
                                           "on-chip route took an N past "
                                           "its shared memory")
                del operands, c
            torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain", "seconds": time.perf_counter() - t0,
          "shapes": [list(s) for s in shapes],
          "recurrence_shapes": [list(s) for s in _RECUR_SHAPES],
          "fused_shapes": {label: [list(s) for s in fused_shapes(
              getattr(torch, label))] for label in ("float32", "float64")},
          "tolerance": _TOLERANCE, "recurrence_tolerance": _RECUR_TOLERANCE,
          "fused_measure": "max|kernel - plain| / the largest term formed",
          "shared_routes": ["picked", "partition", "serial (N <= 4096)"],
          "batch_routes": ["picked", "stream (tridiag)"],
          "batch_edge_shapes": {
              label: [list(s) for s in batch_edge_shapes(storage)]
              for label, (_, storage) in storages.items()
              if label != "float16"},
          "overflow_shapes": [list(s) for s in _OVERFLOW_SHAPES],
          "shared_edge_shapes": {
              label: [list(s) for s in shared_edge_shapes(storage)]
              for label, (_, storage) in storages.items()
              if label != "float16"},
          "max_rel_err": worst})


def banded_matvec(system, x):
    """A x for an (N, M) batch, from the spec's diagonals (plain torch)."""
    import torch
    half = system.bandwidth // 2
    out = torch.zeros_like(x)
    for off, diag in zip(range(-half, half + 1), system.diagonals):
        shifted = torch.roll(x, -off, dims=0)   # row i reads x[i + off]
        if not system.periodic:
            if off > 0:
                shifted[-off:] = 0
            elif off < 0:
                shifted[:-off] = 0
        out += diag.to(x.dtype)[:, None] * shifted
    return out


def main_path_cases():
    from repro_torch.solver import BandedSystem
    s = 0.4
    return {
        "a": ("periodic tridiag constant (CN diffusion)", 512, 1 << 20,
              lambda: BandedSystem.tridiag(-s, 1 + 2 * s, -s, n=512,
                                           periodic=True, mode="constant")),
        "b": ("periodic penta uniform (CN hyperdiffusion)", 512, 1 << 20,
              lambda: BandedSystem.penta(s, -4 * s, 1 + 6 * s, -4 * s, s,
                                         n=512, periodic=True,
                                         mode="uniform")),
        "c": ("Dirichlet tridiag constant", 16384, 65536,
              lambda: BandedSystem.tridiag(-s, 1 + 2 * s, -s, n=16384,
                                           periodic=False, mode="constant")),
        "d": ("Dirichlet tridiag batch (CN diffusion)", 512, 1 << 20,
              lambda: BandedSystem.tridiag(-s, 1 + 2 * s, -s, n=512,
                                           periodic=False, mode="batch",
                                           batch=1 << 20)),
        "e": ("Dirichlet penta batch (CN hyperdiffusion)", 512, 1 << 20,
              lambda: BandedSystem.penta(s, -4 * s, 1 + 6 * s, -4 * s, s,
                                         n=512, periodic=False, mode="batch",
                                         batch=1 << 20)),
    }


# cases whose solve runs backward too, and the launches the batch cases
# must show: the forward sweep, plus the rolled adjoint on (d)
_BACKWARD = ("a", "d")
_BATCH_LAUNCHES = {"d": {"thomas_batch": 2}, "e": {"penta_batch": 1}}
_BATCH_ROUTES = {"d": "onchip", "e": "stream"}


def phase_main_path() -> dict:
    """Each case: counts to 0, factorize + solve (+ backward on (a) and
    (d)), counts read; then the residual and, for (a) and (d), the gradient
    are checked."""
    import torch
    from repro_torch.core import tridiag
    from repro_torch.kernels import engine, ops
    from repro_torch.solver import factorize, reference, solve

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {}
    for key, (title, n, m, make) in main_path_cases().items():
        system = make()
        rhs = torch.randn(n, m, generator=gen, device="cuda",
                          requires_grad=(key in _BACKWARD))
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        fact = factorize(system, backend="auto")
        x = solve(fact, rhs)
        if key in _BACKWARD:
            loss = (x ** 2).sum()
            loss.backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        check(fact.backend == "cuda",
              f"({key}) auto chose {fact.backend!r}, not 'cuda'")
        fwd = sum(v for k, v in launches.items() if not k.endswith("_t"))
        bwd = sum(v for k, v in launches.items() if k.endswith("_t"))
        check(fwd > 0, f"({key}) the forward sweep kernel never launched")
        if key in _BATCH_LAUNCHES:
            check(launches == _BATCH_LAUNCHES[key],
                  f"({key}) launches {launches}, expected "
                  f"{_BATCH_LAUNCHES[key]}")
            # the route is a shape rule: (d) takes the on-chip one
            route = ops.batch_route(n, rhs.dtype, system.bandwidth).name
            check(route == _BATCH_ROUTES[key],
                  f"({key}) batch route {route!r}, expected "
                  f"{_BATCH_ROUTES[key]!r}")
        with torch.no_grad():
            d = rhs.detach()
            resid = (torch.linalg.vector_norm(banded_matvec(system, x) - d)
                     / torch.linalg.vector_norm(d)).item()
            check(torch.isfinite(x).all().item() and x.shape == (n, m),
                  f"({key}) x is not finite of shape {(n, m)}")
            check(resid <= 1e-4, f"({key}) residual {resid:.3e} > 1e-4")
        row = {"phase": "main_path", "case": key, "title": title, "n": n,
               "m": m, "backend": fact.backend, "launches": launches,
               "seconds": seconds, "residual": resid}
        if key in _BATCH_ROUTES:
            row["batch_route"] = _BATCH_ROUTES[key]
        if key == "a":
            check(bwd > 0, "(a) the transposed sweep kernel never launched")
            with torch.no_grad():
                pf = fact.stored
                spec_t = engine.find_spec(3, "constant", transposed=True)
                lhs_t = ops.stack_tridiag_lhs(pf.factor, transposed=True)
                y = ops.shared_sweep_plain(spec_t, lhs_t.contiguous(),
                                           (2 * x).contiguous())
                want = tridiag.periodic_corner_correction_t(pf, y)
                gerr = rel_err(rhs.grad, want)
            check(gerr <= 1e-5, f"(a) rhs.grad vs plain transposed solve "
                                f"{gerr:.3e} > 1e-5")
            row["grad_rel_err"] = gerr
        if key == "d":
            # the adjoint: the plain batch sweep on the rolled diagonals
            with torch.no_grad():
                rolled = reference.transposed_batch_diagonals(3, fact.stored)
                want = ops.batch_sweep_plain(engine.find_spec(3, "batch"),
                                             rolled, (2 * x).contiguous())
                gerr = rel_err(rhs.grad, want)
                del rolled, want
            check(gerr <= 1e-5, f"(d) rhs.grad vs plain batch sweep on the "
                                f"rolled diagonals {gerr:.3e} > 1e-5")
            row["grad_rel_err"] = gerr
        emit(row)
        # a batch factorization holds (N, M) copies of every diagonal:
        # phase_times rebuilds them rather than keep them all alive
        results[key] = {"launches": fwd + bwd, "system": system,
                        "fact": None if system.mode == "batch" else fact}
        del x, rhs, fact
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# the gated recurrences and the PDE steps
# ---------------------------------------------------------------------------

SEQ = 4096          # tokens per sequence in (f) and (g)
RGLRU_WIDTH = 4096  # rnn_width, src/repro/configs/recurrentgemma_9b.py
RGLRU_BATCH = 16
# mamba2-130m, src/repro/configs/mamba2_130m.py: d_model 768, expand 2,
# head_dim 64 -> 24 heads; ssm_state 128; SSD chunk 64
SSD_HEADS, SSD_HEAD_DIM, SSD_STATE, SSD_CHUNK, SSD_BATCH = 24, 64, 128, 64, 8
PDE_N, PDE_M, PDE_STEPS, ADI_N, ADI_B, ADI_STEPS = 512, 1 << 20, 10, 1024, \
    64, 5
# case (l): the fused steps past the on-chip route's rows (partitioned)
WIDE_N, WIDE_M, WIDE_STEPS = 4096, 65536, 5
# chunk counts the on-chip fused rows also time (fp32, 512 rows)
CHUNK_SWEEP = (1, 2, 4, 8, 16)


def recurrence_cases(gen) -> dict:
    """(title, order, reverse, make) by case; ``make()`` returns the fp32
    leaves (gates, q and the seeds) on the card."""
    import torch

    def rglru():
        # per-token gates a in (0, 1); q = sqrt(1 - a^2) x, RG-LRU's input
        # normalisation, so h stays of unit scale
        shape = (SEQ, RGLRU_BATCH, RGLRU_WIDTH)
        a = torch.rand(shape, generator=gen, device="cuda")
        x = torch.randn(shape, generator=gen, device="cuda")
        return [a, torch.sqrt(1 - a * a) * x]

    def ssd():
        # the per-chunk decay exp(cumulative log a) in (0, 1), broadcast
        # over (head_dim, state): gate (nc, B, H, 1, 1)
        nc = SEQ // SSD_CHUNK
        p = torch.rand((nc, SSD_BATCH, SSD_HEADS, 1, 1), generator=gen,
                       device="cuda")
        q = torch.randn((nc, SSD_BATCH, SSD_HEADS, SSD_HEAD_DIM, SSD_STATE),
                        generator=gen, device="cuda")
        return [p, q]

    def order2():
        n, m = SEQ, 65536
        s = 1.2 * torch.rand(n, m, generator=gen, device="cuda") - 0.6
        t = 0.6 * torch.rand(n, m, generator=gen, device="cuda") - 0.3
        u = torch.randn(n, m, generator=gen, device="cuda")
        h1, h2 = (torch.randn(m, generator=gen, device="cuda")
                  for _ in range(2))
        return [s, t, u, h1, h2]

    return {
        "f": ("RG-LRU scan, recurrentgemma-9b width (S 4096 x B 16 x 4096)",
              1, False, rglru),
        "g": ("SSD inter-chunk scan, mamba2-130m (64 chunks x B 8 x 24 "
              "heads x 64 x 128)", 1, False, ssd),
        "h": ("order 2, reverse, with an h0 pair (4096 x 65536)", 2, True,
              order2),
    }


def _recur_call(order: int, reverse: bool, leaves: list, method: str):
    from repro_torch.core.recurrence import (linear_recurrence,
                                             linear_recurrence2)
    if order == 1:
        return linear_recurrence(*leaves, reverse=reverse, method=method)
    s, t, u, h1, h2 = leaves
    return linear_recurrence2(s, t, u, (h1, h2), reverse=reverse,
                              method=method)


def phase_recurrences() -> dict:
    """(f)–(h): counts to 0, ``method="auto"`` forward and
    ``loss.backward()`` with loss = ½‖h‖², counts read.  Then h and every
    gradient are held against an fp64 plain scan of the same leaves and
    autograd through it (no hand-written backward)."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    launches = {}
    for key, (title, order, reverse, make) in recurrence_cases(gen).items():
        leaves = [t.requires_grad_() for t in make()]
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        h = _recur_call(order, reverse, leaves, "auto")
        (0.5 * (h * h).sum()).backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        suffix = f"recur{order}"
        want = {suffix: 1, suffix + "_rev": 1}
        check(got == want, f"({key}) launches {got}, expected {want}")
        check(h.shape == leaves[order].shape
              and torch.isfinite(h).all().item(),
              f"({key}) h is not finite of the operand's shape")
        grads = [t.grad for t in leaves]
        check(grads[0].shape == leaves[0].shape,
              f"({key}) the gate's gradient has shape "
              f"{tuple(grads[0].shape)}, not the gate's")
        h = h.detach()
        for t in leaves:
            t.grad = None
        ref = [t.detach().double().requires_grad_() for t in leaves]
        del leaves
        h64 = _recur_call(order, reverse, ref, "scan")
        (0.5 * (h64 * h64).sum()).backward()
        h_err = rel_err(h, h64.detach())
        del h, h64
        check(h_err <= 1e-5, f"({key}) h vs fp64 plain scan {h_err:.3e}")
        grad_err = [rel_err(g, r.grad) for g, r in zip(grads, ref)]
        check(max(grad_err) <= 1e-5,
              f"({key}) gradients vs fp64 plain adjoint {grad_err}")
        emit({"phase": "main_path", "case": key, "title": title,
              "launches": got, "seconds": seconds, "h_rel_err": h_err,
              "grad_rel_err": grad_err})
        launches[key] = sum(got.values())
        del grads, ref
        torch.cuda.empty_cache()
    return launches


def _allclose(got, want, rtol: float, atol: float) -> float:
    """The worst ``|got − want| / (atol + rtol·|want|)``: ≤ 1 passes."""
    return ((got.double() - want.double()).abs()
            / (atol + rtol * want.double().abs())).max().item()


def phase_pde() -> dict:
    """(i)–(k) through ``repro_torch.pde`` and the fused steps; counts
    to 0 before each case and read after it."""
    import math

    import torch
    from repro_torch.core import penta
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_cn import fused_cn_penta_step
    from repro_torch.pde import ADI2D, DiffusionCN, HyperdiffusionCN

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    n, m = PDE_N, PDE_M
    x = torch.arange(n, device="cuda", dtype=torch.float64) / n
    wave = torch.sin(2 * math.pi * x)[:, None]
    launches = {}

    def run_case(key, title, body, want, kernels):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        checks = body()
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        check(got == want, f"({key}) launches {got}, expected {want}")
        for name, ratio in checks.items():
            check(ratio <= 1.0, f"({key}) {name}: worst |Δ| is {ratio:.3f} "
                                f"of its bar")
        emit({"phase": "main_path", "case": key, "title": title,
              "launches": got, "seconds": time.perf_counter() - t0,
              "worst_over_bar": checks})
        launches[key] = {k: got[k] for k in kernels}
        torch.cuda.empty_cache()

    def diffusion():
        dt = 0.8 / n ** 2          # sigma = 0.4, as in case (a)
        fused = DiffusionCN(n=n, dt=dt, backend="fused")
        noisy = (wave + 0.3 * torch.randn(n, m, generator=gen, device="cuda",
                                          dtype=torch.float64)).float()
        out_f = fused.run(noisy, PDE_STEPS)
        out_c = DiffusionCN(n=n, dt=dt, backend="cuda").run(noisy, PDE_STEPS)
        finite = torch.isfinite(out_f).all().item() and out_f.shape == (n, m)
        check(finite, "(i) the fused trajectory is not finite of shape "
                      f"{(n, m)}")
        # the JAX suite's bars: 3e-4/3e-5 between backends, 2e-3/2e-4
        # against the analytic decay (tests/test_pde.py)
        vs_pipeline = _allclose(out_f, out_c, 3e-4, 3e-5)
        del noisy, out_f, out_c
        clean = wave.float().expand(n, m).contiguous()
        out_a = fused.run(clean, PDE_STEPS)
        want = torch.from_numpy(DiffusionCN.analytic(
            x.cpu().numpy(), dt * PDE_STEPS)).to("cuda")[:, None]
        return {"vs_cuda_pipeline": vs_pipeline,
                "vs_analytic": _allclose(out_a, want.expand(n, m), 2e-3,
                                         2e-4)}

    def hyperdiffusion():
        dt = 0.8 / n ** 4          # sigma = 0.4
        hyper = HyperdiffusionCN(n=n, dt=dt, backend="cuda", mode="uniform")
        pf = penta.periodic_penta_factor(*(
            torch.full((n,), v, device="cuda") for v in hyper.coefficients()))
        noisy = (wave + 0.3 * torch.randn(n, m, generator=gen, device="cuda",
                                          dtype=torch.float64)).float()
        out_f = noisy
        for _ in range(PDE_STEPS):
            out_f = fused_cn_penta_step(pf, hyper.sigma, out_f)
        out_c = hyper.run(noisy, PDE_STEPS)
        check(torch.isfinite(out_f).all().item(),
              "(j) the fused trajectory is not finite")
        return {"vs_cuda_pipeline": _allclose(out_f, out_c, 3e-4, 3e-5)}

    def adi():
        dt = 0.8 / ADI_N ** 2     # sx = sy = 0.4
        model = ADI2D(nx=ADI_N, ny=ADI_N, dt=dt, backend="auto")
        g = torch.arange(ADI_N, device="cuda", dtype=torch.float64) / ADI_N
        f0 = (torch.sin(2 * math.pi * g)[:, None]
              * torch.sin(2 * math.pi * g)[None, :])
        out = model.run(f0.float()[..., None].expand(ADI_N, ADI_N, ADI_B)
                        .contiguous(), ADI_STEPS)
        gx = g.cpu().numpy()
        want = torch.from_numpy(ADI2D.analytic(
            gx[:, None], gx[None, :], dt * ADI_STEPS)).to("cuda")[..., None]
        check(out.shape == (ADI_N, ADI_N, ADI_B)
              and torch.isfinite(out).all().item(),
              "(k) the ADI field is not finite of its shape")
        # the JAX suite's bar for ADI against the analytic decay
        return {"vs_analytic": _allclose(out, want.expand_as(out), 5e-3,
                                         5e-4)}

    def wide():
        # both fused steps at WIDE_N rows, past the on-chip route's
        # onchip_max_rows: the public steps take the partitioned route
        wn, wm = WIDE_N, WIDE_M
        xw = torch.arange(wn, device="cuda", dtype=torch.float64) / wn
        noisy = (torch.sin(2 * math.pi * xw)[:, None] + 0.3 * torch.randn(
            wn, wm, generator=gen, device="cuda", dtype=torch.float64)
                 ).float()
        dt = 0.8 / wn ** 2
        out_f = DiffusionCN(n=wn, dt=dt, backend="fused").run(noisy,
                                                               WIDE_STEPS)
        out_c = DiffusionCN(n=wn, dt=dt, backend="cuda").run(noisy,
                                                              WIDE_STEPS)
        checks = {"diffusion_vs_cuda_pipeline": _allclose(out_f, out_c, 3e-4,
                                                          3e-5)}
        del out_f, out_c
        hyper = HyperdiffusionCN(n=wn, dt=0.8 / wn ** 4, backend="cuda",
                                 mode="uniform")
        pf = penta.periodic_penta_factor(*(
            torch.full((wn,), v, device="cuda")
            for v in hyper.coefficients()))
        out_f = noisy
        for _ in range(WIDE_STEPS):
            out_f = fused_cn_penta_step(pf, hyper.sigma, out_f)
        out_c = hyper.run(noisy, WIDE_STEPS)
        check(torch.isfinite(out_f).all().item() and out_f.shape == (wn, wm),
              f"(l) the fused trajectories are not finite of shape {(wn, wm)}")
        checks["hyperdiffusion_vs_cuda_pipeline"] = _allclose(
            out_f, out_c, 3e-4, 3e-5)
        return checks

    run_case("i", f"DiffusionCN fused, {PDE_STEPS} steps on {n} x {m}",
             diffusion, {"fused_cn_tridiag": 2 * PDE_STEPS,
                         "thomas_constant": PDE_STEPS},
             ("fused_cn_tridiag",))
    run_case("j", f"fused_cn_penta_step, {PDE_STEPS} steps on {n} x {m}",
             hyperdiffusion, {"fused_cn_penta": PDE_STEPS,
                              "penta_uniform": PDE_STEPS},
             ("fused_cn_penta",))
    run_case("k", f"ADI2D auto, {ADI_STEPS} steps on {ADI_N} x {ADI_N} x "
                  f"{ADI_B}", adi, {"thomas_constant": 2 * ADI_STEPS},
             ("thomas_constant",))
    run_case("l", f"DiffusionCN fused and fused_cn_penta_step, {WIDE_STEPS} "
                  f"steps each on {WIDE_N} x {WIDE_M} (the partitioned "
                  "route)",
             wide, {"fused_cn_tridiag_partition": WIDE_STEPS,
                    "thomas_constant": WIDE_STEPS,
                    "fused_cn_penta_partition": WIDE_STEPS,
                    "penta_uniform": WIDE_STEPS},
             ("fused_cn_tridiag_partition", "fused_cn_penta_partition"))
    return launches


# ---------------------------------------------------------------------------
# case (m): serving mamba2-130m at its published config
# ---------------------------------------------------------------------------

# src/repro_torch/configs/mamba2_130m.py (as src/repro/configs/): 24 layers,
# d_model 768, vocab 50280, ssm_state 128, head_dim 64, chunk 64, bf16
SERVE_ARCH = "mamba2-130m"
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 16, 8, 1024, 64
# the fp32 prefill on the card against the CPU's; teacher-forced decode
# against prefill at fp32 and bf16 (ROADMAP Queue 3 item 9)
PARITY_BATCH, PARITY_SEQ, PARITY_TOL = 1, 256, 1e-3
REPLAY_BATCH, REPLAY_SEQ, REPLAY_TOL, REPLAY_NOISE = 2, 64, 3e-2, 3.0


def _device_kernel_ms(prof) -> tuple:
    """(all kernels, recurrence kernels) device ms of a profiler trace."""
    from torch.autograd import DeviceType
    total = recur = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        total += us
        if "recurrence" in e.key:
            recur += us
    return total / 1e3, recur / 1e3


def _replay(model, tokens) -> tuple:
    """Normalised log-probs of teacher-forced decode over ``tokens`` from
    an empty cache, and of the prefill of the same tokens."""
    pre, _ = model.prefill({"tokens": tokens})
    cache = model.init_cache(*tokens.shape)
    for t in range(tokens.shape[1]):
        step, cache = model.decode(cache, tokens[:, t], t)
    return (step - step.max(-1, keepdim=True).values,
            pre - pre.max(-1, keepdim=True).values)


def phase_serve(card: str) -> dict:
    """(m): ``repro_torch.launch.serve.serve`` at mamba2-130m's published
    config, random weights from the seed, with the counts set to 0 just
    before it and read just after: one ``recur1`` launch per layer a
    prefill and none in decode.  Then one prefill (B 8, S 1024) timed with
    CUDA events and traced; the fp32 prefill on the card (the kernel)
    against the CPU (its plain version) on the same weights, log-probs
    within 1e-3; teacher-forced decode over a 64-token prompt against the
    prefill, normalised log-probs: at fp32 within the JAX suite's 3e-2
    bar, at bf16 within the rounding's own reach (below)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, build_model
    from repro_torch.models.params import tree_map

    cfg = get_config(SERVE_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.ssm_state,
           cfg.ssm_head_dim, cfg.ssm_chunk, cfg.dtype)
          == (24, 768, 50280, 128, 64, 64, "bfloat16"),
          f"(m) {SERVE_ARCH} is not at its published config: {cfg}")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve(cfg, requests=SERVE_REQUESTS, batch=SERVE_BATCH,
                prompt_len=SERVE_PROMPT, gen=SERVE_GEN, device="cuda",
                seed=SEED, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    waves = out["waves"]
    per_prefill = launches.get("recur1", 0) / len(waves)
    check(launches == {"recur1": len(waves) * cfg.n_layers},
          f"(m) launches {launches}, expected {cfg.n_layers} recur1 a "
          f"prefill over {len(waves)} waves")
    state = out["cache"]["state"]
    check(out["served"] == SERVE_REQUESTS
          and tuple(state.shape) == (cfg.n_layers, SERVE_BATCH,
                                     cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.ssm_state)
          and torch.isfinite(state).all().item(),
          "(m) the decode state is not finite of shape (L, B, H, P, N)")
    del out
    row = {"phase": "serve", "case": "m", "arch": SERVE_ARCH,
           "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
           "prompt": SERVE_PROMPT, "gen": SERVE_GEN, "launches": launches,
           "recur1_per_prefill": per_prefill,
           "prefill_ms": [w["prefill_s"] * 1e3 for w in waves],
           "decode_ms_per_token": [w["decode_s"] * 1e3 / w["decode_steps"]
                                   for w in waves],
           "tokens_per_s": SERVE_REQUESTS * SERVE_GEN
           / sum(w["prefill_s"] + w["decode_s"] for w in waves),
           "serve_seconds": time.perf_counter() - t0,
           "peak_device_bytes": peak}

    # one prefill of a wave's shape: CUDA events, then a profiler trace
    model = build_model(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, device="cuda")
    stats = kernel_stats(lambda: model.prefill({"tokens": tokens}))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
    kernels_ms, recur_ms = _device_kernel_ms(prof)
    row.update({"prefill_event_ms": stats["ms"],
                "prefill_event_ms_q1": stats["ms_q1"],
                "prefill_event_ms_q3": stats["ms_q3"],
                "trace_kernels_ms": kernels_ms,
                "trace_recurrence_ms": recur_ms,
                "trace_recurrence_share": (recur_ms / kernels_ms
                                           if kernels_ms else None)})
    del model, tokens, prof

    # the kernel against its plain version on the model path, fp32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu = Model(cfg32, device="cpu", seed=SEED + 5)
    card32 = Model(cfg32, device="cuda", params=cpu.params.tree())
    toks = torch.randint(0, cfg.vocab, (PARITY_BATCH, PARITY_SEQ),
                         generator=torch.Generator().manual_seed(SEED + 5))
    ops.reset_launches()
    got, _ = card32.prefill({"tokens": toks.cuda()})
    torch.cuda.synchronize()
    check(ops.LAUNCHES == {"recur1": cfg.n_layers},
          f"(m) fp32 prefill launches {ops.LAUNCHES}")
    want, _ = cpu.prefill({"tokens": toks})
    lp_err = (torch.log_softmax(got, -1).cpu()
              - torch.log_softmax(want, -1)).abs().max().item()
    check(lp_err <= PARITY_TOL,
          f"(m) fp32 prefill log-probs, card vs CPU, max|Δ| {lp_err:.3e}")
    del cpu, card32, got, want

    # teacher-forced decode against prefill at the full config: fp32 within
    # the JAX suite's bar; bf16, where 24 layers of rounding move the
    # prefill itself about 1 from its fp32 run (and JAX's own replay misses
    # the bar), no further from the fp32 prefill than REPLAY_NOISE times
    # the bf16 prefill is
    model = build_model(cfg, device="cuda", seed=SEED + 6)
    model32 = Model(cfg32, device="cuda",
                    params=tree_map(lambda t: t.float(), model.params.tree()))
    toks = torch.randint(0, cfg.vocab, (REPLAY_BATCH, REPLAY_SEQ),
                         generator=gen, device="cuda")
    a16, b16 = _replay(model, toks)
    a32, b32 = _replay(model32, toks)
    del model, model32
    torch.cuda.empty_cache()
    fp32_replay = _allclose(a32, b32, rtol=REPLAY_TOL, atol=10 * REPLAY_TOL)
    bf16_replay = _allclose(a16, b16, rtol=REPLAY_TOL, atol=10 * REPLAY_TOL)
    bf16_from_fp32 = (a16 - b32).abs().max().item()
    bf16_noise = (b16 - b32).abs().max().item()
    check(fp32_replay <= 1.0,
          f"(m) fp32 decode replay vs prefill {fp32_replay:.3f} of the bar")
    check(torch.isfinite(a16).all().item()
          and bf16_from_fp32 <= REPLAY_NOISE * bf16_noise,
          f"(m) bf16 decode {bf16_from_fp32:.3e} from the fp32 prefill, "
          f"the bf16 prefill {bf16_noise:.3e}")
    row.update({"fp32_logprob_max_abs_err": lp_err,
                "fp32_replay_max_abs_err": (a32 - b32).abs().max().item(),
                "fp32_replay_worst_of_bar": fp32_replay,
                "bf16_replay_max_abs_err": (a16 - b16).abs().max().item(),
                "bf16_replay_worst_of_bar": bf16_replay,
                "bf16_decode_from_fp32_prefill": bf16_from_fp32,
                "bf16_prefill_from_fp32_prefill": bf16_noise,
                "seconds": time.perf_counter() - t0})
    emit(row)
    return row


def _bound(nbytes: float, ops_count: float, card: str) -> tuple:
    """(bound_ms, bound_by): bytes over the memory rate against fp32
    operations over the card's non-tensor-core rate."""
    rate, flops = card_rates(card)
    bytes_ms = nbytes / rate * 1e3
    ops_ms = ops_count / flops["float32"] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def bound(spec, n: int, m: int, card: str) -> tuple:
    """(bound_ms, bound_by) of one fp32 solve: the larger of the bytes the
    function must move over the card's memory rate and its operations
    over the card's fp32 rate."""
    import torch
    return _bound(spec.traffic_bytes(n, m, torch.float32),
                  ops_per_row(spec) * n * m, card)


def kernel_stats(fn) -> dict:
    """Median of 20 CUDA-event timings of ``fn`` with its quartiles."""
    times = event_times(fn, reps=20)
    q1, _, q3 = statistics.quantiles(times, n=4)
    return {"ms": statistics.median(times), "ms_q1": q1, "ms_q3": q3,
            "reps": len(times)}


def adi_entry(launches: int) -> tuple:
    """(title, n, m, entry) of case (k)'s shared sweep: each ADI half step
    solves the periodic CN operator (σ = 0.4) over N = 1024 rows and
    M = 1024 · 64 lines, on one factor."""
    from repro_torch.solver import BandedSystem, factorize
    s = 0.4
    system = BandedSystem.tridiag(-s, 1 + 2 * s, -s, n=ADI_N, periodic=True,
                                  mode="constant")
    return (f"ADI2D half step: periodic tridiag constant over "
            f"{ADI_N} x {ADI_N * ADI_B}", ADI_N, ADI_N * ADI_B,
            {"launches": launches, "system": system,
             "fact": factorize(system, backend="auto")})


def shared_ptxas(ptxas: dict, order: int) -> dict:
    """The ptxas report of the shared sweep's fp32 kernels of one carry
    order: tile (``<f,f,order,tile,scale_fwd>``), coefficients, summary,
    serial and chain."""
    out = {}
    for name, report in ptxas.items():
        args = name.split("<")[-1].rstrip(">").split(",")
        fp32 = args[:3] == ["f", "f", str(order)] or args == ["f", str(order)]
        if name.startswith("shared_") and fp32:
            out[name] = report
    return out


def shared_times(key: str, title: str, n: int, m: int, entry: dict,
                 card: str, gen, ptxas: dict) -> dict:
    """The shared sweep's row, fp32: the route it takes (``ms``) and the
    serial kernel forced (``serial_ms``) timed in turns, each with
    its rate on the floor bytes; the plain version in the route's chunks;
    ``lu_solve``; the tile's blocks per SM and ptxas report; at (a) and (k)
    the route at each chunk count of ``CHUNK_SWEEP`` and both tile
    widths; on chip the partitioned route forced (``partition_ms``), at (c)
    each of the partitioned route's four launches alone (``stage_ms``)."""
    import torch
    from repro_torch.core import dense_penta, dense_tridiag
    from repro_torch.kernels import engine, ops

    system, fact = entry["system"], entry["fact"]
    spec = engine.find_spec(system.bandwidth, system.mode)
    factor = fact.stored.factor if system.periodic else fact.stored
    rhs = torch.randn(n, m, generator=gen, device="cuda")
    lhs, rhs, eps = sweep_operands(spec, factor, rhs, torch.float32)
    picked = ops.shared_route(n, torch.float32)

    def kernel(**kw):
        return ops.shared_sweep_cuda(spec, lhs, rhs, eps, **kw)

    turns = route_turns(lambda which: kernel(route=which), "serial",
                        picked.name)
    new, serial = turns[picked.name], turns["serial"]
    plain_reps = 3 if n > 4096 else 5
    plain_ms = event_ms(lambda: ops.shared_sweep_plain(spec, lhs, rhs, eps),
                        reps=plain_reps, warmup=1)
    errs = {}
    for which in (picked.name, "serial"):
        r = ops.shared_route(n, torch.float32, which)
        got = kernel(route=which)
        want = ops.shared_sweep_plain(spec, lhs, rhs, eps,
                                      blocks=r.row_blocks, chunks=r.chunks)
        errs[which] = (got - want).abs().max().item()
        check(errs[which] <= 1e-5 * want.abs().max().item(),
              f"({key}) {which} route vs plain max|Δ| {errs[which]:.3e}")
        del got, want
    floor = spec.traffic_bytes(n, m, torch.float32)
    rows = n // picked.row_blocks
    extra = {"blocks_per_sm": ops.shared_tile_blocks_per_sm(
        -(-n // picked.row_blocks), torch.float32, spec.order, picked.chunks,
        picked.tile_m)}
    if key in ("a", "k"):
        # the route at other chunk counts, each held to the chosen count's
        chosen = kernel()
        sweep = {}
        for chunks in CHUNK_SWEEP:
            err = rel_err(kernel(chunks=chunks), chosen)
            check(err <= 1e-5, f"({key}) shared sweep in {chunks} chunks vs "
                               f"{picked.chunks}: {err:.3e} > 1e-5")
            sweep[chunks] = {
                **kernel_stats(lambda: kernel(chunks=chunks)),
                "blocks_per_sm": ops.shared_tile_blocks_per_sm(
                    rows, torch.float32, spec.order, chunks, picked.tile_m)}
        extra["chunk_sweep"] = sweep
        if key in ("a", "k"):
            tiles = {}
            for tile_m in (16, 32):
                err = rel_err(kernel(tile_m=tile_m), chosen)
                check(err <= 1e-5, f"({key}) {tile_m}-column tile vs "
                                   f"{picked.tile_m}: {err:.3e} > 1e-5")
                tiles[tile_m] = {
                    **kernel_stats(lambda: kernel(tile_m=tile_m)),
                    "blocks_per_sm": ops.shared_tile_blocks_per_sm(
                        rows, torch.float32, spec.order, picked.chunks,
                        tile_m)}
            extra["tile_sweep"] = tiles
        del chosen
    if picked.name == "partition":
        stages = ops.partition_stages(spec, lhs, rhs, eps)
        extra["stage_ms"] = {k: kernel_stats(f)["ms"]
                             for k, f in stages.items()}
        del stages
    else:
        # the partitioned route forced at this N, timed alone
        extra["partition_ms"] = kernel_stats(
            lambda: kernel(route="partition"))["ms"]
    bound_ms, bound_by = bound(spec, n, m, card)
    # yardstick only: one PyTorch call solving the same dense system
    # from a precomputed LU (the port never calls it)
    dense = (dense_tridiag if system.bandwidth == 3 else dense_penta)(
        *system.diagonals, periodic=system.periodic)
    lu, piv = torch.linalg.lu_factor(dense)
    del dense
    library_ms = event_ms(lambda: torch.linalg.lu_solve(lu, piv, rhs),
                          reps=20 if n <= 512 else 5, warmup=1)
    del lu, piv, lhs, rhs
    return {
        "name": f"shared_sweep/{spec.name}/N{n}xM{m}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/shared_sweep.cu",
        "replaces": "src/repro/kernels/engine.py:760",
        "also_replaces": ["src/repro/kernels/engine.py:777",
                          "src/repro/kernels/engine.py:795"],
        "launches": entry["launches"],
        "max_abs_err": errs[picked.name],
        "ms": new["ms"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "case": key, "title": title, "ms_q1": new["ms_q1"],
        "ms_q3": new["ms_q3"], "reps": new["reps"],
        "sweep_route": dataclasses.asdict(picked),
        "gbps": floor / new["ms"] / 1e6,
        "serial_ms": serial["ms"], "serial_ms_q1": serial["ms_q1"],
        "serial_ms_q3": serial["ms_q3"],
        "serial_gbps": floor / serial["ms"] / 1e6,
        "serial_max_abs_err": errs["serial"],
        "ptxas": shared_ptxas(ptxas, spec.order),
        **extra,
    }


# Systems of the batched dense LU that stands beside the batch sweep: a
# dense (M, N, N) LU of all 2^20 systems would take about 1 TiB.
LIBRARY_M = 4096


def batch_ptxas(ptxas: dict) -> dict:
    """The ptxas report of the batch sweep's kernels: the on-chip kernel
    (``batch_onchip_kernel<storage,compute,rows>``) and the stream kernel
    (``batch_sweep_kernel<storage,compute,order>``)."""
    return {k: v for k, v in ptxas.items() if k.startswith("batch_")}


def batch_route_pair(spec, n: int, m: int, storage, card: str, gen) -> dict:
    """The batch sweep at (n, m, storage) on distinct diagonals: the route
    it picks and the stream route forced, timed in turns, each beside the
    bound and held to the plain version in its chunks."""
    import torch
    from repro_torch.kernels import ops

    diags, rhs = random_batch_operands(spec, n, m, storage, gen)
    picked = ops.batch_route(n, storage, spec.bandwidth)
    turns = route_turns(
        lambda which: ops.batch_sweep_cuda(spec, diags, rhs, route=which),
        "stream", picked.name)
    errs = {}
    for which in (picked.name, "stream"):
        r = ops.batch_route(n, storage, spec.bandwidth, which)
        got = ops.batch_sweep_cuda(spec, diags, rhs, route=which)
        errs[which] = rel_err(got, ops.batch_sweep_plain(spec, diags, rhs,
                                                         chunks=r.chunks))
        label = {torch.bfloat16: "bf16"}.get(storage, str(storage)[6:])
        check(errs[which] <= _TOLERANCE[label],
              f"batch {which} N={n} {label}: kernel vs plain "
              f"{errs[which]:.3e}")
        del got
    del diags, rhs
    torch.cuda.empty_cache()
    rate, flops = card_rates(card)
    nbytes = spec.traffic_bytes(n, m, storage)
    bound_ms = max(nbytes / rate, ops_per_row(spec) * n * m
                   / flops["float64" if storage == torch.float64
                           else "float32"]) * 1e3
    return {"n": n, "m": m, "sweep_route": dataclasses.asdict(picked),
            "ms": turns[picked.name]["ms"],
            "ms_q1": turns[picked.name]["ms_q1"],
            "ms_q3": turns[picked.name]["ms_q3"],
            "stream_ms": turns["stream"]["ms"],
            "stream_ms_q1": turns["stream"]["ms_q1"],
            "stream_ms_q3": turns["stream"]["ms_q3"],
            "bound_ms": bound_ms, "rel_err": errs}


def batch_times(key: str, entry: dict, card: str, gen, ptxas: dict) -> dict:
    """The batch sweep's row: kernel, plain, shared-sweep and library
    times.  ``ms`` is the route (d) or (e) takes, timed in turns with the
    stream route forced (``stream_ms``; the same route at (e));
    ``shared_ms`` is the shared sweep on one factor of the same operator
    at the same N and M (constant mode): the paper's comparison of
    cuThomasConstantBatch / cuPentConstantBatch with cuThomasBatch /
    cuPentBatch.  ``library_ms`` is a batched dense ``lu_solve`` from a
    precomputed ``lu_factor`` of ``LIBRARY_M`` systems, beside the kernel's
    own time at that M (``ms_at_library_m``).  (d) also gives its tile
    (systems, chunks, rows), blocks per SM and ptxas report, the same pair
    of routes at fp64 (at its on-chip route's last N) and at bf16 storage,
    and the overflow-prone case at its full grid."""
    import torch
    from repro_torch.core import dense_penta, dense_tridiag, penta, tridiag
    from repro_torch.kernels import engine, ops
    from repro_torch.solver import factorize, reference

    title, n, m, _make = main_path_cases()[key]
    system = entry["system"]
    bw = system.bandwidth
    spec = engine.find_spec(bw, "batch")
    picked = ops.batch_route(n, torch.float32, bw)
    diags = list(reference.batch_diagonals(
        bw, factorize(system, backend="auto").stored))
    rhs = torch.randn(n, m, generator=gen, device="cuda")
    turns = route_turns(
        lambda which: ops.batch_sweep_cuda(spec, diags, rhs, route=which),
        "stream", picked.name)
    stats, stream = turns[picked.name], turns["stream"]
    plain_ms = event_ms(lambda: ops.batch_sweep_plain(spec, diags, rhs),
                        reps=5, warmup=1)
    got = ops.batch_sweep_cuda(spec, diags, rhs)
    want = ops.batch_sweep_plain(spec, diags, rhs)
    max_abs_err = (got - want).abs().max().item()
    check(max_abs_err <= 1e-5 * want.abs().max().item(),
          f"({key}) kernel vs plain max|Δ| {max_abs_err:.3e}")
    del got, want
    torch.cuda.empty_cache()

    # the shared sweep on one factor of the same operator, same N and M
    shared_spec = engine.find_spec(bw, "constant")
    if bw == 3:
        lhs = ops.stack_tridiag_lhs(tridiag.thomas_factor(*system.diagonals))
    else:
        lhs = ops.stack_penta_lhs(penta.penta_factor(*system.diagonals))
    lhs = lhs.contiguous()
    shared_ms = kernel_stats(
        lambda: ops.shared_sweep_cuda(shared_spec, lhs, rhs))["ms"]
    torch.cuda.empty_cache()

    # the kernel and the library call at LIBRARY_M systems
    small = [d[:, :LIBRARY_M].contiguous() for d in diags]
    rhs_small = rhs[:, :LIBRARY_M].contiguous()
    del diags, rhs
    torch.cuda.empty_cache()
    ms_small = kernel_stats(
        lambda: ops.batch_sweep_cuda(spec, small, rhs_small))["ms"]
    dense = (dense_tridiag if bw == 3 else dense_penta)(*system.diagonals)
    lu, piv = torch.linalg.lu_factor(
        dense.expand(LIBRARY_M, n, n).contiguous())
    del dense
    b = rhs_small.t().contiguous()[..., None]
    x_lib = torch.linalg.lu_solve(lu, piv, b)[..., 0].t()
    x_ker = ops.batch_sweep_cuda(spec, small, rhs_small)
    lib_err = rel_err(x_ker, x_lib)
    check(lib_err <= 1e-4, f"({key}) kernel vs lu_solve at M={LIBRARY_M}: "
                           f"{lib_err:.3e} > 1e-4")
    library_ms = event_ms(lambda: torch.linalg.lu_solve(lu, piv, b), reps=20,
                          warmup=1)
    del lu, piv, b, small, rhs_small, x_lib, x_ker
    torch.cuda.empty_cache()

    # the main path's systems all tile one LHS: at its full grid, hold the
    # kernel (on the route the case takes) to its plain version in the
    # route's chunks on distinct diagonals in every system too
    diags, rhs = random_batch_operands(spec, n, m, torch.float32, gen)
    got = ops.batch_sweep_cuda(spec, diags, rhs)
    want = ops.batch_sweep_plain(spec, diags, rhs)
    distinct_err = rel_err(got, want)
    check(distinct_err <= _TOLERANCE["float32"],
          f"({key}) kernel vs plain on distinct diagonals at N={n} M={m}: "
          f"{distinct_err:.3e} > {_TOLERANCE['float32']}")
    del diags, rhs, got, want
    torch.cuda.empty_cache()
    extra = {}
    if picked.name == "onchip":
        diags, rhs = overflow_batch_operands(n, m, gen)
        got = ops.batch_sweep_cuda(spec, diags, rhs)
        check(torch.isfinite(got).all().item(),
              f"({key}) overflow case at the full grid is not finite")
        overflow_err = rel_err(got, ops.batch_sweep_plain(spec, diags, rhs))
        check(overflow_err <= _TOLERANCE["float32"],
              f"({key}) overflow case at the full grid: kernel vs plain "
              f"{overflow_err:.3e}")
        del diags, rhs, got
        torch.cuda.empty_cache()
        extra = {
            "tile": {"systems": 32, "chunks": picked.chunks,
                     "rows": picked.rows},
            "blocks_per_sm": ops.batch_onchip_blocks_per_sm(torch.float32,
                                                            picked.chunks),
            "overflow_rel_err": overflow_err,
            "ptxas": batch_ptxas(ptxas),
            "fp64": batch_route_pair(
                spec, ops.batch_onchip_max_rows(torch.float64), m,
                torch.float64, card, gen),
            "bf16": batch_route_pair(spec, n, m, torch.bfloat16, card, gen),
        }
    bound_ms, bound_by = bound(spec, n, m, card)
    floor = spec.traffic_bytes(n, m, torch.float32)
    return {
        "name": f"batch_sweep/{spec.name}/N{n}xM{m}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/batch_sweep.cu",
        "replaces": "src/repro/kernels/engine.py:947",
        "also_replaces": ["src/repro/kernels/engine.py:963",
                          "src/repro/kernels/engine.py:984",
                          "src/repro/kernels/engine.py:1002"],
        "launches": entry["launches"],
        "max_abs_err": max_abs_err,
        "ms": stats["ms"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_m": LIBRARY_M,
        "ms_at_library_m": ms_small, "library_rel_err": lib_err,
        "distinct_rel_err": distinct_err,
        "shared_ms": shared_ms, "batch_over_shared": stats["ms"] / shared_ms,
        "case": key, "title": title, "ms_q1": stats["ms_q1"],
        "ms_q3": stats["ms_q3"], "reps": stats["reps"],
        "sweep_route": dataclasses.asdict(picked),
        "gbps": floor / stats["ms"] / 1e6,
        "stream_ms": stream["ms"], "stream_ms_q1": stream["ms_q1"],
        "stream_ms_q3": stream["ms_q3"],
        "stream_gbps": floor / stream["ms"] / 1e6,
        **extra,
    }


# operands of the recurrence timing rows: the kernel's (N, M) at each case
_RECUR_ROWS = {"f": (1, False, SEQ, RGLRU_BATCH * RGLRU_WIDTH),
               "g": (1, False, SEQ // SSD_CHUNK,
                     SSD_BATCH * SSD_HEADS * SSD_HEAD_DIM * SSD_STATE),
               "h": (2, True, SEQ, 65536),
               "m": (1, False, SERVE_PROMPT // 64,
                     SERVE_BATCH * SSD_HEADS * SSD_HEAD_DIM * SSD_STATE)}


def recurrence_times(key: str, launches: int, card: str, gen) -> dict:
    """The recurrence kernel's row at a case's (N, M), fp32, distinct
    gates in every column."""
    import torch
    from repro_torch.kernels import engine, ops

    order, reverse, n, m = _RECUR_ROWS[key]
    spec = engine.find_recurrence_spec(order, reverse=reverse)
    gates, q = random_recur_operands(order, n, m, torch.float32, gen)
    stats = kernel_stats(lambda: ops.recurrence_cuda(spec, gates, q))
    plain_ms = event_ms(lambda: ops.recurrence_plain(spec, gates, q),
                        reps=3, warmup=1)
    got = ops.recurrence_cuda(spec, gates, q)
    want = ops.recurrence_plain(spec, gates, q)
    max_abs_err = (got - want).abs().max().item()
    check(max_abs_err <= 1e-5 * want.abs().max().item(),
          f"({key}) recurrence kernel vs plain max|Δ| {max_abs_err:.3e}")
    del got, want, gates, q
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound(spec, n, m, card)
    entry = (recurrence_entry_times(key, card, gen)
             if key in recurrence_cases(gen) else {})
    return {
        "name": f"recurrence_sweep/{spec.name}/N{n}xM{m}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/recurrence_sweep.cu",
        "replaces": "src/repro/kernels/engine.py:1156",
        "also_replaces": ["src/repro/kernels/engine.py:1169"],
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": stats["ms"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a linear "
                        "recurrence",
        "case": key, "ms_q1": stats["ms_q1"], "ms_q3": stats["ms_q3"],
        "reps": stats["reps"], **entry,
    }


def serve_recurrence_row(served: dict, card: str) -> dict:
    """The recurrence kernel at (m)'s operand (N 16 chunks, M = B 8 · 24
    heads · 64 · 128), with the serve run's launches, and its share of a
    prefill: 24 launches' time over the prefill's CUDA-event time."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    row = recurrence_times("m", served["launches"]["recur1"], card, gen)
    per_prefill = served["recur1_per_prefill"]
    row.update({"recur1_per_prefill": per_prefill,
                "prefill_event_ms": served["prefill_event_ms"],
                "share_of_prefill": per_prefill * row["ms"]
                / served["prefill_event_ms"],
                "trace_recurrence_share": served["trace_recurrence_share"]})
    emit({"phase": "times", **row})
    return row


def recurrence_entry_times(key: str, card: str, gen) -> dict:
    """``linear_recurrence(..., method="auto")`` on the case's own leaves
    (at (g) the (nc, B, H, 1, 1) gate, broadcast): forward, and forward
    with the gradients of every leaf, each beside the function's floor.
    The floor reads each leaf once and writes h once; with the backward
    it also reads the cotangent and writes one gradient per leaf."""
    import torch

    _, order, reverse, make = recurrence_cases(gen)[key]
    leaves = [t.requires_grad_() for t in make()]
    cot = torch.randn(leaves[order].shape, generator=gen, device="cuda")

    def fwd_bwd():
        h = _recur_call(order, reverse, leaves, "auto")
        torch.autograd.grad(h, leaves, cot)

    with torch.no_grad():
        fwd = kernel_stats(lambda: _recur_call(order, reverse, leaves,
                                               "auto"))
    both = kernel_stats(fwd_bwd)
    words = sum(t.numel() for t in leaves) + cot.numel()   # leaves and h
    del leaves, cot
    torch.cuda.empty_cache()
    rate = card_rates(card)[0]
    return {"entry_ms": fwd["ms"], "entry_ms_q1": fwd["ms_q1"],
            "entry_ms_q3": fwd["ms_q3"],
            "entry_bound_ms": 4 * words / rate * 1e3,
            "entry_fwd_bwd_ms": both["ms"],
            "entry_fwd_bwd_ms_q1": both["ms_q1"],
            "entry_fwd_bwd_ms_q3": both["ms_q3"],
            "entry_fwd_bwd_bound_ms": 8 * words / rate * 1e3}


def route_turns(call, first: str, second: str, reps: int = 10) -> dict:
    """Two routes of a kernel timed in turns on one card: first, second,
    second, first, ``reps`` launches a turn; ``call(route)`` launches once.
    Medians and quartiles of each route's times."""
    times = {first: [], second: []}
    for which in (first, second, second, first):
        times[which] += event_times(lambda: call(which), reps)
    out = {}
    for which, t in times.items():
        q1, _, q3 = statistics.quantiles(t, n=4)
        out[which] = {"ms": statistics.median(t), "ms_q1": q1, "ms_q3": q3,
                      "reps": len(t)}
    return out


def fused_operands(key: str, dtype):
    """(kind, ops per element, the ``cuda`` pipeline model, operands) of a
    fused case at (PDE_N, PDE_M): the CN factor of (i) or (j) at σ = 0.4."""
    import torch
    from repro_torch.core import penta
    from repro_torch.kernels import fused_cn, ops
    from repro_torch.pde import DiffusionCN, HyperdiffusionCN

    n = PDE_N
    if key == "i":
        model = DiffusionCN(n=n, dt=0.8 / n ** 2, backend="cuda", dtype=dtype)
        pf = DiffusionCN(n=n, dt=0.8 / n ** 2, backend="fused",
                         dtype=dtype).factor()
        return "tridiag", 12, model, [
            ops.stack_tridiag_lhs(pf.factor).contiguous(), pf.z,
            fused_cn.tridiag_params(pf, model.sigma, dtype)]
    model = HyperdiffusionCN(n=n, dt=0.8 / n ** 4, backend="cuda",
                             mode="uniform", dtype=dtype)
    pf = penta.periodic_penta_factor(*(
        torch.full((n,), v, device="cuda", dtype=dtype)
        for v in model.coefficients()))
    return "penta", 26, model, [
        ops.stack_penta_lhs(pf.factor).contiguous(), pf.Z,
        pf.Minv.contiguous(), fused_cn.penta_params(pf, model.sigma, dtype)]


def fused_times(key: str, launches: int, card: str, gen,
                ptxas: dict) -> dict:
    """A fused CN step's on-chip row at (512, 2^20), fp32: the on-chip
    route (``ms``) and the global one (``global_ms``) timed in turns, each
    with its rate on the floor bytes; the plain version; one step of the
    ``cuda`` pipeline (stencil, shared sweep, corner correction) on the
    same field, the comparison of ``repro/kernels/fused_cn.py``'s
    docstring; the same two routes at fp64 (``fp64``); the on-chip block's
    chunks, blocks per SM and ptxas report; and the on-chip route at each
    chunk count of ``CHUNK_SWEEP`` (``chunk_sweep``)."""
    import math

    import torch
    from repro_torch.kernels import fused_cn

    n, m = PDE_N, PDE_M
    kind, ops_per_elem, model, operands = fused_operands(key, torch.float32)
    name = f"fused_cn_{kind}"
    kernel = getattr(fused_cn, f"{name}_cuda")
    plain = getattr(fused_cn, f"{name}_plain")
    x = torch.arange(n, device="cuda", dtype=torch.float64) / n
    c = (torch.sin(2 * math.pi * x)[:, None]
         + 0.3 * torch.randn(n, m, generator=gen, device="cuda",
                             dtype=torch.float64)).float()
    turns = route_turns(lambda which: kernel(*operands, c, route=which),
                        "global", "onchip")
    plain_ms = event_ms(lambda: plain(*operands, c), reps=3, warmup=1)
    errs = {}
    for which in ("onchip", "global"):
        got = kernel(*operands, c, route=which)
        want = plain(*operands, c, blocks=1, chunks=fused_cn.sweep_chunks(
            n, torch.float32, which))
        errs[which] = (got - want).abs().max().item()
        check(errs[which] <= 1e-5 * want.abs().max().item(),
              f"({key}) {name} {which} route vs plain max|Δ| "
              f"{errs[which]:.3e}")
        del got, want
    # the on-chip route at other chunk counts (1: a warp a tile of whole
    # columns), each held to the chosen count's result
    bw = 3 if kind == "tridiag" else 5
    chosen = kernel(*operands, c, route="onchip")
    sweep = {}
    for chunks in CHUNK_SWEEP:
        out = kernel(*operands, c, route="onchip", chunks=chunks)
        err = rel_err(out, chosen)
        check(err <= 1e-5, f"({key}) {name} in {chunks} chunks vs "
                           f"{fused_cn.chunk_count(n, torch.float32)}: "
                           f"{err:.3e} > 1e-5")
        del out
        sweep[chunks] = {
            **kernel_stats(lambda: kernel(*operands, c, route="onchip",
                                          chunks=chunks)),
            "blocks_per_sm": fused_cn.onchip_blocks_per_sm(
                n, torch.float32, bw, chunks)}
    del chosen
    _, step = model.step_fn()
    pipeline = kernel_stats(lambda: step(c))
    del c
    torch.cuda.empty_cache()
    rate = card_rates(card)[0]
    traffic = getattr(fused_cn, f"{kind}_traffic_bytes")
    floor = traffic(n, m, torch.float32)["fused"]
    bound_ms, bound_by = _bound(floor, ops_per_elem * n * m, card)

    # fp64, both routes in turns on the same card
    _, _, _, ops64 = fused_operands(key, torch.float64)
    c64 = torch.randn(n, m, generator=gen, device="cuda", dtype=torch.float64)
    turns64 = route_turns(lambda which: kernel(*ops64, c64, route=which),
                          "global", "onchip")
    del ops64, c64
    torch.cuda.empty_cache()
    floor64 = traffic(n, m, torch.float64)["fused"]
    replaces = ("src/repro/kernels/fused_cn.py:32" if kind == "tridiag"
                else "src/repro/kernels/fused_cn_penta.py:31")
    onchip, glob = turns["onchip"], turns["global"]
    return {
        "name": f"{name}/N{n}xM{m}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_cn.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": errs["onchip"],
        "ms": onchip["ms"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a CN step",
        "case": key, "ms_q1": onchip["ms_q1"], "ms_q3": onchip["ms_q3"],
        "reps": onchip["reps"], "gbps": floor / onchip["ms"] / 1e6,
        "global_ms": glob["ms"], "global_ms_q1": glob["ms_q1"],
        "global_ms_q3": glob["ms_q3"], "global_gbps": floor / glob["ms"] / 1e6,
        "global_max_abs_err": errs["global"],
        "pipeline_ms": pipeline["ms"],
        "pipeline_ms_q1": pipeline["ms_q1"],
        "pipeline_ms_q3": pipeline["ms_q3"],
        "pipeline_bound_ms": _bound(traffic(n, m, torch.float32)[
            "unfused_pipeline"], ops_per_elem * n * m, card)[0],
        "fp64": {"ms": turns64["onchip"]["ms"],
                 "ms_q1": turns64["onchip"]["ms_q1"],
                 "ms_q3": turns64["onchip"]["ms_q3"],
                 "global_ms": turns64["global"]["ms"],
                 "global_ms_q1": turns64["global"]["ms_q1"],
                 "global_ms_q3": turns64["global"]["ms_q3"],
                 "bound_ms": floor64 / rate * 1e3,
                 "gbps": floor64 / turns64["onchip"]["ms"] / 1e6,
                 "global_gbps": floor64 / turns64["global"]["ms"] / 1e6},
        "onchip_block": {
            label: {"chunks": fused_cn.chunk_count(n, dtype),
                    "threads": 32 * fused_cn.chunk_count(n, dtype),
                    "smem_bytes": fused_cn.route(n, dtype)[1],
                    "blocks_per_sm": fused_cn.onchip_blocks_per_sm(
                        n, dtype, bw)}
            for label, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64))},
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith(name)},
        "chunk_sweep": sweep,
    }


def wide_operands(kind: str, dtype) -> tuple:
    """(ops per element, the ``cuda`` pipeline's step, operands) of case
    (l)'s fused step at (WIDE_N, WIDE_M): the CN factor at σ = 0.4."""
    import torch
    from repro_torch.core import penta, tridiag
    from repro_torch.kernels import fused_cn, ops
    from repro_torch.pde import DiffusionCN, HyperdiffusionCN

    n, s = WIDE_N, 0.4
    if kind == "tridiag":
        pf = tridiag.periodic_thomas_factor(*(
            torch.full((n,), v, device="cuda", dtype=dtype)
            for v in (-s, 1 + 2 * s, -s)))
        _, step = DiffusionCN(n=n, dt=2 * s / n ** 2, backend="cuda",
                              dtype=dtype).step_fn()
        return 12, step, [ops.stack_tridiag_lhs(pf.factor).contiguous(),
                          pf.z, fused_cn.tridiag_params(pf, s, dtype)]
    pf = penta.periodic_penta_factor(*(
        torch.full((n,), v, device="cuda", dtype=dtype)
        for v in (s, -4 * s, 1 + 6 * s, -4 * s, s)))
    _, step = HyperdiffusionCN(n=n, dt=2 * s / n ** 4, backend="cuda",
                               mode="uniform", dtype=dtype).step_fn()
    return 26, step, [ops.stack_penta_lhs(pf.factor).contiguous(), pf.Z,
                      pf.Minv.contiguous(),
                      fused_cn.penta_params(pf, s, dtype)]


def fused_wide_times(kind: str, launches: int, card: str, gen,
                     ptxas: dict) -> dict:
    """Case (l)'s row at (WIDE_N, WIDE_M): the partitioned route (``ms``)
    and the global route forced (``global_ms``) timed in turns, each with
    its rate on the floor bytes; each of K0–K3 timed alone
    (``stage_ms``); the plain version in the route's row blocks and
    chunks, and the global route's against its own (one chunk); one step
    of the ``cuda`` pipeline on the same field; the same at fp64
    (``fp64``); the route's split and its kernels' ptxas report."""
    import torch
    from repro_torch.kernels import fused_cn

    n, m = WIDE_N, WIDE_M
    name = f"fused_cn_{kind}"
    kernel = getattr(fused_cn, f"{name}_cuda")
    plain = getattr(fused_cn, f"{name}_plain")
    traffic = getattr(fused_cn, f"{kind}_traffic_bytes")
    rate = card_rates(card)[0]
    out = {}
    for label, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        check(fused_cn.route(n, dtype)[0] == "partition",
              f"{name}: N = {n} should take the partitioned route")
        ops_per_elem, step, operands = wide_operands(kind, dtype)
        c = torch.randn(n, m, generator=gen, device="cuda", dtype=dtype)
        turns = route_turns(lambda which: kernel(*operands, c, route=which),
                            "global", "partition")
        stages = fused_cn.partition_stages(kind, *operands, c)
        stage_ms = {k: kernel_stats(f)["ms"] for k, f in stages.items()}
        del stages
        floor = traffic(n, m, dtype)["fused"]
        row = {"ms": turns["partition"]["ms"],
               "ms_q1": turns["partition"]["ms_q1"],
               "ms_q3": turns["partition"]["ms_q3"],
               "reps": turns["partition"]["reps"],
               "gbps": floor / turns["partition"]["ms"] / 1e6,
               "global_ms": turns["global"]["ms"],
               "global_ms_q1": turns["global"]["ms_q1"],
               "global_ms_q3": turns["global"]["ms_q3"],
               "global_gbps": floor / turns["global"]["ms"] / 1e6,
               "stage_ms": stage_ms,
               "bound_ms": (floor / rate * 1e3 if label == "float64" else
                            _bound(floor, ops_per_elem * n * m, card)[0])}
        if label == "float32":
            row["plain_ms"] = event_ms(lambda: plain(*operands, c), reps=3,
                                       warmup=1)
            pipeline = kernel_stats(lambda: step(c))
            row.update({"pipeline_ms": pipeline["ms"],
                        "pipeline_ms_q1": pipeline["ms_q1"],
                        "pipeline_ms_q3": pipeline["ms_q3"],
                        "pipeline_bound_ms": _bound(traffic(
                            n, m, dtype)["unfused_pipeline"],
                            ops_per_elem * n * m, card)[0]})
            for which in ("partition", "global"):
                got = kernel(*operands, c, route=which)
                want = plain(*operands, c,
                             blocks=fused_cn.row_blocks(n, dtype, which),
                             chunks=fused_cn.sweep_chunks(n, dtype, which))
                err = (got - want).abs().max().item()
                check(err <= 1e-5 * want.abs().max().item(),
                      f"(l) {name} {which} route vs plain max|Δ| {err:.3e}")
                row["max_abs_err" if which == "partition"
                    else "global_max_abs_err"] = err
                del got, want
        out[label] = row
        del operands, c, step
        torch.cuda.empty_cache()
    row = out["float32"]
    order = 1 if kind == "tridiag" else 2
    kernels = (f"{name}_tile_kernel<f,1>", f"fused_summary_kernel<f,{order}>",
               f"fused_chain_kernel<f,{order}>",
               f"shared_coef_kernel<f,f,{order},1>")
    return {
        "name": f"{name}_partition/N{n}xM{m}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_cn.cu",
        "also_source": ["src/repro_torch/kernels/csrc/partition.cuh"],
        "replaces": ("src/repro/kernels/fused_cn.py:32" if kind == "tridiag"
                     else "src/repro/kernels/fused_cn_penta.py:31"),
        "launches": launches,
        "max_abs_err": row.pop("max_abs_err"),
        "ms": row.pop("ms"), "plain_ms": row.pop("plain_ms"),
        "bound_ms": row.pop("bound_ms"),
        "bound_by": _bound(traffic(n, m)["fused"],
                           (12 if kind == "tridiag" else 26) * n * m,
                           card)[1],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a CN step",
        "case": "l",
        "split": {"row_blocks": fused_cn.row_blocks(n, torch.float32),
                  "chunks": fused_cn.sweep_chunks(n, torch.float32),
                  "tile_smem_bytes": fused_cn.route(n, torch.float32)[1]},
        **row,
        "fp64": {**out["float64"],
                 "split": {"row_blocks": fused_cn.row_blocks(
                     n, torch.float64), "chunks": fused_cn.sweep_chunks(
                     n, torch.float64)}},
        "ptxas": {k: ptxas[k] for k in kernels if k in ptxas},
    }


def phase_times(main: dict, card: str, ptxas: dict) -> list:
    """Kernel, plain and library times of each main-path case's kernel at
    its shape; bound from this run's shapes and the card's peaks.  ``main``
    maps (a)–(e) to their systems and launches, (f)–(h) to launches,
    (i)–(l) to launches by kernel name."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    t0 = time.perf_counter()

    def add(row):
        rows.append(row)
        emit({"phase": "times", "seconds": time.perf_counter() - t0, **row})
        torch.cuda.empty_cache()

    for key, entry in main.items():
        if key in _RECUR_ROWS:
            add(recurrence_times(key, entry, card, gen))
        elif key in ("i", "j"):
            add(fused_times(key, entry[f"fused_cn_{'tridiag' if key == 'i'
                                                   else 'penta'}"],
                            card, gen, ptxas))
        elif key == "k":
            add(shared_times(key, *adi_entry(entry["thomas_constant"]), card,
                             gen, ptxas))
        elif key == "l":
            for kind in ("tridiag", "penta"):
                add(fused_wide_times(kind,
                                     entry[f"fused_cn_{kind}_partition"],
                                     card, gen, ptxas))
        elif entry["system"].mode == "batch":
            add(batch_times(key, entry, card, gen, ptxas))
        else:
            title, n, m, _make = main_path_cases()[key]
            add(shared_times(key, title, n, m, entry, card, gen, ptxas))
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch sources under {src}; run it from "
              "the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    start = time.perf_counter()

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        card = torch.cuda.get_device_name(0)
        emit({"phase": "device", "nvidia_smi": smi, "name": card,
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]})
        torch.backends.cuda.matmul.allow_tf32 = False

        from repro_torch.kernels import build
        t0 = time.perf_counter()
        reports = build.build_all()
        registers = {name: [line.split("Used ")[1].split(",")[0]
                            for line in log.splitlines() if "Used " in line]
                     for name, log in reports.items()}
        ptxas = ptxas_summary(reports.get("fused_cn", "")
                              + reports.get("shared_sweep", "")
                              + reports.get("batch_sweep", ""))
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "built": sorted(reports), "registers": registers,
              "ptxas": ptxas, "dir": str(build.BUILD_DIR)})

        phase_kernel_vs_plain()
        main = phase_main_path()
        main.update(phase_recurrences())
        main.update(phase_pde())
        kernels = phase_times(main, card, ptxas)
        peak = torch.cuda.max_memory_allocated()
        served = phase_serve(card)
        kernels.append(serve_recurrence_row(served, card))
        emit({"phase": "summary", "seconds": time.perf_counter() - start,
              "peak_device_bytes": max(peak, served["peak_device_bytes"])})
        print(json.dumps({"kernels": kernels}), flush=True)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
