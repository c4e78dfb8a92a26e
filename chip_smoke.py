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
     full-size grid (the recurrence on the route it picks, on the walk and
     the tile forced and on the tile in 16 chunks, each in its own order,
     also at the tile's edges, N = R ± 1, 16 R ± 1 and 32 R + 3 at M = 333,
     at (n)'s and (o)'s M and at (q)'s operand, where a forced geometry
     the kernel has no instantiation for must raise); the fused steps on
     operands drawn at random, against the largest term the step forms,
     on the route each N takes, on the partitioned route forced (where N
     makes two row blocks) and on the global route forced, also at the
     on-chip route's last N and past it (N_max + 1, 2 N_max, 4096 and
     12,000 rows, where a forced on-chip launch must raise), each route
     counted under its own name;
  4. the main path at full size through ``repro_torch.solver`` (factorize
     with ``backend="auto"``, solve, and the adjoint through
     ``loss.backward()``), with the launch counts read around each case and
     the residual ``‖A x − d‖ / ‖d‖`` checked: shared-LHS cases (a)–(c)
     and per-system-LHS (batch) cases (d)–(e); then (r), phase
     ``sharded``: ``factorize(system, backend="sharded")`` with its ranks
     as child processes (``chip_smoke.py --sharded-rank``, after the
     kernels are built), (r1) two gloo ranks sharing the one card and (r2)
     one NCCL rank, each solving (a)'s periodic shared system (512 × 2^20)
     and (d)'s Dirichlet batch at a ragged M = 2^20 + 3 on a DTensor rhs
     sharded over M, with the backward; exactly one forward and one
     adjoint launch a rank a case; each rank's x and rhs gradient bit for
     bit the single-process ``cuda`` backend's columns, the diagonals'
     gradient (one all-reduce) within 1e-5 of its, residuals within 1e-4;
     each rank's kernel ms (contended when ranks share the card) beside
     the single-process kernel's at the whole M, its peak memory and its
     factor's bytes;
  5. the recurrences and the PDE steps through their public entry points,
     each with its launch counts: (f) the RG-LRU scan at recurrentgemma-9b's
     width, (g) the SSD inter-chunk scan at mamba2-130m's, (h) an order-2
     reverse recurrence with an h0 pair, (o) the RG-LRU scan of one
     request of recurrentgemma-9b's prefill (S 1984 × B 1 × 4096), each
     forward and backward against an fp64 plain scan and its autograd;
     (i) ``DiffusionCN(backend="fused")`` against the ``cuda`` pipeline
     and the analytic decay, (j) ``fused_cn_penta_step`` against
     ``HyperdiffusionCN(backend="cuda")``,
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
     recurrence row ((f), (g), (h), (o), and (m) and (n) after serving)
     times the walk, the tile route and the walk again (an identical
     launch, whose distance from the first walk is the turns' noise) in
     turns, each held against the plain version in its order, with the
     route the rule picks, a verdict on it against the other route, the
     tile's chunks, rows and blocks per SM and both kernels' ptxas
     report, and
     times the public entry point on the case's own operands (the
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
  8. (n) serving recurrentgemma-9b (the hybrid family) at its published
     config (38 layers, 12 × (rec, rec, attn) + 2 rec, d_model 4096, vocab
     256000, window 2048, rnn_width 4096, bf16, random weights from the
     seed) through ``serve``: 16 requests in waves of 8, prompt 1984 tokens,
     128 generated, so the ring of 2048 slots wraps while decoding; counts
     read around it (26 ``recur1`` a prefill, one per RG-LRU layer, none in
     decode), the ring caches' shape and the RG-LRU state checked, the
     serving numbers and one traced, event-timed prefill as in (m); at full
     width and 5 layers the fp32 prefill on the card against the CPU's
     (log-probs within 1e-3), and teacher-forced decode from a 2016-token
     prefill to 2080, across the wrap, against the prefill of each checked
     prefix with (m)'s bars.  The recurrence kernel's row at (n)'s operand
     (S 1984 × B 8 · 4096) gives its share of a prefill;
  9. (s) serving granite-3-8b (the dense family) at its published config
     (40 layers, d_model 4096, 32 heads, GQA kv 8, head_dim 128, d_ff
     12800, vocab 49155, bf16): 16 requests in waves of 8, prompt 1024,
     64 generated; (t) dbrx-132b (the moe family: 16 experts, top-4) at
     full width, 4 layers, capacity factor 1.25: 8 requests, 1024 + 32;
     (u) kimi-k2-1t-a32b (384 experts, top-8, a shared expert) at full
     width, 1 layer: 8 requests, 1024 + 16.  Each through ``serve``, with
     random weights from the seed and the counts read around it (these
     families reach no solver kernel: no launch), the K/V caches' shape
     and finite values checked, the serving numbers, one prefill timed
     with CUDA events (its logits finite) and traced (the top device ops);
     for (s) at 2 layers and (t) at 1, the fp32 prefill on the card
     against the CPU's (log-probs within 1e-3; for (s), whose fp32
     rounding alone moves them about that far, within twice the CPU's
     own fp32 distance from its fp64 run, the two fp64 runs within 1e-9);
     for (s) and (t) at 2 layers (capacity ``n_experts``), teacher-forced
     decode over a 64-token prompt against the prefill (fp32 within the
     JAX suite's 2e-2 / 5e-2 bars, bf16 within three times the bf16
     prefill's own distance from fp32).  (u)'s fp32 copy does not fit on
     either side; its parity is held on the CPU at the smoke config.
     (v) seamless-m4t-large-v2 (the encdec family) at its published
     config (24 encoder and 24 decoder layers, d_model 1024, 16 heads,
     d_ff 8192, vocab 256206, 1536 frames): 16 requests in waves of 8,
     prompt 128, 128 generated, its cross memory never padded; (w)
     llama-3.2-vision-90b (the vlm family: a gated cross block every 5th
     layer over 2048 image tokens of width 7680) at full width, 10 layers,
     every cross gate set to 1.0 after the init: 8 requests, 1024 + 32.
     The same checks and timings, over JAX's zero frontends in the serve
     and seeded normals × 0.1 elsewhere; the card-vs-CPU prefill (with the
     fp64 runs) and the replay at 2 + 2 layers for (v), at one group
     (5 layers) for (w);
 10. (p) training mamba2-130m at its published config (24 layers, bf16,
     remat on, random weights from the seed) through
     ``repro_torch.launch.train.train``: 20 steps of B 8 × S 4096 (the
     ``train_4k`` length), lr 3e-3 after 5 warmup steps, a checkpoint every
     10 steps into ``build/train_p``; counts read around it (per step 48
     ``recur1``, a forward and a remat recompute a layer, and 24
     ``recur1_rev``, the adjoint; nothing else), finite losses whose last
     five average below the first five, the step-19 checkpoint restored
     bitwise onto the returned parameters and moments, and a second call
     to 22 steps resuming at step 20; median step ms, tokens/s, peak
     memory, one step timed with CUDA events and one traced.  (p') at full
     width and 2 layers, fp32, ``loss_fn`` and its gradients on the card
     against the CPU (loss within 1e-4 relative, each gradient leaf within
     1e-3 of its largest entry, TF32 off).  (q) recurrentgemma-9b at full
     width, 5 layers, bf16, B 1 × S 2048: one loss and backward, finite,
     with 8 ``recur1`` and 4 ``recur1_rev`` launches.  The recurrence
     kernel's rows at (p)'s operand (N 64 × M 1,572,864), forward and
     adjoint, give its share of a step; (q)'s (N 2048 × M 4096) are timed
     too;
 11. phase ``analysis``: ``repro_torch.analysis.speccheck`` over the
     sweep registry (with the operand recount of the traffic model), then
     ``nansweep`` on the card: every registry spec and both fused CN steps
     on every route of the four CUDA sources at the ragged, dead-lane and
     aligned shapes, each output NaN-filled and fenced by NaN guards
     (every element written and finite, nothing written past it), one
     launch a route a shape, read from the counts; ``tracecheck`` on the
     kernels (every pure backend x mode x boundary condition and the 8
     recurrence cases, forward, transposed and backward, under a dispatch
     mode that raises on a value brought to the host and under
     ``torch.cuda.set_sync_debug_mode("error")``; exactly the launches of
     the cases it ran) and the lint; ``gridcheck``, every route rule's row
     spans over its N grid held against each CUDA source's
     ``<source>_spans`` export; the mutation self-test (8 classes);
 12. phase ``profile``: the measured leg of ``repro_torch.launch.dryrun``
     on P1 mamba2-130m ``prefill_32k`` (24 layers, the batch that leaves
     10 GB free), P2 mamba2-130m ``train_4k`` (B 8), P3 recurrentgemma-9b
     ``prefill_32k`` (5 layers, B 1: four ``recur1`` on the tile route)
     and P4 granite-3-8b ``decode_32k`` (40 layers, the batch that leaves
     10 GB free): one step timed by CUDA events and one traced a cell,
     each step's hand-kernel launches exact and the trace's equal to the
     counter's, ``mfu``, ``measured_roofline_fraction`` (both of the work
     that ran) and the device's busy share in (0, 1.05], one line a cell with the top five device ops and the
     cuts, then the four records through ``roofline_report``;
 13. one summary line (the run's seconds and peak device memory) and one
     ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; a machine without CUDA fails, it never runs on the CPU.

    python3 chip_smoke.py --routes [--out build/recurrence_routes.json]

builds the kernels and, instead of the phases above, times the recurrence
kernel's two routes over a grid (``recurrence_route_grid``): the data the
route rule ``ops.recurrence_route`` and its chunk counts are chosen from.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

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


def card_rates(name: str):
    """The card's peak rates, from the port's card table
    (``repro_torch.launch.trace_analysis.CARDS``, by the name nvidia-smi
    reports; NVIDIA's data sheets, dense rates)."""
    from repro_torch.launch.trace_analysis import card_rates as rates
    try:
        return rates(name)
    except KeyError as exc:
        raise SmokeFailure(str(exc)) from None


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
    return ",".join(num or ("bf16" if bf else "fp16" if hf else letter)
                    for num, bf, hf, letter in re.findall(
                        r"L[a-z](\d+)E|(\d+__nv_bfloat16)|(\d+__half)|([a-z])",
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


def recur_shapes() -> tuple:
    """``_RECUR_SHAPES`` and the tile route's edges at its largest window
    (P = 16 chunks of R rows): N = R - 1, R, R + 1, P R - 1, P R + 1 and
    2 P R + 3 at a ragged M = 333, (n)'s and (o)'s M at (n)'s N, and
    (q)'s RG-LRU operand (N 2048 × M 4096)."""
    from repro_torch.kernels import ops
    p, r = ops.RECURRENCE_MAX_CHUNKS, ops.RECURRENCE_ROWS
    edges = tuple((n, 333) for n in (r - 1, r, r + 1, p * r - 1, p * r + 1,
                                     2 * p * r + 3))
    return _RECUR_SHAPES + edges + ((HYBRID_PROMPT, RGLRU_WIDTH),
                                    (HYBRID_PROMPT,
                                     SERVE_BATCH * RGLRU_WIDTH),
                                    (HYBRID_TRAIN_SEQ, RGLRU_WIDTH))


def recur_routes_vs_plain(name, label, spec, gates, q, compare) -> None:
    """The recurrence kernel on the route it picks, on the walk and the
    tile forced and on the tile in 16 chunks, each against the plain
    version in that route's order and counted once under the spec's name;
    a forced geometry the kernel has no instantiation for must raise."""
    from repro_torch.kernels import ops
    n, m = q.shape
    for route, chunks in ((None, None), ("walk", None), ("tile", None),
                          ("tile", ops.RECURRENCE_MAX_CHUNKS)):
        picked = ops.recurrence_tuned(n, m, q.dtype, spec.order, route,
                                      chunks)
        ops.reset_launches()
        got = ops.recurrence_cuda(spec, gates, q, route=route, chunks=chunks)
        check(ops.LAUNCHES == {name: 1},
              f"{name}/{label} N={n}: launches {ops.LAUNCHES}")
        compare(f"{name}/{route or 'picked'}", label, n, m, got,
                ops.route_plain(spec, gates, q, picked),
                _RECUR_TOLERANCE[label])
        del got
    for kw in ({"route": "tile", "chunks": ops.RECURRENCE_MAX_CHUNKS + 1},
               {"route": "walk", "chunks": 2}):
        try:
            ops.recurrence_cuda(spec, gates, q, **kw)
        except ValueError:
            continue
        raise SmokeFailure(f"{name}/{label}: forced {kw} did not raise")


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
                for n, m in recur_shapes():
                    gates, q = random_recur_operands(spec.order, n, m,
                                                     storage, gen)
                    recur_routes_vs_plain(name, label, spec, gates, q,
                                          compare)
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
          "recurrence_shapes": [list(s) for s in recur_shapes()],
          "recurrence_routes": ["picked", "walk", "tile",
                                "tile in 16 chunks"],
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
# (r) the sharded backend: ranks sharing the one card
# ---------------------------------------------------------------------------

SHARDED_N = 512
# (a)'s shape, and (d)'s with a ragged M (shards of 524,290 and 524,289)
SHARDED_M = {"a": 1 << 20, "d": (1 << 20) + 3}
# the launches each rank must show for its solve + backward
_SHARDED_LAUNCHES = {"a": {"thomas_constant": 1, "thomas_constant_t": 1},
                     "d": {"thomas_batch": 2}}
# (run, ranks, process-group backend): two gloo ranks time-slice the card
# (two processes on one device rule NCCL out); one NCCL rank is the
# production backend on the same code
SHARDED_RUNS = (("r1", 2, "cpu:gloo,cuda:gloo"), ("r2", 1, "nccl"))
SHARDED_DIR = ROOT / "build" / "sharded"


def sharded_system(key: str):
    """(a)'s periodic CN diffusion LHS (σ = 0.4) or (d)'s Dirichlet batch
    of it, diagonals requiring grad."""
    import torch
    from repro_torch.solver import BandedSystem
    s = 0.4
    diags = [torch.full((SHARDED_N,), v, device="cuda", requires_grad=True)
             for v in (-s, 1 + 2 * s, -s)]
    if key == "a":
        return BandedSystem.tridiag(*diags, n=SHARDED_N, periodic=True,
                                    mode="constant", device="cuda")
    return BandedSystem.tridiag(*diags, n=SHARDED_N, periodic=False,
                                mode="batch", batch=SHARDED_M[key],
                                device="cuda")


def _stored_bytes(stored) -> int:
    from repro_torch.solver.plan import _tensors
    return sum(t.numel() * t.element_size() for t in _tensors(
        {k: v.to_local() for k, v in stored.items()}
        if isinstance(stored, dict) else stored))


def sharded_case(key: str, card: str) -> dict:
    """One case on this rank: factorize with ``backend="sharded"``, solve a
    DTensor rhs sharded ``Shard(1)``, backward, counts read around it; then
    the single-process ``cuda`` backend on the whole M in this process,
    held bit for bit (x and the rhs's gradient, this rank's columns) and
    within 1e-5 (the diagonals' gradient, summed over the ranks by the one
    all-reduce); then the rank's kernel and the single-process one timed
    (contended when ranks share the card)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.core import dense_tridiag
    from repro_torch.kernels import engine, ops
    from repro_torch.solver import factorize, solve
    from repro_torch.solver.sharded import lane_range

    n, m = SHARDED_N, SHARDED_M[key]
    system = sharded_system(key)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    full = torch.randn(n, m, generator=gen, device="cuda")
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    fact = factorize(system, backend="sharded")
    mesh = fact.meta.opt("mesh")
    rhs = distribute_tensor(full, mesh.device_mesh,
                            mesh.placements((None, "batch")),
                            src_data_rank=None).requires_grad_()
    x = solve(fact, rhs)
    (x.to_local() ** 2).sum().backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches == _SHARDED_LAUNCHES[key],
          f"(r) case {key}: launches {launches}, expected "
          f"{_SHARDED_LAUNCHES[key]}")
    lo, hi = lane_range(m, mesh, "batch")
    x_local = x.to_local().detach()
    lam_local = rhs.grad.to_local()
    grads = [d.grad.clone() for d in system.diagonals]
    d_local = full[:, lo:hi]
    with torch.no_grad():
        resid = (torch.linalg.vector_norm(banded_matvec(system, x_local)
                                          - d_local)
                 / torch.linalg.vector_norm(d_local)).item()
    check(torch.isfinite(x_local).all().item() and
          x_local.shape == (n, hi - lo) and tuple(x.shape) == (n, m),
          f"(r) case {key}: x is not finite of shape {(n, hi - lo)}")
    check(resid <= 1e-4, f"(r) case {key}: residual {resid:.3e} > 1e-4")
    factor_bytes = _stored_bytes(fact.stored)
    local_stored = (fact.stored if key == "a" else
                    [v.to_local() for v in fact.stored.values()])
    del x, rhs
    # the single-process cuda backend on the whole M, in this process
    for d in system.diagonals:
        d.grad = None
    single = factorize(system, backend="cuda")
    rhs1 = full.clone().requires_grad_()
    x1 = solve(single, rhs1)
    (x1 ** 2).sum().backward()
    x_bitwise = torch.equal(x_local, x1[:, lo:hi].detach())
    lam_bitwise = torch.equal(lam_local, rhs1.grad[:, lo:hi])
    grad_err = max(rel_err(g, d.grad) for g, d in zip(grads,
                                                       system.diagonals))
    check(x_bitwise, f"(r) case {key}: this rank's x differs from the "
                     "single-process cuda backend's columns")
    check(lam_bitwise, f"(r) case {key}: this rank's rhs gradient differs "
                       "from the single-process cuda backend's columns")
    check(grad_err <= 1e-5, f"(r) case {key}: diagonal gradient vs the "
                            f"single-process one {grad_err:.3e} > 1e-5")
    del x1, rhs1, lam_local
    torch.cuda.empty_cache()
    # the kernel on this rank's columns and on the whole M, by events
    local = d_local.contiguous()
    if key == "a":
        spec = engine.find_spec(3, "constant")
        route = ops.shared_route(n, torch.float32)

        def kernel(r):
            return ops.thomas_constant(local_stored.factor, r)

        def kernel_full():
            return ops.thomas_constant(single.stored.factor, full)

        lhs, _, eps = sweep_operands(spec, local_stored.factor, local[:, :1],
                                     torch.float32)

        def plain():
            return ops.shared_sweep_plain(spec, lhs, local, eps,
                                          blocks=route.row_blocks,
                                          chunks=route.chunks)
    else:
        spec = engine.find_spec(3, "batch")
        route = ops.batch_route(n, torch.float32, 3)

        def kernel(r):
            return ops.thomas_batch(*local_stored, r)

        def kernel_full():
            return ops.thomas_batch(*single.stored.values(), full)

        def plain():
            return ops.batch_sweep_plain(spec, local_stored, local,
                                         chunks=route.chunks)
    want = plain()
    max_abs_err = (kernel(local) - want).abs().max().item()
    check(max_abs_err <= 1e-5 * want.abs().max().item(),
          f"(r) case {key}: kernel vs plain max|Δ| {max_abs_err:.3e}")
    del want
    dist.barrier()
    rank_stats = kernel_stats(lambda: kernel(local))
    dist.barrier()
    single_stats = kernel_stats(kernel_full)
    plain_ms = event_ms(plain, reps=3, warmup=1)
    library_ms = None
    if key == "a":
        # yardstick only: one PyTorch call on the same dense system
        dense = dense_tridiag(*(d.detach() for d in system.diagonals),
                              periodic=True)
        lu, piv = torch.linalg.lu_factor(dense)
        library_ms = event_ms(lambda: torch.linalg.lu_solve(lu, piv, local),
                              reps=5, warmup=1)
        del lu, piv, dense
    bound_ms, bound_by = bound(spec, n, hi - lo, card)
    row = {"case": key, "n": n, "m": m, "lo": lo, "hi": hi,
           "launches": launches, "seconds": seconds, "residual": resid,
           "x_bitwise": x_bitwise, "rhs_grad_bitwise": lam_bitwise,
           "diag_grad_rel_err": grad_err, "max_abs_err": max_abs_err,
           "rank_ms": rank_stats["ms"], "rank_ms_q1": rank_stats["ms_q1"],
           "rank_ms_q3": rank_stats["ms_q3"],
           "single_ms": single_stats["ms"],
           "single_ms_q1": single_stats["ms_q1"],
           "single_ms_q3": single_stats["ms_q3"],
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "peak_device_bytes": peak, "factor_bytes": factor_bytes,
           "sweep_route": dataclasses.asdict(route)}
    del local_stored, single, full, d_local, local
    torch.cuda.empty_cache()
    return row


def sharded_rank_main(args) -> int:
    """A rank of phase ``sharded``: join the group, run (a) and (d), write
    this rank's rows to ``<dir>/rank<r>.json``.  Never prints the
    contract's lines."""
    import torch
    import torch.distributed as dist
    out = Path(args.sharded_dir)
    dist.init_process_group(args.sharded_backend,
                            init_method=f"file://{out / 'pg_init'}",
                            rank=args.sharded_rank,
                            world_size=args.sharded_world)
    try:
        card = torch.cuda.get_device_name(0)
        rows = [sharded_case(key, card) for key in SHARDED_M]
        device = str(torch.device("cuda", torch.cuda.current_device()))
    finally:
        dist.destroy_process_group()
    (out / f"rank{args.sharded_rank}.json").write_text(json.dumps(
        {"rank": args.sharded_rank, "device": device, "rows": rows}))
    return 0


def _sharded_kernel_row(run: str, world: int, res: dict, row: dict) -> dict:
    key = row["case"]
    kind = ("shared_sweep/thomas_constant" if key == "a"
            else "batch_sweep/thomas_batch")
    return {
        "name": f"{kind}/N{row['n']}xM{row['hi'] - row['lo']}/({run}) rank "
                f"{res['rank']} of {world}",
        "route": "cuda",
        "source": ("src/repro_torch/kernels/csrc/shared_sweep.cu"
                   if key == "a" else
                   "src/repro_torch/kernels/csrc/batch_sweep.cu"),
        "replaces": ("src/repro/kernels/engine.py:760" if key == "a"
                     else "src/repro/kernels/engine.py:947"),
        "launches": sum(row["launches"].values()),
        "max_abs_err": row["max_abs_err"],
        "ms": row["rank_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "case": f"{run}/{key}", "single_ms": row["single_ms"],
        "contended": world > 1,
    }


def phase_sharded(card: str) -> list:
    """(r): the sharded backend with its ranks as child processes of this
    one, each running ``chip_smoke.py --sharded-rank``: (r1) two gloo ranks
    on the one card, (r2) one NCCL rank.  Any rank that fails or exits
    non-zero fails the phase.  Returns the kernel rows."""
    import shutil
    import os
    import torch
    torch.cuda.empty_cache()
    kernel_rows = []
    t0 = time.perf_counter()
    for run, world, backend in SHARDED_RUNS:
        shutil.rmtree(SHARDED_DIR, ignore_errors=True)
        SHARDED_DIR.mkdir(parents=True)
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank",
             str(r), "--sharded-world", str(world), "--sharded-backend",
             backend, "--sharded-dir", str(SHARDED_DIR)],
            env=dict(os.environ, LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            logs.append("timed out after 300 s")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [i for i, proc in enumerate(procs) if proc.returncode != 0]
        check(not failed, f"(r) {run}: ranks {failed} failed:\n"
                          + "\n".join(log[-3000:] for log in logs))
        emit({"phase": "sharded", "run": run, "ranks": world,
              "backend": backend,
              "collective": "one all_reduce a backward (the (3, N) diagonal "
                            "gradient sums) on the CUDA tensors as they are, "
                            "through this backend: no host copy in the port"})
        for r in range(world):
            res = json.loads((SHARDED_DIR / f"rank{r}.json").read_text())
            for row in res["rows"]:
                emit({"phase": "sharded", "run": run, "ranks": world,
                      "backend": backend, "rank": r,
                      "device": res["device"],
                      "seconds_so_far": time.perf_counter() - t0,
                      "timing": ("contended: the ranks time-slice one card; "
                                 "not a scaling figure") if world > 1
                      else "one rank alone on the card",
                      **row})
                kernel_rows.append(_sharded_kernel_row(run, world, res, row))
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    return kernel_rows


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

    def rglru(seq=SEQ, batch=RGLRU_BATCH):
        # per-token gates a in (0, 1); q = sqrt(1 - a^2) x, RG-LRU's input
        # normalisation, so h stays of unit scale
        shape = (seq, batch, RGLRU_WIDTH)
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
        "o": ("RG-LRU scan, one request of recurrentgemma-9b's prefill "
              "(S 1984 x B 1 x 4096)", 1, False,
              lambda: rglru(HYBRID_PROMPT, 1)),
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
    """(f)–(h) and (o): counts to 0, ``method="auto"`` forward and
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


def _device_kernels(prof) -> dict:
    """Device ms by kernel name of a profiler trace."""
    from torch.autograd import DeviceType
    return {e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)) / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _device_ops(prof) -> dict:
    """Device ms by the host op that launched it (``aten::mul``, ...) of a
    profiler trace."""
    from torch.autograd import DeviceType
    out = {e.key: getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0)) / 1e3
           for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    return {k: v for k, v in out.items() if v > 0}


def _device_kernel_ms(prof) -> tuple:
    """(all kernels, recurrence kernels) device ms of a profiler trace."""
    kernels = _device_kernels(prof)
    return (sum(kernels.values()),
            sum(ms for name, ms in kernels.items() if "recurrence" in name))


def _normed(logits):
    return logits - logits.max(-1, keepdim=True).values


def _replay(model, tokens, frontend=None) -> tuple:
    """Normalised log-probs of teacher-forced decode over ``tokens`` from
    an empty cache, and of the prefill of the same tokens (with the
    encdec or vlm ``frontend``, whose memory the empty cache takes from
    the prefill)."""
    from repro_torch.models.model import memory_leaves
    pre, pre_cache = model.prefill({"tokens": tokens, **(frontend or {})})
    cache = model.init_cache(*tokens.shape)
    cache.update({k: pre_cache[k] for k in memory_leaves(model.cfg)})
    del pre_cache
    for t in range(tokens.shape[1]):
        step, cache = model.decode(cache, tokens[:, t], t)
    return _normed(step), _normed(pre)


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


# ---------------------------------------------------------------------------
# case (n): serving recurrentgemma-9b (the hybrid family) at its published
# config
# ---------------------------------------------------------------------------

# src/repro_torch/configs/recurrentgemma_9b.py (as src/repro/configs/): 38
# layers, 12 x (rec, rec, attn) + 2 rec, d_model 4096, 16 heads (MQA, kv 1,
# head_dim 256), d_ff 12288, vocab 256000, window 2048, rnn_width 4096, bf16.
# A prompt of 1984 tokens under the window: the prefill's ring of 1984 slots
# grows to 2048 and wraps at token 2048 while the wave decodes to 2111.
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_PROMPT, HYBRID_GEN = 1984, 128
# the card-vs-CPU and replay checks at full width, depth cut to one group
# plus the tail (the smoke config's layout): prefill 2016 tokens, grow the
# ring, decode teacher-forced to 2080, each checked step against the
# prefill of the same prefix (before the wrap, at it, after it, the last)
HYBRID_LAYERS, HYBRID_PARITY_SEQ = 5, 128
HYBRID_REPLAY_PROMPT, HYBRID_REPLAY_CHECKS = 2016, (2040, 2049, 2064, 2080)


def _replay_across_wrap(model, tokens) -> dict:
    """{prefix length: (normalised log-probs of teacher-forced decode, of
    the prefill of the same prefix)}: prefill ``HYBRID_REPLAY_PROMPT``
    tokens, grow the ring with ``pad_cache`` to the serving budget, then
    decode the rest of ``tokens``."""
    from repro_torch.launch.serve import pad_cache

    B, T = tokens.shape
    _, cache = model.prefill({"tokens": tokens[:, :HYBRID_REPLAY_PROMPT]})
    cache = pad_cache(cache, model.cache_specs(B, T), T, model.cfg.window)
    out = {}
    for t in range(HYBRID_REPLAY_PROMPT, T):
        step, cache = model.decode(cache, tokens[:, t], t)
        if t + 1 in HYBRID_REPLAY_CHECKS:
            pre, _ = model.prefill({"tokens": tokens[:, :t + 1]})
            out[t + 1] = (_normed(step), _normed(pre))
    return out


def phase_serve_hybrid(card: str) -> dict:
    """(n): ``repro_torch.launch.serve.serve`` at recurrentgemma-9b's
    published config, random weights from the seed, with the counts set to
    0 just before it and read just after: one ``recur1`` launch per RG-LRU
    layer a prefill (26) and none in decode.  Then one prefill (B 8, S 1984)
    timed with CUDA events and traced; at full width and 5 layers, the fp32
    prefill on the card against the CPU's plain run on the same weights
    (log-probs within 1e-3) and teacher-forced decode across the ring's
    wrap against the prefill of each checked prefix (fp32 within the JAX
    suite's 3e-2 bar, bf16 within REPLAY_NOISE times the bf16 prefill's own
    distance from the fp32 prefill).  One full-size model is held at a
    time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, build_model
    from repro_torch.models.params import tree_map

    cfg = get_config(HYBRID_ARCH)
    check((cfg.n_layers, cfg.block_pattern, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab, cfg.window,
           cfg.rnn_dim, cfg.dtype)
          == (38, ("rec", "rec", "attn"), 4096, 16, 1, 256, 12288, 256000,
              2048, 4096, "bfloat16"),
          f"(n) {HYBRID_ARCH} is not at its published config: {cfg}")
    groups, tail = divmod(cfg.n_layers, len(cfg.block_pattern))
    n_rec = groups * cfg.block_pattern.count("rec") + tail
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve(cfg, requests=SERVE_REQUESTS, batch=SERVE_BATCH,
                prompt_len=HYBRID_PROMPT, gen=HYBRID_GEN, device="cuda",
                seed=SEED, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    waves = out["waves"]
    check(launches == {"recur1": len(waves) * n_rec},
          f"(n) launches {launches}, expected {n_rec} recur1 a prefill over "
          f"{len(waves)} waves")
    cache = out["cache"]
    ring = (groups, SERVE_BATCH, cfg.n_kv_heads, cfg.window, cfg.hd)
    rings = [cache["groups"][k][kv] for k in cache["groups"] if "attn" in k
             for kv in ("k", "v")]
    states = [v["h"] for v in cache["groups"].values() if "h" in v]
    states.append(cache["tail"]["h"])
    check(out["served"] == SERVE_REQUESTS
          and all(tuple(r.shape) == ring for r in rings)
          and all(torch.isfinite(h).all().item() for h in states),
          f"(n) the ring caches are not {ring} or an RG-LRU state is not "
          "finite")
    del out, cache, rings, states
    row = {"phase": "serve", "case": "n", "arch": HYBRID_ARCH,
           "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
           "prompt": HYBRID_PROMPT, "gen": HYBRID_GEN, "ring": list(ring),
           "launches": launches, "recur1_per_prefill": n_rec,
           "prefill_ms": [w["prefill_s"] * 1e3 for w in waves],
           "decode_ms_per_token": [w["decode_s"] * 1e3 / w["decode_steps"]
                                   for w in waves],
           "tokens_per_s": SERVE_REQUESTS * HYBRID_GEN
           / sum(w["prefill_s"] + w["decode_s"] for w in waves),
           "serve_seconds": time.perf_counter() - t0,
           "peak_device_bytes": peak}

    # one prefill of a wave's shape: CUDA events, then a profiler trace
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, HYBRID_PROMPT),
                           generator=gen, device="cuda")
    times = event_times(lambda: model.prefill({"tokens": tokens}), reps=5,
                        warmup=1)
    q1, _, q3 = statistics.quantiles(times, n=4)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
    kernels_ms, recur_ms = _device_kernel_ms(prof)
    top = sorted(_device_kernels(prof).items(), key=lambda kv: -kv[1])[:8]
    row.update({"prefill_event_ms": statistics.median(times),
                "trace_top_kernels_ms": [[name[:80], ms] for name, ms in top],
                "prefill_event_ms_q1": q1, "prefill_event_ms_q3": q3,
                "prefill_event_reps": len(times),
                "trace_kernels_ms": kernels_ms,
                "trace_recurrence_ms": recur_ms,
                "trace_recurrence_share": (recur_ms / kernels_ms
                                           if kernels_ms else None)})
    del model, tokens, prof
    torch.cuda.empty_cache()

    # full width, 5 layers: the bf16 model and its fp32 twin on the card,
    # the twin's weights also on the CPU
    cut = dataclasses.replace(cfg, n_layers=HYBRID_LAYERS)
    cut32 = dataclasses.replace(cut, dtype="float32")
    model = build_model(cut, device="cuda", seed=SEED + 6)
    model32 = Model(cut32, device="cuda",
                    params=tree_map(lambda t: t.float(), model.params.tree()))
    cpu = Model(cut32, device="cpu",
                params=tree_map(lambda t: t.cpu(), model32.params.tree()))
    toks = torch.randint(0, cfg.vocab, (PARITY_BATCH, HYBRID_PARITY_SEQ),
                         generator=torch.Generator().manual_seed(SEED + 5))
    ops.reset_launches()
    got, _ = model32.prefill({"tokens": toks.cuda()})
    torch.cuda.synchronize()
    groups, tail = divmod(HYBRID_LAYERS, len(cut.block_pattern))
    check(ops.LAUNCHES == {"recur1": groups * cut.block_pattern.count("rec")
                           + tail},
          f"(n) fp32 prefill launches {ops.LAUNCHES}")
    want, _ = cpu.prefill({"tokens": toks})
    del cpu
    lp_err = (torch.log_softmax(got, -1).cpu()
              - torch.log_softmax(want, -1)).abs().max().item()
    check(lp_err <= PARITY_TOL,
          f"(n) fp32 prefill log-probs, card vs CPU, max|Δ| {lp_err:.3e}")

    # teacher-forced decode across the ring's wrap against prefill
    toks = torch.randint(0, cfg.vocab, (REPLAY_BATCH, HYBRID_REPLAY_CHECKS[-1]),
                         generator=gen, device="cuda")
    r16 = _replay_across_wrap(model, toks)
    r32 = _replay_across_wrap(model32, toks)
    del model, model32
    torch.cuda.empty_cache()
    steps = []
    for n in HYBRID_REPLAY_CHECKS:
        (a16, b16), (a32, b32) = r16[n], r32[n]
        step = {"prefix": n,
                "fp32_replay_max_abs_err": (a32 - b32).abs().max().item(),
                "fp32_replay_worst_of_bar": _allclose(
                    a32, b32, rtol=REPLAY_TOL, atol=10 * REPLAY_TOL),
                "bf16_replay_max_abs_err": (a16 - b16).abs().max().item(),
                "bf16_decode_from_fp32_prefill": (a16 - b32).abs().max()
                .item(),
                "bf16_prefill_from_fp32_prefill": (b16 - b32).abs().max()
                .item()}
        check(step["fp32_replay_worst_of_bar"] <= 1.0,
              f"(n) fp32 decode replay vs prefill at {n} tokens: "
              f"{step['fp32_replay_worst_of_bar']:.3f} of the bar")
        check(torch.isfinite(a16).all().item()
              and step["bf16_decode_from_fp32_prefill"]
              <= REPLAY_NOISE * step["bf16_prefill_from_fp32_prefill"],
              f"(n) bf16 decode at {n} tokens "
              f"{step['bf16_decode_from_fp32_prefill']:.3e} from the fp32 "
              f"prefill, the bf16 prefill "
              f"{step['bf16_prefill_from_fp32_prefill']:.3e}")
        steps.append(step)
    row.update({"fp32_logprob_max_abs_err": lp_err, "replay": steps,
                "seconds": time.perf_counter() - t0})
    emit(row)
    return row


# ---------------------------------------------------------------------------
# cases (s)-(w): serving the attention families: dense (granite-3-8b), moe
# (dbrx-132b, kimi-k2-1t-a32b), encdec (seamless-m4t-large-v2) and vlm
# (llama-3.2-vision-90b)
# ---------------------------------------------------------------------------

# Each case: (arch, the published widths its config must have, layers kept
# (None: the published depth; the encdec family's encoder and decoder
# each), requests, batch, prompt, generated, layers of the fp32 card-vs-CPU
# prefill (None: no such check) and its prompt length, whether that check
# also runs both sides at fp64 (its bar then follows fp32's own rounding),
# layers of the decode replay (None: no replay), prefill timings, the
# value every cross gate is set to after the init (None: no gates), and
# whether the checks' weights draw the attention projections by the fan-in
# rule over d_model (``_soften_attention``)).
# The replay keeps 2 layers: these random weights (JAX's init rule) put the
# attention logits in the hundreds, so the softmax is nearly hard and each
# layer multiplies a rounding difference about a hundredfold; past a few
# layers decode and prefill part whatever the precision (granite-3-8b at
# 40 layers: 10.4 times the bar at fp64, 16.9 at fp32).  The widths are
# src/repro_torch/configs/*.py's, the same as src/repro/configs/.
# granite-3-8b: 40 layers, d_model 4096, 32 heads (GQA kv 8, head_dim 128),
# d_ff 12800, vocab 49155, rope θ 1e4; 8.4 G parameters, 16.7 GB at bf16.
# dbrx-132b: 16 experts top-4, expert_d_ff 10752, d_model 6144, 48 heads
# (kv 8), vocab 100352; one layer's experts 6.3 GB at bf16, so the depth is
# cut to 4 (28.6 GB).  kimi-k2-1t-a32b: 384 experts top-8 and a shared
# expert, expert_d_ff 2048, d_model 7168, 64 heads (kv 8, head_dim 112),
# vocab 163840; one layer's experts 33.8 GB at bf16, so one layer; its fp32
# copy (over 68 GB on each side) does not fit, so its parity is held on the
# CPU at the smoke config (tests/test_torch_moe.py) and not here.
DENSE_MOE_CASES = {
    "s": dict(arch="granite-3-8b",
              widths=dict(n_layers=40, d_model=4096, n_heads=32,
                          n_kv_heads=8, hd=128, d_ff=12800, vocab=49155,
                          rope_theta=1e4, dtype="bfloat16"),
              layers=None, requests=16, batch=8, prompt=1024, gen=64,
              parity_layers=2, parity_seq=128, oracle=True, replay_layers=2,
              reps=5, gates=None, soft=False),
    "t": dict(arch="dbrx-132b",
              widths=dict(d_model=6144, n_heads=48, n_kv_heads=8, hd=128,
                          n_experts=16, top_k=4, expert_d_ff=10752,
                          shared_expert=False, vocab=100352,
                          capacity_factor=1.25, dtype="bfloat16"),
              layers=4, requests=8, batch=8, prompt=1024, gen=32,
              parity_layers=1, parity_seq=128, oracle=False, replay_layers=2,
              reps=3, gates=None, soft=False),
    "u": dict(arch="kimi-k2-1t-a32b",
              widths=dict(d_model=7168, n_heads=64, n_kv_heads=8, hd=112,
                          n_experts=384, top_k=8, expert_d_ff=2048,
                          shared_expert=True, vocab=163840,
                          capacity_factor=1.25, dtype="bfloat16"),
              layers=1, requests=8, batch=8, prompt=1024, gen=16,
              parity_layers=None, parity_seq=None, oracle=False,
              replay_layers=None, reps=3, gates=None, soft=False),
}
# seamless-m4t-large-v2, at its published config: 24 encoder and 24
# decoder layers, d_model 1024, 16 heads (MHA, head_dim 64), d_ff 8192,
# vocab 256206, 1536 audio frames (the frontend stub), rope θ 1e4; 2.04 G
# parameters (0.52 G of embed and unembed, 29.4 M an encoder layer, 33.6 M
# a decoder layer), 4.1 GB at bf16.  A wave's cross memory is 2 × 604 MB,
# never padded (max_len 256 < 1536).  The checks cut both stacks to 2.
# llama-3.2-vision-90b: d_model 8192, 64 heads (GQA kv 8, head_dim 128),
# d_ff 28672, vocab 128256, a gated cross block every 5th layer over 2048
# image tokens of width 7680 (the frontend stub); 0.856 G a block, so the
# depth is cut from 100 to 10: two groups of 4 self blocks and a cross
# block, 10.7 G parameters, 21.4 GB at bf16 (the whole model, 175 GB, fits
# no card).  The checks keep one group (5 layers).  The cross gates are
# zeros at init and tanh(0) = 0 removes the cross block, so every gate is
# set to 1.0 after the init: the serve, the timings and the checks reach
# the cross-attention.  Their checks soften the attention: with JAX's init
# the fp32 log-probs of either model move 0.01-0.92 from fp64 by rounding
# alone, differently for each sequence (PERF.md §6), so no bar
# holds them, and a near-hard softmax would not see a wrong key's weight.
CROSS_CASES = {
    "v": dict(arch="seamless-m4t-large-v2",
              widths=dict(enc_layers=24, dec_layers=24, d_model=1024,
                          n_heads=16, n_kv_heads=16, hd=64, d_ff=8192,
                          vocab=256206, n_frames=1536, rope_theta=1e4,
                          dtype="bfloat16"),
              layers=None, requests=16, batch=8, prompt=128, gen=128,
              parity_layers=2, parity_seq=64, oracle=True, replay_layers=2,
              reps=5, gates=None, soft=True),
    "w": dict(arch="llama-3.2-vision-90b",
              widths=dict(n_layers=100, d_model=8192, n_heads=64,
                          n_kv_heads=8, hd=128, d_ff=28672, vocab=128256,
                          cross_attn_every=5, vision_dim=7680,
                          n_img_tokens=2048, dtype="bfloat16"),
              layers=10, requests=8, batch=8, prompt=1024, gen=32,
              parity_layers=5, parity_seq=128, oracle=True, replay_layers=5,
              reps=3, gates=1.0, soft=True),
}
SERVE_CASES = {**DENSE_MOE_CASES, **CROSS_CASES}
# the card-vs-CPU prefill's batch; the JAX suite's replay bars
# (tests/test_decode_equivalence.py): dense 2e-2, moe 5e-2, encdec and vlm
# 3e-2
DENSE_PARITY_BATCH = 2
REPLAY_BARS = {"dense": 2e-2, "moe": 5e-2, "encdec": 3e-2, "vlm": 3e-2}


def _with_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers: the encdec family's encoder and
    decoder each, the others' stack (the vlm family's whole groups)."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, enc_layers=layers, dec_layers=layers,
                                   n_layers=2 * layers)
    return dataclasses.replace(cfg, n_layers=layers)


def _set_gates(model, value) -> None:
    """Every cross block's ``gate_attn`` and ``gate_mlp`` of ``model`` set
    to ``value``, in place."""
    import torch
    with torch.no_grad():
        for name, p in model.params.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gate_attn", "gate_mlp"):
                p.fill_(value)


def _soften_attention(model) -> None:
    """Every attention ``wq`` and ``wk`` of ``model`` (shape (..., D, H,
    hd)) rescaled in place from JAX's fan-in rule over ``shape[-2]``
    (std 1/√H) to the rule over its input width D (std 1/√D).  The
    attention logits then sit near 1, as a trained model's do, not in the
    hundreds, where the softmax is nearly hard and each layer multiplies a
    rounding difference about 30-fold."""
    import torch
    with torch.no_grad():
        for name, p in model.params.named_parameters():
            if name.rsplit(".", 1)[-1] in ("wq", "wk"):
                p.mul_(math.sqrt(p.shape[-2] / p.shape[-3]))


def _frontend(cfg, batch: int, device, gen) -> dict:
    """The encdec or vlm frontend of a batch, normals × 0.1 drawn from
    ``gen`` (on its device) and rounded to bf16, as the JAX suite's
    tests/test_decode_equivalence.py draws them; {} for the others."""
    import torch
    if cfg.family == "encdec":
        key, shape = "frames", (batch, cfg.n_frames, cfg.d_model)
    elif cfg.family == "vlm":
        key, shape = "img_embed", (batch, cfg.n_img_tokens, cfg.vision_dim)
    else:
        return {}
    x = torch.randn(shape, generator=gen, device=gen.device) * 0.1
    return {key: x.to(device, torch.bfloat16)}


def _fp64_prefill(model, batch):
    """``model``'s prefill logits with its parameters carried at fp64: the
    layers then compute in fp64 throughout (``models.layers._acc``).  Each
    parameter becomes its fp64 copy in place, so the model is left at fp64
    and its fp32 leaves are freed one by one."""
    import torch
    with torch.no_grad():
        for p in model.params.parameters():
            p.data = p.data.double()
    return model.prefill(batch)[0]


def _free_device() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_attention(key: str, card: str) -> dict:
    """(s)-(w): ``repro_torch.launch.serve.serve`` at the case's published
    widths (depth cut where ``layers`` says), random weights from the seed
    (the cross gates then set to ``gates``), with the counts set to 0 just
    before it and read just after: these families reach no solver kernel,
    so no launch and no plain fallback.  Every cache leaf's shape
    (``cache_specs`` at the serving budget: the self-attention caches
    grown to it, a frontend's memory at the frontend's length) and finite
    values are checked.  Then one prefill of a wave's shape (the frontend
    seeded normals × 0.1) timed with CUDA events (its logits finite) and
    traced with ``torch.profiler`` (the top device ops); the fp32 prefill
    on the card against the CPU's on the same weights and inputs, at full
    width and ``parity_layers`` (log-probs within 1e-3; with the
    ``oracle``, within twice the CPU's own fp32 distance from its fp64
    run, and the two fp64 runs within 1e-9); and teacher-forced decode
    over a 64-token prompt against the prefill, at full width and
    ``replay_layers`` (the memory the prefill's; the moe family at
    capacity ``n_experts``, as the JAX test sets it, since at 1.25 prefill
    and decode drop different tokens): fp32 within the JAX suite's bar,
    bf16 within REPLAY_NOISE times the bf16 prefill's own distance from
    the fp32 prefill.  With ``soft``, the checks' attention projections
    are redrawn to the fan-in rule over d_model (``_soften_attention``).
    Each model is freed before the next is built."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, build_model
    from repro_torch.models.model import cache_specs, memory_leaves
    from repro_torch.models.params import tree_map

    case = SERVE_CASES[key]
    cfg = get_config(case["arch"])
    got = {name: getattr(cfg, name) for name in case["widths"]}
    check(got == case["widths"],
          f"({key}) {case['arch']} is not at its published widths: {got}")
    published = (cfg.enc_layers if cfg.family == "encdec" else cfg.n_layers)
    if case["layers"]:
        cfg = _with_depth(cfg, case["layers"])
    gates = case["gates"]
    t0 = time.perf_counter()
    _free_device()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=SEED)
    if gates is not None:
        _set_gates(model, gates)
    ops.reset_launches()
    out = serve(cfg, requests=case["requests"], batch=case["batch"],
                prompt_len=case["prompt"], gen=case["gen"], seed=SEED,
                log=lambda line: print(line, flush=True), model=model)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches == {}, f"({key}) launches {launches}: the {cfg.family} "
                          f"family reaches no solver kernel")
    waves = out["waves"]
    shapes = {name: spec.shape for name, spec in cache_specs(
        cfg, case["batch"], case["prompt"] + case["gen"]).items()}
    cache = out["cache"]
    check(out["served"] == case["requests"]
          and {name: tuple(t.shape) for name, t in cache.items()} == shapes
          and all(torch.isfinite(t).all().item() for t in cache.values()),
          f"({key}) the caches are not finite of shapes {shapes}")
    del out, cache
    memory = memory_leaves(cfg)
    row = {"phase": "serve", "case": key, "arch": case["arch"],
           "family": cfg.family, "card": card,
           "reduced": ({"n_layers": [published, case["layers"]]}
                       if case["layers"] else None),
           "requests": case["requests"], "batch": case["batch"],
           "prompt": case["prompt"], "gen": case["gen"],
           "capacity_factor": cfg.capacity_factor if cfg.n_experts else None,
           "cross_gates": gates,
           "launches": launches, "cache_shape": list(shapes["k"]),
           "memory_shape": list(shapes[memory[0]]) if memory else None,
           "prefill_ms": [w["prefill_s"] * 1e3 for w in waves],
           "decode_ms_per_token": [w["decode_s"] * 1e3 / w["decode_steps"]
                                   for w in waves],
           "tokens_per_s": case["requests"] * case["gen"]
           / sum(w["prefill_s"] + w["decode_s"] for w in waves),
           "serve_seconds": time.perf_counter() - t0,
           "peak_device_bytes": peak}

    # one prefill of a wave's shape: CUDA events, then a profiler trace
    _free_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    tokens = torch.randint(0, cfg.vocab, (case["batch"], case["prompt"]),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens,
             **_frontend(cfg, case["batch"], "cuda", gen)}
    ops.reset_launches()
    logits, _ = model.prefill(batch)
    check(ops.LAUNCHES == {} and torch.isfinite(logits).all().item()
          and tuple(logits.shape) == (case["batch"], cfg.vocab),
          f"({key}) prefill logits not finite of shape (B, V), or launches "
          f"{ops.LAUNCHES}")
    del logits
    times = event_times(lambda: model.prefill(batch), reps=case["reps"],
                        warmup=1)
    q1, _, q3 = statistics.quantiles(times, n=4)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(batch)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    top = sorted(_device_ops(prof).items(), key=lambda kv: -kv[1])[:8]
    row.update({"prefill_event_ms": statistics.median(times),
                "prefill_event_ms_q1": q1, "prefill_event_ms_q3": q3,
                "prefill_event_reps": len(times),
                "trace_kernels_ms": sum(kernels.values()),
                "trace_top_ops_ms": [[name[:80], ms] for name, ms in top]})
    del model, tokens, batch, prof
    _free_device()

    if case["parity_layers"]:
        # fp32 at full width: the card against the CPU on the same weights
        cut32 = dataclasses.replace(_with_depth(cfg, case["parity_layers"]),
                                    dtype="float32")
        card32 = build_model(cut32, device="cuda", seed=SEED + 5)
        if gates is not None:
            _set_gates(card32, gates)
        if case["soft"]:
            _soften_attention(card32)
        cpu = Model(cut32, device="cpu",
                    params=tree_map(lambda t: t.cpu(),
                                    card32.params.tree()))
        cpu_gen = torch.Generator().manual_seed(SEED + 5)
        toks = torch.randint(0, cfg.vocab,
                             (DENSE_PARITY_BATCH, case["parity_seq"]),
                             generator=cpu_gen)
        cpu_batch = {"tokens": toks,
                     **_frontend(cfg, DENSE_PARITY_BATCH, "cpu", cpu_gen)}
        card_batch = {k: v.cuda() for k, v in cpu_batch.items()}
        ops.reset_launches()
        got = {"fp32": card32.prefill(card_batch)[0]}
        if case["oracle"]:
            got["fp64"] = _fp64_prefill(card32, card_batch)
        torch.cuda.synchronize()
        check(ops.LAUNCHES == {}, f"({key}) fp32 prefill launches "
                                  f"{ops.LAUNCHES}")
        del card32, card_batch
        _free_device()
        want = {"fp32": cpu.prefill(cpu_batch)[0]}
        if case["oracle"]:
            want["fp64"] = _fp64_prefill(cpu, cpu_batch)
        del cpu
        lp = {k: torch.log_softmax(v.double(), -1).cpu()
              for k, v in [("card_" + k, v) for k, v in got.items()]
              + [("cpu_" + k, v) for k, v in want.items()]}
        lp_err = (lp["card_fp32"] - lp["cpu_fp32"]).abs().max().item()
        bar = PARITY_TOL
        row.update({"checks_soft_attention": case["soft"],
                    "parity_layers": case["parity_layers"],
                    "parity_shape": [DENSE_PARITY_BATCH, case["parity_seq"]],
                    "fp32_logprob_max_abs_err": lp_err})
        if case["oracle"]:
            # fp32 rounding alone moves these log-probs about 1e-3 (the
            # attention logits of the random weights reach the hundreds,
            # so the softmax is nearly hard): the card's fp32 is held to
            # twice the CPU's own fp32 distance from its fp64 run, and the
            # two fp64 runs, the same function at fp64, to 1e-9
            fp64_err = (lp["card_fp64"] - lp["cpu_fp64"]).abs().max().item()
            noise = (lp["cpu_fp32"] - lp["cpu_fp64"]).abs().max().item()
            check(fp64_err <= 1e-9,
                  f"({key}) fp64 prefill log-probs, card vs CPU, max|Δ| "
                  f"{fp64_err:.3e}")
            bar = max(PARITY_TOL, 2 * noise)
            row.update({"fp64_logprob_max_abs_err": fp64_err,
                        "cpu_fp32_from_fp64": noise,
                        "card_fp32_from_fp64": (lp["card_fp32"]
                                                - lp["cpu_fp64"]).abs().max()
                        .item()})
        row["fp32_logprob_bar"] = bar
        check(lp_err <= bar,
              f"({key}) fp32 prefill log-probs, card vs CPU, max|Δ| "
              f"{lp_err:.3e} > {bar:.3e}")
    else:
        row["parity"] = ("none on the card: an fp32 copy of one layer "
                         "needs over 68 GB on each side; held on the CPU "
                         "at the smoke config (tests/test_torch_moe.py)")

    if case["replay_layers"]:
        # teacher-forced decode against prefill, bf16 and its fp32 twin
        rcfg = _with_depth(cfg, case["replay_layers"])
        if rcfg.n_experts:
            rcfg = dataclasses.replace(
                rcfg, capacity_factor=float(rcfg.n_experts))
        model = build_model(rcfg, device="cuda", seed=SEED + 6)
        if gates is not None:
            _set_gates(model, gates)
        if case["soft"]:
            _soften_attention(model)
        model32 = Model(dataclasses.replace(rcfg, dtype="float32"),
                        device="cuda",
                        params=tree_map(lambda t: t.float(),
                                        model.params.tree()))
        toks = torch.randint(0, cfg.vocab, (REPLAY_BATCH, REPLAY_SEQ),
                             generator=gen, device="cuda")
        front = _frontend(cfg, REPLAY_BATCH, "cuda", gen)
        ops.reset_launches()
        a16, b16 = _replay(model, toks, front)
        a32, b32 = _replay(model32, toks, front)
        check(ops.LAUNCHES == {}, f"({key}) replay launches {ops.LAUNCHES}")
        del model, model32, front
        _free_device()
        bar = REPLAY_BARS[cfg.family]
        fp32_replay = _allclose(a32, b32, rtol=bar, atol=10 * bar)
        bf16_from_fp32 = (a16 - b32).abs().max().item()
        bf16_noise = (b16 - b32).abs().max().item()
        check(fp32_replay <= 1.0,
              f"({key}) fp32 decode replay vs prefill {fp32_replay:.3f} of "
              f"the bar")
        check(torch.isfinite(a16).all().item()
              and bf16_from_fp32 <= REPLAY_NOISE * bf16_noise,
              f"({key}) bf16 decode {bf16_from_fp32:.3e} from the fp32 "
              f"prefill, the bf16 prefill {bf16_noise:.3e}")
        row.update({"replay_layers": case["replay_layers"],
                    "replay_capacity_factor": (rcfg.capacity_factor
                                               if rcfg.n_experts else None),
                    "replay_bar": bar,
                    "fp32_replay_max_abs_err": (a32 - b32).abs().max()
                    .item(),
                    "fp32_replay_worst_of_bar": fp32_replay,
                    "bf16_replay_max_abs_err": (a16 - b16).abs().max()
                    .item(),
                    "bf16_decode_from_fp32_prefill": bf16_from_fp32,
                    "bf16_prefill_from_fp32_prefill": bf16_noise})
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


# ---------------------------------------------------------------------------
# cases (p), (p'), (q): training
# ---------------------------------------------------------------------------

# (p): mamba2-130m at its published config through launch.train.train, at
# the train_4k sequence length (src/repro/configs/__init__.py) and a
# micro-batch of 8; the SSD scan then runs at (g)'s operand, N 64 chunks x
# M 8 * 24 heads * 64 * 128
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_RESUME_STEPS = 8, 4096, 20, 22
TRAIN_LR, TRAIN_WARMUP, TRAIN_CKPT_EVERY = 3e-3, 5, 10
# (p'): fp32 at full width, depth cut to 2 layers, card against CPU
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 2, 256
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
# (q): recurrentgemma-9b at full width, one (rec, rec, attn) group plus the
# 2-layer tail, bf16, remat on, B 1 x S 2048: its RG-LRU scans run at
# N 2048 x M 4096 on the tile route
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_SEQ = 5, 2048


def _same_bits(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.cpu(), b.cpu())


def _grads(cfg, params, batch) -> tuple:
    """(loss, gradients in sorted-leaf order) of ``loss_fn`` on a copy of
    ``params`` whose leaves require grad."""
    import torch
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.sharding import ShardingCtx

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, leaves), batch,
                      ShardingCtx.local(), cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def phase_train(card: str) -> dict:
    """(p): ``repro_torch.launch.train.train`` at mamba2-130m's published
    config (remat on, random weights from the seed) for 20 steps, with the
    counts set to 0 just before it and read just after: per step one
    ``recur1`` and one remat recompute per layer and one ``recur1_rev``
    (the adjoint), nothing else.  Finite losses whose last five average
    below the first five; the committed checkpoint of step 19 restores
    bitwise onto the returned parameters and moments; a second call to 22
    steps on the same directory resumes at step 20.  Then one step timed
    with CUDA events and one traced.  (p'): at full width, 2 layers, fp32,
    ``loss_fn`` and its gradients on the card against the CPU's plain run
    on the same weights and batch (TF32 off).  (q): recurrentgemma-9b at
    full width, 5 layers, one ``loss_fn`` and backward, finite, with 8
    ``recur1`` and 4 ``recur1_rev`` launches; no optimizer step (the
    full-depth step needs more than one card)."""
    import shutil

    import torch
    from repro_torch.ckpt import latest_step, restore
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_optimizer, train
    from repro_torch.models import Model, build_model
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.sharding import ShardingCtx
    from repro_torch.train import make_train_step

    cfg = get_config(SERVE_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.dtype, cfg.remat)
          == (24, 768, 50280, "bfloat16", True),
          f"(p) {SERVE_ARCH} is not at its published config: {cfg}")
    ckpt_dir = ROOT / "build" / "train_p"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
              warmup=TRAIN_WARMUP, ckpt_dir=str(ckpt_dir),
              ckpt_every=TRAIN_CKPT_EVERY, log_every=5, device="cuda",
              seed=SEED, log=lambda line: print(line, flush=True))
    L = cfg.n_layers
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = train(cfg, steps=TRAIN_STEPS, **kw)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"recur1": 2 * L * TRAIN_STEPS, "recur1_rev": L * TRAIN_STEPS}
    check(launches == want, f"(p) launches {launches}, expected {want}")
    losses = out["losses"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"(p) losses not finite: {losses}")
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    check(last < first, f"(p) loss did not descend: {losses}")
    check(latest_step(str(ckpt_dir)) == TRAIN_STEPS - 1,
          f"(p) latest committed step {latest_step(str(ckpt_dir))}")
    saved, step = restore(str(ckpt_dir), TRAIN_STEPS - 1)
    ours = {"params": out["params"], "opt": out["opt_state"]}
    check(step == TRAIN_STEPS - 1
          and len(tree_leaves(saved)) == len(tree_leaves(ours))
          and all(_same_bits(a, b) for a, b in zip(tree_leaves(saved),
                                                   tree_leaves(ours))),
          "(p) the checkpoint of the last step does not restore bitwise")
    del saved
    ops.reset_launches()
    again = train(cfg, steps=TRAIN_RESUME_STEPS, **kw)
    torch.cuda.synchronize()
    extra = TRAIN_RESUME_STEPS - TRAIN_STEPS
    check(again["start"] == TRAIN_STEPS and len(again["losses"]) == extra
          and ops.LAUNCHES == {"recur1": 2 * L * extra,
                               "recur1_rev": L * extra},
          f"(p) resume started at {again['start']} with launches "
          f"{ops.LAUNCHES}")
    del again
    step_ms = statistics.median(out["step_s"]) * 1e3
    row = {"phase": "train", "case": "p", "arch": SERVE_ARCH,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "lr": TRAIN_LR, "warmup": TRAIN_WARMUP, "remat": cfg.remat,
           "launches": launches, "losses": losses,
           "first5_mean": first, "last5_mean": last,
           "resumed_at": TRAIN_STEPS,
           "step_ms": [t * 1e3 for t in out["step_s"]],
           "median_step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
           "peak_device_bytes": peak, "train_seconds": time.perf_counter() - t0}

    # one step of the same state: CUDA events, then a profiler trace
    model = build_model(cfg, device="cuda", seed=SEED)
    step_fn = make_train_step(model, ShardingCtx.local(), make_optimizer(
        cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS))
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, seed=SEED).batch_at(
        TRAIN_STEPS, device="cuda")
    params, state = out["params"], out["opt_state"]
    del out, model

    def one_step():
        return step_fn(params, state, batch, TRAIN_STEPS)

    times = event_times(one_step, reps=5, warmup=1)
    q1, _, q3 = statistics.quantiles(times, n=4)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    kernels_ms, recur_ms = _device_kernel_ms(prof)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    top_ops = sorted(_device_ops(prof).items(), key=lambda kv: -kv[1])[:15]
    row.update({"step_event_ms": statistics.median(times),
                "trace_top_ops_ms": [[name, ms] for name, ms in top_ops],
                "step_event_ms_q1": q1, "step_event_ms_q3": q3,
                "step_event_reps": len(times),
                "trace_top_kernels_ms": [[name[:80], ms] for name, ms in top],
                "trace_kernels_ms": kernels_ms,
                "trace_recurrence_ms": recur_ms,
                "trace_recurrence_share": (recur_ms / kernels_ms
                                           if kernels_ms else None)})
    del params, state, batch, prof
    torch.cuda.empty_cache()

    # (p'): fp32 at full width, 2 layers, card against CPU
    cut32 = dataclasses.replace(cfg, n_layers=TRAIN_PARITY_LAYERS,
                                dtype="float32")
    cpu = Model(cut32, device="cpu", seed=SEED + 11)
    params = {"cpu": cpu.params.tree()}
    params["card"] = tree_map(lambda t: t.cuda(), params["cpu"])
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_PARITY_SEQ,
                       global_batch=TRAIN_PARITY_BATCH, seed=SEED + 11
                       ).batch_at(0, device="cpu")
    ops.reset_launches()
    card_loss, card_grads = _grads(cut32, params["card"],
                                   {k: v.cuda() for k, v in data.items()})
    torch.cuda.synchronize()
    check(ops.LAUNCHES == {"recur1": 2 * TRAIN_PARITY_LAYERS,
                           "recur1_rev": TRAIN_PARITY_LAYERS},
          f"(p') launches {ops.LAUNCHES}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "(p') TF32 is on for fp32 matmuls")
    cpu_loss, cpu_grads = _grads(cut32, params["cpu"], data)
    loss_err = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    grad_errs = [((g.cpu() - w).abs().max() / w.abs().max()).item()
                 for g, w in zip(card_grads, cpu_grads)]
    check(loss_err <= TRAIN_LOSS_TOL,
          f"(p') fp32 loss, card vs CPU, relative {loss_err:.3e}")
    check(max(grad_errs) <= TRAIN_GRAD_TOL,
          f"(p') fp32 gradients, card vs CPU, worst leaf "
          f"{max(grad_errs):.3e} of its max")
    row.update({"parity_layers": TRAIN_PARITY_LAYERS,
                "parity_batch": TRAIN_PARITY_BATCH,
                "parity_seq": TRAIN_PARITY_SEQ,
                "fp32_loss_rel_err": loss_err,
                "fp32_grad_worst_leaf_rel_err": max(grad_errs)})
    del cpu, params, card_grads, cpu_grads
    torch.cuda.empty_cache()

    # (q): the hybrid trunk under autograd at full width
    hcfg = dataclasses.replace(get_config(HYBRID_ARCH),
                               n_layers=HYBRID_TRAIN_LAYERS)
    groups, tail = divmod(hcfg.n_layers, len(hcfg.block_pattern))
    n_rec = groups * hcfg.block_pattern.count("rec") + tail
    check((hcfg.d_model, hcfg.rnn_dim, hcfg.vocab, hcfg.window, hcfg.dtype,
           hcfg.remat, n_rec) == (4096, 4096, 256000, 2048, "bfloat16", True,
                                  4),
          f"(q) {HYBRID_ARCH} cut is not at full width: {hcfg}")
    check((HYBRID_TRAIN_SEQ, RGLRU_WIDTH) in recur_shapes(),
          "(q) phase 3 does not hold the kernel at the RG-LRU operand")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(hcfg, device="cuda", seed=SEED + 12)
    hbatch = SyntheticLM(vocab=hcfg.vocab, seq_len=HYBRID_TRAIN_SEQ,
                         global_batch=1, seed=SEED + 12).batch_at(
        0, device="cuda")
    ops.reset_launches()
    t1 = time.perf_counter()
    loss, grads = _grads(hcfg, model.params.tree(), hbatch)
    torch.cuda.synchronize()
    hybrid_s = time.perf_counter() - t1
    check(ops.LAUNCHES == {"recur1": 2 * n_rec, "recur1_rev": n_rec},
          f"(q) launches {ops.LAUNCHES}")
    check(math.isfinite(loss.item())
          and all(torch.isfinite(g).all().item() for g in grads),
          "(q) the hybrid loss or a gradient is not finite")
    row.update({"hybrid_layers": HYBRID_TRAIN_LAYERS,
                "hybrid_seq": HYBRID_TRAIN_SEQ,
                "hybrid_launches": dict(ops.LAUNCHES),
                "hybrid_loss": loss.item(),
                "hybrid_fwd_bwd_s": hybrid_s,
                "hybrid_peak_device_bytes": torch.cuda.max_memory_allocated(),
                "seconds": time.perf_counter() - t0})
    del model, grads
    torch.cuda.empty_cache()
    emit(row)
    return row


def train_recurrence_rows(trained: dict, card: str, ptxas: dict) -> list:
    """The recurrence kernel at (p)'s operand (N 64 x M 1,572,864), forward
    (``recur1``) and adjoint (``recur1_rev``), and at (q)'s (N 2048 x
    M 4096), each on its routes in turns against the plain version, with
    the training runs' launches; (p)'s rows also give the kernel's share of
    a step: its launches a step times its time over the step's CUDA-event
    time."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    per_step = {"recur1": 2 * 24, "recur1_rev": 24}
    rows = []
    for key in ("p", "p_rev", "q", "q_rev"):
        name = "recur1_rev" if key.endswith("_rev") else "recur1"
        launches = (trained["launches"][name] if key.startswith("p")
                    else trained["hybrid_launches"][name])
        row = recurrence_times(key, launches, card, gen, ptxas)
        if key.startswith("p"):
            row.update({"launches_per_step": per_step[name],
                        "step_event_ms": trained["step_event_ms"],
                        "share_of_step": per_step[name] * row["ms"]
                        / trained["step_event_ms"],
                        "trace_recurrence_share":
                            trained["trace_recurrence_share"]})
        emit({"phase": "times", **row})
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _bound(nbytes: float, ops_count: float, card: str) -> tuple:
    """(bound_ms, bound_by): bytes over the memory rate against fp32
    operations over the card's non-tensor-core rate."""
    rates = card_rates(card)
    bytes_ms = nbytes / rates.hbm_bytes_s * 1e3
    ops_ms = ops_count / rates.fp32_flops * 1e3
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
    rates = card_rates(card)
    nbytes = spec.traffic_bytes(n, m, storage)
    bound_ms = max(nbytes / rates.hbm_bytes_s, ops_per_row(spec) * n * m
                   / rates.flops("float64" if storage == torch.float64
                                 else "float32")) * 1e3
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
                     SERVE_BATCH * SSD_HEADS * SSD_HEAD_DIM * SSD_STATE),
               "n": (1, False, HYBRID_PROMPT, SERVE_BATCH * RGLRU_WIDTH),
               "o": (1, False, HYBRID_PROMPT, RGLRU_WIDTH),
               "p": (1, False, SEQ // SSD_CHUNK,
                     SSD_BATCH * SSD_HEADS * SSD_HEAD_DIM * SSD_STATE),
               "p_rev": (1, True, SEQ // SSD_CHUNK,
                         SSD_BATCH * SSD_HEADS * SSD_HEAD_DIM * SSD_STATE),
               "q": (1, False, HYBRID_TRAIN_SEQ, RGLRU_WIDTH),
               "q_rev": (1, True, HYBRID_TRAIN_SEQ, RGLRU_WIDTH)}


def recurrence_ptxas(ptxas: dict, order: int) -> dict:
    """The ptxas report of the recurrence kernel's fp32 kernels of one
    order: the walk (``recurrence_kernel<f,f,order,reverse>``) and the tile
    (``recurrence_tile_kernel<f,f,order,reverse>``)."""
    return {k: v for k, v in ptxas.items()
            if k.startswith("recurrence_") and f"<f,f,{order}," in k}


def route_verdict(stats: dict, picked: str, other: str) -> dict:
    """The picked route against the other in the same turns: the margin
    (other / picked − 1), the noise of the turns (the relative distance
    between the two identical walk launches, ``walk`` and ``walk_again``)
    and the verdict: ``"picked faster"`` or ``"other faster"`` where the
    quartiles part and the margin passes the noise, else ``"tie"``."""
    mine, theirs = stats[picked], stats[other]
    walks = (stats["walk"]["ms"], stats["walk_again"]["ms"])
    noise = abs(walks[0] - walks[1]) / min(walks)
    margin = theirs["ms"] / mine["ms"] - 1
    verdict = "tie"
    if theirs["ms_q1"] > mine["ms_q3"] and margin > noise:
        verdict = "picked faster"
    elif mine["ms_q1"] > theirs["ms_q3"] and -margin > noise:
        verdict = "other faster"
    return {"margin": margin, "noise": noise, "verdict": verdict}


def recurrence_times(key: str, launches: int, card: str, gen,
                     ptxas: dict) -> dict:
    """The recurrence kernel's row at a case's (N, M), fp32, distinct
    gates in every column: the walk, the tile and the walk again timed in
    turns (``route_turns``), each route held against the plain version in
    its order; ``ms`` is the route the rule picks, ``route_verdict`` judges
    it, and ``plain_ms`` times the sequential plain walk.  With the tile's
    chunks and rows, its blocks per SM and both kernels' ptxas report."""
    import torch
    from repro_torch.kernels import engine, ops

    order, reverse, n, m = _RECUR_ROWS[key]
    spec = engine.find_recurrence_spec(order, reverse=reverse)
    gates, q = random_recur_operands(order, n, m, torch.float32, gen)
    picked = ops.recurrence_route(n, m, torch.float32, order)
    calls = {"walk": {"route": "walk"}, "tile": {"route": "tile"},
             "walk_again": {"route": "walk"}}
    stats = route_turns(
        lambda which: ops.recurrence_cuda(spec, gates, q, **calls[which]),
        *calls)
    errs = {}
    for k in ("walk", "tile"):
        route = ops.recurrence_route(n, m, torch.float32, order, k)
        want = ops.route_plain(spec, gates, q, route)
        got = ops.recurrence_cuda(spec, gates, q, route=k)
        errs[k] = (got - want).abs().max().item()
        check(errs[k] <= 1e-5 * want.abs().max().item(),
              f"({key}) recurrence {k} route vs plain max|Δ| {errs[k]:.3e}")
        del got, want
    plain_ms = event_ms(lambda: ops.recurrence_plain(spec, gates, q),
                        reps=3, warmup=1)
    del gates, q
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound(spec, n, m, card)
    tile = ops.recurrence_route(n, m, torch.float32, order, "tile")
    entry = (recurrence_entry_times(key, card, gen)
             if key in recurrence_cases(gen) else {})
    mine = stats[picked.name]
    other = "tile" if picked.name == "walk" else "walk"
    return {
        "name": f"recurrence_sweep/{spec.name}/N{n}xM{m}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/recurrence_sweep.cu",
        "replaces": "src/repro/kernels/engine.py:1156",
        "also_replaces": ["src/repro/kernels/engine.py:1169"],
        "launches": launches,
        "max_abs_err": errs[picked.name],
        "ms": mine["ms"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a linear "
                        "recurrence",
        "case": key, "ms_q1": mine["ms_q1"], "ms_q3": mine["ms_q3"],
        "reps": mine["reps"],
        "sweep_route": dataclasses.asdict(picked),
        "walk_ms": stats["walk"]["ms"], "walk_ms_q1": stats["walk"]["ms_q1"],
        "walk_ms_q3": stats["walk"]["ms_q3"],
        "tile_ms": stats["tile"]["ms"], "tile_ms_q1": stats["tile"]["ms_q1"],
        "tile_ms_q3": stats["tile"]["ms_q3"],
        "walk_again_ms": stats["walk_again"]["ms"],
        "route_check": route_verdict(stats, picked.name, other),
        "other_route_abs_err": errs[other],
        "tile": {"chunks": tile.chunks, "rows": tile.rows,
                 "threads": tile.threads},
        "blocks_per_sm": ops.recurrence_tile_blocks_per_sm(
            torch.float32, order, tile.chunks),
        "ptxas": recurrence_ptxas(ptxas, order),
        **entry,
    }


def serve_recurrence_row(served: dict, card: str, ptxas: dict) -> dict:
    """The recurrence kernel at a serving case's operand ((m): N 16 chunks,
    M = B 8 · 24 heads · 64 · 128; (n): N = S 1984, M = B 8 · rnn_width
    4096), with the serve run's launches, and its share of a prefill: a
    prefill's launches' time over the prefill's CUDA-event time."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    row = recurrence_times(served["case"], served["launches"]["recur1"], card,
                           gen, ptxas)
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
    rate = card_rates(card).hbm_bytes_s
    return {"entry_ms": fwd["ms"], "entry_ms_q1": fwd["ms_q1"],
            "entry_ms_q3": fwd["ms_q3"],
            "entry_bound_ms": 4 * words / rate * 1e3,
            "entry_fwd_bwd_ms": both["ms"],
            "entry_fwd_bwd_ms_q1": both["ms_q1"],
            "entry_fwd_bwd_ms_q3": both["ms_q3"],
            "entry_fwd_bwd_bound_ms": 8 * words / rate * 1e3}


def route_turns(call, *routes: str, reps: int = 10) -> dict:
    """Routes of a kernel timed in turns on one card, ``reps`` launches a
    turn; ``call(route)`` launches once.  One round a route: round r takes
    the routes from the r-th on, cyclically, and then back (first, second,
    second, first; then second, first, first, second), so that each route
    opens and closes as many turns as any other.  Medians and quartiles of
    each route's times."""
    times = {which: [] for which in routes}
    for r in range(len(routes)):
        order = routes[r:] + routes[:r]
        for which in order + order[::-1]:
            times[which] += event_times(lambda: call(which), reps)
    out = {}
    for which, t in times.items():
        q1, _, q3 = statistics.quantiles(t, n=4)
        out[which] = {"ms": statistics.median(t), "ms_q1": q1, "ms_q3": q3,
                      "reps": len(t)}
    return out


# the grid of ``--routes``: (order, reverse, N, M) beyond the main-path
# rows: M across the tile's column cutoff at N 1024, and short N
_ROUTE_GRID = ([(1, False, 1024, m) for m in (4096, 16384, 65536, 98304,
                                             131072, 262144, 1 << 20)]
               + [(2, True, 1024, m) for m in (8192, 32768, 49152, 65536,
                                               131072)]
               + [(1, False, n, m) for n in (8, 16, 32, 64, 128, 256)
                  for m in (4096, 32768, 1 << 20)]
               + [(2, True, n, 32768) for n in (16, 64, 256)])


def recurrence_route_grid(card: str) -> list:
    """The recurrence kernel's routes over a grid, fp32, distinct gates in
    every column: at the main-path rows (``_RECUR_ROWS``) and at
    ``_ROUTE_GRID``, the walk, the tile in 1, 2, 4, 8 and 16 chunks (where
    N fills them) and the walk again, in turns (``route_turns``), each
    beside the byte floor, the rule's pick, the fastest and the turns'
    noise (the two walks' distance); 40 launches a turn up to 2^25
    elements, else 10.  One JSON line a row."""
    import torch
    from repro_torch.kernels import engine, ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = [(key, *row) for key, row in _RECUR_ROWS.items()]
    rows += [("grid", *row) for row in _ROUTE_GRID]
    out = [{"blocks_per_sm_fp32": {
        f"{o},{c}": ops.recurrence_tile_blocks_per_sm(torch.float32, o, c)
        for o in (1, 2) for c in (1, 2, 4, 8, 16)}}]
    emit(out[0])
    for key, order, reverse, n, m in rows:
        spec = engine.find_recurrence_spec(order, reverse=reverse)
        gates, q = random_recur_operands(order, n, m, torch.float32, gen)
        calls = {"walk": {"route": "walk"}}
        for c in (1, 2, 4, 8, 16):
            if c == 1 or (c - 1) * ops.RECURRENCE_ROWS < n:
                calls[f"tile{c}"] = {"route": "tile", "chunks": c}
        calls["walk_again"] = {"route": "walk"}
        stats = route_turns(
            lambda which: ops.recurrence_cuda(spec, gates, q, **calls[which]),
            *calls, reps=40 if n * m <= 1 << 25 else 10)
        del gates, q
        torch.cuda.empty_cache()
        picked = ops.recurrence_route(n, m, torch.float32, order)
        ms = {k: v["ms"] for k, v in stats.items()}
        walks = (ms["walk"], ms["walk_again"])
        row = {"row": key, "order": order, "reverse": reverse, "n": n,
               "m": m, "bound_ms": bound(spec, n, m, card)[0],
               "picked": dataclasses.asdict(picked), "ms": ms,
               "q1": {k: v["ms_q1"] for k, v in stats.items()},
               "q3": {k: v["ms_q3"] for k, v in stats.items()},
               "best": min(ms, key=ms.get),
               "noise": abs(walks[0] - walks[1]) / min(walks)}
        emit(row)
        out.append(row)
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
    rate = card_rates(card).hbm_bytes_s
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
    rate = card_rates(card).hbm_bytes_s
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
            add(recurrence_times(key, entry, card, gen, ptxas))
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


# ---------------------------------------------------------------------------
# phases ``analysis`` and ``profile``: the registry checks and the
# whole-step report
# ---------------------------------------------------------------------------

def phase_analysis() -> dict:
    """``repro_torch.analysis`` on the card, each part with the counts set
    to 0 just before it and read just after: ``speccheck`` over the
    registry (with the traffic recount); the card-side ``nansweep`` (every
    registry spec and both fused CN steps on every route at the ragged,
    dead-lane and aligned shapes, each output NaN-filled and fenced: one
    launch a route a shape, under each route's name); ``tracecheck`` on the
    kernels (every pure backend x bandwidth x mode x boundary condition
    and the 8 recurrence cases, forward, transposed and backward, under
    ``HostSyncMode`` and ``torch.cuda.set_sync_debug_mode("error")``, the
    sharded cells in a one-rank gloo group under the former alone; its
    launches exactly those of the cases it ran, its skips JAX's); then the
    lint; ``gridcheck`` with every CUDA source's ``<source>_spans`` export
    held against the Python rules over the whole grid (no launch); the
    mutation self-test on the CPU (every class caught, every patched object
    restored, no launch).  Fails on any finding."""
    import torch
    from repro_torch.analysis import (gridcheck, mutation, nansweep,
                                      speccheck, tracecheck)
    from repro_torch.kernels import fused_cn, ops

    t0 = time.perf_counter()
    seconds = {}
    findings = speccheck.run()
    check(not findings, "speccheck: " + "; ".join(map(str, findings[:10])))
    seconds["speccheck"] = time.perf_counter() - t0

    t = time.perf_counter()
    want: dict = {}
    for subject, layout, spec in nansweep.kinds():
        for route in nansweep.routes(layout, spec):
            key = subject if layout != "fused" else fused_cn.launch_name(
                subject.split("_")[-1], route[0])
            want[key] = want.get(key, 0) + len(nansweep.CASES)
    ops.reset_launches()
    findings = nansweep.run("cuda")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(not findings, "nansweep: " + "; ".join(map(str, findings[:10])))
    check(launches == want, f"analysis: nansweep launches {launches}, "
          f"expected {want}")
    seconds["nansweep"] = time.perf_counter() - t

    t = time.perf_counter()
    cases = tracecheck.contract_cases()
    ops.reset_launches()
    traced = tracecheck.sweep("cuda")
    torch.cuda.synchronize()
    trace_launches = dict(ops.LAUNCHES)
    check(not traced.findings,
          "tracecheck: " + "; ".join(map(str, traced.findings[:10])))
    skips = sorted(tracecheck.subject(*c) for c in cases
                   if c[0] == "cuda" and c[2] == "batch" and c[3])
    check(sorted(traced.skips) == skips, f"tracecheck skipped "
          f"{traced.skips}, expected JAX's cells {skips}")
    check(traced.cases + len(traced.skips) == len(cases),
          f"tracecheck ran {traced.cases} of {len(cases)} cells")
    check(traced.recurrences == len(tracecheck.recurrence_cases()),
          f"tracecheck ran {traced.recurrences} recurrence cases")
    check(trace_launches == traced.launches, f"tracecheck launches "
          f"{trace_launches}, expected {traced.launches}")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "tracecheck left the sync debug mode set")
    seconds["tracecheck"] = time.perf_counter() - t

    t = time.perf_counter()
    ops.reset_launches()
    grid = gridcheck.sweep("cuda")
    check(not grid.findings,
          "gridcheck: " + "; ".join(map(str, grid.findings[:10])))
    check(grid.spans > 0 and grid.compared == grid.spans,
          f"gridcheck compared {grid.compared} of {grid.spans} spans with "
          f"the CUDA sources")
    check(not ops.LAUNCHES, f"gridcheck launched {dict(ops.LAUNCHES)}")
    seconds["gridcheck"] = time.perf_counter() - t

    t = time.perf_counter()
    before = mutation.patch_targets()
    ops.reset_launches()
    results = mutation.self_test()
    after = mutation.patch_targets()
    missed = [r.name for r in results if not r.detected]
    check(not missed and len(results) == len(mutation._MUTATIONS),
          f"mutation self-test missed {missed}")
    check(all(after[k] is before[k] for k in before),
          "the mutation self-test left a patched object behind")
    check(not ops.LAUNCHES, f"the self-test launched {dict(ops.LAUNCHES)}")
    seconds["mutation"] = time.perf_counter() - t

    row = {"phase": "analysis", "seconds": time.perf_counter() - t0,
           "part_seconds": seconds, "speccheck_findings": 0,
           "nansweep_findings": 0, "launches": launches,
           "tracecheck": {"cells": traced.cases, "skips": traced.skips,
                          "recurrences": traced.recurrences,
                          "lint_findings": traced.lint_findings,
                          "launches": trace_launches},
           "gridcheck": {"rules": grid.rules, "spans": grid.spans,
                         "compared_with_cuda": grid.compared},
           "mutation": {r.name: len(r.evidence) for r in results}}
    emit(row)
    return row


# The cells of phase ``profile``: (name, arch, shape, cuts, hand-kernel
# launches a step).  P1 runs all 24 layers at the batch that fits, P2 the
# batch of (p), P3 one group and the tail (5 layers) at B 1, P4 all 40
# layers at the batch that leaves 10 GB of the card free.
PROFILE_CELLS = (
    ("P1", "mamba2-130m", "prefill_32k", {}, {"recur1": 24}),
    ("P2", "mamba2-130m", "train_4k", {"batch": 8},
     {"recur1": 48, "recur1_rev": 24}),
    ("P3", "recurrentgemma-9b", "prefill_32k", {"layers": 5, "batch": 1},
     {"recur1": 4}),
    ("P4", "granite-3-8b", "decode_32k", {}, {}),
)
#: A share no card can give: above it the count, not the card, is wrong.
SHARE_CAP = 1.05


def phase_profile(smi: str) -> list:
    """The measured leg of ``repro_torch.launch.dryrun`` on the cells of
    ``PROFILE_CELLS``, at full width with the cuts the record lists: one
    warm-up step, one timed by CUDA events, one traced.  Each step's
    hand-kernel launches (the counts set to 0 just before it and read just
    after) must equal the cell's, and the trace's must equal the counter's;
    P3's four on the tile route (N 32768 x M 4096).  ``mfu``,
    ``measured_roofline_fraction`` and ``busy_share``, each of the work
    that ran, must lie in (0, 1.05].  One line a cell (with the
    reference's ``mfu_reference`` beside), then the four records through
    ``roofline_report``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline_report

    t0 = time.perf_counter()
    check(ops.recurrence_route(32768, 4096, torch.bfloat16, 1).name
          == "tile", "P3's RG-LRU operand should take the tile route")
    records = []
    for name, arch, shape, cuts, want in PROFILE_CELLS:
        _free_device()
        rec = dryrun.measure_cell(arch, shape, seed=SEED, **cuts)
        check(rec["status"] == "ok", f"{name}: {rec.get('reason')}")
        got = rec["launches"]
        check(got["timed"] == want and got["traced"] == want,
              f"{name}: launches {got}, expected {want} a step")
        check(rec["trace"]["hand_launches"] == got["traced"],
              f"{name}: the trace shows {rec['trace']['hand_launches']}, "
              f"the counter {got['traced']}")
        if name == "P3":
            tile = sum(n for k, n in rec["trace"]["kernel_launches"].items()
                       if k.startswith("recurrence_tile_kernel"))
            check(tile == 4, f"P3: {tile} launches of the tile kernel")
        for key in ("mfu", "measured_roofline_fraction", "busy_share"):
            check(0 < rec[key] <= SHARE_CAP,
                  f"{name}: {key} {rec[key]:.4g} outside (0, {SHARE_CAP}]")
        emit({"phase": "profile", "cell": name, "arch": arch,
              "shape": shape, "batch": rec["batch"], "seq": rec["seq"],
              "measured_s": rec["measured_s"], "mfu": rec["mfu"],
              "mfu_reference": rec["mfu_reference"],
              "measured_roofline_fraction":
                  rec["measured_roofline_fraction"],
              "busy_share": rec["busy_share"],
              "bound_s": rec["roofline_ran"]["bound_s"],
              "dominant": rec["roofline_ran"]["dominant"],
              "top_ops_ms": rec["trace"]["top_kernels_ms"],
              "device_ms_by_class": rec["trace"]["device_ms_by_class"],
              "kernel_floors": rec["kernel_floors"],
              "launches": got["traced"], "reduced": rec["reduced"],
              "fit": rec.get("fit"),
              "peak_device_bytes": rec["peak_device_bytes"],
              "card": smi})
        rec["cell"] = name
        records.append(rec)
    print(roofline_report.render(records, markdown=True), flush=True)
    emit({"phase": "profile", "seconds": time.perf_counter() - t0})
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--routes", action="store_true",
                        help="time the recurrence kernel's routes over a "
                             "grid instead of the phases")
    parser.add_argument("--out", default="build/recurrence_routes.json",
                        help="where --routes writes its rows")
    # a rank of phase ``sharded``, started by that phase
    parser.add_argument("--sharded-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--sharded-world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--sharded-backend", help=argparse.SUPPRESS)
    parser.add_argument("--sharded-dir", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
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
    if args.sharded_rank is not None:
        try:
            return sharded_rank_main(args)
        except SmokeFailure as exc:
            print(f"chip_smoke: rank {args.sharded_rank}: FAIL: {exc}",
                  file=sys.stderr)
            return 1
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
                              + reports.get("batch_sweep", "")
                              + reports.get("recurrence_sweep", ""))
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "built": sorted(reports), "registers": registers,
              "ptxas": ptxas, "dir": str(build.BUILD_DIR)})

        if args.routes:
            grid = recurrence_route_grid(card)
            out = ROOT / args.out
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text("".join(json.dumps(row) + "\n" for row in grid))
            return 0
        phase_kernel_vs_plain()
        main = phase_main_path()
        sharded_rows = phase_sharded(card)
        main.update(phase_recurrences())
        main.update(phase_pde())
        kernels = phase_times(main, card, ptxas) + sharded_rows
        peak = torch.cuda.max_memory_allocated()
        peaks = [peak]
        for phase in (phase_serve, phase_serve_hybrid):
            served = phase(card)
            kernels.append(serve_recurrence_row(served, card, ptxas))
            peaks.append(served["peak_device_bytes"])
        for key in SERVE_CASES:
            peaks.append(phase_serve_attention(key, card)
                         ["peak_device_bytes"])
        trained = phase_train(card)
        kernels += train_recurrence_rows(trained, card, ptxas)
        peaks += [trained["peak_device_bytes"],
                  trained["hybrid_peak_device_bytes"]]
        phase_analysis()
        peaks += [rec["peak_device_bytes"] for rec in phase_profile(smi)]
        emit({"phase": "summary", "seconds": time.perf_counter() - start,
              "peak_device_bytes": max(peaks)})
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
