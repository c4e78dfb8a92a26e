#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` for
``sm_90a`` and no network.  Phases, each printing one JSON line:

  1. the card (``nvidia-smi`` name and power limit) and torch / CUDA versions;
  2. build every kernel from the checkout's sources (``build/repro_torch/``);
  3. each kernel against its plain-torch version on the card, for every
     sweep variant and storage type, at main-path and edge shapes (the
     batch sweep with distinct diagonals in every system);
  4. the main path at full size through ``repro_torch.solver`` (factorize
     with ``backend="auto"``, solve, and the adjoint through
     ``loss.backward()``), with the launch counts read around each case and
     the residual ``‖A x − d‖ / ‖d‖`` checked: shared-LHS cases (a)–(c)
     and per-system-LHS (batch) cases (d)–(e);
  5. kernel, plain-version and library times at the main-path shapes,
     beside the least time the card could take; each batch row also
     times the shared sweep on the same operator and shape, the paper's
     comparison, and holds the batch sweep to its plain version at the
     full grid on distinct diagonals in every system;
  6. one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; a machine without CUDA fails, it never runs on the CPU.
"""

from __future__ import annotations

import json
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


def ops_per_row(spec) -> int:
    """Arithmetic operations per row and system, read off each kernel's
    source, a division counted as one: the shared sweep does 2 per carry
    term in each pass plus the scale; the batch sweep's fused forward pass
    does 7 (tridiag) or 16 (penta), its backward 2 or 4."""
    if spec.layout == "batch":
        return 9 if spec.order == 1 else 20
    return 4 * spec.order + 1


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel_vs_plain() -> None:
    import torch
    from repro_torch.kernels import engine, ops

    storages = {"float32": (torch.float32, torch.float32),
                "float64": (torch.float64, torch.float64),
                "bf16": (torch.float32, torch.bfloat16)}
    shapes = ((512, 65536), (16384, 4096), (1, 1), (2, 3), (3, 130),
              (200, 1000))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    factors, worst = {}, {}

    def compare(name, label, n, m, got, want):
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name}/{label} N={n} M={m}: dtype or shape differs")
        err = rel_err(got, want)
        check(err <= _TOLERANCE[label],
              f"{name}/{label} N={n} M={m}: kernel vs plain "
              f"{err:.3e} > {_TOLERANCE[label]}")
        key = f"{name}/{label}"
        worst[key] = max(worst.get(key, 0.0), err)

    for name, spec in engine.REGISTRY.items():
        for label, (dtype, storage) in storages.items():
            for n, m in shapes:
                if spec.layout == "batch":
                    diags, rhs = random_batch_operands(spec, n, m, storage,
                                                       gen)
                    compare(name, label, n, m,
                            ops.batch_sweep_cuda(spec, diags, rhs),
                            ops.batch_sweep_plain(spec, diags, rhs))
                    del diags, rhs
                    continue
                if spec.bandwidth == 5 and n < 2:
                    continue   # the penta factor needs N >= 2
                fkey = (spec.bandwidth, spec.uniform, n, dtype)
                if fkey not in factors:   # a variant and its transpose share it
                    factors[fkey] = random_factor(spec, n, dtype, gen)
                f = factors[fkey]
                rhs = torch.randn(n, m, generator=gen, device="cuda",
                                  dtype=dtype)
                lhs, rhs, eps = sweep_operands(spec, f, rhs, storage)
                compare(name, label, n, m,
                        ops.shared_sweep_cuda(spec, lhs, rhs, eps),
                        ops.shared_sweep_plain(spec, lhs, rhs, eps))
        torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain", "shapes": [list(s) for s in shapes],
          "tolerance": _TOLERANCE, "max_rel_err": worst})


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


def bound(spec, n: int, m: int, card: str) -> tuple:
    """(bound_ms, bound_by) of one fp32 solve: the larger of the bytes the
    function must move over the card's memory rate and its operations
    over the card's fp32 rate."""
    import torch
    rate, flops = card_rates(card)
    bytes_ms = spec.traffic_bytes(n, m, torch.float32) / rate * 1e3
    ops_ms = ops_per_row(spec) * n * m / flops["float32"] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def kernel_stats(fn) -> dict:
    """Median of 20 CUDA-event timings of ``fn`` with its quartiles."""
    times = event_times(fn, reps=20)
    q1, _, q3 = statistics.quantiles(times, n=4)
    return {"ms": statistics.median(times), "ms_q1": q1, "ms_q3": q3,
            "reps": len(times)}


def shared_times(key: str, entry: dict, card: str, gen) -> dict:
    """The shared sweep's row: kernel, plain and ``lu_solve`` times."""
    import torch
    from repro_torch.core import dense_penta, dense_tridiag
    from repro_torch.kernels import engine, ops

    title, n, m, _make = main_path_cases()[key]
    system, fact = entry["system"], entry["fact"]
    spec = engine.find_spec(system.bandwidth, system.mode)
    factor = fact.stored.factor if system.periodic else fact.stored
    rhs = torch.randn(n, m, generator=gen, device="cuda")
    lhs, rhs, eps = sweep_operands(spec, factor, rhs, torch.float32)
    stats = kernel_stats(lambda: ops.shared_sweep_cuda(spec, lhs, rhs, eps))
    plain_reps = 3 if n > 4096 else 5
    plain_ms = event_ms(lambda: ops.shared_sweep_plain(spec, lhs, rhs, eps),
                        reps=plain_reps, warmup=1)
    got = ops.shared_sweep_cuda(spec, lhs, rhs, eps)
    want = ops.shared_sweep_plain(spec, lhs, rhs, eps)
    max_abs_err = (got - want).abs().max().item()
    check(max_abs_err <= 1e-5 * want.abs().max().item(),
          f"({key}) kernel vs plain max|Δ| {max_abs_err:.3e}")
    del got, want
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
        "max_abs_err": max_abs_err,
        "ms": stats["ms"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "case": key, "title": title, "ms_q1": stats["ms_q1"],
        "ms_q3": stats["ms_q3"], "reps": stats["reps"],
    }


# Systems of the batched dense LU that stands beside the batch sweep: a
# dense (M, N, N) LU of all 2^20 systems would take about 1 TiB.
LIBRARY_M = 4096


def batch_times(key: str, entry: dict, card: str, gen) -> dict:
    """The batch sweep's row: kernel, plain, shared-sweep and library
    times.  ``shared_ms`` is the shared sweep on one factor of the same
    operator at the same N and M (constant mode): the paper's comparison
    of cuThomasConstantBatch / cuPentConstantBatch with cuThomasBatch /
    cuPentBatch.  ``library_ms`` is a batched dense ``lu_solve`` from a
    precomputed ``lu_factor`` of ``LIBRARY_M`` systems, beside the kernel's
    own time at that M (``ms_at_library_m``)."""
    import torch
    from repro_torch.core import dense_penta, dense_tridiag, penta, tridiag
    from repro_torch.kernels import engine, ops
    from repro_torch.solver import factorize, reference

    title, n, m, _make = main_path_cases()[key]
    system = entry["system"]
    bw = system.bandwidth
    spec = engine.find_spec(bw, "batch")
    diags = list(reference.batch_diagonals(
        bw, factorize(system, backend="auto").stored))
    rhs = torch.randn(n, m, generator=gen, device="cuda")
    stats = kernel_stats(lambda: ops.batch_sweep_cuda(spec, diags, rhs))
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
    # kernel to its plain version on distinct diagonals in every system too
    diags, rhs = random_batch_operands(spec, n, m, torch.float32, gen)
    got = ops.batch_sweep_cuda(spec, diags, rhs)
    want = ops.batch_sweep_plain(spec, diags, rhs)
    distinct_err = rel_err(got, want)
    check(distinct_err <= _TOLERANCE["float32"],
          f"({key}) kernel vs plain on distinct diagonals at N={n} M={m}: "
          f"{distinct_err:.3e} > {_TOLERANCE['float32']}")
    del diags, rhs, got, want
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound(spec, n, m, card)
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
    }


def phase_times(main: dict, card: str) -> list:
    """Kernel, plain and library times of each main-path case's sweep at
    its shape; bound from this run's shapes and the card's peaks."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for key, entry in main.items():
        times = batch_times if entry["system"].mode == "batch" else \
            shared_times
        rows.append(times(key, entry, card, gen))
        emit({"phase": "times", **rows[-1]})
        torch.cuda.empty_cache()
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
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "built": sorted(reports), "registers": registers,
              "dir": str(build.BUILD_DIR)})

        phase_kernel_vs_plain()
        main = phase_main_path()
        kernels = phase_times(main, card)
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
