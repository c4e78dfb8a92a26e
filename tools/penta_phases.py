#!/usr/bin/env python3
"""Where the pentadiagonal on-chip tile's time goes at case (e): the tile
cut after each phase, timed in turns with the whole tile and the stream
kernel.

    python3 tools/penta_phases.py [--n 512] [--m 1048576] [--seed 0]

Run from the root of a checkout on a machine with one CUDA device and
``nvcc`` (it fails without them).  The default build of
``csrc/batch_sweep.cu`` holds the solve alone; this script builds the
source once more with ``-DBATCH_SWEEP_PHASES`` into ``build/penta_phases/``,
which adds ``batch_sweep_penta_phase``: ``batch_penta_kernel`` at float32
cut after phase 1 (loads), 2 (products), 3 (fold and re-run) or 4 (g walk),
writing what it holds instead of x.  On distinct, diagonally dominant
(N, M) fp32 diagonals from ``--seed`` (``chip_smoke.random_batch_operands``)
it times the four cuts, the whole tile (``route="onchip"``) and the stream
kernel (``route="stream"``) in turns (``chip_smoke.route_turns``: medians
and quartiles of 120 launches each), and holds the whole tile to its plain
version in its chunks.  Prints the card's name and power limit, then one
JSON line: each call's times, and each phase's time as the difference of
successive medians (``back``: the whole tile less the g-walk cut).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("loads", "products", "rerun", "g_walk")


def build_cuts(build) -> ctypes.CDLL:
    """``csrc/batch_sweep.cu`` built with its phase cuts, loaded."""
    out = ROOT / "build" / "penta_phases" / "batch_sweep_phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                    "-DBATCH_SWEEP_PHASES", "-o", str(out),
                    str(build.CSRC / "batch_sweep.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.batch_sweep_penta_phase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--m", type=int, default=1 << 20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("penta_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build, engine, ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    n, m = args.n, args.m
    spec = engine.REGISTRY["penta_batch"]
    tile = ops.batch_route(n, torch.float32, 5, "onchip")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    diags, rhs = cs.random_batch_operands(spec, n, m, torch.float32, gen)
    fn = build_cuts(build).batch_sweep_penta_phase
    ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in diags))
    scratch = torch.empty((n, m), dtype=torch.float32, device="cuda")

    def cut(stop: int) -> None:
        rc = fn(stop, ptrs, rhs.data_ptr(), scratch.data_ptr(), n, m,
                tile.chunks, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"batch_sweep_penta_phase {stop}: CUDA error "
                               f"{rc}")

    calls = {name: (lambda stop=k + 1: cut(stop))
             for k, name in enumerate(PHASES)}
    calls["tile"] = lambda: ops.batch_sweep_cuda(spec, diags, rhs,
                                                 route="onchip")
    calls["stream"] = lambda: ops.batch_sweep_cuda(spec, diags, rhs,
                                                   route="stream")
    turns = cs.route_turns(lambda which: calls[which](), *calls)
    ends = [turns[k]["ms"] for k in (*PHASES, "tile")]
    phase_ms = {k: ends[i] - (ends[i - 1] if i else 0.0)
                for i, k in enumerate((*PHASES, "back"))}
    got = ops.batch_sweep_cuda(spec, diags, rhs, route="onchip")
    want = ops.batch_sweep_plain(spec, diags, rhs, chunks=tile.chunks)
    err = (got - want).abs().max().item() / want.abs().max().item()
    print(json.dumps({"n": n, "m": m, "seed": args.seed,
                      "tile": {"chunks": tile.chunks, "rows": tile.rows},
                      "turns": turns, "phase_ms": phase_ms,
                      "tile_vs_plain": err}), flush=True)
    return 0 if err <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
