"""Readings that a cell's limits are set from, on the card, in one
process: the numbers ``correct`` compares, for sound runs of the program
over many seeds, for the control (the plain reference one precision below
the configuration's, in the program's place) over a few, and for each
planted fault over a few; each at the cell's own size and load.

    python3 bench/calibrate.py --workload cn-diffusion.step \\
        --seeds 12 --controls 3 --faults 3 --seconds 3 --out readings.jsonl

Each reading is one JSON line (``what``: program, control or
fault:<kind>; ``seed``; ``numbers``), written to ``--out`` and printed.
The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchkit import faults, manifest  # noqa: E402
from benchkit.cell import run_cell  # noqa: E402


def readings(config, workload, ref, what, seed, seconds):
    """One set of compared numbers."""
    import torch

    if what == "control" and workload["driver"] == "lm_train":
        # training's readings need no window: its set-up steps are compared
        from benchkit.kinds import lm_train
        numbers = lm_train.Cell(config, workload, seed, "cuda", ref,
                                control=True).check()
    else:
        plant = faults.planted(workload["driver"], what.split(":")[1]) \
            if what.startswith("fault:") else contextlib.nullcontext()
        with plant:
            _, _, rows, _ = run_cell(config, workload, ref, seed=seed,
                                     seconds=seconds, traced=False,
                                     device="cuda", t0=time.time(),
                                     control=what == "control")
        numbers = {k: v for k, v, _ in rows}
    torch.cuda.empty_cache()
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = manifest.load_manifest()
    entry = manifest.cell(bench, args.workload)
    conf_file = manifest.ROOT / manifest.config_entry(
        bench, entry["config"])["file"]
    config = manifest.read_json(conf_file)
    workload = manifest.read_json(manifest.workload_file(args.workload))
    ref = manifest.reference(conf_file)
    plan = ([("program", args.first_seed + i) for i in range(args.seeds)]
            + [("control", args.first_seed + 500 + i)
               for i in range(args.controls)]
            + [(f"fault:{k}", args.first_seed + 700 + i)
               for k in faults.KINDS for i in range(args.faults)])
    with open(args.out, "a") as out:
        for what, seed in plan:
            t = time.time()
            line = json.dumps({"cell": args.workload, "what": what,
                               "seed": seed,
                               "numbers": readings(config, workload, ref,
                                                   what, seed, args.seconds),
                               "seconds": round(time.time() - t, 1)})
            print(line, flush=True)
            out.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
