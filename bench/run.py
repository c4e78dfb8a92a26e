"""Run one benchmark cell of ``BENCHMARK.json`` on the card and print its
result as one JSON line.

    python3 bench/run.py --workload cn-diffusion.step --seed 7 \\
        --seconds 30 --trace 0

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` its
per-layer metrics, read from a profiler trace of ``trace_steps`` more
steps after the window, with ``busy_s``, ``window_s`` and a breakdown.
Every run compares its answers with the plain reference and prints each
compared number beside its limit, last on standard error and last in the
result line (``checks``).  Exits non-zero, with no result, without enough
CUDA devices, when the port's package is missing, or when the JAX
package or JAX was loaded.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchkit import manifest  # noqa: E402
from benchkit.cell import forbidden_modules, run_cell, smi  # noqa: E402


def metric_values(entries: list, run) -> dict:
    out = {}
    for m in entries:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.load_manifest()
    entry = manifest.cell(bench, args.workload)
    conf_entry = manifest.config_entry(bench, entry["config"])
    conf_file = manifest.ROOT / conf_entry["file"]
    config = manifest.read_json(conf_file)
    workload = manifest.read_json(manifest.workload_file(args.workload))

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchkit.cards import card_rates

    run, correct, rows, attempted = run_cell(
        config, workload, manifest.reference(conf_file),
        seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
        device="cuda", t0=T0)
    name = torch.cuda.get_device_name(0)
    run.card = card_rates(name)
    print(f"card: {smi()}", flush=True)

    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 3

    section = "per_layer" if args.trace else "end_to_end"
    result = {
        "correct": correct, "attempted": attempted,
        "failed": sum(1 for _, v, lim in rows if not v <= lim),
        "metrics": metric_values(
            manifest.metrics_for(bench, args.workload, section), run),
        "device": {"platform": "gpu", "kind": name, "count": 1,
                   "memory_peak_bytes": run.peak_bytes}}
    if args.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["top_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    if args.trace:
        print(f"traced launches: {json.dumps(run.trace['hand_launches'])} "
              f"in {run.trace_steps} steps", flush=True)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
