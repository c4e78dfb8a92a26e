"""Render the roofline table from dry-run records.

Counterpart of ``repro.launch.roofline_report``: the same columns, with
``mesh`` defaulting to ``1`` (one card) and the measured leg's
``measured_s``, ``mfu``, ``measured_roofline_fraction`` and ``busy_share``
added where a record has them (``-`` in a static record's row of such a
table).  ``roofline_frac`` is the reference's share in every row: the
useful compute time over the analytic bound.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        [--dir artifacts/dryrun] [--mesh 1] [--markdown]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

HEADER = ["arch", "shape", "compute_s", "memory_s", "collective_s",
          "dominant", "MODEL_FLOPS", "useful_ratio", "roofline_frac"]
MEASURED = ["measured_s", "mfu", "measured_roofline_frac", "busy_share"]
#: Record-name suffixes of the untagged meshes (``dryrun.record_name``).
_MESH_SUFFIXES = ("__pod2", "__card", "__card_measured")
#: A host-bound step: the device idle most of the traced window.
LOW_BUSY = 0.5
#: A hand kernel at its byte floor: its device time within this factor of
#: the bytes it must move over the card's rate.
AT_FLOOR = 1.5


def load_cells(directory: str, *, mesh: str = "1", tag: str = ""):
    cells = []
    for p in sorted(glob.glob(os.path.join(directory, "*.json"))):
        base = os.path.basename(p)
        if tag and f"__{tag}" not in base:
            continue
        if not tag and base.count("__") > 1 + any(
                s in base for s in _MESH_SUFFIXES):
            continue  # skip tagged experiment records in the main table
        with open(p) as f:
            d = json.load(f)
        if d.get("mesh") != mesh:
            continue
        cells.append(d)
    return cells


def one_sentence(d: dict) -> str:
    """What the record shows holds the step: a measured record by its trace
    (a low busy share: the host; GEMMs filling the device time: compute; a
    hand kernel at its byte floor: memory), else by the analytic
    roofline's dominant term.  Says nothing the record does not show."""
    trace = d.get("trace")
    if trace is not None:
        busy = d.get("busy_share", 0.0)
        classes = trace.get("device_ms_by_class", {})
        device_ms = sum(classes.values())
        if busy < LOW_BUSY:
            return (f"host-bound: the device is busy {busy:.1%} of the "
                    f"traced step")
        top = max(classes, key=classes.get) if classes else None
        if top == "gemm":
            return (f"compute: GEMMs take {classes[top] / device_ms:.1%} of "
                    f"the device time")
        floors = d.get("kernel_floors", {})
        at_floor = [k for k, r in floors.items() if r <= AT_FLOOR]
        if top and top.startswith("hand:") and top[5:] in at_floor:
            return (f"memory: {top[5:]} runs within {AT_FLOOR}x of its byte "
                    f"floor and takes {classes[top] / device_ms:.1%} of the "
                    f"device time")
        return (f"device-bound: {top} takes "
                f"{classes[top] / device_ms:.1%} of the device time"
                if top else "no device time in the trace")
    dom = d["roofline"]["dominant"]
    return {"compute": "compute: the analytic FLOPs at the card's peak "
                       "bound the step",
            "memory": "memory: the analytic bytes at the card's rate bound "
                      "the step",
            "collective": "collectives: the bytes over NVLink bound the "
                          "step"}[dom]


def fmt_row(d: dict, markdown: bool) -> str:
    rl = d["roofline"]
    mf = d.get("model_flops", {})
    cols = [
        f"{d['arch']}", f"{d['shape']}",
        f"{rl['compute_s']:.3g}", f"{rl['memory_s']:.3g}",
        f"{rl['collective_s']:.3g}", rl["dominant"],
        f"{mf.get('model_flops', 0):.3g}",
        f"{d.get('useful_flop_ratio', 0):.2f}",
        f"{d.get('roofline_fraction', 0):.3f}",
    ]
    if "measured_s" in d:
        cols += [f"{d['measured_s']:.4g}", f"{d['mfu']:.3g}",
                 f"{d['measured_roofline_fraction']:.3f}",
                 f"{d['busy_share']:.3f}"]
    sep = " | " if markdown else ","
    return sep.join(cols)


def render(cells: list, markdown: bool) -> str:
    """The table of ``cells``' ok records, their skips and one sentence a
    record, as ``main`` prints it."""
    ok = sorted((d for d in cells if d.get("status") == "ok"),
                key=lambda d: (d["arch"], d["shape"]))
    measured = any("measured_s" in d for d in ok)
    hdr = HEADER + (MEASURED if measured else [])
    sep = " | " if markdown else ","
    lines = (["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr)]
             if markdown else [",".join(hdr)])
    for d in ok:
        row = fmt_row(d, markdown)
        if measured and "measured_s" not in d:
            row += sep + sep.join(["-"] * len(MEASURED))
        lines.append(("| " + row + " |") if markdown else row)
    for d in cells:
        if d.get("status") == "skip":
            lines.append(f"{'| ' if markdown else ''}{d['arch']} "
                         f"{d['shape']}: SKIP — {d['reason']}"
                         f"{' |' if markdown else ''}")
    lines += ["", "### Bottleneck sentences"]
    lines += [f"- {d['arch']} x {d['shape']}: {one_sentence(d)}" for d in ok]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.roofline_report")
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="1")
    ap.add_argument("--tag", default="")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    print(render(load_cells(args.dir, mesh=args.mesh, tag=args.tag),
                 args.markdown))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
