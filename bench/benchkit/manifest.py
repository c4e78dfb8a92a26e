"""Find what ``BENCHMARK.json`` names: a cell's workload file, its
configuration file and the configuration's plain reference, and each
metric's reader.

Everything is found by name, so a later change adds a configuration, a
cell or a metric as new files and new entries, and edits none:

  * ``bench/workloads/<cell name>.json`` — the cell's traffic: the
    driver (a module of ``benchkit.kinds``) and its parameters;
  * the configuration's ``file`` (``bench/configs/<config>.json``) and
    its plain reference beside it, ``bench/configs/<config>_ref.py``;
  * ``bench/metrics/<metric name>.py`` — a reader ``read(run)`` that
    returns the metric's value, or None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload_file(name: str) -> Path:
    return BENCH / "workloads" / f"{name}.json"


def reference_file(config_file: Path) -> Path:
    return config_file.with_name(config_file.stem + "_ref.py")


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(config_file: Path):
    """The plain reference module beside a configuration's file."""
    return load_module(reference_file(config_file),
                       "bench_ref_" + re.sub(r"\W", "_", config_file.stem))


def reader(metric: str):
    """``read(run)`` of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    return load_module(path, "bench_metric_" + re.sub(r"\W", "_",
                                                      metric)).read


def metrics_for(manifest: dict, cell_name: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    apply to the cell: those that list it, and those with no list."""
    return [m for m in manifest[section]
            if cell_name in m.get("workloads", [cell_name])]


def problems(manifest: dict, root: Path = ROOT) -> list:
    """What in the manifest breaks the naming rules or points nowhere."""
    out = []
    names = ([c["name"] for c in manifest["configs"]]
             + [w["name"] for w in manifest["workloads"]]
             + [m["name"] for m in manifest["end_to_end"]]
             + [m["name"] for m in manifest["per_layer"]])
    for n in names:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in manifest[section]]
        if len(set(seen)) != len(seen):
            out.append(f"duplicate name in {section}")
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    cells = {w["name"] for w in manifest["workloads"]}
    for m in metrics:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better is {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
        if not set(m.get("workloads", [])) <= cells:
            out.append(f"{m['name']}: lists a cell that does not exist")
        if not (BENCH / "metrics" / f"{m['name']}.py").exists():
            out.append(f"{m['name']}: no reader")
    for c in manifest["configs"]:
        path = root / c["file"]
        if not path.exists() or not reference_file(path).exists():
            out.append(f"{c['name']}: no file or no reference")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"{c['name']}: bad reduced key {key!r}")
    configs = {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
        if not NAME.match(w["traffic"]):
            out.append(f"{w['name']}: bad traffic {w['traffic']!r}")
        if w["name"] != f"{w['config']}.{w['traffic']}":
            out.append(f"{w['name']}: not named <config>.<traffic>")
        if not workload_file(w["name"]).exists():
            out.append(f"{w['name']}: no workload file")
    return out
