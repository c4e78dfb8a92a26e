"""The manifest keeps the naming rules, and everything in it is found by
name, so that a new configuration, cell or metric is new files only."""

import json
import re

from benchkit import manifest


def test_manifest_has_no_problems(bench):
    assert manifest.problems(bench) == []


def test_names_and_units_use_only_allowed_characters(bench):
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[section]:
            assert name.match(e["name"]), e["name"]
    for e in bench["end_to_end"] + bench["per_layer"]:
        assert unit.match(e["unit"]), e["unit"]
    for w in bench["workloads"]:
        assert name.match(w["traffic"]) and name.match(w["config"])
    assert len(json.dumps(bench).encode()) < 64 * 1024


def test_every_file_is_found_by_name(bench):
    for w in bench["workloads"]:
        assert manifest.workload_file(w["name"]).exists()
    for c in bench["configs"]:
        path = manifest.ROOT / c["file"]
        assert path.exists() and manifest.reference_file(path).exists()
        assert manifest.read_json(path)["name"] == c["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_the_code_names_no_cell_config_or_metric(bench):
    """The harness's code finds them by name: none is written into it, so
    adding one edits no existing file."""
    names = ([e["name"] for s in ("configs", "workloads", "end_to_end",
                                  "per_layer") for e in bench[s]])
    code = [manifest.BENCH / "run.py",
            *sorted((manifest.BENCH / "benchkit").rglob("*.py"))]
    for path in code:
        text = path.read_text()
        for n in names:
            assert f'"{n}"' not in text and f"'{n}'" not in text, (path, n)


def test_a_new_cell_is_new_files(tmp_path, bench, monkeypatch):
    """A workload file and a metric reader added beside the others are
    found without touching any existing file."""
    monkeypatch.setattr(manifest, "BENCH", tmp_path)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "workloads" / "cn-diffusion.other.json").write_text(
        json.dumps({"driver": "cn_step"}))
    (tmp_path / "metrics" / "extra.pde.py").write_text(
        "def read(run):\n    return 1.5\n")
    assert manifest.read_json(manifest.workload_file(
        "cn-diffusion.other"))["driver"] == "cn_step"
    assert manifest.reader("extra.pde")(None) == 1.5
    extra = dict(bench, per_layer=bench["per_layer"] + [
        {"name": "extra.pde", "workloads": ["cn-diffusion.step"]}])
    assert "extra.pde" in [m["name"] for m in manifest.metrics_for(
        extra, "cn-diffusion.step", "per_layer")]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(bench, w["name"],
                                                       "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(bench, w["name"], "per_layer")
    for m in bench["per_layer"]:
        assert m["moves"] in [e["name"] for e in bench["end_to_end"]]
        for cell in m.get("workloads", []):
            assert m["moves"] in [e["name"] for e in manifest.metrics_for(
                bench, cell, "end_to_end")]
