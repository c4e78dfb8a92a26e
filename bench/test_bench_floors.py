"""The byte floors and FLOP counts the shares divide by: hand-checked
values, and independent of the route the program takes."""

import ast

import pytest

from benchkit import floors, manifest
from benchkit.cards import card_rates


def test_cn_step_floor_at_the_main_path_shape():
    card = card_rates("NVIDIA H100 80GB HBM3")
    b = floors.cn_step_floor_bytes(512, 2 ** 20, "float32")
    assert b == 2 * 512 * 2 ** 20 * 4 == 4294967296
    assert round(b / card.hbm_bytes_s * 1e3, 4) == 1.2821
    adj = floors.cn_adjoint_floor_bytes(512, 2 ** 20, "float32")
    assert adj == (4 * 512 * 2 ** 20 + 6 * 512) * 4


def test_mamba2_counts_at_the_published_widths():
    c = manifest.read_json(manifest.BENCH / "configs" / "mamba2-130m.json")
    p = floors.mamba2_params(c)
    # a layer: 768 + 2*768*1536 + 2*768*128 + 768*24 + 3*24
    #          + 4*(1536 + 256) + 1536 + 1536*768 = 3,763,528
    assert p["layers"] == 24 * 3763528
    # config.json's 50277 tokens padded to a multiple of 16
    assert floors.embed_rows(c) == 50288
    assert p["embed"] == p["unembed"] == 50288 * 768
    scan = floors.mamba2_scan_flops(c, 8, 4096)
    t = 8 * 4096
    assert scan == 2 * t * 64 * 128 + 2 * t * 64 * 24 * 64 \
        + 4 * t * 128 * 24 * 64
    train = floors.mamba2_step_flops(c, 8, 4096, "train")
    assert train == 6 * (p["layers"] + 768) * t + 6 * 768 * 50288 * t \
        + 3 * 24 * scan
    prefill = floors.mamba2_step_flops(c, 4, 32768, "prefill")
    assert prefill == 2 * (p["layers"] + 768) * 4 * 32768 \
        + 2 * 768 * 50288 * 4 + 24 * floors.mamba2_scan_flops(c, 4, 32768)
    # the SSD scan of a prefill: N = 32768 / 64 = 512 chunks, M = 4 * 24 *
    # 64 * 128 = 786,432 columns, fp32, 24 layers
    rb = floors.mamba2_recur_floor_bytes(c, 4, 32768, "prefill")
    assert rb == 24 * (2 * 512 * 786432 + 512 * 4 * 24) * 4
    assert floors.mamba2_recur_floor_bytes(c, 8, 4096, "train") == \
        2 * 24 * (2 * 64 * 1572864 + 64 * 8 * 24) * 4


def test_floors_import_nothing_of_the_program():
    tree = ast.parse((manifest.BENCH / "benchkit" / "floors.py").read_text())
    imported = {n.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for n in ([a.name for a in node.names]
                          if isinstance(node, ast.Import) else [node.module])}
    assert imported <= {"__future__"}


@pytest.mark.parametrize("cell", ["cn-diffusion.step",
                                  "cn-diffusion.adjoint"])
def test_floor_is_the_same_whatever_route_runs(tiny, cell):
    """The same cell on the program's fused kernel, on its shared-sweep
    pipeline and on the plain reference backend has one floor."""
    import importlib
    config, workload, ref = tiny(cell)
    kind = importlib.import_module(f"benchkit.kinds.{workload['driver']}")
    backends = (("fused", "cuda", "reference") if workload["driver"] ==
                "cn_step" else ("cuda", "reference"))
    got = {b: kind.Cell(config, dict(workload, backend=b), 1, "cpu",
                        ref).floors for b in backends}
    assert len({tuple(sorted(f.items())) for f in got.values()}) == 1
