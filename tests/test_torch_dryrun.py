"""The port's cost model and profiler report (``repro_torch.launch.
{analytic_cost, trace_analysis, dryrun, roofline_report}``) against the
JAX package's ``repro.launch.{analytic_cost, hlo_analysis, dryrun,
roofline_report}``, on the CPU.

The analytic FLOPs, bytes, attention FLOPs, ``model_flops`` and the
parameter counts equal JAX's exactly for every arch x shape cell (the same
formulas on configs of the same fields); the roofline terms use the card's
rates; the trace reader is held on a hand-written chrome trace and on a
real CPU profile of a smoke prefill; the static leg's records render to
the same shared columns as JAX's ``fmt_row``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.launch import analytic_cost as janalytic
from repro.launch import hlo_analysis as jhlo
from repro.launch import roofline_report as jreport
from repro.models import build_model as jbuild_model
from repro.models.params import ParamSpec as JParamSpec

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 get_smoke_config)
from repro_torch.launch import analytic_cost, dryrun, roofline_report
from repro_torch.launch.trace_analysis import (CARDS, MATMUL_OPS,
                                               _attn_flops, card_rates,
                                               launch_name, model_flops,
                                               read_trace, roofline_terms)
from repro_torch.models import build_model

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
H100 = "NVIDIA H100 80GB HBM3"


def _jax_attn_flops():
    """JAX's ``dryrun._attn_flops``.  Importing ``repro.launch.dryrun`` sets
    ``XLA_FLAGS`` to 512 host devices; the backend is started first (so
    the flag changes nothing here) and the variable is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun._attn_flops


def _jax_param_counts(arch: str) -> tuple:
    """JAX's ``run_cell`` rule on JAX's own parameter specs."""
    cfg = jconfigs.get_config(arch)
    specs = jbuild_model(cfg).param_specs()
    total = active = 0.0
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, JParamSpec))[0]:
        n = float(math.prod(s.shape))
        total += n
        if [getattr(k, "key", str(k)) for k in path] == ["embed"]:
            continue
        active += n * ((cfg.top_k / cfg.n_experts) if "experts" in s.names
                       else 1.0)
    return total, active


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_cost_and_model_flops_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    seq, batch, kind = SHAPES[shape]
    assert analytic_cost.flops_for_cell(cfg, kind, batch, seq) == \
        janalytic.flops_for_cell(jcfg, kind, batch, seq)
    total, active = dryrun.param_counts(cfg)
    for n_dev, shards in ((256, 16), (512, 16), (1, 1)):
        kw = dict(n_dev=n_dev, params_total=total, params_active=active,
                  cache_bytes_total=3.5e9, model_shards=shards)
        assert analytic_cost.bytes_for_cell(cfg, kind, batch, seq, **kw) == \
            janalytic.bytes_for_cell(jcfg, kind, batch, seq, **kw)
    attn = _attn_flops(cfg, kind, batch, seq)
    assert attn == _jax_attn_flops()(jcfg, kind, batch, seq)
    tokens = batch if kind == "decode" else batch * seq
    assert model_flops(cfg, kind, tokens, active, total, attn) == \
        jhlo.model_flops(jcfg, kind, tokens, active, total, attn)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch):
    assert dryrun.param_counts(get_config(arch)) == _jax_param_counts(arch)


def test_roofline_terms_dominance_at_the_card_rates():
    card = card_rates(H100)
    assert card == CARDS["H100 80GB HBM3"]
    assert (card.hbm_bytes_s, card.bf16_flops, card.fp32_flops,
            card.fp64_flops, card.nvlink_bytes_s) == (
        3.35e12, 989e12, 67e12, 34e12, 450e9)
    r = roofline_terms(989e12, 100e9, 1e9, card=H100)   # 1 s compute
    assert r["dominant"] == "compute"
    assert abs(r["compute_s"] - 1.0) < 1e-12
    r = roofline_terms(1e12, 3.35e12, 1e9, card=card)   # 1 s memory
    assert r["dominant"] == "memory"
    assert abs(r["memory_s"] - 1.0) < 1e-12
    r = roofline_terms(1e12, 1e9, 4500e9, card=H100)    # 10 s collective
    assert r["dominant"] == "collective"
    assert abs(r["collective_s"] - 10.0) < 1e-9
    assert r["bound_s"] == r["collective_s"]
    r = roofline_terms(67e12, 0.0, 0.0, card=H100, dtype="float32")
    assert abs(r["compute_s"] - 1.0) < 1e-12
    with pytest.raises(KeyError, match="no peak rates"):
        card_rates("Tesla T4")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def test_trace_reader_on_a_synthetic_trace():
    """Two overlapping kernels, an idle gap, a matmul launched by
    ``aten::mm``, a copy, and one ``c10d::allreduce_`` of a tensor list
    whose dtype only gloo's annotation of the same shapes records."""
    recur = ("void (anonymous namespace)::recurrence_tile_kernel<"
             "__nv_bfloat16, float, 1, false>(__nv_bfloat16 const*, "
             "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
             "long, long)")
    gemm = "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT"
    events = [
        _x("aten::mm", "cpu_op", 0.0, 20.0,
           **{"Input Dims": [[64, 32], [32, 16]],
              "Input type": ["c10::BFloat16", "c10::BFloat16"]}),
        _x("cudaLaunchKernel", "cuda_runtime", 5.0, 2.0, correlation=11),
        _x("cudaLaunchKernel", "cuda_runtime", 30.0, 2.0, correlation=12),
        _x("c10d::allreduce_", "cpu_op", 40.0, 10.0,
           **{"Input Dims": [[[1024, 256]], [], [], [], [], []],
              "Input type": ["TensorList", "", "", "", "Scalar",
                             "Scalar"]}),
        _x("gloo:all_reduce", "user_annotation", 41.0, 1.0, tid=2,
           **{"Input Dims": [[1024, 256]], "Input type": ["float"]}),
        _x(gemm, "kernel", 100.0, 50.0, tid=3, correlation=11),
        _x(recur, "kernel", 120.0, 60.0, tid=4, correlation=12),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 300.0, 100.0,
           tid=3),
        {"ph": "M", "name": "process_name", "pid": 7, "tid": 0,
         "args": {"name": "python"}},
    ]
    r = read_trace({"traceEvents": events})
    assert r["window_ms"] == pytest.approx(0.4)          # 0 .. 400 us
    assert r["busy_ms"] == pytest.approx(0.18)           # 100-180, 300-400
    assert r["busy_share"] == pytest.approx(0.45)
    assert r["device_ms_by_class"] == pytest.approx(
        {"gemm": 0.05, "hand:recur1": 0.06, "other": 0.1})
    assert r["device_ms_by_op"] == pytest.approx(
        {"aten::mm": 0.05, None: 0.16})
    assert r["hand_launches"] == {"recur1": 1}
    assert r["launches"] == {
        gemm: 1, "recurrence_tile_kernel<__nv_bfloat16, float, 1, false>": 1,
        "Memcpy DtoD (Device -> Device)": 1}
    assert r["matmul_flops"] == 2 * 64 * 32 * 16
    assert r["collectives"] == {
        "by_op": {"c10d::allreduce_": {"bytes": 1024 * 256 * 4,
                                       "count": 1}},
        "total_bytes": 1024 * 256 * 4}
    assert r["host_ops"] == {"aten::mm": 1, "c10d::allreduce_": 1}
    assert launch_name("void recurrence_kernel<float, float, 2, true>"
                       "(float const*)") == "recur2_rev"
    assert launch_name("void (anonymous namespace)::shared_tile_kernel<"
                       "float, float>((anonymous namespace)::TileArgs)") \
        == "shared_sweep"
    assert launch_name("void at::native::vectorized_elementwise_kernel<4>"
                       "(int)") is None
    assert launch_name(gemm) is None


def test_trace_reader_on_a_cpu_profile_of_the_smoke_prefill(tmp_path):
    cfg = get_smoke_config("mamba2-130m")
    model = build_model(cfg, device="cpu", seed=0)
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 with_flops=True) as prof:
        model.prefill({"tokens": tokens})
    got = read_trace(prof)
    # the program's spans are user annotations, which are no host ops
    assert got["host_ops"] == {
        e.key: e.count for e in prof.key_averages()
        if not getattr(e, "is_user_annotation", False)}
    assert "ssm.ssd" not in got["host_ops"]
    assert "ssm.ssd" in {e.key for e in prof.key_averages()}
    assert got["matmul_flops"] == sum(e.flops for e in prof.events()
                                      if e.name in MATMUL_OPS) > 0
    assert got["host_ops"]["aten::bmm"] >= cfg.n_layers
    assert got["launches"] == {} and got["busy_share"] == 0.0
    # a second run, exported (a profiler saves its trace once) and read
    # back from the file and from the loaded JSON
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 with_flops=True) as prof:
        model.prefill({"tokens": tokens})
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        loaded = json.load(f)
    for again in (read_trace(str(path)), read_trace(loaded)):
        assert again["host_ops"] == got["host_ops"]
        assert again["matmul_flops"] == got["matmul_flops"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_static_record_matches_jax_and_renders_its_columns(arch, shape):
    rec = dryrun.run_cell(arch, shape, mesh="16x16")
    jcfg = jconfigs.get_config(arch)
    seq, batch, kind = SHAPES[shape]
    ok, _ = jconfigs.shape_applicable(jcfg, shape)
    if not ok:
        assert rec["status"] == "skip"
        return
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert (rec["params_total"], rec["params_active"]) == \
        _jax_param_counts(arch)
    assert rec["analytic"]["flops_global"] == janalytic.flops_for_cell(
        jcfg, kind, batch, seq)["total"]
    cache = rec["analytic"]["cache_bytes_total"]
    assert rec["analytic"]["bytes_per_device"] == janalytic.bytes_for_cell(
        jcfg, kind, batch, seq, n_dev=256, params_total=rec["params_total"],
        params_active=rec["params_active"], cache_bytes_total=cache)["total"]
    if kind == "decode":
        assert cache == sum(math.prod(s.shape) * jnp.dtype(s.dtype).itemsize
                            for s in jax.tree_util.tree_leaves(
                                jbuild_model(jcfg).cache_specs(batch, seq),
                                is_leaf=lambda x: isinstance(x, JParamSpec)))
    rl = rec["roofline"]
    assert rl["compute_s"] == rec["analytic"]["flops_global"] / 256 / 989e12
    assert rl["memory_s"] == rec["analytic"]["bytes_per_device"] / 3.35e12
    for markdown in (False, True):
        assert roofline_report.fmt_row(rec, markdown) == \
            jreport.fmt_row(rec, markdown)


def test_one_card_mesh_skips_what_cannot_fit():
    rec = dryrun.run_cell("granite-3-8b", "decode_32k", mesh="1")
    assert rec["status"] == "skip" and "80 GB" in rec["reason"]
    # 40 layers x K and V x 128 sequences x 8 heads x 32768 x 128 x 2 bytes
    assert rec["held_bytes"]["cache"] == 40 * 2 * 128 * 8 * 32768 * 128 * 2
    rec = dryrun.run_cell("mamba2-130m", "train_4k", mesh="1")
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    held = rec["held_bytes"]
    assert held["opt_state"] == 2 * 4 * rec["params_total"]  # fp32 mu, nu
    assert held["grads"] == held["weights"]


def test_dryrun_all_and_the_report(tmp_path):
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 0
    files = sorted(os.listdir(tmp_path))
    assert len(files) == len(ARCH_IDS) * len(SHAPES) * len(dryrun.MESHES)
    for mesh, n_ok in (("16x16", 32), ("1", 12)):
        cells = roofline_report.load_cells(str(tmp_path), mesh=mesh)
        assert len(cells) == len(ARCH_IDS) * len(SHAPES)
        assert sum(d["status"] == "ok" for d in cells) == n_ok
        table = roofline_report.render(cells, markdown=True)
        rows = [line for line in table.splitlines()
                if line.startswith("| ") and "SKIP" not in line]
        assert len(rows) == 1 + n_ok                   # the header and rows
    with open(tmp_path / "mamba2_130m__train_4k__card.json") as f:
        assert json.load(f)["mesh"] == "1"
    if not torch.cuda.is_available():
        # the measured leg writes its own record (here its error), beside
        # the static one and never over it
        assert dryrun.main(["--arch", "mamba2-130m", "--shape", "train_4k",
                            "--measure", "--out", str(tmp_path)]) == 1
        with open(tmp_path / "mamba2_130m__train_4k__card_measured.json") as f:
            assert json.load(f)["status"] == "error"
        with open(tmp_path / "mamba2_130m__train_4k__card.json") as f:
            assert json.load(f)["status"] == "ok"


def test_report_reads_a_measured_record():
    static = dryrun.run_cell("mamba2-130m", "prefill_32k", mesh="1")
    rec = dict(static)
    rec.update(measured_s=2.0, mfu=0.04, measured_roofline_fraction=0.15,
               busy_share=0.3,
               trace={"device_ms_by_class": {"gemm": 10.0, "other": 500.0}})
    row = roofline_report.fmt_row(rec, False)
    assert row.endswith(",2,0.04,0.150,0.300")
    # the static share keeps its column; the measured one has its own
    assert row.split(",")[8] == f"{static['roofline_fraction']:.3f}"
    table = roofline_report.render([static, rec], markdown=False)
    header, first, second = table.splitlines()[:3]
    assert header.split(",")[-4:] == roofline_report.MEASURED
    assert {first.split(",")[-1], second.split(",")[-1]} == {"-", "0.300"}
    assert dryrun.record_name("mamba2-130m", "prefill_32k", "1",
                              measured=True) \
        == "mamba2_130m__prefill_32k__card_measured.json"
    assert roofline_report.one_sentence(rec).startswith("host-bound")
    rec.update(busy_share=0.97, kernel_floors={"recur1": 1.2}, trace={
        "device_ms_by_class": {"gemm": 10.0, "hand:recur1": 50.0}})
    assert roofline_report.one_sentence(rec).startswith("memory: recur1")
    rec["trace"]["device_ms_by_class"]["gemm"] = 90.0
    assert roofline_report.one_sentence(rec).startswith("compute")


def test_measured_leg_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the measured leg runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        dryrun.measure_cell("mamba2-130m", "prefill_32k")


def test_measured_cuts_recompute_the_cost():
    """The measured leg prices the cut cell, not the published one."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=5)
    rec = dryrun.analytic_record(cfg, "prefill", 1, 32768, 1, 1, H100)
    full = dryrun.run_cell("recurrentgemma-9b", "prefill_32k", mesh="1")
    assert rec["params_total"] < full["params_total"]
    assert rec["analytic"]["flops_global"] == \
        analytic_cost.flops_for_cell(cfg, "prefill", 1, 32768)["total"]


def test_mfu_counts_the_logits_the_prefill_forms():
    """P3's cut cell (recurrentgemma-9b, 5 layers, B 1 x S 32768): the
    reference counts the unembed at all 32,768 tokens, the port's prefill
    forms the last token's logits, so the work that ran is about half the
    reference's count; the analytic bound drops by the same unembed."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=5)
    seq = 32768
    rec = dryrun.analytic_record(cfg, "prefill", 1, seq, 1, 1, H100)
    ran = dryrun.ran_record(cfg, "prefill", 1, seq,
                            rec["analytic"]["bytes_per_device"], H100)
    unembed = 2.0 * cfg.d_model * cfg.vocab
    assert rec["model_flops"]["model_flops"] \
        - ran["model_flops_ran"]["model_flops"] == unembed * (seq - 1)
    assert 0.5 < ran["model_flops_ran"]["model_flops"] \
        / rec["model_flops"]["model_flops"] < 0.55
    assert rec["analytic"]["flops_global"] \
        - ran["analytic_ran"]["flops_global"] == unembed * (seq - 1)
    assert ran["roofline_ran"]["bound_s"] < rec["roofline"]["bound_s"]
    # training forms every token's logits: nothing to take off
    rec = dryrun.analytic_record(cfg, "train", 1, 4096, 1, 1, H100)
    ran = dryrun.ran_record(cfg, "train", 1, 4096, 1.0, H100)
    assert ran["model_flops_ran"]["model_flops"] == \
        rec["model_flops"]["model_flops"]


APPLICABLE = [(a, s) for a, s in CELLS
              if jconfigs.shape_applicable(jconfigs.get_config(a), s)[0]]


@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_useful_flops_of_the_work_that_ran_stay_within_the_analytic(arch,
                                                                    shape):
    """Counted at the rows each parameter is applied to, the useful FLOPs
    stay within the analytic FLOPs of the same step, up to the norm
    scales the reference's k x N rule counts as matmul weights (at most
    0.004 % past it over the grid; the reference's own count reads 1.34
    times the analytic at seamless-m4t-large-v2 ``prefill_32k``)."""
    cfg = get_config(arch)
    seq, batch, kind = SHAPES[shape]
    ran = dryrun.ran_record(cfg, kind, batch, seq, 1.0, H100)
    assert 0 < ran["model_flops_ran"]["model_flops"] \
        <= 1.0001 * ran["analytic_ran"]["flops_global"]


def test_reference_model_flops_count_every_parameter_at_every_token():
    """A limit of the reference's ``model_flops`` (k · N_active · tokens),
    kept for parity: it counts the encoder's parameters at every decoder
    token and the unembed at every prefill token, so at
    seamless-m4t-large-v2's ``prefill_32k`` (32,768 tokens over 1536
    frames) its "useful" FLOPs exceed the analytic count."""
    rec = dryrun.run_cell("seamless-m4t-large-v2", "prefill_32k")
    assert rec["useful_flop_ratio"] > 1.3
    comps = rec["analytic"]["flops_components_fwd"]
    cfg = get_config("seamless-m4t-large-v2")
    seq, batch, _ = SHAPES["prefill_32k"]
    assert comps["unembed"] == 2.0 * batch * seq * cfg.d_model * cfg.vocab
