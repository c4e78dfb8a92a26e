"""Dry-run driver: the cost of every (architecture x input-shape x mesh)
cell, and its measured whole step on one card.

Counterpart of ``repro.launch.dryrun``, with its CLI.  The reference lowers
and compiles each cell's jitted step for the production mesh and reads
XLA's analyses; the port has no compiler to ask, so it has two legs:

  * **static** (CPU, allocates nothing): for each cell the reference's
    record keys that mean something without XLA — ``params_total`` /
    ``params_active`` (from ``models.model.param_specs``, the reference's
    rule: skip ``embed``, scale ``experts`` by ``top_k / n_experts``),
    ``analytic`` (``launch.analytic_cost``; cache bytes from
    ``models.model.cache_specs``), ``roofline`` at the card's rates (no
    collective term: nothing measured it), ``model_flops``,
    ``useful_flop_ratio``, ``roofline_fraction`` (useful compute time
    over the bound, the reference's), and ``status`` / ``reason``
    (``configs.shape_applicable``).  In place of XLA's memory analysis,
    ``held_bytes``: the weights, optimizer state and cache each device
    holds at the mesh's shards; a cell that cannot fit the card's memory
    is ``status: "skip"`` with the reason.  Meshes: the reference's
    ``16x16`` and ``2x16x16`` (``launch.mesh.production_shape``), and
    ``1``, one card with ``model_shards=1``.
  * **measured** (``--measure``, the card only: it raises without CUDA):
    the cell's real step through the port's entry points
    (``train.make_train_step`` / ``make_prefill_step`` /
    ``make_decode_step``) at full width, depth and batch cut only as far
    as one card forces (each cut listed in ``reduced``; the batch by
    ``fit_batch``).  One warm-up step, one step timed by CUDA events
    (``measured_s``), one step traced by ``torch.profiler``
    (``launch.trace_analysis.read_trace``: device time by class, launches,
    the device's busy share), and one traced with the inputs' shapes for
    the matmul FLOPs (recording shapes slows the host enough to open gaps
    in a device-bound step's trace, so the busy share is read from the
    step traced without them).  The record holds the cut cell's static
    keys at ``model_shards=1`` (``roofline_fraction`` keeps the static
    meaning), and the measured shares, each of the work that ran
    (``ran_record``: the reference counts the unembed at every prefill
    token and the encoder and image projections at every token, where the
    port's step forms one token's logits a sequence in prefill and runs
    those projections once over each sequence's frames or image tokens):
    ``mfu`` = ``model_flops_ran`` / (``measured_s`` x the card's peak for
    the model's dtype), ``mfu_reference`` the same of the reference's
    ``model_flops``; ``measured_roofline_fraction`` = ``roofline_ran``'s
    ``bound_s`` / ``measured_s``; ``kernel_floors``: each hand kernel's
    traced device time over its byte floor (``ops.LAUNCH_BYTES`` at the
    card's rate); ``roofline_raw_profiler``: the profiler's matmul FLOPs
    and the collectives' bytes through ``roofline_terms`` (the profiler
    records no device-memory bytes), the counterpart of the reference's
    ``roofline_raw_hlo``.  Its record is ``*__card_measured.json``, beside
    the static ``*__card.json``.

The reference's variants are the same arguments of ``run_cell`` and
``measure_cell`` and the same flags: ``accum`` (``--accum``, the training
step's microbatches, ``train.make_train_step``), ``moe_local``
(``--moe-local [local2]``, ``cfg.moe_dispatch`` set to ``"local"`` or
``"local2"``, the moe layer's per-shard dispatch) and ``no_remat``
(``--no-remat``, ``cfg.remat`` off: no recompute in the backward, and the
analytic cost without its re-forward).  Each record carries the
reference's ``variant`` dict.  Its ``--rules`` and ``--grad-constrain``
(GSPMD sharding-rule overrides and gradient layout constraints) and
``--timeout`` (of one cell's XLA compile) have no counterpart: the port
compiles nothing, and its one-card step has no layout to constrain; the
``variant`` dict keeps their keys at the values that mean "not used".

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape decode_32k --measure
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
        --shape train_4k --measure --no-remat
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, _norm, get_config,
                                 shape_applicable)
from repro_torch.launch import analytic_cost
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.trace_analysis import (DEFAULT_CARD, _attn_flops,
                                               card_rates, model_flops,
                                               read_trace, roofline_terms,
                                               top_ops)
from repro_torch.models.model import cache_specs, param_specs
from repro_torch.models.params import ParamSpec, tree_leaves, tree_map

MESHES = ("16x16", "2x16x16", "1")
#: Bytes of the card ``fit_batch`` leaves free.
FREE_BYTES = 10e9


def _itemsize(dtype) -> int:
    return dtype.itemsize


def mesh_devices(mesh: str) -> tuple:
    """``(n_dev, model_shards)`` of a mesh name."""
    if mesh == "1":
        return 1, 1
    shape, axes = production_shape(multi_pod=(mesh == "2x16x16"))
    return math.prod(shape), shape[axes.index("model")]


def _spec_items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_items(tree[k], path + (k,))
    else:
        yield path, tree


def _active(cfg, s) -> float:
    """The parameters of leaf ``s`` one token meets: an ``experts`` leaf
    scaled by ``top_k / n_experts``."""
    return float(math.prod(s.shape)) * (
        (cfg.top_k / cfg.n_experts) if "experts" in s.names else 1.0)


def param_counts(cfg) -> tuple:
    """``(params_total, params_active)`` by the reference's rule: every
    parameter counts in the total; the active count skips the input
    ``embed`` table (a gather, not a matmul) and scales each ``experts``
    leaf by ``top_k / n_experts``."""
    total = active = 0.0
    for path, s in _spec_items(param_specs(cfg)):
        total += float(math.prod(s.shape))
        if list(path) != ["embed"]:
            active += _active(cfg, s)
    return total, active


def _tree_bytes(tree) -> float:
    return float(sum(math.prod(s.shape) * _itemsize(s.dtype)
                     for s in tree_leaves(tree) if isinstance(s, ParamSpec)))


def held_bytes(cfg, kind: str, batch: int, seq: int, n_dev: int) -> dict:
    """Bytes each device holds, every tree split evenly over ``n_dev``
    (the reference's fully sharded weights): the weights; for training
    their gradients and the two AdamW moments at ``cfg.opt_dtype``; for
    decode the cache.  Activations are not counted."""
    weights = _tree_bytes(param_specs(cfg))
    out = {"weights": weights / n_dev}
    if kind == "train":
        n = sum(math.prod(s.shape) for s in tree_leaves(param_specs(cfg)))
        opt_b = 2 if cfg.opt_dtype == "bfloat16" else 4
        out["grads"] = weights / n_dev
        out["opt_state"] = 2.0 * n * opt_b / n_dev
    if kind == "decode":
        out["cache"] = _tree_bytes(cache_specs(cfg, batch, seq)) / n_dev
    out["total"] = sum(out.values())
    return out


def analytic_record(cfg, kind: str, batch: int, seq: int, n_dev: int,
                    model_shards: int, card: str) -> dict:
    """The cell's cost at ``batch`` and ``cfg``'s depth: params, analytic
    FLOPs and bytes, the roofline at ``card``'s rates, ``model_flops``
    and the useful ratio."""
    total, active = param_counts(cfg)
    af = analytic_cost.flops_for_cell(cfg, kind, batch, seq)
    cache_total = _tree_bytes(cache_specs(cfg, batch, seq)) \
        if kind == "decode" else 0.0
    ab = analytic_cost.bytes_for_cell(
        cfg, kind, batch, seq, n_dev=n_dev, params_total=total,
        params_active=active, cache_bytes_total=cache_total,
        model_shards=model_shards)
    rl = roofline_terms(af["total"] / n_dev, ab["total"], 0.0, card=card,
                        dtype=cfg.dtype)
    tokens = batch if kind == "decode" else batch * seq
    mf = model_flops(cfg, kind, tokens, active, total,
                     _attn_flops(cfg, kind, batch, seq))
    return {
        "params_total": total, "params_active": active,
        "analytic": {"flops_global": af["total"],
                     "flops_components_fwd": af["components_fwd"],
                     "bytes_per_device": ab["total"],
                     "bytes_components": ab["components"],
                     "cache_bytes_total": cache_total},
        "roofline": rl, "model_flops": mf,
        "useful_flop_ratio": (mf["model_flops"] / af["total"]
                              if af["total"] else 0.0)}


def useful_share(rec: dict, n_dev: int, card: str, dtype: str) -> float:
    """The reference's ``roofline_fraction``: the useful compute time
    (``model_flops`` per device at the card's peak) over the roofline's
    bound."""
    useful_s = (rec["model_flops"]["model_flops"] / n_dev
                / card_rates(card).flops(dtype))
    bound = rec["roofline"]["bound_s"]
    return useful_s / bound if bound else 0.0


def logits_rows(kind: str, batch: int, seq: int) -> int:
    """The tokens whose logits the port's step forms: every token in
    training, the last of each sequence in prefill, the one new token of
    each sequence in decode."""
    return batch * seq if kind == "train" else batch


def _memory_leaf(path: tuple) -> bool:
    """A leaf applied to the encdec frames or the vlm image tokens (the
    encoder, the frame and image projections, the cross-attention K / V),
    not to the text tokens."""
    return (path[0] in ("frame_proj", "enc_blocks", "enc_ln", "img_proj")
            or (path[-1] in ("wk", "wv")
                and ("cross_attn" in path or "cross" in path)))


def _rows(cfg, path: tuple, kind: str, batch: int, seq: int) -> int:
    """The rows the port's step applies the leaf at ``path`` to."""
    if path[0] == "unembed":
        return logits_rows(kind, batch, seq)
    memory = {"encdec": cfg.n_frames,
              "vlm": cfg.n_img_tokens}.get(cfg.family)
    if memory and _memory_leaf(path):
        # once over each sequence's memory; decode reads its K / V cached
        return 0 if kind == "decode" else batch * memory
    return batch if kind == "decode" else batch * seq


def model_flops_ran(cfg, kind: str, batch: int, seq: int) -> dict:
    """The reference's useful FLOPs (k x active parameters x rows, plus
    ``_attn_flops``) with each parameter counted at the rows the port's
    step applies it to (``_rows``) in place of every token."""
    k = 6.0 if kind == "train" else 2.0
    params = 0.0
    for path, s in _spec_items(param_specs(cfg)):
        if list(path) != ["embed"]:
            params += k * _active(cfg, s) * _rows(cfg, path, kind, batch, seq)
    attn = _attn_flops(cfg, kind, batch, seq)
    return {"model_flops": params + attn, "k": k, "attn_flops": attn}


def ran_record(cfg, kind: str, batch: int, seq: int, bytes_per_device: float,
               card: str) -> dict:
    """The cost of the work the port's step runs on one card:
    ``model_flops_ran``, the analytic FLOPs with the unembed at
    ``logits_rows`` (and no image projection in a vlm decode, whose cache
    holds the image's K / V), and their roofline with the analytic
    bytes."""
    af = analytic_cost.flops_for_cell(cfg, kind, batch, seq)
    comp = dict(af["components_fwd"])
    comp["unembed"] = analytic_cost._unembed_flops(
        cfg, logits_rows(kind, batch, seq))
    if kind == "decode" and "img_proj" in comp:
        comp["img_proj"] = 0.0
    total = sum(comp.values()) * af["train_mult"]
    return {"model_flops_ran": model_flops_ran(cfg, kind, batch, seq),
            "analytic_ran": {"flops_global": total,
                             "flops_components_fwd": comp},
            "roofline_ran": roofline_terms(total, bytes_per_device, 0.0,
                                           card=card, dtype=cfg.dtype)}


def variant_config(cfg, *, moe_local=False, no_remat: bool = False):
    """``cfg`` with the reference's variants applied: ``moe_local``
    (``True`` or ``"local"``, or ``"local2"``) as ``moe_dispatch``,
    ``no_remat`` as ``remat=False``."""
    if moe_local:
        mode = moe_local if isinstance(moe_local, str) else "local"
        if mode not in ("local", "local2"):
            raise ValueError(f"moe_local must be 'local' or 'local2', got "
                             f"{moe_local!r}")
        cfg = dataclasses.replace(cfg, moe_dispatch=mode)
    if no_remat:
        cfg = dataclasses.replace(cfg, remat=False)
    return cfg


def variant_record(moe_local=False, no_remat: bool = False) -> dict:
    """The reference's ``variant`` dict: its GSPMD knobs
    (``grad_constrain``, ``rules``) at their unused values."""
    return {"moe_local": moe_local, "grad_constrain": False,
            "no_remat": no_remat, "rules": {}}


def _check_accum(accum: int) -> int:
    if int(accum) != accum or accum < 1:
        raise ValueError(f"accum must be a positive integer, got {accum!r}")
    return int(accum)


def run_cell(arch: str, shape_name: str, *, mesh: str = "16x16",
             tag: str = "", card: str = DEFAULT_CARD, accum: int = 1,
             moe_local=False, no_remat: bool = False) -> dict:
    """The static record of one cell (no allocation), with the variants
    applied (module docstring); ``accum`` changes no static term (the
    reference's analytic cost ignores it too) and is recorded."""
    cfg = variant_config(get_config(arch), moe_local=moe_local,
                         no_remat=no_remat)
    seq, batch, kind = SHAPES[shape_name]
    rec = {"arch": cfg.name, "shape": shape_name, "mesh": mesh,
           "kind": kind, "seq": seq, "batch": batch, "tag": tag,
           "card": card, "accum": _check_accum(accum),
           "variant": variant_record(moe_local, no_remat)}
    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec
    n_dev, shards = mesh_devices(mesh)
    rec.update(analytic_record(cfg, kind, batch, seq, n_dev, shards, card))
    rec["roofline_fraction"] = useful_share(rec, n_dev, card, cfg.dtype)
    rec["n_devices"] = n_dev
    rec["held_bytes"] = held_bytes(cfg, kind, batch, seq, n_dev)
    cap = card_rates(card).memory_bytes
    if rec["held_bytes"]["total"] > cap:
        rec.update(status="skip", reason=(
            f"holds {rec['held_bytes']['total'] / 1e9:.1f} GB a device "
            f"(weights, optimizer state, cache), past the card's "
            f"{cap / 1e9:.0f} GB"))
        return rec
    rec["status"] = "ok"
    return rec


# ---------------------------------------------------------------------------
# The measured leg
# ---------------------------------------------------------------------------

def _frontend(cfg, batch: int, device) -> dict:
    """The encdec / vlm frontend inputs, zeros as the reference's serving
    driver feeds them."""
    if cfg.family == "encdec":
        return {"frames": torch.zeros((batch, cfg.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)}
    if cfg.family == "vlm":
        return {"img_embed": torch.zeros(
            (batch, cfg.n_img_tokens, cfg.vision_dim), dtype=torch.bfloat16,
            device=device)}
    return {}


def make_step(model, kind: str, seq: int, *, seed: int = 0,
              accum: int = 1):
    """``prepare(batch) -> run()``: ``prepare`` builds the cell's inputs
    (and, for training, the optimizer state) at ``batch``; each ``run()``
    is one step through the port's entry point for ``kind`` (a training
    step in ``accum`` microbatches)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_optimizer
    from repro_torch.train import (make_decode_step, make_prefill_step,
                                   make_train_step)

    cfg, dev, sctx = model.cfg, model.device, model.sctx

    def prepare(batch: int):
        params = model.params.tree()
        if kind == "train":
            params = tree_map(lambda t: t.detach(), params)
        if kind == "decode":
            fn = make_decode_step(model, sctx)
            cache = model.init_cache(batch, seq)
            token = torch.zeros((batch,), dtype=torch.int64, device=dev)
            return lambda: fn(params, cache, token, seq - 1)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=seed).batch_at(0, device=dev)
        data.update(_frontend(cfg, batch, dev))
        if kind == "prefill":
            fn = make_prefill_step(model, sctx)
            data.pop("labels")
            return lambda: fn(params, data)
        opt = make_optimizer(cfg, lr=3e-4, warmup=20, steps=100)
        fn = make_train_step(model, sctx, opt, accum=accum)
        state = {"params": params, "opt": opt.init(params), "step": 0}

        def train_step():
            state["params"], state["opt"], metrics = fn(
                state["params"], state["opt"], data, state["step"])
            state["step"] += 1
            return metrics["loss"]
        return train_step

    return prepare


def fit_batch(prepare, cell_batch: int, multiple: int = 1) -> tuple:
    """``(batch, probe)``: the largest multiple of ``multiple`` (the
    training step's microbatches) up to ``cell_batch`` whose step leaves
    ``FREE_BYTES`` of the card free, from one step at batch ``multiple``:
    its peak above what was allocated before it, over ``multiple``, taken
    as the device bytes a sequence adds; ``probe`` holds the numbers the
    rule read."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run = prepare(multiple)
    run()
    torch.cuda.synchronize()
    per_seq = (torch.cuda.max_memory_allocated() - base) / multiple
    del run
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    fits = min(cell_batch, int((free - FREE_BYTES) // per_seq))
    batch = max(multiple, fits // multiple * multiple)
    return batch, {"per_sequence_bytes": per_seq, "free_bytes": free,
                   "left_free_bytes": FREE_BYTES}


def measure_cell(arch: str, shape_name: str, *, layers: int | None = None,
                 batch: int | None = None, seed: int = 0,
                 tag: str = "", accum: int = 1, moe_local=False,
                 no_remat: bool = False,
                 max_batch: int | None = None) -> dict:
    """The measured record of one cell on the CUDA card (module docstring);
    ``layers`` and ``batch`` cut depth and batch (``batch`` None: the
    largest ``fit_batch`` allows, a multiple of ``accum``, at most
    ``max_batch`` when given); ``accum``,
    ``moe_local`` and ``no_remat`` are the reference's variants.  Raises
    without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("the measured leg runs on a CUDA card; "
                           "torch.cuda.is_available() is False")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    full = variant_config(get_config(arch), moe_local=moe_local,
                          no_remat=no_remat)
    accum = _check_accum(accum)
    seq, cell_batch, kind = SHAPES[shape_name]
    card = torch.cuda.get_device_name(0)
    rec = {"arch": full.name, "shape": shape_name, "mesh": "1",
           "kind": kind, "seq": seq, "cell_batch": cell_batch, "tag": tag,
           "card": card, "accum": accum,
           "variant": variant_record(moe_local, no_remat)}
    if accum > 1 and kind != "train":
        raise ValueError(f"accum={accum} splits a training step; "
                         f"{shape_name} is a {kind} cell")
    ok, reason = shape_applicable(full, shape_name)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec
    cfg, reduced = full, []
    if layers is not None and layers != full.n_layers:
        if full.family == "encdec":
            raise ValueError("the encdec family's depth is enc_layers + "
                             "dec_layers; cut it with dataclasses.replace")
        cfg = dataclasses.replace(full, n_layers=layers)
        reduced.append(f"n_layers {full.n_layers} -> {layers}")
    model = build_model(cfg, device="cuda", seed=seed)
    prepare = make_step(model, kind, seq, seed=seed, accum=accum)
    if batch is None:
        batch, rec["fit"] = fit_batch(
            prepare, min(cell_batch, max_batch or cell_batch), accum)
        rule = f"leaves {FREE_BYTES / 1e9:g} GB of the card free"
    else:
        rule = "as asked"
    if batch != cell_batch:
        reduced.append(f"batch {cell_batch} -> {batch} ({rule})")
    rec.update(batch=batch, reduced=reduced)

    torch.cuda.reset_peak_memory_stats()
    run = prepare(batch)
    run()                                           # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    measured_s = start.elapsed_time(end) / 1e3
    timed_launches = dict(ops.LAUNCHES)
    traces = []
    for shapes in (False, True):
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=shapes, with_flops=shapes) as prof:
            run()
            torch.cuda.synchronize()
        traces.append(read_trace(prof))
        if not shapes:
            traced_launches = dict(ops.LAUNCHES)
            traced_bytes = dict(ops.LAUNCH_BYTES)
    peak = torch.cuda.max_memory_allocated()
    del run
    trace, shaped = traces

    rec.update(analytic_record(cfg, kind, batch, seq, 1, 1, card))
    rec["roofline_fraction"] = useful_share(rec, 1, card, cfg.dtype)
    rec.update(ran_record(cfg, kind, batch, seq,
                          rec["analytic"]["bytes_per_device"], card))
    rates = card_rates(card)
    peak_flops = rates.flops(cfg.dtype)
    # each hand kernel's traced device time over its byte floor
    floors = {name: trace["device_ms_by_kernel"][name]
              / (nbytes / rates.hbm_bytes_s * 1e3)
              for name, nbytes in traced_bytes.items()
              if nbytes and name in trace["device_ms_by_kernel"]}
    rec.update(
        measured_s=measured_s,
        mfu=rec["model_flops_ran"]["model_flops"]
        / (measured_s * peak_flops),
        mfu_reference=rec["model_flops"]["model_flops"]
        / (measured_s * peak_flops),
        measured_roofline_fraction=rec["roofline_ran"]["bound_s"]
        / measured_s,
        busy_share=trace["busy_share"],
        trace={"window_ms": trace["window_ms"], "busy_ms": trace["busy_ms"],
               "device_ms_by_class": trace["device_ms_by_class"],
               "top_kernels_ms": top_ops(trace["device_ms_by_kernel"]),
               "top_ops_ms": top_ops({str(k): v for k, v in
                                      trace["device_ms_by_op"].items()}),
               "hand_launches": trace["hand_launches"],
               "kernel_launches": trace["launches"],
               "matmul_flops": shaped["matmul_flops"],
               "shapes_window_ms": shaped["window_ms"]},
        launches={"timed": timed_launches, "traced": traced_launches},
        kernel_floors=floors,
        roofline_raw_profiler=roofline_terms(
            shaped["matmul_flops"], 0.0,
            shaped["collectives"]["total_bytes"], card=card,
            dtype=cfg.dtype),
        peak_device_bytes=peak, status="ok")
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def record_name(arch: str, shape: str, mesh: str, tag: str = "",
                measured: bool = False) -> str:
    """The record's file name; a measured record (mesh ``1``) has its own,
    so it never replaces the static record of its cell."""
    suffix = {"16x16": "", "2x16x16": "__pod2", "1": "__card"}[mesh]
    suffix += "_measured" if measured else ""
    return f"{_norm(arch)}__{shape}{suffix}{('__' + tag) if tag else ''}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=MESHES, default="16x16")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (as --mesh 2x16x16)")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape x mesh, static leg")
    ap.add_argument("--measure", action="store_true",
                    help="the measured leg on the CUDA card (mesh 1)")
    ap.add_argument("--layers", type=int, help="measured: cut the depth")
    ap.add_argument("--batch", type=int,
                    help="measured: cut the batch (default: fit_batch)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--accum", type=int, default=1,
                    help="a training step's microbatches")
    ap.add_argument("--moe-local", nargs="?", const="local", default=False,
                    help="MoE dispatch mode: (no value)=local, or local2")
    ap.add_argument("--no-remat", action="store_true",
                    help="no recompute in the backward (cfg.remat off)")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    variants = {"accum": args.accum, "moe_local": args.moe_local,
                "no_remat": args.no_remat}

    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mesh in MESHES:
                    name = record_name(arch, shape, mesh, args.tag)
                    path = os.path.join(args.out, name)
                    if os.path.exists(path) and not args.force:
                        print(f"[cached] {name}")
                        continue
                    rec = run_cell(arch, shape, mesh=mesh, tag=args.tag,
                                   **variants)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[{rec['status']}] {name}")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    mesh = "1" if args.measure else ("2x16x16" if args.multi_pod
                                     else args.mesh)
    t0 = time.time()
    try:
        if args.measure:
            rec = measure_cell(args.arch, args.shape, layers=args.layers,
                               batch=args.batch, tag=args.tag, **variants)
        else:
            rec = run_cell(args.arch, args.shape, mesh=mesh, tag=args.tag,
                           **variants)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh,
               "status": "error", "error": traceback.format_exc()[-6000:]}
    rec["wall_s"] = time.time() - t0
    path = os.path.join(args.out, record_name(args.arch, args.shape, mesh,
                                              args.tag, args.measure))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "error"},
                     indent=1)[:2000])
    if rec["status"] == "error":
        print(rec["error"][-3000:], file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
