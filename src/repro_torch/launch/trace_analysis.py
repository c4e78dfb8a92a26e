"""Roofline terms and a ``torch.profiler`` trace reader for the card.

Counterpart of ``repro.launch.hlo_analysis``, which reads optimized XLA
HLO; the port has no compiled module to parse, so this module reads what
the profiler recorded of a run instead:

  * ``CARDS`` / ``card_rates`` — the card's peak rates by the name
    ``nvidia-smi`` reports (NVIDIA's data sheets, dense rates): device
    memory bytes/s, bf16 tensor-core FLOP/s, fp32 and fp64 FLOP/s outside
    the tensor cores, NVLink bytes/s each way, and device memory.  One
    table serves the solver kernels' byte floors (``chip_smoke.py``) and
    the model rooflines (``launch.dryrun``).
  * ``roofline_terms`` — the reference's compute / memory / collective
    terms at the card's rates.
  * ``model_flops`` and ``_attn_flops`` — the reference's "useful" FLOP
    count (``k · N_active · tokens`` plus attention), copied as they are.
  * ``read_trace`` — device time by kernel, by launching host op, by the
    program's span (``repro_torch.spans``) and by class (each hand kernel
    under its launch name, GEMMs, collectives, other device work), idle
    time by span, launches per name, the device's busy share of the
    traced window, the matmul FLOPs the profiler's own formula gives from
    the recorded shapes, and the collectives' bytes from the recorded
    input shapes of the ``c10d::`` ops.  The profiler records every
    launch, so no trip-count correction is needed (the reference's
    ``HloModule`` scales loop bodies by their trip counts because XLA
    lists a ``while`` body once).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import re
import tempfile


@dataclasses.dataclass(frozen=True)
class Card:
    """Peak rates of one card (dense, at its full power limit)."""

    hbm_bytes_s: float      # device memory bytes/s
    bf16_flops: float       # bf16 / fp16 tensor-core FLOP/s
    fp32_flops: float       # fp32 FLOP/s outside the tensor cores
    fp64_flops: float       # fp64 FLOP/s outside the tensor cores
    nvlink_bytes_s: float   # NVLink bytes/s each way
    memory_bytes: float     # device memory

    def flops(self, dtype: str) -> float:
        """Peak FLOP/s for work stored at ``dtype`` ("bfloat16" and
        "float16" on the tensor cores; "float32" (TF32 off) and "float64"
        outside them)."""
        return {"bfloat16": self.bf16_flops, "float16": self.bf16_flops,
                "float32": self.fp32_flops,
                "float64": self.fp64_flops}[dtype]


#: By the name ``nvidia-smi`` reports (a substring of it), from NVIDIA's
#: H100 data sheets.
CARDS = {
    "H100 80GB HBM3": Card(3.35e12, 989e12, 67e12, 34e12, 450e9, 80e9),
    "H100 PCIe": Card(2.0e12, 756e12, 51e12, 26e12, 300e9, 80e9),
    "H100 NVL": Card(3.9e12, 835e12, 60e12, 30e12, 300e9, 94e9),
}
#: The card the static records are priced for.
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def card_rates(name: str) -> Card:
    """The rates of the card whose reported name contains a ``CARDS`` key;
    raises ``KeyError`` for a card with no recorded rates."""
    for key, card in CARDS.items():
        if key in name:
            return card
    raise KeyError(f"no peak rates recorded for card {name!r}")


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, *, card=DEFAULT_CARD,
                   dtype: str = "bfloat16") -> dict:
    """The reference's roofline terms at ``card``'s rates (a ``Card`` or a
    reported name): compute at the peak for ``dtype``, memory at the
    device-memory rate, collectives at the NVLink rate each way."""
    card = card if isinstance(card, Card) else card_rates(card)
    compute_s = flops_per_dev / card.flops(dtype)
    memory_s = bytes_per_dev / card.hbm_bytes_s
    collective_s = coll_bytes_per_dev / card.nvlink_bytes_s
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        "overlap_efficiency": bound / total if total else 0.0,
    }


def model_flops(cfg, shape_kind: str, tokens: int, n_params_active: float,
                n_params_total: float, attn_flops: float) -> dict:
    """MODEL_FLOPS = k . N_active . tokens (+ attention) — the 'useful'
    fraction. k = 6 train (fwd+bwd), 2 inference."""
    k = 6.0 if shape_kind == "train" else 2.0
    mf = k * n_params_active * tokens + attn_flops
    return {"model_flops": mf, "n_params_total": n_params_total,
            "n_params_active": n_params_active, "k": k,
            "attn_flops": attn_flops}


def _attn_flops(cfg, kind, B, S):
    """Documented approximation of 'useful' attention/SSD FLOPs (the part of
    MODEL_FLOPS not captured by k*N*D).  The reference's arithmetic, kept
    as it is for parity (the ssm branch's ``* 0`` term included)."""
    hd, H = cfg.hd, cfg.n_heads
    mult = 3.0 if kind == "train" else 1.0  # bwd ~ 2x fwd

    def self_attn(n_layers, s_eff, causal=True):
        if kind == "decode":
            return 4.0 * B * s_eff * H * hd * n_layers
        f = 4.0 * B * S * s_eff * H * hd * n_layers
        return f * (0.5 if causal else 1.0)

    fam = cfg.family
    if fam in ("dense", "moe"):
        return mult * self_attn(cfg.n_layers, S)
    if fam == "hybrid":
        pat = cfg.block_pattern
        n_attn = (cfg.n_layers // len(pat)) * sum(1 for k in pat if k == "attn")
        w = min(cfg.window, S)
        return mult * self_attn(n_attn, w)
    if fam == "ssm":
        # SSD intra-chunk + state flops per layer ~ 2BS(Q(N+P) + 2NP); the
        # reference's expression, its zeroed first term included
        Q, N, P = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_head_dim
        per_tok = 2.0 * (Q * (N + P) + 2 * N * P) * cfg.ssm_heads * 0 + \
            2.0 * (Q * N + Q * P + 2 * N * P)
        toks = B if kind == "decode" else B * S
        return mult * per_tok * toks * cfg.d_inner / cfg.ssm_head_dim
    if fam == "vlm":
        k = cfg.cross_attn_every
        G = cfg.n_layers // k
        f = self_attn(G * (k - 1), S)
        fc = self_attn(G, cfg.n_img_tokens, causal=False)
        return mult * (f + fc)
    if fam == "encdec":
        F = cfg.n_frames
        if kind == "decode":
            self_f = 4.0 * B * S * H * hd * cfg.dec_layers
            cross_f = 4.0 * B * F * H * hd * cfg.dec_layers
            return self_f + cross_f
        enc = 4.0 * B * F * F * H * hd * cfg.enc_layers
        dec = 4.0 * B * S * S * H * hd * cfg.dec_layers * 0.5
        cross = 4.0 * B * S * F * H * hd * cfg.dec_layers
        return mult * (enc + dec + cross)
    return 0.0


# ---------------------------------------------------------------------------
# The trace reader
# ---------------------------------------------------------------------------

#: Bytes of an element by the type name the profiler records.
_TYPE_BYTES = {
    "bool": 1, "unsigned char": 1, "signed char": 1, "c10::Float8_e4m3fn": 1,
    "c10::Float8_e5m2": 1, "short int": 2, "c10::Half": 2,
    "c10::BFloat16": 2, "int": 4, "float": 4, "long int": 8, "double": 8,
    "c10::complex<float>": 8, "c10::complex<double>": 16,
}
#: Host ops whose FLOPs the profiler's ``with_flops`` formula counts as
#: matmuls (2·M·K·N, times the batch for ``bmm`` / ``baddbmm``).
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
# The hand kernels' symbols (``kernels/csrc``) and the launch names their
# wrappers count in ``ops.LAUNCHES``; a recurrence symbol carries its
# order and direction as template arguments <S, C, ORDER, REVERSE>.
_RECURRENCE_SYMBOL = re.compile(
    r"recurrence(?:_tile)?_kernel<[^,<>]+,\s*[^,<>]+,\s*(\d+),\s*(true|false)")
_HAND_PREFIXES = (("shared_", "shared_sweep"), ("batch_", "batch_sweep"),
                  ("fused_cn_tridiag", "fused_cn_tridiag"),
                  ("fused_cn_penta", "fused_cn_penta"),
                  ("fused_", "fused_cn"))
_GEMM_SYMBOL = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce",
                          re.IGNORECASE)


def _symbol(name: str) -> str:
    """A kernel's function name without its return type, namespaces and
    arguments: ``void (anonymous namespace)::foo<float, 1>(float const*)``
    -> ``foo<float, 1>``."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].strip()
    head = head[len("void "):] if head.startswith("void ") else head
    base, sep, args = head.partition("<")
    return base.rsplit("::", 1)[-1] + sep + args


def launch_name(kernel: str) -> str | None:
    """The launch name of a hand kernel of ``kernels/csrc`` (``recur1``,
    ``recur2_rev``, ``shared_sweep``, ``batch_sweep``,
    ``fused_cn_tridiag``, ``fused_cn_penta``, ``fused_cn`` for the
    partitioned route's shared stages), or None for any other kernel."""
    sym = _symbol(kernel)
    m = _RECURRENCE_SYMBOL.match(sym)
    if m:
        return f"recur{m.group(1)}" + ("_rev" if m.group(2) == "true" else "")
    for prefix, name in _HAND_PREFIXES:
        if sym.startswith(prefix):
            return name
    return None


def _elements(dims) -> int:
    """Elements of one recorded input: a shape, or a tensor list's shapes."""
    if not dims:
        return 0
    if isinstance(dims[0], list):
        return sum(math.prod(d) for d in dims if d)
    return math.prod(dims)


def _matmul_flops(name: str, dims: list) -> float:
    """The profiler's formula for a matmul op from its recorded shapes."""
    a, b = dims[1:3] if name in ("aten::addmm", "aten::baddbmm") \
        else dims[:2]
    if name in ("aten::mm", "aten::addmm"):
        return 2.0 * a[0] * a[1] * b[1]
    return 2.0 * a[0] * a[1] * a[2] * b[2]


def _load(source) -> list:
    """The trace events of a profiler result, a chrome-trace dict, or the
    path of an exported chrome-trace JSON."""
    if hasattr(source, "export_chrome_trace"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            source.export_chrome_trace(path)
            with open(path) as f:
                source = json.load(f)
    elif isinstance(source, (str, os.PathLike)):
        with open(source) as f:
            source = json.load(f)
    return [e for e in source["traceEvents"] if e.get("ph") == "X"]


def _comm_bytes(op: dict, events: list) -> float:
    """Bytes of a ``c10d::`` op's inputs: its recorded shapes at the type
    it records, or, where it records only a ``TensorList``, at the dtype of
    the backend's own record of the same call (NCCL's
    ``record_param_comms`` inside its span, or gloo's
    ``gloo:<collective>`` annotation of the same shapes)."""
    args = op.get("args", {})
    dims, types = args.get("Input Dims", []), args.get("Input type", [])
    total = 0.0
    for d, t in zip(dims, types):
        n = _elements(d)
        if not n:
            continue
        size = _TYPE_BYTES.get(t)
        if size is None:
            size = _list_itemsize(op, d, events)
        total += n * size
    return total


def _list_itemsize(op: dict, dims, events: list) -> int:
    end = op["ts"] + op.get("dur", 0)
    for e in events:
        a = e.get("args", {})
        if e["name"] == "record_param_comms" and e.get("tid") == op.get(
                "tid") and op["ts"] <= e["ts"] <= end:
            dtype = str(a.get("dtype", "")).lower()
            for key, size in (("bfloat16", 2), ("half", 2), ("float", 4),
                              ("double", 8), ("long", 8), ("int", 4),
                              ("byte", 1), ("char", 1), ("bool", 1)):
                if key in dtype:
                    return size
        if e.get("cat") == "user_annotation" and ":" in e["name"] and \
                a.get("Input Dims") and a["Input Dims"][0] in dims:
            size = _TYPE_BYTES.get(a.get("Input type", [""])[0])
            if size:
                return size
    raise ValueError(f"{op['name']} at ts={op['ts']}: no dtype recorded for "
                     "its tensor list")


def _union_us(intervals: list) -> float:
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _nesting(events: list) -> tuple:
    """``(nested, launched_by)``: the ids of the host ops (``cpu_op``) that
    are the only child of a host op of the same name (the profiler's own
    tables fold these into their parent, as one call), and, by correlation
    id, the innermost host op around the runtime or driver call that
    launched a device op; per host thread."""
    by_tid: dict = {}
    for e in events:
        if e.get("cat") in _HOST_CATS:
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    parent, children, launched_by = {}, {}, {}
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: list = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) \
                    <= e["ts"]:
                stack.pop()
            if stack:
                parent[id(e)] = (e["name"], stack[-1])
                children[id(stack[-1])] = children.get(id(stack[-1]), 0) + 1
            if e["cat"] in ("cpu_op", "user_annotation"):
                stack.append(e)
            elif "correlation" in e.get("args", {}):
                ops = [o for o in stack if o["cat"] == "cpu_op"]
                launched_by[e["args"]["correlation"]] = \
                    ops[-1]["name"] if ops else None
    nested = {i for i, (name, p) in parent.items()
              if p["name"] == name and children[id(p)] == 1}
    return nested, launched_by


class _Spans:
    """The program's spans (``repro_torch.spans.chrome_events``) sorted by
    start, to find the innermost one open at a time."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.spans]
        self.reach, top = [], -math.inf
        for e in self.spans:
            top = max(top, e["ts"] + e["dur"])
            self.reach.append(top)

    def at(self, t: float):
        """The name of the latest-starting span open at ``t``, on any
        thread (autograd's worker opens its spans inside the caller's);
        None when none is open."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.reach[i] < t:
                break
            e = self.spans[i]
            if e["ts"] + e["dur"] >= t:
                return e["name"]
        return None


def _by_span(events: list, spans: list) -> dict:
    """Device ms by the innermost span open at the midpoint of each device
    op's launch call (by correlation id), and idle ms by the span open at
    each gap's midpoint; None for no span.  Spans are matched by time, not
    by thread: a profile of device activity alone labels its runtime calls
    by another thread id than a profile with CPU activity does."""
    found = _Spans(spans)
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    device_ms: dict = {}
    busy = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0))
        busy.append((start, start + dur))
        call = calls.get(e.get("args", {}).get("correlation"))
        name = None if call is None else found.at(
            call["ts"] + call.get("dur", 0) / 2)
        device_ms[name] = device_ms.get(name, 0.0) + dur / 1e3
    idle_ms: dict = {}
    end = None
    for s, e in sorted(busy):
        if end is not None and s > end:
            name = found.at((end + s) / 2)
            idle_ms[name] = idle_ms.get(name, 0.0) + (s - end) / 1e3
        end = e if end is None else max(end, e)
    return {"device_ms_by_span": device_ms, "idle_ms_by_span": idle_ms}


def read_trace(source, spans=None) -> dict:
    """Read a ``torch.profiler`` trace (the profiler, or its exported
    chrome-trace JSON as a dict or a path) into:

    ``device_ms_by_kernel``: each device op's ms by kernel name (a hand
    kernel under its launch name, ``launch_name``); ``device_ms_by_op``:
    by the host op that launched it (``None`` for the hand kernels, which
    launch from Python); ``device_ms_by_class``: ``hand:<launch name>``,
    ``gemm`` (a kernel launched by one of ``MATMUL_OPS`` or with a
    cuBLAS / CUTLASS symbol), ``collective`` (NCCL kernels) and ``other``
    (every other kernel, copy and fill); ``launches``: device ops by
    kernel symbol (template arguments kept: a hand kernel's route and
    instantiation), and ``hand_launches`` those of the hand kernels alone,
    by launch name
    (the counterpart of ``ops.LAUNCHES``); ``host_ops``: host op counts by
    name, a call nested in one of its own name counted once, as the
    profiler's ``key_averages`` counts it;
    ``window_ms`` and ``busy_ms``: the traced window, from the first host
    op, runtime call or device op to the last (user annotations, such as
    the program's spans, are not counted), and the union of the device
    ops' intervals
    in it; ``busy_share``: their ratio (0 in a trace with no device op);
    ``matmul_flops``: the profiler's matmul formula over the recorded
    shapes of ``MATMUL_OPS``; ``collectives``: bytes and counts of the
    ``c10d::`` ops by op, from their recorded input shapes.

    Handed the program's spans of the same run as ``spans``
    (``repro_torch.spans.chrome_events`` on the trace's
    ``baseTimeNanoseconds``), it adds ``device_ms_by_span``: each device
    op's ms by the innermost span around the runtime call that launched
    it, and ``idle_ms_by_span``: each gap between the device's busy
    intervals by the span open on the host at the gap's midpoint (None
    for time outside every span)."""
    events = _load(source)
    nested, launched_by = _nesting(events)
    by_kernel: dict = {}
    by_op: dict = {}
    by_class: dict = {}
    launches: dict = {}
    hand_launches: dict = {}
    host_ops: dict = {}
    busy, extent = [], []
    flops = 0.0
    colls: dict = {}
    for e in events:
        cat = e.get("cat")
        start, dur = float(e["ts"]), float(e.get("dur", 0))
        if cat in _DEVICE_CATS:
            busy.append((start, start + dur))
            extent.append((start, start + dur))
            ms = dur / 1e3
            hand = launch_name(e["name"]) if cat == "kernel" else None
            sym = _symbol(e["name"]) if cat == "kernel" else e["name"]
            name = hand or sym
            op = launched_by.get(e.get("args", {}).get("correlation"))
            if hand:
                cls = f"hand:{hand}"
            elif cat == "kernel" and "nccl" in e["name"].lower():
                cls = "collective"
            elif cat == "kernel" and (op in MATMUL_OPS
                                      or _GEMM_SYMBOL.search(e["name"])):
                cls = "gemm"
            else:
                cls = "other"
            by_kernel[name] = by_kernel.get(name, 0.0) + ms
            by_op[op] = by_op.get(op, 0.0) + ms
            by_class[cls] = by_class.get(cls, 0.0) + ms
            launches[sym] = launches.get(sym, 0) + 1
            if hand:
                hand_launches[hand] = hand_launches.get(hand, 0) + 1
        elif cat in _HOST_CATS:
            if cat != "user_annotation":
                extent.append((start, start + dur))
            if cat != "cpu_op" or id(e) in nested:
                continue
            name = e["name"]
            host_ops[name] = host_ops.get(name, 0) + 1
            dims = e.get("args", {}).get("Input Dims")
            if name in MATMUL_OPS and dims:
                flops += _matmul_flops(name, dims)
            if name.startswith("c10d::"):
                c = colls.setdefault(name, {"bytes": 0.0, "count": 0})
                c["bytes"] += _comm_bytes(e, events)
                c["count"] += 1
    window = (max(s[1] for s in extent) - min(s[0] for s in extent)) \
        if extent else 0.0
    busy_us = _union_us(busy)
    return {"device_ms_by_kernel": by_kernel, "device_ms_by_op": by_op,
            "device_ms_by_class": by_class, "launches": launches,
            "hand_launches": hand_launches,
            "host_ops": host_ops, "window_ms": window / 1e3,
            "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / window if window and busy else 0.0,
            "matmul_flops": flops,
            "collectives": {"by_op": colls, "total_bytes": sum(
                c["bytes"] for c in colls.values())},
            **({} if spans is None else _by_span(events, spans))}


def top_ops(ms_by_name: dict, n: int = 5) -> list:
    """The ``n`` largest entries of a ms-by-name map, largest first."""
    return sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:n]
