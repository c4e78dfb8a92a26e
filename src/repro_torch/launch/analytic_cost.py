"""Analytic compute/memory cost model — exact for the major ops of the
port's model code (every matmul and einsum in ``repro_torch.models`` is
enumerated here).

Counterpart of ``repro.launch.analytic_cost``: the same formulas, names
and defaults, so a cell costs the same in both packages.  Why analytic
here: ``torch.profiler``'s ``with_flops`` counts only aten matmuls
(``mm``, ``addmm``, ``bmm``, …). It sees no hand kernel
(``recurrence_sweep.cu`` and the other CUDA sources launch through
ctypes) and no FLOPs of the chunked attention loop's elementwise passes,
so a profiled count is a lower bound on the work, never the work itself.
All formulas below are 2*M*N*K per matmul (fwd); training multiplies by
3 (bwd ~ 2x fwd) and adds the remat re-forward where enabled (x1 extra
fwd for the trunk).

Memory term (device-memory bytes/device/step) counts, per device:
  * parameter traffic: every weight shard is read once per use; gathered
    weights are written+read once per layer visit,
  * activation traffic: rw_factor x the major activation tensors per layer,
  * decode KV/state cache read (+ write of the updated slice/one-hot pass),
  * optimizer state read+write (train),
  * logits/loss traffic.
These are steady-state lower bounds (fusion-friendly); documented per term.
``model_shards`` defaults to 16, the reference's 16x16 mesh, for parity;
callers pass the shards of the deployment they describe (1 for one card).
"""

from __future__ import annotations

import dataclasses


BF16 = 2
F32 = 4


@dataclasses.dataclass
class Cost:
    flops: float = 0.0            # global FLOPs per step
    weight_bytes: float = 0.0     # per-device bytes from weights/opt
    act_bytes: float = 0.0        # per-device bytes from activations
    cache_bytes: float = 0.0      # per-device bytes from decode caches

    @property
    def bytes_per_device(self) -> float:
        return self.weight_bytes + self.act_bytes + self.cache_bytes


def _layer_matmul_flops(cfg, B, S, kind: str) -> tuple[float, float]:
    """(per-attn-layer, per-mlp) fwd matmul flops for full-seq passes."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    T = B * S
    attn_proj = 2.0 * T * D * (H * hd) + 2.0 * 2.0 * T * D * (KV * hd) \
        + 2.0 * T * (H * hd) * D
    mlp = 3 * 2.0 * T * D * cfg.d_ff
    return attn_proj, mlp


def _attention_flops(cfg, B, S, n_layers, *, window=0, causal=True,
                     kv_len=None) -> float:
    H, hd = cfg.n_heads, cfg.hd
    Sk = kv_len if kv_len is not None else (min(window, S) if window else S)
    f = 4.0 * B * S * Sk * H * hd * n_layers
    if causal and kv_len is None and not window:
        f *= 0.5
    return f


def _moe_flops(cfg, B, S) -> float:
    T = B * S
    f = 3 * 2.0 * T * cfg.top_k * cfg.d_model * cfg.expert_d_ff
    f += 2.0 * T * cfg.d_model * cfg.n_experts  # router
    if cfg.shared_expert:
        f += 3 * 2.0 * T * cfg.d_model * cfg.expert_d_ff
    return f


def _ssd_flops(cfg, B, S) -> float:
    """Mamba-2 SSD per the chunked einsums in models/ssm.py (fwd)."""
    di, H, P, N, Q = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state, cfg.ssm_chunk
    T = B * S
    proj = 2.0 * T * cfg.d_model * (2 * di + 2 * N + H) \
        + 2.0 * T * di * cfg.d_model            # in/out projections
    scores = 2.0 * T * Q * N                     # C.B within chunk
    intra = 2.0 * T * Q * H * P                  # W @ X
    states = 2.0 * T * N * H * P * 2             # chunk states + Y_inter
    conv = 2.0 * T * (di + 2 * N) * cfg.conv_width
    return proj + scores + intra + states + conv


def _rglru_flops(cfg, B, S) -> float:
    R = cfg.rnn_dim
    T = B * S
    return (2.0 * T * cfg.d_model * R * 2        # in_x, in_gate
            + 2.0 * T * R * R * 2                # w_a, w_i
            + 2.0 * T * R * cfg.d_model          # out
            + 10.0 * T * R)                      # scan/gates elementwise


def _unembed_flops(cfg, tokens) -> float:
    return 2.0 * tokens * cfg.d_model * cfg.vocab


def flops_for_cell(cfg, kind: str, B: int, S: int) -> dict:
    """Global FLOPs per step, split into components."""
    fam = cfg.family
    train_mult = 3.0 if kind == "train" else 1.0
    if kind == "train" and cfg.remat:
        train_mult += 1.0        # recompute of the trunk's fwd
    tokens = B if kind == "decode" else B * S
    comp: dict[str, float] = {}

    if kind == "decode":
        # parameter-linear part: 2 * N_active per token (computed by caller
        # via params; here count matmuls directly at S=1)
        B1, S1 = B, 1
    else:
        B1, S1 = B, S

    if fam in ("dense", "moe"):
        ap, mlp = _layer_matmul_flops(cfg, B1, S1, kind)
        L = cfg.n_layers
        comp["proj"] = ap * L
        comp["ffn"] = (_moe_flops(cfg, B1, S1) if fam == "moe" else mlp) * L
        kv_len = S if kind == "decode" else None
        comp["attention"] = _attention_flops(cfg, B1, S1, L, window=cfg.window,
                                             kv_len=kv_len)
    elif fam == "ssm":
        comp["ssm"] = _ssd_flops(cfg, B1, S1) * cfg.n_layers
    elif fam == "hybrid":
        pat = cfg.block_pattern
        G = cfg.n_layers // len(pat)
        n_rec = G * sum(1 for k in pat if k == "rec") + cfg.n_layers % len(pat)
        n_att = G * sum(1 for k in pat if k == "attn")
        ap, mlp = _layer_matmul_flops(cfg, B1, S1, kind)
        comp["rec"] = _rglru_flops(cfg, B1, S1) * n_rec
        comp["mlp"] = mlp * cfg.n_layers
        comp["proj"] = ap * n_att
        kv_len = min(cfg.window, S) if kind == "decode" else None
        comp["attention"] = _attention_flops(cfg, B1, S1, n_att,
                                             window=cfg.window, kv_len=kv_len)
    elif fam == "vlm":
        k = cfg.cross_attn_every
        G = cfg.n_layers // k
        ap, mlp = _layer_matmul_flops(cfg, B1, S1, kind)
        comp["proj"] = ap * cfg.n_layers
        comp["ffn"] = mlp * cfg.n_layers
        comp["img_proj"] = 2.0 * B * cfg.n_img_tokens * cfg.vision_dim * cfg.d_model
        kv_len = S if kind == "decode" else None
        comp["attention"] = _attention_flops(cfg, B1, S1, G * (k - 1),
                                             kv_len=kv_len)
        comp["cross_attention"] = _attention_flops(
            cfg, B1, S1, G, causal=False, kv_len=cfg.n_img_tokens)
    elif fam == "encdec":
        F = cfg.n_frames
        ap, mlp = _layer_matmul_flops(cfg, B1, S1, kind)
        ap_enc, mlp_enc = _layer_matmul_flops(cfg, B, F, kind)
        if kind == "decode":
            comp["enc"] = 0.0   # encoder ran at prefill; cache holds memory
        else:
            comp["enc"] = (ap_enc + mlp_enc) * cfg.enc_layers \
                + _attention_flops(cfg, B, F, cfg.enc_layers, causal=False)
        comp["dec_proj"] = (ap * 2 + mlp) * cfg.dec_layers  # self+cross attn
        kv_len = S if kind == "decode" else None
        comp["dec_self"] = _attention_flops(cfg, B1, S1, cfg.dec_layers,
                                            kv_len=kv_len)
        comp["dec_cross"] = _attention_flops(cfg, B1, S1, cfg.dec_layers,
                                             causal=False, kv_len=F)
    else:
        raise ValueError(fam)

    comp["unembed"] = _unembed_flops(cfg, tokens)
    total_fwd = sum(comp.values())
    total = total_fwd * train_mult
    return {"components_fwd": comp, "fwd": total_fwd, "train_mult": train_mult,
            "total": total}


def bytes_for_cell(cfg, kind: str, B: int, S: int, *, n_dev: int,
                   params_total: float, params_active: float,
                   cache_bytes_total: float, model_shards: int = 16,
                   data_shards: int | None = None) -> dict:
    """Per-device device-memory bytes per step (documented steady-state
    model).

    Weight traffic assumes the model-axis shard of each weight stays local
    (never gathered over 'model'); gathering over the data axes shows up in
    the *collective* term (measured from the trace's collectives), and its
    device-memory echo is the write+read of the per-device gathered tile —
    which is exactly params/model_shards per pass. Activation traffic
    counts ``rw`` passes of the (per-device) residual-width tensor per
    layer. Decode counts one full cache read + the one-hot masked rewrite
    (the reference's baseline cache-update strategy).
    """
    tokens = B if kind == "decode" else B * S
    if data_shards is None:
        data_shards = max(min(B, n_dev // model_shards), 1)
    out: dict[str, float] = {}

    gathered_tile = params_total * BF16 / model_shards
    if kind == "train":
        opt_b = 2 if cfg.opt_dtype == "bfloat16" else 4
        passes = 3.0 + (1.0 if cfg.remat else 0.0)   # fwd, (re-fwd), bwd x2
        out["weights"] = passes * 2.0 * gathered_tile
        out["grads_opt"] = (params_total / n_dev) * (2 * BF16 + 4 * opt_b + F32)
    else:
        out["weights"] = 2.0 * params_active * BF16 / model_shards

    act_elems = (tokens / data_shards) * cfg.d_model
    depth = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
    rw = 8.0 if kind == "train" else 4.0
    out["activations"] = act_elems * depth * rw * BF16

    if kind == "decode":
        out["cache"] = cache_bytes_total / n_dev * 1.5   # read + one-hot write
    else:
        vocab_tile = cfg.vocab / model_shards
        passes = 2.0 if kind == "train" else 0.05        # loss rw vs last-tok
        out["logits"] = (tokens / data_shards) * vocab_tile * F32 * passes

    total = sum(out.values())
    return {"components": out, "total": total}
