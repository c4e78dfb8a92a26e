"""Model assembly: the serving and training paths of every family.

Counterpart of ``repro.models.model``:

  dense  — decoder-only LM, GQA/MQA (granite-3-8b, granite-34b, ...);
  moe    — decoder-only with token-choice top-k MoE (dbrx-132b, kimi-k2),
           the same blocks with ``models.moe`` as the MLP and its aux losses
           (``lb_loss``, ``router_z``) summed over layers;
  ssm    — Mamba-2 SSD stack, attention-free (mamba2-130m);
  hybrid — RecurrentGemma: the (RG-LRU, RG-LRU, local-attn) pattern plus a
           tail of RG-LRU layers, the attention KV cache a ring of
           ``min(window, seq)`` slots (recurrentgemma-9b);
  encdec — encoder-decoder with cross-attention (seamless-m4t-large-v2):
           ``batch["frames"]`` (B, n_frames, d_model), the audio frontend's
           stub, through a non-causal encoder; each decoder layer attends
           to itself and to the encoder's output, whose K/V (``mem_k``,
           ``mem_v``) the prefill writes once;
  vlm    — decoder LM with a gated cross-attention block to the image
           tokens after every ``cross_attn_every - 1`` self blocks
           (llama-3.2-vision-90b): ``batch["img_embed"]`` (B, n_img_tokens,
           vision_dim), the vision frontend's stub, projected to d_model;
           the image K/V (``img_k``, ``img_v``) written once by the prefill.

``param_specs``, ``cache_specs``, ``init_cache``, ``prefill_fn``,
``decode_fn`` and ``loss_fn`` are plain functions on nested dicts of
tensors, under the JAX names.  The layer stack is a loop over parameters
stacked along a leading ``layers`` axis (JAX's ``lax.scan``; two such axes
for the vlm family's groups of self blocks).  ``Model`` is the
``nn.Module`` that holds the parameters on one device and serves
``prefill`` / ``decode``; ``build_model`` makes one.  Every family trains:
``loss_fn`` (the chunked cross-entropy over the trunk, each layer body
under ``torch.utils.checkpoint`` when ``cfg.remat``, as JAX wraps it in
``jax.checkpoint``) is differentiated by ``repro_torch.train``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import ShardingCtx
from repro_torch.solver.system import resolve_device
from .config import ArchConfig
from .layers import (_acc, _dt, attention_apply, attention_prefill_kv,
                     attention_specs, cache_write, decode_attention,
                     mlp_apply, mlp_apply_1tok, mlp_specs, rmsnorm, rope)
from .params import (ParamSpec, abstract_params, check_tree, init_params,
                     tree_leaves, tree_map)
from .rglru import rglru_apply, rglru_decode_step, rglru_specs
from .ssm import ssm_apply, ssm_decode_step, ssm_specs
from .transformer import block_apply, block_decode, block_prefill_kv, block_specs

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# the logical name of a cache's sequence axis: the one a serving driver grows
SEQ_AXIS = "act_kv_seq"
# the cache leaves that hold a frontend's memory (the encoder's output, the
# image tokens): JAX names their length ``act_kv_seq`` too, but it is the
# frontend's, fixed by the prefill, and no serving budget grows it
MEMORY_LEAVES = {"encdec": ("mem_k", "mem_v"), "vlm": ("img_k", "img_v")}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def memory_leaves(cfg: ArchConfig) -> tuple:
    """The keys of ``cfg``'s cache leaves that hold a frontend's memory."""
    return MEMORY_LEAVES.get(cfg.family, ())


def stack_specs(tree, n: int):
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.names,
                                        s.dtype, s.init, s.scale), tree)


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` recomputed in the backward pass (non-reentrant checkpoint:
    only its inputs are kept) when ``cfg.remat``."""
    if not cfg.remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ===========================================================================
# parameter and cache spec trees
# ===========================================================================

def _embed_specs(cfg: ArchConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab
    dt = _dt(cfg)
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed"), dt,
                           scale=1.0 / math.sqrt(D)),
        "ln_f": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "unembed": ParamSpec((D, V), ("embed", "vocab"), dt),
    }


def _rec_layer_specs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    return {
        "ln1": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "temporal": rglru_specs(cfg),
        "ln2": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "mlp": mlp_specs(cfg),
    }


def _ssm_layer_specs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    return {
        "ln": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "ssm": ssm_specs(cfg),
    }


def _hybrid_layout(cfg: ArchConfig) -> tuple:
    """(groups, tail layers, [(key, kind)] of a group): ``n_layers`` cut
    into groups of ``block_pattern``, the remainder RG-LRU layers."""
    pat = cfg.block_pattern
    groups, rem = divmod(cfg.n_layers, len(pat))
    return groups, rem, [(f"l{i}_{kind}", kind) for i, kind in enumerate(pat)]


def _dec_layer_specs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    return {
        "ln1": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "self_attn": attention_specs(cfg),
        "ln2": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "cross_attn": attention_specs(cfg),
        "ln3": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "mlp": mlp_specs(cfg),
    }


def param_specs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    specs = _embed_specs(cfg)
    D = cfg.d_model
    if cfg.family in ("dense", "moe"):
        specs["blocks"] = stack_specs(
            block_specs(cfg, moe=cfg.family == "moe"), cfg.n_layers)
    elif cfg.family == "ssm":
        specs["blocks"] = stack_specs(_ssm_layer_specs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        G, rem, keys = _hybrid_layout(cfg)
        specs["groups"] = stack_specs(
            {key: _rec_layer_specs(cfg) if kind == "rec" else block_specs(cfg)
             for key, kind in keys}, G)
        if rem:
            specs["tail"] = stack_specs(_rec_layer_specs(cfg), rem)
    elif cfg.family == "encdec":
        specs["frame_proj"] = ParamSpec((D, D), ("embed", None), _dt(cfg))
        specs["enc_blocks"] = stack_specs(block_specs(cfg), cfg.enc_layers)
        specs["enc_ln"] = ParamSpec((D,), (None,), torch.float32,
                                    init="zeros")
        specs["dec_blocks"] = stack_specs(_dec_layer_specs(cfg),
                                          cfg.dec_layers)
    else:
        k = cfg.cross_attn_every
        specs["img_proj"] = ParamSpec((cfg.vision_dim, D), (None, "embed"),
                                      _dt(cfg))
        specs["groups"] = stack_specs(
            {"selfs": stack_specs(block_specs(cfg), k - 1),
             "cross": block_specs(cfg, kind="cross")}, cfg.n_layers // k)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Decode-time state.  ``seq`` sizes the sequence axes (named
    ``act_kv_seq``): the attention families' K/V caches of ``seq`` slots,
    the hybrid family's ring of ``min(window, seq)``; the ssm state and the
    RG-LRU state have none.  The encdec and vlm memories (``MEMORY_LEAVES``)
    carry the same name at the frontend's length, ``n_frames`` or
    ``n_img_tokens``, whatever ``seq`` is."""
    _check_family(cfg)
    dt = _dt(cfg)
    names = ("layers", "act_batch", "act_kv", SEQ_AXIS, "act_head_dim")

    def kv(n_layers, s):
        return ParamSpec((n_layers, batch, cfg.n_kv_heads, s, cfg.hd), names,
                         dt, init="zeros")

    if cfg.family in ("dense", "moe"):
        return {"k": kv(cfg.n_layers, seq), "v": kv(cfg.n_layers, seq)}
    if cfg.family == "hybrid":
        G, rem, keys = _hybrid_layout(cfg)
        R, W = cfg.rnn_dim, cfg.conv_width
        ring = kv(G, min(cfg.window, seq))

        def rec_state(n):
            return {
                "h": ParamSpec((n, batch, R), ("layers", "act_batch",
                                               "act_mlp"), torch.float32,
                               init="zeros"),
                "conv": ParamSpec((n, batch, W - 1, R),
                                  ("layers", "act_batch", None, "act_mlp"),
                                  dt, init="zeros"),
            }
        out = {"groups": {key: rec_state(G) if kind == "rec"
                          else {"k": ring, "v": ring} for key, kind in keys}}
        if rem:
            out["tail"] = rec_state(rem)
        return out
    if cfg.family == "encdec":
        L, F = cfg.dec_layers, cfg.n_frames
        return {"k": kv(L, seq), "v": kv(L, seq),
                "mem_k": kv(L, F), "mem_v": kv(L, F)}
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        G = cfg.n_layers // k
        selfs = ParamSpec((G, k - 1, batch, cfg.n_kv_heads, seq, cfg.hd),
                          ("layers",) + names, dt, init="zeros")
        return {"k": selfs, "v": selfs,
                "img_k": kv(G, cfg.n_img_tokens),
                "img_v": kv(G, cfg.n_img_tokens)}
    L, H, P, N = cfg.n_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W, di = cfg.conv_width, cfg.d_inner
    return {
        "state": ParamSpec((L, batch, H, P, N),
                           ("layers", "act_batch", None, None, None),
                           torch.float32, init="zeros"),
        "conv_x": ParamSpec((L, batch, W - 1, di),
                            ("layers", "act_batch", None, "act_mlp"), dt,
                            init="zeros"),
        "conv_B": ParamSpec((L, batch, W - 1, N),
                            ("layers", "act_batch", None, None), dt,
                            init="zeros"),
        "conv_C": ParamSpec((L, batch, W - 1, N),
                            ("layers", "act_batch", None, None), dt,
                            init="zeros"),
    }


def init_cache(cfg: ArchConfig, batch: int, seq: int, *, device) -> dict:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_specs(cfg, batch, seq))


# ===========================================================================
# shared pieces
# ===========================================================================

def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of parameters stacked along a leading ``layers`` axis."""
    return tree_map(lambda t: t[i], stacked)


def _layers(stacked: dict) -> list:
    """Every layer of a stacked tree, each leaf unbound once: under
    autograd the gradient of the stacked leaf is then one ``stack``, not
    one full-size scatter a layer."""
    flat = tree_map(lambda t: torch.unbind(t, 0), stacked)
    n = len(tree_leaves(flat)[0])
    return [tree_map(lambda per, i=i: per[i], flat) for i in range(n)]


def _embed_tokens(params, tokens, sctx: ShardingCtx, cfg: ArchConfig):
    x = F.embedding(tokens, params["embed"])
    return sctx.constrain(x, ("act_batch", "act_res_seq", None))


def _logits_1tok(params, x, sctx: ShardingCtx, cfg: ArchConfig):
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = (x @ params["unembed"]).to(_acc(x.dtype))
    return sctx.constrain(logits, ("act_batch", "act_vocab"))


# ===========================================================================
# the training forward pass and loss
# ===========================================================================

def ce_loss_chunked(x, unembed, labels, sctx: ShardingCtx, chunk: int = 512):
    """Cross-entropy without materialising (B, S, V) logits: the sequence
    cut into ``max(S // chunk, 1)`` equal chunks (an S that does not cut
    evenly raises, as JAX's reshape does), logits in the activations'
    dtype cast to fp32, fp32 logsumexp; labels < 0 are masked."""
    B, S, D = x.shape
    nc = max(S // chunk, 1)
    c = S // nc
    xs = torch.movedim(x.reshape(B, nc, c, D), 1, 0)
    ls = torch.movedim(labels.reshape(B, nc, c), 1, 0)
    sums, counts = [], []
    for xi, li in zip(xs, ls):
        logits = torch.einsum("bsd,dv->bsv", xi, unembed).to(torch.float32)
        logits = sctx.constrain(logits, ("act_batch", "act_seq", "act_vocab"))
        lse = torch.logsumexp(logits, dim=-1)
        mask = (li >= 0).to(torch.float32)
        gold = torch.gather(logits, -1,
                            torch.clamp(li, min=0)[..., None])[..., 0]
        sums.append(torch.sum((lse - gold) * mask))
        counts.append(torch.sum(mask))
    return torch.stack(sums).sum() / torch.clamp(torch.stack(counts).sum(),
                                                 min=1.0)


def _project_images(params, img_embed, sctx: ShardingCtx):
    """The vision stub's (B, T, vision_dim) embeddings in d_model, cast to
    the projection's dtype first (JAX casts to the config's: the same for
    a tree at the config's dtype)."""
    w = params["img_proj"]
    img_x = torch.einsum("btv,vd->btd", img_embed.to(w.dtype), w)
    return sctx.constrain(img_x, ("act_batch", "act_res_seq", None))


def _forward_trunk(params, tokens, sctx: ShardingCtx, cfg: ArchConfig, *,
                   img_embed=None):
    """Token trunk -> final hidden states (B, S, D) + aux losses: the moe
    family's summed over layers, zero for the others, which route
    nothing.  The vlm family cross-attends to ``img_embed``."""
    _check_family(cfg)
    x = _embed_tokens(params, tokens, sctx, cfg)
    aux = {"lb_loss": 0.0, "router_z": 0.0}
    if cfg.family in ("dense", "moe"):
        positions = torch.arange(tokens.shape[1], device=x.device)
        moe = cfg.family == "moe"

        def block_fn(p, x):
            return block_apply(p, x, sctx, cfg, positions=positions,
                               window=cfg.window, moe=moe)
        block_fn = _maybe_remat(block_fn, cfg)
        lb = zz = 0.0
        for p in _layers(params["blocks"]):
            x, a = block_fn(p, x)
            if moe:
                lb = lb + a["lb_loss"]
                zz = zz + a["router_z"]
        return (rmsnorm(params["ln_f"], x, cfg.norm_eps),
                {"lb_loss": lb, "router_z": zz})
    if cfg.family == "ssm":
        def body_fn(p, x):
            h, _, _ = ssm_apply(p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps),
                                sctx, cfg)
            return x + h
        body_fn = _maybe_remat(body_fn, cfg)
        for p in _layers(params["blocks"]):
            x = body_fn(p, x)
        return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux
    positions = torch.arange(tokens.shape[1], device=x.device)
    if cfg.family == "vlm":
        img_x = _project_images(params, img_embed, sctx)

        def vlm_group_fn(gp, x):
            for p in _layers(gp["selfs"]):
                x, _ = block_apply(p, x, sctx, cfg, positions=positions)
            x, _ = block_apply(gp["cross"], x, sctx, cfg, positions=positions,
                               kv_input=img_x, kind="cross", use_rope=False)
            return x
        vlm_group_fn = _maybe_remat(vlm_group_fn, cfg)
        for gp in _layers(params["groups"]):
            x = vlm_group_fn(gp, x)
        return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux
    if cfg.family != "hybrid":
        raise ValueError(cfg.family)
    _, _, keys = _hybrid_layout(cfg)

    def rec_apply(p, x):
        h, _ = rglru_apply(p["temporal"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                           sctx, cfg)
        x = x + h
        return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                             sctx)

    def group_fn(gp, x):
        for key, kind in keys:
            if kind == "rec":
                x = rec_apply(gp[key], x)
            else:
                x, _ = block_apply(gp[key], x, sctx, cfg, positions=positions,
                                   window=cfg.window)
        return x
    group_fn = _maybe_remat(group_fn, cfg)
    for gp in _layers(params["groups"]):
        x = group_fn(gp, x)
    if "tail" in params:
        tail_fn = _maybe_remat(rec_apply, cfg)
        for p in _layers(params["tail"]):
            x = tail_fn(p, x)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def _encode_frames(params, frames, sctx: ShardingCtx, cfg: ArchConfig):
    """The audio stub's encoder trunk. frames: (B, F, D) precomputed
    embeddings, cast to ``frame_proj``'s dtype (JAX: the config's); the
    blocks see every frame (no causal mask), RoPE at the frame's index."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    w = params["frame_proj"]
    x = torch.einsum("bfd,de->bfe", frames.to(w.dtype), w)
    x = sctx.constrain(x, ("act_batch", "act_res_seq", None))

    def body_fn(p, x):
        y, _ = block_apply(p, x, sctx, cfg, positions=positions, causal=False)
        return y
    body_fn = _maybe_remat(body_fn, cfg)
    for p in _layers(params["enc_blocks"]):
        x = body_fn(p, x)
    return rmsnorm(params["enc_ln"], x, cfg.norm_eps)


def _dec_layer_apply(p, x, enc_out, positions, sctx: ShardingCtx,
                     cfg: ArchConfig):
    """A decoder layer: causal self-attention, cross-attention to the
    encoder's output (no RoPE), the MLP, each on its own pre-norm."""
    h = attention_apply(p["self_attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                        sctx, cfg, positions=positions)
    x = x + h
    h = attention_apply(p["cross_attn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                        sctx, cfg, positions=positions, kv_input=enc_out,
                        use_rope=False)
    x = x + h
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln3"], x, cfg.norm_eps), sctx)


def _forward_encdec(params, tokens, frames, sctx: ShardingCtx,
                    cfg: ArchConfig):
    enc_out = _encode_frames(params, frames, sctx, cfg)
    x = _embed_tokens(params, tokens, sctx, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def body_fn(p, x):
        return _dec_layer_apply(p, x, enc_out, positions, sctx, cfg)
    body_fn = _maybe_remat(body_fn, cfg)
    for p in _layers(params["dec_blocks"]):
        x = body_fn(p, x)
    return (rmsnorm(params["ln_f"], x, cfg.norm_eps),
            {"lb_loss": 0.0, "router_z": 0.0})


def loss_fn(params, batch, sctx: ShardingCtx, cfg: ArchConfig):
    """batch: ``{"tokens", "labels"}`` (B, S) integer, plus the frontend's
    input (``frames`` for encdec, ``img_embed`` for vlm) -> (total loss,
    {"ce", "lb_loss", "router_z"})."""
    if cfg.family == "encdec":
        x, aux = _forward_encdec(params, batch["tokens"], batch["frames"],
                                 sctx, cfg)
    elif cfg.family == "vlm":
        x, aux = _forward_trunk(params, batch["tokens"], sctx, cfg,
                                img_embed=batch["img_embed"])
    else:
        x, aux = _forward_trunk(params, batch["tokens"], sctx, cfg)
    loss = ce_loss_chunked(x, params["unembed"], batch["labels"], sctx)
    total = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["router_z"]
    return total, {"ce": loss, **aux}


# ===========================================================================
# prefill and decode
# ===========================================================================

def prefill_fn(params, batch, sctx: ShardingCtx, cfg: ArchConfig):
    """Process a full prompt; return (last-token logits, decode cache)."""
    _check_family(cfg)
    x = _embed_tokens(params, batch["tokens"], sctx, cfg)
    if cfg.family in ("dense", "moe"):
        x, cache = _kv_prefill(params, x, sctx, cfg)
        return _logits_1tok(params, x[:, -1], sctx, cfg), cache
    if cfg.family == "hybrid":
        x, cache = _hybrid_prefill(params, x, sctx, cfg)
        return _logits_1tok(params, x[:, -1], sctx, cfg), cache
    if cfg.family == "encdec":
        x, cache = _encdec_prefill(params, x, batch["frames"], sctx, cfg)
        return _logits_1tok(params, x[:, -1], sctx, cfg), cache
    if cfg.family == "vlm":
        x, cache = _vlm_prefill(params, x, batch["img_embed"], sctx, cfg)
        return _logits_1tok(params, x[:, -1], sctx, cfg), cache
    outs = {"state": [], "conv_x": [], "conv_B": [], "conv_C": []}
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        h, state, tails = ssm_apply(p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps),
                                    sctx, cfg)
        x = x + h
        for key, value in (("state", state), ("conv_x", tails["x"]),
                           ("conv_B", tails["B"]), ("conv_C", tails["C"])):
            outs[key].append(value)
    cache = {k: torch.stack(v) for k, v in outs.items()}
    return _logits_1tok(params, x[:, -1], sctx, cfg), cache


def _kv_prefill(params, x, sctx: ShardingCtx, cfg: ArchConfig):
    """The dense and moe blocks; each layer's K/V cache holds every
    position of the prompt, (L, B, KV, S, hd), at the activations'
    dtype."""
    positions = torch.arange(x.shape[1], device=x.device)
    moe = cfg.family == "moe"
    cache = None
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        k, v = block_prefill_kv(p, x, cfg, positions)
        if cache is None:
            cache = {"k": k.new_empty((cfg.n_layers,) + k.shape),
                     "v": v.new_empty((cfg.n_layers,) + v.shape)}
        cache["k"][i], cache["v"][i] = k, v
        x, _ = block_apply(p, x, sctx, cfg, positions=positions,
                           window=cfg.window, moe=moe)
    return x, cache


def _stack_states(states: list) -> dict:
    """Per-layer dicts of tensors -> one dict of tensors stacked along a
    leading ``layers`` axis."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _rec_prefill(p, x, sctx: ShardingCtx, cfg: ArchConfig):
    h, (h_last, tail) = rglru_apply(
        p["temporal"], rmsnorm(p["ln1"], x, cfg.norm_eps), sctx, cfg)
    x = x + h
    x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), sctx)
    return x, {"h": h_last, "conv": tail}


def _hybrid_prefill(params, x, sctx: ShardingCtx, cfg: ArchConfig):
    """The groups, then the tail.  An attention layer's K/V cache keeps the
    last ``Wn = min(window, S)`` tokens, token p in ring slot p % Wn."""
    S = x.shape[1]
    G, rem, keys = _hybrid_layout(cfg)
    positions = torch.arange(S, device=x.device)
    Wn = min(cfg.window, S)
    slots = torch.arange(Wn, device=x.device)
    ring = (S - 1) - ((S - 1 - slots) % Wn)          # the position in each slot
    states = {key: [] for key, _ in keys}
    for g in range(G):
        gp = _layer(params["groups"], g)
        for key, kind in keys:
            if kind == "rec":
                x, st = _rec_prefill(gp[key], x, sctx, cfg)
            else:
                k, v = block_prefill_kv(gp[key], x, cfg, positions)
                x, _ = block_apply(gp[key], x, sctx, cfg, positions=positions,
                                   window=cfg.window)
                st = {"k": k[:, :, ring], "v": v[:, :, ring]}
            states[key].append(st)
    cache = {"groups": {key: _stack_states(v) for key, v in states.items()}}
    if rem:
        tail = []
        for i in range(rem):
            x, st = _rec_prefill(_layer(params["tail"], i), x, sctx, cfg)
            tail.append(st)
        cache["tail"] = _stack_states(tail)
    return x, cache


def _encdec_prefill(params, x, frames, sctx: ShardingCtx, cfg: ArchConfig):
    """The encoder over ``frames``, then the decoder layers.  A layer's
    self-attention cache holds every position of the prompt; its memory
    (``mem_k``, ``mem_v``) is the encoder's output through the layer's
    cross-attention ``wk`` / ``wv``, (L, B, KV, F, hd)."""
    enc_out = _encode_frames(params, frames, sctx, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    outs = {"k": [], "v": [], "mem_k": [], "mem_v": []}
    for p in _layers(params["dec_blocks"]):
        k, v = attention_prefill_kv(p["self_attn"],
                                    rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                                    positions)
        mk = torch.einsum("bsd,dgk->bsgk", enc_out, p["cross_attn"]["wk"])
        mv = torch.einsum("bsd,dgk->bsgk", enc_out, p["cross_attn"]["wv"])
        x = _dec_layer_apply(p, x, enc_out, positions, sctx, cfg)
        for key, value in (("k", k), ("v", v), ("mem_k", mk.transpose(1, 2)),
                           ("mem_v", mv.transpose(1, 2))):
            outs[key].append(value)
    return x, {k: torch.stack(v) for k, v in outs.items()}


def _vlm_prefill(params, x, img_embed, sctx: ShardingCtx, cfg: ArchConfig):
    """The groups: ``cross_attn_every - 1`` self blocks, each caching every
    position of the prompt, (G, k - 1, B, KV, S, hd), then the gated cross
    block, whose cache (``img_k``, ``img_v``, (G, B, KV, T, hd)) holds the
    projected image tokens through its ``wk`` / ``wv``."""
    img_x = _project_images(params, img_embed, sctx)
    positions = torch.arange(x.shape[1], device=x.device)
    outs = {"k": [], "v": [], "img_k": [], "img_v": []}
    for gp in _layers(params["groups"]):
        ks, vs = [], []
        for p in _layers(gp["selfs"]):
            k, v = block_prefill_kv(p, x, cfg, positions)
            x, _ = block_apply(p, x, sctx, cfg, positions=positions)
            ks.append(k)
            vs.append(v)
        ik, iv = block_prefill_kv(gp["cross"], x, cfg, positions,
                                  kv_input=img_x)
        x, _ = block_apply(gp["cross"], x, sctx, cfg, positions=positions,
                           kv_input=img_x, kind="cross", use_rope=False)
        for key, value in (("k", torch.stack(ks)), ("v", torch.stack(vs)),
                           ("img_k", ik), ("img_v", iv)):
            outs[key].append(value)
    return x, {k: torch.stack(v) for k, v in outs.items()}


def decode_fn(params, cache, token, pos: int, sctx: ShardingCtx,
              cfg: ArchConfig):
    """token: (B,) integer; pos: the token's position (the ssm family keeps
    no positions).  Returns (logits, new cache); ``cache`` is not
    modified."""
    _check_family(cfg)
    x = F.embedding(token, params["embed"])
    x = sctx.constrain(x, ("act_batch", None))
    if cfg.family in ("dense", "moe"):
        new_cache = {k: torch.empty_like(v) for k, v in cache.items()}
        for i in range(cfg.n_layers):
            x, new_cache["k"][i], new_cache["v"][i] = block_decode(
                _layer(params["blocks"], i), x, cache["k"][i],
                cache["v"][i], pos, sctx, cfg, moe=cfg.family == "moe")
        return _logits_1tok(params, x, sctx, cfg), new_cache
    if cfg.family == "hybrid":
        x, new_cache = _hybrid_decode(params, cache, x, pos, sctx, cfg)
        return _logits_1tok(params, x, sctx, cfg), new_cache
    if cfg.family == "encdec":
        x, new_cache = _encdec_decode(params, cache, x, pos, sctx, cfg)
        return _logits_1tok(params, x, sctx, cfg), new_cache
    if cfg.family == "vlm":
        x, new_cache = _vlm_decode(params, cache, x, pos, sctx, cfg)
        return _logits_1tok(params, x, sctx, cfg), new_cache
    new_cache = {k: torch.empty_like(v) for k, v in cache.items()}
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        h, state, bufs = ssm_decode_step(
            p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps), cache["state"][i],
            {"x": cache["conv_x"][i], "B": cache["conv_B"][i],
             "C": cache["conv_C"][i]}, cfg)
        x = x + h
        for key, value in (("state", state), ("conv_x", bufs["x"]),
                           ("conv_B", bufs["B"]), ("conv_C", bufs["C"])):
            new_cache[key][i] = value
    return _logits_1tok(params, x, sctx, cfg), new_cache


def _rec_step(p, x, state: dict, sctx: ShardingCtx, cfg: ArchConfig):
    h, h_new, buf = rglru_decode_step(
        p["temporal"], rmsnorm(p["ln1"], x, cfg.norm_eps), state["h"],
        state["conv"], cfg)
    x = x + h
    x = x + mlp_apply_1tok(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), sctx)
    return x, {"h": h_new, "conv": buf}


def _hybrid_decode(params, cache, x, pos: int, sctx: ShardingCtx,
                   cfg: ArchConfig):
    """One token through the groups and the tail.  The ring's length ``Wn``
    is read from the cache; the token goes into slot ``pos % Wn``, and a
    slot not written yet is labelled ``pos + 1``, so it is masked."""
    G, rem, keys = _hybrid_layout(cfg)
    attn = [key for key, kind in keys if kind != "rec"]
    Wn = cache["groups"][attn[0]]["k"].shape[3] if attn else cfg.window
    slot = pos % Wn
    held = pos - ((pos - torch.arange(Wn, device=x.device)) % Wn)
    slot_pos = torch.where(held >= 0, held, pos + 1)
    states = {key: [] for key, _ in keys}
    for g in range(G):
        gp = _layer(params["groups"], g)
        st = _layer(cache["groups"], g)
        for key, kind in keys:
            if kind == "rec":
                x, new = _rec_step(gp[key], x, st[key], sctx, cfg)
            else:
                x, ck, cv = block_decode(gp[key], x, st[key]["k"],
                                         st[key]["v"], pos, sctx, cfg,
                                         slot=slot, slot_pos=slot_pos)
                new = {"k": ck, "v": cv}
            states[key].append(new)
    new_cache = {"groups": {key: _stack_states(v)
                            for key, v in states.items()}}
    if rem:
        tail = []
        for i in range(rem):
            x, new = _rec_step(_layer(params["tail"], i), x,
                               _layer(cache["tail"], i), sctx, cfg)
            tail.append(new)
        new_cache["tail"] = _stack_states(tail)
    return x, new_cache


def _encdec_decode(params, cache, x, pos: int, sctx: ShardingCtx,
                   cfg: ArchConfig):
    """One token through the decoder layers: the self-attention cache
    written at ``pos``, the memory read with every one of its ``F`` slots
    at position 0 (always seen) and never written."""
    mem_pos = torch.zeros(cache["mem_k"].shape[3], dtype=torch.long,
                          device=x.device)
    here = torch.arange(pos, pos + 1, device=x.device)
    new_cache = dict(cache, k=torch.empty_like(cache["k"]),
                     v=torch.empty_like(cache["v"]))
    for i in range(cfg.dec_layers):
        p = _layer(params["dec_blocks"], i)
        xin = rmsnorm(p["ln1"], x, cfg.norm_eps)
        k_new = torch.einsum("bd,dgk->bgk", xin, p["self_attn"]["wk"])
        v_new = torch.einsum("bd,dgk->bgk", xin, p["self_attn"]["wv"])
        k_new = rope(k_new[:, None], here, cfg.rope_theta)[:, 0]
        ck = cache_write(cache["k"][i], k_new, pos)
        cv = cache_write(cache["v"][i], v_new, pos)
        x = x + decode_attention(p["self_attn"], xin, ck, cv, pos, sctx, cfg)
        x = x + decode_attention(
            p["cross_attn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
            cache["mem_k"][i], cache["mem_v"][i], pos, sctx, cfg,
            slot_pos=mem_pos, use_rope=False)
        x = x + mlp_apply_1tok(p["mlp"], rmsnorm(p["ln3"], x, cfg.norm_eps),
                               sctx)
        new_cache["k"][i], new_cache["v"][i] = ck, cv
    return x, new_cache


def _vlm_decode(params, cache, x, pos: int, sctx: ShardingCtx,
                cfg: ArchConfig):
    """One token through the groups: each self block writes its cache at
    ``pos``; the cross block reads the image cache, every one of its ``T``
    slots at position 0, unrotated, and writes nothing."""
    img_pos = torch.zeros(cache["img_k"].shape[3], dtype=torch.long,
                          device=x.device)
    new_cache = dict(cache, k=torch.empty_like(cache["k"]),
                     v=torch.empty_like(cache["v"]))
    for g in range(cfg.n_layers // cfg.cross_attn_every):
        gp = _layer(params["groups"], g)
        for j in range(cfg.cross_attn_every - 1):
            x, new_cache["k"][g, j], new_cache["v"][g, j] = block_decode(
                _layer(gp["selfs"], j), x, cache["k"][g, j],
                cache["v"][g, j], pos, sctx, cfg)
        x, _, _ = block_decode(gp["cross"], x, cache["img_k"][g],
                               cache["img_v"][g], pos, sctx, cfg,
                               slot_pos=img_pos, write=False, use_rope=False)
    return x, new_cache


# ===========================================================================
# the module
# ===========================================================================

class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: sub-dicts become child
    modules, tensors parameters, under the same keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        out.update({k: m.tree() for k, m in self.named_children()})
        return out


class Model(nn.Module):
    """One architecture's parameters on one device, served by ``prefill``
    and ``decode``.

    ``device`` defaults to the CUDA device and raises without one; pass
    ``device="cpu"`` for a CPU run.  ``params`` (a nested dict of tensors
    matching ``param_specs(cfg)``, e.g. from ``repro_torch.convert``) are
    moved there; without them the parameters are drawn by
    ``init_params`` from a generator seeded with ``seed``."""

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        specs = param_specs(cfg)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init_params(specs, gen, device=device)
        else:
            check_tree(specs, params)
            params = tree_map(lambda t: t.to(device), params)
        self.cfg = cfg
        self.sctx = ShardingCtx.local()
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params.embed.device

    def param_specs(self) -> dict:
        return param_specs(self.cfg)

    def abstract_params(self) -> dict:
        """``params.abstract_params`` of the config's specs: ``meta``
        tensors of each leaf's shape and dtype.  JAX's ``Model.init(rng)``
        has no counterpart: this module draws its weights when it is built,
        from ``seed``."""
        return abstract_params(self.param_specs())

    def cache_specs(self, batch: int, seq: int) -> dict:
        return cache_specs(self.cfg, batch, seq)

    def init_cache(self, batch: int, seq: int) -> dict:
        return init_cache(self.cfg, batch, seq, device=self.device)

    def loss(self, params, batch: dict, sctx: ShardingCtx | None = None):
        """``loss_fn`` on the parameter tree ``params`` (not the module's
        own, which stay as they are): the training path differentiates
        it with respect to its own leaves."""
        return loss_fn(params, batch, sctx or self.sctx, self.cfg)

    @torch.inference_mode()
    def prefill(self, batch: dict):
        """batch: ``{"tokens": (B, S) integer}``, plus ``frames`` (B,
        n_frames, d_model) for the encdec family or ``img_embed`` (B,
        n_img_tokens, vision_dim) for the vlm family -> (logits (B, V)
        fp32, cache)."""
        return prefill_fn(self.params.tree(), batch, self.sctx, self.cfg)

    @torch.inference_mode()
    def decode(self, cache: dict, token: torch.Tensor, pos: int):
        return decode_fn(self.params.tree(), cache, token, pos, self.sctx,
                         self.cfg)


def build_model(cfg: ArchConfig, *, device=None, seed: int = 0) -> Model:
    """``Model(cfg)`` on ``device`` (the CUDA device by default), its
    weights drawn from ``seed``."""
    return Model(cfg, device=device, seed=seed)
