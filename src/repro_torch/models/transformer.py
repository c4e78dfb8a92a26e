"""Transformer blocks (self / cross / MoE variants) shared by every
attention-bearing family, in prefill and decode flavours.

Counterpart of ``repro.models.transformer``: the self-attention block with
the dense MLP or the MoE layer (``moe=True``), and llama-3.2-vision's
gated cross-attention block (``kind="cross"``: ``tanh(gate)`` scales the
attention and the MLP, each gate an fp32 (1,) leaf initialised to zeros).
Cross-attention takes its K and V from the raw memory (``kv_input``), with
no RoPE and no causal mask.  Decode writes into a plain cache (the token at
``pos``, every slot at its own position), into a ring (``slot`` and
``slot_pos``), or, with ``write=False``, not at all (a memory cache).
"""

from __future__ import annotations

import torch

from repro_torch.sharding import ShardingCtx
from .config import ArchConfig
from .layers import (
    attention_apply,
    attention_prefill_kv,
    attention_specs,
    cache_write,
    decode_attention,
    mlp_apply,
    mlp_apply_1tok,
    mlp_specs,
    rmsnorm,
    rope,
)
from .moe import moe_apply, moe_specs
from .params import ParamSpec


def _gate() -> ParamSpec:
    """A cross block's gate: one fp32 scalar, zeros at init (JAX's
    ``_f32()``)."""
    return ParamSpec((1,), (None,), torch.float32, init="zeros")


def block_specs(cfg: ArchConfig, *, kind: str = "self",
                kv_dim: int | None = None, moe: bool = False) -> dict:
    D = cfg.d_model
    s = {
        "ln1": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "attn": attention_specs(cfg, kv_dim=kv_dim),
        "ln2": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "mlp": moe_specs(cfg) if moe else mlp_specs(cfg),
    }
    if kind == "cross":
        # llama-3.2-vision style gated cross-attention
        s["gate_attn"] = _gate()
        s["gate_mlp"] = _gate()
    return s


def _mlp(p, x, sctx: ShardingCtx, cfg: ArchConfig, moe: bool) -> tuple:
    """The block's MLP on normed (B, S, D) activations: (out, aux)."""
    if moe:
        return moe_apply(p, x, sctx, cfg)
    return mlp_apply(p, x, sctx), {}


def block_apply(p, x, sctx: ShardingCtx, cfg: ArchConfig, *, positions,
                causal=True, window=0, kv_input=None, kind="self", moe=False,
                use_rope=True):
    """Full-sequence block (train / prefill). Returns (x, aux): the MoE
    layer's aux losses, else {}."""
    h = attention_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), sctx,
                        cfg, positions=positions, causal=causal,
                        window=window, kv_input=kv_input, use_rope=use_rope)
    if kind == "cross":
        h = torch.tanh(p["gate_attn"].to(x.dtype)) * h
    x = x + h
    m, aux = _mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), sctx, cfg,
                  moe)
    if kind == "cross":
        m = torch.tanh(p["gate_mlp"].to(x.dtype)) * m
    return x + m, aux


def block_prefill_kv(p, x, cfg: ArchConfig, positions, *, kv_input=None,
                     use_rope=True):
    """K/V cache entries of this block.  Self-attention caches see the
    normed block input (K rotated at absolute positions); cross-attention
    caches see the raw memory (``kv_input``), no RoPE.  Layout
    (B, KV, S, hd)."""
    if kv_input is None and use_rope:
        return attention_prefill_kv(
            p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, positions)
    src = kv_input if kv_input is not None else rmsnorm(p["ln1"], x,
                                                        cfg.norm_eps)
    k = torch.einsum("bsd,dgk->bsgk", src, p["attn"]["wk"])
    v = torch.einsum("bsd,dgk->bsgk", src, p["attn"]["wv"])
    return k.transpose(1, 2), v.transpose(1, 2)


def block_decode(p, x, cache_k, cache_v, pos: int, sctx: ShardingCtx,
                 cfg: ArchConfig, *, slot: int | None = None,
                 slot_pos: torch.Tensor | None = None, moe=False,
                 write=True, use_rope=True):
    """Single-token block. x: (B, D); the token's K and V go into slot
    ``slot`` (default ``pos``: a plain cache) of a cache whose slots hold
    positions ``slot_pos`` (default ``arange(S)``; a ring gives its own),
    or, with ``write=False``, nowhere (a memory the prefill wrote).
    Returns (x, new_k, new_v); the caches given are not modified."""
    xin = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if write:
        k_new = torch.einsum("bd,dgk->bgk", xin, p["attn"]["wk"])
        v_new = torch.einsum("bd,dgk->bgk", xin, p["attn"]["wv"])
        if use_rope:
            here = torch.arange(pos, pos + 1, device=x.device)
            k_new = rope(k_new[:, None], here, cfg.rope_theta)[:, 0]
        wslot = pos if slot is None else slot
        cache_k = cache_write(cache_k, k_new, wslot)
        cache_v = cache_write(cache_v, v_new, wslot)
    h = decode_attention(p["attn"], xin, cache_k, cache_v, pos, sctx, cfg,
                         slot_pos=slot_pos, use_rope=use_rope)
    if "gate_attn" in p:
        h = torch.tanh(p["gate_attn"].to(x.dtype)) * h
    x = x + h
    xin2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if moe:
        m, _ = moe_apply(p["mlp"], xin2[:, None, :], sctx, cfg)
        m = m[:, 0]
    else:
        m = mlp_apply_1tok(p["mlp"], xin2, sctx)
    if "gate_mlp" in p:
        m = torch.tanh(p["gate_mlp"].to(x.dtype)) * m
    return x + m, cache_k, cache_v
