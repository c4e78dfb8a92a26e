"""Transformer blocks shared by the attention-bearing families, in prefill
and decode flavours.

Counterpart of ``repro.models.transformer`` for self-attention blocks with
the dense MLP (the hybrid family's attention layers).  The MoE block and
the gated cross-attention block raise ``NotImplementedError`` naming the
ROADMAP item that brings them.  Options that only the unported families
use come with them and are not here: JAX's ``kv_input``, ``kv_dim``,
``use_rope=False`` and ``write=False``, the MLP's ``d_ff``, non-causal
attention, and decode into a plain cache (no ring ``slot`` / ``slot_pos``).
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
from .params import ParamSpec

_UNPORTED_BLOCKS = "ROADMAP.md Queue 1 item 4 (the rest of the model families)"


def _self_dense(kind: str, moe: bool) -> None:
    if moe:
        raise NotImplementedError(
            f"the MoE block is not ported yet: {_UNPORTED_BLOCKS}")
    if kind != "self":
        raise NotImplementedError(
            f"the {kind!r} attention block is not ported yet: "
            f"{_UNPORTED_BLOCKS}")


def block_specs(cfg: ArchConfig, *, kind: str = "self",
                moe: bool = False) -> dict:
    _self_dense(kind, moe)
    D = cfg.d_model
    return {
        "ln1": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "attn": attention_specs(cfg),
        "ln2": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "mlp": mlp_specs(cfg),
    }


def block_apply(p, x, sctx: ShardingCtx, cfg: ArchConfig, *, positions,
                window: int, kind="self", moe=False):
    """Full-sequence causal block (prefill). Returns (x, aux)."""
    _self_dense(kind, moe)
    h = attention_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), sctx,
                        cfg, positions=positions, window=window)
    x = x + h
    m = mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), sctx)
    return x + m, {}


def block_prefill_kv(p, x, cfg: ArchConfig, positions):
    """K/V cache entries of this block: the normed block input, K rotated
    at absolute positions.  Layout (B, KV, S, hd)."""
    return attention_prefill_kv(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                cfg, positions)


def block_decode(p, x, cache_k, cache_v, pos: int, sctx: ShardingCtx,
                 cfg: ArchConfig, *, slot: int, slot_pos: torch.Tensor,
                 moe=False):
    """Single-token block. x: (B, D); the token's K and V go into slot
    ``slot`` of the ring, whose slots hold positions ``slot_pos``.  Returns
    (x, new_k, new_v); the caches given are not modified."""
    _self_dense("self", moe)
    xin = rmsnorm(p["ln1"], x, cfg.norm_eps)
    k_new = torch.einsum("bd,dgk->bgk", xin, p["attn"]["wk"])
    v_new = torch.einsum("bd,dgk->bgk", xin, p["attn"]["wv"])
    here = torch.arange(pos, pos + 1, device=x.device)
    k_new = rope(k_new[:, None], here, cfg.rope_theta)[:, 0]
    cache_k = cache_write(cache_k, k_new, slot)
    cache_v = cache_write(cache_v, v_new, slot)
    h = decode_attention(p["attn"], xin, cache_k, cache_v, pos, sctx, cfg,
                         slot_pos=slot_pos)
    x = x + h
    m = mlp_apply_1tok(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), sctx)
    return x + m, cache_k, cache_v
