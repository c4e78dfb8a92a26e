"""Transformer blocks shared by the attention-bearing families, in prefill
and decode flavours.

Counterpart of ``repro.models.transformer`` for self-attention blocks with
the dense MLP or the MoE layer (``moe=True``): the dense and moe families'
blocks and the hybrid family's attention layers.  Decode writes into a
plain cache (the token at ``pos``, every slot at its own position) or into
a ring (``slot`` and ``slot_pos``).  The gated cross-attention block
(``kind="cross"``) raises ``NotImplementedError`` naming the ROADMAP item
that brings it, with the options only it and the encdec family use, which
are not here: JAX's ``kv_input``, ``kv_dim``, ``use_rope=False``,
``write=False`` and non-causal attention.
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

_UNPORTED_BLOCKS = ("ROADMAP.md Queue 1 item 4b (the encdec and vlm "
                    "families)")


def _self_only(kind: str = "self", *, kv_input=None, use_rope: bool = True,
               write: bool = True) -> None:
    """Refuse what only the cross-attention block and the encdec and vlm
    families use (JAX's keywords, which the port takes so as to name the
    item that brings them)."""
    if kind != "self":
        raise NotImplementedError(
            f"the {kind!r} attention block is not ported yet: "
            f"{_UNPORTED_BLOCKS}")
    for name, given in (("kv_input", kv_input is not None),
                        ("use_rope=False", not use_rope),
                        ("write=False", not write)):
        if given:
            raise NotImplementedError(
                f"{name} (cross-attention) is not ported yet: "
                f"{_UNPORTED_BLOCKS}")


def block_specs(cfg: ArchConfig, *, kind: str = "self",
                moe: bool = False) -> dict:
    _self_only(kind)
    D = cfg.d_model
    return {
        "ln1": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "attn": attention_specs(cfg),
        "ln2": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "mlp": moe_specs(cfg) if moe else mlp_specs(cfg),
    }


def _mlp(p, x, sctx: ShardingCtx, cfg: ArchConfig, moe: bool) -> tuple:
    """The block's MLP on normed (B, S, D) activations: (out, aux)."""
    if moe:
        return moe_apply(p, x, sctx, cfg)
    return mlp_apply(p, x, sctx), {}


def block_apply(p, x, sctx: ShardingCtx, cfg: ArchConfig, *, positions,
                window: int, kind="self", moe=False, kv_input=None,
                use_rope=True):
    """Full-sequence causal block (train / prefill). Returns (x, aux): the
    MoE layer's aux losses, else {}."""
    _self_only(kind, kv_input=kv_input, use_rope=use_rope)
    h = attention_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), sctx,
                        cfg, positions=positions, window=window)
    x = x + h
    m, aux = _mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), sctx, cfg,
                  moe)
    return x + m, aux


def block_prefill_kv(p, x, cfg: ArchConfig, positions, *, kv_input=None,
                     use_rope=True):
    """K/V cache entries of this block: the normed block input, K rotated
    at absolute positions.  Layout (B, KV, S, hd)."""
    _self_only(kv_input=kv_input, use_rope=use_rope)
    return attention_prefill_kv(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                cfg, positions)


def block_decode(p, x, cache_k, cache_v, pos: int, sctx: ShardingCtx,
                 cfg: ArchConfig, *, slot: int | None = None,
                 slot_pos: torch.Tensor | None = None, moe=False,
                 write=True, use_rope=True):
    """Single-token block. x: (B, D); the token's K and V go into slot
    ``slot`` (default ``pos``: a plain cache) of a cache whose slots hold
    positions ``slot_pos`` (default ``arange(S)``; a ring gives its own).
    Returns (x, new_k, new_v); the caches given are not modified."""
    _self_only(write=write, use_rope=use_rope)
    xin = rmsnorm(p["ln1"], x, cfg.norm_eps)
    k_new = torch.einsum("bd,dgk->bgk", xin, p["attn"]["wk"])
    v_new = torch.einsum("bd,dgk->bgk", xin, p["attn"]["wv"])
    here = torch.arange(pos, pos + 1, device=x.device)
    k_new = rope(k_new[:, None], here, cfg.rope_theta)[:, 0]
    wslot = pos if slot is None else slot
    cache_k = cache_write(cache_k, k_new, wslot)
    cache_v = cache_write(cache_v, v_new, wslot)
    h = decode_attention(p["attn"], xin, cache_k, cache_v, pos, sctx, cfg,
                         slot_pos=slot_pos)
    x = x + h
    xin2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if moe:
        m, _ = moe_apply(p["mlp"], xin2[:, None, :], sctx, cfg)
        m = m[:, 0]
    else:
        m = mlp_apply_1tok(p["mlp"], xin2, sctx)
    return x + m, cache_k, cache_v
