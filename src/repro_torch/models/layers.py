"""Core layers shared by the model families: RMSNorm, RoPE, blockwise
(flash-style) attention, GQA/MQA/cross attention with KV caches, SwiGLU
MLP.

Counterpart of ``repro.models.layers``, under the JAX names.  All attention
math, norms and RoPE accumulate in fp32 whatever the activation dtype, as
in JAX; an fp64 input (parameters carried at fp64, never a config's
dtype) computes in fp64 throughout, an oracle of the same function.
``flash_attention`` is JAX's blockwise oracle as loops over q and kv
chunks: the same chunks (``_pick_chunk``), masks, ``NEG_INF`` fill and
fp32 online softmax, and never the (Sq, Sk) score matrix.
"""

from __future__ import annotations

import math

import torch

from repro_torch.sharding import ShardingCtx
from .config import ArchConfig
from .params import ParamSpec

NEG_INF = -1e30


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype attention, norms and RoPE compute in: fp32, or fp64 for
    an fp64 input."""
    return torch.promote_types(dtype, torch.float32)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s order: the sigmoid rounded to x's dtype, then the
    product (``F.silu`` rounds once)."""
    return x * torch.sigmoid(x)


def _pick_chunk(s: int, want: int) -> int:
    """Largest divisor of s that is <= want (non-power-of-two seq lengths,
    e.g. a 1984-token prompt chunks at 992)."""
    c = min(want, s)
    while s % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# norm + rope
# ---------------------------------------------------------------------------

def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with JAX's ``(1 + w)`` scale and the mean taken in fp32."""
    xf = x.to(_acc(x.dtype))
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * scale) * (1.0 + w.to(xf.dtype))).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., L, H, D) with pos (..., L) broadcastable; fp32 angles, the
    two halves rotated and concatenated."""
    half = x.shape[-1] // 2
    acc = _acc(x.dtype)
    freqs = theta ** (-torch.arange(0, half, dtype=acc, device=x.device)
                      / half)
    angles = pos.to(acc)[..., None] * freqs                 # (..., L, half)
    cos = torch.cos(angles)[..., None, :]                       # (..., L, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].to(acc)
    x2 = x[..., half:].to(acc)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise flash attention (prefill)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D); H % KV == 0 (GQA folding).
    ``causal`` masks keys past each query (Sq = Sk); ``window`` > 0 keeps
    the last ``window`` keys of each query.  Without either every key is
    seen (an encoder, cross-attention over Sk ≠ Sq).

    Online softmax over kv chunks inside a loop over q chunks: the largest
    live tile is (B, q_chunk, H, kv_chunk) fp32."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Sk, kv_chunk)
    f32 = _acc(q.dtype)

    qs = (q.to(f32) * (1.0 / math.sqrt(D))).reshape(B, Sq // qc, qc, KV, rep, D)
    ks = k.reshape(B, Sk // kc, kc, KV, D)
    vs = v.reshape(B, Sk // kc, kc, KV, D)
    k_off = torch.arange(kc, device=q.device)
    out = []
    for qi in range(Sq // qc):
        qblk = qs[:, qi]
        q_pos = qi * qc + torch.arange(qc, device=q.device)
        m = torch.full((B, qc, KV, rep), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((B, qc, KV, rep), dtype=f32, device=q.device)
        acc = torch.zeros((B, qc, KV, rep, D), dtype=f32, device=q.device)
        for ki in range(Sk // kc):
            s = torch.einsum("bqgrd,bkgd->bqgrk", qblk, ks[:, ki].to(f32))
            k_pos = ki * kc + k_off
            mask = q_pos[:, None] >= k_pos[None, :] if causal else None
            if window:
                near = (q_pos[:, None] - k_pos[None, :]) < window
                mask = near if mask is None else mask & near
            if mask is not None:
                s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqgrk,bkgd->bqgrd", p, vs[:, ki].to(f32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out.append(acc / torch.clamp(l, min=1e-20)[..., None])
    return torch.stack(out, dim=1).reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# attention (self / cross, prefill / decode)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ArchConfig, *, kv_dim: int | None = None) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kd = kv_dim or D
    dt = _dt(cfg)
    return {
        "wq": ParamSpec((D, H, hd), ("embed", "heads", "head_dim"), dt),
        "wk": ParamSpec((kd, KV, hd), ("embed", "kv", "head_dim"), dt),
        "wv": ParamSpec((kd, KV, hd), ("embed", "kv", "head_dim"), dt),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "embed"), dt,
                        scale=1.0 / math.sqrt(H * hd)),
    }


def attention_apply(p, x, sctx: ShardingCtx, cfg: ArchConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0, kv_input: torch.Tensor | None = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Prefill / training path. x: (B, S, D); positions: (S,).  With
    ``kv_input`` (B, Sk, kv_dim), cross-attention: K and V are made from
    it, nothing is rotated and every key is seen."""
    src = x if kv_input is None else kv_input
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dgk->bsgk", src, p["wk"])
    v = torch.einsum("bsd,dgk->bsgk", src, p["wv"])
    if use_rope and kv_input is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = sctx.constrain(q, ("act_batch", "act_seq", "act_heads", None))
    k = sctx.constrain(k, ("act_batch", "act_seq", "act_kv", None))
    v = sctx.constrain(v, ("act_batch", "act_seq", "act_kv", None))
    o = flash_attention(q, k, v, causal=causal and kv_input is None,
                        window=window, q_chunk=cfg.q_chunk,
                        kv_chunk=cfg.kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return sctx.constrain(out, ("act_batch", "act_res_seq", None))


def attention_prefill_kv(p, x, cfg: ArchConfig, positions) -> tuple:
    """Rotated K and V for the cache, laid out (B, KV, S, hd): kv heads
    first, as JAX's sharding fallback chain wants them."""
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"])
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"])
    k = rope(k, positions, cfg.rope_theta)
    return k.transpose(1, 2), v.transpose(1, 2)


def decode_attention(p, x, cache_k, cache_v, pos: int, sctx: ShardingCtx,
                     cfg: ArchConfig, *,
                     slot_pos: torch.Tensor | None = None,
                     use_rope: bool = True) -> torch.Tensor:
    """Single-token decode. x: (B, D); cache_{k,v}: (B, KV, S, hd);
    ``slot_pos``: (S,) absolute position of each cache slot (ring buffers;
    a memory's slots all at 0); defaults to arange(S).  Slots past ``pos``
    are masked; without ``use_rope`` the query is not rotated."""
    B, KV, S, hd = cache_k.shape
    if slot_pos is None:
        slot_pos = torch.arange(S, device=x.device)
    H = cfg.n_heads
    rep = H // KV
    f32 = _acc(x.dtype)
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    if use_rope:
        here = torch.arange(pos, pos + 1, device=x.device)
        q = rope(q[:, None], here, cfg.rope_theta)[:, 0]
    qf = (q.to(f32) * (1.0 / math.sqrt(hd))).reshape(B, KV, rep, hd)
    s = torch.einsum("bgrk,bgsk->bgrs", qf, cache_k.to(f32))
    s = torch.where((slot_pos <= pos)[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bgsk->bgrk", w, cache_v.to(f32))
    o = o.reshape(B, H, hd).to(x.dtype)
    out = torch.einsum("bhk,hkd->bd", o, p["wo"])
    return sctx.constrain(out, ("act_batch", None))


def cache_write(cache: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """``cache`` (B, KV, S, hd) with slot ``slot`` set to ``new`` (B, KV, hd),
    as a new tensor; ``cache`` is not modified.  JAX's one-hot masked write
    (there for SPMD) gives the same values."""
    out = cache.clone()
    out[:, :, slot] = new
    return out


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    dt = _dt(cfg)
    return {
        "wi": ParamSpec((D, F), ("embed", "mlp"), dt),
        "wg": ParamSpec((D, F), ("embed", "mlp"), dt),
        "wo": ParamSpec((F, D), ("mlp", "embed"), dt),
    }


def mlp_apply(p, x, sctx: ShardingCtx) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    h = _silu(g) * h
    h = sctx.constrain(h, ("act_batch", "act_seq", "act_mlp"))
    out = torch.einsum("bsf,fd->bsd", h, p["wo"])
    return sctx.constrain(out, ("act_batch", "act_res_seq", None))


def mlp_apply_1tok(p, x, sctx: ShardingCtx) -> torch.Tensor:
    return (_silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
