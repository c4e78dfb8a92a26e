"""Architecture configuration (covers every family in the assigned pool).

A copy of ``repro.models.config``: the same fields, defaults and
``reduced`` sizing, so a configuration means the same model in both
packages."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_dispatch: str = "global"   # global | local (per-data-shard; §Perf)

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_width: int = 4

    # hybrid (RecurrentGemma): repeating block pattern + remainder
    block_pattern: tuple = ()     # e.g. ("rec", "rec", "attn")
    window: int = 0               # local-attention window (0 = full)
    rnn_width: int = 0            # RG-LRU width (0 -> d_model)

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    n_frames: int = 1536          # audio frontend stub length

    # VLM cross-attention
    cross_attn_every: int = 0     # every k-th layer attends to vision tokens
    vision_dim: int = 0
    n_img_tokens: int = 0

    # numerics / execution
    dtype: str = "bfloat16"
    opt_dtype: str = "float32"    # AdamW moment dtype (kimi-1T uses bf16)
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    remat: bool = True
    scan_layers: bool = True

    # attention flash-chunking (pure-JAX blockwise attention)
    q_chunk: int = 1024
    kv_chunk: int = 1024

    # ----- derived -----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode cell? (SSM / windowed attn)"""
        return self.family in ("ssm",) or (self.family == "hybrid" and self.window > 0)

    def params_dense_formula(self) -> int:
        """Rough 6ND-style N for MODEL_FLOPS accounting (see roofline)."""
        # computed precisely from the spec tree at dry-run time; this is a
        # sanity-check fallback only.
        return 0


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A smoke-test sized sibling of the same family (per the brief: small
    layers/width, few experts, tiny vocab)."""
    base = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=256,
        vocab=512,
        head_dim=32,
        rope_theta=10000.0,
        q_chunk=64,
        kv_chunk=64,
    )
    if cfg.n_experts:
        base.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
                    expert_d_ff=128)
    if cfg.ssm_state:
        base.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.block_pattern:
        base.update(n_layers=len(cfg.block_pattern) + 2, window=32, rnn_width=128)
    if cfg.enc_layers:
        base.update(enc_layers=2, dec_layers=2, n_layers=4, n_frames=24)
    if cfg.cross_attn_every:
        base.update(n_layers=5, cross_attn_every=5, vision_dim=96, n_img_tokens=16)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
