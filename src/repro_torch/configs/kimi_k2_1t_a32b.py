"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 + shared expert; trillion-param MoE.
[arXiv:2501.kimi2; unverified]

Spec-line wins over the real model where they differ (the release uses
MLA; the assigned line says GQA kv=8 — documented in DESIGN.md §6).
Optimizer moments are bf16 so params+opt fit 512 x 16 GB (DESIGN.md §9)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    n_experts=384,
    top_k=8,
    expert_d_ff=2048,
    shared_expert=True,
    opt_dtype="bfloat16",
    rope_theta=50000.0,
)
