"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained).
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    head_dim=128,
    n_experts=16,
    top_k=4,
    expert_d_ff=10752,
    rope_theta=500000.0,
)
