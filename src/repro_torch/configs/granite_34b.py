"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; llama-arch code model. [arXiv:2405.04324; hf]

MQA: the single KV head is replicated; decode caches fall back to
sequence sharding via the resolver chain."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    rope_theta=10000.0,
)
