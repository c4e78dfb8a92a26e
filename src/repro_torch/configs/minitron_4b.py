"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000; pruned nemotron. [arXiv:2407.14679; hf]

24 heads do not divide the 16-way model axis: the logical-sharding
resolver replicates the head dim and tensor-parallelises head_dim/mlp
instead (DESIGN.md §7)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    head_dim=128,
    rope_theta=10000.0,
)
