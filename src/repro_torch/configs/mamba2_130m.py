"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality). [arXiv:2405.21060; unverified]

Attention-free: runs the long_500k cell with O(1) recurrent state. The
SSD inter-chunk scan runs on repro_torch.core.recurrence (machinery shared
with the paper's solver sweeps — DESIGN.md §4)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,        # unused (attention-free); kept for config uniformity
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
)
