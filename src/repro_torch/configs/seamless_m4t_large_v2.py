"""seamless-m4t-large-v2 [audio] — enc-dec, 24+24L d_model=1024 16H
(MHA kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596; hf]

The modality frontend is a STUB per the brief: input_specs supplies
precomputed audio frame embeddings (B, 1536, d_model) ~= 30 s of frames
after length adaptation (DESIGN.md §6); the backbone encoder consumes
them, the decoder cross-attends."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    n_frames=1536,
    rope_theta=10000.0,
)
