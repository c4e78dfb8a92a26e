"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attention image layers every 5th layer
(20 of 100). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Vision frontend is a STUB per the brief: ``input_specs`` supplies
precomputed patch/tile embeddings (B, 2048, 7680) that the backbone
projects and cross-attends to (DESIGN.md §6)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    cross_attn_every=5,
    vision_dim=7680,
    n_img_tokens=2048,
    rope_theta=500000.0,
)
