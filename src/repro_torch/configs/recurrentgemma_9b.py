"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000; RG-LRU + local attention, pattern
(rec, rec, attn) x12 + 2 rec, window 2048. [arXiv:2402.19427; unverified]

Sub-quadratic: runs the long_500k cell (window-bounded KV + O(1) RG-LRU
state). The RG-LRU scan runs on repro_torch.core.recurrence — the paper's
shared-coefficient recurrence engine."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    window=2048,
    rnn_width=4096,
    rope_theta=10000.0,
)
