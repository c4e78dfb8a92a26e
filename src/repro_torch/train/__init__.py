"""Training (counterpart of ``repro.train``): AdamW with the warmup-cosine
schedule, and the train / prefill / decode step factories."""

from .optimizer import AdamW, apply_updates, global_norm, warmup_cosine
from .train_loop import make_decode_step, make_prefill_step, make_train_step

__all__ = ["AdamW", "apply_updates", "global_norm", "make_decode_step",
           "make_prefill_step", "make_train_step", "warmup_cosine"]
