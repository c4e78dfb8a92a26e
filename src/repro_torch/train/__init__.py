"""Training (counterpart of ``repro.train``): AdamW with the warmup-cosine
schedule, the train / prefill / decode step factories and their sharding
helpers."""

from .optimizer import AdamW, apply_updates, global_norm, warmup_cosine
from .train_loop import (batch_shardings, cache_shardings,
                         make_decode_step, make_prefill_step,
                         make_train_step, train_step_shardings)

__all__ = ["AdamW", "apply_updates", "batch_shardings", "cache_shardings",
           "global_norm", "make_decode_step",
           "make_prefill_step", "make_train_step", "train_step_shardings",
           "warmup_cosine"]
