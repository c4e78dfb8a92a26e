"""Checkpoints (counterpart of ``repro.ckpt``), in JAX's on-disk format."""

from .checkpoint import AsyncWriter, latest_step, restore, save

__all__ = ["AsyncWriter", "latest_step", "restore", "save"]
