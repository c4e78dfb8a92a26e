"""Architecture registry + the assigned input-shape grid.

Counterpart of ``repro.configs``: the same ten published configs (source
tags in each file) and the same four shape cells.  ``long_500k`` runs only
for sub-quadratic archs.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig, reduced

ARCH_IDS = [
    "llama_3_2_vision_90b",
    "mistral_large_123b",
    "minitron_4b",
    "granite_3_8b",
    "granite_34b",
    "recurrentgemma_9b",
    "dbrx_132b",
    "kimi_k2_1t_a32b",
    "mamba2_130m",
    "seamless_m4t_large_v2",
]


def _norm(name: str) -> str:
    """External ids use dashes/dots (llama-3.2-vision-90b); modules use
    underscores."""
    return name.replace("-", "_").replace(".", "_")


SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return reduced(get_config(name))


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape_name == "long_500k" and not cfg.sub_quadratic():
        return False, ("full quadratic attention at 524k tokens — skipped per "
                       "brief; runs only for SSM/hybrid archs")
    return True, ""
