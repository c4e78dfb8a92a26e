"""Architecture registry + the assigned input-shape grid.

Counterpart of ``repro.configs``: the same ten published configs (source
tags in each file) and the same four shape cells.  ``long_500k`` runs only
for sub-quadratic archs.  ``input_specs`` gives every model input of a
cell as tensors on the ``meta`` device (shapes and dtypes, no memory).
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.models.config import ArchConfig, reduced
from repro_torch.models.model import cache_specs
from repro_torch.models.params import tree_map

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


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """Stand-ins for every model input of this cell: tensors on the
    ``meta`` device, PyTorch's counterpart of ``jax.ShapeDtypeStruct``,
    under JAX's keys, shapes and dtypes.

    train   -> ``{"batch": {"tokens", "labels", frontend}}``
    prefill -> ``{"batch": {"tokens", frontend}}``
    decode  -> ``{"cache", "token", "pos"}``

    The frontend is ``frames`` (B, n_frames, d_model) for the encdec
    family, ``img_embed`` (B, n_img_tokens, vision_dim) for the vlm family,
    bf16.  The cache comes from ``models.model.cache_specs``: no model is
    built (the port's ``build_model`` allocates every parameter)."""
    seq, batch, kind = SHAPES[shape_name]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    tok = meta((batch, seq), torch.int32)
    frontend = {}
    if cfg.family == "vlm":
        frontend["img_embed"] = meta(
            (batch, cfg.n_img_tokens, cfg.vision_dim), torch.bfloat16)
    if cfg.family == "encdec":
        frontend["frames"] = meta((batch, cfg.n_frames, cfg.d_model),
                                  torch.bfloat16)
    if kind == "train":
        return {"batch": {"tokens": tok, "labels": tok, **frontend}}
    if kind == "prefill":
        return {"batch": {"tokens": tok, **frontend}}
    if kind == "decode":
        return {"cache": tree_map(lambda s: meta(s.shape, s.dtype),
                                  cache_specs(cfg, batch, seq)),
                "token": meta((batch,), torch.int32),
                "pos": meta((), torch.int32)}
    raise ValueError(shape_name)
