"""Sequence models on the port's kernels (counterpart of ``repro.models``).

Ported so far: the serving path of the ssm family (mamba2-130m), and the
RG-LRU layer of the hybrid family (``rglru``)."""

from .config import ArchConfig, reduced
from .model import Model, build_model
from .params import ParamSpec, init_params, tree_size

__all__ = ["ArchConfig", "Model", "ParamSpec", "build_model", "init_params",
           "reduced", "tree_size"]
