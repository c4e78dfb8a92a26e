"""Sequence models on the port's kernels (counterpart of ``repro.models``).

Every family of the JAX package, served and trained: dense, moe, ssm,
hybrid, encdec and vlm (``model``), on ``layers`` (attention, self and
cross), ``transformer``, ``moe``, ``ssm`` and ``rglru``."""

from .config import ArchConfig, reduced
from .model import Model, build_model
from .params import ParamSpec, abstract_params, init_params, tree_size

__all__ = ["ArchConfig", "Model", "ParamSpec", "abstract_params",
           "build_model", "init_params", "reduced", "tree_size"]
