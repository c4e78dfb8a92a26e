"""Carry a factorization made by the JAX package into the port.

``from_jax_factorization`` takes the JAX package's stored factor as numpy
arrays — the fields of ``TridiagFactor``, ``PeriodicTridiagFactor``,
``PentaFactor`` or ``PeriodicPentaFactor`` (a NamedTuple of arrays, or a
mapping of field name to array, nested for the periodic factors), or the
batch-mode dict of diagonals — plus its ``SolveMeta`` fields, and returns
the port's ``Factorization`` of the same operator.
``from_jax_periodic_factor`` turns the fields of a JAX
``PeriodicTridiagFactor`` / ``PeriodicPentaFactor`` into the port's core
factor, the operand of the fused CN steps.

For the models, ``params_from_jax`` turns a JAX parameter tree (nested
dicts of numpy arrays, stacked along ``layers``) into the port's
parameter tree, checked against ``param_specs``, and ``model_from_jax``
into a ``Model``; ``cache_from_jax`` does the same for a decode cache,
``tree_from_jax`` for any nested dict (one layer's parameters), and
``opt_state_from_jax`` for an AdamW state, so that a JAX train state
(parameters, moments and step) continues in the port.  JAX's bfloat16
arrays (numpy's ``bfloat16`` extension type) become ``torch.bfloat16``
exactly.

Everything here reads plain numpy and mappings only; the caller converts
from JAX (``jax.tree_util.tree_map(np.asarray, tree)``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.penta import PentaFactor, PeriodicPentaFactor
from .core.tridiag import PeriodicTridiagFactor, TridiagFactor
from .kernels.ops import canonical_storage_dtype
from .models.model import (SEQ_AXIS, Model, cache_specs, memory_leaves,
                           param_specs)
from .models.params import check_tree, tree_leaves
from .solver.functional import Factorization, SolveMeta
from .solver.reference import _expand_if_scalarized
from .solver.system import resolve_device
from .train.optimizer import AdamW

# JAX backend -> the port's backend holding the same stored layout
_BACKENDS = {"pallas": "cuda", "reference": "reference", "cuda": "cuda"}


def _fields(obj) -> dict:
    if isinstance(obj, Mapping):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    raise TypeError(f"expected a NamedTuple or mapping of arrays, got "
                    f"{type(obj).__name__}")


def _factor(cls, fields: dict, tensor):
    return cls(**{k: tensor(v) for k, v in fields.items()})


def from_jax_periodic_factor(fields, *, device=None):
    """The port's ``PeriodicTridiagFactor`` or ``PeriodicPentaFactor`` of
    the numpy fields of JAX's (a NamedTuple of arrays, or a mapping with
    the inner ``factor`` nested), on ``device`` (default: the CUDA
    device).  JAX's ``z`` is (N,), as the port's is; its fused kernel
    reshapes it to (N, 1) itself."""
    device = resolve_device(device)

    def tensor(x):
        return torch.tensor(np.asarray(x), device=device)

    fields = _fields(fields)
    inner = _fields(fields.pop("factor"))
    if "z" in fields:
        return PeriodicTridiagFactor(
            factor=_factor(TridiagFactor, inner, tensor),
            **{k: tensor(v) for k, v in fields.items()})
    return PeriodicPentaFactor(factor=_factor(PentaFactor, inner, tensor),
                               **{k: tensor(v) for k, v in fields.items()})


def from_jax_factorization(stored_np, meta_dict: Mapping, *, device,
                           diagonals=()) -> Factorization:
    """The port's ``Factorization`` of a JAX-made stored factor.

    ``meta_dict`` holds ``SolveMeta``'s fields (``bandwidth``, ``n``,
    ``mode``, ``periodic``, ``backend``, ``options``).  A ``pallas``
    factorization becomes a ``cuda`` one (the same stored layout; its
    ``storage_dtype`` carries over, its TPU tiling does not), a Dirichlet
    batch-mode one included; a periodic batch-mode one, which has no
    kernel, becomes a ``reference`` one.
    ``diagonals`` are the spec's (N,) diagonals, needed only for their
    gradients."""
    device = torch.device(device)

    def tensor(x):
        return torch.tensor(np.asarray(x), device=device)

    bandwidth, mode = int(meta_dict["bandwidth"]), meta_dict["mode"]
    periodic, n = bool(meta_dict["periodic"]), int(meta_dict["n"])
    try:
        backend = _BACKENDS[meta_dict["backend"]]
    except KeyError:
        raise ValueError(f"no port backend holds the stored layout of JAX "
                         f"backend {meta_dict['backend']!r}") from None
    if mode == "batch" and periodic:
        backend = "reference"   # no kernel for periodic per-system copies
    jax_opts = dict(meta_dict.get("options", ()))

    fields = _fields(stored_np)
    if mode == "batch":
        stored = {k: tensor(v) for k, v in fields.items()}
    else:
        base, wrapper = ((TridiagFactor, PeriodicTridiagFactor)
                         if bandwidth == 3 else
                         (PentaFactor, PeriodicPentaFactor))
        if periodic:
            inner = _factor(base, _fields(fields.pop("factor")), tensor)
            stored = wrapper(factor=inner,
                             **{k: tensor(v) for k, v in fields.items()})
        else:
            stored = _factor(base, fields, tensor)
        if backend == "cuda":
            stored = _expand_if_scalarized(bandwidth, periodic, n, stored)

    if backend == "cuda":
        options = {"storage_dtype": canonical_storage_dtype(
                       jax_opts.get("storage_dtype"))}
    else:
        options = {"method": jax_opts.get("method", "scan")}
    meta = SolveMeta(bandwidth=bandwidth, n=n, mode=mode, periodic=periodic,
                     backend=backend, options=tuple(sorted(options.items())))
    return Factorization(diagonals=tuple(tensor(d) for d in diagonals),
                         stored=stored, meta=meta)


# ---------------------------------------------------------------------------
# Model parameters and decode caches
# ---------------------------------------------------------------------------

def _array_to_tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":   # exact through fp32
        return torch.from_numpy(x.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.tensor(x, device=device)


def tree_from_jax(tree, *, device) -> dict:
    """A nested mapping of numpy arrays as the same nesting of tensors on
    ``device``, each at its own dtype."""
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: tree_from_jax(v, device=device) for k, v in tree.items()}
    return _array_to_tensor(tree, device)


def params_from_jax(cfg, tree, *, device) -> dict:
    """The port's parameter tree of a JAX ``init_params`` / trained tree,
    checked against ``param_specs(cfg)`` (keys, shapes, dtypes)."""
    params = tree_from_jax(tree, device=device)
    check_tree(param_specs(cfg), params)
    return params


def model_from_jax(cfg, tree, *, device) -> Model:
    """A ``Model`` of ``cfg`` holding the JAX-made parameters ``tree``."""
    return Model(cfg, device=device, params=params_from_jax(cfg, tree,
                                                            device=device))


def _seq_len(spec_tree, tree, memory) -> int:
    """The ``act_kv_seq`` length of the first self-attention leaf of
    ``tree`` (sorted-key order; the leaves named in ``memory`` skipped), or
    0 where none has that axis."""
    for key in sorted(spec_tree.keys() & tree.keys()):
        spec, leaf = spec_tree[key], tree[key]
        if isinstance(spec, dict):
            seq = _seq_len(spec, leaf, memory) if isinstance(leaf, dict) else 0
            if seq:
                return seq
        elif key not in memory and SEQ_AXIS in spec.names:
            return leaf.shape[spec.names.index(SEQ_AXIS)]
    return 0


def cache_from_jax(cfg, cache, *, device) -> dict:
    """The port's decode cache of a JAX one (``prefill`` / ``init_cache``
    output, nested for the hybrid family), checked against ``cache_specs``
    at the cache's batch and sequence length: the batch read where the
    specs name it (``act_batch``), the length from the ``act_kv_seq`` axis
    of a self-attention leaf (the hybrid family's ring; not a frontend's
    memory, whose length is the config's; the ssm cache has none)."""
    out = tree_from_jax(cache, device=device)
    specs = cache_specs(cfg, 1, 1)
    spec, leaf = tree_leaves(specs)[0], tree_leaves(out)[0]
    batch = leaf.shape[spec.names.index("act_batch")]
    seq = _seq_len(specs, out, memory_leaves(cfg))
    check_tree(cache_specs(cfg, batch, seq), out)
    return out


def opt_state_from_jax(cfg, tree, *, device) -> dict:
    """The port's AdamW state of a JAX one: ``{"m", "v"}``, each a nested
    mapping of numpy arrays shaped like the parameters, checked against
    ``AdamW.state_specs(param_specs(cfg))`` in ``cfg.opt_dtype`` (the
    moment dtype JAX's training driver takes from the config)."""
    opt_dtype = torch.bfloat16 if cfg.opt_dtype == "bfloat16" else \
        torch.float32
    state = tree_from_jax(tree, device=device)
    check_tree(AdamW(lr=None, opt_dtype=opt_dtype).state_specs(
        param_specs(cfg)), state)
    return state
