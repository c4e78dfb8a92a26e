"""Atomic checkpoints in the JAX package's on-disk format.

Counterpart of ``repro.ckpt.checkpoint``; the two packages read each
other's checkpoints.  Layout: ``<dir>/step_<N>/manifest.json`` + one
``.npy`` per leaf.
  * Atomicity: written into ``.tmp_step_<N>`` then ``os.rename``'d
    (restarts never see a torn checkpoint); a ``COMMITTED`` marker closes
    the write.
  * keep_k garbage collection; torn writes are removed.
  * Leaves are full logical arrays with the tree structure (nested dicts,
    tuples and lists) in the manifest's keys.
  * bfloat16, which numpy has no type for without ``ml_dtypes``, is stored
    as its raw 16 bits (numpy void ``V2``) with the manifest dtype
    ``"bfloat16"``: what JAX's files hold.  ``restore`` views those bits
    as ``torch.bfloat16``.
  * ``restore(..., shardings=)`` lays each leaf out on its
    ``NamedSharding`` (the elastic re-shard path): every rank reads the
    full leaf and keeps its own shard, a DTensor.
  * ``AsyncWriter`` overlaps serialization with training.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.sharding import place_tree

_SEP = "/"
_BF16 = "bfloat16"


def _flatten(tree) -> dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + [str(k)], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + [f"__{i}"], v)
        else:
            flat[_SEP.join(prefix)] = node
    walk([], tree)
    return flat


def _unflatten(flat: dict[str, Any]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("__") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][2:]))
            return tuple(fix(v) for _, v in items)
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def _to_numpy(val) -> tuple:
    """(numpy array, manifest dtype) of a leaf: a tensor (bf16 as its raw
    bits, ``V2``), a numpy array or a Python scalar."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu()
        if val.dtype == torch.bfloat16:
            return val.view(torch.int16).numpy().view("V2"), _BF16
        return val.numpy(), str(val.numpy().dtype)
    arr = np.asarray(val)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if dtype != _BF16:
            raise ValueError(f"checkpoint leaf of dtype {dtype!r}: only "
                             "bfloat16 is stored as raw bits here")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(directory: str, step: int, tree, *, keep_k: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(tree)
    manifest = {"step": step, "leaves": {}}
    for i, (key, val) in enumerate(sorted(flat.items())):
        arr, dtype = _to_numpy(val)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep_k)
    return final


def _gc(directory: str, keep_k: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep_k] if keep_k > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    # remove torn writes
    for d in os.listdir(directory):
        if d.startswith(".tmp_step_"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for d in os.listdir(directory):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(directory, d, "COMMITTED")):
            best = max(best or -1, int(d.split("_")[1]))
    return best


def restore(directory: str, step: int | None = None, *, device=None,
            shardings=None):
    """Load a checkpoint as (tree of tensors, step): the latest committed
    one unless ``step`` is given.  Leaves are CPU tensors (0-d for
    scalars), moved to ``device`` when one is given, then laid out on
    ``shardings`` (a tree of ``NamedSharding`` matching the saved one;
    ``None`` leaves stay as they are) when those are given."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for key, meta in manifest["leaves"].items():
        leaf = _to_tensor(np.load(os.path.join(path, meta["file"])),
                          meta["dtype"])
        flat[key] = leaf if device is None else leaf.to(device)
    tree = _unflatten(flat)
    if shardings is not None:
        tree = place_tree(tree, shardings)
    return tree, manifest["step"]


def _snapshot(tree):
    """A copy of every tensor leaf in host memory (nested dicts, tuples
    and lists kept)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


class AsyncWriter:
    """Overlap checkpoint serialization with training (single worker; at
    scale this is one writer per host writing its shard chunks)."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            directory, step, tree, keep_k = item
            try:
                save(directory, step, tree, keep_k=keep_k)
            except Exception as e:      # surfaced on next submit/flush
                self._err = e

    def submit(self, directory: str, step: int, tree, *, keep_k: int = 3):
        if self._err:
            raise self._err
        # snapshot to host memory NOW so training can go on with its buffers
        self._q.put((directory, step, _snapshot(tree), keep_k))

    def flush(self):
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err
