"""AdamW with a configurable moment dtype, and the warmup-cosine schedule.

Counterpart of ``repro.train.optimizer``, in JAX's order of operations
(``torch.optim.AdamW`` differs: it keeps moments in the parameter dtype,
computes bf16 updates in bf16 and has no clip epsilon of 1e-9):

  clip every gradient by ``min(1, clip / (global norm + 1e-9))``; take the
  moments in fp32 and store them in ``opt_dtype``; compute
  ``delta = -lr · (m̂ / (√v̂ + eps) + wd · p)`` in fp32, cast it to the
  parameter's dtype, and add it there (``apply_updates``).

The schedule and the bias corrections are fp32 scalars, as JAX's are.
Every function returns new trees and modifies nothing it is given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models.params import (ParamSpec, tree_leaves, tree_map,
                                      tree_zip_map)

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """step -> learning rate (a 0-d fp32 CPU tensor): linear from 0 over
    ``warmup`` steps, then a cosine from ``base_lr`` down to
    ``floor · base_lr`` at ``total``."""
    def f(step):
        step = _f32(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return base_lr * (floor + (1 - floor) * 0.5
                          * (1 + torch.cos(math.pi * prog)))
    return f


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaf by leaf in
    sorted-key order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(_F32)))
                          for g in tree_leaves(tree)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable                 # step -> learning rate
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0
    opt_dtype: Any = torch.float32

    def init(self, params) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.opt_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def state_specs(self, param_specs) -> dict:
        """Spec tree for the optimizer state (same logical names as params)."""
        def conv(s: ParamSpec) -> ParamSpec:
            return ParamSpec(s.shape, s.names, self.opt_dtype, init="zeros")
        return {"m": tree_map(conv, param_specs),
                "v": tree_map(conv, param_specs)}

    def update(self, grads, state, params, step):
        """(deltas, new state, {"grad_norm", "lr"}) for ``step``; nothing
        given is modified."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip / (gnorm + 1e-9), max=1.0)
        t = _f32(step) + 1.0
        lr = self.lr(step)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t

        def upd(g, m, v, p):
            g = g.to(_F32) * scale
            m_new = self.b1 * m.to(_F32) + (1 - self.b1) * g
            v_new = self.b2 * v.to(_F32) + (1 - self.b2) * g * g
            mhat = m_new / bc1
            vhat = v_new / bc2
            step_dir = mhat / (torch.sqrt(vhat) + self.eps)
            delta = -lr * (step_dir + self.weight_decay * p.to(_F32))
            return (delta.to(p.dtype), m_new.to(self.opt_dtype),
                    v_new.to(self.opt_dtype))

        with torch.no_grad():
            out = tree_zip_map(upd, grads, state["m"], state["v"], params)
        deltas, m, v = (tree_map(lambda o, i=i: o[i], out)
                        for i in range(3))
        return deltas, {"m": m, "v": v}, {"grad_norm": gnorm, "lr": lr}


def apply_updates(params, deltas):
    return tree_zip_map(lambda p, d: p + d.to(p.dtype), params, deltas)
