"""Core layers shared by the model families.

Counterpart of ``repro.models.layers``.  This slice ports ``rmsnorm``, the
one the recurrent (ssm) family needs; RoPE, attention and the MLP come
with the hybrid family.
"""

from __future__ import annotations

import torch


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with JAX's ``(1 + w)`` scale and the mean taken in fp32."""
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * scale) * (1.0 + w.to(torch.float32))).to(x.dtype)
