"""Periodic finite-difference stencils on interleaved (N, M) field batches.

Counterpart of ``repro.pde.stencil`` (the paper computes its CN right-hand
sides with cuSten): plain torch, one ``torch.roll`` per nonzero weight.
"""

from __future__ import annotations

import torch


def apply_periodic_stencil(field: torch.Tensor, weights) -> torch.Tensor:
    """Apply a centred periodic stencil along axis 0 of ``field``.

    field:   (N, ...) interleaved batch (N = grid axis).
    weights: sequence of length 2r+1 (offset -r..+r).
    """
    weights = list(weights)
    r = (len(weights) - 1) // 2
    out = torch.zeros_like(field)
    for k, w in enumerate(weights):
        if w == 0:
            continue
        out = out + w * torch.roll(field, -(k - r), dims=0)
    return out


def cn_rhs_diffusion(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Paper Eq. (9) RHS: sigma C_{i-1} + (1-2 sigma) C_i + sigma C_{i+1}."""
    return apply_periodic_stencil(field, [sigma, 1.0 - 2.0 * sigma, sigma])


def cn_rhs_hyperdiffusion(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Paper Eq. (20b) RHS: -sigma C_{i-2} + 4 sigma C_{i-1}
    + (1-6 sigma) C_i + 4 sigma C_{i+1} - sigma C_{i+2}."""
    return apply_periodic_stencil(
        field, [-sigma, 4.0 * sigma, 1.0 - 6.0 * sigma, 4.0 * sigma, -sigma])
