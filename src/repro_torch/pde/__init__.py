"""PDE substrate: the paper's application layer, on the port.

Counterpart of ``repro.pde``: batched 1-D Crank–Nicolson integration of the
diffusion (paper §III.B) and hyperdiffusion (paper §IV.B) equations on
periodic domains, and a 2-D ADI scheme.  The stencils are plain torch; the
implicit solves are ``repro_torch.solver``'s constant-LHS batch solves,
or, for ``DiffusionCN(backend="fused")``, one fused kernel per step.
"""

from .adi2d import ADI2D
from .diffusion import DiffusionCN
from .hyperdiffusion import HyperdiffusionCN
from .stencil import apply_periodic_stencil

__all__ = ["ADI2D", "DiffusionCN", "HyperdiffusionCN", "apply_periodic_stencil"]
