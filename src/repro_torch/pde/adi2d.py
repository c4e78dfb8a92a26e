"""2-D ADI (alternating-direction implicit) diffusion on a periodic grid —
the paper's §I motivating application for batched tridiagonal solves.

Counterpart of ``repro.pde.adi2d``.  Peaceman–Rachford splitting of
dC/dt = alpha (d2/dx2 + d2/dy2) C:

    (1 - sx Dxx) C*      = (1 + sy Dyy) C^n        (x-implicit half step)
    (1 - sy Dyy) C^{n+1} = (1 + sx Dxx) C*         (y-implicit half step)

with s = alpha dt / (2 h^2).  Each half step is a BATCH of 1-D periodic
tridiagonal solves sharing one LHS: the x-sweep batches over y (and any
field batch), the y-sweep over x, with the same axis moves as the JAX
stepper.  Both operators are factored once through ``repro_torch.solver``
(``backend`` ``reference``, ``cuda`` or ``auto``) on ``device``, the CUDA
device unless the caller asks for the CPU.  ``run`` is a Python loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..solver import BandedSystem, factorize, solve
from .stencil import apply_periodic_stencil


@dataclasses.dataclass(frozen=True)
class ADI2D:
    nx: int
    ny: int
    dt: float
    alpha: float = 1.0
    backend: str = "reference"
    dtype: torch.dtype = torch.float32
    device: object = None       # None: the CUDA device

    @property
    def sx(self) -> float:
        return self.alpha * self.dt / (2.0 * (1.0 / self.nx) ** 2)

    @property
    def sy(self) -> float:
        return self.alpha * self.dt / (2.0 * (1.0 / self.ny) ** 2)

    def _factorize(self, n, s):
        system = BandedSystem.tridiag(-s, 1.0 + 2.0 * s, -s, n=n,
                                      periodic=True, dtype=self.dtype,
                                      device=self.device)
        return factorize(system, backend=self.backend)

    def step_fn(self):
        fx = self._factorize(self.nx, self.sx)
        fy = self._factorize(self.ny, self.sy)
        sx, sy = self.sx, self.sy

        def step(field):
            """field: (NX, NY) or (NX, NY, B)."""
            # x-implicit: RHS = (1 + sy Dyy) C  (apply along y)
            cy = field.reshape(field.shape[0], field.shape[1], -1)
            rhs = cy + sy * apply_periodic_stencil(
                torch.movedim(cy, 1, 0), [1.0, -2.0, 1.0]).transpose(0, 1)
            c_star = solve(fx, rhs.reshape(field.shape[0], -1))
            c_star = c_star.reshape(cy.shape)
            # y-implicit: RHS = (1 + sx Dxx) C*  (apply along x)
            rhs2 = c_star + sx * apply_periodic_stencil(c_star,
                                                        [1.0, -2.0, 1.0])
            rhs2_t = torch.movedim(rhs2, 1, 0)               # (NY, NX, B)
            c_next = solve(fy, rhs2_t.reshape(field.shape[1], -1))
            c_next = torch.movedim(c_next.reshape(rhs2_t.shape), 0, 1)
            return c_next.reshape(field.shape)

        return step

    def run(self, field0: torch.Tensor, n_steps: int) -> torch.Tensor:
        step = self.step_fn()
        f = field0
        for _ in range(n_steps):
            f = step(f)
        return f

    @staticmethod
    def analytic(x, y, t, kx: int = 1, ky: int = 1, alpha: float = 1.0):
        """C0 = sin(2 pi kx x) sin(2 pi ky y) -> decay
        exp(-4 pi^2 (kx^2+ky^2) alpha t)."""
        decay = np.exp(-4 * np.pi ** 2 * (kx ** 2 + ky ** 2) * alpha * t)
        return decay * np.sin(2 * np.pi * kx * x) * np.sin(2 * np.pi * ky * y)
