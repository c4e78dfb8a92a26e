"""Batched periodic 1-D hyperdiffusion, Crank–Nicolson (paper §IV.B-C).

Counterpart of ``repro.pde.hyperdiffusion``:

    dC/dt = -D d4C/dx4,  periodic,  D = L = 1 after rescaling.

Implicit LHS (Eq. 20a): a_i = e_i = sigma, b_i = d_i = -4 sigma,
c_i = 1 + 6 sigma with sigma = dt / (2 dx^4) — a *uniform* pentadiagonal
operator, so all three paper variants apply: ``mode`` is ``constant``
(cuPentConstantBatch), ``uniform`` (cuPentUniformBatch) or ``batch``
(cuPentBatch, needs ``batch=M``).  Steps go through ``repro_torch.solver``
only (``backend`` is ``reference``, ``cuda`` or ``auto``); the fused
hyperdiffusion step is ``repro_torch.kernels.fused_cn.fused_cn_penta_step``,
which this class does not call, as the JAX class does not.  ``run`` is a
Python loop (JAX's ``use_scan`` has no counterpart).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..solver import BandedSystem, factorize, solve
from .stencil import cn_rhs_hyperdiffusion


@dataclasses.dataclass(frozen=True)
class HyperdiffusionCN:
    n: int
    dt: float
    backend: str = "reference"  # reference | cuda | auto
    mode: str = "constant"      # constant | uniform | batch (baseline)
    batch: int | None = None    # required for mode="batch"
    dtype: torch.dtype = torch.float32
    device: object = None       # None: the CUDA device

    @property
    def dx(self) -> float:
        return 1.0 / self.n

    @property
    def sigma(self) -> float:
        return self.dt / (2.0 * self.dx ** 4)

    def coefficients(self):
        s = self.sigma
        return (s, -4.0 * s, 1.0 + 6.0 * s, -4.0 * s, s)

    def system(self) -> BandedSystem:
        return BandedSystem.penta(*self.coefficients(), n=self.n,
                                  periodic=True, mode=self.mode,
                                  batch=self.batch, dtype=self.dtype,
                                  device=self.device)

    def step_fn(self):
        """Returns (factorization, step); step closes over the factor."""
        fact = factorize(self.system(), backend=self.backend)
        s = self.sigma

        def step(field):
            return solve(fact, cn_rhs_hyperdiffusion(field, s))
        return fact, step

    def run(self, field0: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Integrate ``n_steps``: factor once, loop over the solve."""
        _, step = self.step_fn()
        f = field0
        for _ in range(n_steps):
            f = step(f)
        return f

    @staticmethod
    def analytic(x: np.ndarray, t: float, k: int = 1) -> np.ndarray:
        """C(x,0) = sin(2 pi k x) -> exp(-(2 pi k)^4 t) sin(2 pi k x)."""
        return np.exp(-((2 * np.pi * k) ** 4) * t) * np.sin(2 * np.pi * k * x)
