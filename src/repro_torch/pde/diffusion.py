"""Batched periodic 1-D diffusion, Crank–Nicolson (paper §III.B-D).

Counterpart of ``repro.pde.diffusion``:

    dC/dt = alpha d2C/dx2,  C(x+L) = C(x),  alpha = L = 1 after rescaling.

Implicit LHS (Eq. 11): a_i = -sigma, b_i = 1+2 sigma, c_i = -sigma with
sigma = dt / (2 dx^2); the LHS is IDENTICAL for every system in the batch —
the paper's single-LHS setting.  ``step_fn`` factors once and each step
solves through ``repro_torch.solver``:

  * ``backend="reference"`` — the plain-torch loops (the default, as in JAX);
  * ``backend="cuda"``      — the stencil in plain torch, the shared sweep
    kernel, and the Sherman–Morrison correction around it (the paper's
    pipeline);
  * ``backend="auto"``      — ``cuda`` (the solver's policy);
  * ``backend="fused"``     — one fused kernel per step
    (``repro_torch.kernels.fused_cn.fused_cn_step``).

The factor lives on ``device``, the CUDA device unless the caller asks for
the CPU.  ``run`` is a Python loop over the steps; JAX's ``use_scan`` (a
``lax.scan`` over the closed-over factor) has no counterpart and is not
accepted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import periodic_thomas_factor
from ..kernels.fused_cn import fused_cn_step
from ..solver import BandedSystem, factorize, solve
from ..spans import span
from .stencil import cn_rhs_diffusion


@dataclasses.dataclass(frozen=True)
class DiffusionCN:
    n: int
    dt: float
    backend: str = "reference"   # reference | cuda | auto | fused
    dtype: torch.dtype = torch.float32
    device: object = None        # None: the CUDA device

    @property
    def dx(self) -> float:
        return 1.0 / self.n

    @property
    def sigma(self) -> float:
        return self.dt / (2.0 * self.dx * self.dx)

    def system(self) -> BandedSystem:
        s = self.sigma
        return BandedSystem.tridiag(-s, 1.0 + 2.0 * s, -s, n=self.n,
                                    periodic=True, dtype=self.dtype,
                                    device=self.device)

    def factor(self):
        """The periodic factor of the CN LHS (the fused step's operand)."""
        return periodic_thomas_factor(*self.system().diagonals)

    def step_fn(self):
        """Returns (factor, step) where step(field (N, M)) -> next field;
        the factor is built ONCE here and every step reuses it.  Each step
        is the span ``pde.step``."""
        s = self.sigma
        if self.backend == "fused":
            pf = self.factor()

            def step(field):
                with span("pde.step"):
                    return fused_cn_step(pf, s, field)
            return pf, step

        fact = factorize(self.system(), backend=self.backend)

        def step(field):
            with span("pde.step"):
                return solve(fact, cn_rhs_diffusion(field, s))
        return fact, step

    def run(self, field0: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Integrate ``n_steps`` from field0 (N, M): factor once, loop."""
        _, step = self.step_fn()
        f = field0
        for _ in range(n_steps):
            f = step(f)
        return f

    @staticmethod
    def analytic(x: np.ndarray, t: float, k: int = 1) -> np.ndarray:
        """C(x,0) = sin(2 pi k x)  ->  exp(-4 pi^2 k^2 t) sin(2 pi k x)."""
        return np.exp(-4.0 * np.pi ** 2 * k ** 2 * t) * np.sin(2 * np.pi * k * x)
