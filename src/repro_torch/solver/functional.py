"""The solver API: ``factorize`` once, then ``solve`` / ``transpose_solve``.

Counterpart of ``repro.solver.functional``:

    from repro_torch.solver import BandedSystem, factorize, solve

    fact = factorize(system, backend="auto")     # factor ONCE
    x = solve(fact, rhs)                         # rhs: (N,) or (N, M)
    lam = transpose_solve(fact, g)               # A^T lam = g, same factor

  * ``Factorization`` is a frozen dataclass: the stored factor, the
    spec's (N,) diagonals (what ``torch.autograd`` gives gradients to) and
    ``SolveMeta``, the static description every solve dispatches on.
  * ``solve`` (``repro_torch.solver.autodiff``) is a
    ``torch.autograd.Function`` whose backward solves the TRANSPOSED
    system on the same stored factor.

``backend="auto"`` picks ``cuda`` wherever the JAX package picks
``pallas``: the shared-LHS modes at any N (the shared sweep kernel) and
Dirichlet ``batch`` mode (the batch sweep kernel, factorisation fused into
the solve).  Periodic ``batch`` mode has no kernel in either package and
goes to ``reference``.  The ``cuda`` backend runs its kernels on CUDA
tensors and their plain versions on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .registry import get_pure_backend
from .system import BandedSystem

# Tiling knobs of the TPU kernels.  They have no meaning on Hopper, where
# one thread walks all N rows of its system.
_TPU_KNOBS = {
    "block_m": "the TPU lane tile; the CUDA kernel gives each system one "
               "thread",
    "block_n": "the TPU's VMEM chunk of N; the CUDA kernel walks all of N "
               "and stages the factor through shared memory",
    "fused": "the choice between one and two TPU kernel calls; the CUDA "
             "kernel always runs both passes in one launch",
    "prefetch": "TPU double-buffered DMA; the CUDA kernel has no such "
                "option",
    "interpret": "Pallas interpret mode; tensors on the CPU run the plain "
                 "torch version instead",
}


@dataclasses.dataclass(frozen=True)
class SolveMeta:
    """Everything a solve dispatches on.  ``options`` is a sorted tuple of
    (key, value) pairs of RESOLVED backend options."""

    bandwidth: int
    n: int
    mode: str
    periodic: bool
    backend: str
    options: tuple = ()

    def opt(self, key: str, default=None):
        for k, v in self.options:
            if k == key:
                return v
        return default

    def with_options(self, **updates) -> "SolveMeta":
        opts = dict(self.options)
        opts.update({k: v for k, v in updates.items() if v is not None})
        return dataclasses.replace(self, options=tuple(sorted(opts.items())))


@dataclasses.dataclass(frozen=True)
class Factorization:
    """A factored LHS: ``stored`` is the backend's factor (the paper's
    O(k·N) shared storage), ``diagonals`` the spec's (N,) diagonals, which
    receive the gradient of a solve (the stored factor receives none)."""

    diagonals: tuple
    stored: Any
    meta: SolveMeta

    @property
    def backend(self) -> str:
        return self.meta.backend

    def describe(self) -> str:
        """e.g. ``tridiag/periodic/constant/N=512@cuda``."""
        kind = "tridiag" if self.meta.bandwidth == 3 else "penta"
        bc = "periodic" if self.meta.periodic else "dirichlet"
        return (f"{kind}/{bc}/{self.meta.mode}/N={self.meta.n}"
                f"@{self.meta.backend}")


def select_backend(system: BandedSystem) -> str:
    """The ``backend="auto"`` policy: the CUDA kernels serve every
    shared-LHS system and every Dirichlet batch system at any N (Hopper
    has no VMEM wall); periodic batch has no kernel and stays on the
    reference."""
    if system.mode == "batch" and system.periodic:
        return "reference"
    return "cuda"


def resolve_backend_name(system: BandedSystem, backend: str) -> str:
    return select_backend(system) if backend == "auto" else backend


def check_options(opts: dict) -> None:
    """Raise ``TypeError`` on a TPU tiling knob, saying why it has none
    of its meaning here."""
    for key in opts:
        if key in _TPU_KNOBS:
            raise TypeError(f"{key!r} is not an option of repro_torch: it is "
                            f"{_TPU_KNOBS[key]}")


def factorize(system: BandedSystem, backend: str = "auto",
              **opts) -> Factorization:
    """Factor ``system`` once.

    ``backend`` is ``reference``, ``cuda`` or ``"auto"``.  Options:
    ``method`` (reference: ``"scan"``); ``storage_dtype`` (cuda: e.g.
    ``"bf16"`` stores factor and RHS at bf16 and computes in fp32).  The
    factor is built without
    autograd history; gradients reach the diagonals through ``solve``."""
    check_options(opts)
    backend = resolve_backend_name(system, backend)
    pure = get_pure_backend(backend)
    with torch.no_grad():
        stored, options = pure.build(system, **opts)
    meta = SolveMeta(bandwidth=system.bandwidth, n=system.n,
                     mode=system.mode, periodic=system.periodic,
                     backend=backend, options=tuple(sorted(options.items())))
    return Factorization(diagonals=tuple(system.diagonals), stored=stored,
                         meta=meta)


def _check_batch_width(factorization: Factorization, rhs) -> None:
    """batch mode stores per-system LHS copies: rhs width must match."""
    if factorization.meta.mode != "batch":
        return
    stored_m = next(iter(factorization.stored.values())).shape[1]
    m = 1 if rhs.ndim == 1 else rhs.shape[1]
    if m != stored_m:
        raise ValueError(f"batch-mode factorization built for M={stored_m} "
                         f"per-system LHS copies but rhs has M={m}")


def solve_impl(factorization: Factorization, rhs: torch.Tensor) -> torch.Tensor:
    """The raw solve (no autograd rule) — dispatch on the meta."""
    meta = factorization.meta
    _check_batch_width(factorization, rhs)
    return get_pure_backend(meta.backend).solve(meta, factorization.stored,
                                                rhs)


def transpose_solve(factorization: Factorization,
                    rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``A^T x = rhs`` reusing the FORWARD factorization: no
    transposed refactorisation, no second LHS copy."""
    meta = factorization.meta
    _check_batch_width(factorization, rhs)
    return get_pure_backend(meta.backend).transpose_solve(
        meta, factorization.stored, rhs)


def with_options(factorization: Factorization, **updates) -> Factorization:
    """A copy of ``factorization`` with per-call option overrides
    (``None`` values are ignored, not unset).  Tensors are shared."""
    check_options(updates)
    return dataclasses.replace(factorization,
                               meta=factorization.meta.with_options(**updates))
