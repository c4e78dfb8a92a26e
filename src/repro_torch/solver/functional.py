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

# Knobs of the JAX package that have no meaning here: the TPU kernels'
# tiling and the scan's unroll factor.  The CUDA kernels size themselves
# from (N, dtype) (``kernels.ops.shared_route``): a tile of 32 systems over
# all N rows in shared memory up to N = 1614 (fp32, bf16) / 807 (fp64),
# each column swept in row chunks at once; past that, row blocks of 512 /
# 256 rows in four launches (coefficients, summaries, chain, finish).
_JAX_KNOBS = {
    "block_m": "the TPU lane tile; the CUDA kernels pick their own tiles "
               "of systems and mask the ragged edge of M themselves",
    "block_n": "the TPU's VMEM chunk of N; the CUDA kernel keeps a tile of "
               "all N rows in shared memory up to N = 1614 (fp32) / 807 "
               "(fp64) and splits longer columns into row blocks itself",
    "fused": "the choice between one and two TPU kernel calls; the CUDA "
             "kernel sweeps both passes of a tile in one launch, or of a "
             "row block in its partitioned route's four launches",
    "prefetch": "TPU double-buffered DMA; the CUDA kernel overlaps its "
                "loads with the sweep itself (cp.async)",
    "interpret": "Pallas interpret mode; tensors on the CPU run the plain "
                 "torch version instead",
    "unroll": "the unroll factor of jax.lax.scan; the plain torch loops and "
              "the CUDA kernels take none",
}

# the JAX package's legacy spelling of the reference backend
ALIASES = {"core": "reference"}


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
    """``backend`` with ``ALIASES`` applied, ``"auto"`` resolved."""
    backend = ALIASES.get(backend, backend)
    return select_backend(system) if backend == "auto" else backend


def check_options(opts: dict) -> None:
    """Raise ``TypeError`` on a knob of ``_JAX_KNOBS``, saying why it has
    none of its meaning here."""
    for key in opts:
        if key in _JAX_KNOBS:
            raise TypeError(f"{key!r} is not an option of repro_torch: it is "
                            f"{_JAX_KNOBS[key]}")


def factorize(system: BandedSystem, backend: str = "auto",
              **opts) -> Factorization:
    """Factor ``system`` once.

    ``backend`` is ``reference`` (alias ``core``), ``cuda``,
    ``sharded`` (ranks of a ``torch.distributed`` process group) or
    ``"auto"`` (never ``sharded``).  Options, the union over backends,
    each ignored by the backends it does not apply to (as in the JAX
    package): ``method`` (reference: ``"scan"``); ``storage_dtype``
    (cuda: e.g. ``"bf16"`` stores factor and RHS at bf16 and computes in
    fp32); ``mesh``, ``batch_axis`` and ``kernels`` (sharded).  The
    factor is built without autograd history; gradients reach the
    diagonals through ``solve``."""
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
