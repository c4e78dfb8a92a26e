"""``cuda`` backend: the hand-written Hopper sweep kernels.

Counterpart of ``repro.solver.pallas``.  There is no VMEM wall and no
tuner: the backend serves every constant/uniform system at any N through
the shared sweep (``kernels/csrc/shared_sweep.cu``), whose route
``kernels.ops.shared_route`` picks from (N, dtype).  Up to N = 1614 (fp32,
bf16) / 807 (fp64) a block holds a tile of 32 systems over all N rows in
shared memory and sweeps each column in row chunks at once, fixed up by
the chunks' carry responses; past that the partitioned route cuts each
column into row blocks of 512 / 256 rows (four launches: coefficients,
summaries, chain, finish).  Every Dirichlet batch system goes to the batch
sweep (``kernels/csrc/batch_sweep.cu``), each system's own diagonals
factored inside the solve, on the route ``kernels.ops.batch_route``
picks: a tridiagonal system up to N = 512 (fp32, bf16) / 256 (fp64) on
chip (32 systems a block, their rows in chunks of 16 joined by folds of
the factor's 2×2 companion products and of the linear carries, each
operand read once and x written once); past that, and every
pentadiagonal system, streamed (one thread a system, the factor and
intermediate through device memory).  A pentadiagonal on-chip tile exists
(``route="onchip"`` of ``kernels.ops.batch_sweep_cuda``) but ran slower
than the stream kernel, so the rule never takes it.  On CPU tensors the
same calls run the kernels' plain versions (``kernels.ops``), in the
route's chunks.

Periodic boundaries: the kernel solves the truncated band; the rank-1
Sherman-Morrison (tridiag) / rank-4 Woodbury (penta) corner corrections
are plain torch around it — a few O(M) dots, the paper's 2-kernel
pipeline.  The adjoint runs the kernel's transposed variants on the SAME
stored factor and transposes the corners from the stored ``zt``/``Zt``.

Batch mode: the stored state is the per-system diagonal copies (the
reference's tiling, the O((k+1)·N·M) storage of cuThomasBatch).  Rolling
them turns A^T into another batch system, so the FORWARD batch kernel
serves the adjoint: the entries the roll wraps across the Dirichlet
boundary only ever multiply a zero carry.  Periodic batch has no kernel
here, as it has none in the JAX package: ``auto`` sends it to
``reference``.
"""

from __future__ import annotations

import torch

from ..core import penta as _penta
from ..core import tridiag as _tridiag
from ..kernels import ops as _kops
from . import reference as _ref
from .registry import register_backend, register_pure_backend
from .system import BandedSystem

_PERIODIC_BATCH_MESSAGE = (
    "the cuda backend has no kernel for periodic per-system-LHS systems "
    "(mode='batch', periodic=True), and neither has the JAX package's "
    "pallas backend; use backend='reference' or 'auto'")


def build_stored(system: BandedSystem):
    """Factor once into the kernel-facing stored factor: the reference
    factors, with uniform mode kept full-vector (the kernel reads a
    stacked LHS); batch mode tiles the per-system diagonal copies."""
    if system.mode == "batch" and system.periodic:
        raise NotImplementedError(_PERIODIC_BATCH_MESSAGE)
    return _ref.build_stored(system, scalarize_uniform=False)


def _batch_sweep(bandwidth: int, diags: tuple, rhs, kw: dict):
    if bandwidth == 3:
        return _kops.thomas_batch(*diags, rhs, **kw)
    return _kops.penta_batch(*diags, rhs, **kw)


def _sweep(bandwidth: int, uniform: bool, factor, rhs, transposed: bool,
           kw: dict) -> torch.Tensor:
    if bandwidth == 3:
        return _kops.thomas_constant(factor, rhs, transposed=transposed, **kw)
    return _kops.penta_constant(factor, rhs, uniform=uniform,
                                transposed=transposed, **kw)


def solve_stored(bandwidth: int, mode: str, periodic: bool, stored,
                 rhs: torch.Tensor, *, storage_dtype=None) -> torch.Tensor:
    """A x = rhs through the kernel, rhs (N,) or (N, M)."""
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    kw = dict(storage_dtype=storage_dtype)
    uniform = mode == "uniform"
    if mode == "batch":
        x = _batch_sweep(bandwidth, _ref.batch_diagonals(bandwidth, stored),
                         rhs, kw)
    elif not periodic:
        x = _sweep(bandwidth, uniform, stored, rhs, False, kw)
    elif bandwidth == 3:
        pf = stored
        y = _sweep(3, uniform, pf.factor, rhs, False, kw)
        # rank-1 Sherman-Morrison corner correction (paper Eq. 15)
        v_dot_y = y[0] + pf.v_last * y[-1]
        x = y - (v_dot_y * pf.inv_denom_sm) * pf.z[:, None]
    else:
        pf = stored
        y = _sweep(5, uniform, pf.factor, rhs, False, kw)
        # rank-4 Woodbury corner correction: (4, M) dots and an (N,4)·(4,M)
        w = pf.Minv @ _penta._vty(pf.vcoef, y)
        x = y - pf.Z @ w
    return x[:, 0] if squeeze else x


def transpose_solve_stored(bandwidth: int, mode: str, periodic: bool, stored,
                           rhs: torch.Tensor, *,
                           storage_dtype=None) -> torch.Tensor:
    """A^T x = rhs through the kernel's transposed variants, from the SAME
    stored factor; periodic corners transpose from the stored aux.  Batch
    mode runs the forward batch kernel on the rolled diagonals."""
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    kw = dict(storage_dtype=storage_dtype)
    uniform = mode == "uniform"
    if mode == "batch":
        x = _batch_sweep(bandwidth,
                         _ref.transposed_batch_diagonals(bandwidth, stored),
                         rhs, kw)
    elif not periodic:
        x = _sweep(bandwidth, uniform, stored, rhs, True, kw)
    else:
        y = _sweep(bandwidth, uniform, stored.factor, rhs, True, kw)
        core = _tridiag if bandwidth == 3 else _penta
        x = core.periodic_corner_correction_t(stored, y)
    return x[:, 0] if squeeze else x


# -- the pure-function contract (repro_torch.solver.functional) --------------

def _pure_build(system: BandedSystem, *, storage_dtype=None, **_ignored):
    sdt = _kops.canonical_storage_dtype(storage_dtype)
    return build_stored(system), {"storage_dtype": sdt}


def _pure_solve(meta, stored, rhs):
    return solve_stored(meta.bandwidth, meta.mode, meta.periodic, stored, rhs,
                        storage_dtype=meta.opt("storage_dtype"))


def _pure_transpose(meta, stored, rhs):
    return transpose_solve_stored(meta.bandwidth, meta.mode, meta.periodic,
                                  stored, rhs,
                                  storage_dtype=meta.opt("storage_dtype"))


register_pure_backend("cuda", build=_pure_build, solve=_pure_solve,
                      transpose_solve=_pure_transpose)


@register_backend("cuda")
class CudaBackend:
    """The sweep kernel behind ``plan``: holds a ``Factorization`` and routes
    ``solve`` through the differentiable entry point."""

    def __init__(self, system: BandedSystem, **opts):
        from .functional import factorize
        self.system = system
        self.fact = factorize(system, backend="cuda", **opts)
        self.stored = self.fact.stored

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        from .autodiff import solve as _solve
        return _solve(self.fact, rhs)
