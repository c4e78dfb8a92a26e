"""DEPRECATED operator-level API — thin shims over ``repro_torch.solver``.

Counterpart of ``repro.core.banded``.  ``TridiagOperator`` /
``PentaOperator`` keep the JAX package's call signatures (plus ``device``,
the CUDA device unless ``device="cpu"``) and warn with a
``DeprecationWarning``.  New code should use::

    from repro_torch.solver import BandedSystem, plan
    p = plan(BandedSystem.tridiag(a, b, c, n=n, mode="constant"))
    x = p.solve(rhs)

The three storage modes mirror the paper's comparison matrix:

  * ``constant`` — ONE shared LHS for the whole batch (the paper's
    contribution).  Storage O(k·N + M·N), k = 3 (tridiag) or 5 (penta).
  * ``batch``    — per-system LHS copies, factor fused into every solve
    (the prior state of the art).  Storage O((k+1)·M·N).
  * ``uniform``  — all entries of each diagonal equal: the eps/a vector
    degenerates to a scalar.  Storage O((k-1)·N + M·N).

``storage_bytes()`` reports the bytes the operator holds, so the paper's
~75 % / ~83 % reduction claims are measured rather than quoted.  Both
operators factor on the ``reference`` backend, as JAX's do.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

_DEPRECATION = ("%s is deprecated; use repro_torch.solver.plan("
                "BandedSystem.%s(...)) — the operators remain for one "
                "release as shims.")


def _storage(stored, mode: str, n: int, rhs_batch, itemsize: int) -> dict:
    from repro_torch.solver.plan import _nbytes
    lhs = _nbytes(stored)
    out = {"lhs_bytes": lhs, "mode": mode, "n": n}
    if rhs_batch is not None:
        out["rhs_bytes"] = n * rhs_batch * itemsize
        out["total_bytes"] = lhs + out["rhs_bytes"]
    return out


def _reference_stored(system, **opts):
    # lazy: repro_torch.solver imports repro_torch.core
    from repro_torch.solver import plan
    return plan(system, backend="reference", **opts).impl.stored


@dataclasses.dataclass(frozen=True)
class TridiagOperator:
    """Batched tridiagonal solve with selectable storage mode (deprecated
    shim over ``repro_torch.solver``)."""

    mode: str                  # constant | batch | uniform
    periodic: bool
    n: int
    stored: Any                # factor (constant/uniform) or raw diagonals (batch)

    @classmethod
    def create(cls, a, b, c, *, n: int | None = None, mode: str = "constant",
               periodic: bool = False, batch: int | None = None,
               dtype=torch.float32, method: str = "scan",
               device=None) -> "TridiagOperator":
        warnings.warn(_DEPRECATION % ("TridiagOperator", "tridiag"),
                      DeprecationWarning, stacklevel=2)
        from repro_torch.solver import BandedSystem
        system = BandedSystem.tridiag(a, b, c, n=n, mode=mode,
                                      periodic=periodic, batch=batch,
                                      dtype=dtype, device=device)
        return cls(mode=mode, periodic=periodic, n=system.n,
                   stored=_reference_stored(system, method=method))

    def solve(self, d: torch.Tensor, *, method: str = "scan") -> torch.Tensor:
        """d: (N,) or (N, M) interleaved RHS batch."""
        from repro_torch.solver import reference as _ref
        return _ref.solve_stored(3, self.mode, self.periodic, self.n,
                                 self.stored, d, method=method)

    def storage_bytes(self, *, rhs_batch: int | None = None,
                      itemsize: int = 4) -> dict:
        return _storage(self.stored, self.mode, self.n, rhs_batch, itemsize)


@dataclasses.dataclass(frozen=True)
class PentaOperator:
    """Batched pentadiagonal solve (deprecated shim over
    ``repro_torch.solver``)."""

    mode: str
    periodic: bool
    n: int
    stored: Any

    @classmethod
    def create(cls, a, b, c, d, e, *, n: int | None = None,
               mode: str = "constant", periodic: bool = False,
               batch: int | None = None, dtype=torch.float32,
               device=None) -> "PentaOperator":
        warnings.warn(_DEPRECATION % ("PentaOperator", "penta"),
                      DeprecationWarning, stacklevel=2)
        from repro_torch.solver import BandedSystem
        system = BandedSystem.penta(a, b, c, d, e, n=n, mode=mode,
                                    periodic=periodic, batch=batch,
                                    dtype=dtype, device=device)
        return cls(mode=mode, periodic=periodic, n=system.n,
                   stored=_reference_stored(system))

    def solve(self, rhs: torch.Tensor, *, method: str = "scan") -> torch.Tensor:
        from repro_torch.solver import reference as _ref
        return _ref.solve_stored(5, self.mode, self.periodic, self.n,
                                 self.stored, rhs, method=method)

    def storage_bytes(self, *, rhs_batch: int | None = None,
                      itemsize: int = 4) -> dict:
        return _storage(self.stored, self.mode, self.n, rhs_batch, itemsize)
