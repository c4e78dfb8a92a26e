"""repro_torch.solver — the public entry point for the banded solves.

Counterpart of ``repro.solver``, with the same names:

    from repro_torch.solver import BandedSystem, factorize, solve

    system = BandedSystem.tridiag(-s, 1 + 2 * s, -s, n=512, periodic=True)
    fact = factorize(system, backend="auto")   # factor ONCE
    x = solve(fact, rhs)                       # rhs: (N,) or (N, M)
    x.pow(2).sum().backward()                  # adjoint on the same factor

``BandedSystem`` puts its diagonals on the CUDA device unless given
``device="cpu"``.  Backends:

  * ``reference`` — plain-torch loops over N from ``repro_torch.core``
    (the oracle; the only backend of periodic ``batch`` mode);
  * ``cuda``      — the hand-written Hopper kernels on CUDA tensors (the
    shared sweep, and the batch sweep for Dirichlet ``batch`` mode),
    their plain-torch versions on CPU tensors;
  * ``sharded``   — M sharded over the ranks of a ``torch.distributed``
    mesh, the factor replicated on each, every rank running ``cuda`` (or
    ``reference``) on its own columns (``repro_torch.solver.sharded``);
  * ``auto``      — ``cuda`` for ``constant``, ``uniform`` and Dirichlet
    ``batch``, ``reference`` for periodic ``batch``; never ``sharded``.

``MODES`` is the tuple of storage-mode names.
"""

from .functional import (Factorization, SolveMeta, factorize,
                         transpose_solve, with_options)
from .plan import Plan, plan
from .registry import (available_backends, get_backend, get_pure_backend,
                       register_backend, register_pure_backend)
from .system import MODES, BandedSystem

# importing the backend modules populates the registries
from . import cuda as _cuda_backend            # noqa: F401,E402
from . import reference as _reference_backend  # noqa: F401,E402
from . import sharded as _sharded_backend      # noqa: F401,E402

from .autodiff import solve                    # noqa: E402

__all__ = [
    "BandedSystem",
    "Factorization",
    "MODES",
    "Plan",
    "SolveMeta",
    "available_backends",
    "factorize",
    "get_backend",
    "get_pure_backend",
    "plan",
    "register_backend",
    "register_pure_backend",
    "solve",
    "transpose_solve",
    "with_options",
]
