"""Paper core: constant-LHS interleaved batch banded solvers (plain torch).

Counterpart of ``repro.core``: the low-level factor/solve pairs, as loops
over N vectorised over the batch.  The public entry point is
``repro_torch.solver``; its ``reference`` backend calls these functions,
and every backend builds its stored factor with them.
"""

from .penta import (
    PentaFactor,
    PeriodicPentaFactor,
    dense_penta,
    penta_factor,
    penta_solve,
    penta_solve_t,
    periodic_penta_factor,
    periodic_penta_solve,
    periodic_penta_solve_t,
)
from .recurrence import linear_recurrence, linear_recurrence2
from .tridiag import (
    PeriodicTridiagFactor,
    TridiagFactor,
    dense_tridiag,
    periodic_thomas_factor,
    periodic_thomas_solve,
    periodic_thomas_solve_t,
    thomas_factor,
    thomas_solve,
    thomas_solve_t,
)

__all__ = [
    "PentaFactor", "PeriodicPentaFactor", "PeriodicTridiagFactor",
    "TridiagFactor", "dense_penta", "dense_tridiag",
    "linear_recurrence", "linear_recurrence2",
    "penta_factor", "penta_solve", "penta_solve_t",
    "periodic_penta_factor", "periodic_penta_solve", "periodic_penta_solve_t",
    "periodic_thomas_factor", "periodic_thomas_solve",
    "periodic_thomas_solve_t",
    "thomas_factor", "thomas_solve", "thomas_solve_t",
]
