"""Hand-written Hopper kernels of the port, their plain versions, and the
sweep descriptions that drive them (``engine``).

Counterpart of ``repro.kernels``, with its public names: the registry of
variants (``REGISTRY``, ``SweepSpec``, ``RecurrenceSpec``, ``find_spec``,
``find_recurrence_spec``), the entry points (``thomas_constant``,
``thomas_batch``, ``penta_constant``, ``penta_batch``, ``recurrence``, the
fused CN steps ``fused_cn_step`` / ``fused_cn_penta_step``), the factor
stacking (``stack_tridiag_lhs``, ``stack_penta_lhs``), ``sharded_solve``,
and the traffic model: ``solver_hbm_traffic_bytes``,
``recurrence_hbm_traffic_bytes``, ``traffic_table`` and
``recurrence_traffic_table`` give the bytes a solve moves through device
memory on a route of its kernel (``route=``, where the JAX package takes
its TPU tilings ``streamed=`` / ``fused=``).  Each entry point runs its
CUDA kernel on CUDA tensors (``csrc/``, built at first use) and its plain
version on CPU tensors.
"""

from .engine import (REGISTRY, RecurrenceSpec, SweepSpec, find_recurrence_spec,
                     find_spec)
from .fused_cn import fused_cn_penta_step, fused_cn_step
from .ops import (penta_batch, penta_constant, recurrence,
                  recurrence_hbm_traffic_bytes, recurrence_traffic_table,
                  sharded_solve, solver_hbm_traffic_bytes, stack_penta_lhs,
                  stack_tridiag_lhs, thomas_batch, thomas_constant,
                  traffic_table)

__all__ = [
    "REGISTRY", "RecurrenceSpec", "SweepSpec", "find_recurrence_spec",
    "find_spec", "recurrence_traffic_table", "traffic_table",
    "fused_cn_penta_step", "fused_cn_step", "penta_batch", "penta_constant",
    "recurrence", "recurrence_hbm_traffic_bytes",
    "sharded_solve", "solver_hbm_traffic_bytes", "stack_penta_lhs",
    "stack_tridiag_lhs", "thomas_batch", "thomas_constant",
]
