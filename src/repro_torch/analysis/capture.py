"""An operand recount of the traffic model: read what the kernels are handed.

Counterpart of ``repro.analysis.capture``'s ``recount_traffic_words``.
The reference swaps ``pl.pallas_call`` for a recorder and counts the
blocks each BlockSpec streams.  The port does not trace its CUDA sources,
so the recount reads what each kernel's entry point is handed: for every
``engine.REGISTRY`` spec and both fused CN steps, the operands
``nansweep.operands`` builds at ``TRACE_N x TRACE_M`` (the reference's
trace size), cast to the storage type, go through the CPU dispatch the
card's wrapper mirrors (``ops.shared_sweep``, ``ops.batch_sweep``,
``ops.recurrence_sweep``, ``fused_cn.fused_cn_tridiag`` /
``fused_cn_penta``), and the recount sums ``numel x itemsize`` of every
operand the kernel reads once and of the output it returns, at the type
it returns it (the compute type for the sweeps, the operand type for the
recurrences).  It never reads ``traffic_words``, ``storage_words`` or
``compute_words``.

``speccheck`` holds the recount against the model the launch counter
books (``spec.traffic_bytes(n, m, dtype)`` a launch, ``ops.LAUNCH_BYTES``)
and ``fused_cn.{tridiag,penta}_traffic_bytes``; a mismatch is an "HBM
traffic drift".
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import engine, fused_cn, ops

from . import nansweep

#: The reference's trace size, which ``speccheck``'s accounting checks
#: price too.
TRACE_N, TRACE_M = 48, 24
#: The storage types recounted: the sweeps and recurrences at fp32 and
#: bf16, the fused steps (float32 or float64 only) at fp32 and fp64.
DTYPES = (torch.float32, torch.bfloat16)
FUSED_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class Recount:
    """One kernel's operands at one storage type, and what they weigh."""

    subject: str
    dtype: torch.dtype
    read_bytes: int        # every operand, read once
    write_bytes: int       # the output, written once
    words: int             # operand and output elements

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.write_bytes


def _dispatch(layout: str, spec, args: list, rhs: torch.Tensor):
    """The CPU dispatch of the kernel's entry point (the plain version the
    card's wrapper mirrors) on ``args`` and ``rhs``."""
    if layout == "shared":
        lhs, eps = args
        return ops.shared_sweep(spec, lhs, rhs, eps)
    if layout == "batch":
        return ops.batch_sweep(spec, args, rhs)
    if layout == "recurrence":
        return ops.recurrence_sweep(spec, args, rhs)
    fn = fused_cn.fused_cn_tridiag if spec == nansweep.FUSED[0] \
        else fused_cn.fused_cn_penta
    return fn(*args, rhs)


def recount(layout: str, spec, dtype) -> Recount:
    """The operand recount of one kernel at storage type ``dtype``, at
    ``TRACE_N x TRACE_M``."""
    args, rhs = nansweep.operands(layout, spec, TRACE_N, TRACE_M)
    args = [None if a is None else a.to(dtype) for a in args]
    rhs = rhs.to(dtype)
    out = _dispatch(layout, spec, args, rhs)
    operands = [a for a in args if a is not None] + [rhs]
    subject = spec if isinstance(spec, str) else spec.name
    return Recount(
        subject=subject, dtype=dtype,
        read_bytes=sum(t.numel() * t.element_size() for t in operands),
        write_bytes=out.numel() * out.element_size(),
        words=sum(t.numel() for t in operands) + out.numel())


def recount_all() -> list:
    """``Recount`` of every swept kind at each of its storage types."""
    out = []
    for subject, layout, spec in nansweep.kinds():
        for dtype in FUSED_DTYPES if layout == "fused" else DTYPES:
            out.append(recount(layout, spec, dtype))
    return out


def modelled_bytes(subject: str, n: int, m: int, dtype) -> int:
    """What the model books for one launch at ``dtype`` storage: the spec's
    ``traffic_bytes`` as the launch counter calls it, or the fused step's
    ``"fused"`` bytes."""
    if subject in nansweep.FUSED:
        fn = fused_cn.tridiag_traffic_bytes if subject == nansweep.FUSED[0] \
            else fused_cn.penta_traffic_bytes
        return fn(n, m, dtype)["fused"]
    return engine.REGISTRY[subject].traffic_bytes(n, m, dtype)


def modelled_words(subject: str, n: int, m: int) -> int:
    """The model's words for one launch (the fused step's bytes at fp32
    over 4)."""
    if subject in nansweep.FUSED:
        return modelled_bytes(subject, n, m, torch.float32) // 4
    return engine.REGISTRY[subject].traffic_words(n, m)
