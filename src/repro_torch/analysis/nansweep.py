"""Registry-driven NaN / write-coverage sweep over every kernel route.

Counterpart of ``repro.analysis.nansweep``.  The defect class is the
reference's dead-lane NaN (padding fed through a divide) and, on the
card, its Hopper sibling: an element of the output that no thread writes,
or a write past it, on some route at some ragged shape.  The cases come
from the engine ``REGISTRY`` and the port's routes, so a new spec or route
is swept the day it lands:

  * every ``REGISTRY`` spec on every route the port has for it — shared:
    on chip, partitioned, serial; batch: on chip, stream;
    recurrence: tile, walk — and both fused CN steps
    (``kernels/fused_cn.py``) on chip, partitioned and global;
  * the reference's three shape classes (``CASES``): ragged (45 x 70),
    dead-lane (33 x 3: most of a 32-column tile idle) and aligned
    (48 x 64), each route at its own chunk count (``ROUTES``), chosen so
    the ragged cases stay ragged against it: the tile routes in 4 row
    chunks (45 rows: 12, 12, 12, 9), the recurrence tile in windows of 2
    chunks of 8 rows (45 = 16 + 16 + 13), the partitioned routes in two
    row blocks (on the card at N + 512 rows, since the route cuts a float32
    column into blocks of 2048 bytes), split unevenly for the odd N.

``run(device="cpu")`` runs each route's plain version in that route's row
blocks and chunks under ``NonFiniteMode``, which raises on the first
non-finite intermediate (the counterpart of ``jax_debug_nans``), and
checks the output finite.  ``run(device="cuda")`` launches each kernel
with its route forced into an output buffer filled with NaN and fenced by
NaN guards on both sides: a finding names every element left NaN or made
non-finite, and any guard word written.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import (penta_factor, periodic_penta_factor,
                              periodic_thomas_factor, thomas_factor)
from repro_torch.kernels import engine, fused_cn, ops

from . import Finding

#: (case name, n, m): the reference's shape classes.
CASES = (
    ("ragged", 45, 70),
    ("dead-lane", 33, 3),
    ("aligned", 48, 64),
)
#: Row chunks of the tile routes, and of the recurrence tile's windows.
TILE_CHUNKS, RECURRENCE_CHUNKS = 4, 2
#: Rows of a row block of the partitioned routes at float32.
BLOCK_ROWS = ops.ROW_BLOCK_BYTES // 4
#: The routes of each kind of kernel: (route, plain row blocks, chunks).
ROUTES = {
    "shared": (("onchip", 1, TILE_CHUNKS), ("partition", 2, TILE_CHUNKS),
               ("serial", 1, 1)),
    "batch": (("onchip", 1, TILE_CHUNKS), ("stream", 1, 1)),
    "recurrence": (("walk", 1, 1), ("tile", 1, RECURRENCE_CHUNKS)),
    "fused": (("onchip", 1, TILE_CHUNKS), ("partition", 2, TILE_CHUNKS),
              ("global", 1, 1)),
}
FUSED = ("fused_cn_tridiag", "fused_cn_penta")
SIGMA = 0.4
#: Words of NaN fenced on either side of a kernel's output.
GUARD = 64


#: In-place ops that write part of their destination: checked on the
#: values they write, since the rest of the destination may still be the
#: uninitialised memory of an ``empty`` buffer.
PARTIAL_WRITES = ("aten::index_put_", "aten::_index_put_impl_",
                  "aten::index_copy_", "aten::index_fill_",
                  "aten::masked_fill_", "aten::masked_scatter_",
                  "aten::scatter_")


class NonFiniteMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` on the first op whose floating output
    holds a non-finite value.  Factory ops (``empty*``) and views make no
    values and are not checked; ``PARTIAL_WRITES`` are checked on the
    values they write."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        returns = func._schema.returns
        view = bool(returns) and returns[0].alias_info is not None \
            and not returns[0].alias_info.is_write
        if view or name.startswith(("aten::empty", "aten::new_empty")):
            return out
        written = tree_leaves((args[1:], kwargs)) if name in PARTIAL_WRITES \
            else tree_leaves(out)
        for t in written:
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and not torch.isfinite(t).all():
                raise FloatingPointError(f"{name} produced a non-finite "
                                         "value")
        return out


#: Ops through which a tensor's value reaches the host: ``.item()``,
#: ``float(t)``, ``int(t)`` and ``bool(t)`` reach ``_local_scalar_dense``;
#: ``nonzero`` sizes its output from the values.
HOST_SYNC_OPS = ("aten::_local_scalar_dense", "aten::is_nonzero",
                 "aten::nonzero", "aten::equal")


class HostSyncError(RuntimeError):
    """A tensor's value was brought to the host inside ``HostSyncMode``."""


class HostSyncMode(TorchDispatchMode):
    """Raise ``HostSyncError`` on the first op through which a tensor's
    value reaches the host: one of ``HOST_SYNC_OPS`` (raised before it
    runs), or a copy from a CUDA tensor into a CPU one.  The counterpart,
    on a run, of JAX's concretization error on a traced value; on the card
    ``torch.cuda.set_sync_debug_mode("error")`` is the second guard.  Sees
    the ops the port's Python code calls (autograd's backward included),
    not those a kernel or a tensor subclass runs inside one."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in HOST_SYNC_OPS:
            raise HostSyncError(f"{name} brings a tensor's value to the host "
                                "(a host sync)")
        out = func(*args, **(kwargs or {}))
        inputs = tree_leaves((args, kwargs))
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in inputs):
            written = (args[:1] if name == "aten::copy_"
                       else tree_leaves(out))
            if any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in written):
                raise HostSyncError(f"{name} copies a CUDA tensor to the "
                                    "host (a host sync)")
        return out


def kinds() -> list:
    """``(subject, layout, spec)`` of everything swept: the registry's specs,
    then the fused steps."""
    out = [(name, spec.layout, spec)
           for name, spec in sorted(engine.REGISTRY.items())]
    return out + [(name, "fused", name) for name in FUSED]


def routes(layout: str, spec) -> tuple:
    """The routes the port has for ``spec``."""
    return ROUTES[layout]


def case_rows(route: str, n: int, device: str) -> int:
    """The case's N on a route: on the card the partitioned routes take
    N + ``BLOCK_ROWS`` rows, which the route cuts into two row blocks; the
    plain versions take their two row blocks at N itself."""
    return n + BLOCK_ROWS if route == "partition" and device == "cuda" \
        else n


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _shared_operands(spec, rng, n: int) -> tuple:
    """``(lhs, eps)`` of a diagonally dominant factor, as the reference's
    sweep draws it."""
    if spec.bandwidth == 3:
        a = rng.uniform(-1, 1, n)
        c = rng.uniform(-1, 1, n)
        f = thomas_factor(_t(a), _t(np.abs(a) + np.abs(c) + 2.5), _t(c))
        return ops.stack_tridiag_lhs(f, transposed=spec.transposed), None
    if spec.uniform:
        s = 0.11
        coeffs = [_t(np.full(n, v)) for v in (s, -4 * s, 1 + 6 * s, -4 * s,
                                               s)]
    else:
        a, b, d, e = (rng.uniform(-1, 1, n) for _ in range(4))
        c = np.abs(a) + np.abs(b) + np.abs(d) + np.abs(e) + 4.0
        coeffs = [_t(x) for x in (a, b, c, d, e)]
    f = penta_factor(*coeffs)
    lhs = ops.stack_penta_lhs(f, uniform=spec.uniform,
                              transposed=spec.transposed)
    eps = ops._uniform_eps_param(f, torch.float32) if spec.uniform else None
    return lhs, eps


def _batch_diags(spec, rng, n: int, m: int) -> list:
    k = spec.bandwidth - 1
    off = [rng.uniform(-1, 1, (n, m)) for _ in range(k)]
    main = sum(np.abs(o) for o in off) + (k + 1.0)
    return [_t(x) for x in (*off[:k // 2], main, *off[k // 2:])]


def _recurrence_gates(spec, rng, n: int, m: int) -> list:
    """Stable per-token gates: |s| + |t| < 1 bounds every carry."""
    scales = (0.9,) if spec.order == 1 else (0.6, 0.3)
    return [_t(rng.uniform(-s, s, (n, m))) for s in scales]


def _fused_operands(kind: str, n: int) -> list:
    """The CN step's operands at sigma 0.4 (the periodic factor of its LHS,
    its correction terms and parameters)."""
    one = torch.ones(n, dtype=torch.float32)
    if kind == "fused_cn_tridiag":
        pf = periodic_thomas_factor(-SIGMA * one, (1 + 2 * SIGMA) * one,
                                    -SIGMA * one)
        return [ops.stack_tridiag_lhs(pf.factor), pf.z,
                fused_cn.tridiag_params(pf, SIGMA, torch.float32)]
    pf = periodic_penta_factor(SIGMA * one, -4 * SIGMA * one,
                               (1 + 6 * SIGMA) * one, -4 * SIGMA * one,
                               SIGMA * one)
    return [ops.stack_penta_lhs(pf.factor), pf.Z, pf.Minv,
            fused_cn.penta_params(pf, SIGMA, torch.float32)]


def operands(layout: str, spec, n: int, m: int, seed: int = 7) -> tuple:
    """``(args, rhs)`` of one solve on the CPU, from ``seed``."""
    rng = np.random.default_rng(seed)
    if layout == "fused":
        args = _fused_operands(spec, n)
    elif layout == "shared":
        args = list(_shared_operands(spec, rng, n))
    elif layout == "batch":
        args = _batch_diags(spec, rng, n, m)
    else:
        args = _recurrence_gates(spec, rng, n, m)
    return args, _t(rng.uniform(-1, 1, (n, m)))


def plain(layout: str, spec, route: tuple, args: list, rhs: torch.Tensor
          ) -> torch.Tensor:
    """The route's plain version, in its row blocks and chunks."""
    _, blocks, chunks = route
    if layout == "shared":
        lhs, eps = args
        return ops.shared_sweep_plain(spec, lhs, rhs, eps, blocks=blocks,
                                      chunks=chunks)
    if layout == "batch":
        return ops.batch_sweep_plain(spec, args, rhs, chunks=chunks)
    if layout == "recurrence":
        if route[0] == "tile":
            return ops.recurrence_plain(spec, args, rhs, chunks=chunks,
                                        rows=ops.RECURRENCE_ROWS)
        return ops.recurrence_plain(spec, args, rhs)
    fn = fused_cn.fused_cn_tridiag_plain if spec == FUSED[0] \
        else fused_cn.fused_cn_penta_plain
    return fn(*args, rhs, chunks=chunks, blocks=blocks)


def kernel(layout: str, spec, route: tuple, args: list, rhs: torch.Tensor,
           out: torch.Tensor) -> None:
    """The kernel on ``route`` forced, writing into ``out`` (CUDA
    tensors)."""
    which, _, chunks = route
    tiled = which not in ("serial", "stream", "walk", "global")
    if layout == "shared":
        lhs, eps = args
        ops.shared_sweep_cuda(spec, lhs, rhs, eps, route=which,
                              chunks=chunks if tiled else None, out=out)
    elif layout == "batch":
        ops.batch_sweep_cuda(spec, args, rhs, route=which,
                             chunks=chunks if tiled else None, out=out)
    elif layout == "recurrence":
        ops.recurrence_cuda(spec, args, rhs, route=which,
                            chunks=chunks if tiled else None, out=out)
    else:
        fn = fused_cn.fused_cn_tridiag_cuda if spec == FUSED[0] \
            else fused_cn.fused_cn_penta_cuda
        fn(*args, rhs, route=which, chunks=chunks if tiled else None,
           out=out)


def _out_dtype(layout: str, rhs: torch.Tensor):
    return engine.compute_dtype(rhs.dtype) if layout in ("shared", "batch") \
        else rhs.dtype


def _sweep_cpu(layout, spec, route, args, rhs, sub, out: list) -> None:
    try:
        with NonFiniteMode():
            x = plain(layout, spec, route, args, rhs)
    except FloatingPointError as exc:
        out.append(Finding("nansweep", sub,
                           f"non-finite intermediate: {exc} — a padded or "
                           f"dead value is fed through a divide"))
        return
    if tuple(x.shape) != tuple(rhs.shape):
        out.append(Finding("nansweep", sub, f"output shape "
                           f"{tuple(x.shape)}, expected {tuple(rhs.shape)}"))
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        out.append(Finding("nansweep", sub,
                           f"{bad} non-finite value(s) in the output"))


def _sweep_cuda(layout, spec, route, args, rhs, sub, out: list) -> None:
    n, m = rhs.shape
    dev = torch.device("cuda")
    args = [None if a is None else a.to(dev).contiguous() for a in args]
    rhs = rhs.to(dev)
    buf = torch.full((n * m + 2 * GUARD,), float("nan"),
                     dtype=_out_dtype(layout, rhs), device=dev)
    kernel(layout, spec, route, args, rhs, buf[GUARD:GUARD + n * m]
           .view(n, m))
    torch.cuda.synchronize()
    x = buf[GUARD:GUARD + n * m]
    guards = torch.cat([buf[:GUARD], buf[GUARD + n * m:]])
    unwritten = int((~torch.isfinite(x)).sum())
    if unwritten:
        out.append(Finding("nansweep", sub,
                           f"{unwritten} of {n * m} output element(s) left "
                           f"NaN or made non-finite"))
    stray = int((~torch.isnan(guards)).sum())
    if stray:
        out.append(Finding("nansweep", sub,
                           f"{stray} word(s) written outside the output"))


def run(device: str = "cuda") -> list:
    """Every swept kind x route x shape class, on the kernels (``"cuda"``,
    the default, which raises without a card) or on the plain versions
    (``device="cpu"``); the findings, empty when clean."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("nansweep on the kernels needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"nansweep: device must be cpu or cuda, got "
                         f"{device!r}")
    sweep = _sweep_cuda if device == "cuda" else _sweep_cpu
    out: list = []
    for subject, layout, spec in kinds():
        for route in routes(layout, spec):
            for case, n, m in CASES:
                rows = case_rows(route[0], n, device)
                sub = f"{subject}[{route[0]} {case} n={rows} m={m}]"
                args, rhs = operands(layout, spec, rows, m)
                try:
                    sweep(layout, spec, route, args, rhs, sub, out)
                except (RuntimeError, ValueError, TypeError) as exc:
                    out.append(Finding("nansweep", sub,
                                       f"dispatch raised "
                                       f"{type(exc).__name__}: {exc}"))
    return out
