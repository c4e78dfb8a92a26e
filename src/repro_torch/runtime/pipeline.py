"""GPipe-style pipeline parallelism over a mesh axis (the "pod" axis can
be claimed as a stage axis instead of outer data parallelism).

Counterpart of ``repro.runtime.pipeline``.  Schedule: GPipe fill and
drain with M microbatches over K stages (bubble fraction
(K-1)/(M+K-1)).  Each tick every stage applies its function; the
inter-stage hop is one point-to-point pair on the axis's process group
(``batch_isend_irecv``: send to the next stage, receive from the
previous), the only communication of the schedule until the last stage's
outputs are broadcast to every rank of the axis.

``pipeline_run`` is differentiable, as JAX's is.  The hop is an autograd
``Function`` whose backward sends the cotangent back to the previous stage
and receives one from the next; every rank builds the same graph (stage 0
selects its microbatch with ``torch.where`` over the received buffer, and
every stage collects its outputs), so each rank runs each hop's backward,
and its point-to-point pair meets its peer's.  The output is one value
replicated on the axis: its cotangent is the mean of the ranks' (each
rank's own when every rank computes the same loss, as an SPMD program
does).  Inputs given as plain tensors, the same on every rank, get their
whole gradient on every rank (a sum over the axis); a DTensor's comes back
in its own layout.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.params import tree_map
from repro_torch.sharding import ranked_mesh


class _Hop(torch.autograd.Function):
    """buf = the previous stage's y; y goes to the next stage.  Backward:
    the cotangent of buf goes back to the previous stage, y's comes from
    the next."""

    @staticmethod
    def forward(ctx, y, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        buf = torch.zeros_like(y)       # stage 0 never receives
        _exchange(y, nxt, buf, prev, group)
        return buf

    @staticmethod
    def backward(ctx, g_buf):
        g_y = torch.zeros_like(g_buf)   # the last stage never receives
        _exchange(g_buf, ctx.prev, g_y, ctx.nxt, ctx.group)
        return g_y, None, None, None


def _exchange(send, to, recv, frm, group) -> None:
    """Send ``send`` to global rank ``to`` and receive ``recv`` from
    ``frm`` (either ``None``: skipped), as one batch."""
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv, frm, group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()


class _Replicate(torch.autograd.Function):
    """The global rank ``src``'s tensor on every rank of ``group``.
    Backward: the mean of the ranks' cotangents, on ``src``.

    ``torch.distributed.nn.functional.broadcast`` sums the cotangents
    (K times the gradient of a loss every rank computes) and zeroes the
    gradient by comparing the global ``src`` with the GROUP rank, wrong on
    an axis of a larger mesh."""

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        out = x.clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.reduce(g, dst=ctx.src, group=ctx.group)
        if dist.get_rank() != ctx.src:
            return torch.zeros_like(g), None, None
        return g / dist.get_world_size(ctx.group), None, None


class _SumGrad(torch.autograd.Function):
    """The identity; its gradient is summed over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _stage_leaf(leaf, mesh, axis: str, idx: int, group):
    """This stage's slice of a (K, ...) leaf: a DTensor is laid out
    ``Shard(0)`` over ``axis`` first; a plain tensor is indexed, its
    gradient summed over the axis."""
    if isinstance(leaf, DTensor):
        placements = mesh.placements((axis,) + (None,) * (leaf.ndim - 1))
        return leaf.redistribute(leaf.device_mesh, placements).to_local()[0]
    return _SumGrad.apply(leaf, group)[idx]


def pipeline_run(mesh, axis: str, stage_fn, stage_params, x_mb):
    """Run microbatches through a K-stage pipeline.

    stage_fn: (params_for_stage, x) -> y   (same shape as x)
    stage_params: tree of leaves with leading dim K (stage k's on the
      rank at position k of ``axis``)
    x_mb: (M, mb, ...) microbatched input, the same on every rank

    Returns (M, mb, ...) outputs of the last stage, on every rank.
    """
    mesh = ranked_mesh(mesh)
    dm = mesh.device_mesh
    K = mesh.axis_sizes[axis]
    group = dm.get_group(axis)
    idx = dm.get_local_rank(axis)
    if isinstance(x_mb, DTensor):
        x_mb = x_mb.redistribute(dm, (Replicate(),) * dm.ndim).to_local()
    x_mb = _SumGrad.apply(x_mb, group)
    M = x_mb.shape[0]
    T = M + K - 1                       # fill-drain schedule length
    p = tree_map(lambda leaf: _stage_leaf(leaf, mesh, axis, idx, group),
                 stage_params)
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    nxt = dist.get_global_rank(group, idx + 1) if idx < K - 1 else None
    first = torch.tensor(idx == 0, device=x_mb.device)

    buf = torch.zeros_like(x_mb[0])
    ys = []
    for t in range(T):
        y = stage_fn(p, torch.where(first, x_mb[min(t, M - 1)], buf))
        ys.append(y)
        buf = _Hop.apply(y, prev, nxt, group)
    # the last stage emits microbatch t-K+1 at tick t; replicate its
    # collection (the other stages' stand in the graph, with no gradient)
    return _Replicate.apply(torch.stack(ys[K - 1:]),
                            dist.get_global_rank(group, K - 1), group)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
