"""GPipe-style pipeline parallelism over a mesh axis (the "pod" axis can
be claimed as a stage axis instead of outer data parallelism).

Counterpart of ``repro.runtime.pipeline``.  Schedule: GPipe fill and
drain with M microbatches over K stages (bubble fraction
(K-1)/(M+K-1)).  Each tick every stage applies its function; the
inter-stage hop is one point-to-point pair on the axis's process group
(``batch_isend_irecv``: send to the next stage, receive from the
previous), the only communication of the schedule until the last stage's
outputs are broadcast to every rank of the axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.params import tree_map
from repro_torch.sharding import ranked_mesh


def _stage_leaf(leaf, mesh, axis: str, idx: int):
    """This stage's slice of a (K, ...) leaf: a DTensor is laid out
    ``Shard(0)`` over ``axis`` first; a plain tensor is indexed."""
    if isinstance(leaf, DTensor):
        placements = mesh.placements((axis,) + (None,) * (leaf.ndim - 1))
        return leaf.redistribute(leaf.device_mesh, placements).to_local()[0]
    return leaf[idx]


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
    M = x_mb.shape[0]
    T = M + K - 1                       # fill-drain schedule length
    p = tree_map(lambda leaf: _stage_leaf(leaf, mesh, axis, idx),
                  stage_params)
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    nxt = dist.get_global_rank(group, idx + 1) if idx < K - 1 else None

    buf = torch.zeros_like(x_mb[0])     # stage 0 never receives
    outs = torch.zeros_like(x_mb)
    for t in range(T):
        x_in = x_mb[min(t, M - 1)] if idx == 0 else buf
        y = stage_fn(p, x_in)
        if idx == K - 1 and t >= K - 1:
            outs[t - (K - 1)] = y       # last stage emits microbatch t-K+1
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prev is not None:
            buf = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, buf, prev, group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    # only the last stage's collection is meaningful; replicate it
    dist.broadcast(outs, src=dist.get_global_rank(group, K - 1), group=group)
    return outs


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
