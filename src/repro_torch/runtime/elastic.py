"""Elastic scaling: rebuild the mesh from the surviving ranks and reshard
the latest checkpoint onto it.

Counterpart of ``repro.runtime.elastic``.  Checkpoints store full logical
arrays (``repro_torch.ckpt``), so resharding is a restore that lays each
leaf out on the new mesh's placements: no shard-file surgery.  The policy
keeps the model (TP) axis fixed and shrinks or grows the data axis,
because optimizer state sharded over data re-balances for free while the
model axis is baked into layout choices.
"""

from __future__ import annotations

import dataclasses

from repro_torch import ckpt as ckpt_lib
from repro_torch.launch.mesh import mesh_over_ranks
from repro_torch.sharding import LogicalRules, Mesh, ShardingCtx


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    n_used: int
    n_available: int

    @property
    def utilization(self) -> float:
        return self.n_used / max(self.n_available, 1)


def remesh_plan(n_available: int, *, model: int = 16,
                axes=("data", "model")) -> MeshPlan:
    """Largest (data, model) mesh that fits the surviving device count."""
    if n_available < model:
        # degenerate: shrink the model axis to the largest power of two left
        m = 1 << (n_available.bit_length() - 1)
        return MeshPlan((1, m), axes, m, n_available)
    data = n_available // model
    return MeshPlan((data, model), axes, data * model, n_available)


def build_mesh(plan: MeshPlan, *, device=None) -> Mesh:
    """The plan's mesh over the first ``n_used`` ranks (every rank of the
    process group calls it); the CUDA device unless ``device`` says
    otherwise."""
    return mesh_over_ranks(plan.shape, plan.axes, device=device)


def elastic_restore(ckpt_dir: str, plan: MeshPlan, model, opt,
                    rules: LogicalRules | None = None, *, device=None):
    """Restore the latest checkpoint resharded for the new mesh.  Returns
    (params, opt_state, step, sctx); ``model`` gives ``param_specs()``."""
    mesh = build_mesh(plan, device=device)
    sctx = ShardingCtx(mesh=mesh, rules=rules or LogicalRules.default())
    pspecs = model.param_specs()
    shardings = {
        "params": sctx.tree_shardings(pspecs),
        "opt": sctx.tree_shardings(opt.state_specs(pspecs)),
    }
    tree, step = ckpt_lib.restore(ckpt_dir, shardings=shardings)
    return tree["params"], tree["opt"], step, sctx
