"""The rest of the JAX package's public surface on the port, against the
JAX package on the CPU: ``repro_torch.kernels``' names and its entry-point
registry (``ops.ENTRY_POINTS`` / ``entry_key`` / ``entry_point``, each key
solved once beside JAX's in interpret mode), ``ops.sharded_solve`` on a
one-rank gloo group, ``models.abstract_params`` for every config,
``ReferenceBackend.factor_for_solve`` and ``launch.dryrun``'s variants
(``accum``, ``moe_local``, ``no_remat``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jkernels
import repro.models as jmodels
from repro import configs as jconfigs
from repro.core import penta as jpenta
from repro.core import tridiag as jtri
from repro.kernels import engine as jengine
from repro.kernels import ops as jops
from repro.launch import analytic_cost as janalytic
from repro.models.params import abstract_params as jabstract_params
from repro.solver import BandedSystem as JSystem
from repro.solver import reference as jreference

import repro_torch.kernels as tkernels
import repro_torch.models as tmodels
from repro_torch.analysis.tracecheck import one_rank_group
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.core import penta as tpenta
from repro_torch.core import tridiag as ttri
from repro_torch.kernels import engine, fused_cn, ops
from repro_torch.launch import analytic_cost, dryrun
from repro_torch.models import Model, abstract_params
from repro_torch.models.model import param_specs
from repro_torch.models.params import tree_leaves
from repro_torch.solver import BandedSystem
from repro_torch.solver import reference

ROOT = Path(__file__).resolve().parents[1]
N, M = 12, 8


def test_kernels_export_jax_names():
    assert set(jkernels.__all__) <= set(tkernels.__all__)
    assert len(jkernels.__all__) == 19
    for name in jkernels.__all__:
        obj = getattr(tkernels, name)
        assert obj.__doc__, f"repro_torch.kernels.{name} has no docstring"
    assert tkernels.fused_cn_step is fused_cn.fused_cn_step
    assert tkernels.fused_cn_penta_step is fused_cn.fused_cn_penta_step
    assert tkernels.REGISTRY is engine.REGISTRY


def test_models_export_jax_names():
    assert set(jmodels.__all__) <= set(tmodels.__all__)
    assert tmodels.abstract_params is abstract_params
    for name in jmodels.__all__:
        assert getattr(tmodels, name).__doc__, \
            f"repro_torch.models.{name} has no docstring"


def test_entry_points_are_jaxs():
    assert set(ops.ENTRY_POINTS) == set(jops.ENTRY_POINTS)
    for key, fn in ops.ENTRY_POINTS.items():
        assert fn.__name__ == jops.ENTRY_POINTS[key].__name__
    for name, spec in engine.REGISTRY.items():
        key = ops.entry_key(spec)
        assert key == jops.entry_key(jengine.REGISTRY[name])
        assert ops.entry_point(spec) is ops.ENTRY_POINTS[key]
    assert {fn.__name__ for fn in map(ops.entry_point,
                                      engine.REGISTRY.values())} == {
        "thomas_constant", "thomas_batch", "penta_constant", "penta_batch",
        "recurrence"}


def _operands(key: tuple) -> tuple:
    """(JAX args, port args, kwargs) of one solve at (N, M), fp32, from
    one numpy draw."""
    rng = np.random.default_rng(sum(key[0:1]) * 7 + len(key[1]))

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    rhs = u(-1, 1, N, M)
    width, layout = key
    if layout == "recurrence":
        arrays = [u(-0.9, 0.9, N, M) / width for _ in range(width)] + [rhs]
        kw = {"reverse": True}
    elif layout == "batch":
        arrays = ([u(-0.5, 0.5, N, M), u(2, 3, N, M), u(-0.5, 0.5, N, M)]
                  if width == 3 else
                  [u(-0.3, 0.3, N, M), u(-0.5, 0.5, N, M), u(4, 5, N, M),
                   u(-0.5, 0.5, N, M), u(-0.3, 0.3, N, M)]) + [rhs]
        kw = {}
    else:
        diags = ([u(-0.5, 0.5, N), u(2, 3, N), u(-0.5, 0.5, N)]
                 if width == 3 else
                 [u(-0.3, 0.3, N), u(-0.5, 0.5, N), u(4, 5, N),
                  u(-0.5, 0.5, N), u(-0.3, 0.3, N)])
        jmod, tmod = (jtri, ttri) if width == 3 else (jpenta, tpenta)
        jname = "thomas_factor" if width == 3 else "penta_factor"
        jf = getattr(jmod, jname)(*map(jnp.asarray, diags))
        tf = getattr(tmod, jname)(*map(torch.from_numpy, diags))
        return (jf, jnp.asarray(rhs)), (tf, torch.from_numpy(rhs)), {
            "transposed": True}
    return (tuple(map(jnp.asarray, arrays)),
            tuple(map(torch.from_numpy, arrays)), kw)


@pytest.mark.parametrize("key", sorted(ops.ENTRY_POINTS))
def test_entry_point_solves_match_jax(key):
    jargs, targs, kw = _operands(key)
    want = np.asarray(jops.ENTRY_POINTS[key](*jargs, **kw))
    ops.reset_launches()
    got = ops.ENTRY_POINTS[key](*targs, **kw).numpy()
    assert ops.LAUNCHES == {}, "the plain version counted a launch"
    assert got.shape == want.shape == (N, M)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_sharded_solve_on_one_gloo_rank_is_the_plain_solve():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    _, (tf, rhs), _ = _operands((3, "shared"))
    with one_rank_group("cpu"):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("batch",))
        solve = ops.sharded_solve(ops.thomas_constant, mesh, "batch")
        x = solve(tf, rhs)
        assert isinstance(x, DTensor) and tuple(x.shape) == (N, M)
        assert torch.equal(x.to_local(), ops.thomas_constant(tf, rhs))
        # a DTensor rhs already laid out gives the same
        assert torch.equal(solve(tf, x).to_local(),
                           ops.thomas_constant(tf, x.to_local()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_jax(arch):
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    got = abstract_params(param_specs(get_config(arch)))
    want = jabstract_params(jmodels.build_model(
        jconfigs.get_config(arch)).param_specs())
    jleaves = jax.tree_util.tree_leaves_with_path(want)
    tleaves = tree_leaves(got)
    assert len(tleaves) == len(jleaves)
    for t, (path, j) in zip(tleaves, jleaves):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype)[6:] == str(j.dtype), path
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


def test_model_abstract_params_method():
    cfg = get_smoke_config("mamba2-130m")
    model = Model(cfg, device="cpu")
    got, want = model.abstract_params(), abstract_params(param_specs(cfg))
    assert [(t.shape, t.dtype, t.device.type) for t in tree_leaves(got)] == \
        [(t.shape, t.dtype, "meta") for t in tree_leaves(want)]
    assert [(t.shape, t.dtype) for t in tree_leaves(got)] == \
        [(t.shape, t.dtype) for t in tree_leaves(model.params.tree())]


@pytest.mark.parametrize("bw,periodic", ((3, False), (3, True), (5, False),
                                         (5, True)))
def test_factor_for_solve_matches_jax(bw, periodic):
    coefs = (-0.4, 1.8, -0.4) if bw == 3 else (0.1, -0.4, 1.6, -0.4, 0.1)
    for mode in ("uniform", "constant"):
        kw = dict(n=N, periodic=periodic, mode=mode)
        jctor = JSystem.tridiag if bw == 3 else JSystem.penta
        tctor = BandedSystem.tridiag if bw == 3 else BandedSystem.penta
        jgot = jreference.ReferenceBackend(jctor(*coefs, **kw)) \
            .factor_for_solve()
        tgot = reference.ReferenceBackend(tctor(*coefs, device="cpu", **kw)) \
            .factor_for_solve()
        jl = jax.tree_util.tree_leaves(jgot)
        tl = list(_tensors(tgot))
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            assert tuple(t.shape) == tuple(j.shape)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _jax_variant_keys() -> set:
    """The keys of the ``variant`` dict JAX's ``run_cell`` records, read
    from its source (running it compiles the cell for 256 devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "variant":
                    return {key.value for key in v.keys}
    raise AssertionError("JAX's run_cell records no variant")


TRAIN_CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
               if SHAPES[s][2] == "train"]


@pytest.mark.parametrize("arch,shape", TRAIN_CELLS)
def test_no_remat_cell_has_jaxs_analytic_terms(arch, shape):
    rec = dryrun.run_cell(arch, shape, no_remat=True)
    assert set(rec["variant"]) == _jax_variant_keys()
    assert rec["variant"]["no_remat"] is True
    if rec["status"] == "skip":
        return
    seq, batch, kind = SHAPES[shape]
    jcfg = dataclasses.replace(jconfigs.get_config(arch), remat=False)
    af = janalytic.flops_for_cell(jcfg, kind, batch, seq)
    assert rec["analytic"]["flops_global"] == af["total"]
    assert rec["analytic"]["flops_components_fwd"] == af["components_fwd"]
    total, active = dryrun.param_counts(get_config(arch))
    ab = janalytic.bytes_for_cell(
        jcfg, kind, batch, seq, n_dev=rec["n_devices"], params_total=total,
        params_active=active, cache_bytes_total=0.0)
    assert rec["analytic"]["bytes_per_device"] == ab["total"]
    with_remat = dryrun.run_cell(arch, shape)
    assert with_remat["analytic"]["flops_global"] > af["total"]
    assert analytic_cost.flops_for_cell(
        dataclasses.replace(get_config(arch), remat=False), kind, batch,
        seq) == af


def test_moe_local_and_accum_variants():
    rec = dryrun.run_cell("dbrx-132b", "train_4k", moe_local=True, accum=4)
    assert rec["variant"] == {"moe_local": True, "grad_constrain": False,
                              "no_remat": False, "rules": {}}
    assert rec["accum"] == 4
    cfg = dryrun.variant_config(get_config("dbrx-132b"), moe_local=True)
    assert cfg.moe_dispatch == "local"
    assert dryrun.variant_config(get_config("dbrx-132b"),
                                 moe_local="local2").moe_dispatch == "local2"
    assert not dryrun.variant_config(get_config("mamba2-130m"),
                                     no_remat=True).remat
    with pytest.raises(ValueError, match="moe_local"):
        dryrun.variant_config(get_config("dbrx-132b"), moe_local="global2")
    with pytest.raises(ValueError, match="accum"):
        dryrun.run_cell("dbrx-132b", "train_4k", accum=0)


def test_accum_splits_the_measured_step_on_the_cpu():
    """``make_step``'s training step in two microbatches: the same loss as
    one batch of the same tokens, to fp32 rounding."""
    cfg = dryrun.variant_config(get_smoke_config("mamba2-130m"),
                                no_remat=True)
    model = tmodels.build_model(cfg, device="cpu", seed=0)
    one = dryrun.make_step(model, "train", 32)(4)()
    two = dryrun.make_step(model, "train", 32, accum=2)(4)()
    assert math.isclose(float(one), float(two), rel_tol=1e-5)


def test_dryrun_cli_takes_the_variant_flags(tmp_path):
    rc = dryrun.main(["--arch", "mamba2-130m", "--shape", "train_4k",
                      "--mesh", "1", "--no-remat", "--moe-local", "local2",
                      "--accum", "2", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / dryrun.record_name(
        "mamba2-130m", "train_4k", "1")).read_text())
    assert rec["variant"] == {"moe_local": "local2", "grad_constrain": False,
                              "no_remat": True, "rules": {}}
    assert rec["accum"] == 2 and rec["status"] == "ok"
