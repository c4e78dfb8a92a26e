"""The port's multi-device substrate on a 4-rank gloo group on the CPU.

One group of four child processes (``init_method="file://…"``) runs every
case that needs ranks; the test process holds their results against the
JAX package on the conftest's 4 host devices:

  * placements against JAX's ``NamedSharding`` on a (2, 2) ("data",
    "model") mesh, for ``tests/test_sharding.py``'s cases: the resolved
    placements, and each rank's shard from ``ShardingCtx.constrain`` (of
    a plain tensor and of a DTensor) against the slice JAX gives its
    device;
  * ``train_step_shardings`` at the mamba2-130m smoke config;
  * ``make_compressed_mean`` over two steps of error feedback (within
    1e-6 of JAX, within JAX's own 0.05 of the exact mean);
  * ``pipeline_run`` with K 4, M 8 (within 1e-5 of JAX and of the
    sequential oracle), and its gradients at mb 2, d 3 for the loss
    ``sum(y²)`` on every rank (within 1e-6 of ``jax.grad`` through JAX's
    ``pipeline_run`` and of the sequential stages' gradients);
  * ``remesh_plan``, and ``elastic_restore`` of a checkpoint that the JAX
    package saved, onto the (2, 2) mesh: each rank's shards are the right
    slices, and ``full_tensor()`` is the saved arrays bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from repro import configs as jconfigs
from repro.ckpt import save as jax_save
from repro.models import build_model as jax_build_model
from repro.runtime import elastic_restore as jax_elastic_restore
from repro.runtime import make_compressed_mean as jax_compressed_mean
from repro.runtime import pipeline_run as jax_pipeline_run
from repro.runtime import init_error_state as jax_init_error_state
from repro.runtime import quantize_int8 as jax_quantize
from repro.runtime import ef_compress as jax_ef_compress
from repro.runtime import remesh_plan as jax_remesh_plan
from repro.sharding import LogicalRules as JaxRules
from repro.sharding import ShardingCtx as JaxCtx
from repro.train import AdamW as JaxAdamW
from repro.train import warmup_cosine as jax_warmup_cosine
from repro.train.train_loop import cache_shardings as jax_cache_shardings
from repro.train.train_loop import \
    train_step_shardings as jax_train_step_shardings
from repro_torch import configs
from repro_torch.models import Model
from repro_torch.models.params import tree_leaves
from repro_torch.runtime import (bubble_fraction, dequantize_int8,
                                 ef_compress, quantize_int8, remesh_plan)
from repro_torch.sharding import LogicalRules, Mesh, ShardingCtx, place_tree
from repro_torch.train import (AdamW, cache_shardings, train_step_shardings,
                               warmup_cosine)

WORLD = 4
TIMEOUT = 180                        # seconds for the whole group
ARCH = "mamba2-130m"
AXES = ("data", "model")
RULES = LogicalRules.default()
# tests/test_sharding.py's cases (names, dims, rule overrides) and, for the
# shards that ranks hold, small dims with the same divisibility on (2, 2)
PLACEMENT_CASES = {
    "basic_param": (("embed", "mlp"), (512, 2048), (8, 12), {}),
    "batch_group": (("act_batch", "act_seq", "act_embed"), (64, 128, 256),
                    (4, 6, 2), {}),
    "missing_axis": (("act_batch", None), (64, 128), (4, 6), {}),
    "indivisible_heads": (("heads", "head_dim"), (24, 128), (3, 4), {}),
    "axis_not_reused": (("experts", "embed", "expert_mlp"), (8, 512, 1024),
                        (4, 6, 2), {}),
    "kv_fallback_gqa": (("act_batch", "act_kv", "act_kv_seq",
                         "act_head_dim"), (128, 8, 32768, 128), (4, 1, 6, 2),
                        {}),
    "kv_fallback_mha": (("act_batch", "act_kv", "act_kv_seq",
                         "act_head_dim"), (128, 16, 32768, 128), (4, 2, 6, 2),
                        {}),
    "override": (("act_batch", "act_seq", "act_embed"), (32, 1024, 512),
                 (4, 6, 2), {"act_seq": ["model"]}),
    "size_one_axis": (("act_batch", "act_heads"), (7, 16), (3, 4), {}),
}
PIPE_K, PIPE_M, PIPE_MB, PIPE_D = 4, 8, 4, 16
GRAD_MB, GRAD_D = 2, 3              # the gradient case's microbatch, width


def _jax_mesh(shape, axes) -> JaxMesh:
    """Devices 0..3 in rank order: device k sits where rank k does."""
    n = math.prod(shape)
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _full(dims) -> np.ndarray:
    return np.arange(math.prod(dims), dtype=np.float32).reshape(dims)


def _grads(step: int) -> np.ndarray:
    return np.random.default_rng(10 + step).normal(
        size=(WORLD, 32)).astype(np.float32)


def _pipe_inputs(mb: int = PIPE_MB, d: int = PIPE_D):
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(PIPE_K, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.normal(size=(PIPE_M, mb, d)).astype(np.float32)
    return ws, x


def _sequential_grads(ws: np.ndarray, x: np.ndarray) -> tuple:
    """The gradients of sum(y²) through the stages one after another."""
    w = torch.from_numpy(ws).requires_grad_()
    h = torch.from_numpy(x).requires_grad_()
    y = h
    for k in range(PIPE_K):
        y = torch.tanh(y @ w[k])
    (y ** 2).sum().backward()
    return w.grad.numpy(), h.grad.numpy()


def _cfgs():
    return configs.get_smoke_config(ARCH), jconfigs.get_smoke_config(ARCH)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values, bf16 as its raw bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# -- the ranks ----------------------------------------------------------------

def _rank_placements(mesh22) -> dict:
    """Each case's shard on this rank, from a plain tensor, from a
    replicated DTensor and from a DTensor laid out otherwise."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    out = {}
    for key, (names, _, dims, overrides) in PLACEMENT_CASES.items():
        sctx = ShardingCtx(mesh22, RULES.override(**overrides))
        full = torch.from_numpy(_full(dims))
        dm = mesh22.device_mesh
        plain = sctx.constrain(full, names)
        rep = sctx.constrain(distribute_tensor(
            full, dm, (Replicate(), Replicate()), src_data_rank=None), names)
        other = sctx.constrain(distribute_tensor(
            full, dm, (Replicate(), Shard(0)), src_data_rank=None), names)
        out[key] = {"plain": plain.to_local().numpy(),
                    "replicated": rep.to_local().numpy(),
                    "other": other.to_local().numpy(),
                    "placements": str(plain.placements),
                    "full": plain.full_tensor().numpy()}
    return out


def _rank_compressed_mean(mesh4) -> dict:
    from repro_torch.runtime import init_error_state, make_compressed_mean
    mean_c = make_compressed_mean(mesh4, "pod")
    g1 = {"g": torch.from_numpy(_grads(1))}
    out1, err1 = mean_c(g1, init_error_state(g1))
    out2, err2 = mean_c({"g": torch.from_numpy(_grads(2))}, err1)
    return {"out1": out1["g"].to_local().numpy(),
            "err1": err1["g"].to_local().numpy(),
            "out2": out2["g"].to_local().numpy(),
            "err2": err2["g"].to_local().numpy(),
            "out1_global": tuple(out1["g"].shape)}


def _rank_pipeline(mesh_pp) -> dict:
    from repro_torch.runtime import pipeline_run
    ws, x = _pipe_inputs()
    got = pipeline_run(mesh_pp, "pp", lambda w, h: torch.tanh(h @ w),
                       torch.from_numpy(ws), torch.from_numpy(x))
    return {"got": got.numpy()}


def _rank_pipeline_grad(mesh_pp) -> dict:
    """The gradients of sum(y²), the same loss on every rank, with respect
    to the stages' weights and the microbatches (plain tensors)."""
    from repro_torch.runtime import pipeline_run
    ws, x = (torch.from_numpy(a).requires_grad_()
             for a in _pipe_inputs(GRAD_MB, GRAD_D))
    y = pipeline_run(mesh_pp, "pp", lambda w, h: torch.tanh(h @ w), ws, x)
    (y ** 2).sum().backward()
    return {"loss": float((y ** 2).sum()), "ws": ws.grad.numpy(),
            "x": x.grad.numpy()}


def _rank_elastic(ckpt_dir: str) -> dict:
    """The JAX checkpoint restored onto the (2, 2) mesh, and the model's
    own parameters laid out by ``place_tree`` on the train step's
    shardings."""
    from repro_torch.runtime import elastic_restore
    cfg, _ = _cfgs()
    model = Model(cfg, device="cpu")
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
    plan = remesh_plan(WORLD, model=2)
    params, opt_state, step, sctx = elastic_restore(ckpt_dir, plan, model,
                                                    opt, device="cpu")
    leaves = _flat({"params": params, "opt": opt_state})
    (p_sh, *_), _ = train_step_shardings(model, sctx, opt, _batch())
    mine = _flat({"params": place_tree(model.params.tree(), p_sh)})
    return {"step": step, "mesh": (sctx.mesh.axis_names, sctx.mesh.shape),
            "local": {k: _bits(v.to_local()) for k, v in leaves.items()},
            "full": {k: _bits(v.full_tensor()) for k, v in leaves.items()},
            "distributed": {k: _bits(v.to_local()) for k, v in mine.items()}}


def _worker(rank: int, init_file: str, out_dir: str) -> None:
    from repro_torch.launch.mesh import mesh_over_ranks
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=WORLD)
        mesh22 = mesh_over_ranks((2, 2), AXES, device="cpu")
        results = {
            "coords": mesh22.device_mesh.get_coordinate(),
            "placements": _rank_placements(mesh22),
            "compressed": _rank_compressed_mean(
                mesh_over_ranks((WORLD,), ("pod",), device="cpu")),
            "pipeline": _rank_pipeline(
                mesh_over_ranks((WORLD,), ("pp",), device="cpu")),
            "pipeline_grad": _rank_pipeline_grad(
                mesh_over_ranks((WORLD,), ("pp",), device="cpu")),
            "elastic": _rank_elastic(str(Path(out_dir, "ckpt"))),
        }
        torch.save(results, Path(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except Exception:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_group(worker, tmp: Path) -> list:
    """Start ``worker(rank, init_file, out_dir)`` in WORLD spawned child
    processes, which meet through a file under ``tmp``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(r, str(tmp / "pg_init"),
                                              str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def join_group(procs, tmp: Path, started: float,
               timeout: float = TIMEOUT) -> list:
    """Each rank's saved results; fails on a rank that exits non-zero or
    outlives ``timeout`` from ``started`` (then every rank is killed)."""
    for p in procs:
        p.join(max(1.0, started + timeout - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = [f.read_text() for f in sorted(tmp.glob("rank*.err"))]
    assert not alive, f"{len(alive)} ranks outlived {timeout} s\n{errors}"
    assert all(p.exitcode == 0 for p in procs), "\n".join(errors)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# -- the JAX side -------------------------------------------------------------

def _jax_state():
    _, jcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-3, 2, 10))
    return jmodel, jopt, {"params": params, "opt": jopt.init(params)}


def _jax_side(tmp: Path) -> dict:
    """What the ranks are held to, from the JAX package."""
    out = {}
    mesh4 = _jax_mesh((WORLD,), ("pod",))
    mean_c = jax.jit(jax_compressed_mean(mesh4, "pod"))
    g1, g2 = jnp.asarray(_grads(1)), jnp.asarray(_grads(2))
    out1, err1 = mean_c(g1, jax_init_error_state(g1))
    out2, err2 = mean_c(g2, err1)
    out["compressed"] = {k: np.asarray(v) for k, v in
                         dict(out1=out1, err1=err1, out2=out2,
                              err2=err2).items()}
    ws, x = _pipe_inputs()
    out["pipeline"] = np.asarray(jax_pipeline_run(
        _jax_mesh((PIPE_K,), ("pp",)), "pp",
        lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws), jnp.asarray(x)))

    def pipe_loss(ws, x):
        y = jax_pipeline_run(_jax_mesh((PIPE_K,), ("pp",)), "pp",
                             lambda w, h: jnp.tanh(h @ w), ws, x)
        return jnp.sum(y ** 2)
    g_ws, g_x = jax.jit(jax.grad(pipe_loss, argnums=(0, 1)))(
        *map(jnp.asarray, _pipe_inputs(GRAD_MB, GRAD_D)))
    out["pipeline_grad"] = {"ws": np.asarray(g_ws), "x": np.asarray(g_x)}
    jmodel, jopt, _ = _jax_state()
    params, opt_state, step, _ = jax_elastic_restore(
        str(tmp / "ckpt"), jax_remesh_plan(WORLD, model=2), jmodel, jopt)
    out["elastic_step"] = step
    out["elastic_index"] = {
        k: v.sharding.devices_indices_map(v.shape)
        for k, v in _flat({"params": params, "opt": opt_state}).items()}
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The ranks' results and the JAX package's, from one 4-rank group."""
    tmp = tmp_path_factory.mktemp("substrate_group")
    _, _, tree = _jax_state()
    jax_save(str(tmp / "ckpt"), 3, tree)
    saved = {k: np.asarray(v) for k, v in _flat(tree).items()}
    started = time.monotonic()
    procs = spawn_group(_worker, tmp)
    try:
        assert jax.device_count() >= WORLD, "conftest forces 4 host devices"
        want = _jax_side(tmp)
    finally:
        ranks = join_group(procs, tmp, started)
    want["saved"] = saved
    return ranks, want


def _device_of(rank: int):
    """The JAX device at rank ``rank``'s mesh position."""
    return jax.devices()[rank]


# -- placements ---------------------------------------------------------------

def _jax_placements(spec, axes) -> tuple:
    """The DTensor placements a JAX PartitionSpec stands for."""
    out = ["R"] * len(axes)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[axes.index(a)] = f"S({d})"
    return tuple(out)


def _names(placements) -> tuple:
    return tuple(f"S({p.dim})" if p.is_shard() else "R" for p in placements)


@pytest.mark.parametrize("key", sorted(PLACEMENT_CASES))
def test_placements_match_jax_named_sharding(key):
    names, dims, _, overrides = PLACEMENT_CASES[key]
    sctx = ShardingCtx(Mesh(AXES, (2, 2)), RULES.override(**overrides))
    jctx = JaxCtx(_jax_mesh((2, 2), AXES),
                  JaxRules.default().override(**overrides))
    assert sctx.spec(names, dims) == tuple(jctx.spec(names, dims))
    assert _names(sctx.sharding(names, dims).placements) == \
        _jax_placements(jctx.sharding(names, dims).spec, AXES)


@pytest.mark.parametrize("key", sorted(PLACEMENT_CASES))
def test_constrain_gives_each_rank_its_jax_slice(group, key):
    """constrain of a plain tensor, of a replicated DTensor and of one
    laid out otherwise: each rank holds the slice that JAX's
    NamedSharding gives its device, and the whole is the tensor."""
    ranks, _ = group
    names, _, dims, overrides = PLACEMENT_CASES[key]
    jctx = JaxCtx(_jax_mesh((2, 2), AXES),
                  JaxRules.default().override(**overrides))
    index = jctx.sharding(names, dims).devices_indices_map(dims)
    full = _full(dims)
    for r, res in enumerate(ranks):
        got = res["placements"][key]
        want = full[index[_device_of(r)]]
        for how in ("plain", "replicated", "other"):
            np.testing.assert_array_equal(got[how], want)
        np.testing.assert_array_equal(got["full"], full)
    assert [tuple(res["coords"]) for res in ranks] == [(0, 0), (0, 1), (1, 0),
                                                        (1, 1)]


def test_constrain_is_the_identity_on_one_device():
    x = torch.ones(4, 6)
    assert ShardingCtx.local().constrain(x, ("act_batch", None)) is x


def _batch() -> dict:
    return {"tokens": torch.zeros(4, 16, dtype=torch.int64),
            "labels": torch.zeros(4, 16, dtype=torch.int64)}


def _step_shardings():
    cfg, jcfg = _cfgs()
    jbatch = {k: jax.ShapeDtypeStruct((4, 16), jnp.int32) for k in _batch()}
    got = train_step_shardings(
        Model(cfg, device="cpu"), ShardingCtx(Mesh(AXES, (2, 2)), RULES),
        AdamW(lr=warmup_cosine(1e-3, 2, 10)), _batch())
    want = jax_train_step_shardings(
        jax_build_model(jcfg), JaxCtx(_jax_mesh((2, 2), AXES),
                                      JaxRules.default()),
        JaxAdamW(lr=jax_warmup_cosine(1e-3, 2, 10)), jbatch)
    return got, want


@pytest.mark.parametrize("part", ["params", "opt", "batch", "step"])
def test_train_step_shardings_match_jax(part):
    """(in, out) shardings of the train step at the mamba2-130m smoke
    config: every leaf's placements are JAX's spec."""
    (got_in, got_out), (want_in, want_out) = _step_shardings()
    i = ("params", "opt", "batch", "step").index(part)
    got, want = _flat(got_in[i]), _flat(want_in[i])
    assert sorted(got) == sorted(want)
    for k in got:
        assert _names(got[k].placements) == _jax_placements(want[k].spec,
                                                            AXES), k
    assert got_out[2] is None and want_out[2] is None
    if part in ("params", "opt"):
        assert got_out[i] is got_in[i]


def test_cache_shardings_match_jax():
    cfg, jcfg = _cfgs()
    from repro.models.model import cache_specs as jax_cache_specs
    from repro_torch.models.model import cache_specs
    got = _flat(cache_shardings(ShardingCtx(Mesh(AXES, (2, 2)), RULES),
                                cache_specs(cfg, 4, 32)))
    want = _flat(jax_cache_shardings(
        JaxCtx(_jax_mesh((2, 2), AXES), JaxRules.default()),
        jax_cache_specs(jcfg, 4, 32)))
    assert sorted(got) == sorted(want)
    for k in got:
        assert _names(got[k].placements) == _jax_placements(want[k].spec,
                                                            AXES), k


# -- compression, pipeline, elastic -------------------------------------------

def test_quantize_and_error_feedback_match_jax_bitwise():
    x = np.random.default_rng(3).normal(size=(64,)).astype(np.float32) * 3
    err = np.random.default_rng(4).normal(size=(64,)).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jq, np.float32) * np.float32(js))
    got = ef_compress(torch.from_numpy(x), torch.from_numpy(err))
    want = jax_ef_compress(jnp.asarray(x), jnp.asarray(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("step", [1, 2])
def test_compressed_mean_matches_jax(group, step):
    """Each rank's row of the mean and of the error state, step 1 from
    zero error, step 2 carrying step 1's."""
    ranks, want = group
    exact = _grads(step).mean(axis=0)
    for r, res in enumerate(ranks):
        got = res["compressed"]
        assert got["out1_global"] == (WORLD, 32)
        for key in (f"out{step}", f"err{step}"):
            np.testing.assert_allclose(got[key], want["compressed"][key]
                                       [r:r + 1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[f"out{step}"][0], exact, atol=0.05)
        np.testing.assert_allclose(got[f"out{step}"][0],
                                   ranks[0]["compressed"][f"out{step}"][0],
                                   rtol=0, atol=0)


def test_pipeline_matches_jax_and_the_sequential_oracle(group):
    ranks, want = group
    ws, x = _pipe_inputs()
    h = torch.from_numpy(x)
    for k in range(PIPE_K):
        h = torch.tanh(h @ torch.from_numpy(ws[k]))
    for res in ranks:
        got = res["pipeline"]["got"]
        np.testing.assert_allclose(got, want["pipeline"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, h.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wrt", ["ws", "x"])
def test_pipeline_gradients_match_jax_grad_and_the_sequential_stages(
        group, wrt):
    """Every rank holds the whole gradient of the stages' weights and of
    the microbatches: within 1e-6 of ``jax.grad`` through JAX's pipeline
    and of the sequential stages' (JAX's own gradient meets the
    sequential one within 2.4e-7)."""
    ranks, want = group
    seq = dict(zip(("ws", "x"), _sequential_grads(
        *_pipe_inputs(GRAD_MB, GRAD_D))))
    assert np.abs(seq[wrt]).max() > 0.1
    for res in ranks:
        got = res["pipeline_grad"][wrt]
        np.testing.assert_allclose(got, want["pipeline_grad"][wrt],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, seq[wrt], rtol=0, atol=1e-6)


def test_fault_docstring_points_at_the_elastic_remesh():
    from repro_torch.runtime import fault
    assert "remedy = elastic re-mesh" in fault.__doc__
    assert "(``runtime/elastic.py``)" in fault.__doc__
    assert "Queue 1" not in fault.__doc__


def test_bubble_fraction():
    assert bubble_fraction(PIPE_K, PIPE_M) == pytest.approx(3 / 11)


@pytest.mark.parametrize("n_available,model", [
    (512, 16), (500, 16), (256, 16), (17, 16), (16, 16), (15, 16),
    (7, 16), (4, 2), (3, 2), (1, 2)])
def test_remesh_plan_matches_jax(n_available, model):
    got = remesh_plan(n_available, model=model)
    want = jax_remesh_plan(n_available, model=model)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.utilization == want.utilization


def test_elastic_restore_of_a_jax_checkpoint(group):
    """Each rank's shards of every leaf are the slices JAX's own elastic
    restore gives its device; ``full_tensor()`` is the saved leaf, bit
    for bit (bf16 by its raw bits)."""
    ranks, want = group
    saved = want["saved"]
    for r, res in enumerate(ranks):
        got = res["elastic"]
        assert got["step"] == want["elastic_step"] == 3
        assert got["mesh"] == (AXES, (2, 2))
        assert sorted(got["full"]) == sorted(saved)
        for k, arr in saved.items():
            bits = arr.view(np.int16) if str(arr.dtype) == "bfloat16" else arr
            np.testing.assert_array_equal(got["full"][k], bits)
            index = want["elastic_index"][k][_device_of(r)]
            np.testing.assert_array_equal(got["local"][k], bits[index])


def test_place_tree_lays_params_out_as_jax_would(group):
    """``sharding.place_tree`` onto ``train_step_shardings``' params: each
    rank holds the slice of the model's own parameters (seed 0) that JAX
    gives its device."""
    ranks, want = group
    cfg, _ = _cfgs()
    full = {k: _bits(v) for k, v in
            _flat({"params": Model(cfg, device="cpu").params.tree()}).items()}
    for r, res in enumerate(ranks):
        got = res["elastic"]["distributed"]
        assert sorted(got) == sorted(full)
        for k, arr in full.items():
            index = want["elastic_index"][k][_device_of(r)]
            np.testing.assert_array_equal(got[k], arr[index])


def test_place_tree_is_the_identity_on_one_device():
    cfg, _ = _cfgs()
    model = Model(cfg, device="cpu")
    params = model.params.tree()
    (p_sh, *_), _ = train_step_shardings(
        model, ShardingCtx.local(), AdamW(lr=warmup_cosine(1e-3, 2, 10)),
        _batch())
    out = place_tree(params, p_sh)
    assert all(a is b for a, b in zip(tree_leaves(out), tree_leaves(params)))
