"""The port's training path against the JAX package at the smoke configs.

Data (``SyntheticLM``), the schedule and AdamW, ``loss_fn`` and its
gradients (the ssm, hybrid, dense, moe, encdec and vlm families, remat
on and off),
three train steps from one converted state, gradient accumulation, loss
descent, the SSD layer's long-sequence gradients, checkpoints read across
the two packages, the fault-tolerance runtime and the training driver's
resume.
JAX runs on the CPU as its own tests run it (its ``method="auto"`` reaches
the Pallas recurrence kernel in interpret mode); the port runs the
recurrence kernel's plain version on CPU tensors.  At fp32 the bar is
rtol 1e-4 / atol 1e-5 (``tests/test_torch_models.py``'s); AdamW alone is
held to 1e-6 relative at fp32 and one bf16 ulp at bf16.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.ckpt import restore as jax_restore
from repro.ckpt import save as jax_save
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.models import ssm as jssm
from repro.models.params import init_params as jax_init_params
from repro.sharding import LogicalRules as JaxRules
from repro.sharding import ShardingCtx as JaxCtx
from repro.train import AdamW as JaxAdamW
from repro.train import make_train_step as jax_make_train_step
from repro.train import warmup_cosine as jax_warmup_cosine
from repro_torch import configs, convert
from repro_torch.ckpt import AsyncWriter, latest_step, restore, save
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import Model, model as tmodel, ssm
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime import Heartbeat, StragglerMonitor, with_retries
from repro_torch.sharding import ShardingCtx
from repro_torch.train import (AdamW, apply_updates, global_norm,
                               make_decode_step, make_prefill_step,
                               make_train_step, warmup_cosine)

TOL = dict(rtol=1e-4, atol=1e-5)
SCTX = ShardingCtx.local()
ARCHS = ("mamba2-130m", "recurrentgemma-9b", "granite-3-8b", "dbrx-132b",
         "seamless-m4t-large-v2", "llama-3.2-vision-90b")
# (B, S) of the loss cases: three SSD chunks of 16; past the hybrid
# smoke config's window of 32; the dense and moe families' (at moe's
# capacity 1.25, where tokens are dropped); the encdec and vlm families'
# (over 24 frames, 16 image tokens)
SHAPES = {"mamba2-130m": (2, 48), "recurrentgemma-9b": (2, 40),
          "granite-3-8b": (2, 32), "dbrx-132b": (2, 32),
          "seamless-m4t-large-v2": (2, 32), "llama-3.2-vision-90b": (2, 32)}
# the vlm cross blocks' gates, set in JAX's weights: the init's zeros make
# tanh(gate) remove the cross block and its gradient
GATES = {"gate_attn": 0.8, "gate_mlp": -0.6}


def _jctx():
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return JaxCtx(mesh=jax.sharding.Mesh(devs, ("data", "model")),
                  rules=JaxRules.default())


def _cfgs(arch: str, dtype: str = "float32", **kw):
    return (dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype,
                                **kw),
            dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype,
                                **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(batch: dict) -> dict:
    """Integer arrays as int64 tensors; a frontend (bf16) exactly."""
    return {k: (torch.from_numpy(np.asarray(v).astype(np.int64))
                if np.issubdtype(np.asarray(v).dtype, np.integer)
                else convert.tree_from_jax({k: v}, device="cpu")[k])
            for k, v in batch.items()}


def _frontend(cfg, B: int) -> dict:
    """The encdec or vlm frontend of a loss case: seeded normals × 0.1,
    bf16 (``tests/test_decode_equivalence.py``'s)."""
    rng = np.random.default_rng(6)
    if cfg.family == "encdec":
        shape, key = (B, cfg.n_frames, cfg.d_model), "frames"
    elif cfg.family == "vlm":
        shape, key = (B, cfg.n_img_tokens, cfg.vision_dim), "img_embed"
    else:
        return {}
    return {key: jnp.asarray(rng.normal(size=shape) * 0.1, jnp.bfloat16)}


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close_trees(got, want, what: str):
    """Port tree (dict of tensors) against a JAX tree at ``TOL``, leaf by
    leaf in sorted-key order (both packages' leaf order)."""
    g = tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=f"{what}[{i}]",
                                   **TOL)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (the spacing of 8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_bf16_ulp(got: torch.Tensor, want) -> None:
    a, b = _f32(got), _f32(want)
    assert (np.abs(a - b) <= _bf16_ulp(b)).all(), np.abs(a - b).max()


def _grads(params, batch, cfg):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss, aux = tmodel.loss_fn(tree_unflatten(params, leaves), batch, SCTX,
                               cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss, aux, tree_unflatten(params, grads)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard,structure", [
    (0, (0, 1), 0.9), (5, (1, 2), 0.9), (123456, (3, 4), 1.0),
    (7, (0, 1), 0.0)])
def test_synthetic_batches_match_jax(step, shard, structure):
    kw = dict(vocab=97, seq_len=33, global_batch=8, seed=3,
              structure=structure)
    got = SyntheticLM(**kw).batch_at(step, shard=shard, device="cpu")
    want = JaxSyntheticLM(**kw).batch_at(step, shard=shard)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int64 and got[key].is_contiguous()
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_synthetic_shards_tile_the_batch_and_iterate():
    ds = SyntheticLM(vocab=50280, seq_len=16, global_batch=8, seed=0)
    whole = ds.batch_at(2, device="cpu")["tokens"]
    parts = [ds.batch_at(2, shard=(i, 4), device="cpu")["tokens"]
             for i in range(4)]
    assert torch.equal(torch.cat(parts), whole)
    it = ds.iterator(2, device="cpu")
    assert [next(it)[0] for _ in range(3)] == [2, 3, 4]
    with pytest.raises(ValueError, match="split"):
        ds.batch_at(0, shard=(0, 3), device="cpu")


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,warmup,total", [(1e-3, 10, 110), (3e-3, 5, 200),
                                               (3e-4, 20, 300)])
def test_warmup_cosine_matches_jax(base, warmup, total):
    got = warmup_cosine(base, warmup, total)
    want = jax_warmup_cosine(base, warmup, total)
    for step in range(0, 201):
        g, w = float(got(step)), float(want(step))
        assert g == pytest.approx(w, rel=1e-6, abs=0.0), step


def _random_tree(rng, scale=1.0, positive=False):
    """fp32 numpy leaves of three shapes, nested."""
    def draw(shape):
        x = rng.normal(size=shape).astype(np.float32) * scale
        return np.abs(x) if positive else x
    return tree_map(draw, {"a": (7, 5), "b": {"c": (3,), "d": (2, 4, 6)}})


@pytest.mark.parametrize("opt_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("param_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("clipped", (False, True))
def test_adamw_update_matches_jax(param_dtype, opt_dtype, clipped):
    rng = np.random.default_rng(7)
    trees = {"p": _random_tree(rng),
             "g": _random_tree(rng, 3.0 if clipped else 0.01),
             "m": _random_tree(rng, 0.01),
             "v": _random_tree(rng, 1e-4, positive=True)}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def jax_tree(t, dt):
        return tree_map(lambda x: jnp.asarray(x, jdt[dt]), t)

    def port_tree(t, dt):
        return tree_map(lambda x: torch.from_numpy(x).to(tdt[dt]), t)

    lr = warmup_cosine(1e-3, 5, 100)
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-3, 5, 100),
                    opt_dtype=jdt[opt_dtype])
    opt = AdamW(lr=lr, opt_dtype=tdt[opt_dtype])
    step = 9
    jstate = {"m": jax_tree(trees["m"], opt_dtype),
              "v": jax_tree(trees["v"], opt_dtype)}
    jp, jg = jax_tree(trees["p"], param_dtype), jax_tree(trees["g"],
                                                         param_dtype)
    jd, jnew, jmet = jopt.update(jg, jstate, jp, jnp.int32(step))
    state = {"m": port_tree(trees["m"], opt_dtype),
             "v": port_tree(trees["v"], opt_dtype)}
    p, g = port_tree(trees["p"], param_dtype), port_tree(trees["g"],
                                                          param_dtype)
    before = [t.clone() for t in tree_leaves(p) + tree_leaves(state)]
    d, new, met = opt.update(g, state, p, step)
    # nothing given is modified
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(p) + tree_leaves(state)))
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-6)
    assert (float(met["grad_norm"]) > 1.0) == clipped
    assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    for got, want, dt in ((d, jd, param_dtype),
                          (new["m"], jnew["m"], opt_dtype),
                          (new["v"], jnew["v"], opt_dtype),
                          (apply_updates(p, d),
                           jax.tree_util.tree_map(lambda a, b: a + b.astype(
                               a.dtype), jp, jd), param_dtype)):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert a.dtype == tdt[dt]
            if dt == "float32":
                np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-6,
                                           atol=1e-12)
            else:
                _within_bf16_ulp(a, b)


def test_adamw_state_specs_and_init():
    cfg = configs.get_smoke_config("mamba2-130m")
    opt = AdamW(lr=lambda s: 1e-3, opt_dtype=torch.bfloat16)
    specs = opt.state_specs(tmodel.param_specs(cfg))
    params = Model(cfg, device="cpu").params.tree()
    state = opt.init(params)
    from repro_torch.models.params import check_tree
    check_tree(specs, state)
    assert all(not t.any() for t in tree_leaves(state))
    g = tree_map(torch.ones_like, params)
    n = sum(t.numel() for t in tree_leaves(params))
    assert float(global_norm(g)) == pytest.approx(n ** 0.5, rel=1e-6)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

_JAX_GRADS: dict = {}


def _jax_loss_and_grads(arch: str):
    """JAX's (params, batch, loss, aux, grads) at the smoke config, fp32,
    computed once per test process."""
    if arch not in _JAX_GRADS:
        _, jcfg = _cfgs(arch)
        jm = jax_build_model(jcfg)
        params = jax_init_params(jm.param_specs(), jax.random.PRNGKey(2))
        B, S = SHAPES[arch]
        batch = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=S, global_batch=B,
                               seed=4).batch_at(0)
        batch = dict(batch, **_frontend(jcfg, B))
        if jcfg.family == "vlm":
            cross = params["groups"]["cross"]
            params["groups"]["cross"] = dict(cross, **{
                k: jnp.full_like(cross[k], v) for k, v in GATES.items()})
        ctx = _jctx()
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b, ctx), has_aux=True))(params, batch)
        _JAX_GRADS[arch] = (_np(params), _np(batch), float(loss),
                            {k: float(v) for k, v in aux.items()},
                            _np(grads))
    return _JAX_GRADS[arch]


@pytest.mark.parametrize("remat", (True, False), ids=("remat", "no_remat"))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    """The loss (and the moe family's aux losses, summed over layers) at
    rtol 1e-4 / atol 1e-5; the ssm gradients elementwise at the same bar.
    The hybrid smoke model grows its gradients about 400x from the last
    layer to the first, and fp32 rounding with them: JAX's own gradients,
    jitted with remat against eager without, differ by 3.4e-5 of the
    embedding gradient's largest entry.  So each hybrid gradient leaf is
    held to max|Δ| <= 1e-4 · max|g_jax|.  The dense and moe smoke models
    draw wq with fan-in H = 4, so their attention logits reach ±30 and the
    softmax is nearly hard: one-ulp differences between XLA's and torch's
    exp, sin and cos grow from 6e-5 after the first layer to 4e-3 after
    the fourth (of activations 30–70), and JAX's own fp32 gradients move
    up to 4.9e-4 of their largest entry when the parameters are carried at
    x64.  Each of their leaves is held to max|Δ| <= 3e-3 · max|g_jax|
    (the port's worst: 1.0e-3, granite's wq), as are the encdec and vlm
    families' (their smoke models draw wq alike), over a seeded frontend
    and, for vlm, with the cross gates set nonzero in JAX's weights."""
    params_np, batch, loss, aux, grads = _jax_loss_and_grads(arch)
    cfg, _ = _cfgs(arch, remat=remat)
    params = convert.params_from_jax(cfg, params_np, device="cpu")
    got_loss, got_aux, got = _grads(params, _to_torch(batch), cfg)
    np.testing.assert_allclose(got_loss.item(), loss, **TOL)
    np.testing.assert_allclose(got_aux["ce"].item(), aux["ce"], **TOL)
    if cfg.family == "moe":
        for key in ("lb_loss", "router_z"):
            assert aux[key] > 0
            np.testing.assert_allclose(got_aux[key].item(), aux[key], **TOL)
    else:
        assert got_aux["lb_loss"] == 0.0 and got_aux["router_z"] == 0.0
    if cfg.family == "ssm":
        _close_trees(got, grads, f"{arch} grads")
        return
    bar = 1e-4 if cfg.family == "hybrid" else 3e-3
    for i, (g, w) in enumerate(zip(tree_leaves(got),
                                   jax.tree_util.tree_leaves(grads))):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= bar * np.abs(w).max(), i


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_numbers(arch):
    params_np, batch, *_ = _jax_loss_and_grads(arch)
    out = []
    for remat in (True, False):
        cfg, _ = _cfgs(arch, remat=remat)
        params = convert.params_from_jax(cfg, params_np, device="cpu")
        out.append(_grads(params, _to_torch(batch), cfg))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


def test_ce_loss_chunked_cuts_the_sequence_evenly_or_raises():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 1536, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 11)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, 11, (2, 1536)))
    logits = (x @ w).log_softmax(-1)
    keep = labels >= 0
    want = -logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0][keep]
    got = tmodel.ce_loss_chunked(x, w, labels, SCTX)     # 3 chunks of 512
    assert got.item() == pytest.approx(want.mean().item(), rel=1e-5)
    with pytest.raises(RuntimeError):
        tmodel.ce_loss_chunked(x[:, :1537 - 512], w, labels[:, :1025], SCTX)


def test_unported_families_do_not_train():
    """The encdec and vlm families, once refused here, train: through
    ``Model.loss`` (the frontend in ``batch``) their fp32 losses equal
    JAX's, and the gradients reach the frontend's projection and the
    cross-attention (nonzero, within 3e-3 of max|g_jax|, the dense bar of
    ``test_loss_and_grads_match_jax``)."""
    for arch, reached in (("seamless-m4t-large-v2",
                           (("frame_proj",), ("enc_blocks", "attn", "wq"),
                            ("dec_blocks", "cross_attn", "wk"))),
                          ("llama-3.2-vision-90b",
                           (("img_proj",), ("groups", "cross", "attn", "wv"),
                            ("groups", "cross", "gate_attn"),
                            ("groups", "cross", "gate_mlp")))):
        params_np, batch, loss, _, grads = _jax_loss_and_grads(arch)
        cfg, _ = _cfgs(arch)
        model = Model(cfg, device="cpu",
                      params=convert.params_from_jax(cfg, params_np,
                                                     device="cpu"))
        params = model.params.tree()
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        got_loss, _ = model.loss(tree, _to_torch(batch))
        got = tree_unflatten(params, torch.autograd.grad(got_loss, leaves))
        np.testing.assert_allclose(got_loss.item(), loss, **TOL)
        for path in reached:
            g, w = got, grads
            for key in path:
                g, w = g[key], w[key]
            w = np.asarray(w)
            assert np.abs(w).max() > 0, (arch, path)
            assert np.abs(g.numpy() - w).max() <= 3e-3 * np.abs(w).max(), \
                (arch, path)


def test_ssd_long_sequence_grads_match_jax():
    """``tests/test_ssd_long_grad.py``'s inputs (S 512, chunk 64, dt up to
    3): without the clamp before the masked exp the gradients are NaN."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 1, 512, 4, 16, 16
    chunk = 64
    xs = [rng.normal(size=(B, S, H, P)).astype(np.float32),
          rng.uniform(0.5, 3.0, size=(B, S, H)).astype(np.float32),
          rng.normal(size=(B, S, N)).astype(np.float32),
          rng.normal(size=(B, S, N)).astype(np.float32)]
    A_log = np.zeros((H,), np.float32)

    def jloss(xh, dt, Bm, Cm):
        y, state = jssm.ssd_chunked(xh, dt, jnp.asarray(A_log), Bm, Cm, chunk)
        return jnp.sum(y.astype(jnp.float32) ** 2) + jnp.sum(state ** 2)

    want, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, xs))
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    y, state = ssm.ssd_chunked(leaves[0], leaves[1], torch.from_numpy(A_log),
                               leaves[2], leaves[3], chunk)
    loss = torch.sum(y.float() ** 2) + torch.sum(state ** 2)
    grads = torch.autograd.grad(loss, leaves)
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for g, w in zip(grads, jgrads):
        assert torch.isfinite(g).all()
        scale = np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _close_params(params, jp, jm, lrs: list, step: int) -> None:
    """Parameters after AdamW steps at ``TOL``, but where JAX's first
    moment is within the gradients' rounding (|m| <= 1e-4 · max|m| of the
    leaf): there m̂ / √v̂ is the ratio of two rounding residues, about ±1
    whatever their size, so one step moves the parameter by up to ±lr in
    either package.  Those entries are held to 2 · Σ lr instead."""
    for i, (a, b, m) in enumerate(zip(tree_leaves(params),
                                      jax.tree_util.tree_leaves(jp),
                                      jax.tree_util.tree_leaves(jm))):
        a, b, m = _f32(a), _f32(b), np.abs(_f32(m))
        diff = np.abs(a - b)
        miss = diff > TOL["atol"] + TOL["rtol"] * np.abs(b)
        residue = m <= 1e-4 * m.max()
        assert not (miss & ~residue).any(), (step, i, diff[~residue].max())
        assert (diff[miss] <= 2 * sum(lrs)).all(), (step, i)


def test_train_steps_match_jax():
    """From one JAX state (parameters after a step, its nonzero moments)
    carried over by ``params_from_jax`` + ``opt_state_from_jax``, three
    steps past warmup in both packages on the same batches: the metrics
    and moments at ``TOL``, the parameters as ``_close_params`` says."""
    arch = "mamba2-130m"
    cfg, jcfg = _cfgs(arch)
    jm = jax_build_model(jcfg)
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-3, 2, 50))
    jstep = jax.jit(jax_make_train_step(jm, _jctx(), jopt))
    jds = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=32, global_batch=4, seed=1)
    jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(3))
    js = jopt.init(jp)
    jp, js, _ = jstep(jp, js, jds.batch_at(2), jnp.int32(2))
    params = convert.params_from_jax(cfg, _np(jp), device="cpu")
    state = convert.opt_state_from_jax(cfg, _np(js), device="cpu")
    step_fn = make_train_step(Model(cfg, device="cpu"), SCTX,
                              AdamW(lr=warmup_cosine(1e-3, 2, 50)))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    lrs = []
    for step in (3, 4, 5):
        jp, js, jmet = jstep(jp, js, jds.batch_at(step), jnp.int32(step))
        params, state, met = step_fn(params, state,
                                     ds.batch_at(step, device="cpu"), step)
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       err_msg=f"{key} at step {step}", **TOL)
        lrs.append(float(jmet["lr"]))
        _close_params(params, jp, js["m"], lrs, step)
        _close_trees(state["m"], js["m"], f"m at step {step}")
        _close_trees(state["v"], js["v"], f"v at step {step}")


def test_opt_state_from_jax_checks_the_moment_dtype():
    cfg = configs.get_smoke_config("mamba2-130m")
    jm = jax_build_model(jconfigs.get_smoke_config("mamba2-130m"))
    jstate = JaxAdamW(lr=lambda s: 1e-3, opt_dtype=jnp.bfloat16).init(
        jax_init_params(jm.param_specs(), jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="expected"):
        convert.opt_state_from_jax(cfg, _np(jstate), device="cpu")
    state = convert.opt_state_from_jax(
        dataclasses.replace(cfg, opt_dtype="bfloat16"), _np(jstate),
        device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state))


def test_grad_accumulation_matches_large_batch():
    """JAX's accumulation test at the ssm smoke config (bf16): the same data
    give the same mean gradient, so the same update."""
    cfg = configs.get_smoke_config("mamba2-130m")
    model = Model(cfg, device="cpu", seed=1)
    params = model.params.tree()
    opt = AdamW(lr=lambda s: 1e-3, weight_decay=0.0)
    state = opt.init(params)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=8,
                        seed=1).batch_at(0, device="cpu")
    p1, _, m1 = make_train_step(model, SCTX, opt, accum=1)(params, state,
                                                           batch, 0)
    p4, _, m4 = make_train_step(model, SCTX, opt, accum=4)(params, state,
                                                           batch, 0)
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=2e-2)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=2e-2, atol=2e-3)


def test_grad_accumulation_matches_large_batch_dense():
    """JAX's accumulation test at its own config, granite-3-8b's smoke
    config (bf16): the same data give the same mean gradient, so the same
    update, within JAX's rtol 2e-2 / atol 2e-3."""
    cfg = configs.get_smoke_config("granite_3_8b")
    model = Model(cfg, device="cpu", seed=1)
    params = model.params.tree()
    opt = AdamW(lr=lambda s: 1e-3, weight_decay=0.0)
    state = opt.init(params)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=8,
                        seed=1).batch_at(0, device="cpu")
    p1, _, m1 = make_train_step(model, SCTX, opt, accum=1)(params, state,
                                                           batch, 0)
    p4, _, m4 = make_train_step(model, SCTX, opt, accum=4)(params, state,
                                                           batch, 0)
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=2e-2)
    moved = 0
    for a, b, p in zip(tree_leaves(p1), tree_leaves(p4), tree_leaves(params)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=2e-2, atol=2e-3)
        moved += not torch.equal(a, p)
    assert moved == len(tree_leaves(params))


def test_train_loss_descends():
    """JAX's bar: 30 steps on the structured stream (structure 1.0), lr
    3e-3 after 5 warmup steps, drop the loss by at least 0.5."""
    cfg = configs.get_smoke_config("mamba2_130m")
    model = Model(cfg, device="cpu", seed=0)
    params = model.params.tree()
    opt = AdamW(lr=warmup_cosine(3e-3, 5, 200), weight_decay=0.0)
    state = opt.init(params)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0,
                     structure=1.0)
    step_fn = make_train_step(model, SCTX, opt)
    losses = []
    for step in range(30):
        params, state, met = step_fn(params, state,
                                     ds.batch_at(step, device="cpu"), step)
        losses.append(float(met["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses


def test_prefill_and_decode_steps_take_the_tree_given():
    cfg = configs.get_smoke_config("mamba2-130m")
    model = Model(cfg, device="cpu", seed=2)
    params = tree_map(lambda t: t.detach().clone(), model.params.tree())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 32)))
    want, cache = model.prefill({"tokens": toks})
    got, got_cache = make_prefill_step(model, SCTX)(params, {"tokens": toks})
    assert torch.equal(got, want)
    step, _ = make_decode_step(model, SCTX)(params, got_cache, toks[:, 0], 32)
    assert torch.equal(step, model.decode(cache, toks[:, 0], 32)[0])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": (torch.tensor([1.0, -2.5, 3.0e-3, 7.0],
                                     dtype=torch.bfloat16),
                        torch.tensor(3.5, dtype=torch.float32))}}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    for step in [1, 2, 3, 4]:
        save(d, step, tree, keep_k=2)
    assert latest_step(d) == 4
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_00000003", "step_00000004"]
    got, step = restore(d)
    assert step == 4
    assert torch.equal(got["a"], tree["a"])
    c0, c1 = got["b"]["c"]
    assert c0.dtype == torch.bfloat16 and torch.equal(c0, tree["b"]["c"][0])
    assert c1.shape == () and float(c1) == 3.5
    got, _ = restore(d, 3, device="cpu")
    assert torch.equal(got["a"], tree["a"])
    with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["b/c/__0"]["dtype"] == "bfloat16"


def test_checkpoint_torn_write_is_never_restored(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 1, {"x": torch.ones(3)})
    # a write cut off before its rename, and a step dir never committed
    torn = os.path.join(d, ".tmp_step_00000002")
    os.makedirs(torn)
    os.makedirs(os.path.join(d, "step_00000003"))
    assert latest_step(d) == 1
    got, step = restore(d)
    assert step == 1 and torch.equal(got["x"], torch.ones(3))
    save(d, 4, {"x": torch.zeros(3)})            # gc clears the torn write
    assert not os.path.exists(torn) and latest_step(d) == 4
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"))


def test_checkpoint_async_writer(tmp_path):
    d = str(tmp_path / "ckpt")
    w = AsyncWriter()
    x = torch.full((8,), 2.0)
    w.submit(d, 7, {"x": x})
    x.fill_(5.0)          # the writer holds its own snapshot
    w.flush()
    got, step = restore(d)
    assert step == 7
    assert torch.equal(got["x"], torch.full((8,), 2.0))


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    d = str(tmp_path / "ckpt")
    bits = np.array([0x3F80, 0xC020, 0x3B44, 0x7F7F, 0x0001], np.uint16)
    tree = {"a": jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
            "b": {"c": (jnp.asarray(bits.view(jnp.bfloat16)),
                        jnp.float32(3.5))},
            "w": jnp.asarray(np.linspace(-1, 1, 12, dtype=np.float32))}
    jax_save(d, 5, tree)
    got, step = restore(d)
    assert step == 5
    assert torch.equal(got["a"], torch.arange(6, dtype=torch.int32)
                       .reshape(2, 3))
    c0, c1 = got["b"]["c"]
    assert c0.dtype == torch.bfloat16
    np.testing.assert_array_equal(c0.view(torch.int16).numpy().view(np.uint16),
                                  bits)
    assert c1.shape == () and c1.dtype == torch.float32 and float(c1) == 3.5
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(tree["w"]))


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    save(d, 6, tree)
    got, step = jax_restore(d)
    assert step == 6
    np.testing.assert_array_equal(got["a"], tree["a"].numpy())
    c0, c1 = got["b"]["c"]
    assert c0.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(c0).view(np.uint16),
        tree["b"]["c"][0].view(torch.int16).numpy().view(np.uint16))
    assert np.asarray(c1).shape == () and float(c1) == 3.5


# ---------------------------------------------------------------------------
# the fault-tolerance runtime
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_persistent_slow_host():
    mon = StragglerMonitor(threshold=1.4, patience=3)
    flagged = []
    for step in range(10):
        flagged = mon.update({0: 1.0, 1: 1.02, 2: 0.98, 3: 2.5})
    assert flagged == [3]
    mon2 = StragglerMonitor(threshold=1.4, patience=3)
    for step in range(10):
        out = mon2.update({0: 1.0, 1: 1.0, 2: 3.0 if step == 4 else 1.0})
    assert out == []


def test_with_retries():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert with_retries(flaky, max_retries=5, backoff_s=0.0)() == "ok"
    assert calls["n"] == 3

    def always_fails():
        raise RuntimeError("permanent")
    with pytest.raises(RuntimeError, match="permanent"):
        with_retries(always_fails, max_retries=2, backoff_s=0.0)()


def test_heartbeat_dead_hosts(tmp_path):
    d = str(tmp_path / "hb")
    Heartbeat(d, 0).beat(3)
    Heartbeat(d, 1).beat(3)
    assert Heartbeat.dead_hosts(d, timeout_s=60.0) == []
    with open(os.path.join(d, "host_1.hb"), "w") as f:
        json.dump({"step": 3, "t": 0.0}, f)
    assert Heartbeat.dead_hosts(d, timeout_s=60.0) == [1]


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

_ARGV = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--batch",
         "4", "--seq", "32", "--ckpt-every", "2", "--log-every", "1"]


def test_train_main_resumes_bitwise(tmp_path, capsys):
    """Stopped at 4 steps and resumed to 6, the run ends bitwise where an
    uninterrupted 6-step run does (the schedule is in warmup, so it does
    not depend on the step count)."""
    cut, whole = str(tmp_path / "cut"), str(tmp_path / "whole")
    assert tlaunch.main(_ARGV + ["--steps", "4", "--ckpt-dir", cut]) == 0
    assert latest_step(cut) == 3
    assert tlaunch.main(_ARGV + ["--steps", "6", "--ckpt-dir", cut]) == 0
    assert "[train] resumed from step 3" in capsys.readouterr().out
    assert tlaunch.main(_ARGV + ["--steps", "6", "--ckpt-dir", whole]) == 0
    a, sa = restore(cut)
    b, sb = restore(whole)
    assert sa == sb == 5
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with open(os.path.join(whole, "log.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == list(range(6))


def test_train_returns_the_state_it_checkpointed(tmp_path):
    cfg = configs.get_smoke_config("recurrentgemma-9b")
    out = tlaunch.train(cfg, steps=3, batch=2, seq=40, lr=3e-3, warmup=1,
                        ckpt_dir=str(tmp_path), ckpt_every=10, device="cpu",
                        log=lambda _: None)
    assert out["start"] == 0 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    tree, step = restore(str(tmp_path))
    assert step == 2
    for x, y in zip(tree_leaves({"params": out["params"],
                                 "opt": out["opt_state"]}), tree_leaves(tree)):
        assert torch.equal(x, y)
