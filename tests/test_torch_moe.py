"""The port's dense and moe families against the JAX package at the smoke
configs: the MoE layer, the MoE block, and the models' prefill, decode and
serving.

The same numpy inputs, made from a seed, go through JAX and the port; JAX
parameters (``init_params(..., jax.random.PRNGKey(k))``) and caches are
carried across by ``repro_torch.convert``.  JAX's results are computed
once per module, one jit a case.  The bars:

  * ``moe_apply`` at fp32: outputs within 1e-5 · max|ref|, the aux losses
    at rtol 1e-5, and the routing integers (``slot``, ``tok_s``) equal, at
    the published capacity factor 1.25 (where tokens are dropped) and at
    ``n_experts`` (where none are); the gradients of a weighted sum of the
    outputs and the aux losses within 1e-5 · max|g| of ``jax.grad``; at
    bf16, 99 % of the outputs within ``tests/test_moe_dispatch.py``'s rtol
    5e-2 / atol 5e-3 and all within twice JAX's own bf16 distance from
    its fp32 run (the test's docstring says why);
  * a block and a model at fp32 within ``tests/test_torch_models.py``'s
    rtol 1e-4 / atol 1e-5 (a block's output, a model's logits and
    caches: below); at bf16 the port no further from JAX's fp32 run than
    twice JAX's own bf16 run is;
  * decode replayed over the prompt against prefill (normalised
    log-probs) at ``tests/test_decode_equivalence.py``'s bars: 2e-2 for
    the dense family, 5e-2 for the moe family at capacity ``n_experts``.

The smoke models draw ``wq`` with fan-in H = 4, so attention logits reach
±30 and the softmax is nearly hard: one-ulp differences between XLA's and
torch's exp, sin and cos grow layer by layer (6e-5 after the first of 4
layers, 4e-3 after the fourth, of activations 30–70).  So a model's fp32
logits and cache leaves are held to max|Δ| <= 1e-3 · max|ref|, and one
block's output (after its attention) to max|Δ| <= 1e-4 · max|ref|; the
K/V it writes, before any attention, to rtol 1e-4 / atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.models import transformer as jtransformer
from repro.sharding import LogicalRules as JaxRules
from repro.sharding import ShardingCtx as JaxCtx
from repro_torch import configs, convert
from repro_torch.launch import serve as tserve
from repro_torch.models import (layers, model as tmodel, moe, params,
                                transformer)
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.sharding import ShardingCtx

SCTX = ShardingCtx.local()
MOE_ARCHS = ("dbrx_132b", "kimi_k2_1t_a32b")
MODEL_ARCHS = ("granite_3_8b", "granite_34b", "dbrx_132b", "kimi_k2_1t_a32b")
CAPS = ("published", "ample")           # 1.25, and n_experts (no drops)
TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = 1e-3                        # of max|ref|; see the docstring
BLOCK_TOL = 1e-4                        # of max|ref|; see the docstring
B, S = 2, 16                            # the MoE layer's tokens
PROMPT = 24                             # the models' prompt


def _jctx():
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return JaxCtx(mesh=jax.sharding.Mesh(devs, ("data", "model")),
                  rules=JaxRules.default())


def _cfgs(arch: str, dtype: str = "float32", cap: str = "published", **kw):
    cfg = configs.get_smoke_config(arch)
    if cap == "ample":
        kw["capacity_factor"] = float(cfg.n_experts)
    return (dataclasses.replace(cfg, dtype=dtype, **kw),
            dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype,
                                **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _rel(got, want, what: str = "", bar: float = 1e-5) -> None:
    """max|Δ| <= bar · max|want|."""
    a, b = _f32(got), _f32(want)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= bar * scale, \
        f"{what}: max|Δ| {err:.3e} > {bar} · {scale:.3e}"


def _x(cfg, seed: int, shape=None) -> np.ndarray:
    shape = shape or (B, S, cfg.d_model)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens_x(cfg, seed: int) -> np.ndarray:
    """(B, S, D) activations sharing one direction, as a batch of related
    tokens does: the router then loads some experts past the capacity."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)) + rng.normal(size=cfg.d_model)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _jax_routing(p, xt, jcfg):
    logits = xt.astype(jnp.float32) @ p["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(probs, jcfg.top_k)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    T = xt.shape[0]
    cap = max(int(np.ceil(jcfg.capacity_factor * T * jcfg.top_k
                          / jcfg.n_experts)), 1)
    _, (slot, tok_s, _) = jmoe._dispatch(xt, topw, topi, jcfg.n_experts,
                                         jcfg.top_k, cap)
    return slot, tok_s, jnp.sort(probs, axis=-1)[:, ::-1]


def _port_routing(p, xt, cfg):
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    _, (slot, tok_s, _) = moe._dispatch(xt, topw, topi, cfg.n_experts,
                                        cfg.top_k,
                                        moe._capacity(cfg, xt.shape[0]))
    return slot, tok_s


_JAX_MOE: dict = {}


def _jax_moe(arch: str, cap: str, dtype: str = "float32"):
    """JAX's (params, x, w, out, aux, slot, tok_s, sorted probs, grads,
    out of the fp32 twin) for one case; the gradients (fp32 only) of
    sum(out · w) + 0.01 lb_loss + 1e-3 router_z with respect to the
    parameters and x; the fp32 twin's output (bf16 only) from the same
    weights and activations at fp32."""
    key = (arch, cap, dtype)
    if key not in _JAX_MOE:
        _, jcfg = _cfgs(arch, dtype, cap)
        p = jparams.init_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(3))
        x = _tokens_x(jcfg, 4)
        w = _x(jcfg, 5)
        ctx = _jctx()
        jdt = getattr(jnp, dtype)

        def loss(p, x):
            out, aux = jmoe.moe_apply(p, x, ctx, jcfg)
            return (jnp.sum(out.astype(jnp.float32) * w)
                    + 0.01 * aux["lb_loss"] + 1e-3 * aux["router_z"])

        @jax.jit
        def run(p, x):
            out, aux = jmoe.moe_apply(p, x, ctx, jcfg)
            slot, tok_s, probs = _jax_routing(p, x.reshape(-1, x.shape[-1]),
                                              jcfg)
            grads = (jax.grad(loss, argnums=(0, 1))(p, x)
                     if dtype == "float32" else None)
            return out, aux, slot, tok_s, probs, grads

        out = run(p, jnp.asarray(x, jdt))
        twin = None
        if dtype != "float32":
            cfg32 = dataclasses.replace(jcfg, dtype="float32")
            p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p)
            x32 = jnp.asarray(x, jdt).astype(jnp.float32)
            twin = np.asarray(jax.jit(
                lambda p, x: jmoe.moe_apply(p, x, ctx, cfg32)[0])(p32, x32))
        _JAX_MOE[key] = (_np(p), x, w) + tuple(_np(out)) + (twin,)
    return _JAX_MOE[key]


def _port_moe(arch: str, cap: str, dtype: str = "float32", **kw):
    cfg, _ = _cfgs(arch, dtype, cap, **kw)
    p_np, x, w, *rest = _jax_moe(arch, cap, dtype)
    p = convert.tree_from_jax(p_np, device="cpu")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return cfg, p, xt, w, rest


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, cap):
    cfg, p, x, _, (jout, jaux, jslot, jtok, jprobs, _, _) = _port_moe(arch,
                                                                      cap)
    k, E = cfg.top_k, cfg.n_experts
    # untied router probabilities at the top-k boundary (jax.lax.top_k and
    # torch.topk may order ties differently)
    assert (jprobs[:, k - 1] - jprobs[:, k]).min() > 0
    out, aux = moe.moe_apply(p, x, SCTX, cfg)
    _rel(out, jout, "out")
    for name in ("lb_loss", "router_z"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]),
                                   rtol=1e-5)
    slot, tok_s = _port_routing(p, x.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(tok_s.numpy(), jtok)
    dropped = int((slot == E * moe._capacity(cfg, B * S)).sum())
    assert (dropped > 0) == (cap == "published"), dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_bf16_matches_jax(arch):
    """At bf16 the two packages round their matmuls' sums and the SiLU's
    steps each its own way; where a routed and a shared expert's outputs
    nearly cancel (kimi-k2), one ulp of a term is 7.8e-3, past
    tests/test_moe_dispatch.py's atol 5e-3 (that test compares JAX with
    itself).  So 99 % of the outputs are held to its rtol 5e-2 / atol
    5e-3, and every one to twice JAX's own bf16 distance from its fp32 run
    of the same weights."""
    cfg, p, x, _, (jout, jaux, *_rest, twin) = _port_moe(arch, "published",
                                                         "bfloat16")
    out, aux = moe.moe_apply(p, x, SCTX, cfg)
    assert out.dtype == torch.bfloat16
    got, want = _f32(out), _f32(jout)
    within = np.abs(got - want) <= 5e-3 + 5e-2 * np.abs(want)
    assert within.mean() >= 0.99, within.mean()
    err, err_jax = np.abs(got - twin).max(), np.abs(want - twin).max()
    assert err <= 2 * err_jax, (err, err_jax)
    np.testing.assert_allclose(aux["lb_loss"].item(), float(jaux["lb_loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_grads_match_jax(arch):
    cfg, p, x, w, (*_, jgrads, _) = _port_moe(arch, "published")
    leaves = [t.requires_grad_() for t in tree_leaves(p)]
    x.requires_grad_()
    out, aux = moe.moe_apply(tree_unflatten(p, leaves), x, SCTX, cfg)
    loss = ((out * torch.from_numpy(w)).sum() + 0.01 * aux["lb_loss"]
            + 1e-3 * aux["router_z"])
    loss.backward()
    jp, jx = jgrads
    got = [t.grad for t in leaves]
    want = jax.tree_util.tree_leaves(jp)
    assert len(got) == len(want)
    for i, (g, wg) in enumerate(zip(got, want)):
        _rel(g, wg, f"grad {i}")
    _rel(x.grad, jx, "grad x")


@pytest.mark.parametrize("mode", ("local", "local2"))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_local_dispatch_equals_global_at_dp_1(arch, mode):
    """On one device (DP = pod × data = 1) the per-shard dispatch is the
    global one: the same numbers, bit for bit, at the published capacity."""
    cfg, p, x, _, (jout, *_rest) = _port_moe(arch, "published")
    want, want_aux = moe.moe_apply(p, x, SCTX, cfg)
    got, aux = moe.moe_apply(p, x, SCTX,
                             dataclasses.replace(cfg, moe_dispatch=mode))
    assert torch.equal(got, want)
    assert torch.equal(aux["lb_loss"], want_aux["lb_loss"])
    _rel(got, jout, "out")


def test_combine_sums_a_token_in_expert_order():
    """Token t's k rows are added one after another in expert order, as
    JAX's scatter applies them (bf16, where the order shows)."""
    E, k, cap, D, T = 4, 3, 2, 5, 2
    out_e = torch.randn(E, cap, D, generator=torch.Generator().manual_seed(0)
                        ).to(torch.bfloat16)
    # token 0 chose experts (2, 0, 3), token 1 (1, 0, 2)
    topi = torch.tensor([[2, 0, 3], [1, 0, 2]])
    topw = torch.full((T, k), 1.0)
    xt = torch.zeros(T, D, dtype=torch.bfloat16)
    _, routing = moe._dispatch(xt, topw, topi, E, k, cap)
    got = moe._combine(out_e, routing, T)
    slot = routing[0]
    rows = torch.cat([out_e.reshape(E * cap, D), out_e.new_zeros(1, D)])
    for t, experts in enumerate(((0, 2, 3), (0, 1, 2))):
        want = torch.zeros(D, dtype=torch.bfloat16)
        for e in experts:
            j = next(i for i in range(T * k)
                     if routing[1][i] == t and slot[i] // cap == e)
            want = want + rows[slot[j]]
        assert torch.equal(got[t], want)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

_JAX_BLOCK: dict = {}


def _jax_block(arch: str):
    """JAX's block_apply / block_prefill_kv / block_decode (plain cache)
    with moe=True at fp32."""
    if arch not in _JAX_BLOCK:
        _, jcfg = _cfgs(arch)
        p = jparams.init_params(jtransformer.block_specs(jcfg, moe=True),
                                jax.random.PRNGKey(6))
        x = _x(jcfg, 7) * 0.3
        xd = _x(jcfg, 8, (B, jcfg.d_model)) * 0.3
        ck = _x(jcfg, 9, (B, jcfg.n_kv_heads, S, jcfg.hd))
        cv = _x(jcfg, 10, (B, jcfg.n_kv_heads, S, jcfg.hd))
        ctx = _jctx()

        @jax.jit
        def run(p, x, xd, ck, cv):
            pos = jnp.arange(S)
            y, aux = jtransformer.block_apply(p, x, ctx, jcfg, positions=pos,
                                              causal=True, window=0, moe=True)
            kv = jtransformer.block_prefill_kv(p, x, jcfg, pos)
            dec = jtransformer.block_decode(p, xd, ck, cv, jnp.int32(S // 2),
                                            ctx, jcfg, moe=True)
            return y, aux, kv, dec

        _JAX_BLOCK[arch] = ((_np(p), x, xd, ck, cv)
                            + tuple(_np(run(p, x, xd, ck, cv))))
    return _JAX_BLOCK[arch]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax(arch):
    cfg, _ = _cfgs(arch)
    p_np, x, xd, ck, cv, jy, jaux, jkv, jdec = _jax_block(arch)
    p = convert.tree_from_jax(p_np, device="cpu")
    pos = torch.arange(S)
    y, aux = transformer.block_apply(p, torch.from_numpy(x), SCTX, cfg,
                                     positions=pos, window=0, moe=True)
    _rel(y, jy, "block out", BLOCK_TOL)
    for name in ("lb_loss", "router_z"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]),
                                   rtol=1e-5)
    for got, want in zip(transformer.block_prefill_kv(
            p, torch.from_numpy(x), cfg, pos), jkv):
        np.testing.assert_allclose(_f32(got), want, **TOL)
    tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
    before = (tk.clone(), tv.clone())
    dec = transformer.block_decode(p, torch.from_numpy(xd), tk, tv, S // 2,
                                   SCTX, cfg, moe=True)
    _rel(dec[0], jdec[0], "decode out", BLOCK_TOL)
    for got, want, what in zip(dec[1:], jdec[1:], ("k", "v")):
        np.testing.assert_allclose(_f32(got), want, err_msg=what, **TOL)
    # the token went into slot pos of the plain cache, nothing else moved
    keep = [s for s in range(S) if s != S // 2]
    assert torch.equal(dec[1][:, :, keep], before[0][:, :, keep])
    assert torch.equal(tk, before[0]) and torch.equal(tv, before[1])


# ---------------------------------------------------------------------------
# the models: prefill, decode, replay, serving
# ---------------------------------------------------------------------------

_JAX_MODEL: dict = {}


def _jax_model(arch: str, dtype: str):
    """JAX's prefill of a PROMPT-token prompt, then one decode step from
    that cache grown by one slot, at ``dtype`` and at fp32 on the same
    weights: (params, tokens, next token, logits, cache, step logits,
    step cache) at each."""
    key = (arch, dtype)
    if key not in _JAX_MODEL:
        _, jcfg = _cfgs(arch, dtype)
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(1))
        rng = np.random.default_rng(12)
        toks = rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
        nxt = rng.integers(0, jcfg.vocab, (B,)).astype(np.int32)
        ctx = _jctx()

        def run_on(jm, jp):
            @jax.jit
            def run(jp, toks, nxt):
                logits, cache = jm.prefill(jp, {"tokens": toks}, ctx)
                grown = jax.tree_util.tree_map(
                    lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, 1), (0, 0)]),
                    cache)
                step, new = jm.decode(jp, grown, nxt, jnp.int32(PROMPT), ctx)
                return logits, cache, step, new
            return _np(run(jp, jnp.asarray(toks), jnp.asarray(nxt)))

        out = run_on(jm, jp)
        if dtype == "float32":
            out32 = out
        else:
            jm32 = jax_build_model(dataclasses.replace(jcfg, dtype="float32"))
            out32 = run_on(jm32, jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float32), jp))
        _JAX_MODEL[key] = (_np(jp), toks, nxt, out, out32)
    return _JAX_MODEL[key]


def _close_model(got, want, want32, dtype: str, what: str) -> None:
    """fp32: max|Δ| <= MODEL_TOL · max|ref| (logits normalised); bf16: no
    further from JAX's fp32 run than twice JAX's bf16 run is."""
    a, b, c = _f32(got), _f32(want), _f32(want32)
    if what == "logits":
        a, b, c = (v - v.max(-1, keepdims=True) for v in (a, b, c))
    if dtype == "float32":
        return _rel(a, b, what, MODEL_TOL)
    err, err_jax = np.abs(a - c).max(), np.abs(b - c).max()
    assert err <= 2 * err_jax, (what, err, err_jax)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    cfg, _ = _cfgs(arch, dtype)
    jp, toks, nxt, out, out32 = _jax_model(arch, dtype)
    tm = convert.model_from_jax(cfg, jp, device="cpu")
    logits, cache = tm.prefill({"tokens": torch.from_numpy(toks).long()})
    assert logits.dtype == torch.float32
    assert set(cache) == {"k", "v"}
    shape = (cfg.n_layers, B, cfg.n_kv_heads, PROMPT, cfg.hd)
    for name, got in (("logits", logits), ("k", cache["k"]),
                      ("v", cache["v"])):
        i = {"logits": 0, "k": 1, "v": 1}[name]
        want = out[i] if i == 0 else out[i][name]
        want32 = out32[i] if i == 0 else out32[i][name]
        if name != "logits":
            assert tuple(got.shape) == shape
            assert got.dtype == tm.params.embed.dtype
        _close_model(got, want, want32, dtype, name)
    # one step from JAX's own cache, grown by one slot
    jcache = jax.tree_util.tree_map(
        lambda a: np.pad(np.asarray(a), [(0, 0)] * 3 + [(0, 1), (0, 0)]),
        out[1])
    tcache = convert.cache_from_jax(cfg, jcache, device="cpu")
    before = {k: v.clone() for k, v in tcache.items()}
    step, new = tm.decode(tcache, torch.from_numpy(nxt).long(), PROMPT)
    _close_model(step, out[2], out32[2], dtype, "logits")
    for name in ("k", "v"):
        _close_model(new[name], out[3][name], out32[3][name], dtype, name)
        assert torch.equal(tcache[name], before[name])


@pytest.mark.parametrize("arch,tol", [("granite_3_8b", 2e-2),
                                      ("granite_34b", 2e-2),
                                      ("dbrx_132b", 5e-2),
                                      ("kimi_k2_1t_a32b", 5e-2)])
def test_decode_replay_matches_prefill(arch, tol):
    """As tests/test_decode_equivalence.py: stepping decode over the prompt
    from an empty plain cache reproduces the prefill logits (normalised
    log-probs), the moe family at capacity n_experts (no drops, so prefill
    and decode route alike)."""
    cfg = configs.get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    tm = tmodel.build_model(cfg, device="cpu")
    T = 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T)))
    logits_pre, cache_pre = tm.prefill({"tokens": toks})
    cache = tm.init_cache(B, T)
    for t in range(T):
        out, cache = tm.decode(cache, toks[:, t], t)
    a = out - out.max(-1, keepdim=True).values
    b = logits_pre - logits_pre.max(-1, keepdim=True).values
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=10 * tol)
    for name in ("k", "v"):
        assert cache[name].shape == cache_pre[name].shape
        np.testing.assert_allclose(_f32(cache[name]), _f32(cache_pre[name]),
                                   rtol=tol, atol=tol)


def test_serve_driver_serves_the_dense_family_on_the_cpu(capsys):
    cfg = configs.get_smoke_config("granite-3-8b")
    out = tserve.serve(cfg, requests=3, batch=2, prompt_len=16, gen=4,
                       device="cpu")
    assert out["served"] == 4 and out["tokens"] == 16
    assert len(out["waves"]) == 2
    assert all(len(w["first"]) == 4 for w in out["waves"])
    for name in ("k", "v"):
        got = out["cache"][name]
        assert got.shape == (cfg.n_layers, 2, cfg.n_kv_heads, 20, cfg.hd)
        assert torch.isfinite(got.float()).all()
        assert got[:, :, :, :19].abs().sum(-1).gt(0).all()   # written
        assert not got[:, :, :, 19:].any()                   # not yet
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("[serve] served 4 requests, 16 tokens")


def test_serve_main_defaults_to_granite_3_8b(monkeypatch):
    seen = {}

    def fake_serve(cfg, **kw):
        seen["cfg"], seen["kw"] = cfg, kw
    monkeypatch.setattr(tserve, "serve", fake_serve)
    assert tserve.main(["--smoke", "--device", "cpu"]) == 0
    assert seen["cfg"] == configs.get_smoke_config("granite-3-8b")
    assert seen["kw"]["device"] == "cpu"


def test_moe_specs_match_jax():
    for arch in MOE_ARCHS:
        for get in ("get_config", "get_smoke_config"):
            cfg = getattr(configs, get)(arch)
            jcfg = getattr(jconfigs, get)(arch)
            got = params.tree_leaves(moe.moe_specs(cfg))
            want = jax.tree_util.tree_leaves(
                jmoe.moe_specs(jcfg), is_leaf=lambda s: hasattr(s, "names"))
            assert [(s.shape, s.names, s.init, s.scale) for s in got] == \
                [(s.shape, s.names, s.init, s.scale) for s in want], arch
            assert [str(s.dtype).split(".")[-1] for s in got] == \
                [np.dtype(s.dtype).name for s in want]


def test_an_fp64_tree_computes_in_fp64():
    """Parameters carried at fp64 (the oracle ``chip_smoke.py`` holds the
    card's fp32 prefill to) run every layer at fp64: the norms, RoPE and
    attention compute at promote(dtype, fp32), fp32 for bf16 and fp32."""
    cfg = dataclasses.replace(configs.get_smoke_config("granite_3_8b"),
                              dtype="float32")
    tm = tmodel.build_model(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, PROMPT)))
    p64 = params.tree_map(lambda t: t.double(), tm.params.tree())
    with torch.no_grad():
        got, _ = tmodel.prefill_fn(p64, {"tokens": toks}, SCTX, cfg)
        want, _ = tm.prefill({"tokens": toks})
    assert got.dtype == torch.float64 and want.dtype == torch.float32
    _close_model(torch.log_softmax(want.double(), -1),
                 torch.log_softmax(got, -1), None, "float32", "log-probs")
    x = torch.randn(2, 5, 4, 32, dtype=torch.float64)
    for dtype, acc in ((torch.bfloat16, torch.float32),
                       (torch.float32, torch.float32),
                       (torch.float64, torch.float64)):
        assert layers._acc(dtype) == acc
        xd = x.to(dtype)
        assert layers.rope(xd, torch.arange(5), 1e4).dtype == dtype
        assert layers.flash_attention(xd, xd, xd).dtype == dtype
    # at fp64 RoPE is the rotation itself, to fp64 rounding
    r = layers.rope(x, torch.arange(5), 1e4)
    assert torch.allclose(r.norm(dim=-1), x.norm(dim=-1), rtol=1e-13)
