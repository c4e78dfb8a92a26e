"""The port's serving path of the ssm family, and its RG-LRU layer, against
the JAX package at the smoke configs.

The same numpy inputs, made from a seed, go through JAX and the port; JAX
parameters (``init_params(..., jax.random.PRNGKey(k))``) and caches are
carried across by ``repro_torch.convert``.  JAX's ``method="auto"`` reaches
the Pallas recurrence kernel in interpret mode on the CPU; the port's
reaches the recurrence kernel's plain version on CPU tensors.  Each check
runs at fp32 (``dtype="float32"``) within rtol 1e-4 / atol 1e-5, and at the
config's bf16 within 3e-2, the JAX suite's bar: rtol = atol = 3e-2 for
layer outputs and states (``tests/test_recurrence.py``), and for logits
the bar of ``tests/test_decode_equivalence.py`` (normalised log-probs,
rtol 3e-2, atol 3e-1).  A model's cache leaves at bf16 are held to JAX's
fp32 run of the same weights: the port's error there at most twice JAX's
own bf16 error.  Each package rounds every bf16 step its own way (XLA's
CPU backend rounds each step of its sigmoid to bf16), and a few layers
deep the two bf16 runs differ by more than 3e-2 elementwise, as JAX's bf16
run differs from its own fp32 run.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.sharding import LogicalRules as JaxRules
from repro.sharding import ShardingCtx as JaxCtx
from repro_torch import configs, convert
from repro_torch.launch import serve as tserve
from repro_torch.models import layers, model as tmodel, params, rglru, ssm
from repro_torch.sharding import ShardingCtx

DTYPES = ("float32", "bfloat16")
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SCTX = ShardingCtx.local()


def _jctx():
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return JaxCtx(mesh=jax.sharding.Mesh(devs, ("data", "model")),
                  rules=JaxRules.default())


def _cfg(arch: str, dtype: str):
    return (dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(rng, shape, dtype: str, scale: float = 0.3):
    """The same values for both packages: (jnp array, torch tensor)."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype: str, what: str = ""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL[dtype])


def _close_logits(got, want, dtype: str):
    if dtype == "float32":
        return _close(got, want, dtype, "logits")
    a = got.float().numpy()
    b = np.asarray(want, np.float32)
    np.testing.assert_allclose(a - a.max(-1, keepdims=True),
                               b - b.max(-1, keepdims=True), rtol=3e-2,
                               atol=3e-1, err_msg="normalised logits")


def _layer_params(spec_fn, jcfg, key: int):
    p = jparams.init_params(spec_fn(jcfg), jax.random.PRNGKey(key))
    return p, convert.tree_from_jax(_np(p), device="cpu")


# ---------------------------------------------------------------------------
# configs and parameter specs
# ---------------------------------------------------------------------------

def test_configs_are_the_reference_configs():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.SHAPES == jconfigs.SHAPES
    for arch in configs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            got = getattr(configs, get)(arch)
            want = getattr(jconfigs, get)(arch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        for shape in configs.SHAPES:
            assert configs.shape_applicable(configs.get_config(arch), shape) \
                == jconfigs.shape_applicable(jconfigs.get_config(arch), shape)


@pytest.mark.parametrize("smoke", (True, False))
def test_param_and_cache_specs_match_jax(smoke):
    get = "get_smoke_config" if smoke else "get_config"
    cfg = getattr(configs, get)("mamba2-130m")
    jcfg = getattr(jconfigs, get)("mamba2-130m")
    jm = jax_build_model(jcfg)
    for got, want in ((tmodel.param_specs(cfg), jm.param_specs()),
                      (tmodel.cache_specs(cfg, 3, 7), jm.cache_specs(3, 7))):
        g = params.tree_leaves(got)
        w = jax.tree_util.tree_leaves(want, is_leaf=lambda s: hasattr(s, "names"))
        assert [(s.shape, s.names, s.init, s.scale) for s in g] == \
            [(s.shape, s.names, s.init, s.scale) for s in w]
        assert [str(s.dtype).split(".")[-1] for s in g] == \
            [np.dtype(s.dtype).name for s in w]
    assert params.tree_size(tmodel.param_specs(cfg)) == \
        jparams.tree_size(jm.param_specs())


def test_init_params_follows_the_jax_rule():
    spec = {"w": params.ParamSpec((64, 4096), ("embed", "mlp"),
                                  torch.float32),
            "s": params.ParamSpec((8, 4096), (None, None), torch.float32,
                                  scale=0.5),
            "z": params.ParamSpec((5,), (None,), torch.bfloat16, init="zeros"),
            "o": params.ParamSpec((5,), (None,), torch.float32, init="ones")}
    gen = torch.Generator().manual_seed(3)
    p = params.init_params(spec, gen, device="cpu")
    assert p["z"].dtype == torch.bfloat16 and not p["z"].any()
    assert bool((p["o"] == 1).all())
    # scale * N(0, 1): std 1/sqrt(fan_in = shape[-2]), or the spec's scale
    assert abs(p["w"].std().item() * 8.0 - 1.0) < 0.02
    assert abs(p["s"].std().item() / 0.5 - 1.0) < 0.03
    again = params.init_params(spec, torch.Generator().manual_seed(3),
                               device="cpu")
    assert torch.equal(p["w"], again["w"])


@pytest.mark.parametrize("arch", ("granite_34b", "dbrx_132b",
                                  "recurrentgemma_9b", "seamless_m4t_large_v2",
                                  "llama_3_2_vision_90b"))
def test_unported_families_name_their_roadmap_item(arch):
    cfg = configs.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        tmodel.build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        tmodel.cache_specs(cfg, 1, 8)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _inputs(rng, (3, 5, 128), dtype, scale=2.0)
    w = rng.normal(size=(128,)).astype(np.float32) * 0.1
    got = layers.rmsnorm(torch.from_numpy(w), tx, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, jlayers.rmsnorm(jnp.asarray(w), jx, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_and_conv_step(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _inputs(rng, (2, 11, 48), dtype)
    jw, tw = _inputs(rng, (4, 48), dtype, scale=0.5)
    _close(ssm._causal_conv(tx, tw), jssm._causal_conv(jx, jw), dtype)
    jb, tb = _inputs(rng, (2, 3, 48), dtype)
    jy, jbuf = jssm._conv_step(jb, jx[:, 0], jw)
    ty, tbuf = ssm._conv_step(tb, tx[:, 0], tw)
    _close(ty, jy, dtype)
    _close(tbuf, jbuf, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq", (48, 10), ids=("3_chunks", "under_a_chunk"))
def test_ssd_chunked(seq, dtype):
    B, H, P, N, chunk = 2, 3, 8, 16, 16
    rng = np.random.default_rng(3)
    jxh, txh = _inputs(rng, (B, seq, H, P), dtype, scale=1.0)
    dt = np.log1p(np.exp(rng.normal(size=(B, seq, H)))).astype(np.float32)
    a_log = (rng.normal(size=(H,)) * 0.5).astype(np.float32)
    jB, tB = _inputs(rng, (B, seq, N), dtype, scale=1.0)
    jC, tC = _inputs(rng, (B, seq, N), dtype, scale=1.0)
    jy, jstate = jssm.ssd_chunked(jxh, jnp.asarray(dt), jnp.asarray(a_log),
                                  jB, jC, chunk)
    ty, tstate = ssm.ssd_chunked(txh, torch.from_numpy(dt),
                                 torch.from_numpy(a_log), tB, tC, chunk)
    assert ty.dtype == txh.dtype and tstate.shape == (B, H, P, N)
    _close(ty, jy, dtype, "y")
    _close(tstate, jstate, dtype, "state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_apply(dtype):
    cfg, jcfg = _cfg("mamba2_130m", dtype)
    jp, tp = _layer_params(jssm.ssm_specs, jcfg, 1)
    rng = np.random.default_rng(4)
    jx, tx = _inputs(rng, (2, 3 * cfg.ssm_chunk, cfg.d_model), dtype)
    jout, jstate, jtails = jssm.ssm_apply(jp, jx, _jctx(), jcfg)
    tout, tstate, ttails = ssm.ssm_apply(tp, tx, SCTX, cfg)
    _close(tout, jout, dtype, "out")
    _close(tstate, jstate, dtype, "state")
    for k in ("x", "B", "C"):
        assert ttails[k].shape == (2, cfg.conv_width - 1, tp[f"conv_{k}"].shape[1])
        _close(ttails[k], jtails[k], dtype, f"conv tail {k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_step(dtype):
    cfg, jcfg = _cfg("mamba2_130m", dtype)
    jp, tp = _layer_params(jssm.ssm_specs, jcfg, 2)
    rng = np.random.default_rng(5)
    B, W = 2, cfg.conv_width
    jx, tx = _inputs(rng, (B, cfg.d_model), dtype)
    state = rng.normal(size=(B, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)).astype(np.float32)
    bufs = {k: _inputs(rng, (B, W - 1, n), dtype)
            for k, n in (("x", cfg.d_inner), ("B", cfg.ssm_state),
                         ("C", cfg.ssm_state))}
    jout, jst, jb = jssm.ssm_decode_step(
        jp, jx, jnp.asarray(state), {k: v[0] for k, v in bufs.items()}, jcfg)
    tout, tst, tb = ssm.ssm_decode_step(
        tp, tx, torch.from_numpy(state), {k: v[1] for k, v in bufs.items()},
        cfg)
    _close(tout, jout, dtype, "out")
    _close(tst, jst, dtype, "state")
    for k in bufs:
        _close(tb[k], jb[k], dtype, f"conv buffer {k}")


def _rglru_case(dtype, gate_scale: float = 1.0):
    cfg, jcfg = _cfg("recurrentgemma_9b", dtype)
    jp = jparams.init_params(jrglru.rglru_specs(jcfg), jax.random.PRNGKey(3))
    jp = dict(jp, in_gate=(jp["in_gate"].astype(jnp.float32)
                           * gate_scale).astype(jp["in_gate"].dtype))
    return cfg, jcfg, jp, convert.tree_from_jax(_np(jp), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_apply(dtype):
    cfg, jcfg, jp, tp = _rglru_case(dtype)
    rng = np.random.default_rng(6)
    jx, tx = _inputs(rng, (2, 9, cfg.d_model), dtype)
    jout, (jh, jtail) = jrglru.rglru_apply(jp, jx, _jctx(), jcfg)
    tout, (th, ttail) = rglru.rglru_apply(tp, tx, SCTX, cfg)
    _close(tout, jout, dtype, "out")
    assert th.dtype == torch.float32
    _close(th, jh, dtype, "h_last")
    _close(ttail, jtail, dtype, "conv tail")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_step(dtype):
    cfg, jcfg, jp, tp = _rglru_case(dtype)
    rng = np.random.default_rng(7)
    B, R, W = 2, cfg.rnn_dim, cfg.conv_width
    jx, tx = _inputs(rng, (B, cfg.d_model), dtype)
    h = rng.normal(size=(B, R)).astype(np.float32)
    jb, tb = _inputs(rng, (B, W - 1, R), dtype)
    jout, jh, jbuf = jrglru.rglru_decode_step(jp, jx, jnp.asarray(h), jb, jcfg)
    tout, th, tbuf = rglru.rglru_decode_step(tp, tx, torch.from_numpy(h), tb,
                                             cfg)
    _close(tout, jout, dtype, "out")
    _close(th, jh, dtype, "h")
    _close(tbuf, jbuf, dtype, "conv buffer")


def test_rglru_gelu_is_the_tanh_form(monkeypatch):
    """The fp32 parity of the RG-LRU layer fails with torch's exact GELU:
    gates of a few units apart make the two forms differ past the bar."""
    cfg, jcfg, jp, tp = _rglru_case("float32", gate_scale=30.0)
    rng = np.random.default_rng(8)
    jx, tx = _inputs(rng, (2, 9, cfg.d_model), "float32")
    jout, _ = jrglru.rglru_apply(jp, jx, _jctx(), jcfg)
    _close(rglru.rglru_apply(tp, tx, SCTX, cfg)[0], jout, "float32")
    exact = torch.nn.functional.gelu
    monkeypatch.setattr(rglru, "_gelu", exact)
    with pytest.raises(AssertionError):
        _close(rglru.rglru_apply(tp, tx, SCTX, cfg)[0], jout, "float32")


# ---------------------------------------------------------------------------
# the model: prefill, decode, replay, serving
# ---------------------------------------------------------------------------

def _models(dtype: str, key: int = 0):
    cfg, jcfg = _cfg("mamba2_130m", dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(key))
    return cfg, jcfg, jm, jp, convert.model_from_jax(cfg, _np(jp),
                                                     device="cpu")


def _f32_twin(jcfg, jp):
    """JAX's fp32 model and parameters of the same (bf16) weights."""
    jm32 = jax_build_model(dataclasses.replace(jcfg, dtype="float32"))
    return jm32, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)


def _close_leaf(got, want, want32, dtype: str, what: str):
    """A model's cache leaf: the fp32 bar, or at bf16 the port no further
    from JAX's fp32 run than twice JAX's bf16 run is."""
    if dtype == "float32":
        return _close(got, want, dtype, what)
    ref = np.asarray(want32, np.float32)
    err = np.abs(got.float().numpy() - ref).max()
    err_jax = np.abs(np.asarray(want, np.float32) - ref).max()
    assert err <= 2 * err_jax, (what, err, err_jax)


def _tokens(cfg, B: int, S: int, seed: int):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_prefill_logits_and_cache(dtype):
    cfg, jcfg, jm, jp, tm = _models(dtype)
    jt, tt = _tokens(cfg, 2, 2 * cfg.ssm_chunk, 9)
    jlogits, jcache = jm.prefill(jp, {"tokens": jt}, _jctx())
    jm32, jp32 = _f32_twin(jcfg, jp)
    _, jcache32 = jm32.prefill(jp32, {"tokens": jt}, _jctx())
    tlogits, tcache = tm.prefill({"tokens": tt})
    assert tlogits.dtype == torch.float32
    _close_logits(tlogits, jlogits, dtype)
    assert set(tcache) == set(jcache)
    for k in jcache:
        assert tcache[k].dtype == convert.tree_from_jax(
            {k: np.asarray(jcache[k])}, device="cpu")[k].dtype
        _close_leaf(tcache[k], jcache[k], jcache32[k], dtype, f"cache {k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_decode_from_a_converted_cache(dtype):
    cfg, jcfg, jm, jp, tm = _models(dtype, key=1)
    B = 2
    jt, _ = _tokens(cfg, B, cfg.ssm_chunk, 10)
    _, jcache = jm.prefill(jp, {"tokens": jt}, _jctx())
    tcache = convert.cache_from_jax(cfg, _np(jcache), device="cpu")
    jtok, ttok = _tokens(cfg, 1, B, 11)
    jlogits, jnew = jm.decode(jp, jcache, jtok[0], jnp.int32(cfg.ssm_chunk),
                              _jctx())
    jm32, jp32 = _f32_twin(jcfg, jp)
    _, jnew32 = jm32.decode(
        jp32, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jcache),
        jtok[0], jnp.int32(cfg.ssm_chunk), _jctx())
    tlogits, tnew = tm.decode(tcache, ttok[0], cfg.ssm_chunk)
    _close_logits(tlogits, jlogits, dtype)
    for k in jnew:
        _close_leaf(tnew[k], jnew[k], jnew32[k], dtype, f"cache {k}")
    # decode returns a new cache and leaves its input as it was
    for k in jcache:
        assert torch.equal(tcache[k], convert.tree_from_jax(
            {k: np.asarray(jcache[k])}, device="cpu")[k]), k


def test_decode_replay_matches_prefill():
    """As tests/test_decode_equivalence.py for mamba2_130m: stepping decode
    over the prompt reproduces the prefill logits (normalised log-probs)."""
    cfg = configs.get_smoke_config("mamba2-130m")
    tm = tmodel.build_model(cfg, device="cpu")
    B, T = 2, 12
    _, toks = _tokens(cfg, B, T, 0)
    logits_pre, cache_pre = tm.prefill({"tokens": toks})
    cache = tm.init_cache(B, T)
    for t in range(T):
        out, cache = tm.decode(cache, toks[:, t], t)
    a = out - out.max(-1, keepdim=True).values
    b = logits_pre - logits_pre.max(-1, keepdim=True).values
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-2, atol=3e-1)
    assert {k: v.shape for k, v in cache.items()} == \
        {k: v.shape for k, v in cache_pre.items()}


def test_serve_driver_at_the_smoke_config_on_the_cpu(capsys):
    """--prompt-len 32 equals the smoke config's ssm_head_dim: the decode
    state keeps its (L, B, H, P, N) shape (no axis is padded as if it
    were the prompt's)."""
    cfg = configs.get_smoke_config("mamba2-130m")
    assert cfg.ssm_head_dim == 32
    out = tserve.serve(cfg, requests=3, batch=2, prompt_len=32, gen=4,
                       device="cpu")
    assert out["served"] == 4 and out["tokens"] == 16
    assert len(out["waves"]) == 2
    assert all(len(w["first"]) == 4 for w in out["waves"])
    L, H, P, N = cfg.n_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert out["cache"]["state"].shape == (L, 2, H, P, N)
    assert out["cache"]["conv_x"].shape == (L, 2, cfg.conv_width - 1,
                                            cfg.d_inner)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] wave done: batch 2")
    assert lines[-1].startswith("[serve] served 4 requests, 16 tokens")


def test_serve_main_parses_the_reference_flags(capsys):
    assert tserve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                        "--requests", "1", "--batch", "1", "--prompt-len",
                        "16", "--gen", "2", "--max-len", "40",
                        "--seed", "1"]) == 0
    assert "[serve] served 1 requests, 2 tokens" in capsys.readouterr().out


def test_pad_cache_grows_only_sequence_axes():
    spec = {"k": params.ParamSpec((2, 3, 1, 5, 4), (
        "layers", "act_batch", "act_kv", "act_kv_seq", "act_head_dim")),
        "state": params.ParamSpec((2, 3, 5, 5), ("layers", "act_batch",
                                                 None, None))}
    cache = {"k": torch.ones(2, 3, 1, 5, 4), "state": torch.ones(2, 3, 5, 5)}
    grown = tserve.pad_cache(cache, spec, 9)
    assert grown["k"].shape == (2, 3, 1, 9, 4)
    assert torch.equal(grown["k"][:, :, :, :5], cache["k"])
    assert not grown["k"][:, :, :, 5:].any()
    assert grown["state"] is cache["state"]
