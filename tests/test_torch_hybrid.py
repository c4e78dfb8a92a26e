"""The port's hybrid family (recurrentgemma-9b): RoPE, blockwise and decode
attention over a ring-window KV cache, the MLP, the transformer block and
the model's prefill / decode, against the JAX package at the smoke config
(5 layers: one (rec, rec, attn) group plus a tail of 2 rec layers, window
32, rnn_width 128).

The same numpy inputs, made from a seed, go through JAX and the port; JAX
parameters and caches are carried across by ``repro_torch.convert``.
JAX's ``method="auto"`` reaches the Pallas recurrence kernel in interpret
mode on the CPU; the port's reaches the kernel's plain version on CPU
tensors.  The bars are ``tests/test_torch_models.py``'s: fp32 rtol 1e-4 /
atol 1e-5, bf16 rtol = atol = 3e-2, and for decode against prefill the bar
of ``tests/test_decode_equivalence.py`` (normalised log-probs, rtol 3e-2,
atol 3e-1).  The fp32 atol is taken of the tensor's scale (max |JAX value|,
at least 1): JAX's fan-in rule draws ``wk`` (embed, kv = 1, head_dim) at
scale 1, so attention logits reach about 300 and a block's output 40, and
JAX's own fp32 block is 2.8e-4 from an fp64 run of it (the port's 1.8e-4).

Layers, block and model are held at fp32 and bf16.  The bf16 model is held
as ``tests/test_torch_models.py`` holds the mamba model: the port's error
from JAX's fp32 run of the same weights at most twice JAX's bf16 error.
That rule holds up to the attention layer's output; past it those logits
make either package's error chaotic, so the tail's leaves and the logits
are held to shape, dtype and finite values there, and ``python
tests/test_torch_hybrid.py`` prints the ratios over six weight seeds.
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
from repro.models import transformer as jtransformer
from repro.sharding import LogicalRules as JaxRules
from repro.sharding import ShardingCtx as JaxCtx
from repro_torch import configs, convert
from repro_torch.launch import serve as tserve
from repro_torch.models import layers, model as tmodel, transformer
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding import ShardingCtx

ARCH = "recurrentgemma_9b"
DTYPES = ("float32", "bfloat16")
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
LOGIT_BAR = dict(rtol=3e-2, atol=3e-1)
SCTX = ShardingCtx.local()


def _jctx():
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return JaxCtx(mesh=jax.sharding.Mesh(devs, ("data", "model")),
                  rules=JaxRules.default())


def _cfg(dtype: str, **over):
    return (dataclasses.replace(configs.get_smoke_config(ARCH), dtype=dtype,
                                **over),
            dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=dtype,
                                **over))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(rng, shape, dtype: str, scale: float = 0.3):
    """The same values for both packages: (jnp array, torch tensor)."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype: str, what: str = ""):
    want = np.asarray(want, np.float32)
    tol = dict(TOL[dtype])
    if dtype == "float32":
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               err_msg=what, **tol)


def _normed(logits) -> np.ndarray:
    a = np.asarray(logits, np.float32)
    return a - a.max(-1, keepdims=True)


def _layer_params(spec_fn, jcfg, key: int):
    p = jparams.init_params(spec_fn(jcfg), jax.random.PRNGKey(key))
    return p, convert.tree_from_jax(_np(p), device="cpu")


def _ring_slot_pos(pos: int, Wn: int) -> np.ndarray:
    """The absolute position in each of ``Wn`` ring slots after token
    ``pos`` was written (JAX's ``decode_fn``): ``pos + 1`` where no token
    has been written yet."""
    held = pos - ((pos - np.arange(Wn)) % Wn)
    return np.where(held >= 0, held, pos + 1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _inputs(rng, (2, 37, 4, 32), dtype, scale=1.0)
    pos = np.arange(1990, 2027)          # positions around the chip's prompt
    got = layers.rope(tx, torch.from_numpy(pos), 10000.0)
    assert got.dtype == tx.dtype
    _close(got, jlayers.rope(jx, jnp.asarray(pos), 10000.0), dtype)
    # decode's form: one position broadcast over (B, 1, H, D)
    one = layers.rope(tx[:, :1], torch.arange(77, 78), 10000.0)
    _close(one, jlayers.rope(jx[:, :1], jnp.asarray(77)[None], 10000.0),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,H,KV,window,chunk", [
    (48, 4, 2, 20, 16),      # window under S, 3 x 3 tiles
    (45, 4, 1, 0, 16),       # S odd: _pick_chunk takes 15
    (45, 4, 2, 32, 16),      # the smoke window, odd chunks
    (40, 4, 4, 0, 16),       # one kv head a head, causal mask only
], ids=("window", "odd_chunk_mqa", "odd_chunk_window", "mha"))
def test_flash_attention(S, H, KV, window, chunk, dtype):
    assert layers._pick_chunk(S, chunk) == jlayers._pick_chunk(S, chunk)
    assert layers._pick_chunk(1984, 1024) == 992
    rng = np.random.default_rng(2)
    jq, tq = _inputs(rng, (2, S, H, 32), dtype, scale=1.0)
    jk, tk = _inputs(rng, (2, S, KV, 32), dtype, scale=1.0)
    jv, tv = _inputs(rng, (2, S, KV, 32), dtype, scale=1.0)
    kw = dict(window=window, q_chunk=chunk, kv_chunk=chunk)
    got = layers.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jlayers.flash_attention(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", (13, 5), ids=("wrapped", "part_written"))
def test_decode_attention_on_a_ring(pos, dtype):
    """A ring of 8 slots: after token 13 it has wrapped (slot 5 holds 13,
    slot 6 holds 6); after token 5 slots 6 and 7 are unwritten and
    masked."""
    cfg, jcfg = _cfg(dtype)
    jp, tp = _layer_params(jlayers.attention_specs, jcfg, 3)
    rng = np.random.default_rng(3)
    B, Wn = 2, 8
    jx, tx = _inputs(rng, (B, cfg.d_model), dtype)
    jk, tk = _inputs(rng, (B, cfg.n_kv_heads, Wn, cfg.hd), dtype, scale=1.0)
    jv, tv = _inputs(rng, (B, cfg.n_kv_heads, Wn, cfg.hd), dtype, scale=1.0)
    slot_pos = _ring_slot_pos(pos, Wn)
    assert slot_pos[pos % Wn] == pos
    want = jlayers.decode_attention(jp, jx, jk, jv, pos, _jctx(), jcfg,
                                    slot_pos=jnp.asarray(slot_pos))
    got = layers.decode_attention(tp, tx, tk, tv, pos, SCTX, cfg,
                                  slot_pos=torch.from_numpy(slot_pos))
    _close(got, want, dtype)
    # a ring not yet wrapped: slot s holds position s (JAX's default)
    _close(layers.decode_attention(tp, tx, tk, tv, 6, SCTX, cfg,
                                   slot_pos=torch.arange(Wn)),
           jlayers.decode_attention(jp, jx, jk, jv, 6, _jctx(), jcfg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cache_write(dtype):
    rng = np.random.default_rng(4)
    jc, tc = _inputs(rng, (2, 1, 8, 32), dtype, scale=1.0)
    jn, tn = _inputs(rng, (2, 1, 32), dtype, scale=1.0)
    before = tc.clone()
    for slot in (0, 5, 7):
        got = layers.cache_write(tc, tn, slot)
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jlayers.cache_write(jc, jn, slot), np.float32))
    assert torch.equal(tc, before)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    cfg, jcfg = _cfg(dtype)
    jp, tp = _layer_params(jlayers.mlp_specs, jcfg, 5)
    rng = np.random.default_rng(5)
    jx, tx = _inputs(rng, (2, 7, cfg.d_model), dtype)
    _close(layers.mlp_apply(tp, tx, SCTX), jlayers.mlp_apply(jp, jx, _jctx()),
           dtype)
    _close(layers.mlp_apply_1tok(tp, tx[:, 0], SCTX),
           jlayers.mlp_apply_1tok(jp, jx[:, 0], _jctx()), dtype)


# ---------------------------------------------------------------------------
# the transformer block
# ---------------------------------------------------------------------------

def _block_case(dtype):
    cfg, jcfg = _cfg(dtype)
    jp, tp = _layer_params(jtransformer.block_specs, jcfg, 6)
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", (24, 45), ids=("under_window", "over_window"))
def test_block_apply_and_prefill_kv(S, dtype):
    cfg, jcfg, jp, tp = _block_case(dtype)
    rng = np.random.default_rng(6)
    jx, tx = _inputs(rng, (2, S, cfg.d_model), dtype)
    pos = np.arange(S)
    jy, _ = jtransformer.block_apply(jp, jx, _jctx(), jcfg,
                                     positions=jnp.asarray(pos), causal=True,
                                     window=cfg.window)
    ty, aux = transformer.block_apply(tp, tx, SCTX, cfg,
                                      positions=torch.from_numpy(pos),
                                      window=cfg.window)
    assert aux == {}
    _close(ty, jy, dtype, "block out")
    jk, jv = jtransformer.block_prefill_kv(jp, jx, jcfg, jnp.asarray(pos))
    tk, tv = transformer.block_prefill_kv(tp, tx, cfg, torch.from_numpy(pos))
    assert tk.shape == (2, cfg.n_kv_heads, S, cfg.hd)
    _close(tk, jk, dtype, "k")
    _close(tv, jv, dtype, "v")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", (13, 5), ids=("wrapped", "part_written"))
def test_block_decode(pos, dtype):
    cfg, jcfg, jp, tp = _block_case(dtype)
    rng = np.random.default_rng(7)
    B, Wn = 2, 8
    jx, tx = _inputs(rng, (B, cfg.d_model), dtype)
    jk, tk = _inputs(rng, (B, cfg.n_kv_heads, Wn, cfg.hd), dtype, scale=1.0)
    jv, tv = _inputs(rng, (B, cfg.n_kv_heads, Wn, cfg.hd), dtype, scale=1.0)
    slot_pos = _ring_slot_pos(pos, Wn)
    before = (tk.clone(), tv.clone())
    jy, jk2, jv2 = jtransformer.block_decode(
        jp, jx, jk, jv, pos, _jctx(), jcfg, slot=pos % Wn,
        slot_pos=jnp.asarray(slot_pos))
    ty, tk2, tv2 = transformer.block_decode(
        tp, tx, tk, tv, pos, SCTX, cfg, slot=pos % Wn,
        slot_pos=torch.from_numpy(slot_pos))
    _close(ty, jy, dtype, "block out")
    _close(tk2, jk2, dtype, "k")
    _close(tv2, jv2, dtype, "v")
    assert torch.equal(tk, before[0]) and torch.equal(tv, before[1])


def test_moe_block_specs_match_jax():
    """The MoE block is ported: its spec tree is JAX's (the numbers are in
    tests/test_torch_moe.py)."""
    for arch in ("dbrx_132b", "kimi_k2_1t_a32b"):
        cfg = configs.get_smoke_config(arch)
        jcfg = jconfigs.get_smoke_config(arch)
        got = tree_leaves(transformer.block_specs(cfg, moe=True))
        want = jax.tree_util.tree_leaves(
            jtransformer.block_specs(jcfg, moe=True),
            is_leaf=lambda s: hasattr(s, "names"))
        assert [(s.shape, s.names, s.init, s.scale) for s in got] == \
            [(s.shape, s.names, s.init, s.scale) for s in want], arch


def _cross_case(dtype, key: int, kind: str = "cross"):
    """A block of ``kind`` with its gates (if any) set nonzero in JAX's
    weights before they are converted, a (B, 12, D) input and a (B, 20, D)
    memory."""
    cfg, jcfg = _cfg(dtype)
    jp = _np(jparams.init_params(jtransformer.block_specs(jcfg, kind=kind),
                                 jax.random.PRNGKey(key)))
    for name, value in (("gate_attn", 0.7), ("gate_mlp", -0.4)):
        if name in jp:
            jp[name] = np.full_like(jp[name], value)
    rng = np.random.default_rng(key)
    jx, tx = _inputs(rng, (2, 12, cfg.d_model), dtype)
    jm, tm = _inputs(rng, (2, 20, cfg.d_model), dtype)
    return cfg, jcfg, jp, convert.tree_from_jax(jp, device="cpu"), \
        (jx, tx), (jm, tm)


@pytest.mark.parametrize("kw", (dict(kind="cross"),), ids=("cross",))
def test_unported_blocks_name_their_roadmap_item(kw):
    """The gated cross-attention block, once refused here, is ported: its
    spec tree is JAX's (the two fp32 (1,) gates, zeros at init), and with
    the gates set nonzero ``block_apply`` over a memory matches JAX's."""
    cfg = configs.get_smoke_config(ARCH)
    jcfg = jconfigs.get_smoke_config(ARCH)
    got = transformer.block_specs(cfg, **kw)
    want = jtransformer.block_specs(jcfg, **kw)
    assert sorted(got) == sorted(want)
    assert [(s.shape, s.names, s.init, s.scale) for s in tree_leaves(got)] \
        == [(s.shape, s.names, s.init, s.scale) for s in
            jax.tree_util.tree_leaves(want,
                                      is_leaf=lambda s: hasattr(s, "names"))]
    assert got["gate_attn"].dtype == torch.float32
    cfg, jcfg, jp, tp, (jx, tx), (jm, tm) = _cross_case("float32", 11)
    pos = np.arange(12)
    jy, _ = jtransformer.block_apply(jp, jx, _jctx(), jcfg,
                                     positions=jnp.asarray(pos), kv_input=jm,
                                     use_rope=False, **kw)
    ty, aux = transformer.block_apply(tp, tx, SCTX, cfg,
                                      positions=torch.from_numpy(pos),
                                      kv_input=tm, use_rope=False, **kw)
    assert aux == {}
    _close(ty, jy, "float32", "cross block out")


@pytest.mark.parametrize("fn,kw", [
    ("block_apply", dict(kv_input=True)),
    ("block_apply", dict(use_rope=False)),
    ("block_prefill_kv", dict(kv_input=True)),
    ("block_decode", dict(write=False)),
    ("block_decode", dict(use_rope=False))],
    ids=("apply-kv_input", "apply-no_rope", "prefill_kv-kv_input",
         "decode-no_write", "decode-no_rope"))
def test_cross_attention_options_name_their_roadmap_item(fn, kw):
    """JAX's cross-attention options, once refused here, match JAX's
    functions at fp32 on a gated cross block (gates 0.7, -0.4): K/V from
    the memory ``kv_input`` (unrotated, every key seen), attention without
    RoPE, and a decode step that reads a memory cache without writing it
    (or writes the token's K unrotated)."""
    cfg, jcfg, jp, tp, (jx, tx), (jm, tm) = _cross_case("float32", 12)
    pos = np.arange(12)
    jkw, tkw = ((dict(kv_input=jm), dict(kv_input=tm)) if "kv_input" in kw
                else (kw, kw))
    if fn == "block_apply":
        jy, _ = jtransformer.block_apply(jp, jx, _jctx(), jcfg,
                                         positions=jnp.asarray(pos),
                                         kind="cross", **jkw)
        ty, _ = transformer.block_apply(tp, tx, SCTX, cfg,
                                        positions=torch.from_numpy(pos),
                                        kind="cross", **tkw)
        return _close(ty, jy, "float32", f"{fn} {sorted(kw)}")
    if fn == "block_prefill_kv":
        want = jtransformer.block_prefill_kv(jp, jx, jcfg, jnp.asarray(pos),
                                             **jkw)
        got = transformer.block_prefill_kv(tp, tx, cfg,
                                           torch.from_numpy(pos), **tkw)
        assert tuple(got[0].shape) == (2, cfg.n_kv_heads, 20, cfg.hd)
        for g, w, what in zip(got, want, ("k", "v")):
            _close(g, w, "float32", what)
        return
    # one token at position 9 against a 20-slot cache: the memory's slots
    # all labelled 0 (write=False), or a plain cache written at 9
    rng = np.random.default_rng(13)
    jx1, tx1 = _inputs(rng, (2, cfg.d_model), "float32")
    jk, tk = _inputs(rng, (2, cfg.n_kv_heads, 20, cfg.hd), "float32", 1.0)
    jv, tv = _inputs(rng, (2, cfg.n_kv_heads, 20, cfg.hd), "float32", 1.0)
    slot_pos = np.zeros(20, np.int32) if not kw.get("write", True) else \
        np.arange(20)
    before = (tk.clone(), tv.clone())
    jy, jk2, jv2 = jtransformer.block_decode(
        jp, jx1, jk, jv, 9, _jctx(), jcfg, slot_pos=jnp.asarray(slot_pos),
        **kw)
    ty, tk2, tv2 = transformer.block_decode(
        tp, tx1, tk, tv, 9, SCTX, cfg,
        slot_pos=torch.from_numpy(slot_pos).long(), **kw)
    _close(ty, jy, "float32", f"{fn} {sorted(kw)} out")
    _close(tk2, jk2, "float32", "k")
    _close(tv2, jv2, "float32", "v")
    if not kw.get("write", True):
        assert tk2 is tk and tv2 is tv
    assert torch.equal(tk, before[0]) and torch.equal(tv, before[1])


# ---------------------------------------------------------------------------
# the model: prefill, decode, the ring's wrap, serving
# ---------------------------------------------------------------------------

def _models(dtype: str, key: int):
    cfg, jcfg = _cfg(dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(key))
    return cfg, jcfg, jm, jp, convert.model_from_jax(cfg, _np(jp),
                                                     device="cpu")


def _f32_twin(jcfg, jp):
    """JAX's fp32 model and parameters of the same (bf16) weights."""
    jm32 = jax_build_model(dataclasses.replace(jcfg, dtype="float32"))
    return jm32, _f32(jp)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _tokens(cfg, B: int, S: int, seed: int):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


def _close_leaf(got, want, want32, dtype: str, what: str):
    """The fp32 bar, or at bf16 (as ``tests/test_torch_models.py`` holds the
    mamba model) the port no further from JAX's fp32 run of the same
    weights than twice JAX's bf16 run is."""
    if dtype == "float32":
        return _close(got, want, dtype, what)
    ref = np.asarray(want32, np.float32)
    err = np.abs(got.detach().float().numpy() - ref).max()
    err_jax = np.abs(np.asarray(want, np.float32) - ref).max()
    assert err <= 2 * err_jax, (what, err, err_jax)


def _close_model(tlogits, tcache, jlogits, jcache, jlogits32, jcache32,
                 dtype: str):
    """Logits and every cache leaf: the fp32 bar, or at bf16 the rule of
    ``_close_leaf`` for the leaves the attention layer's output does not
    reach (the group's two RG-LRU layers and the ring's K and V).  Past
    that layer, one bf16 ulp moves an attention score by about 1 and the
    error of either package from the fp32 run is chaotic: over 6 weight
    seeds at S 20 and 40 the port's max error from it is 0.36-3.94 times
    JAX's in the tail's leaves and 0.77-3.58 in the logits (``PERF.md``
    §6), so there they are held to their shape, dtype and finite values."""
    assert tlogits.dtype == torch.float32
    assert tlogits.shape == jlogits.shape
    if dtype == "float32":
        _close(tlogits, jlogits, dtype, "logits")
    else:
        assert torch.isfinite(tlogits).all()
    for part in ("groups", "tail"):
        g, w = tree_leaves(tcache[part]), jax.tree_util.tree_leaves(jcache[part])
        w32 = jax.tree_util.tree_leaves(jcache32[part])
        assert len(g) == len(w) == len(w32)
        for i, (a, b, b32) in enumerate(zip(g, w, w32)):
            what = f"cache {part} leaf {i}"
            assert tuple(a.shape) == b.shape, (what, a.shape, b.shape)
            assert a.dtype == getattr(torch, str(b.dtype)), (what, a.dtype)
            if dtype == "float32" or part == "groups":
                _close_leaf(a, b, b32, dtype, what)
            else:
                assert torch.isfinite(a).all(), what


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", (20, 40), ids=("under_window", "over_window"))
def test_model_prefill_logits_and_cache(S, dtype):
    cfg, jcfg, jm, jp, tm = _models(dtype, 0)
    jt, tt = _tokens(cfg, 2, S, 9)
    jlogits, jcache = jm.prefill(jp, {"tokens": jt}, _jctx())
    jm32, jp32 = _f32_twin(jcfg, jp)
    jlogits32, jcache32 = jm32.prefill(jp32, {"tokens": jt}, _jctx())
    tlogits, tcache = tm.prefill({"tokens": tt})
    ring = tcache["groups"]["l2_attn"]["k"]
    assert ring.shape == (1, 2, cfg.n_kv_heads, min(cfg.window, S), cfg.hd)
    assert tcache["tail"]["h"].shape == (2, 2, cfg.rnn_dim)
    _close_model(tlogits, tcache, jlogits, jcache, jlogits32, jcache32, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_decode_from_a_converted_cache(dtype):
    """JAX's prefill of 40 tokens leaves a wrapped ring of 32 slots; both
    packages decode token 40 from it."""
    cfg, jcfg, jm, jp, tm = _models(dtype, 1)
    B, S = 2, 40
    jt, _ = _tokens(cfg, B, S, 10)
    _, jcache = jm.prefill(jp, {"tokens": jt}, _jctx())
    tcache = convert.cache_from_jax(cfg, _np(jcache), device="cpu")
    kept = tree_map(torch.clone, tcache)
    jtok, ttok = _tokens(cfg, 1, B, 11)
    jlogits, jnew = jm.decode(jp, jcache, jtok[0], jnp.int32(S), _jctx())
    jm32, jp32 = _f32_twin(jcfg, jp)
    jlogits32, jnew32 = jm32.decode(jp32, _f32(jcache), jtok[0],
                                    jnp.int32(S), _jctx())
    tlogits, tnew = tm.decode(tcache, ttok[0], S)
    _close_model(tlogits, tnew, jlogits, jnew, jlogits32, jnew32, dtype)
    # decode returns a new cache and leaves its input as it was
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tcache),
                                                 tree_leaves(kept)))


def test_cache_from_jax_checks_the_ring_and_the_batch():
    cfg, _, jm, jp, _ = _models("float32", 0)
    jt, _ = _tokens(cfg, 3, 12, 12)
    _, jcache = jm.prefill(jp, {"tokens": jt}, _jctx())
    cache = _np(jcache)
    got = convert.cache_from_jax(cfg, cache, device="cpu")
    assert got["groups"]["l2_attn"]["v"].shape == (1, 3, 1, 12, cfg.hd)
    assert got["tail"]["conv"].dtype == torch.float32
    cache["groups"]["l2_attn"]["v"] = cache["groups"]["l2_attn"]["v"][:, :, :, :11]
    with pytest.raises(ValueError, match="l2_attn/v"):
        convert.cache_from_jax(cfg, cache, device="cpu")


def test_decode_replay_matches_prefill():
    """As tests/test_decode_equivalence.py for recurrentgemma_9b: stepping
    decode over the prompt from an empty cache reproduces the prefill
    logits (normalised log-probs)."""
    cfg = configs.get_smoke_config(ARCH)
    tm = tmodel.build_model(cfg, device="cpu")
    B, T = 2, 12
    _, toks = _tokens(cfg, B, T, 0)
    logits_pre, cache_pre = tm.prefill({"tokens": toks})
    cache = tm.init_cache(B, T)
    for t in range(T):
        out, cache = tm.decode(cache, toks[:, t], t)
    np.testing.assert_allclose(_normed(out), _normed(logits_pre), **LOGIT_BAR)
    assert [a.shape for a in tree_leaves(cache)] == \
        [a.shape for a in tree_leaves(cache_pre)]


@pytest.mark.parametrize("S,T", ((20, 50), (40, 56)))
def test_continuation_across_the_ring_wrap(S, T):
    """fp32: prefill S tokens, grow the ring to min(window, T) slots, then
    decode teacher-forced to T, past the ring's wrap at 32.  Every step
    against the port's prefill of the same prefix, the last also against
    JAX's prefill of all T tokens."""
    cfg, _, jm, jp, tm = _models("float32", 2)
    B = 2
    jt, toks = _tokens(cfg, B, T, 13)
    logits, cache = tm.prefill({"tokens": toks[:, :S]})
    cache = tserve.pad_cache(cache, tm.cache_specs(B, T), T, cfg.window)
    assert cache["groups"]["l2_attn"]["k"].shape[3] == cfg.window
    worst = 0.0
    for t in range(S, T):
        want, _ = tm.prefill({"tokens": toks[:, :t]})
        np.testing.assert_allclose(_normed(logits), _normed(want),
                                   err_msg=f"prefix {t}", **LOGIT_BAR)
        worst = max(worst, np.abs(_normed(logits) - _normed(want)).max())
        logits, cache = tm.decode(cache, toks[:, t], t)
    jlogits, _ = jm.prefill(jp, {"tokens": jt}, _jctx())
    np.testing.assert_allclose(_normed(logits), _normed(jlogits),
                               err_msg="JAX prefill of all T", **LOGIT_BAR)
    # far inside the bar: a ring grown past the window, or relabelled
    # after its wrap, misses it by 2.7-3.8 (ROADMAP Queue 3 item 10)
    assert worst < 1e-3, worst


def test_serve_driver_runs_the_hybrid_family_on_the_cpu(capsys):
    """A prompt past the window (the prefill's ring has wrapped) and one
    under it with max_len past it (the ring grows to the window, then
    wraps while decoding)."""
    cfg = configs.get_smoke_config(ARCH)
    for prompt, gen in ((40, 4), (20, 20)):
        out = tserve.serve(cfg, requests=3, batch=2, prompt_len=prompt,
                           gen=gen, device="cpu")
        assert out["served"] == 4 and out["tokens"] == 2 * 2 * gen
        assert all(len(w["first"]) == min(gen, 10) for w in out["waves"])
        groups = out["cache"]["groups"]
        assert groups["l2_attn"]["k"].shape == (1, 2, cfg.n_kv_heads,
                                                cfg.window, cfg.hd)
        assert groups["l0_rec"]["h"].shape == (1, 2, cfg.rnn_dim)
        assert torch.isfinite(out["cache"]["tail"]["h"]).all()
    assert tserve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device",
                        "cpu", "--requests", "1", "--batch", "1",
                        "--prompt-len", "36", "--gen", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("[serve] served 1 requests, 3 tokens")


def bf16_reach(keys=range(6), lengths=(20, 40)) -> list:
    """The port's bf16 max error from JAX's fp32 run of the same weights,
    over JAX's bf16 max error, for the logits and each cache leaf."""
    rows = []
    for key in keys:
        cfg, jcfg, jm, jp, tm = _models("bfloat16", key)
        jm32, jp32 = _f32_twin(jcfg, jp)
        for S in lengths:
            jt, tt = _tokens(cfg, 2, S, 9 + key)
            jl, jc = jm.prefill(jp, {"tokens": jt}, _jctx())
            jl32, jc32 = jm32.prefill(jp32, {"tokens": jt}, _jctx())
            tl, tc = tm.prefill({"tokens": tt})
            got = [_normed(tl)] + [a.float().numpy() for a in tree_leaves(tc)]
            want = [_normed(jl)] + jax.tree_util.tree_leaves(jc)
            want32 = [_normed(jl32)] + jax.tree_util.tree_leaves(jc32)
            ratios = []
            for a, b, b32 in zip(got, want, want32):
                ref = np.asarray(b32, np.float32)
                ratios.append(float(np.abs(a - ref).max()
                                    / np.abs(np.asarray(b, np.float32) - ref).max()))
            rows.append((key, S, ratios))
    return rows


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_hybrid.py
    print("key S  logits " + " ".join(
        f"{p}/{n}" for p in ("l0", "l1") for n in ("conv", "h"))
        + " attn/k attn/v tail/conv tail/h")
    for key, S, ratios in bf16_reach():
        print(key, S, " ".join(f"{r:.2f}" for r in ratios))
