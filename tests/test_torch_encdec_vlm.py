"""The port's encdec family (seamless-m4t-large-v2) and vlm family
(llama-3.2-vision-90b) against the JAX package at the smoke configs: the
cross-attention layers, the models' prefill, decode and replay, the
serving driver's memory caches, ``convert.cache_from_jax`` and
``configs.input_specs``.

The same numpy inputs, made from a seed, go through JAX and the port; JAX
parameters and caches are carried across by ``repro_torch.convert``.  JAX
runs one jit a case.  Every vlm case sets the cross block's gates nonzero
in the numpy weights before they are converted (``_gated``): the init's
zeros make ``tanh(gate)`` remove the cross block entirely.  The frontend
inputs are seeded normals × 0.1, bf16, as ``tests/test_decode_equivalence.py``
draws them.

The bars are ``tests/test_torch_moe.py``'s.  A layer at fp32 within rtol
1e-4 / atol 1e-5.  A model at fp32: max|Δ| <= 1e-3 · max|ref| (logits
normalised).  The smoke models draw ``wq`` with fan-in H = 4, so attention
logits reach ±30 and the softmax is nearly hard; JAX's own fp32 prefill of
seamless-m4t's smoke model is 2.5e-3 from its x64 run, three times the
port's distance from it.  At bf16 the port is no further from JAX's fp32
run than twice JAX's own bf16 run is.  Decode replayed over the prompt
against prefill (normalised log-probs) at
``tests/test_decode_equivalence.py``'s 3e-2 bar.
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
from repro.sharding import LogicalRules as JaxRules
from repro.sharding import ShardingCtx as JaxCtx
from repro_torch import configs, convert
from repro_torch.launch import serve as tserve
from repro_torch.models import layers, model as tmodel
from repro_torch.sharding import ShardingCtx

ARCHS = ("seamless_m4t_large_v2", "llama_3_2_vision_90b")
DTYPES = ("float32", "bfloat16")
TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = 1e-3                        # of max|ref|; see the docstring
GATES = {"gate_attn": 0.8, "gate_mlp": -0.6}
B, PROMPT = 2, 12
SCTX = ShardingCtx.local()


def _jctx():
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return JaxCtx(mesh=jax.sharding.Mesh(devs, ("data", "model")),
                  rules=JaxRules.default())


def _cfgs(arch: str, dtype: str = "float32"):
    return (dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _rel(got, want, what: str, bar: float = MODEL_TOL) -> None:
    """max|Δ| <= bar · max|want|."""
    a, b = _f32(got), _f32(want)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= bar * scale, \
        f"{what}: max|Δ| {err:.3e} > {bar} · {scale:.3e}"


def _normed(logits) -> np.ndarray:
    a = _f32(logits)
    return a - a.max(-1, keepdims=True)


def _gated(params: dict) -> dict:
    """A numpy parameter tree with every cross block's gates set to GATES
    (``gate_attn`` / ``gate_mlp`` leaves anywhere in the tree)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _gated(v)
        elif k in GATES:
            out[k] = np.full_like(np.asarray(v), GATES[k])
        else:
            out[k] = v
    return out


def _gate_model(model):
    """``model`` with its cross blocks' gates set to GATES, in place."""
    with torch.no_grad():
        for name, p in model.params.named_parameters():
            if name.rsplit(".", 1)[-1] in GATES:
                p.fill_(GATES[name.rsplit(".", 1)[-1]])
    return model


def _jax_params(jm, key: int) -> dict:
    return _gated(_np(jm.init(jax.random.PRNGKey(key))))


def _frontend(cfg, batch: int, seed: int) -> dict:
    """The family's frontend input, seeded normals × 0.1, as numpy fp32
    (rounded to bf16 by both packages alike)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": (rng.normal(size=(batch, cfg.n_frames, cfg.d_model))
                           * 0.1).astype(np.float32)}
    return {"img_embed": (rng.normal(size=(batch, cfg.n_img_tokens,
                                           cfg.vision_dim))
                          * 0.1).astype(np.float32)}


def _jax_batch(tokens, frontend: dict) -> dict:
    return {"tokens": jnp.asarray(tokens, jnp.int32),
            **{k: jnp.asarray(v, jnp.bfloat16) for k, v in frontend.items()}}


def _port_batch(tokens, frontend: dict) -> dict:
    return {"tokens": torch.from_numpy(np.asarray(tokens)).long(),
            **{k: torch.from_numpy(v).bfloat16() for k, v in frontend.items()}}


def _grow(tree, memory, slots: int):
    """JAX's serving growth of a prefill cache: every self-attention leaf
    (…, S, hd) grown by ``slots`` zero slots; the memory leaves kept."""
    return {k: v if k in memory else jnp.pad(
        v, [(0, 0)] * (v.ndim - 2) + [(0, slots), (0, 0)])
        for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the attention layers' cross-attention options
# ---------------------------------------------------------------------------

def test_pick_chunk_cuts_the_audio_frames():
    """1536 frames chunk at 768 (not a power of two), as in JAX."""
    assert layers._pick_chunk(1536, 1024) == jlayers._pick_chunk(1536, 1024) \
        == 768


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk,chunk", [(24, 24, 8), (12, 16, 5),
                                          (12, 40, 16)],
                         ids=("encoder", "cross", "cross_chunked"))
def test_flash_attention_without_the_causal_mask(Sq, Sk, chunk, dtype):
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (rng.normal(size=(B, s, h, 32)).astype(np.float32)
               for s, h in ((Sq, 4), (Sk, 2), (Sk, 2)))
    want = jlayers.flash_attention(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
        causal=False, q_chunk=chunk, kv_chunk=chunk)
    got = layers.flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=False, q_chunk=chunk, kv_chunk=chunk)
    assert got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def _attn_case(arch: str, key: int, kv_dim=None):
    cfg, jcfg = _cfgs(arch)
    jp = _np(jparams.init_params(jlayers.attention_specs(jcfg, kv_dim=kv_dim),
                                 jax.random.PRNGKey(key)))
    return cfg, jcfg, jp, convert.tree_from_jax(jp, device="cpu")


@pytest.mark.parametrize("kv_dim", (None, 96), ids=("d_model", "kv_dim"))
def test_attention_apply_cross_matches_jax(kv_dim):
    """Cross-attention prefill: K/V from the raw memory (width ``kv_dim``),
    no RoPE, every key seen; ``attention_specs(kv_dim=)`` is JAX's."""
    cfg, jcfg, jp, tp = _attn_case(ARCHS[1], 3, kv_dim)
    specs = layers.attention_specs(cfg, kv_dim=kv_dim)
    assert {k: s.shape for k, s in specs.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(B, PROMPT, cfg.d_model)) * 0.3).astype(np.float32)
    mem = (rng.normal(size=(B, 16, kv_dim or cfg.d_model))
           * 0.3).astype(np.float32)
    pos = np.arange(PROMPT)
    want = jlayers.attention_apply(jp, jnp.asarray(x), _jctx(), jcfg,
                                   positions=jnp.asarray(pos),
                                   kv_input=jnp.asarray(mem), use_rope=False)
    got = layers.attention_apply(tp, torch.from_numpy(x), SCTX, cfg,
                                 positions=torch.from_numpy(pos),
                                 kv_input=torch.from_numpy(mem),
                                 use_rope=False)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


@pytest.mark.parametrize("pos", (0, 9))
def test_decode_attention_over_a_memory_without_rope(pos):
    """The query unrotated; every memory slot labelled position 0, so all
    are seen at any ``pos``."""
    cfg, jcfg, jp, tp = _attn_case(ARCHS[0], 5)
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(B, cfg.d_model)) * 0.3).astype(np.float32)
    ck, cv = (rng.normal(size=(B, cfg.n_kv_heads, cfg.n_frames, cfg.hd))
              .astype(np.float32) for _ in range(2))
    want = jlayers.decode_attention(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), pos, _jctx(),
        jcfg, slot_pos=jnp.zeros((cfg.n_frames,), jnp.int32), use_rope=False)
    got = layers.decode_attention(
        tp, torch.from_numpy(x), torch.from_numpy(ck), torch.from_numpy(cv),
        pos, SCTX, cfg, slot_pos=torch.zeros(cfg.n_frames, dtype=torch.long),
        use_rope=False)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


# ---------------------------------------------------------------------------
# the models: prefill and decode against JAX
# ---------------------------------------------------------------------------

_JAX_MODEL: dict = {}


def _jax_model(arch: str, dtype: str):
    """JAX's prefill of a PROMPT-token prompt, then one decode step from
    that cache with its self-attention leaves grown by one slot (the
    memory kept), at ``dtype`` and at fp32 on the same weights, in one
    jit: (params, tokens, frontend, next token, (logits, cache, step
    logits, step cache) at ``dtype``, the same at fp32)."""
    key = (arch, dtype)
    if key not in _JAX_MODEL:
        cfg, jcfg = _cfgs(arch, dtype)
        jm = jax_build_model(jcfg)
        jm32 = jax_build_model(dataclasses.replace(jcfg, dtype="float32"))
        jp = _jax_params(jm, 1)
        rng = np.random.default_rng(12)
        toks = rng.integers(0, cfg.vocab, (B, PROMPT))
        nxt = rng.integers(0, cfg.vocab, (B,))
        front = _frontend(cfg, B, 13)
        memory = tmodel.memory_leaves(cfg)
        ctx = _jctx()

        def run_on(jm, jp, batch, nxt):
            logits, cache = jm.prefill(jp, batch, ctx)
            step, new = jm.decode(jp, _grow(cache, memory, 1), nxt,
                                  jnp.int32(PROMPT), ctx)
            return logits, cache, step, new

        @jax.jit
        def run(jp, batch, nxt):
            out = run_on(jm, jp, batch, nxt)
            jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
            return out, run_on(jm32, jp32, batch, nxt)

        out, out32 = run(jp, _jax_batch(toks, front),
                         jnp.asarray(nxt, jnp.int32))
        _JAX_MODEL[key] = (jp, toks, front, nxt, _np(out), _np(out32))
    return _JAX_MODEL[key]


def _close_model(got, want, want32, dtype: str, what: str) -> None:
    """fp32: max|Δ| <= MODEL_TOL · max|ref| (logits normalised); bf16: no
    further from JAX's fp32 run than twice JAX's bf16 run is."""
    a, b, c = _f32(got), _f32(want), _f32(want32)
    if what == "logits":
        a, b, c = _normed(a), _normed(b), _normed(c)
    if dtype == "float32":
        return _rel(a, b, what)
    err, err_jax = np.abs(a - c).max(), np.abs(b - c).max()
    assert err <= 2 * err_jax, (what, err, err_jax)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    cfg, _ = _cfgs(arch, dtype)
    jp, toks, front, nxt, out, out32 = _jax_model(arch, dtype)
    tm = convert.model_from_jax(cfg, jp, device="cpu")
    logits, cache = tm.prefill(_port_batch(toks, front))
    assert logits.dtype == torch.float32
    assert set(cache) == set(out[1])
    _close_model(logits, out[0], out32[0], dtype, "logits")
    for name in cache:
        assert cache[name].dtype == tm.params.embed.dtype, name
        _close_model(cache[name], out[1][name], out32[1][name], dtype, name)
    # one step from JAX's own cache, its self-attention leaves grown
    tcache = convert.cache_from_jax(
        cfg, _np(_grow(out[1], tmodel.memory_leaves(cfg), 1)), device="cpu")
    before = {k: v.clone() for k, v in tcache.items()}
    step, new = tm.decode(tcache, torch.from_numpy(nxt).long(), PROMPT)
    _close_model(step, out[2], out32[2], dtype, "logits")
    for name in new:
        _close_model(new[name], out[3][name], out32[3][name], dtype, name)
        assert torch.equal(tcache[name], before[name]), name
    for name in tmodel.memory_leaves(cfg):      # the memory is only read
        assert torch.equal(new[name], before[name]), name


# ---------------------------------------------------------------------------
# serving: the memory caches keep the frontend's length
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pad_cache_keeps_the_memory_and_decode_matches_jax(arch):
    """``max_len`` 40 is past the smoke configs' 24 frames and 16 image
    tokens: ``pad_cache`` grows the self-attention leaves to 40 and leaves
    the memory at the frontend's length (zero slots there, labelled
    position 0, would pass the decode mask and dilute its softmax).  A
    decode from the padded cache gives the logits JAX's decode gives from
    its prefill cache grown as JAX's driver grows it (the memory
    untouched).  JAX's init puts the smoke model's cross-attention logits
    near 45, where a zero key's weight is exp(-45) and no padding would
    show, so the memory's ``wk`` is scaled by 1e-2 here: a soft
    cross-attention, as a trained model's is, over which a padded slot
    moves the logits by far more than the bar."""
    cfg, jcfg = _cfgs(arch)
    S, max_len = 8, 40
    jm = jax_build_model(jcfg)
    jp = _jax_params(jm, 2)
    cross = (jp["dec_blocks"]["cross_attn"] if cfg.family == "encdec"
             else jp["groups"]["cross"]["attn"])
    cross["wk"] = cross["wk"] * np.float32(1e-2)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab, (B, S))
    nxt = rng.integers(0, cfg.vocab, (B,))
    front = _frontend(cfg, B, 22)
    memory = tmodel.memory_leaves(cfg)
    ctx = _jctx()

    @jax.jit
    def run(jp, batch, nxt):
        _, cache = jm.prefill(jp, batch, ctx)
        step, _ = jm.decode(jp, _grow(cache, memory, max_len - S), nxt,
                            jnp.int32(S), ctx)
        return cache, step

    jcache, jstep = run(jp, _jax_batch(toks, front),
                        jnp.asarray(nxt, jnp.int32))
    tm = convert.model_from_jax(cfg, jp, device="cpu")
    cache = convert.cache_from_jax(cfg, _np(jcache), device="cpu")
    padded = tserve.pad_cache(cache, tm.cache_specs(B, max_len), max_len,
                              cfg.window, memory=memory)
    length = cfg.n_frames if cfg.family == "encdec" else cfg.n_img_tokens
    for name, leaf in padded.items():
        want = length if name in memory else max_len
        assert leaf.shape[-2] == want, (name, tuple(leaf.shape))
        if name in memory:
            assert leaf is cache[name]
    step, _ = tm.decode(padded, torch.from_numpy(nxt).long(), S)
    np.testing.assert_allclose(_normed(step), _normed(jstep), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_serves_the_family_on_the_cpu(arch, capsys):
    """The driver with JAX's zero frontends, ``max_len`` past the memory's
    length: the self-attention caches hold max_len slots, written up to
    the last decoded token; the memory keeps the frontend's length."""
    cfg = configs.get_smoke_config(arch)
    out = tserve.serve(cfg, requests=3, batch=2, prompt_len=8, gen=4,
                       max_len=40, device="cpu")
    assert out["served"] == 4 and out["tokens"] == 16
    assert all(len(w["first"]) == 4 for w in out["waves"])
    cache = out["cache"]
    memory = tmodel.memory_leaves(cfg)
    length = cfg.n_frames if cfg.family == "encdec" else cfg.n_img_tokens
    for name, leaf in cache.items():
        assert torch.isfinite(leaf.float()).all(), name
        assert leaf.shape[-2] == (length if name in memory else 40), name
        if name not in memory:
            assert leaf[..., :11, :].abs().sum(-1).gt(0).all(), name
            assert not leaf[..., 11:, :].any(), name
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("[serve] served 4 requests, 16 tokens")


# ---------------------------------------------------------------------------
# the decode cache carried over from JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,S", [("llama_3_2_vision_90b", 12),
                                    ("llama_3_2_vision_90b", 16),
                                    ("seamless_m4t_large_v2", 12)],
                         ids=("vlm-12", "vlm-n_img_tokens", "encdec-12"))
def test_cache_from_jax_reads_the_text_length(arch, S):
    """The sequence length comes from a self-attention leaf: a vlm cache
    (whose first leaf in sorted order is ``img_k``, 16 image tokens) at a
    text length of 12 or 16, and an encdec one at 12 of its 24 frames,
    convert and pass ``check_tree``."""
    cfg, jcfg = _cfgs(arch)
    jm = jax_build_model(jcfg)
    jp = _jax_params(jm, 3)
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (B, S))
    ctx = _jctx()
    _, jcache = jax.jit(lambda p, b: jm.prefill(p, b, ctx))(
        jp, _jax_batch(toks, _frontend(cfg, B, S)))
    cache = convert.cache_from_jax(cfg, _np(jcache), device="cpu")
    specs = tmodel.cache_specs(cfg, B, S)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: s.shape for k, s in specs.items()}


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_replay_matches_prefill(arch):
    """As tests/test_decode_equivalence.py: stepping decode over the prompt
    from an empty cache holding the prefill's memory reproduces the
    prefill logits (normalised log-probs, rtol 3e-2, atol 3e-1)."""
    cfg = configs.get_smoke_config(arch)
    tm = _gate_model(tmodel.build_model(cfg, device="cpu"))
    T = 12
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, T))
    batch = _port_batch(toks, _frontend(cfg, B, 1))
    logits_pre, cache_pre = tm.prefill(batch)
    cache = tm.init_cache(B, T)
    cache.update({k: cache_pre[k] for k in tmodel.memory_leaves(cfg)})
    for t in range(T):
        out, cache = tm.decode(cache, batch["tokens"][:, t], t)
    np.testing.assert_allclose(_normed(out), _normed(logits_pre), rtol=3e-2,
                               atol=3e-1)
    for name in cache:
        assert cache[name].shape == cache_pre[name].shape, name


# ---------------------------------------------------------------------------
# configs.input_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_jax(arch, shape, monkeypatch):
    """Meta tensors of JAX's keys, shapes and dtypes, with no model built
    (the port's ``Model`` allocates its parameters)."""
    def refuse(*_, **__):
        raise AssertionError("input_specs built a model")
    monkeypatch.setattr(tmodel.Model, "__init__", refuse)
    got = configs.input_specs(configs.get_config(arch), shape)
    want = jconfigs.input_specs(jconfigs.get_config(arch), shape)

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k],
                                                           f"{path}/{k}")]
        return [(path, tree)]
    g, w = flat(got), flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.device.type == "meta", path
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name, path
