"""Model assembly: the serving path of the ssm family (mamba2-130m).

Counterpart of ``repro.models.model`` for the families ported so far:

  ssm    — Mamba-2 SSD stack, attention-free (mamba2-130m).

``param_specs``, ``cache_specs``, ``init_cache``, ``prefill_fn`` and
``decode_fn`` are plain functions on nested dicts of tensors, under the JAX
names.  The layer stack is a loop over parameters stacked along a leading
``layers`` axis (JAX's ``lax.scan``).  ``Model`` is the ``nn.Module`` that
holds the parameters on one device and serves ``prefill`` / ``decode``;
``build_model`` makes one.  The other families (dense, moe, hybrid,
encdec, vlm) raise ``NotImplementedError`` naming the ROADMAP item that
brings them; training (``loss_fn``) comes with the training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import ShardingCtx
from repro_torch.solver.system import resolve_device
from .config import ArchConfig
from .layers import rmsnorm
from .params import ParamSpec, check_tree, init_params, tree_map
from .ssm import _dt, ssm_apply, ssm_decode_step, ssm_specs

# where each unported family comes from (ROADMAP.md, Queue 1)
_UNPORTED = {
    "hybrid": "Queue 1 item 1 (attention, RoPE, ring-window KV cache, MLP "
              "and the transformer block)",
    "dense": "Queue 1 item 2 (the rest of the model families)",
    "moe": "Queue 1 item 2 (the rest of the model families)",
    "encdec": "Queue 1 item 2 (the rest of the model families)",
    "vlm": "Queue 1 item 2 (the rest of the model families)",
}


def _unported(family: str) -> Exception:
    if family in _UNPORTED:
        return NotImplementedError(
            f"family {family!r} is not ported yet: ROADMAP.md "
            f"{_UNPORTED[family]}")
    return ValueError(family)


def stack_specs(tree, n: int):
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.names,
                                        s.dtype, s.init, s.scale), tree)


# ===========================================================================
# parameter and cache spec trees
# ===========================================================================

def _embed_specs(cfg: ArchConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab
    dt = _dt(cfg)
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed"), dt,
                           scale=1.0 / math.sqrt(D)),
        "ln_f": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "unembed": ParamSpec((D, V), ("embed", "vocab"), dt),
    }


def _ssm_layer_specs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    return {
        "ln": ParamSpec((D,), (None,), torch.float32, init="zeros"),
        "ssm": ssm_specs(cfg),
    }


def param_specs(cfg: ArchConfig) -> dict:
    if cfg.family != "ssm":
        raise _unported(cfg.family)
    specs = _embed_specs(cfg)
    specs["blocks"] = stack_specs(_ssm_layer_specs(cfg), cfg.n_layers)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Decode-time state.  ``seq`` sizes the sequence axes (named
    ``act_kv_seq``) of the families that have one; the ssm state has none."""
    if cfg.family != "ssm":
        raise _unported(cfg.family)
    L, H, P, N = cfg.n_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W, di, dt = cfg.conv_width, cfg.d_inner, _dt(cfg)
    return {
        "state": ParamSpec((L, batch, H, P, N),
                           ("layers", "act_batch", None, None, None),
                           torch.float32, init="zeros"),
        "conv_x": ParamSpec((L, batch, W - 1, di),
                            ("layers", "act_batch", None, "act_mlp"), dt,
                            init="zeros"),
        "conv_B": ParamSpec((L, batch, W - 1, N),
                            ("layers", "act_batch", None, None), dt,
                            init="zeros"),
        "conv_C": ParamSpec((L, batch, W - 1, N),
                            ("layers", "act_batch", None, None), dt,
                            init="zeros"),
    }


def init_cache(cfg: ArchConfig, batch: int, seq: int, *, device) -> dict:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_specs(cfg, batch, seq))


# ===========================================================================
# shared pieces
# ===========================================================================

def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of parameters stacked along a leading ``layers`` axis."""
    return tree_map(lambda t: t[i], stacked)


def _embed_tokens(params, tokens, sctx: ShardingCtx, cfg: ArchConfig):
    x = F.embedding(tokens, params["embed"])
    return sctx.constrain(x, ("act_batch", "act_res_seq", None))


def _logits_1tok(params, x, sctx: ShardingCtx, cfg: ArchConfig):
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = (x @ params["unembed"]).to(torch.float32)
    return sctx.constrain(logits, ("act_batch", "act_vocab"))


# ===========================================================================
# prefill and decode
# ===========================================================================

def prefill_fn(params, batch, sctx: ShardingCtx, cfg: ArchConfig):
    """Process a full prompt; return (last-token logits, decode cache)."""
    if cfg.family != "ssm":
        raise _unported(cfg.family)
    x = _embed_tokens(params, batch["tokens"], sctx, cfg)
    outs = {"state": [], "conv_x": [], "conv_B": [], "conv_C": []}
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        h, state, tails = ssm_apply(p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps),
                                    sctx, cfg)
        x = x + h
        for key, value in (("state", state), ("conv_x", tails["x"]),
                           ("conv_B", tails["B"]), ("conv_C", tails["C"])):
            outs[key].append(value)
    cache = {k: torch.stack(v) for k, v in outs.items()}
    return _logits_1tok(params, x[:, -1], sctx, cfg), cache


def decode_fn(params, cache, token, pos, sctx: ShardingCtx, cfg: ArchConfig):
    """token: (B,) integer; pos: the token's position (the ssm family keeps
    no positions).  Returns (logits, new cache); ``cache`` is not
    modified."""
    if cfg.family != "ssm":
        raise _unported(cfg.family)
    x = F.embedding(token, params["embed"])
    x = sctx.constrain(x, ("act_batch", None))
    new_cache = {k: torch.empty_like(v) for k, v in cache.items()}
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        h, state, bufs = ssm_decode_step(
            p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps), cache["state"][i],
            {"x": cache["conv_x"][i], "B": cache["conv_B"][i],
             "C": cache["conv_C"][i]}, cfg)
        x = x + h
        for key, value in (("state", state), ("conv_x", bufs["x"]),
                           ("conv_B", bufs["B"]), ("conv_C", bufs["C"])):
            new_cache[key][i] = value
    return _logits_1tok(params, x, sctx, cfg), new_cache


# ===========================================================================
# the module
# ===========================================================================

class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: sub-dicts become child
    modules, tensors parameters, under the same keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        out.update({k: m.tree() for k, m in self.named_children()})
        return out


class Model(nn.Module):
    """One architecture's parameters on one device, served by ``prefill``
    and ``decode``.

    ``device`` defaults to the CUDA device and raises without one; pass
    ``device="cpu"`` for a CPU run.  ``params`` (a nested dict of tensors
    matching ``param_specs(cfg)``, e.g. from ``repro_torch.convert``) are
    moved there; without them the parameters are drawn by
    ``init_params`` from a generator seeded with ``seed``."""

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        specs = param_specs(cfg)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init_params(specs, gen, device=device)
        else:
            check_tree(specs, params)
            params = tree_map(lambda t: t.to(device), params)
        self.cfg = cfg
        self.sctx = ShardingCtx.local()
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params.embed.device

    def cache_specs(self, batch: int, seq: int) -> dict:
        return cache_specs(self.cfg, batch, seq)

    def init_cache(self, batch: int, seq: int) -> dict:
        return init_cache(self.cfg, batch, seq, device=self.device)

    @torch.inference_mode()
    def prefill(self, batch: dict):
        """batch: ``{"tokens": (B, S) integer}`` -> (logits (B, V) fp32,
        cache)."""
        return prefill_fn(self.params.tree(), batch, self.sctx, self.cfg)

    @torch.inference_mode()
    def decode(self, cache: dict, token: torch.Tensor, pos: int):
        return decode_fn(self.params.tree(), cache, token, pos, self.sctx,
                         self.cfg)


def build_model(cfg: ArchConfig, *, device=None, seed: int = 0) -> Model:
    return Model(cfg, device=device, seed=seed)
