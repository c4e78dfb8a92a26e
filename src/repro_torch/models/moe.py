"""Token-choice top-k Mixture-of-Experts with expert parallelism.

Counterpart of ``repro.models.moe``, plain torch.  Dispatch is sort-based
(a stable argsort by expert id, then capacity clipping) rather than a
(T, E, C) one-hot einsum: with E = 384 (kimi-k2) the one-hot tensor would
not fit.  The same tokens are dropped as in JAX: the capacity is
``ceil(capacity_factor · T · k / E)`` rows an expert, and a token past it
goes to the drop row ``E · cap``, whose output is zero.

Both scatters are deterministic on the card.  Dispatch writes each kept
row exactly once (``index_add_`` onto zeros; the drop row only gathers
zeros).  Combine sums a token's k weighted rows in the order JAX's
scatter applies them, by expert id, one add after another, rather than
through ``index_add_``, whose atomics sum in a different order from run
to run.
"""

from __future__ import annotations

import math

import torch

from repro_torch.sharding import ShardingCtx
from .config import ArchConfig
from .layers import _acc, _dt, _silu
from .params import ParamSpec


def moe_specs(cfg: ArchConfig) -> dict:
    E, D, F = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    dt = _dt(cfg)
    specs = {
        "router": ParamSpec((D, E), ("embed", None), torch.float32,
                            scale=1.0 / math.sqrt(D)),
        "wi": ParamSpec((E, D, F), ("experts", "embed", "expert_mlp"), dt),
        "wg": ParamSpec((E, D, F), ("experts", "embed", "expert_mlp"), dt),
        "wo": ParamSpec((E, F, D), ("experts", "expert_mlp", "embed"), dt,
                        scale=1.0 / math.sqrt(F)),
    }
    if cfg.shared_expert:
        specs["shared"] = {
            "wi": ParamSpec((D, F), ("embed", "mlp"), dt),
            "wg": ParamSpec((D, F), ("embed", "mlp"), dt),
            "wo": ParamSpec((F, D), ("mlp", "embed"), dt,
                            scale=1.0 / math.sqrt(F)),
        }
    return specs


def _capacity(cfg: ArchConfig, tokens: int) -> int:
    return max(math.ceil(cfg.capacity_factor * tokens * cfg.top_k
                         / cfg.n_experts), 1)


def _dispatch(xt, topw, topi, E: int, k: int, cap: int):
    """Sort-based dispatch: tokens -> (E, cap, D) buffer + routing state
    ``(slot, tok_s, w_s)``, each (T·k,) in expert order.  All indexing is
    local to ``xt``'s token set (T, D)."""
    T, D = xt.shape
    eid = topi.reshape(-1)                                   # (T*k,)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    tok_s = order // k
    w_s = topw.reshape(-1)[order]

    counts = torch.bincount(eid, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=xt.device) - starts[eid_s]
    keep = pos_in_e < cap
    slot = torch.where(keep, eid_s * cap + pos_in_e, E * cap)  # E*cap = drop

    rows = xt[tok_s] * keep[:, None].to(xt.dtype)
    buf = torch.zeros((E * cap + 1, D), dtype=xt.dtype,
                      device=xt.device).index_add(0, slot, rows)
    return buf[: E * cap].reshape(E, cap, D), (slot, tok_s, w_s)


def _combine(out_e, routing, T: int):
    """Weighted gather of expert outputs back to token order: token t's k
    rows summed in expert order (the order of t's entries in the sorted
    routing), one add after another."""
    slot, tok_s, w_s = routing
    D = out_e.shape[-1]
    E_cap = out_e.shape[0] * out_e.shape[1]
    out_flat = torch.cat([out_e.reshape(E_cap, D),
                          out_e.new_zeros((1, D))], dim=0)
    gathered = out_flat[slot] * w_s[:, None].to(out_e.dtype)  # (T*k, D)
    k = slot.shape[0] // T
    # each token's sorted positions, ascending: its rows in expert order
    where = torch.argsort(tok_s, stable=True).reshape(T, k)
    out = gathered[where[:, 0]]
    for j in range(1, k):
        out = out + gathered[where[:, j]]
    return out


def moe_apply(p, x: torch.Tensor, sctx: ShardingCtx, cfg: ArchConfig):
    """x: (B, S, D) -> (out, aux_losses).

    Dispatch modes (``cfg.moe_dispatch``), as JAX's:
      * "global" — one sorted dispatch over all tokens;
      * "local"  — one dispatch per data shard (DP = ``pod`` × ``data`` of
        the mesh; capacity per shard), the shards' (E, cap, D) buffers
        merged into one (E, DP·cap, D) expert buffer;
      * "local2" — "local" with the merged buffer also laid out over the
        data axes along its capacity.
    """
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)

    acc = _acc(xt.dtype)
    logits = xt.to(acc) @ p["router"].to(acc)                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)                        # (T, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    eid = topi.reshape(-1)

    def expert_ffn(hidden):
        hidden = sctx.constrain(hidden, ("act_experts", None, None))
        h = torch.einsum("ecd,edf->ecf", hidden, p["wi"])
        g = torch.einsum("ecd,edf->ecf", hidden, p["wg"])
        act = _silu(g) * h
        out_e = torch.einsum("ecf,efd->ecd", act, p["wo"])
        return sctx.constrain(out_e, ("act_experts", None, None))

    mode = cfg.moe_dispatch
    if mode in ("local", "local2"):
        sizes = sctx.mesh.axis_sizes
        DP = sizes.get("pod", 1) * sizes.get("data", 1)
        if T % DP != 0 or T // DP < 1:
            DP = 1
        Tl = T // DP
        cap = _capacity(cfg, Tl)

        xs = sctx.constrain(xt.reshape(DP, Tl, D), ("act_batch", None, None))
        ws = topw.reshape(DP, Tl, k)
        ids = topi.reshape(DP, Tl, k)
        # 1) per-shard dispatch (indices stay shard-local)
        shards = [_dispatch(xs[i], ws[i], ids[i], E, k, cap)
                  for i in range(DP)]
        bufs = torch.stack([buf for buf, _ in shards])
        # 2) one layout change: (DP, E, cap, D) -> (E, DP * cap, D)
        merged = torch.movedim(bufs, 0, 1).reshape(E, DP * cap, D)
        if mode == "local2":
            merged = sctx.constrain(merged, ("act_experts", "act_batch", None))
        out_e = expert_ffn(merged)
        out_e = torch.movedim(out_e.reshape(E, DP, cap, D), 1, 0)
        out_e = sctx.constrain(out_e, ("act_batch", None, None, None))
        # 3) per-shard combine
        out = torch.stack([_combine(out_e[i], shards[i][1], Tl)
                           for i in range(DP)]).reshape(B, S, D)
    else:
        hidden, routing = _dispatch(xt, topw, topi, E, k, _capacity(cfg, T))
        out = _combine(expert_ffn(hidden), routing, T).reshape(B, S, D)

    if cfg.shared_expert:
        sh = p["shared"]
        hs = _silu(torch.einsum("bsd,df->bsf", x, sh["wg"])) \
            * torch.einsum("bsd,df->bsf", x, sh["wi"])
        out = out + torch.einsum("bsf,fd->bsd", hs, sh["wo"])

    # ---- aux losses (load balance + router z) -----------------------------
    me = probs.mean(dim=0)                                    # (E,)
    ce = torch.bincount(eid, minlength=E).to(acc) / (T * k)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out, {"lb_loss": lb_loss, "router_z": z_loss}
