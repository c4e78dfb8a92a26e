"""Mamba-2 (SSD — state-space duality) layer, chunked.

Counterpart of ``repro.models.ssm``.  The inter-chunk state recurrence runs
on ``repro_torch.core.recurrence.linear_recurrence(method="auto")``: on a
CUDA tensor the hand-written kernel ``kernels/csrc/recurrence_sweep.cu``
(counted as ``recur1`` in ``kernels.ops.LAUNCHES``), on a CPU tensor its
plain version.

Per head h with state (P, N):  h_t = exp(a_t) h_{t-1} + dt_t B_t x_t^T,
y_t = C_t . h_t + D x_t, a_t = -exp(A_log) dt_t. Group count G = 1 (B and C
shared across heads), following the mamba2-130m config.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.recurrence import linear_recurrence
from repro_torch.sharding import ShardingCtx
from repro_torch.spans import span
from .config import ArchConfig
from .layers import _dt, _silu, rmsnorm
from .params import ParamSpec


def ssm_specs(cfg: ArchConfig) -> dict:
    D, di, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    w = cfg.conv_width
    dt = _dt(cfg)
    f32 = torch.float32
    return {
        "z_proj": ParamSpec((D, di), ("embed", "mlp"), dt),
        "x_proj": ParamSpec((D, di), ("embed", "mlp"), dt),
        "B_proj": ParamSpec((D, N), ("embed", "state"), dt),
        "C_proj": ParamSpec((D, N), ("embed", "state"), dt),
        "dt_proj": ParamSpec((D, H), ("embed", None), dt),
        "dt_bias": ParamSpec((H,), (None,), f32, init="zeros"),
        "A_log": ParamSpec((H,), (None,), f32, init="zeros"),
        "D_skip": ParamSpec((H,), (None,), f32, init="ones"),
        "conv_x": ParamSpec((w, di), ("conv", "mlp"), dt),
        "conv_B": ParamSpec((w, N), ("conv", "state"), dt),
        "conv_C": ParamSpec((w, N), ("conv", "state"), dt),
        "norm": ParamSpec((di,), (None,), f32, init="zeros"),
        "out_proj": ParamSpec((di, D), ("mlp", "embed"), dt,
                              scale=1.0 / math.sqrt(di)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S. x: (B, S, C); w: (W, C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1]] * w[i][None, None, :]
    return out


def _conv_step(buf: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor):
    """buf: (B, W-1, C) previous inputs; x_t: (B, C). Returns (y_t, new_buf)."""
    full = torch.cat([buf, x_t[:, None]], dim=1)             # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full, w)
    return y, full[:, 1:]


def ssd_chunked(xh, dt, A_log, Bm, Cm, chunk: int):
    """Chunked SSD scan, the span ``ssm.ssd``.

    xh: (B, S, H, P); dt: (B, S, H) post-softplus; Bm, Cm: (B, S, N).
    Returns (y (B, S, H, P), final_state (B, H, P, N)).
    """
    with span("ssm.ssd"):
        return _ssd_chunked(xh, dt, A_log, Bm, Cm, chunk)


def _ssd_chunked(xh, dt, A_log, Bm, Cm, chunk: int):
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q
    f32 = torch.float32

    xf = xh.to(f32)
    a = -torch.exp(A_log)[None, None, :] * dt                # (B, S, H) < 0
    ac = a.reshape(B, nc, Q, H)
    cum = torch.cumsum(ac, dim=2)                            # inclusive
    Xc = xf.reshape(B, nc, Q, H, P)
    dtc = dt.reshape(B, nc, Q, H)
    Bc = Bm.to(f32).reshape(B, nc, Q, N)
    Cc = Cm.to(f32).reshape(B, nc, Q, N)

    # ---- intra-chunk (quadratic within Q) --------------------------------
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)         # (B, nc, Q, Q)
    # clamp BEFORE exp: for masked pairs j > i the difference is positive and
    # exp overflows to inf, and inf * 0 = NaN. Valid pairs are non-positive.
    decay = torch.exp(torch.clamp(
        cum[:, :, :, None, :] - cum[:, :, None, :, :], max=0.0))  # (B,nc,i,j,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    W = torch.where(tri[None, None, :, :, None], decay, 0.0) \
        * (scores[..., None] * dtc[:, :, None, :, :])
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, Xc)

    # ---- chunk states + inter-chunk recurrence (the recurrence kernel) ---
    cum_last = cum[:, :, -1:, :]                             # (B, nc, 1, H)
    wj = torch.exp(cum_last - cum) * dtc                     # (B, nc, Q, H)
    S_c = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, wj, Xc)  # (B, nc, H, P, N)
    p_chunk = torch.exp(cum_last[:, :, 0, :])                # (B, nc, H)

    p_t = torch.movedim(p_chunk, 1, 0)[..., None, None]      # (nc, B, H, 1, 1)
    q_t = torch.movedim(S_c, 1, 0)                           # (nc, B, H, P, N)
    # the per-chunk decay broadcasts to a full gate operand on dispatch
    S_run = linear_recurrence(p_t, q_t, method="auto")       # inclusive prefix
    S_prev = torch.cat([torch.zeros_like(S_run[:1]), S_run[:-1]], dim=0)
    S_prev = torch.movedim(S_prev, 0, 1)                     # (B, nc, H, P, N)

    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, S_prev) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(xh.dtype), S_run[-1]                         # state: (B, H, P, N)


def ssm_apply(p, x, sctx: ShardingCtx, cfg: ArchConfig):
    """Prefill. x: (B, S, D) -> (y, final_ssm_state, conv_tails)."""
    B, S, D = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    W = cfg.conv_width

    z = torch.einsum("bsd,de->bse", x, p["z_proj"])
    xr = torch.einsum("bsd,de->bse", x, p["x_proj"])
    Bm = torch.einsum("bsd,dn->bsn", x, p["B_proj"])
    Cm = torch.einsum("bsd,dn->bsn", x, p["C_proj"])
    dt_arg = torch.einsum("bsd,dh->bsh", x, p["dt_proj"]).to(torch.float32)
    dt = F.softplus(dt_arg + p["dt_bias"][None, None, :])

    # conv tails for decode handoff: the last W-1 *pre-conv* inputs
    conv_tails = {
        "x": xr[:, -(W - 1):],
        "B": Bm[:, -(W - 1):],
        "C": Cm[:, -(W - 1):],
    }

    xr = _silu(_causal_conv(xr, p["conv_x"]))
    Bm = _silu(_causal_conv(Bm, p["conv_B"]))
    Cm = _silu(_causal_conv(Cm, p["conv_C"]))

    xh = xr.reshape(B, S, H, P)
    y, state = ssd_chunked(xh, dt, p["A_log"], Bm, Cm, cfg.ssm_chunk)
    y = y + p["D_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, H * P)
    y = y * _silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return sctx.constrain(out, ("act_batch", "act_res_seq", None)), state, conv_tails


def ssm_decode_step(p, x_t, state, conv_bufs, cfg: ArchConfig):
    """x_t: (B, D); state: (B, H, P, N); conv_bufs dict of (B, W-1, C)."""
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    z = x_t @ p["z_proj"]
    xr = x_t @ p["x_proj"]
    Bm = x_t @ p["B_proj"]
    Cm = x_t @ p["C_proj"]
    dt = F.softplus((x_t @ p["dt_proj"]).to(f32)
                    + p["dt_bias"][None, :])                  # (B, H)

    xr, bx = _conv_step(conv_bufs["x"], xr, p["conv_x"])
    Bm, bB = _conv_step(conv_bufs["B"], Bm, p["conv_B"])
    Cm, bC = _conv_step(conv_bufs["C"], Cm, p["conv_C"])
    xr, Bm, Cm = _silu(xr), _silu(Bm), _silu(Cm)

    xh = xr.reshape(-1, H, P).to(f32)
    a = torch.exp(-torch.exp(p["A_log"])[None, :] * dt)       # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.to(f32), xh)
    state = a[..., None, None] * state + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.to(f32), state)
    y = y + p["D_skip"][None, :, None] * xh
    y = y.reshape(-1, H * P).to(x_t.dtype)
    y = y * _silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = y @ p["out_proj"]
    return out, state, {"x": bx, "B": bB, "C": bC}
