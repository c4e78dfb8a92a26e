"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Counterpart of ``repro.models.rglru``:

    r_t = sigmoid(x_t W_a),  i_t = sigmoid(x_t W_i)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The sequence scan is ``repro_torch.core.recurrence.linear_recurrence``
with per-token gates: on a CUDA tensor the hand-written recurrence kernel,
on a CPU tensor its plain version.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.recurrence import linear_recurrence
from repro_torch.sharding import ShardingCtx
from .config import ArchConfig
from .layers import _dt
from .params import ParamSpec
from .ssm import _causal_conv, _conv_step

RG_C = 8.0


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the exact form)."""
    return F.gelu(x, approximate="tanh")


def rglru_specs(cfg: ArchConfig) -> dict:
    D, R, W = cfg.d_model, cfg.rnn_dim, cfg.conv_width
    dt = _dt(cfg)
    return {
        "in_x": ParamSpec((D, R), ("embed", "mlp"), dt),
        "in_gate": ParamSpec((D, R), ("embed", "mlp"), dt),
        "conv": ParamSpec((W, R), ("conv", "mlp"), dt),
        "w_a": ParamSpec((R, R), (None, "mlp"), dt, scale=1.0 / math.sqrt(R)),
        "w_i": ParamSpec((R, R), (None, "mlp"), dt, scale=1.0 / math.sqrt(R)),
        "lam": ParamSpec((R,), (None,), torch.float32, init="zeros"),
        "out": ParamSpec((R, D), ("mlp", "embed"), dt, scale=1.0 / math.sqrt(R)),
    }


def _gates(p, xr):
    """xr: (..., R) post-conv branch input -> (a, gated_input), fp32."""
    f32 = torch.float32
    r = torch.sigmoid(torch.einsum("...r,rq->...q", xr, p["w_a"]).to(f32))
    i = torch.sigmoid(torch.einsum("...r,rq->...q", xr, p["w_i"]).to(f32))
    log_a = -RG_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i * xr.to(f32)


def rglru_apply(p, x, sctx: ShardingCtx, cfg: ArchConfig):
    """x: (B, S, D) -> (out, (h_last, conv_tail))."""
    W = cfg.conv_width
    xr = torch.einsum("bsd,dr->bsr", x, p["in_x"])
    gate = _gelu(torch.einsum("bsd,dr->bsr", x, p["in_gate"]))
    conv_tail = xr[:, -(W - 1):]
    xr = _causal_conv(xr, p["conv"])

    a, q = _gates(p, xr)                                     # (B, S, R) fp32
    a_t = torch.movedim(a, 1, 0)                             # (S, B, R)
    q_t = torch.movedim(q, 1, 0)
    h = linear_recurrence(a_t, q_t, method="auto")           # (S, B, R) fp32
    h = torch.movedim(h, 0, 1).to(x.dtype)                   # (B, S, R)

    out = torch.einsum("bsr,rd->bsd", h * gate, p["out"])
    out = sctx.constrain(out, ("act_batch", "act_res_seq", None))
    return out, (h[:, -1].to(torch.float32), conv_tail)


def rglru_decode_step(p, x_t, h_prev, conv_buf, cfg: ArchConfig):
    """x_t: (B, D); h_prev: (B, R) fp32; conv_buf: (B, W-1, R)."""
    xr = x_t @ p["in_x"]
    gate = _gelu(x_t @ p["in_gate"])
    xr, buf = _conv_step(conv_buf, xr, p["conv"])
    a, q = _gates(p, xr)
    h = a * h_prev + q                                       # (B, R) fp32
    out = (h.to(x_t.dtype) * gate) @ p["out"]
    return out, h, buf
