"""Plain reference for ``mamba2-130m``: the Mamba-2 (SSD) language model,
its loss and gradients, AdamW, and a prefill, in plain torch at fp32.

The model (Dao and Gu, arXiv:2405.21060), as the cell runs it: the
configuration's file, with the port's gaps that its ``program_gaps``
names (an output head apart from the embedding, no conv bias).  Tokens
embedded (the rows padded as ``pad_vocab_size_multiple`` says); each of
``n_layer`` residual blocks applies RMSNorm (scale 1 + w), then the
Mamba-2 mixer:

    z, x, B, C = h W_z, h W_x, h W_B, h W_C;  dt = softplus(h W_dt + dt_bias)
    x, B, C = silu(causal depthwise conv of width d_conv, no bias)
    per head (state headdim x d_state, one group):
        s_t = exp(-exp(A_log) dt_t) s_{t-1} + dt_t x_t B_t^T,  y_t = s_t C_t
    y = (y + D x) * silu(z);  y = RMSNorm(y) W_out;  residual add

then RMSNorm and the output head; the loss is the mean cross-entropy of
every token's next token, read off the token sequence itself.  The scan
is computed here by chunks (the quadratic form within a chunk, a loop
over chunks for the carried state), which is exact algebra whatever the
chunk; ``CHUNK`` is the reference's.

Matrix products take ``prec``: "float32" (TF32 off, set by the caller),
or "float8" for the control: each operand rounded to float8 e4m3 with a
per-tensor scale (straight through in the backward pass).  Parameters
are stored at the dtype they were given in, as the configuration says:
an AdamW step adds its update cast to that dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CHUNK = 128
F8_MAX = 448.0


def _round(x, prec):
    if prec == "float32":
        return x
    scale = (x.detach().abs().amax() / F8_MAX).clamp(min=1e-30)
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def mm(x, w, prec):
    return _round(x, prec) @ _round(w, prec)


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def silu(x):
    return x * torch.sigmoid(x)


def causal_conv(x, w):
    """x (B, S, C), w (W, C): out_t = sum_k w_k x_{t - W + 1 + k}."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[:, k:k + s] * w[k] for k in range(width))


def ssd(x, dt, a, bm, cm, q=CHUNK):
    """x (B, S, H, P), dt (B, S, H), a = exp(A_log) (H,), bm, cm (B, S, N)
    -> y (B, S, H, P) and the last state (B, H, P, N)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(q, s)
    nc = s // q
    cs = (-a * dt).view(b, nc, q, h).cumsum(2)               # log decay
    xd = (x * dt[..., None]).view(b, nc, q, h, p)
    bc, cc = bm.view(b, nc, q, n), cm.view(b, nc, q, n)
    lower = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                  device=x.device))[None, None, :, :, None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]        # (b,c,i,j,h)
    decay = torch.where(lower, diff, -math.inf).exp()
    w = decay * torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xd)
    tail = (cs[:, :, -1:, :] - cs).exp()                      # (b,c,q,h)
    ends = torch.einsum("bcjhp,bcjn->bchpn", xd * tail[..., None], bc)
    carry = cs[:, :, -1, :].exp()                             # (b,c,h)
    state = x.new_zeros((b, h, p, n))
    before = []
    for c in range(nc):
        before.append(state)
        state = carry[:, c, :, None, None] * state + ends[:, c]
    y = y + torch.einsum("bcin,bchpn->bcihp", cc, torch.stack(before, 1)) \
        * cs.exp()[..., None]
    return y.reshape(b, s, h, p), state


def layer(x, p, cfg, prec):
    """One residual block; x (B, S, D) fp32.  Returns (x, last state)."""
    eps, hp = cfg["norm_epsilon"], cfg["headdim"]
    m = p["ssm"]
    u = rmsnorm(x, p["ln"], eps)
    z = mm(u, m["z_proj"], prec)
    xs = silu(causal_conv(mm(u, m["x_proj"], prec), m["conv_x"]))
    bm = silu(causal_conv(mm(u, m["B_proj"], prec), m["conv_B"]))
    cm = silu(causal_conv(mm(u, m["C_proj"], prec), m["conv_C"]))
    dt = F.softplus(mm(u, m["dt_proj"], prec) + m["dt_bias"])
    b, s, _ = x.shape
    xh = xs.view(b, s, -1, hp)
    y, state = ssd(xh, dt, torch.exp(m["A_log"]), bm, cm)
    y = (y + m["D_skip"][:, None] * xh).reshape(b, s, -1) * silu(z)
    y = rmsnorm(y, m["norm"], eps)
    return x + mm(y, m["out_proj"], prec), state


def _layer_params(params, i):
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["blocks"])


def _f32_tree(tree):
    return {k: _f32_tree(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out.extend(leaves(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def rebuild(tree, values):
    it = iter(values)

    def walk(t):
        return {k: walk(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return walk(tree)


# ---------------------------------------------------------------------------
# Prefill: last-token logits and every layer's last state
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params, tokens, cfg, prec="float32", rows=1):
    """tokens (B, S) -> (logits (B, V), states (L, B, H, P, N)), a block of
    ``rows`` sequences at a time."""
    p = _f32_tree(params)
    logits, states = [], []
    for r in range(0, tokens.shape[0], rows):
        x = p["embed"][tokens[r:r + rows]]
        per_layer = []
        for i in range(cfg["n_layer"]):
            x, st = layer(x, _layer_params(p, i), cfg, prec)
            per_layer.append(st)
        states.append(torch.stack(per_layer))
        u = rmsnorm(x[:, -1], p["ln_f"], cfg["norm_epsilon"])
        logits.append(mm(u, p["unembed"], prec))
        del x
    return torch.cat(logits), torch.cat(states, dim=1)


# ---------------------------------------------------------------------------
# Training: loss, gradients, AdamW
# ---------------------------------------------------------------------------

def _ce_sum(x, unembed, labels, prec):
    logits = mm(x, unembed, prec)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None])[..., 0]).sum()


def loss_and_grads(p, tokens, labels, cfg, prec, rows, ce_chunk=1024):
    """Mean next-token cross-entropy over every token; the gradient of
    each leaf of ``p`` (fp32, requiring grad) lands in its ``.grad``.
    A block of ``rows`` sequences at a time, each layer recomputed in the
    backward pass."""
    total_tokens = tokens.numel()
    total = 0.0
    for r in range(0, tokens.shape[0], rows):
        x = p["embed"][tokens[r:r + rows]]
        for i in range(cfg["n_layer"]):
            x = checkpoint(lambda x, i=i: layer(
                x, _layer_params(p, i), cfg, prec)[0], x,
                use_reentrant=False)
        x = rmsnorm(x, p["ln_f"], cfg["norm_epsilon"])
        lab = labels[r:r + rows]
        loss = sum(checkpoint(_ce_sum, x[:, s:s + ce_chunk], p["unembed"],
                              lab[:, s:s + ce_chunk], prec,
                              use_reentrant=False)
                   for s in range(0, x.shape[1], ce_chunk))
        (loss / total_tokens).backward()
        total += float(loss.detach())
    return total / total_tokens


def lr_at(step, hp):
    """The warmup-cosine schedule: linear from 0 over ``warmup`` steps,
    then a cosine from ``lr`` to ``floor`` x ``lr`` at ``total``."""
    if step < hp["warmup"]:
        return hp["lr"] * step / max(hp["warmup"], 1)
    prog = min(max((step - hp["warmup"]) / max(hp["total"] - hp["warmup"],
                                               1), 0.0), 1.0)
    return hp["lr"] * (hp["floor"] + (1 - hp["floor"]) * 0.5
                       * (1 + math.cos(math.pi * prog)))


def train_steps(params, seqs, hp, cfg, prec="float32", rows=2):
    """AdamW from ``params`` over ``seqs`` (one (B, S + 1) token sequence a
    step: the first S columns are the input, the last S each token's next
    token), the global gradient norm clipped to ``clip``, weight decay on
    every leaf.  Returns each step's loss, each leaf's first clipped
    gradient norm and each leaf's change after the last step, with the
    leaves' paths, in sorted-key order."""
    paths, start = zip(*leaves(params))
    cur = [t.detach().clone() for t in start]
    mom = [torch.zeros_like(t, dtype=torch.float32) for t in start]
    vel = [torch.zeros_like(t, dtype=torch.float32) for t in start]
    b1, b2 = hp["b1"], hp["b2"]
    losses, first = [], None
    for step, seq in enumerate(seqs):
        tokens, labels = seq[:, :-1], seq[:, 1:]
        xs = [t.float().requires_grad_() for t in cur]
        losses.append(loss_and_grads(rebuild(params, xs), tokens, labels,
                                     cfg, prec, rows))
        grads = [x.grad for x in xs]
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.clamp(hp["clip"] / (gnorm + 1e-9), max=1.0)
        grads = [g * scale for g in grads]
        if first is None:
            first = [float(g.norm()) for g in grads]
        t = step + 1
        lr = lr_at(step, hp)
        with torch.no_grad():
            for k, g in enumerate(grads):
                mom[k] = b1 * mom[k] + (1 - b1) * g
                vel[k] = b2 * vel[k] + (1 - b2) * g * g
                upd = (mom[k] / (1 - b1 ** t)) / (
                    torch.sqrt(vel[k] / (1 - b2 ** t)) + hp["eps"])
                delta = -lr * (upd + hp["weight_decay"] * cur[k].float())
                cur[k] = (cur[k].float() + delta.to(cur[k].dtype).float()
                          ).to(cur[k].dtype)
    change = [float((c.float() - s.float()).norm())
              for c, s in zip(cur, start)]
    return {"paths": list(paths), "losses": losses, "grad_norms": first,
            "change_norms": change}
