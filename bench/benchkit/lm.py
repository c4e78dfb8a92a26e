"""A Mamba-2 language model as the benchmark hands it to the program and
to the reference: the port's configuration built from the benchmark's
own file, and seeded weights in the port's parameter layout.

The weights are the benchmark's: drawn on the device from the seed in
two calls (one normal draw for every matrix, one uniform draw for the
per-head dt and A of the published Mamba-2 initialisation), cast to the
dtype they are served in, and handed alike to the program and to the
reference.
"""

from __future__ import annotations

import math

import torch

import numpy as np

from .floors import embed_rows, mamba2_dims


def arch_config(c: dict, *, remat: bool = True):
    """The port's ``ArchConfig`` with every size from the file ``c`` (the
    vocabulary as the embedding's padded rows)."""
    from repro_torch.models import ArchConfig

    return ArchConfig(
        name=c["name"], family="ssm", n_layers=c["n_layer"],
        d_model=c["d_model"], n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=embed_rows(c), ssm_state=c["d_state"],
        ssm_head_dim=c["headdim"], ssm_expand=c["expand"],
        ssm_chunk=c["chunk_size"], conv_width=c["d_conv"],
        dtype=c["dtype"], norm_eps=c["norm_epsilon"], remat=remat)


# Frozen copy of the token stream of ``SyntheticLM.batch_at`` and its hash
# (``src/repro_torch/data/synthetic.py`` at commit 3b55662): the benchmark
# makes its batches itself, so the reference reads the labels off the
# sequence it was handed, not off the program's batch.

def _hash_u32(x: np.ndarray, seed: int) -> np.ndarray:
    x = (x.astype(np.uint64) + np.uint64(seed)) * np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(29)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(32)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def token_stream(vocab: int, seq: int, batch: int, seed: int, step: int,
                 structure: float = 0.9) -> torch.Tensor:
    """(batch, seq + 1) int64 tokens of ``step`` on the host: each row
    starts at a hashed token, and each next token is ``(31 t + 7) mod
    vocab`` or, with probability 1 - ``structure``, hashed noise.  A
    step's tokens are the first ``seq`` columns, its labels the last
    ``seq``."""
    rows = np.arange(batch, dtype=np.uint64)
    base = (np.uint64(step) << np.uint64(24)) + rows[:, None]
    toks = np.zeros((batch, seq + 1), np.int64)
    toks[:, 0] = _hash_u32(base, seed)[:, 0] % vocab
    noise = _hash_u32(base * np.uint64(131)
                      + np.arange(seq + 1, dtype=np.uint64)[None, :],
                      seed + 1)
    use_noise = (noise % np.uint32(1000)) >= np.uint32(int(structure * 1000))
    for j in range(1, seq + 1):
        affine = (toks[:, j - 1] * 31 + 7) % vocab
        toks[:, j] = np.where(use_noise[:, j], noise[:, j] % vocab, affine)
    return torch.from_numpy(toks)


def _put(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for key in head:
        tree = tree.setdefault(key, {})
    tree[last] = value


def make_params(c: dict, seed: int, device) -> dict:
    """The parameter tree ``{"embed", "unembed", "ln_f", "blocks": {"ln",
    "ssm": {...}}}`` with layers stacked on a leading axis.  Matrices are
    N(0, 1/fan_in) (fan-in the contracted size; the conv's its width);
    norms zero (the scale is 1 + w); D one; dt log-uniform in [dt_min,
    dt_max] through the softplus's inverse in dt_bias; A uniform in
    A_init_range through A_log."""
    d = mamba2_dims(c)
    L, D, V, di, H, N, W = (d[k] for k in ("L", "D", "V", "di", "H", "N",
                                            "W"))
    wdt = getattr(torch, c["dtype"])
    f32 = torch.float32
    normal = [("embed", (V, D), D), ("unembed", (D, V), D),
              ("blocks/ssm/z_proj", (L, D, di), D),
              ("blocks/ssm/x_proj", (L, D, di), D),
              ("blocks/ssm/B_proj", (L, D, N), D),
              ("blocks/ssm/C_proj", (L, D, N), D),
              ("blocks/ssm/dt_proj", (L, D, H), D),
              ("blocks/ssm/conv_x", (L, W, di), W),
              ("blocks/ssm/conv_B", (L, W, N), W),
              ("blocks/ssm/conv_C", (L, W, N), W),
              ("blocks/ssm/out_proj", (L, di, D), di)]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal),
                       generator=gen, dtype=f32, device=device)
    tree: dict = {}
    off = 0
    for path, shape, fan_in in normal:
        k = math.prod(shape)
        leaf = flat[off:off + k].view(shape).mul_(fan_in ** -0.5)
        _put(tree, path, leaf.to(wdt))
        off += k
    del flat
    u = torch.rand((2, L, H), generator=gen, dtype=f32, device=device)
    lo, hi = math.log(c["dt_min"]), math.log(c["dt_max"])
    dt = torch.exp(lo + (hi - lo) * u[0])
    a_lo, a_hi = c["A_init_range"]
    _put(tree, "blocks/ssm/dt_bias", dt + torch.log(-torch.expm1(-dt)))
    _put(tree, "blocks/ssm/A_log", torch.log(a_lo + (a_hi - a_lo) * u[1]))
    _put(tree, "blocks/ssm/D_skip", torch.ones((L, H), dtype=f32,
                                               device=device))
    _put(tree, "blocks/ssm/norm", torch.zeros((L, di), dtype=f32,
                                              device=device))
    _put(tree, "blocks/ln", torch.zeros((L, D), dtype=f32, device=device))
    _put(tree, "ln_f", torch.zeros((D,), dtype=f32, device=device))
    return tree


def leaves(tree: dict, prefix: str = "") -> list:
    """``[(path, tensor)]`` in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out.extend(leaves(v, path) if isinstance(v, dict) else [(path, v)])
    return out
