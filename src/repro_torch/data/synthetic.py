"""Deterministic synthetic LM data pipeline: shard-aware, resumable.

Counterpart of ``repro.data.synthetic``, with the same numpy hash, so the
two packages draw the same tokens for the same (seed, step, shard).
Tokens are a stateless hash of (stream seed, step, position), so
  * every host/shard can materialise exactly its slice with no I/O,
  * restarts resume bit-identically from the step counter alone (the
    checkpoint stores only ``step``),
  * re-sharding is trivial (the global batch is position-addressed).

The "language" has enough structure to give a learnable signal: token t+1 is
a noisy affine function of token t modulo vocab, so a model can reduce loss
well below uniform.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.solver.system import resolve_device


def _hash_u32(x: np.ndarray, seed: int) -> np.ndarray:
    x = (x.astype(np.uint64) + np.uint64(seed)) * np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(29)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(32)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.9      # P(next = affine(prev)); rest uniform noise

    def batch_at(self, step: int, *, shard: tuple[int, int] = (0, 1),
                 device=None) -> dict:
        """Materialise (a shard of) the global batch for ``step`` as int64
        ``tokens`` and ``labels`` (the next tokens) on ``device`` (default:
        the CUDA device; raises without one unless ``device="cpu"``).

        shard = (index, count) slices the global batch dimension (per-host
        data loading at scale)."""
        device = resolve_device(device)
        idx, count = shard
        if self.global_batch % count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {count} shards")
        per = self.global_batch // count
        rows = np.arange(idx * per, (idx + 1) * per, dtype=np.uint64)
        base = (np.uint64(step) << np.uint64(24)) + rows[:, None]

        # column 0: hashed start token; columns evolve affinely with noise
        h0 = _hash_u32(base, self.seed)
        toks = np.zeros((per, self.seq_len + 1), np.int64)
        toks[:, 0] = h0[:, 0] % self.vocab
        noise = _hash_u32(base * np.uint64(131) +
                          np.arange(self.seq_len + 1, dtype=np.uint64)[None, :],
                          self.seed + 1)
        use_noise = (noise % np.uint32(1000)) >= np.uint32(int(self.structure * 1000))
        for j in range(1, self.seq_len + 1):
            affine = (toks[:, j - 1] * 31 + 7) % self.vocab
            toks[:, j] = np.where(use_noise[:, j], noise[:, j] % self.vocab,
                                  affine)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}

    def iterator(self, start_step: int = 0, *, shard=(0, 1), device=None):
        step = start_step
        while True:
            yield step, self.batch_at(step, shard=shard, device=device)
            step += 1
