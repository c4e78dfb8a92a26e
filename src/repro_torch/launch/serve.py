"""Batched serving driver: prefill a wave of prompts, then decode greedily.

Counterpart of ``repro.launch.serve``, with the same flags and wave loop
(a wave of ``--batch`` prompts, padded by repeating its last prompt;
prefill; greedy decode of ``--gen`` tokens; the same two ``[serve]``
lines), plus ``--device`` (default ``cuda``; raises without a card unless
``--device cpu``) and ``--seed`` (weights and prompts):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --smoke --device cpu --requests 4 --batch 2 --prompt-len 32 --gen 8

The prefill cache is grown to the serving budget (``--max-len``) only
along the axes its spec names a sequence axis (``act_kv_seq``); the ssm
state and conv tails have none, whatever their sizes.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model

SEQ_AXIS = "act_kv_seq"


def pad_cache(cache: dict, specs: dict, max_len: int) -> dict:
    """Grow every cache leaf whose spec names a sequence axis to
    ``max_len`` along it (zeros after the prompt)."""
    def grow(leaf, spec):
        if SEQ_AXIS not in spec.names:
            return leaf
        axis = spec.names.index(SEQ_AXIS)
        pad = [0, 0] * (leaf.ndim - 1 - axis) + [0, max_len - leaf.shape[axis]]
        return F.pad(leaf, pad)
    return {k: (pad_cache(v, specs[k], max_len) if isinstance(v, dict)
                else grow(v, specs[k])) for k, v in cache.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, *, requests: int = 12, batch: int = 4, prompt_len: int = 32,
          gen: int = 24, max_len: int = 0, device=None, seed: int = 0,
          log=print) -> dict:
    """Serve ``requests`` random prompts in waves of ``batch``.  Returns the
    per-wave prefill and decode seconds (host clock around work that ends
    in a device synchronise), the counts, each wave's first continuation
    and the last wave's decode cache."""
    model = build_model(cfg, device=device, seed=seed)
    device = model.device
    max_len = max_len or (prompt_len + gen)
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, cfg.vocab, (prompt_len,)).astype(np.int64)
             for _ in range(requests)]
    specs = model.cache_specs(batch, max_len)

    served = tokens_out = 0
    waves = []
    cache = None
    t0 = time.perf_counter()
    while queue:
        wave = [queue.pop(0) for _ in range(min(batch, len(queue)))]
        while len(wave) < batch:                  # pad the wave
            wave.append(wave[-1])
        prompts = torch.from_numpy(np.stack(wave)).to(device)
        _sync(device)
        t_pre = time.perf_counter()
        logits, cache = model.prefill({"tokens": prompts})
        cache = pad_cache(cache, specs, max_len)
        tok = torch.argmax(logits, -1)
        _sync(device)
        t_dec = time.perf_counter()
        out = [tok]
        for t in range(gen - 1):
            logits, cache = model.decode(cache, tok, prompt_len + t)
            tok = torch.argmax(logits, -1)
            out.append(tok)
        generated = torch.stack(out, dim=1).cpu()
        t_end = time.perf_counter()
        served += len(wave)
        tokens_out += gen * batch
        first = generated[0][:10].tolist()
        waves.append({"prefill_s": t_dec - t_pre, "decode_s": t_end - t_dec,
                      "decode_steps": gen - 1, "first": first})
        log(f"[serve] wave done: batch {batch}, first seq continuation: "
            f"{first}")
    seconds = time.perf_counter() - t0
    log(f"[serve] served {served} requests, {tokens_out} tokens in "
        f"{seconds:.1f}s ({tokens_out / seconds:.1f} tok/s incl. prefill)")
    return {"served": served, "tokens": tokens_out, "seconds": seconds,
            "waves": waves, "cache": cache}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    serve(cfg, requests=args.requests, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen, max_len=args.max_len,
          device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
