"""End-to-end training driver with fault tolerance.

Counterpart of ``repro.launch.train``, with the same flags, defaults and
``[train]`` log lines, plus ``--device`` (default ``cuda``; raises without
a card unless ``--device cpu``) and ``--seed`` (weights and data):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 300 --batch 8 --seq 256 --ckpt-dir artifacts/train_run
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --smoke --device cpu --steps 4

Features wired in: auto-resume from the latest committed checkpoint (JAX's
format, so either package resumes the other's run), async checkpoint
writer, straggler monitor (per-host timings are simulated on one host but
flow through the real code path), retry wrapper around the step,
deterministic resumable data.  ``--smoke`` uses the reduced config.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.ckpt import AsyncWriter, latest_step, restore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.model import param_specs
from repro_torch.models.params import check_tree, tree_leaves, tree_map
from repro_torch.runtime import StragglerMonitor, with_retries
from repro_torch.sharding import ShardingCtx
from repro_torch.train import AdamW, make_train_step, warmup_cosine


def make_optimizer(cfg, *, lr: float, warmup: int, steps: int) -> AdamW:
    """The driver's AdamW: warmup-cosine to ``steps``, moments in
    ``cfg.opt_dtype``."""
    return AdamW(lr=warmup_cosine(lr, warmup, steps),
                 opt_dtype=torch.bfloat16 if cfg.opt_dtype == "bfloat16"
                 else torch.float32)


def train(cfg, *, steps: int = 300, batch: int = 8, seq: int = 256,
          lr: float = 3e-4, warmup: int = 20,
          ckpt_dir: str = "artifacts/train_run", ckpt_every: int = 50,
          log_every: int = 10, accum: int = 1, device=None, seed: int = 0,
          log=print) -> dict:
    """Train ``cfg`` from step 0, or from the step after the latest
    committed checkpoint in ``ckpt_dir``, up to ``steps``; checkpoint
    every ``ckpt_every`` steps and at the last.  Returns the first step
    run (``start``), each step's loss and seconds (host clock around the
    batch and the step, which ends in reading the loss), and the final
    ``params`` and ``opt_state``."""
    model = build_model(cfg, device=device, seed=seed)
    device = model.device
    sctx = ShardingCtx.local()
    opt = make_optimizer(cfg, lr=lr, warmup=warmup, steps=steps)

    # ---- init or auto-resume --------------------------------------------
    start = latest_step(ckpt_dir)
    if start is not None:
        tree, start = restore(ckpt_dir, device=device)
        params, opt_state = tree["params"], tree["opt"]
        check_tree(param_specs(cfg), params)
        check_tree(opt.state_specs(param_specs(cfg)), opt_state)
        log(f"[train] resumed from step {start}")
        start += 1
    else:
        params = tree_map(lambda t: t.detach(), model.params.tree())
        opt_state = opt.init(params)
        start = 0
        n = sum(x.numel() for x in tree_leaves(params))
        log(f"[train] fresh start: {cfg.name}, {n/1e6:.1f}M params")

    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                     seed=seed)
    step_fn = with_retries(make_train_step(model, sctx, opt, accum=accum),
                           max_retries=2)

    writer = AsyncWriter()
    monitor = StragglerMonitor()
    losses, t_hist = [], []
    log_path = os.path.join(ckpt_dir, "log.jsonl")
    os.makedirs(ckpt_dir, exist_ok=True)

    for step in range(start, steps):
        t0 = time.time()
        data = ds.batch_at(step, device=device)
        params, opt_state, metrics = step_fn(params, opt_state, data, step)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        losses.append(loss)
        t_hist.append(dt)
        flagged = monitor.update({0: dt})   # single-host: id 0
        if step % log_every == 0 or step == steps - 1:
            toks = batch * seq / dt
            log(f"[train] step {step:5d} loss {loss:.4f} "
                f"{dt*1e3:7.1f} ms/step {toks:9.0f} tok/s"
                + (f" STRAGGLERS {flagged}" if flagged else ""))
            with open(log_path, "a") as f:
                json.dump({"step": step, "loss": loss, "ms": dt * 1e3}, f)
                f.write("\n")
        if step > 0 and step % ckpt_every == 0:
            writer.submit(ckpt_dir, step,
                          {"params": params, "opt": opt_state})
    if losses:
        writer.submit(ckpt_dir, steps - 1,
                      {"params": params, "opt": opt_state})
    writer.flush()
    if losses:
        log(f"[train] done; final loss {losses[-1]:.4f}; "
            f"median step {sorted(t_hist)[len(t_hist)//2]*1e3:.1f} ms")
    return {"start": start, "losses": losses, "step_s": t_hist,
            "params": params, "opt_state": opt_state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="artifacts/train_run")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CI-sized)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          warmup=args.warmup, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, log_every=args.log_every,
          accum=args.accum, device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
