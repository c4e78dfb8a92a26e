"""train_step / serve_step factories.

Counterpart of ``repro.train.train_loop``.  ``make_train_step`` returns a
function of (params, opt_state, batch, step) that builds and returns new
trees and modifies none it is given, so ``runtime.with_retries`` can run
it again after a failure.  Gradients come from ``torch.autograd.grad``
over the parameter leaves; microbatches (``accum`` > 1) are a loop that
sums fp32 gradients and divides by ``accum``, as JAX's ``lax.scan`` does.
The sharding helpers (``batch_shardings``, ``cache_shardings``,
``train_step_shardings``) give trees of ``NamedSharding`` (a mesh and its
DTensor placements); ``repro_torch.sharding.place_tree`` lays a tree of
tensors out on them.
"""

from __future__ import annotations

import torch

from repro_torch.models.model import decode_fn, prefill_fn
from repro_torch.models.params import (tree_leaves, tree_map, tree_unflatten,
                                      tree_zip_map)
from repro_torch.sharding import ShardingCtx
from repro_torch.spans import span
from .optimizer import AdamW, apply_updates


def batch_shardings(sctx: ShardingCtx, batch_specs: dict) -> dict:
    """NamedShardings for a batch dict of tensors (or anything with a
    ``shape``): the leading dim is the batch, the rest replicated."""
    def one(s):
        ndim = len(s.shape)
        names = ("act_batch",) + (None,) * (ndim - 1) if ndim else ()
        return sctx.sharding(names, tuple(s.shape))
    return tree_map(one, batch_specs)


def cache_shardings(sctx: ShardingCtx, cache_spec_tree):
    return sctx.tree_shardings(cache_spec_tree)


def train_step_shardings(model, sctx: ShardingCtx, opt: AdamW,
                         batch_specs: dict) -> tuple:
    """(in_shardings, out_shardings) of ``train_step``: the params', the
    AdamW state's, the batch's and the step's placements; the metrics are
    left unplaced (replicated scalars), as in JAX."""
    pspecs = model.param_specs()
    p_sh = sctx.tree_shardings(pspecs)
    o_sh = sctx.tree_shardings(opt.state_specs(pspecs))
    b_sh = batch_shardings(sctx, batch_specs)
    step_sh = sctx.sharding((), ())
    return (p_sh, o_sh, b_sh, step_sh), (p_sh, o_sh, None)


def make_train_step(model, sctx: ShardingCtx, opt: AdamW, *, accum: int = 1):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``model`` is a ``repro_torch.models.Model`` (only its ``loss`` is
    used: the parameters are the tree passed in).  ``batch`` holds
    (B, S) ``tokens`` and ``labels``; ``accum`` splits B into that many
    microbatches.  A step is the span ``train.step``, around
    ``train.forward`` (the loss) and ``train.backward`` (its gradients), a
    pair a microbatch, and ``train.optimizer`` (AdamW's update and its
    application)."""

    def grads_of(params, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with torch.enable_grad():
            with span("train.forward"):
                loss, metrics = model.loss(tree_unflatten(params, leaves),
                                           batch, sctx)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, grads)

    def train_step(params, opt_state, batch, step):
        with span("train.step"):
            return _train_step(params, opt_state, batch, step)

    def _train_step(params, opt_state, batch, step):
        if accum > 1:
            mbs = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                   for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lsum = 0.0
            for i in range(accum):
                loss, _, g = grads_of(params, {k: v[i] for k, v in
                                               mbs.items()})
                gsum = tree_zip_map(lambda a, b: a + b.to(torch.float32),
                                    gsum, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / accum, gsum)
            loss = lsum / accum
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        with torch.no_grad(), span("train.optimizer"):
            deltas, opt_state, opt_metrics = opt.update(grads, opt_state,
                                                        params, step)
            params = apply_updates(params, deltas)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(model, sctx: ShardingCtx):
    """(params, batch) -> (last-token logits, cache), the span
    ``prefill.step``."""
    def prefill_step(params, batch):
        with torch.inference_mode(), span("prefill.step"):
            return prefill_fn(params, batch, sctx, model.cfg)
    return prefill_step


def make_decode_step(model, sctx: ShardingCtx):
    def decode_step(params, cache, token, pos):
        with torch.inference_mode():
            return decode_fn(params, cache, token, pos, sctx, model.cfg)
    return decode_step
