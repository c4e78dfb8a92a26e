"""Driver ``lm_prefill``: one prefill of the whole batch a window step
through the port's ``train.make_prefill_step`` (the last token's logits
and the decode cache).

Set-up builds the model with the benchmark's seeded weights and a pool of
seeded token batches; each window step prefills the next batch of the
pool.  The sampled steps' answers are compared with the plain reference's
prefill of the same tokens: the logits, and every layer's last SSM state.
"""

from __future__ import annotations

import torch

from .. import floors, lm
from ..check import rel_max, sample_steps


class Cell:
    def __init__(self, config, workload, seed, device, ref, control=False):
        self.cfg, self.wl, self.ref = config, workload, ref
        self.device = device
        b, s = workload["batch"], workload["seq"]
        self.params = lm.make_params(config, seed, device)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.pool = [torch.randint(0, config["vocab_size"], (b, s),
                                   generator=gen, device=device)
                     for _ in range(workload["pool"])]
        if control:
            def run(tokens):
                return ref.prefill(self.params, tokens, config, "float8",
                                   rows=workload["ref_rows"])
        else:
            from repro_torch.models import Model
            from repro_torch.sharding import ShardingCtx
            from repro_torch.train import make_prefill_step
            model = Model(lm.arch_config(config), device=device,
                          params=self.params)
            prefill = make_prefill_step(model, ShardingCtx.local())

            def run(tokens):
                logits, cache = prefill(self.params, {"tokens": tokens})
                return logits, cache["state"]
        self._run = run
        self.samples = set(sample_steps(seed, workload["check_steps"],
                                        workload["check_span"]))
        self.kept = []
        self.open = True
        self.attempted = 0
        self.units_per_step = float(b * s)
        self.floors = {
            "flops": floors.mamba2_step_flops(config, b, s, "prefill"),
            "recur_bytes": floors.mamba2_recur_floor_bytes(config, b, s,
                                                           "prefill")}
        self._run(self.pool[0])                  # warm-up, discarded
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def step(self, i):
        j = i % len(self.pool)
        logits, states = self._run(self.pool[j])
        if self.open and i in self.samples:
            self.kept.append((j, logits, states))
        self.attempted += 1

    def close(self):
        self.open = False

    def check(self) -> dict:
        self._run = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        logits_err = state_err = 0.0
        for j, logits, states in self.kept:
            want_l, want_s = self.ref.prefill(self.params, self.pool[j],
                                              self.cfg,
                                              rows=self.wl["ref_rows"])
            logits_err = max(logits_err, rel_max(logits, want_l))
            state_err = max(state_err, max(
                float((a.double() - w.double()).norm() / w.double().norm())
                for a, w in zip(states, want_s)))
        return {"logits_err": logits_err, "state_err": state_err}
