"""Driver ``lm_train``: one training step a window step through the
port's ``train.make_train_step`` (AdamW, remat as the workload says),
each step's batch made by the benchmark from the seed (``lm.token_stream``,
a frozen copy of ``data.SyntheticLM``'s stream).

Set-up builds one step object with the benchmark's seeded weights and a
fresh optimizer state, and drives it through its first three steps with
the window's own call and feed; the window then goes on from step 3 with
that same state.  What is compared is those first three steps, against
the plain reference from the same weights and batches: each step's loss,
each leaf's first gradient as the optimizer got it (its first moment
after step 0 over 1 - b1), and each leaf's change over the three steps.
The reference is handed each step's token sequence and reads the labels
off it.  A batch is made on the host, pinned, and copied without a host
sync.
"""

from __future__ import annotations

import torch

from .. import floors, lm
from ..check import norm_gap

CHECKED_STEPS = 3


class Cell:
    def __init__(self, config, workload, seed, device, ref, control=False):
        self.cfg, self.wl, self.ref = config, workload, ref
        self.device = device
        self.batch, self.seq = b, s = workload["batch"], workload["seq"]
        self.hp = workload["optimizer"]
        self.seed = seed
        self.params0 = lm.make_params(config, seed, device)
        self.attempted = 0
        self.units_per_step = float(b * s)
        self.floors = {
            "flops": floors.mamba2_step_flops(config, b, s, "train"),
            "recur_bytes": floors.mamba2_recur_floor_bytes(config, b, s,
                                                           "train")}
        self.checked = [self._tokens(k) for k in range(CHECKED_STEPS)]
        if control:
            self.got = self._reference("float8")
            return
        from repro_torch.models import Model
        from repro_torch.sharding import ShardingCtx
        from repro_torch.train import AdamW, make_train_step, warmup_cosine
        hp = self.hp
        opt = AdamW(lr=warmup_cosine(hp["lr"], hp["warmup"], hp["total"],
                                     hp["floor"]),
                    b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                    weight_decay=hp["weight_decay"], clip=hp["clip"],
                    opt_dtype=getattr(torch, hp["moment_dtype"]))
        self.model = Model(lm.arch_config(config, remat=workload["remat"]),
                           device=device, params=self.params0)
        self._train = make_train_step(self.model, ShardingCtx.local(), opt)
        self.state = (self.params0, opt.init(self.params0))
        losses = []
        for k, seq in enumerate(self.checked):
            losses.append(self._run(k, self._feed(seq)))
            if k == 0:
                first = [(m / (1.0 - hp["b1"])).norm() for _, m in
                         lm.leaves(self.state[1]["m"])]
        change = [(p.float() - q.float()).norm() for (_, p), (_, q) in
                  zip(lm.leaves(self.state[0]), lm.leaves(self.params0))]
        self.got = {"losses": [float(x) for x in losses],
                    "grad_norms": [float(g) for g in first],
                    "change_norms": [float(c) for c in change]}

    def _tokens(self, step):
        """The (batch, seq + 1) token sequence of ``step``, on the host."""
        return lm.token_stream(self.cfg["vocab_size"], self.seq, self.batch,
                               self.seed, step)

    def _feed(self, seq):
        """The program's batch: the sequence's first ``seq`` columns as
        tokens, its last ``seq`` as labels, on the device (pinned, copied
        without waiting)."""
        host = {"tokens": seq[:, :-1].contiguous(),
                "labels": seq[:, 1:].contiguous()}
        if torch.device(self.device).type == "cpu":
            return host
        return {k: v.pin_memory().to(self.device, non_blocking=True)
                for k, v in host.items()}

    def _run(self, step, batch):
        params, opt_state, metrics = self._train(*self.state, batch, step)
        self.state = (params, opt_state)
        return metrics["loss"]

    def step(self, i):
        k = CHECKED_STEPS + i
        self._run(k, self._feed(self._tokens(k)))
        self.attempted += 1

    def close(self):
        pass

    def _reference(self, prec):
        seqs = [seq.to(self.device) for seq in self.checked]
        return self.ref.train_steps(self.params0, seqs, self.hp, self.cfg,
                                    prec=prec, rows=self.wl["ref_rows"])

    def check(self) -> dict:
        for name in ("state", "model", "_train"):
            self.__dict__.pop(name, None)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        want = self._reference("float32")
        got = self.got
        # leaves whose reference gradient is nought to rounding move under
        # Adam by round-off alone: left out of the change by this rule
        g = sorted(want["grad_norms"])
        moved = [w >= 1e-3 * g[len(g) // 2] for w in want["grad_norms"]]
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], want["losses"])),
            "grad_gap": norm_gap(got["grad_norms"], want["grad_norms"]),
            "change_gap": norm_gap(got["change_norms"], want["change_norms"],
                                   moved)}
