"""Faults planted under a cell's timed path, each of the kinds a cell
can have: a step that returns its state unchanged ("unchanged"); half of
the batch left out, the rest stepped or averaged ("half"); an answer
altered where it is produced ("altered").  The tests and
``bench/calibrate.py`` plant them to see ``correct`` come out false and to
read what each fault reads.  (One card: no exchange between chips to
leave out.)"""

import contextlib

import torch


def _cn_step_fault(kind):
    from repro_torch.pde import DiffusionCN
    real = DiffusionCN.step_fn

    def step_fn(self):
        pf, step = real(self)

        def broken(f):
            if kind == "unchanged":
                return f
            out = step(f)
            if kind == "half":
                out[:, f.shape[1] // 2:] = f[:, f.shape[1] // 2:]
            else:
                out[3, 5] += 1.0
            return out
        return pf, broken
    return DiffusionCN, "step_fn", step_fn


def _cn_adjoint_fault(kind):
    import repro_torch.solver as solver
    real = solver.solve

    def solve(fact, d):
        if kind == "unchanged":
            return d + 0.0 * sum(t.sum() for t in fact.diagonals)
        x = real(fact, d)
        if kind == "half":
            h = d.shape[1] // 2
            return torch.cat([x[:, :h], d[:, h:]], dim=1)
        bump = torch.zeros_like(x)
        bump[3, 5] = 1.0
        return x + bump
    return solver, "solve", solve


def _train_fault(kind):
    import repro_torch.train as train
    real = train.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def broken(params, opt_state, batch, n):
            if kind == "half":
                half = batch["tokens"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
            new_p, new_o, metrics = step(params, opt_state, batch, n)
            if kind == "unchanged":
                return params, opt_state, metrics
            if kind == "altered":
                ssm = dict(new_p["blocks"]["ssm"])
                a = ssm["A_log"]
                ssm["A_log"] = a + 0.05 * (torch.arange(
                    a.numel(), device=a.device) == 0).view(a.shape)
                new_p = dict(new_p, blocks=dict(new_p["blocks"], ssm=ssm))
            return new_p, new_o, metrics
        return broken
    return train, "make_train_step", make


def _prefill_fault(kind):
    import repro_torch.train as train
    real = train.make_prefill_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def broken(params, batch):
            logits, cache = step(params, batch)
            logits, cache = logits.clone(), dict(cache)
            if kind == "unchanged":
                cache["state"] = torch.zeros_like(cache["state"])
            elif kind == "half":
                h = logits.shape[0] // 2
                logits[h:] = logits[:h].mean(0)
            else:
                logits[0, 7] += 1.0
            return logits, cache
        return broken
    return train, "make_prefill_step", make


#: by the workload's driver
FAULTS = {"cn_step": _cn_step_fault, "cn_adjoint": _cn_adjoint_fault,
          "lm_train": _train_fault, "lm_prefill": _prefill_fault}
KINDS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(driver: str, kind: str):
    """The timed path of ``driver``'s cells broken with the fault ``kind``
    while the block runs."""
    owner, name, broken = FAULTS[driver](kind)
    real = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, real)
