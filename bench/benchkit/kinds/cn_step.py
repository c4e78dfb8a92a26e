"""Driver ``cn_step``: the Crank–Nicolson step of ``pde.DiffusionCN``.

Set-up builds the step (the factor once) and a seeded (N, M) field; each
window step is ``field = step(field)``.  The answers compared are every
system of the sampled steps (``check_steps`` of them, step 0 and others
drawn from the seed below ``check_span``), read through a seeded random
projection: the step is linear, so the projection of its output is the
reference's step applied to the projection of its input, and one wrong
system, or one wrong unknown, moves it.  A projection is one
matrix-vector product on the device, enqueued beside the sampled step.
"""

from __future__ import annotations

import torch

from .. import floors
from ..check import rel_max, sample_steps


class Cell:
    def __init__(self, config, workload, seed, device, ref, control=False):
        self.n, self.m = n, m = config["n"], config["m"]
        self.sigma = config["dt"] / (2.0 * (1.0 / n) ** 2)
        dtype = getattr(torch, config["dtype"])
        self.device, self.ref = device, ref
        gen = torch.Generator(device=device).manual_seed(seed)
        self.field = torch.randn((n, m), generator=gen, dtype=dtype,
                                 device=device)
        self.proj = (2 * torch.randint(0, 2, (m,), generator=gen,
                                       device=device) - 1).to(dtype)
        if control:
            ainv = ref.inverse(n, self.sigma, device=device)
            ainv = ainv.to(torch.bfloat16)
            self._step = lambda f: ref.step_low(f, self.sigma, ainv)
        else:
            from repro_torch.pde import DiffusionCN
            pde = DiffusionCN(n=n, dt=config["dt"],
                              backend=workload["backend"],
                              dtype=dtype, device=device)
            _, self._step = pde.step_fn()
        self.samples = set(sample_steps(seed, workload["check_steps"],
                                        workload["check_span"]))
        self.kept = []
        self.open = True
        self.attempted = 0
        self.units_per_step = float(n * m)
        self.floors = {"pde_bytes": floors.cn_step_floor_bytes(
            n, m, config["dtype"])}
        self._step(self.field)                   # warm-up, discarded
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def step(self, i):
        keep = self.open and i in self.samples
        if keep:
            before = self.field @ self.proj
        self.field = self._step(self.field)
        if keep:
            self.kept.append((i, before, self.field @ self.proj))
        self.attempted += 1

    def close(self):
        self.open = False

    def check(self) -> dict:
        del self.field
        t = self.ref.step_matrix(self.n, self.sigma, device=self.device)
        errs = [rel_max(after, t @ before.double())
                for _, before, after in self.kept]
        return {"step_err": max(errs)}
