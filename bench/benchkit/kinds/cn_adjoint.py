"""Driver ``cn_adjoint``: a shared-LHS solve and its adjoint through the
solver's front end (``solver.factorize`` / ``solver.solve`` and
``torch.autograd``).

Set-up factors the CN LHS once, with its three (N,) diagonals as leaves
that take gradients, and draws a pool of seeded right-hand sides d and
cotangents g.  Each window step solves x = A^{-1} d for the next pool
pair and takes the gradients of <x, g> with respect to d and the three
diagonals (``torch.autograd.grad``: the rhs's gradient comes back as the
step's output rather than being summed into ``d.grad``).  The sampled
steps' answers are compared: x and the rhs's gradient through a seeded
random projection of every system, the diagonals' gradients whole.
"""

from __future__ import annotations

import torch

from .. import floors
from ..check import rel_max, sample_steps


class Cell:
    def __init__(self, config, workload, seed, device, ref, control=False):
        self.n, self.m = n, m = config["n"], config["m"]
        self.sigma = s = config["dt"] / (2.0 * (1.0 / n) ** 2)
        dtype = getattr(torch, config["dtype"])
        self.device, self.ref = device, ref
        gen = torch.Generator(device=device).manual_seed(seed)
        self.pool = [(torch.randn((n, m), generator=gen, dtype=dtype,
                                  device=device).requires_grad_(),
                      torch.randn((n, m), generator=gen, dtype=dtype,
                                  device=device))
                     for _ in range(workload["pool"])]
        self.proj = (2 * torch.randint(0, 2, (m,), generator=gen,
                                       device=device) - 1).to(dtype)
        if control:
            ainv = ref.inverse(n, s, device=device).to(torch.bfloat16)

            def it(d, g):
                with torch.no_grad():
                    x, lam, cots = ref.adjoint_low(d, g, ainv)
                return x, lam, cots
        else:
            from repro_torch.solver import BandedSystem, factorize, solve
            diags = tuple(torch.full((n,), v, dtype=dtype, device=device,
                                     requires_grad=True)
                          for v in (-s, 1.0 + 2.0 * s, -s))
            system = BandedSystem.tridiag(*diags, n=n, periodic=True,
                                          dtype=dtype, device=device)
            fact = factorize(system, backend=workload["backend"])

            def it(d, g):
                x = solve(fact, d)
                gd, *cots = torch.autograd.grad(x, (d, *diags), g)
                return x.detach(), gd, tuple(cots)
        self._iter = it
        self.samples = set(sample_steps(seed, workload["check_steps"],
                                        workload["check_span"]))
        self.kept = []
        self.open = True
        self.attempted = 0
        self.units_per_step = 2.0 * n * m
        self.floors = {"pde_bytes": floors.cn_adjoint_floor_bytes(
            n, m, config["dtype"])}
        self._iter(*self.pool[0])                # warm-up, discarded
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def step(self, i):
        j = i % len(self.pool)
        x, gd, cots = self._iter(*self.pool[j])
        if self.open and i in self.samples:
            self.kept.append((j, x @ self.proj, gd @ self.proj, cots))
        self.attempted += 1

    def close(self):
        self.open = False

    def _reference(self, j, ainv, block):
        """x's and lambda's projections and the diagonals' gradients of
        pool pair j, in fp64, a block of systems at a time."""
        d, g = self.pool[j]
        r = self.proj.double()
        dr = torch.zeros(self.n, dtype=torch.float64, device=self.device)
        gr = torch.zeros_like(dr)
        cots = [torch.zeros_like(dr) for _ in range(3)]
        for s in range(0, self.m, block):
            db = d.detach()[:, s:s + block].double()
            gb = g[:, s:s + block].double()
            dr += db @ r[s:s + block]
            gr += gb @ r[s:s + block]
            for k, c in enumerate(self.ref.diagonal_cotangents(
                    ainv.t() @ gb, ainv @ db)):
                cots[k] += c
        return ainv @ dr, ainv.t() @ gr, cots

    def check(self) -> dict:
        ainv = self.ref.inverse(self.n, self.sigma, device=self.device)
        refs = {j: self._reference(j, ainv, 65536)
                for j in sorted({k[0] for k in self.kept})}
        x_err = grad_err = diag_err = 0.0
        for j, px, pd, cots in self.kept:
            want_x, want_d, want_c = refs[j]
            x_err = max(x_err, rel_max(px, want_x))
            grad_err = max(grad_err, rel_max(pd, want_d))
            diag_err = max(diag_err, *(rel_max(c, w)
                                       for c, w in zip(cots, want_c)))
        return {"x_err": x_err, "rhs_grad_err": grad_err,
                "diag_grad_err": diag_err}
