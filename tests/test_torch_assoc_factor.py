"""``thomas_factor(method="assoc")`` of repro_torch against the JAX package.

The Möbius recurrence of the Thomas factor, c_hat_i = c_i / (b_i − a_i
c_hat_{i−1}), tracked as the ratio of 2×2 companion products (JAX:
``src/repro/core/tridiag.py``, ``method="assoc"``), on the same seeded
numpy inputs: the factor fields, and ``factorize(..., backend="reference",
method="assoc")`` → ``solve`` / ``transpose_solve`` through both
packages' front ends (Dirichlet and periodic, constant and uniform mode).
Tolerances (max|Δ| / max|reference|): fp32 1e-5, fp64 1e-12 (JAX x64
switched on for that case only).  Like JAX's, the port's product is
unscaled: both overflow at b = 1e3, N = 40 in fp32, and both refuse
(N, M) diagonals, also through a batch-mode solve.  These mirror
``tests/test_core_solvers.py``'s mode agreement and
``tests/test_solver_frontend.py``'s front-end checks.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.solver as jsolver
from repro.core import tridiag as jtri
from repro_torch.core import tridiag as ttri
from repro_torch.solver import (BandedSystem, factorize, solve,
                                transpose_solve)

TOL = {"float32": 1e-5, "float64": 1e-12}


@contextlib.contextmanager
def _jax_x64(enabled: bool):
    if not enabled:
        yield
        return
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _diags(n: int, dtype: str, seed: int = 0, b_range=(4.0, 5.0)) -> list:
    rng = np.random.default_rng(seed + n)
    return [x.astype(dtype) for x in (rng.uniform(-1, 1, n),
                                      rng.uniform(*b_range, n),
                                      rng.uniform(-1, 1, n))]


def _rel(got, want) -> float:
    got = np.asarray(got.detach().double().numpy() if torch.is_tensor(got)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# the unscaled product overflows fp32 once the running determinant, about
# 4.5^N here, passes 3.4e38 (N = 59): N stays below it, as in JAX's use
@pytest.mark.parametrize("n", (1, 2, 3, 24, 40))
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_assoc_factor_matches_jax(dtype, n):
    diags = _diags(n, dtype)
    with _jax_x64(dtype == "float64"):
        want = jtri.thomas_factor(*map(jnp.asarray, diags), method="assoc")
        want = [np.asarray(v) for v in want]
    got = ttri.thomas_factor(*map(torch.from_numpy, diags), method="assoc")
    assert got.c_hat.dtype == getattr(torch, dtype)
    for field, w in zip(("a", "inv_denom", "c_hat"), want):
        assert _rel(getattr(got, field), w) <= TOL[dtype], field
    scan = ttri.thomas_factor(*map(torch.from_numpy, diags))
    assert _rel(got.c_hat, scan.c_hat.numpy()) <= TOL[dtype]


@pytest.mark.parametrize("mode", ("constant", "uniform"))
@pytest.mark.parametrize("periodic", (False, True))
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_assoc_factorize_solve_matches_jax(dtype, periodic, mode):
    n, m = 40, 7
    if mode == "uniform":
        diags = [np.full(n, v, dtype) for v in (-0.4, 1.8, -0.4)]
    else:
        diags = _diags(n, dtype, seed=3)
    rhs = np.random.default_rng(4).normal(size=(n, m)).astype(dtype)
    with _jax_x64(dtype == "float64"):
        jfact = jsolver.factorize(
            jsolver.BandedSystem.tridiag(*diags, n=n, periodic=periodic,
                                         mode=mode, dtype=getattr(jnp, dtype)),
            backend="reference", method="assoc")
        want_x = np.asarray(jsolver.solve(jfact, jnp.asarray(rhs)))
        want_xt = np.asarray(jsolver.transpose_solve(jfact,
                                                     jnp.asarray(rhs)))
    fact = factorize(BandedSystem.tridiag(*diags, n=n, periodic=periodic,
                                          mode=mode,
                                          dtype=getattr(torch, dtype),
                                          device="cpu"),
                     backend="reference", method="assoc")
    assert fact.meta.opt("method") == "assoc"
    r = torch.from_numpy(rhs)
    assert _rel(solve(fact, r), want_x) <= TOL[dtype]
    assert _rel(transpose_solve(fact, r), want_xt) <= TOL[dtype]


def test_assoc_factor_overflows_as_jax_does():
    """b in [1e3, 2e3] at N = 40, fp32: the unscaled running determinant
    overflows in both packages (the batch sweep's on-chip route rescales
    its chunk products instead)."""
    diags = _diags(40, "float32", seed=9, b_range=(1e3, 2e3))
    want = jtri.thomas_factor(*map(jnp.asarray, diags), method="assoc")
    got = ttri.thomas_factor(*map(torch.from_numpy, diags), method="assoc")
    assert not np.isfinite(np.asarray(want.c_hat)).all()
    assert not torch.isfinite(got.c_hat).all()
    scan = ttri.thomas_factor(*map(torch.from_numpy, diags))
    assert torch.isfinite(scan.c_hat).all()


def test_assoc_factor_refuses_batch_diagonals_as_jax_does():
    n, m = 12, 5
    diags = [np.tile(d[:, None], (1, m)) for d in _diags(n, "float32")]
    with pytest.raises(ValueError):
        jtri.thomas_factor(*map(jnp.asarray, diags), method="assoc")
    with pytest.raises(ValueError, match=r"\(N,\) diagonals"):
        ttri.thomas_factor(*map(torch.from_numpy, diags), method="assoc")


def test_assoc_batch_mode_solve_refuses_as_jax_does():
    """Batch mode factors inside the solve, on (N, M) copies: JAX's
    ``factorize`` succeeds and its ``solve`` raises; so do the port's."""
    n, m = 12, 5
    diags = _diags(n, "float32", seed=1)
    rhs = np.ones((n, m), np.float32)
    jfact = jsolver.factorize(
        jsolver.BandedSystem.tridiag(*diags, n=n, mode="batch", batch=m),
        backend="reference", method="assoc")
    with pytest.raises(ValueError):
        jsolver.solve(jfact, jnp.asarray(rhs))
    fact = factorize(BandedSystem.tridiag(*diags, n=n, mode="batch",
                                          batch=m, device="cpu"),
                     backend="reference", method="assoc")
    with pytest.raises(ValueError, match=r"\(N,\) diagonals"):
        solve(fact, torch.from_numpy(rhs))


def test_unknown_factor_method_raises():
    diags = [torch.from_numpy(d) for d in _diags(5, "float32")]
    with pytest.raises(ValueError, match="unknown method"):
        ttri.thomas_factor(*diags, method="pallas")
