"""The rest of ``repro_torch.core``: the fused factor+solve functions and
the deprecated ``TridiagOperator`` / ``PentaOperator`` shims, against the
JAX package on the same numpy inputs (after
``tests/test_core_solvers.py``'s operator tests and
``tests/test_solver_frontend.py``'s shim test)."""

import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import PentaOperator as JaxPenta
from repro.core import TridiagOperator as JaxTridiag
from repro.core import penta_factor_solve as jax_penta_factor_solve
from repro.core import thomas_factor_solve as jax_thomas_factor_solve
from repro_torch.core import (PentaOperator, TridiagOperator,
                              penta_factor_solve, thomas_factor_solve)
from repro_torch.solver import BandedSystem, plan

CPU = "cpu"


def _rand_tridiag(rng, n, dominance=2.5):
    a = rng.uniform(-1, 1, n).astype(np.float32)
    c = rng.uniform(-1, 1, n).astype(np.float32)
    b = (np.abs(a) + np.abs(c) + dominance).astype(np.float32)
    return a, b, c


def _rand_penta(rng, n, dominance=4.0):
    a, b, d, e = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(4))
    c = (np.abs(a) + np.abs(b) + np.abs(d) + np.abs(e)
         + dominance).astype(np.float32)
    return a, b, c, d, e


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=1e-5):
    got, want = got.numpy(), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("method", ("scan", "assoc"))
def test_thomas_factor_solve_matches_jax(method):
    rng = np.random.default_rng(1)
    a, b, c = _rand_tridiag(rng, 40)
    d = rng.normal(size=(40, 9)).astype(np.float32)
    got = thomas_factor_solve(*map(_t, (a, b, c, d)), method=method)
    _close(got, jax_thomas_factor_solve(a, b, c, jnp.asarray(d),
                                        method=method))


def test_penta_factor_solve_matches_jax():
    rng = np.random.default_rng(2)
    diags = _rand_penta(rng, 40)
    rhs = rng.normal(size=(40, 9)).astype(np.float32)
    got = penta_factor_solve(*map(_t, diags), _t(rhs))
    _close(got, jax_penta_factor_solve(*diags, jnp.asarray(rhs)))


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("periodic", [False, True])
def test_tridiag_modes_agree_and_match_jax(periodic):
    rng = np.random.default_rng(42)
    n, m = 96, 24
    a, b, c = _rand_tridiag(rng, n)
    d = rng.normal(size=(n, m)).astype(np.float32)
    xs = {}
    for mode in ["constant", "batch"]:
        batch = m if mode == "batch" else None
        op = TridiagOperator.create(a, b, c, mode=mode, periodic=periodic,
                                    batch=batch, device=CPU)
        xs[mode] = op.solve(_t(d))
        jop = JaxTridiag.create(a, b, c, mode=mode, periodic=periodic,
                                batch=batch)
        _close(xs[mode], jop.solve(jnp.asarray(d)))
    np.testing.assert_allclose(xs["constant"], xs["batch"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("periodic", [False, True])
def test_penta_modes_agree_and_match_jax(periodic):
    rng = np.random.default_rng(43)
    n, m = 64, 12
    sigma = 0.21
    coef = (sigma, -4 * sigma, 1 + 6 * sigma, -4 * sigma, sigma)
    rhs = rng.normal(size=(n, m)).astype(np.float32)
    xs = {}
    for mode in ["constant", "batch", "uniform"]:
        batch = m if mode == "batch" else None
        op = PentaOperator.create(*coef, n=n, mode=mode, periodic=periodic,
                                  batch=batch, device=CPU)
        xs[mode] = op.solve(_t(rhs))
        jop = JaxPenta.create(*coef, n=n, mode=mode, periodic=periodic,
                              batch=batch)
        _close(xs[mode], jop.solve(jnp.asarray(rhs)))
    np.testing.assert_allclose(xs["constant"], xs["batch"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(xs["constant"], xs["uniform"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_storage_reduction_claims_match_jax():
    """Paper: tridiag 4MN -> 3N+MN (~75 %), penta 6MN -> 5N+MN (~83 %)."""
    n, m = 1024, 4096
    pen = (1.0, -4.0, 7.0, -4.0, 1.0)
    cases = [
        (TridiagOperator, JaxTridiag, (1.0, 4.0, 1.0), "constant"),
        (TridiagOperator, JaxTridiag, (1.0, 4.0, 1.0), "batch"),
        (PentaOperator, JaxPenta, pen, "constant"),
        (PentaOperator, JaxPenta, pen, "batch"),
        (PentaOperator, JaxPenta, pen, "uniform"),
    ]
    for port, ref, coef, mode in cases:
        batch = m if mode == "batch" else None
        got = port.create(*coef, n=n, mode=mode, batch=batch, device=CPU)
        want = ref.create(*coef, n=n, mode=mode, batch=batch)
        assert got.storage_bytes(rhs_batch=m) == want.storage_bytes(
            rhs_batch=m), (port.__name__, mode)
    tri_c = TridiagOperator.create(1.0, 4.0, 1.0, n=n, device=CPU)
    tri_b = TridiagOperator.create(1.0, 4.0, 1.0, n=n, mode="batch", batch=m,
                                   device=CPU)
    tot_c = tri_c.storage_bytes(rhs_batch=m)["total_bytes"]
    tot_b = tri_b.storage_bytes(rhs_batch=m)["total_bytes"]
    assert tot_c == (3 * n + n * m) * 4 and tot_b == 4 * n * m * 4
    assert 1 - tot_c / tot_b > 0.74
    pen_u = PentaOperator.create(*pen, n=n, mode="uniform", device=CPU)
    assert pen_u.storage_bytes()["lhs_bytes"] == (4 * n + 1) * 4


def test_operator_shims_warn_and_match_the_front_end():
    rng = np.random.default_rng(6)
    n = 64
    a, b, c = _rand_tridiag(rng, n)
    d = _t(rng.normal(size=(n, 7)).astype(np.float32))
    with pytest.warns(DeprecationWarning, match="TridiagOperator"):
        op = TridiagOperator.create(a, b, c, mode="constant", periodic=True,
                                    device=CPU)
    p = plan(BandedSystem.tridiag(a, b, c, periodic=True, device=CPU),
             backend="reference")
    np.testing.assert_allclose(op.solve(d, method="scan"), p.solve(d),
                               rtol=1e-6, atol=1e-6)

    s = 0.11
    pa, pb, pc, pd, pe = (v * np.ones(n, np.float32)
                          for v in (s, -4 * s, 1 + 6 * s, -4 * s, s))
    with pytest.warns(DeprecationWarning, match="PentaOperator"):
        op5 = PentaOperator.create(pa, pb, pc, pd, pe, mode="uniform",
                                   periodic=True, device=CPU)
    p5 = plan(BandedSystem.penta(pa, pb, pc, pd, pe, periodic=True,
                                 mode="uniform", device=CPU),
              backend="reference")
    np.testing.assert_allclose(op5.solve(d), p5.solve(d), rtol=1e-6,
                               atol=1e-6)


def test_operator_shims_default_to_cuda():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if torch.cuda.is_available():
            op = TridiagOperator.create(1.0, 4.0, 1.0, n=8)
            assert op.stored.a.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TridiagOperator.create(1.0, 4.0, 1.0, n=8)
