"""repro_torch.solver against repro.solver on the same numpy inputs.

``factorize`` / ``solve`` / ``transpose_solve`` / ``plan`` of the port, on
the CPU, for backend ∈ {reference, cuda, auto} × bandwidth {3, 5} × mode
{constant, uniform} × {Dirichlet, periodic}, held against JAX's
``factorize(backend="pallas")`` (interpret mode) at fp32, ≤ 1e-5
relative; ``torch.autograd`` gradients against ``jax.grad``; an fp64
finite-difference check; factorizations carried over from JAX; the README's
storage claim; and the options the port refuses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.solver as jsolver
from repro_torch.convert import from_jax_factorization
from repro_torch.solver import (BandedSystem, factorize, plan, solve,
                                transpose_solve, with_options)

N, M = 48, 9
TOL = 1e-5
BACKENDS = ("reference", "cuda", "auto")
CONFIGS = [(bw, mode, periodic) for bw in (3, 5)
           for mode in ("constant", "uniform") for periodic in (False, True)]


def _diags(bw: int, mode: str, dtype=np.float32):
    """Scalars for uniform mode, (N,) vectors otherwise (numpy)."""
    if mode == "uniform":
        vals = (-0.4, 1.8, -0.4) if bw == 3 else (0.4, -1.6, 3.4, -1.6, 0.4)
        return [dtype(v) for v in vals]
    rng = np.random.default_rng(bw)
    if bw == 3:
        diags = [rng.uniform(-1, 1, N), 4 + rng.uniform(0, 1, N),
                 rng.uniform(-1, 1, N)]
    else:
        diags = [rng.uniform(-0.5, 0.5, N) for _ in range(5)]
        diags[2] = diags[2] + 6
    return [d.astype(dtype) for d in diags]


def _rhs(dtype=np.float32, m=M):
    return np.random.default_rng(11).normal(size=(N, m)).astype(dtype)


def _jax_system(bw, mode, periodic, *, batch=None):
    ctor = jsolver.BandedSystem.tridiag if bw == 3 else jsolver.BandedSystem.penta
    return ctor(*_diags(bw, mode), n=N, periodic=periodic, mode=mode,
                batch=batch)


def _port_system(bw, mode, periodic, *, dtype=torch.float32, batch=None,
                 diags=None):
    ctor = BandedSystem.tridiag if bw == 3 else BandedSystem.penta
    if diags is None:
        diags = [torch.as_tensor(d) for d in _diags(bw, mode)]
    return ctor(*diags, n=N, periodic=periodic, mode=mode, batch=batch,
                dtype=dtype, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_pallas(bw, mode, periodic):
    fact = jsolver.factorize(_jax_system(bw, mode, periodic),
                             backend="pallas")
    rhs = jnp.asarray(_rhs())
    return (np.asarray(jsolver.solve(fact, rhs)),
            np.asarray(jsolver.transpose_solve(fact, rhs)))


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _ids(cfg):
    bw, mode, periodic = cfg
    return f"bw{bw}-{mode}-{'periodic' if periodic else 'dirichlet'}"


@pytest.mark.parametrize("cfg", CONFIGS, ids=[_ids(c) for c in CONFIGS])
@pytest.mark.parametrize("backend", BACKENDS)
def test_solves_match_jax_pallas(backend, cfg):
    bw, mode, periodic = cfg
    want_x, want_xt = _jax_pallas(bw, mode, periodic)
    system = _port_system(bw, mode, periodic)
    fact = factorize(system, backend=backend)
    assert fact.backend == ("reference" if backend == "reference" else "cuda")
    rhs = torch.from_numpy(_rhs())
    assert _rel(solve(fact, rhs), want_x) <= TOL
    assert _rel(transpose_solve(fact, rhs), want_xt) <= TOL
    assert _rel(plan(system, backend=backend).solve(rhs), want_x) <= TOL
    # the (N,) single-RHS squeeze
    assert _rel(solve(fact, rhs[:, 0]), want_x[:, 0]) <= TOL
    assert fact.describe().endswith(f"N={N}@{fact.backend}")


@pytest.mark.parametrize("periodic", (False, True))
@pytest.mark.parametrize("bw", (3, 5))
def test_transpose_solve_matches_the_transposed_system(bw, periodic):
    system = _port_system(bw, "constant", periodic, dtype=torch.float64)
    rhs = torch.from_numpy(_rhs(np.float64))
    got = transpose_solve(factorize(system, backend="cuda"), rhs)
    want = solve(factorize(system.transposed(), backend="reference"), rhs)
    assert _rel(got, want.numpy()) <= 1e-12


@pytest.mark.parametrize("backend", ("reference", "cuda"))
@pytest.mark.parametrize("periodic", (False, True))
@pytest.mark.parametrize("bw", (3, 5))
def test_grads_match_jax(bw, periodic, backend):
    diags = _diags(bw, "constant")
    rhs = _rhs()

    def jloss(fact, r):
        return jnp.sum(jsolver.solve(fact, r) ** 2)

    jfact = jsolver.factorize(_jax_system(bw, "constant", periodic),
                              backend="pallas" if backend == "cuda"
                              else "reference")
    jbar, jrhs_bar = jax.grad(jloss, argnums=(0, 1))(jfact, jnp.asarray(rhs))

    tdiags = [torch.tensor(d, requires_grad=True) for d in diags]
    system = _port_system(bw, "constant", periodic, diags=tdiags)
    assert all(a is b for a, b in zip(system.diagonals, tdiags))
    trhs = torch.tensor(rhs, requires_grad=True)
    (solve(factorize(system, backend=backend), trhs) ** 2).sum().backward()
    assert _rel(trhs.grad, jrhs_bar) <= TOL
    for got, want in zip(tdiags, jbar.diagonals):
        assert _rel(got.grad, want) <= TOL


@pytest.mark.parametrize("periodic", (False, True))
@pytest.mark.parametrize("bw", (3, 5))
def test_grad_matches_finite_differences_fp64(bw, periodic):
    diags = [torch.tensor(d, dtype=torch.float64)
             for d in _diags(bw, "constant", np.float64)]
    main = bw // 2
    rhs0 = torch.tensor(_rhs(np.float64, m=3))

    def f(main_diag, rhs):
        ds = list(diags)
        ds[main] = main_diag
        system = _port_system(bw, "constant", periodic, dtype=torch.float64,
                              diags=ds)
        return solve(factorize(system, backend="cuda"), rhs)

    assert torch.autograd.gradcheck(
        f, (diags[main].clone().requires_grad_(), rhs0.requires_grad_()),
        eps=1e-6, atol=1e-7, rtol=1e-5, fast_mode=True)


def test_stored_factor_gets_no_gradient():
    tdiags = [torch.tensor(d, requires_grad=True) for d in _diags(3, "constant")]
    fact = factorize(_port_system(3, "constant", True, diags=tdiags),
                     backend="cuda")
    assert not fact.stored.z.requires_grad
    assert not fact.stored.factor.inv_denom.requires_grad
    solve(fact, torch.from_numpy(_rhs())).sum().backward()
    assert all(d.grad is not None for d in tdiags)


def _stored_np(fact):
    return jax.tree_util.tree_map(np.asarray, fact.stored)


def _meta_dict(meta):
    return {"bandwidth": meta.bandwidth, "n": meta.n, "mode": meta.mode,
            "periodic": meta.periodic, "backend": meta.backend,
            "options": meta.options}


CARRY = [(bw, mode, periodic, jb) for bw, mode, periodic in CONFIGS
         for jb in ("pallas", "reference")] + [
    (3, "batch", False, "reference"), (5, "batch", False, "reference"),
    (3, "batch", False, "pallas"), (5, "batch", False, "pallas"),
    (3, "batch", True, "reference"), (5, "batch", True, "reference")]


@pytest.mark.parametrize("case", CARRY,
                         ids=[f"{_ids(c[:3])}-{c[3]}" for c in CARRY])
def test_jax_factorization_carried_over(case):
    bw, mode, periodic, jax_backend = case
    batch = M if mode == "batch" else None
    jfact = jsolver.factorize(_jax_system(bw, mode, periodic, batch=batch),
                              backend=jax_backend)
    rhs = _rhs()
    want = np.asarray(jsolver.solve(jfact, jnp.asarray(rhs)))
    want_t = np.asarray(jsolver.transpose_solve(jfact, jnp.asarray(rhs)))
    fact = from_jax_factorization(
        _stored_np(jfact), _meta_dict(jfact.meta), device="cpu",
        diagonals=[np.asarray(d) for d in jfact.diagonals])
    expected = {"pallas": "cuda", "reference": "reference"}[jax_backend]
    # a periodic batch factorization has no kernel and stays reference
    assert fact.backend == ("reference" if mode == "batch" and periodic
                            else expected)
    assert _rel(solve(fact, torch.from_numpy(rhs)), want) <= TOL
    assert _rel(transpose_solve(fact, torch.from_numpy(rhs)), want_t) <= TOL


def test_carried_over_bf16_storage_option():
    jfact = jsolver.factorize(_jax_system(5, "uniform", True),
                              backend="pallas", storage_dtype="bf16")
    fact = from_jax_factorization(_stored_np(jfact), _meta_dict(jfact.meta),
                                  device="cpu")
    assert fact.meta.opt("storage_dtype") is torch.bfloat16
    rhs = _rhs()
    want = np.asarray(jsolver.solve(jfact, jnp.asarray(rhs)))
    assert _rel(solve(fact, torch.from_numpy(rhs)), want) <= 1e-2


def test_readme_storage_saving():
    n, m, sigma = 512, 4096, 0.4
    system = BandedSystem.tridiag(-sigma, 1 + 2 * sigma, -sigma, n=n,
                                  periodic=True, mode="constant", device="cpu")
    batch_sys = BandedSystem.tridiag(-sigma, 1 + 2 * sigma, -sigma, n=n,
                                     periodic=True, mode="batch", batch=m,
                                     device="cpu")
    shared = plan(system, backend="reference").storage_bytes(rhs_batch=m)
    per_sys = plan(batch_sys, backend="reference").storage_bytes(rhs_batch=m)
    saving = 1 - shared["total_bytes"] / per_sys["total_bytes"]
    assert saving > 0.74
    assert plan(system, backend="cuda").storage_bytes()["lhs_bytes"] > 0


@pytest.mark.parametrize("bw,periodic", ((3, True), (5, False), (3, False),
                                        (5, True)))
def test_batch_mode_routes_to_reference_and_cuda_refuses(bw, periodic):
    """``auto`` sends Dirichlet batch to the cuda backend, as JAX sends it to
    pallas; periodic batch has no kernel in either package, so ``auto``
    sends it to reference and an explicit ``backend="cuda"`` refuses it."""
    system = _port_system(bw, "batch", periodic, batch=M)
    if periodic:
        with pytest.raises(NotImplementedError, match="periodic"):
            factorize(system, backend="cuda")
    fact = factorize(system, backend="auto")
    assert fact.backend == ("reference" if periodic else "cuda")
    jfact = jsolver.factorize(_jax_system(bw, "batch", periodic, batch=M),
                              backend="reference")
    want = np.asarray(jsolver.solve(jfact, jnp.asarray(_rhs())))
    assert _rel(solve(fact, torch.from_numpy(_rhs())), want) <= TOL


# the TPU kernels' tiling knobs and JAX's scan unroll factor: refused with
# the reason they mean nothing here
@pytest.mark.parametrize("knob", ("block_m", "block_n", "fused", "prefetch",
                                  "interpret", "unroll"))
def test_tpu_knobs_raise(knob):
    system = _port_system(3, "constant", False)
    with pytest.raises(TypeError, match=knob):
        factorize(system, backend="cuda", **{knob: 128})
    with pytest.raises(TypeError, match=knob):
        plan(system, backend="auto", **{knob: 128})
    fact = factorize(system, backend="cuda")
    with pytest.raises(TypeError, match=knob):
        with_options(fact, **{knob: 128})


def test_cuda_options_ride_in_the_meta():
    fact = factorize(_port_system(3, "constant", False), backend="cuda",
                     storage_dtype="bf16")
    assert fact.meta.opt("storage_dtype") is torch.bfloat16
    assert (with_options(fact, storage_dtype="float64")
            .meta.opt("storage_dtype") == "float64")
    x = solve(fact, torch.from_numpy(_rhs()))
    assert x.dtype == torch.float32


@pytest.mark.parametrize("cfg", [(3, "constant", True), (5, "uniform", False)],
                         ids=_ids)
def test_core_alias_is_the_reference_backend(cfg):
    """``backend="core"``, the JAX package's legacy spelling, resolves to
    ``reference`` in ``factorize`` and ``plan`` and solves as JAX's
    ``core`` does."""
    bw, mode, periodic = cfg
    jfact = jsolver.factorize(_jax_system(bw, mode, periodic), backend="core")
    want = np.asarray(jsolver.solve(jfact, jnp.asarray(_rhs())))
    system = _port_system(bw, mode, periodic)
    fact = factorize(system, backend="core")
    assert fact.backend == "reference"
    assert _rel(solve(fact, torch.from_numpy(_rhs())), want) <= TOL
    p = plan(system, backend="core")
    assert p.backend == "reference"
    assert _rel(p.solve(torch.from_numpy(_rhs())), want) <= TOL


@pytest.mark.parametrize("case", ["scan-on-cuda", "bf16-on-reference"])
def test_options_of_another_backend_are_ignored(case):
    """``factorize`` takes the union of the backends' options and each
    backend ignores what does not apply, as in the JAX package:
    ``method`` reaching the cuda backend through ``auto`` on a constant
    system, ``storage_dtype`` reaching the reference backend through
    ``auto`` on a periodic batch system."""
    if case == "scan-on-cuda":
        cfg, opts, backend = (3, "constant", False), {"method": "scan"}, \
            "cuda"
        system = _port_system(*cfg)
        jsys = _jax_system(*cfg)
    else:
        cfg, opts, backend = (5, "batch", True), {"storage_dtype": "bf16"}, \
            "reference"
        system = _port_system(*cfg, batch=M)
        jsys = _jax_system(*cfg, batch=M)
    want = np.asarray(jsolver.solve(
        jsolver.factorize(jsys, backend="reference"), jnp.asarray(_rhs())))
    fact = factorize(system, backend="auto", **opts)
    assert fact.backend == backend
    assert _rel(solve(fact, torch.from_numpy(_rhs())), want) <= TOL
    p = plan(system, backend="auto", **opts)
    assert p.backend == backend
    assert _rel(p.solve(torch.from_numpy(_rhs())), want) <= TOL
