"""repro_torch.core against repro.core on the same numpy inputs.

Every function of the port's recurrence, tridiag and penta modules is held
against its JAX counterpart at fp32 (max |Δ| ≤ 1e-5 · max |reference|),
including the factor fields themselves.  Sizes N ∈ {1, 2, 3, 5, 64, 200}
and M ∈ {1, 7, 130}; the JAX side runs once per N at M = 138 and each M
compares against its columns (the systems of a batch are independent).

N the JAX functions reject or make degenerate are skipped:
  * periodic tridiag needs N ≥ 3 (below, the corners fall on the band);
  * penta needs N ≥ 2 (its factor zeroes rows 0, 1 and N-2, N-1);
  * periodic penta needs N ≥ 5 (below, its 2x2 corner blocks overlap the
    band).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import penta as jpenta
from repro.core import recurrence as jrec
from repro.core import tridiag as jtri
from repro_torch.core import penta as tpenta
from repro_torch.core import recurrence as trec
from repro_torch.core import tridiag as ttri

NS = (1, 2, 3, 5, 64, 200)
MS = (1, 7, 130)
M_ALL = sum(MS)
TOL = 1e-5


def _min_n(kind: str, periodic: bool) -> int:
    if kind == "tri":
        return 3 if periodic else 1
    return 5 if periodic else 2


def _inputs(kind: str, n: int):
    rng = np.random.default_rng(1000 * n + (3 if kind == "tri" else 5))
    if kind == "tri":
        diags = [rng.uniform(-1, 1, n), 4 + rng.uniform(0, 1, n),
                 rng.uniform(-1, 1, n)]
    else:
        diags = [rng.uniform(-0.5, 0.5, n) for _ in range(5)]
        diags[2] = diags[2] + 6
    rhs = rng.normal(size=(n, M_ALL))
    return [d.astype(np.float32) for d in diags], rhs.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("kind", "periodic"))
def _jax_all(diags, rhs, *, kind, periodic):
    core = jtri if kind == "tri" else jpenta
    fac = jtri.thomas_factor if kind == "tri" else jpenta.penta_factor
    solve = jtri.thomas_solve if kind == "tri" else jpenta.penta_solve
    solve_t = jtri.thomas_solve_t if kind == "tri" else jpenta.penta_solve_t
    f = fac(*diags)
    out = {"factor": f, "x": solve(f, rhs), "xt": solve_t(f, rhs),
           "dense": (jtri.dense_tridiag if kind == "tri"
                     else jpenta.dense_penta)(*diags, periodic=periodic)}
    if periodic:
        pfac = (jtri.periodic_thomas_factor if kind == "tri"
                else jpenta.periodic_penta_factor)
        pf = pfac(*diags)
        out["pfactor"] = pf
        out["px"] = (jtri.periodic_thomas_solve if kind == "tri"
                     else jpenta.periodic_penta_solve)(pf, rhs)
        out["pxt"] = (jtri.periodic_thomas_solve_t if kind == "tri"
                      else jpenta.periodic_penta_solve_t)(pf, rhs)
        out["corner_t"] = core.periodic_corner_correction_t(pf, rhs)
    return out


@functools.lru_cache(maxsize=None)
def _reference(kind: str, n: int, periodic: bool):
    diags, rhs = _inputs(kind, n)
    out = _jax_all(tuple(jnp.asarray(d) for d in diags), jnp.asarray(rhs),
                   kind=kind, periodic=periodic)
    return jax.tree_util.tree_map(np.asarray, out)


def _close(got: torch.Tensor, want, tol=TOL):
    got = got.detach().cpu().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0) / scale
    assert err <= tol, f"max|Δ|/max|ref| = {err:.3e} > {tol}"


def _fields_close(port_factor, jax_factor):
    for name, value in jax_factor._asdict().items():
        got = getattr(port_factor, name)
        if hasattr(value, "_asdict"):
            _fields_close(got, value)
        else:
            _close(got, value)


def _cases():
    for kind in ("tri", "penta"):
        for periodic in (False, True):
            for n in NS:
                if n >= _min_n(kind, periodic):
                    yield kind, periodic, n


CASES = list(_cases())


def _ids(case):
    kind, periodic, n = case
    return f"{kind}-{'periodic' if periodic else 'dirichlet'}-N{n}"


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_factor_fields_match(case):
    kind, periodic, n = case
    diags, _ = _inputs(kind, n)
    want = _reference(kind, n, periodic)
    t = [torch.from_numpy(d) for d in diags]
    if kind == "tri":
        _fields_close(ttri.thomas_factor(*t), want["factor"])
        if periodic:
            _fields_close(ttri.periodic_thomas_factor(*t), want["pfactor"])
    else:
        _fields_close(tpenta.penta_factor(*t), want["factor"])
        if periodic:
            _fields_close(tpenta.periodic_penta_factor(*t), want["pfactor"])


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_solves_match(case, m):
    kind, periodic, n = case
    diags, rhs = _inputs(kind, n)
    want = _reference(kind, n, periodic)
    lo = sum(MS[:MS.index(m)])
    cols = slice(lo, lo + m)
    t = [torch.from_numpy(d) for d in diags]
    r = torch.from_numpy(rhs[:, cols].copy())
    core = ttri if kind == "tri" else tpenta
    if kind == "tri":
        f = ttri.thomas_factor(*t)
        _close(ttri.thomas_solve(f, r), want["x"][:, cols])
        _close(ttri.thomas_solve_t(f, r), want["xt"][:, cols])
    else:
        f = tpenta.penta_factor(*t)
        _close(tpenta.penta_solve(f, r), want["x"][:, cols])
        _close(tpenta.penta_solve_t(f, r), want["xt"][:, cols])
    _close((ttri.dense_tridiag if kind == "tri" else tpenta.dense_penta)(
        *t, periodic=periodic), want["dense"])
    if periodic:
        pfac = (ttri.periodic_thomas_factor if kind == "tri"
                else tpenta.periodic_penta_factor)
        pf = pfac(*t)
        psolve = (ttri.periodic_thomas_solve if kind == "tri"
                  else tpenta.periodic_penta_solve)
        psolve_t = (ttri.periodic_thomas_solve_t if kind == "tri"
                    else tpenta.periodic_penta_solve_t)
        _close(psolve(pf, r), want["px"][:, cols])
        _close(psolve_t(pf, r), want["pxt"][:, cols])
        _close(core.periodic_corner_correction_t(pf, r),
               want["corner_t"][:, cols])


def test_single_rhs_vector_matches_batch_column():
    diags, rhs = _inputs("penta", 64)
    t = [torch.from_numpy(d) for d in diags]
    pf = tpenta.periodic_penta_factor(*t)
    r = torch.from_numpy(rhs[:, :3].copy())
    full = tpenta.periodic_penta_solve(pf, r)
    _close(tpenta.periodic_penta_solve(pf, r[:, 1]), full[:, 1].numpy())
    pt = ttri.periodic_thomas_factor(*[torch.from_numpy(d) for d in
                                       _inputs("tri", 64)[0]])
    _close(ttri.periodic_thomas_solve_t(pt, r[:, 2]),
           ttri.periodic_thomas_solve_t(pt, r)[:, 2].numpy())


def test_penta_helpers_match():
    rng = np.random.default_rng(7)
    vcoef = rng.normal(size=6).astype(np.float32)
    y = rng.normal(size=(9, 4)).astype(np.float32)
    _close(tpenta._vty(torch.from_numpy(vcoef), torch.from_numpy(y)),
           jpenta._vty(jnp.asarray(vcoef), jnp.asarray(y)))
    _close(tpenta._corner_V(torch.from_numpy(vcoef), 9),
           jpenta._corner_V(jnp.asarray(vcoef), 9))


# -- the recurrence loops ----------------------------------------------------

@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("seeded", (False, True))
@pytest.mark.parametrize("order", (1, 2))
def test_linear_recurrence_matches_scan(order, seeded, reverse):
    rng = np.random.default_rng(order * 10 + seeded * 2 + reverse)
    n, m = 33, 5
    gates = [rng.uniform(-0.9, 0.9, n).astype(np.float32)
             for _ in range(order)]
    q = rng.normal(size=(n, m)).astype(np.float32)
    h0 = ([rng.normal(size=m).astype(np.float32) for _ in range(order)]
          if seeded else None)
    if order == 1:
        want = jrec.linear_recurrence(
            jnp.asarray(gates[0]), jnp.asarray(q),
            None if h0 is None else jnp.asarray(h0[0]), reverse=reverse,
            method="scan")
        got = trec.linear_recurrence(
            torch.from_numpy(gates[0]), torch.from_numpy(q),
            None if h0 is None else torch.from_numpy(h0[0]), reverse=reverse)
    else:
        want = jrec.linear_recurrence2(
            *(jnp.asarray(g) for g in gates), jnp.asarray(q),
            None if h0 is None else tuple(jnp.asarray(h) for h in h0),
            reverse=reverse, method="scan")
        got = trec.linear_recurrence2(
            *(torch.from_numpy(g) for g in gates), torch.from_numpy(q),
            None if h0 is None else tuple(torch.from_numpy(h) for h in h0),
            reverse=reverse)
    _close(got, want)


def test_align_matches():
    ref = torch.zeros(4, 3, 2)
    coef = torch.arange(4.0)
    assert trec._align(coef, ref).shape == jrec._align(
        jnp.arange(4.0), jnp.zeros((4, 3, 2))).shape == (4, 1, 1)
    assert trec._align(torch.zeros(4, 3, 2), ref).shape == (4, 3, 2)
    with pytest.raises(ValueError):
        trec._align(torch.zeros(4, 3), ref)


@pytest.mark.parametrize("method", ("pallas", "interpret", "bogus", ""))
def test_unported_methods_raise(method):
    """JAX's kernel method is ``cuda`` here; its name, the TPU interpret
    mode and unknown names are refused."""
    p, q = torch.zeros(3), torch.zeros(3, 2)
    with pytest.raises(ValueError, match="unknown method"):
        trec.linear_recurrence(p, q, method=method)
    with pytest.raises(ValueError, match="unknown method"):
        trec.linear_recurrence2(p, p, q, method=method)


def test_factor_types_are_frozen_dataclasses():
    f = ttri.thomas_factor(torch.zeros(3), torch.ones(3), torch.zeros(3))
    assert dataclasses.is_dataclass(f)
    with pytest.raises(dataclasses.FrozenInstanceError):
        f.a = torch.zeros(3)
