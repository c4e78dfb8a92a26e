"""The PDE steppers and the fused CN steps of repro_torch against the JAX
package.

On the same numpy fields, made from a seed, at N = 64 and M = 128 (the
sizes of ``tests/test_pde.py``):

  * ``fused_cn_step`` / ``fused_cn_penta_step`` — on CPU tensors, the
    plain versions of ``csrc/fused_cn.cu`` — against JAX's fused Pallas
    steps in interpret mode, fed the SAME factor
    (``convert.from_jax_periodic_factor``): one step within
    1e-5·max|x|, 25 steps within the JAX suite's 3e-4 / 3e-5
    (``tests/test_pde.py``).  At fp64 (which the JAX steps do not take) the
    plain versions are held to the port's own stencil + periodic solve
    within 1e-12;
  * ``DiffusionCN`` (every backend) and ``ADI2D`` trajectories against
    JAX's on its ``reference`` and ``pallas`` backends, within 3e-4 /
    3e-5; ``HyperdiffusionCN`` (every mode) at fp64 within 1e-10·max|x|
    (its CN operator is ill-conditioned enough that fp32 roundings which
    differ between the frameworks exceed the fp32 bar);
  * the stencils, the traffic accounting and the refusals (a fused step
    on an input that requires grad raises).

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jkernels
import repro.pde as jpde
from repro.core import periodic_penta_factor as j_penta_factor
from repro.core import periodic_thomas_factor as j_thomas_factor
from repro.kernels import fused_cn as j_fused_cn
from repro.kernels import fused_cn_penta as j_fused_cn_penta
from repro.pde import stencil as jstencil
from repro_torch import pde as tpde
from repro_torch.convert import from_jax_periodic_factor
from repro_torch.core import penta as tpenta
from repro_torch.core import tridiag as ttri
from repro_torch.kernels import fused_cn as tfused
from repro_torch.kernels import ops as tops
from repro_torch.pde import stencil as tstencil

N, M = 64, 128
HYPER_M = 16
STEPS = 25
RTOL, ATOL = 3e-4, 3e-5


@contextlib.contextmanager
def _jax_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _field(n: int = N, m: int = M, k: int = 1, noise: float = 0.3,
           seed: int = 0) -> np.ndarray:
    x = np.arange(n) / n
    rng = np.random.default_rng(seed)
    return (np.sin(2 * np.pi * k * x)[:, None]
            + noise * rng.normal(size=(n, m))).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _factors(kind: str, n: int, sigma: float):
    """(JAX periodic factor, the port's copy of the same numbers)."""
    one = np.ones(n, np.float32)
    if kind == "tridiag":
        coef = (-sigma, 1 + 2 * sigma, -sigma)
        jf = j_thomas_factor(*(jnp.asarray(v * one) for v in coef))
    else:
        coef = (sigma, -4 * sigma, 1 + 6 * sigma, -4 * sigma, sigma)
        jf = j_penta_factor(*(jnp.asarray(v * one) for v in coef))
    fields = jf._asdict()
    fields["factor"] = {k: np.asarray(v)
                        for k, v in jf.factor._asdict().items()}
    fields = {k: (v if k == "factor" else np.asarray(v))
              for k, v in fields.items()}
    return jf, from_jax_periodic_factor(fields, device="cpu")


_STEP = {"tridiag": (jkernels.fused_cn_step, tfused.fused_cn_step),
         "penta": (jkernels.fused_cn_penta_step, tfused.fused_cn_penta_step)}
# sigma per kind: dt = 2e-5 at N = 64 (diffusion, tests/test_pde.py) and
# sigma = 0.13 (hyperdiffusion, tests/test_kernels.py)
_SIGMA = {"tridiag": 2e-5 / (2 * (1 / N) ** 2), "penta": 0.13}


# ---------------------------------------------------------------------------
# The fused steps
# ---------------------------------------------------------------------------

def test_from_jax_periodic_factor_keeps_every_field():
    for kind in ("tridiag", "penta"):
        jf, tf = _factors(kind, 16, 0.3)
        assert type(tf).__name__ == type(jf).__name__
        for name, value in jf._asdict().items():
            if name == "factor":
                for k, v in value._asdict().items():
                    assert _rel(getattr(tf.factor, k), v) == 0
            else:
                assert _rel(getattr(tf, name), value) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from_jax_periodic_factor(jf._asdict())


@pytest.mark.parametrize("m", (1, 130))
@pytest.mark.parametrize("n", (5, N))
@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_step_matches_jax(kind, n, m):
    sigma = _SIGMA[kind]
    jf, tf = _factors(kind, n, sigma)
    c = _field(n, m, seed=n + m)
    jstep, tstep = _STEP[kind]
    want = jstep(jf, sigma, jnp.asarray(c), interpret=True)
    tops.reset_launches()
    got = tstep(tf, sigma, torch.from_numpy(c))
    assert tops.LAUNCHES == {}, "the plain version counted a kernel launch"
    assert got.dtype == torch.float32 and got.shape == (n, m)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_trajectory_matches_jax(kind):
    sigma = _SIGMA[kind]
    jf, tf = _factors(kind, N, sigma)
    c = _field(seed=1)
    jstep, tstep = _STEP[kind]
    want, got = jnp.asarray(c), torch.from_numpy(c)
    for _ in range(STEPS):
        want = jstep(jf, sigma, want, interpret=True)
        got = tstep(tf, sigma, got)
    _close(got, want)


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_plain_is_stencil_plus_periodic_solve_at_fp64(kind):
    """At fp64 the plain fused step equals the port's own pipeline: the
    CN stencil, then the periodic solve of the same factor."""
    n, sigma = 40, 0.4
    one = torch.ones(n, dtype=torch.float64)
    c = torch.from_numpy(_field(n, 33, seed=5).astype(np.float64))
    if kind == "tridiag":
        pf = ttri.periodic_thomas_factor(-sigma * one, (1 + 2 * sigma) * one,
                                         -sigma * one)
        want = ttri.periodic_thomas_solve(
            pf, tstencil.cn_rhs_diffusion(c, sigma))
        got = tfused.fused_cn_step(pf, sigma, c)
    else:
        pf = tpenta.periodic_penta_factor(
            sigma * one, -4 * sigma * one, (1 + 6 * sigma) * one,
            -4 * sigma * one, sigma * one)
        want = tpenta.periodic_penta_solve(
            pf, tstencil.cn_rhs_hyperdiffusion(c, sigma))
        got = tfused.fused_cn_penta_step(pf, sigma, c)
    assert got.dtype == torch.float64
    assert _rel(got, want.numpy()) <= 1e-12


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_fused_step_refuses_inputs_that_require_grad(kind):
    _, tf = _factors(kind, 16, 0.3)
    c = torch.from_numpy(_field(16, 4)).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        _STEP[kind][1](tf, 0.3, c)
    with torch.no_grad():
        assert _STEP[kind][1](tf, 0.3, c).shape == (16, 4)


def test_fused_wrappers_refuse():
    lhs, z, params = torch.ones(3, 4), torch.ones(4), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_cn_tridiag_cuda(lhs, z, params, torch.ones(4, 2))
    with pytest.raises(TypeError, match="dtype"):
        tfused.fused_cn_tridiag(lhs.double(), z, params, torch.ones(4, 2))


@pytest.mark.parametrize("kind", ("tridiag", "penta"))
def test_traffic_accounting_matches_jax(kind):
    jfn = (j_fused_cn if kind == "tridiag" else j_fused_cn_penta)
    tfn = getattr(tfused, f"{kind}_traffic_bytes")
    for n, m in ((64, 128), (512, 1 << 20)):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.float64, jnp.float64)):
            got, want = tfn(n, m, tdt), jfn.hbm_traffic_bytes(n, m, jdt)
            # JAX's keys exactly; the port's routes' keys beside them
            assert {k: got[k] for k in want} == want
            assert set(got) - set(want) == {"partition"}


# ---------------------------------------------------------------------------
# The steppers
# ---------------------------------------------------------------------------

def test_stencils_match_jax():
    c = _field(seed=2)
    for weights in ([0.3, 0.4, 0.3], [-0.1, 0.4, 0.4, 0.4, -0.1],
                    [1.0, 0.0, -2.0, 0.0, 1.0]):
        want = jstencil.apply_periodic_stencil(jnp.asarray(c), weights)
        got = tstencil.apply_periodic_stencil(torch.from_numpy(c), weights)
        assert _rel(got, want) <= 1e-6
    assert _rel(tstencil.cn_rhs_hyperdiffusion(torch.from_numpy(c), 0.2),
                jstencil.cn_rhs_hyperdiffusion(jnp.asarray(c), 0.2)) <= 1e-6


@functools.lru_cache(maxsize=None)
def _jax_diffusion(backend: str) -> np.ndarray:
    model = jpde.DiffusionCN(n=N, dt=2e-5, backend=backend)
    return np.asarray(model.run(jnp.asarray(_field()), STEPS))


# "core" is the JAX package's legacy name of the reference backend; both
# packages take it
@pytest.mark.parametrize("backend", ("reference", "core", "cuda", "auto",
                                     "fused"))
def test_diffusion_matches_jax(backend):
    model = tpde.DiffusionCN(n=N, dt=2e-5, backend=backend, device="cpu")
    got = model.run(torch.from_numpy(_field()), STEPS)
    jax_backend = backend if backend in ("reference", "core", "fused") \
        else "pallas"
    _close(got, _jax_diffusion(jax_backend))


def test_fused_diffusion_matches_analytic_decay():
    n, m, dt, steps = 128, 8, 1e-5, 400
    model = tpde.DiffusionCN(n=n, dt=dt, backend="fused", device="cpu")
    x = np.arange(n) / n
    f0 = np.tile(np.sin(2 * np.pi * x)[:, None], (1, m)).astype(np.float32)
    got = model.run(torch.from_numpy(f0), steps).numpy()
    want = np.tile(model.analytic(x, dt * steps)[:, None], (1, m))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _jax_hyperdiffusion(mode: str, backend: str) -> np.ndarray:
    """JAX's trajectory at fp64: at sigma ≈ 17 the CN operator's condition
    number is about 270, so fp32 roundings that differ between the two
    frameworks (the 4×4 inverse, the sweeps' operation order) reach
    5e-5 after 10 steps; at fp64 the algorithms are compared exactly."""
    batch = HYPER_M if mode == "batch" else None
    with _jax_x64():
        model = jpde.HyperdiffusionCN(n=N, dt=2e-6, backend=backend,
                                      mode=mode, batch=batch,
                                      dtype=jnp.float64)
        return np.asarray(model.run(jnp.asarray(_hyper_field()), 10))


def _hyper_field() -> np.ndarray:
    return _field(N, HYPER_M, k=2, noise=0.2, seed=1).astype(np.float64)


# periodic batch has no kernel in either package: auto sends it to
# reference, and backend="cuda" refuses it
@pytest.mark.parametrize("mode,backend", [
    (mode, backend) for mode in ("constant", "uniform", "batch")
    for backend in ("reference", "core", "cuda", "auto")
    if not (mode == "batch" and backend == "cuda")])
def test_hyperdiffusion_matches_jax(mode, backend):
    want = _jax_hyperdiffusion(mode, backend if backend in ("reference",
                                                            "core")
                               else "auto")
    model = tpde.HyperdiffusionCN(
        n=N, dt=2e-6, backend=backend, mode=mode, dtype=torch.float64,
        batch=HYPER_M if mode == "batch" else None, device="cpu")
    got = model.run(torch.from_numpy(_hyper_field()), 10)
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-10


def test_hyperdiffusion_has_no_fused_backend():
    model = tpde.HyperdiffusionCN(n=16, dt=1e-6, backend="fused",
                                  device="cpu")
    with pytest.raises(KeyError, match="fused"):
        model.step_fn()


@pytest.mark.parametrize("backend", ("reference", "core", "cuda", "auto"))
def test_adi2d_matches_jax(backend):
    nx, ny, b, dt, steps = 32, 24, 3, 1e-4, 10
    rng = np.random.default_rng(3)
    f0 = rng.normal(size=(nx, ny, b)).astype(np.float32)
    jax_backend = backend if backend in ("reference", "core") else "pallas"
    want = jpde.ADI2D(nx=nx, ny=ny, dt=dt, backend=jax_backend).run(
        jnp.asarray(f0), steps)
    model = tpde.ADI2D(nx=nx, ny=ny, dt=dt, backend=backend, device="cpu")
    got = model.run(torch.from_numpy(f0), steps)
    assert got.shape == (nx, ny, b)
    _close(got, want)


def test_adi2d_matches_analytic_decay():
    nx = ny = 32
    dt, steps = 1e-4, 20
    model = tpde.ADI2D(nx=nx, ny=ny, dt=dt, backend="cuda", device="cpu")
    x = (np.arange(nx) / nx)[:, None]
    y = (np.arange(ny) / ny)[None, :]
    f0 = (np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y)).astype(np.float32)
    got = model.run(torch.from_numpy(f0), steps).numpy()
    want = model.analytic(x, y, dt * steps)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


def test_steppers_default_to_cuda():
    for model in (tpde.DiffusionCN(n=8, dt=1e-4, backend="fused"),
                  tpde.HyperdiffusionCN(n=8, dt=1e-6),
                  tpde.ADI2D(nx=8, ny=8, dt=1e-4)):
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.step_fn()
    with pytest.raises(KeyError, match="pallas"):
        tpde.DiffusionCN(n=8, dt=1e-4, backend="pallas",
                         device="cpu").step_fn()
