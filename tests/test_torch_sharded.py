"""The port's ``sharded`` solver backend on a 4-rank gloo group on the CPU.

One group of four child processes (``init_method="file://…"``) runs every
case; the test process holds their results against the JAX package's
``factorize(system, backend="sharded", kernels="reference")`` on the
conftest's 4 host devices (the same shard count), and each rank's columns
against the port's single-process ``cuda`` backend (its plain versions on
the CPU), bit for bit.  Inputs come from numpy seeds.

  * every (bandwidth ∈ {3, 5}, periodic, mode) combination at N 64 and
    M 24 (divisible by 4) and 26 (ragged: uneven shards of 7, 7, 7, 5),
    fp32, and three at fp64: ``solve`` and ``transpose_solve`` within 1e-5
    (fp32) / 1e-12 (fp64) of JAX, the diagonals' and the rhs's gradients
    within the same of ``jax.grad`` through JAX's sharded backend;
  * the only collective of a solve and its backward, for a DTensor rhs,
    is the diagonal gradient's one all-reduce;
  * an (N,) rhs at N 16, solved as one column and returned (N,), with
    its gradients, against JAX's;
  * the ``kernels`` policy, the override that raises, ``"pallas"``, the
    TPU knobs and the error without a process group.
"""

from __future__ import annotations

import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp

from repro.solver import BandedSystem as JaxSystem
from repro.solver import factorize as jax_factorize
from repro.solver import solve as jax_solve
from repro.solver import transpose_solve as jax_transpose_solve
from repro_torch.solver import (BandedSystem, factorize, plan, solve,
                                transpose_solve, with_options)

WORLD = 4
N = 64
TIMEOUT = 180                        # seconds for the whole group
FP32 = [(bw, periodic, mode, m, "float32")
        for bw in (3, 5) for periodic in (False, True)
        for mode in ("constant", "uniform", "batch") for m in (24, 26)]
FP64 = [(3, True, "constant", 26, "float64"),
        (5, False, "batch", 26, "float64"),
        (5, True, "uniform", 24, "float64")]
CASES = FP32 + FP64
TOL = {"float32": 1e-5, "float64": 1e-12}
N1 = 16                              # the (N,) rhs case


def case_id(case) -> str:
    bw, periodic, mode, m, dtype = case
    bc = "periodic" if periodic else "dirichlet"
    return f"{'tri' if bw == 3 else 'penta'}-{bc}-{mode}-M{m}-{dtype}"


def inputs(case) -> dict:
    """Diagonals (diagonally dominant), rhs and the loss weight w, from a
    numpy seed of the case."""
    bw, periodic, mode, m, dtype = case
    rng = np.random.default_rng(1000 * bw + 10 * m + 2 * periodic
                                + ("constant", "uniform", "batch").index(mode))
    if mode == "uniform":
        vals = ((-0.37, 1.74, -0.37) if bw == 3
                else (0.11, -0.44, 1.66, -0.44, 0.11))
        diags = [np.full(N, v) for v in vals]
    elif bw == 3:
        a, c = rng.uniform(-1, 1, N), rng.uniform(-1, 1, N)
        diags = [a, np.abs(a) + np.abs(c) + 2.5, c]
    else:
        a, b, d, e = (rng.uniform(-1, 1, N) for _ in range(4))
        diags = [a, b, np.abs(a) + np.abs(b) + np.abs(d) + np.abs(e) + 4.0,
                 d, e]
    return {"diags": [v.astype(dtype) for v in diags],
            "rhs": rng.normal(size=(N, m)).astype(dtype),
            "w": rng.normal(size=(N, m)).astype(dtype)}


# -- the ranks ----------------------------------------------------------------

def _collectives(fn):
    """(result of fn(), names of the c10d ops it dispatched)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "c10d" in str(func):
                ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, ops


def _torch_system(case, diags):
    bw, periodic, mode, m, dtype = case
    ctor = BandedSystem.tridiag if bw == 3 else BandedSystem.penta
    return ctor(*diags, n=N, periodic=periodic, mode=mode,
                batch=m if mode == "batch" else None,
                dtype=getattr(torch, dtype), device="cpu")


def _rank_case(case) -> dict:
    """One case on this rank: the sharded solve, its adjoint and
    gradients, and the single-process backend on the full M."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.solver.sharded import lane_range

    data = inputs(case)
    diags = [torch.from_numpy(v).requires_grad_() for v in data["diags"]]
    system = _torch_system(case, diags)
    rhs_full = torch.from_numpy(data["rhs"])
    fact = factorize(system, backend="sharded")
    mesh = fact.meta.opt("mesh")
    lo, hi = lane_range(rhs_full.shape[1], mesh, "batch")
    rhs = distribute_tensor(rhs_full, mesh.device_mesh,
                            mesh.placements((None, "batch")),
                            src_data_rank=None).requires_grad_()
    w = torch.from_numpy(data["w"])[:, lo:hi]

    def forward_backward():
        x = solve(fact, rhs)
        (x.to_local() * w).sum().backward()
        return x

    x, ops = _collectives(forward_backward)
    lam = transpose_solve(fact, rhs.detach())
    single = factorize(system, backend=fact.meta.opt("kernels"))
    x1 = solve(single, rhs_full).detach()
    lam1 = transpose_solve(single, rhs_full)
    out = {
        "lo": lo, "hi": hi, "kernels": fact.meta.opt("kernels"),
        "x_is_dtensor": isinstance(x, DTensor),
        "x_shape": tuple(x.shape), "placements": str(x.placements),
        "x": x.to_local().detach().numpy(),
        "lam": lam.to_local().numpy(),
        "rhs_grad_is_dtensor": isinstance(rhs.grad, DTensor),
        "rhs_grad": rhs.grad.to_local().numpy(),
        "diag_grads": [d.grad.numpy() for d in diags],
        "x_single": x1[:, lo:hi].numpy(),
        "lam_single": lam1[:, lo:hi].numpy(),
        "collectives": ops,
    }
    if case[2] == "batch":
        out["stored_local"] = [tuple(v.to_local().shape)
                               for v in fact.stored.values()]
    return out


def _rank_plain_rhs() -> dict:
    """A plain rhs that requires grad: x is still a DTensor, and the
    rhs's gradient comes back whole, bit for bit the single-process λ."""
    case = (3, True, "constant", 26, "float32")
    data = inputs(case)
    system = _torch_system(case, [torch.from_numpy(v) for v in data["diags"]])
    fact = factorize(system, backend="sharded")
    rhs = torch.from_numpy(data["rhs"]).requires_grad_()
    solve(fact, rhs).to_local().sum().backward()
    single = factorize(system, backend="cuda")
    ones = torch.ones(N, 26)
    return {"grad_type": type(rhs.grad).__name__,
            "grad": rhs.grad.numpy(),
            "want": transpose_solve(single, ones).numpy()}


def _rank_policies() -> dict:
    """The ``kernels`` policy, resolved at factorize time."""
    out = {}
    tri = inputs((3, False, "constant", 24, "float32"))["diags"]
    system = BandedSystem.tridiag(*tri, n=N, device="cpu")
    rhs = torch.ones(N, 24)
    out["auto"] = factorize(system, backend="sharded").meta.opt("kernels")
    ref = factorize(system, backend="sharded", kernels="reference")
    out["reference"] = ref.meta.opt("kernels")
    out["reference_x"] = solve(ref, rhs).to_local().numpy()
    out["reference_want"] = solve(factorize(system, backend="reference"),
                                  rhs)[:, :6].numpy()
    messages = []
    for fact, flip in ((ref, "cuda"),
                       (factorize(system, backend="sharded"), "reference")):
        try:
            solve(with_options(fact, kernels=flip), rhs)
        except ValueError as exc:
            messages.append(str(exc))
    out["override"] = messages
    periodic_batch = BandedSystem.tridiag(*tri, n=N, periodic=True,
                                          mode="batch", batch=24,
                                          device="cpu")
    out["periodic_batch_auto"] = factorize(
        periodic_batch, backend="sharded").meta.opt("kernels")
    try:
        factorize(periodic_batch, backend="sharded", kernels="cuda")
        out["periodic_batch_cuda"] = "no error"
    except NotImplementedError as exc:
        out["periodic_batch_cuda"] = str(exc)
    p = plan(system, backend="sharded")
    out["plan"] = (p.backend, p.impl.n_shards, p.impl.batch_axis,
                   p.impl.kernels)
    out["plan_x"] = p.solve(rhs).to_local().numpy()
    return out


def _one_dim_inputs() -> dict:
    """A constant tridiagonal system at N1 and an (N1,) rhs and loss
    weight, from a numpy seed."""
    rng = np.random.default_rng(16)
    a, c = rng.uniform(-1, 1, N1), rng.uniform(-1, 1, N1)
    return {"diags": [v.astype(np.float32)
                      for v in (a, np.abs(a) + np.abs(c) + 2.5, c)],
            "rhs": rng.normal(size=N1).astype(np.float32),
            "w": rng.normal(size=N1).astype(np.float32)}


def _rank_one_dim() -> dict:
    """An (N1,) rhs: solved as one column, returned (N1,), with the
    gradients of sum(x · w)."""
    data = _one_dim_inputs()
    diags = [torch.from_numpy(v).requires_grad_() for v in data["diags"]]
    fact = factorize(BandedSystem.tridiag(*diags, n=N1, device="cpu"),
                     backend="sharded")
    rhs = torch.from_numpy(data["rhs"]).requires_grad_()
    x = solve(fact, rhs)
    (x.to_local() * torch.from_numpy(data["w"])).sum().backward()
    lam = transpose_solve(fact, rhs.detach())
    return {"shape": tuple(x.shape), "lam_shape": tuple(lam.shape),
            "x": x.to_local().detach().numpy(), "lam": lam.to_local().numpy(),
            "rhs_grad": rhs.grad.numpy(),
            "diag_grads": [d.grad.numpy() for d in diags]}


def _worker(rank: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=WORLD)
        results = {"cases": {case_id(c): _rank_case(c) for c in CASES},
                   "plain_rhs": _rank_plain_rhs(),
                   "policies": _rank_policies(),
                   "one_dim": _rank_one_dim()}
        torch.save(results, Path(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except Exception:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_group(worker, tmp: Path) -> list:
    """Start ``worker(rank, init_file, out_dir)`` in WORLD spawned child
    processes, which meet through a file under ``tmp``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(r, str(tmp / "pg_init"),
                                              str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def join_group(procs, tmp: Path, started: float,
               timeout: float = TIMEOUT) -> list:
    """Each rank's saved results; fails on a rank that exits non-zero or
    outlives ``timeout`` from ``started`` (then every rank is killed)."""
    for p in procs:
        p.join(max(1.0, started + timeout - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = [f.read_text() for f in sorted(tmp.glob("rank*.err"))]
    assert not alive, f"{len(alive)} ranks outlived {timeout} s\n{errors}"
    assert all(p.exitcode == 0 for p in procs), "\n".join(errors)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# -- the JAX side -------------------------------------------------------------

def _jax_case(case) -> dict:
    """x, λ and the gradients of sum(x · w) through JAX's sharded backend,
    in one jitted function (the factorization inside it)."""
    bw, periodic, mode, m, dtype = case
    data = inputs(case)
    ctor = JaxSystem.tridiag if bw == 3 else JaxSystem.penta
    jdt = jnp.float64 if dtype == "float64" else jnp.float32

    def fact_of(diags):
        system = ctor(*diags, n=N, periodic=periodic, mode=mode,
                      batch=m if mode == "batch" else None, dtype=jdt)
        return jax_factorize(system, backend="sharded", kernels="reference")

    @jax.jit
    def run(diags, rhs, w):
        fact = fact_of(diags)

        def loss(diags, r):
            return jnp.sum(jax_solve(fact_of(diags), r) * w)

        grads = jax.grad(loss, argnums=(0, 1))(diags, rhs)
        return (jax_solve(fact, rhs), jax_transpose_solve(fact, rhs),
                grads)

    x, lam, (g_diags, g_rhs) = run(tuple(map(jnp.asarray, data["diags"])),
                                   jnp.asarray(data["rhs"]),
                                   jnp.asarray(data["w"]))
    return {"x": np.asarray(x), "lam": np.asarray(lam),
            "diag_grads": [np.asarray(g) for g in g_diags],
            "rhs_grad": np.asarray(g_rhs)}


def _jax_one_dim() -> dict:
    """x, λ and the gradients of sum(x · w) for the (N1,) rhs through
    JAX's sharded backend."""
    data = _one_dim_inputs()

    @jax.jit
    def run(diags, rhs, w):
        def fact_of(diags):
            return jax_factorize(JaxSystem.tridiag(*diags, n=N1),
                                 backend="sharded", kernels="reference")

        def loss(diags, r):
            return jnp.sum(jax_solve(fact_of(diags), r) * w)

        fact = fact_of(diags)
        return (jax_solve(fact, rhs), jax_transpose_solve(fact, rhs),
                jax.grad(loss, argnums=(0, 1))(diags, rhs))

    x, lam, (g_diags, g_rhs) = run(tuple(map(jnp.asarray, data["diags"])),
                                   jnp.asarray(data["rhs"]),
                                   jnp.asarray(data["w"]))
    return {"x": np.asarray(x), "lam": np.asarray(lam),
            "rhs_grad": np.asarray(g_rhs),
            "diag_grads": [np.asarray(g) for g in g_diags]}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case on the 4 ranks, and the JAX package's results meanwhile."""
    tmp = tmp_path_factory.mktemp("sharded_group")
    started = time.monotonic()
    procs = spawn_group(_worker, tmp)
    try:
        assert jax.device_count() >= WORLD, "conftest forces 4 host devices"
        want = {case_id(c): _jax_case(c) for c in FP32}
        want["one_dim"] = _jax_one_dim()
        jax.config.update("jax_enable_x64", True)
        try:
            want.update({case_id(c): _jax_case(c) for c in FP64})
        finally:
            jax.config.update("jax_enable_x64", False)
    finally:
        ranks = join_group(procs, tmp, started)
    return ranks, want


def _gathered(ranks, cid: str, key: str) -> np.ndarray:
    """The ranks' local columns of ``key`` put side by side."""
    parts = [r["cases"][cid] for r in ranks]
    assert [p["lo"] for p in parts] == sorted(p["lo"] for p in parts)
    return np.concatenate([p[key] for p in parts], axis=1)


def _close(got, want, tol) -> None:
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max|Δ| {err:.3e} > {tol:g} · {scale:.3g}"


# -- tests --------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_solve_matches_jax_sharded(group, case):
    ranks, want = group
    cid = case_id(case)
    x = _gathered(ranks, cid, "x")
    assert x.shape == (N, case[3])
    _close(x, want[cid]["x"], TOL[case[4]])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_transpose_solve_matches_jax_sharded(group, case):
    ranks, want = group
    cid = case_id(case)
    _close(_gathered(ranks, cid, "lam"), want[cid]["lam"], TOL[case[4]])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_each_rank_equals_the_single_process_backend_bitwise(group, case):
    """Each rank's columns: the same kernel (plain version) and arithmetic
    as the single-process backend, so the same bits; uneven shards cut
    as DTensor's Shard(1) does."""
    ranks, _ = group
    m = case[3]
    chunk = -(-m // WORLD)
    for r, res in enumerate(ranks):
        part = res["cases"][case_id(case)]
        assert (part["lo"], part["hi"]) == (min(r * chunk, m),
                                            min((r + 1) * chunk, m))
        assert part["x_is_dtensor"] and part["x_shape"] == (N, m)
        assert part["placements"] == "(Shard(dim=1),)"
        np.testing.assert_array_equal(part["x"], part["x_single"])
        np.testing.assert_array_equal(part["lam"], part["lam_single"])
        if case[2] == "batch":
            # each rank holds only its own systems' diagonals
            lanes = part["hi"] - part["lo"]
            assert part["stored_local"] == [(N, lanes)] * case[0]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradients_match_jax_grad(group, case):
    """The diagonals' gradients (one all-reduce over the batch axis, the
    same on every rank) and the rhs's (a DTensor like the rhs)."""
    ranks, want = group
    cid = case_id(case)
    tol = TOL[case[4]]
    for res in ranks:
        for got, jax_g in zip(res["cases"][cid]["diag_grads"],
                              want[cid]["diag_grads"]):
            _close(got, jax_g, tol)
        assert res["cases"][cid]["rhs_grad_is_dtensor"]
    _close(_gathered(ranks, cid, "rhs_grad"), want[cid]["rhs_grad"], tol)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_only_collective_is_the_gradient_all_reduce(group, case):
    ranks, _ = group
    for res in ranks:
        assert res["cases"][case_id(case)]["collectives"] == [
            "c10d.allreduce_.default"]


def test_plain_rhs_is_taken_as_replicated(group):
    """x of a plain rhs is sharded the same way, and the rhs's gradient
    comes back whole: the single-process λ, bit for bit."""
    ranks, _ = group
    for res in ranks:
        got = res["plain_rhs"]
        assert got["grad_type"] == "Tensor"
        np.testing.assert_array_equal(got["grad"], got["want"])


def test_kernels_policy_resolves_at_factorize_time(group):
    ranks, _ = group
    for res in ranks:
        pol = res["policies"]
        assert pol["auto"] == "cuda"
        assert pol["reference"] == "reference"
        assert pol["periodic_batch_auto"] == "reference"
        assert "periodic per-system-LHS" in pol["periodic_batch_cuda"]
        assert pol["plan"] == ("sharded", WORLD, "batch", "cuda")
    # the reference policy's rank-0 columns against the reference backend
    pol0 = ranks[0]["policies"]
    np.testing.assert_array_equal(pol0["reference_x"], pol0["reference_want"])
    assert pol0["plan_x"].shape == (N, 6)


def test_kernels_override_per_call_raises(group):
    ranks, _ = group
    for res in ranks:
        msgs = res["policies"]["override"]
        assert len(msgs) == 2
        assert all("resolved at factorize time" in m for m in msgs)


def test_one_dimensional_rhs_is_refused(group):
    """Not refused any more: an (N,) rhs is solved as one column and comes
    back (N,) on every rank, as JAX's sharded backend returns it; x, λ and
    the gradients within 1e-5 of JAX's (``kernels="reference"``)."""
    ranks, want = group
    want = want["one_dim"]
    for res in ranks:
        got = res["one_dim"]
        assert got["shape"] == got["lam_shape"] == (N1,)
        for key in ("x", "lam", "rhs_grad"):
            _close(got[key], want[key], 1e-5)
        for g, w in zip(got["diag_grads"], want["diag_grads"]):
            _close(g, w, 1e-5)


def _cpu_system():
    return BandedSystem.tridiag(-0.4, 1.8, -0.4, n=8, device="cpu")


def test_no_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group.*torchrun"):
        factorize(_cpu_system(), backend="sharded")
    with pytest.raises(ValueError, match="init_process_group"):
        plan(_cpu_system(), backend="sharded")


def test_pallas_policy_names_cuda():
    with pytest.raises(ValueError, match="kernels='cuda'"):
        factorize(_cpu_system(), backend="sharded", kernels="pallas")
    with pytest.raises(ValueError, match="kernels must be one of"):
        factorize(_cpu_system(), backend="sharded", kernels="nope")


@pytest.mark.parametrize("knob", ["block_m", "block_n", "fused", "prefetch",
                                  "interpret", "unroll"])
def test_tpu_knobs_raise(knob):
    with pytest.raises(TypeError, match=f"'{knob}' is not an option"):
        factorize(_cpu_system(), backend="sharded", **{knob: 1})


@pytest.mark.parametrize("mode", ["constant", "uniform", "batch"])
@pytest.mark.parametrize("periodic", [False, True])
def test_auto_never_picks_sharded(periodic, mode):
    system = BandedSystem.tridiag(-0.4, 1.8, -0.4, n=8, periodic=periodic,
                                  mode=mode,
                                  batch=4 if mode == "batch" else None,
                                  device="cpu")
    assert factorize(system, backend="auto").backend != "sharded"
