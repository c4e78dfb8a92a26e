"""The gated recurrences of repro_torch against the JAX package.

On the same numpy inputs, made from a seed, at N = 37 and a ragged M = 19
(the sizes of ``tests/test_recurrence.py``):

  * the port's ``scan``, ``assoc`` and ``cuda`` methods (``cuda`` runs the
    kernel's plain version on CPU tensors) against JAX's ``pallas`` method
    in interpret mode and its ``assoc`` method, over (order × reverse × h0
    × dtype).  Tolerances: max|Δ| ≤ 1e-5·max|h| at fp32, 2e-2 for bf16
    operands (the bar of ``tests/test_recurrence.py``: JAX carries bf16,
    the port's kernel fp32);
  * the dtype rules (``torch.promote_types`` against ``jnp.result_type``),
    the ``auto`` policy, shared (N,) and singleton-broadcast gates;
  * ``loss.backward()`` through the ``cuda`` method against ``jax.grad``
    of JAX's ``pallas`` method within 1e-5 at fp32, the h0 cotangents and
    the gradients of broadcast gates (summed back to the gate's shape)
    included; the edge sizes N = 1, 2 against autograd through the
    port's own scan loop;
  * ``ops.recurrence``'s host-side h0 fold against JAX's, and the
    recurrence specs' structure and byte accounting against the JAX
    engine's.

The kernel itself is held against this plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import recurrence as jrec
from repro.kernels import engine as jengine
from repro.kernels import ops as jops
from repro_torch.core import recurrence as trec
from repro_torch.kernels import engine as tengine
from repro_torch.kernels import ops as tops

N, M = 37, 19
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(order: int, dtype: str, seed: int, n: int = N, m: int = M):
    """(gates, q, h0) as numpy float32, rounded to ``dtype``'s values."""
    rng = np.random.default_rng(seed)
    scales = (0.9,) if order == 1 else (0.6, 0.3)
    gates = [rng.uniform(-sc, sc, (n, m)).astype(np.float32) for sc in scales]
    q = rng.normal(size=(n, m)).astype(np.float32)
    h0 = [(rng.normal(size=m) * 0.5).astype(np.float32) for _ in range(order)]
    if dtype == "bfloat16":
        rnd = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16),
                                   np.float32)
        gates, q, h0 = [rnd(g) for g in gates], rnd(q), [rnd(h) for h in h0]
    return gates, q, h0


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(_TORCH[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(_JNP[dtype])


@functools.lru_cache(maxsize=None)
def _jax_result(order: int, reverse: bool, with_h0: bool, dtype: str,
                method: str):
    gates, q, h0 = _operands(order, dtype, seed=3 + order)
    fn = jrec.linear_recurrence if order == 1 else jrec.linear_recurrence2
    seeds = None
    if with_h0:
        seeds = _j(h0[0], dtype) if order == 1 else tuple(
            _j(h, dtype) for h in h0)
    out = fn(*(_j(g, dtype) for g in gates), _j(q, dtype), seeds,
             reverse=reverse, method=method, interpret=True)
    assert out.dtype == _JNP[dtype]
    return np.asarray(out.astype(jnp.float32))


def _port(order, gates, q, h0, dtype, reverse, method):
    fn = trec.linear_recurrence if order == 1 else trec.linear_recurrence2
    seeds = None
    if h0 is not None:
        seeds = _t(h0[0], dtype) if order == 1 else tuple(
            _t(h, dtype) for h in h0)
    return fn(*(_t(g, dtype) for g in gates), _t(q, dtype), seeds,
              reverse=reverse, method=method)


# ---------------------------------------------------------------------------
# Forward parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("method", ("scan", "assoc", "cuda"))
@pytest.mark.parametrize("order", (1, 2))
def test_methods_match_jax(order, method, reverse, with_h0, dtype):
    gates, q, h0 = _operands(order, dtype, seed=3 + order)
    tops.reset_launches()
    got = _port(order, gates, q, h0 if with_h0 else None, dtype, reverse,
                method)
    assert tops.LAUNCHES == {}, "a CPU run counted a kernel launch"
    assert got.shape == (N, M) and got.dtype == _TORCH[dtype]
    for jax_method in ("pallas", "assoc"):
        want = _jax_result(order, reverse, with_h0, dtype, jax_method)
        assert _rel(got, want) <= TOL[dtype], jax_method


@pytest.mark.parametrize("n", (1, 2, 3))
@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("order", (1, 2))
def test_edge_sizes_match_jax(order, reverse, n):
    gates, q, h0 = _operands(order, "float32", seed=40 + n, n=n, m=5)
    fn = jrec.linear_recurrence if order == 1 else jrec.linear_recurrence2
    seeds = _j(h0[0]) if order == 1 else tuple(_j(h) for h in h0)
    want = fn(*(_j(g) for g in gates), _j(q), seeds, reverse=reverse,
              method="pallas", interpret=True)
    for method in ("scan", "assoc", "cuda"):
        got = _port(order, gates, q, h0, "float32", reverse, method)
        assert _rel(got, want) <= TOL["float32"], method


def test_dtype_promotion_matches_jax():
    pairs = [("float32", "bfloat16"), ("bfloat16", "float32"),
             ("bfloat16", "bfloat16"), ("float32", "float32"),
             ("int32", "float32"), ("int32", "int32"),
             ("float16", "bfloat16")]
    for a, b in pairs:
        want = jnp.result_type(jnp.dtype(a), jnp.dtype(b))
        got = torch.promote_types(getattr(torch, a), getattr(torch, b))
        assert str(got).removeprefix("torch.") == str(want), (a, b)


@pytest.mark.parametrize("method", ("scan", "assoc", "cuda"))
def test_mixed_dtype_promotes_like_jax(method):
    """bf16 operand + fp32 gate computes (and returns) fp32."""
    rng = np.random.default_rng(9)
    p = rng.uniform(-0.9, 0.9, N).astype(np.float32)
    q = rng.normal(size=(N, M)).astype(np.float32)
    want = jrec.linear_recurrence(_j(p), _j(q, "bfloat16"), method="pallas",
                                  interpret=True)
    got = trec.linear_recurrence(_t(p), _t(q, "bfloat16"), method=method)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got, want) <= TOL["float32"]


@pytest.mark.parametrize("gate_shape", ((N,), (N, 1, 5), (N, 3, 1)))
@pytest.mark.parametrize("method", ("assoc", "cuda", "auto"))
def test_broadcast_gates_match_jax(method, gate_shape):
    rng = np.random.default_rng(11)
    p = rng.uniform(-0.9, 0.9, gate_shape).astype(np.float32)
    q = rng.normal(size=(N, 3, 5)).astype(np.float32)
    want = jrec.linear_recurrence(_j(p), _j(q), method="pallas",
                                  interpret=True)
    got = trec.linear_recurrence(_t(p), _t(q), method=method)
    assert got.shape == (N, 3, 5)
    assert _rel(got, want) <= TOL["float32"]


def test_auto_policy_matches_jax():
    """``cuda`` is the port's name for JAX's ``pallas``."""
    rename = {"pallas": "cuda", "scan": "scan"}
    for name in ("float32", "bfloat16", "float16", "int32", "bool"):
        want = rename[jrec._resolve("auto", jnp.dtype(name))]
        assert trec._resolve("auto", getattr(torch, name)) == want, name
    assert trec._resolve("auto", torch.float64) == "cuda"
    with pytest.raises(ValueError, match="unknown method"):
        trec._resolve("woops", torch.float32)


@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("order", (1, 2))
def test_float16_kernel_method_matches_jax(order, reverse):
    """fp16 operands take the kernel under ``auto`` in both packages; both
    carry fp32 and store h at fp16, so they agree within about two fp16
    ulps (2e-3·max|h|)."""
    gates, q, h0 = _operands(order, "float32", seed=60 + order)
    gates, q, h0 = ([g.astype(np.float16) for g in gates],
                    q.astype(np.float16), [h.astype(np.float16) for h in h0])
    jfn = jrec.linear_recurrence if order == 1 else jrec.linear_recurrence2
    tfn = trec.linear_recurrence if order == 1 else trec.linear_recurrence2
    jseeds = (jnp.asarray(h0[0]) if order == 1
              else tuple(jnp.asarray(h) for h in h0))
    want = jfn(*map(jnp.asarray, gates), jnp.asarray(q), jseeds,
               reverse=reverse, method="auto", interpret=True)
    tseeds = (torch.from_numpy(h0[0]) if order == 1
              else tuple(map(torch.from_numpy, h0)))
    got = tfn(*map(torch.from_numpy, gates), torch.from_numpy(q), tseeds,
              reverse=reverse, method="auto")
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert _rel(got, np.asarray(want.astype(jnp.float32))) <= 2e-3


def test_integer_recurrence_stays_exact_on_scan():
    p = torch.full((4,), 2, dtype=torch.int32)
    q = torch.ones((4, 2), dtype=torch.int32)
    got = trec.linear_recurrence(p, q, method="auto")
    assert got.dtype == torch.int32
    assert got.tolist() == [[1, 1], [3, 3], [7, 7], [15, 15]]


@pytest.mark.parametrize("knob", ("unroll", "block_m", "block_n",
                                  "interpret"))
def test_tpu_knobs_are_not_accepted(knob):
    p, q = torch.zeros(3), torch.zeros(3, 2)
    with pytest.raises(TypeError):
        trec.linear_recurrence(p, q, method="cuda", **{knob: 1})


# ---------------------------------------------------------------------------
# Gradients: loss.backward() through the cuda method vs jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("order", (1, 2))
def test_grads_match_jax_grad(order, reverse):
    gates, q, h0 = _operands(order, "float32", seed=17 + order)
    jfn = jrec.linear_recurrence if order == 1 else jrec.linear_recurrence2

    def jloss(*args):
        *gq, s0, s1 = args if order == 2 else (*args, None)
        seeds = s0 if order == 1 else (s0, s1)
        h = jfn(*gq, seeds, reverse=reverse, method="pallas", interpret=True)
        return jnp.sum(jnp.cos(h))

    jargs = [_j(a) for a in (*gates, q, *h0)]
    want = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)

    leaves = [_t(a).requires_grad_() for a in (*gates, q, *h0)]
    seeds = leaves[-1] if order == 1 else tuple(leaves[-2:])
    fn = trec.linear_recurrence if order == 1 else trec.linear_recurrence2
    h = fn(*leaves[:order + 1], seeds, reverse=reverse, method="cuda")
    h.cos().sum().backward()
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= 1e-5


@pytest.mark.parametrize("gate_shape", ((N,), (N, 2, 3, 1, 1)))
def test_broadcast_gate_grads_sum_to_the_gate_shape(gate_shape):
    """A shared (N,) gate, and the SSD inter-chunk decay (nc, B, H, 1, 1)
    broadcast over (P, state): the gate's gradient has the gate's shape
    and equals ``jax.grad``'s."""
    rng = np.random.default_rng(23)
    p = rng.uniform(0.0, 1.0, gate_shape).astype(np.float32)
    q_shape = (N, 6) if len(gate_shape) == 1 else (N, 2, 3, 4, 5)
    q = rng.normal(size=q_shape).astype(np.float32)

    def jloss(p_, q_):
        h = jrec.linear_recurrence(p_, q_, method="pallas", interpret=True)
        return jnp.sum(h * h)

    gp, gq = jax.grad(jloss, argnums=(0, 1))(_j(p), _j(q))
    tp, tq = _t(p).requires_grad_(), _t(q).requires_grad_()
    h = trec.linear_recurrence(tp, tq, method="cuda")
    (h * h).sum().backward()
    assert tp.grad.shape == gate_shape
    assert _rel(tp.grad, gp) <= 1e-5
    assert _rel(tq.grad, gq) <= 1e-5


@pytest.mark.parametrize("n", (1, 2))
@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("order", (1, 2))
def test_edge_size_grads_match_autograd_through_the_scan(order, reverse, n):
    """At N = 1 and 2 the adjoint's edge terms (the ``n > 1`` guard of
    dh_{-1}, the lag-2 seed rows) against autograd through the port's own
    scan loop, an oracle with no hand-written backward."""
    gates, q, h0 = _operands(order, "float32", seed=60 + n, n=n, m=4)
    fn = trec.linear_recurrence if order == 1 else trec.linear_recurrence2
    grads = {}
    for method in ("scan", "cuda"):
        leaves = [_t(a).double().requires_grad_() for a in (*gates, q, *h0)]
        seeds = leaves[-1] if order == 1 else tuple(leaves[-2:])
        h = fn(*leaves[:order + 1], seeds, reverse=reverse, method=method)
        h.sin().sum().backward()
        grads[method] = [leaf.grad for leaf in leaves]
    for got, want in zip(grads["cuda"], grads["scan"]):
        assert _rel(got, want.numpy()) <= 1e-12


# ---------------------------------------------------------------------------
# The kernel layer: host-side h0 fold, specs, dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (1, 2, N))
@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("order", (1, 2))
def test_ops_recurrence_h0_fold_matches_jax(order, reverse, n):
    gates, q, h0 = _operands(order, "float32", seed=80 + n, n=n)
    seeds = h0[0] if order == 1 else tuple(h0)
    jseeds = _j(seeds) if order == 1 else tuple(_j(h) for h in seeds)
    want = jops.recurrence(*(_j(g) for g in gates), _j(q), h0=jseeds,
                           reverse=reverse, interpret=True)
    tseeds = _t(seeds) if order == 1 else tuple(_t(h) for h in seeds)
    got = tops.recurrence(*(_t(g) for g in gates), _t(q), h0=tseeds,
                          reverse=reverse)
    assert _rel(got, want) <= TOL["float32"]


def test_recurrence_specs_match_jax():
    names = sorted(n for n, s in tengine.REGISTRY.items()
                   if s.layout == "recurrence")
    assert names == ["recur1", "recur1_rev", "recur2", "recur2_rev"]
    table = {k: (tuple(map(tuple, v.terms)), v.scale)
             for k, v in tengine.recurrence_table().items()}
    for name in names:
        spec, jspec = tengine.REGISTRY[name], jengine.REGISTRY[name]
        assert (spec.order, spec.reverse, spec.mode, spec.lhs_rows) == (
            jspec.order, jspec.reverse, jspec.mode, jspec.lhs_rows)
        (jpass,) = jspec.passes()
        assert table[spec.order] == (tuple(map(tuple, jpass.terms)),
                                     jpass.scale)
        for n, m in ((1, 1), (4096, 65536), (64, 1572864)):
            assert spec.traffic_words(n, m) == jspec.traffic_words(n, m)
        assert spec.traffic_bytes(512, 4096, torch.float32) == \
            jspec.traffic_bytes(512, 4096, jnp.float32)
        assert spec.traffic_bytes(512, 4096, torch.float32,
                                  torch.bfloat16) == \
            jspec.traffic_bytes(512, 4096, jnp.float32, jnp.bfloat16)
        assert tengine.find_recurrence_spec(
            spec.order, reverse=spec.reverse) == spec
    with pytest.raises(ValueError, match="order"):
        tengine.find_recurrence_spec(3)


def test_recurrence_wrappers_refuse():
    spec = tengine.find_recurrence_spec(1)
    with pytest.raises(ValueError, match="CUDA"):
        tops.recurrence_cuda(spec, [torch.zeros(3, 2)], torch.zeros(3, 2))
    with pytest.raises(TypeError, match="dtype"):
        tops.recurrence_sweep(spec, [torch.zeros(3, 2, dtype=torch.float64)],
                              torch.zeros(3, 2))
    with pytest.raises(ValueError, match="operands"):
        tops.recurrence(torch.zeros(3, 2))
    with pytest.raises(ValueError, match="h0"):
        tops.recurrence(torch.zeros(3, 2), torch.zeros(3, 2),
                        h0=(torch.zeros(2), torch.zeros(2)))
