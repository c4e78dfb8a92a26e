"""The plain references: held against independent computations at tiny
sizes, and free of the program and of JAX."""

import ast

import numpy as np
import pytest
import torch

from benchkit import manifest

REFS = sorted((manifest.BENCH / "configs").glob("*_ref.py"))


@pytest.mark.parametrize("path", REFS, ids=lambda p: p.name)
def test_reference_imports_only_torch_and_the_standard_library(path):
    allowed = {"__future__", "math", "torch"}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "no relative imports"
            names = [node.module]
        else:
            continue
        assert {n.split(".")[0] for n in names} <= allowed, names


def _cn():
    return manifest.reference(manifest.BENCH / "configs" /
                              "cn-diffusion.json")


def test_cn_step_matches_a_dense_fp64_solve():
    """x = A^{-1} B f against numpy's dense solve of the periodic CN
    system built entry by entry."""
    ref = _cn()
    n, m, s = 12, 7, 0.4
    rng = np.random.default_rng(0)
    f = rng.standard_normal((n, m))
    a = np.zeros((n, n))
    b = np.zeros((n, n))
    for i in range(n):
        a[i, i], a[i, (i - 1) % n], a[i, (i + 1) % n] = 1 + 2 * s, -s, -s
        b[i, i], b[i, (i - 1) % n], b[i, (i + 1) % n] = 1 - 2 * s, s, s
    want = np.linalg.solve(a, b @ f)
    got = ref.step_matrix(n, s) @ torch.from_numpy(f)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_cn_step_damps_each_fourier_mode_by_its_factor():
    ref = _cn()
    n, s = 32, 0.4
    x = np.arange(n)
    t = ref.step_matrix(n, s)
    for k in (1, 3, 16):
        mode = torch.from_numpy(np.cos(2 * np.pi * k * x / n))
        lam = 2 * s * (1 - np.cos(2 * np.pi * k / n))
        np.testing.assert_allclose((t @ mode).numpy(),
                                   (1 - lam) / (1 + lam) * mode.numpy(),
                                   atol=1e-12)


def test_cn_diagonal_cotangents_match_autograd_of_a_dense_solve():
    ref = _cn()
    n, m = 9, 5
    g = torch.Generator().manual_seed(1)
    diags = [torch.randn(n, generator=g, dtype=torch.float64) + c
             for c in (0.0, 4.0, 0.0)]
    d = torch.randn((n, m), generator=g, dtype=torch.float64)
    cot = torch.randn((n, m), generator=g, dtype=torch.float64)
    leaves = [x.clone().requires_grad_() for x in diags]
    i = torch.arange(n)
    a = torch.zeros((n, n), dtype=torch.float64)
    for off, v in zip(ref.OFFSETS, leaves):
        a = a.index_put((i, (i + off) % n), v)
    x = torch.linalg.solve(a, d)
    want = torch.autograd.grad(x, leaves, cot)
    lam = torch.linalg.solve(a.detach().t(), cot)
    got = ref.diagonal_cotangents(lam, x.detach())
    for w, h in zip(want, got):
        torch.testing.assert_close(h, w, rtol=1e-10, atol=1e-10)


def _mamba():
    return manifest.reference(manifest.BENCH / "configs" /
                              "mamba2-130m.json")


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_by_chunks_matches_the_sequential_scan(chunk):
    ref = _mamba()
    g = torch.Generator().manual_seed(2)
    b, s, h, p, n = 2, 32, 3, 4, 5
    x = torch.randn((b, s, h, p), generator=g, dtype=torch.float64)
    dt = torch.rand((b, s, h), generator=g, dtype=torch.float64) * 0.5
    a = torch.rand((h,), generator=g, dtype=torch.float64) * 2
    bm = torch.randn((b, s, n), generator=g, dtype=torch.float64)
    cm = torch.randn((b, s, n), generator=g, dtype=torch.float64)
    state = torch.zeros((b, h, p, n), dtype=torch.float64)
    ys = []
    for t in range(s):
        decay = torch.exp(-a * dt[:, t])[:, :, None, None]
        state = decay * state + (dt[:, t, :, None, None]
                                 * x[:, t, :, :, None]
                                 * bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    y, last = ref.ssd(x, dt, a, bm, cm, q=chunk)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-10,
                               atol=1e-10)
    torch.testing.assert_close(last, state, rtol=1e-10, atol=1e-10)


def test_reference_train_step_moves_every_leaf(tiny):
    """Three reference steps from the benchmark's weights: the losses are
    finite and every leaf's first gradient and change are above zero."""
    from benchkit import lm
    config, workload, ref = tiny("mamba2-130m.train_4k")
    params = lm.make_params(config, 3, "cpu")
    toks = torch.randint(0, config["vocab_size"], (2, 33),
                         generator=torch.Generator().manual_seed(4))
    out = ref.train_steps(params, [toks] * 3, workload["optimizer"], config,
                          rows=1)
    assert all(np.isfinite(out["losses"]))
    assert min(out["grad_norms"]) > 0 and min(out["change_norms"]) > 0
    assert out["paths"] == [p for p, _ in lm.leaves(params)]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_token_stream_is_the_synthetic_lm_stream(seed):
    """The benchmark makes its training batches itself, as a frozen copy
    of the port's ``SyntheticLM`` stream: the same tokens, and labels that
    are the next tokens of the same sequence."""
    from benchkit import lm
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(vocab=97, seq_len=40, global_batch=3, seed=seed)
    for step in (0, 7):
        seq = lm.token_stream(97, 40, 3, seed, step)
        want = data.batch_at(step, device="cpu")
        assert torch.equal(seq[:, :-1], want["tokens"])
        assert torch.equal(seq[:, 1:], want["labels"])

