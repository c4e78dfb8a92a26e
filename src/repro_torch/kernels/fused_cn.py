"""Fused periodic Crank–Nicolson steps: stencil RHS, banded solve and
periodic correction in ONE kernel (``csrc/fused_cn.cu``).

Counterpart of ``repro.kernels.fused_cn`` / ``fused_cn_penta`` and their
``ops.fused_cn_step`` / ``fused_cn_penta_step``.  The paper's pipeline is
a stencil kernel (writes the RHS), the constant-LHS solve (reads it,
writes y) and the corner correction (reads y, writes x); the fused step
reads the field and writes the next one from one kernel.

  * ``fused_cn_step(pf, sigma, c)`` — one CN diffusion step on the
    periodic tridiagonal factor ``pf`` (its core A' and the
    Sherman–Morrison terms);
  * ``fused_cn_penta_step(pf, sigma, c)`` — one CN hyperdiffusion step on
    the periodic penta factor (the rank-4 Woodbury terms);
  * ``fused_cn_tridiag`` / ``fused_cn_penta`` dispatch on where the field
    lies: a CUDA tensor goes to the kernel or raises, a CPU tensor to
    ``fused_cn_tridiag_plain`` / ``fused_cn_penta_plain`` — the kernel's
    arithmetic in the kernel's order (stencil, forward sweep, backward
    sweep, correction), not a call of the periodic solve.

The JAX package defines no VJP for these steps, so neither does the
port: a call on an input that requires grad raises.  Storage is float32
(the JAX steps' type) or float64.
"""

from __future__ import annotations

import torch

from . import ops as _ops

_FUSED_DTYPES = {torch.float32: 0, torch.float64: 1}


def _refuse_grad(name: str, tensors) -> None:
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the fused CN step has no backward (nor "
                           "has the JAX package's); call it on tensors that "
                           "do not require grad, or under torch.no_grad()")


def tridiag_params(pf, sigma: float, dtype) -> torch.Tensor:
    """(8,) ``[sl, sc, sr, v_last, inv_sm, 0, 0, 0]``: the explicit CN
    stencil (σ, 1−2σ, σ) and the Sherman–Morrison scalars, on the factor's
    device (no host sync)."""
    dev = pf.z.device
    stencil = torch.tensor([sigma, 1 - 2 * sigma, sigma], dtype=dtype,
                           device=dev)
    sm = torch.stack([torch.as_tensor(pf.v_last), torch.as_tensor(
        pf.inv_denom_sm)]).to(dtype=dtype, device=dev)
    return torch.cat([stencil, sm, torch.zeros(3, dtype=dtype, device=dev)])


def penta_params(pf, sigma: float, dtype) -> torch.Tensor:
    """(16,) ``[w0..w4, a0, b0, a1, eN2, dN1, eN1, 0 …]``: the CN stencil
    (−σ, 4σ, 1−6σ, 4σ, −σ) and the six wrap coefficients."""
    dev = pf.Z.device
    stencil = torch.tensor([-sigma, 4 * sigma, 1 - 6 * sigma, 4 * sigma,
                            -sigma], dtype=dtype, device=dev)
    return torch.cat([stencil, pf.vcoef.to(dtype),
                      torch.zeros(5, dtype=dtype, device=dev)])


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic, one row at a time
# ---------------------------------------------------------------------------

def fused_cn_tridiag_plain(lhs, z, params, c) -> torch.Tensor:
    """lhs (3, N) ``[a, inv_denom, c_hat]`` of A', z (N,), params (8,),
    c (N, M) -> the next field (N, M)."""
    n, m = c.shape
    a, inv, chat = lhs
    sl, sc, sr, v_last, inv_sm = params[:5]
    x = torch.empty_like(c)
    dh = torch.zeros((m,), dtype=c.dtype, device=c.device)
    for i in range(n):
        r = sl * c[(i - 1) % n] + sc * c[i] + sr * c[(i + 1) % n]
        dh = (r - a[i] * dh) * inv[i]
        x[i] = dh
    y_last = dh
    y = torch.zeros_like(dh)
    for i in range(n - 1, -1, -1):
        y = x[i] - chat[i] * y
        x[i] = y
    corr = (y + v_last * y_last) * inv_sm
    return x - corr[None, :] * z[:, None]


def fused_cn_penta_plain(lhs, zz, minv, params, c) -> torch.Tensor:
    """lhs (5, N) ``[eps, beta, inv_alpha, gamma, delta]`` of A', Z (N, 4),
    Minv (4, 4), params (16,), c (N, M) -> the next field; N ≥ 2."""
    n, m = c.shape
    if n < 2:
        raise ValueError(f"fused_cn_penta: the 5-point stencil needs N >= 2, "
                         f"got {n}")
    eps, beta, inv_alpha, gamma, delta = lhs
    w = params[:5]
    a0, b0, a1, eN2, dN1, eN1 = params[5:11]
    x = torch.empty_like(c)
    g1 = g2 = torch.zeros((m,), dtype=c.dtype, device=c.device)
    for i in range(n):
        r = w[0] * c[(i - 2) % n]
        for t, off in enumerate((-1, 0, 1, 2), start=1):
            r = r + w[t] * c[(i + off) % n]
        g = (r - eps[i] * g2 - beta[i] * g1) * inv_alpha[i]
        x[i] = g
        g1, g2 = g, g1
    y1 = y2 = torch.zeros_like(g1)
    for i in range(n - 1, -1, -1):
        y = x[i] - gamma[i] * y1 - delta[i] * y2
        x[i] = y
        y1, y2 = y, y1
    y0, y_1, yN2, yN1 = x[0], x[1], x[n - 2], x[n - 1]
    vty = (a0 * yN2 + b0 * yN1, a1 * yN1, eN2 * y0, dN1 * y0 + eN1 * y_1)
    wv = []
    for r_i in range(4):
        acc = minv[r_i, 0] * vty[0]
        for c_i in range(1, 4):
            acc = acc + minv[r_i, c_i] * vty[c_i]
        wv.append(acc)
    corr = zz[:, 0:1] * wv[0]
    for k in range(1, 4):
        corr = corr + zz[:, k:k + 1] * wv[k]
    return x - corr


# ---------------------------------------------------------------------------
# Kernels and dispatch
# ---------------------------------------------------------------------------

def _launch(name: str, bandwidth: int, operands: dict,
            c: torch.Tensor) -> torch.Tensor:
    """Validate device, dtype and contiguity, then launch the ``fused_cn``
    entry point of ``csrc/fused_cn.cu`` for ``bandwidth`` (3 or 5);
    ``operands`` are lhs, z / Z, [Minv,] params in the C argument order."""
    tensors = [*operands.values(), c]
    if any(not t.is_cuda or t.device != c.device for t in tensors):
        raise ValueError(f"{name}: every operand must lie on one CUDA device")
    if c.dtype not in _FUSED_DTYPES:
        raise TypeError(f"{name}: unsupported dtype {c.dtype}; the fused "
                        "step takes float32 or float64")
    _ops.same_dtype(name, operands.values(), c)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    n, m = c.shape
    x = torch.empty_like(c)
    if m == 0:
        return x
    ptrs = [t.data_ptr() for t in operands.values()]
    if bandwidth == 3:
        ptrs.insert(2, None)   # no Minv
    fn = _ops._kernel("fused_cn")
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_FUSED_DTYPES[c.dtype], bandwidth, *ptrs, c.data_ptr(),
                x.data_ptr(), n, m, _ops.DEFAULT_THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    _ops.LAUNCHES[name] = _ops.LAUNCHES.get(name, 0) + 1
    return x


def _check_shape(name: str, c: torch.Tensor, min_n: int) -> int:
    if c.ndim != 2 or c.shape[0] < min_n:
        raise ValueError(f"{name}: c must be (N, M) with N >= {min_n}, got "
                         f"{tuple(c.shape)}")
    return c.shape[0]


def fused_cn_tridiag_cuda(lhs, z, params, c) -> torch.Tensor:
    """Launch the diffusion step of ``csrc/fused_cn.cu``."""
    n = _check_shape("fused_cn_tridiag", c, 1)
    if lhs.shape != (3, n) or z.shape != (n,) or params.shape != (8,):
        raise ValueError(f"fused_cn_tridiag: lhs (3, {n}), z ({n},) and "
                         "params (8,) expected")
    return _launch("fused_cn_tridiag", 3,
                   {"lhs": lhs, "z": z, "params": params}, c)


def fused_cn_penta_cuda(lhs, zz, minv, params, c) -> torch.Tensor:
    """Launch the hyperdiffusion step of ``csrc/fused_cn.cu``."""
    n = _check_shape("fused_cn_penta", c, 2)
    if (lhs.shape != (5, n) or zz.shape != (n, 4) or minv.shape != (4, 4)
            or params.shape != (16,)):
        raise ValueError(f"fused_cn_penta: lhs (5, {n}), Z ({n}, 4), Minv "
                         "(4, 4) and params (16,) expected")
    return _launch("fused_cn_penta", 5,
                   {"lhs": lhs, "Z": zz, "Minv": minv, "params": params}, c)


def _dispatch(name: str, cuda_fn, plain_fn, operands: tuple, c):
    """A CUDA field goes to the kernel wrapper (which validates its
    operands), a CPU field to the plain version."""
    if c.is_cuda:
        return cuda_fn(*operands, c)
    if c.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {c.device}")
    _ops.same_dtype(name, operands, c)
    return plain_fn(*operands, c)


def fused_cn_tridiag(lhs, z, params, c) -> torch.Tensor:
    """The fused diffusion step on the kernel for CUDA tensors, on the
    plain version for CPU tensors."""
    return _dispatch("fused_cn_tridiag", fused_cn_tridiag_cuda,
                     fused_cn_tridiag_plain, (lhs, z, params), c)


def fused_cn_penta(lhs, zz, minv, params, c) -> torch.Tensor:
    """The fused hyperdiffusion step on the kernel for CUDA tensors, on
    the plain version for CPU tensors."""
    return _dispatch("fused_cn_penta", fused_cn_penta_cuda,
                     fused_cn_penta_plain, (lhs, zz, minv, params), c)


def fused_cn_step(pf, sigma: float, c: torch.Tensor) -> torch.Tensor:
    """One fused periodic CN diffusion step.  ``pf`` is the periodic
    tridiagonal factor (``core.periodic_thomas_factor``) of the CN LHS,
    at c's dtype and device; c: (N, M) -> (N, M)."""
    _refuse_grad("fused_cn_step", (c, pf.factor.a, pf.factor.inv_denom,
                                   pf.factor.c_hat, pf.z, pf.v_last,
                                   pf.inv_denom_sm))
    lhs = _ops.stack_tridiag_lhs(pf.factor).contiguous()
    params = tridiag_params(pf, sigma, c.dtype)
    return fused_cn_tridiag(lhs, pf.z.contiguous(), params, c.contiguous())


def fused_cn_penta_step(pf, sigma: float, c: torch.Tensor) -> torch.Tensor:
    """One fused periodic CN hyperdiffusion step.  ``pf`` is the periodic
    penta factor (``core.periodic_penta_factor``); c: (N, M) -> (N, M)."""
    f = pf.factor
    _refuse_grad("fused_cn_penta_step", (c, f.eps, f.beta, f.inv_alpha,
                                         f.gamma, f.delta, pf.Z, pf.Minv,
                                         pf.vcoef))
    lhs = _ops.stack_penta_lhs(f).contiguous()
    params = penta_params(pf, sigma, c.dtype)
    return fused_cn_penta(lhs, pf.Z.contiguous(), pf.Minv.contiguous(),
                          params, c.contiguous())


def tridiag_traffic_bytes(n: int, m: int, dtype=torch.float32) -> dict:
    """Bytes of one CN diffusion step, fused (the field read once, the next
    written once, the factor and the parameters read once) against the
    paper's three-kernel pipeline: ``repro.kernels.fused_cn``'s
    ``hbm_traffic_bytes``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {"fused": (2 * n * m + 4 * n + 8) * itemsize,
            "unfused_pipeline": (6 * n * m + 4 * n + 8) * itemsize}


def penta_traffic_bytes(n: int, m: int, dtype=torch.float32) -> dict:
    """The same for one CN hyperdiffusion step:
    ``repro.kernels.fused_cn_penta``'s ``hbm_traffic_bytes``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {"fused": (2 * n * m + 9 * n + 32) * itemsize,
            "unfused_pipeline": (6 * n * m + 9 * n + 32) * itemsize}
