"""BandedSystem — the problem spec consumed by ``repro_torch.solver``.

Counterpart of ``repro.solver.system``.  A ``BandedSystem`` is data: which
banded matrix (bandwidth 3 or 5), its diagonals as ``(N,)`` tensors on
one device, the boundary condition, and the paper's storage mode:

  * ``constant`` — ONE shared LHS for the whole batch
    (cuThomasConstantBatch / cuPentConstantBatch, the paper's contribution);
  * ``uniform``  — all entries of each diagonal equal (cuPentUniformBatch);
  * ``batch``    — per-system LHS copies, factor fused into every solve
    (cuThomasBatch / cuPentBatch, the prior state of the art).

The diagonals live on ``device``, which defaults to the CUDA device; a
CPU run happens only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import torch

MODES = ("constant", "uniform", "batch")
BANDWIDTHS = (3, 5)


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device; raises when CUDA is asked for and
    there is none (never a quiet CPU run)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default and this machine "
            "has none; pass device='cpu' to run the plain-torch versions")
    return device


def _as_vec(x, n: int, dtype, device) -> torch.Tensor:
    """A scalar or an (n,) diagonal as an (n,) tensor.  A tensor already of
    the right dtype and device is kept as it is, so gradients reach it."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if x.ndim == 0:
        return x.expand(n).clone()
    if x.shape != (n,):
        raise ValueError(f"diagonal has shape {tuple(x.shape)}, expected ({n},)")
    return x


@dataclasses.dataclass(frozen=True, eq=False)
class BandedSystem:
    """Spec for a batched banded solve with one (conceptual) LHS.

    ``diagonals`` are ordered sub-most first: ``(a, b, c)`` for bandwidth 3
    (``a`` sub, ``b`` main, ``c`` super) and ``(a, b, c, d, e)`` for
    bandwidth 5 (``c`` main), matching the paper's row convention.
    """

    bandwidth: int
    diagonals: tuple
    n: int
    periodic: bool = False
    mode: str = "constant"
    batch: int | None = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.bandwidth not in BANDWIDTHS:
            raise ValueError(f"bandwidth must be one of {BANDWIDTHS}, "
                             f"got {self.bandwidth}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.mode == "batch" and self.batch is None:
            raise ValueError("mode='batch' requires batch=M "
                             "(number of per-system LHS copies)")
        if self.n < self.bandwidth:
            raise ValueError(f"n={self.n} too small for bandwidth "
                             f"{self.bandwidth}")
        if len(self.diagonals) != self.bandwidth:
            raise ValueError(f"expected {self.bandwidth} diagonals, "
                             f"got {len(self.diagonals)}")

    # -- constructors -------------------------------------------------------

    @classmethod
    def _build(cls, bandwidth, diags, n, periodic, mode, batch, dtype,
               device) -> "BandedSystem":
        device = resolve_device(device)
        if n is None:
            n = torch.as_tensor(diags[bandwidth // 2]).shape[0]
        diags = tuple(_as_vec(v, n, dtype, device) for v in diags)
        return cls(bandwidth=bandwidth, diagonals=diags, n=n,
                   periodic=periodic, mode=mode, batch=batch, dtype=dtype)

    @classmethod
    def tridiag(cls, a, b, c, *, n: int | None = None, periodic: bool = False,
                mode: str = "constant", batch: int | None = None,
                dtype=torch.float32, device=None) -> "BandedSystem":
        """Tridiagonal system: a x_{i-1} + b x_i + c x_{i+1} = rhs_i."""
        return cls._build(3, (a, b, c), n, periodic, mode, batch, dtype,
                          device)

    @classmethod
    def penta(cls, a, b, c, d, e, *, n: int | None = None,
              periodic: bool = False, mode: str = "constant",
              batch: int | None = None, dtype=torch.float32,
              device=None) -> "BandedSystem":
        """Pentadiagonal system:
        a x_{i-2} + b x_{i-1} + c x_i + d x_{i+1} + e x_{i+2} = rhs_i."""
        return cls._build(5, (a, b, c, d, e), n, periodic, mode, batch,
                          dtype, device)

    # -- helpers ------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.diagonals[0].device

    @property
    def diagonal_names(self) -> tuple:
        return ("a", "b", "c") if self.bandwidth == 3 else ("a", "b", "c", "d", "e")

    def transposed(self) -> "BandedSystem":
        """The spec of A^T: diagonal k of A^T at offset ``off`` is diagonal
        ``-off`` of A rolled by ``off``.  ``transpose_solve`` does NOT use
        this (it reuses the forward factor); it is the oracle that path is
        tested against."""
        half = self.bandwidth // 2
        rolled = tuple(torch.roll(d, s, dims=0) for s, d in
                       zip(range(-half, half + 1), self.diagonals))
        return dataclasses.replace(self, diagonals=rolled[::-1])

    def describe(self) -> str:
        kind = "tridiag" if self.bandwidth == 3 else "penta"
        bc = "periodic" if self.periodic else "dirichlet"
        return f"{kind}/{bc}/{self.mode}/N={self.n}"
