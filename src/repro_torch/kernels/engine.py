"""The sweep descriptions behind the solve kernels — as data.

Every shared-LHS banded solve (tridiagonal or pentadiagonal, constant or
uniform storage, forward or transposed) is one two-pass sweep in which
each pass is a short linear recurrence

    out_i = (in_i - sum_j coeff_j(i) * carry_j) * scale(i)

with a carry of order 1 (tridiagonal) or 2 (pentadiagonal), ascending for
forward substitution and descending for back substitution.  Only which
rows of the stacked factor feed which carry lag, and which pass holds the
stored inverse diagonal as its scale, differ between variants.

  * ``PassSpec`` — one pass: ``(coefficient row, carry lag)`` terms in
    subtraction order plus an optional scale row.
  * ``_PASS_TABLE`` — the passes of every shared variant, keyed by
    ``(bandwidth, uniform, transposed)``.  The CUDA kernel
    (``csrc/shared_sweep.cu``) and its plain version (``ops``) both take
    their arguments from this table; no variant has code of its own.
  * ``_BATCH_BWD`` — the back substitution of the batch layout
    (cuThomasBatch / cuPentBatch): each system has its own LHS, the
    factorisation is fused into the forward pass (``ops.batch_sweep_plain``
    and ``csrc/batch_sweep.cu``) and leaves ``c_hat`` (or ``gamma`` and
    ``delta``) per system, which this pass reads.
  * ``SweepSpec`` / ``find_spec`` — one variant, with the byte accounting
    (``traffic_words`` / ``traffic_bytes``) derived from its shape: the
    floor, each input read once and x written once;
  * ``route_words`` / ``route_traffic_bytes`` — the words one launch of a
    variant moves through device memory on each route of its kernel
    (``ROUTES``), derived from the CUDA sources (each method's docstring),
    given the partitioned route's row blocks; ``ops.traffic_table`` /
    ``recurrence_traffic_table`` price every variant × route at the blocks
    the route rule cuts.
  * ``_RECUR_TABLE`` / ``RecurrenceSpec`` / ``find_recurrence_spec`` — the
    gated linear recurrences (``h_i = p_i h_{i-1} + q_i`` and its order-2
    sibling): ONE pass whose coefficients are per-token (N, M) gate
    operands instead of rows of a shared factor
    (``csrc/recurrence_sweep.cu``).

The transposed variants solve A^T x = rhs from the SAME stored factor:
A = L·U means A^T = U^T·L^T, so they read shifted rows of the forward
factor (``c_hat_{i-1}``, ``a_{i+1}``, …) that ``ops`` shifts on the host.
"""

from __future__ import annotations

import dataclasses

import torch

# Sentinel coefficient source: the uniform-mode eps value, which rides in a
# 1-element device tensor (never a host float, so no device sync).
EPS_PARAM = "eps"


@dataclasses.dataclass(frozen=True)
class PassSpec:
    """One pass of a two-pass sweep.

    ``terms`` is a tuple of ``(coeff_src, carry_lag)`` pairs applied in
    SUBTRACTION ORDER.  ``coeff_src`` is a row index into the stacked LHS
    or ``EPS_PARAM``.  ``scale`` is the row that multiplies the bracketed
    result (the stored inverse diagonal); ``None`` means unscaled.
    """

    terms: tuple
    scale: object = None


# (bandwidth, uniform, transposed) -> (forward pass, backward pass).
#
# Stacked LHS row conventions (``ops.stack_*_lhs``):
#   tridiag          [a, inv_denom, c_hat]
#   tridiag^T        [c_hat_{i-1}, inv_denom, a_{i+1}]
#   penta            [eps, beta, inv_alpha, gamma, delta]
#   penta uniform    [beta, inv_alpha, gamma, delta]      (+ eps param)
#   penta^T          [delta_{i-2}, gamma_{i-1}, inv_alpha, beta_{i+1},
#                     eps_{i+2}]
#   penta^T uniform  [delta_{i-2}, gamma_{i-1}, inv_alpha, beta_{i+1}]
#                                                         (+ eps param)
_PASS_TABLE = {
    (3, False, False): (PassSpec(((0, 1),), 1), PassSpec(((2, 1),), None)),
    (3, False, True): (PassSpec(((0, 1),), None), PassSpec(((2, 1),), 1)),
    (5, False, False): (PassSpec(((0, 2), (1, 1)), 2),
                        PassSpec(((3, 1), (4, 2)), None)),
    (5, False, True): (PassSpec(((0, 2), (1, 1)), None),
                       PassSpec(((3, 1), (4, 2)), 2)),
    (5, True, False): (PassSpec(((EPS_PARAM, 2), (0, 1)), 1),
                       PassSpec(((2, 1), (3, 2)), None)),
    (5, True, True): (PassSpec(((0, 2), (1, 1)), None),
                      PassSpec(((3, 1), (EPS_PARAM, 2)), 2)),
}

# Batch-layout back substitution, by carry order: row r of the per-system
# coefficients the fused factorisation produced (c_hat, or gamma/delta).
_BATCH_BWD = {
    1: PassSpec(((0, 1),), None),
    2: PassSpec(((0, 1), (1, 2)), None),
}


# Gated-recurrence pass, by carry order.  Gate operand ``g`` multiplies the
# carry at lag ``g + 1``; there is no scale.  The JAX engine subtracts
# gates read negated (bitwise equal inside JAX); the CUDA kernel and its
# plain version add ``gate * carry`` directly, in the same term order.
_RECUR_TABLE = {
    1: PassSpec(((0, 1),), None),
    2: PassSpec(((0, 1), (1, 2)), None),
}


#: The routes of each layout's kernel, as ``ops.shared_route``,
#: ``ops.batch_route`` and ``ops.recurrence_route`` name them.
ROUTES = {"shared": ("onchip", "partition", "serial"),
          "batch": ("onchip", "stream"),
          "recurrence": ("walk", "tile")}

# The name suffix of each route's traffic entry: a JAX variant's ("" its
# resident one, "_streamed" its two-call pair) where the route moves the
# words that variant moves, else the route's own.
_ROUTE_SUFFIX = {("shared", "onchip"): "", ("shared", "serial"): "_streamed",
                 ("shared", "partition"): "_partition",
                 ("batch", "onchip"): "", ("batch", "stream"): "_streamed",
                 ("recurrence", "walk"): "", ("recurrence", "tile"): "_tile"}


def _itemsize(dtype) -> int:
    return dtype.itemsize


def shard_lanes(m: int, n_shards: int) -> int:
    """Columns of the fullest shard: M split as DTensor's ``Shard(1)``
    gives ``ceil(M / n)`` to the first shards and what is left to the
    last (the JAX package's ``kernels.common.shard_lanes``)."""
    return -(-m // n_shards)


def _check_route(layout: str, route: str) -> None:
    if route not in ROUTES[layout]:
        raise ValueError(f"no {route!r} route for the {layout} layout; its "
                         f"routes are {ROUTES[layout]}")


def compute_dtype(dtype) -> torch.dtype:
    """Accumulation dtype of a sweep over operands stored at ``dtype``:
    at least fp32 (bf16 storage computes and returns fp32)."""
    return torch.promote_types(dtype, torch.float32)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One solve variant: a shared factored LHS, or per-system LHS copies
    (``layout="batch"``)."""

    bandwidth: int            # 3 | 5
    layout: str = "shared"    # "shared" (one factored LHS) | "batch"
    transposed: bool = False  # solve A^T x = rhs from the same factor
    uniform: bool = False     # penta shared only: eps as a 1-element operand

    def __post_init__(self):
        if self.bandwidth not in (3, 5):
            raise ValueError(f"bandwidth must be 3 or 5, got {self.bandwidth}")
        if self.layout not in ("shared", "batch"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.uniform and (self.bandwidth != 5 or self.layout != "shared"):
            raise ValueError("uniform is a shared-penta concept "
                             "(cuPentUniformBatch)")
        if self.transposed and self.layout == "batch":
            raise ValueError(
                "no transposed batch sweep: rolling the per-system diagonals "
                "turns A^T into another batch system, which the forward "
                "batch sweep solves")

    @property
    def order(self) -> int:
        """Carry order of each sweep pass."""
        return 1 if self.bandwidth == 3 else 2

    @property
    def lhs_rows(self) -> int:
        """Rows of the stacked shared LHS (0 for the batch layout)."""
        if self.layout != "shared":
            return 0
        if self.bandwidth == 3:
            return 3
        return 4 if self.uniform else 5

    @property
    def n_coefs(self) -> int:
        """Per-system coefficient arrays the fused factorisation produces
        (c_hat, or gamma and delta): the batch sweep's workspace."""
        return self.order if self.layout == "batch" else 0

    @property
    def mode(self) -> str:
        if self.layout == "batch":
            return "batch"
        return "uniform" if self.uniform else "constant"

    @property
    def name(self) -> str:
        base = "thomas" if self.bandwidth == 3 else "penta"
        return f"{base}_{self.mode}" + ("_t" if self.transposed else "")

    def passes(self) -> tuple:
        """(forward PassSpec, backward PassSpec) for this variant.  The
        batch layout's forward pass is the fused factorisation, which has
        no pass table: it is ``(None, _BATCH_BWD[order])``."""
        if self.layout == "batch":
            return None, _BATCH_BWD[self.order]
        return _PASS_TABLE[(self.bandwidth, self.uniform, self.transposed)]

    # -- accounting: the least traffic the function needs ---------------------

    def storage_words(self, n: int, m: int) -> int:
        """Words read from stored operands: the RHS once, each LHS row
        once, and the eps parameter; for the batch layout, each of the
        ``bandwidth`` per-system diagonals and the RHS once."""
        if self.layout == "batch":
            return (self.bandwidth + 1) * n * m
        return n * m + self.lhs_rows * n + (1 if self.uniform else 0)

    def compute_words(self, n: int, m: int) -> int:
        """Words written at the compute dtype: x once."""
        return n * m

    def traffic_words(self, n: int, m: int) -> int:
        """The least traffic of one solve, each input read once and x
        written once: the paper's ``2NM + kN`` words for a shared LHS,
        ``(bandwidth + 2)·NM`` for per-system copies."""
        return self.storage_words(n, m) + self.compute_words(n, m)

    def traffic_bytes(self, n: int, m: int, dtype=torch.float32,
                      storage_dtype=None) -> int:
        """``traffic_words`` in bytes: stored operands at ``storage_dtype``
        (default ``dtype``), x at the compute dtype."""
        sdt = storage_dtype or dtype
        return (self.storage_words(n, m) * _itemsize(sdt)
                + self.compute_words(n, m) * _itemsize(compute_dtype(sdt)))

    def sharded_traffic_words(self, n: int, m: int, n_shards: int) -> int:
        """Words one rank moves with M sharded over ``n_shards`` ranks: the
        floor at the fullest shard's ``shard_lanes`` columns.  The solve
        has no collective; a shared factor is replicated, so its
        ``lhs_rows · N`` words do not shrink with the shards."""
        return self.traffic_words(n, shard_lanes(m, n_shards))

    # -- accounting: what each route of the kernel moves ----------------------

    def route_name(self, route: str) -> str:
        """The traffic entry of ``route``: the JAX variant's name where the
        route moves what that variant moves (``thomas_constant``,
        ``penta_uniform_streamed_t``, ``thomas_batch_streamed``…), else
        the route's own (``thomas_constant_partition``…)."""
        _check_route(self.layout, route)
        base = "thomas" if self.bandwidth == 3 else "penta"
        return (f"{base}_{self.mode}{_ROUTE_SUFFIX[self.layout, route]}"
                + ("_t" if self.transposed else ""))

    def route_words(self, n: int, m: int, route: str,
                    blocks: int = 1) -> tuple:
        """``(storage words, compute words)`` one solve moves through device
        memory on ``route`` of its kernel, each array a launch reads or
        writes counted once a launch (a factor row or the eps operand that
        every thread reads is one read).  ``blocks`` is the partitioned
        route's row blocks B.  From the CUDA sources:

          * ``"onchip"`` (``csrc/shared_sweep.cu``'s tile,
            ``csrc/batch_sweep.cu``'s ``batch_onchip_kernel`` and
            ``batch_penta_kernel``): the floor, ``traffic_words``.  The
            pentadiagonal tile reads b and c in three phases and the rhs in
            two; it prefetches them into L2 and keeps them there by
            eviction hints until their last reads, so device memory sees
            each once (its source's count; no DRAM counter has read it);
          * ``"serial"`` (shared): the rhs and the factor for the forward
            pass, d̂ written into x, read back and overwritten by the
            backward pass, which stages the factor again: NM + 2kN (+ eps,
            read once at the launch's start) stored words and 3NM at the
            compute type, what the JAX engine's streamed pair moves
            (``*_streamed``);
          * ``"partition"`` (shared, K0–K3 over B row blocks, order o): K0
            reads the factor and writes the block coefficients (3Bo²) and
            the summary weights (2oN); K1 reads the rhs and the weights and
            writes the summaries (2BoM); K2 reads the summaries and the
            coefficients, writes the entry carries (2BoM) and reads the
            forward half back on its way down (BoM); K3 reads the rhs, the
            factor and the carries and writes x.  So 2NM + 2kN (+ 2 eps)
            stored words and NM + 4oN + 6Bo² + 9BoM at the compute type;
          * ``"stream"`` (batch, ``batch_sweep_kernel``): the diagonals and
            the rhs read once ((bw + 1)·NM), then c^ (or gamma and delta)
            into the workspace and d^ (or g) into x, both read back by the
            backward pass, and x written: (1 + 2·(1 + order))·NM at the
            compute type; 9NM in all tridiagonal, 13NM pentadiagonal, what
            the JAX engine's streamed pair moves (``*_batch_streamed``).

        JAX's fused single-call tilings (``*_streamed_fused``) have no
        route here: on Hopper the on-chip tiles keep the intermediate in
        shared memory at every N they take, and past it the partitioned
        route does."""
        _check_route(self.layout, route)
        floor = (self.storage_words(n, m), self.compute_words(n, m))
        if route == "onchip":
            return floor
        if route == "stream":
            return floor[0], (1 + 2 * (1 + self.n_coefs)) * n * m
        eps = 1 if self.uniform else 0
        if route == "serial":
            return n * m + 2 * self.lhs_rows * n + eps, 3 * n * m
        o = self.order
        return (2 * (n * m + self.lhs_rows * n + eps),
                n * m + 4 * o * n + 6 * blocks * o * o + 9 * blocks * o * m)

    def route_traffic_bytes(self, n: int, m: int, route: str,
                            dtype=torch.float32, storage_dtype=None,
                            blocks: int = 1) -> int:
        """``route_words`` in bytes, priced as ``traffic_bytes``: stored
        operands at ``storage_dtype`` (default ``dtype``), the rest at the
        compute type.  The on-chip route's equals ``traffic_bytes``."""
        storage, compute = self.route_words(n, m, route, blocks)
        sdt = storage_dtype or dtype
        return (storage * _itemsize(sdt)
                + compute * _itemsize(compute_dtype(sdt)))


@dataclasses.dataclass(frozen=True)
class RecurrenceSpec:
    """One gated-recurrence variant: ``order`` carry lags, walked ascending
    or (``reverse``) descending from zero carries.  A nonzero ``h0`` is
    folded into the boundary rows of ``q`` on the host (``ops.recurrence``).

    Only the JAX engine's resident names exist here (``recur1``,
    ``recur1_rev``, ``recur2``, ``recur2_rev``): its streamed variants
    chunk N because a TPU core has 12 MiB of VMEM, while one Hopper thread
    walks all N rows of its column, so one kernel serves both tilings and
    no ``_streamed`` spec is registered."""

    order: int
    reverse: bool = False

    def __post_init__(self):
        if self.order not in (1, 2):
            raise ValueError(f"recurrence order must be 1 or 2, "
                             f"got {self.order}")

    layout = "recurrence"
    mode = "recurrence"
    lhs_rows = 0              # no shared factor: the gates are operands

    @property
    def name(self) -> str:
        return f"recur{self.order}" + ("_rev" if self.reverse else "")

    def passes(self) -> tuple:
        """``(pass,)``: a recurrence is one sweep pass."""
        return (_RECUR_TABLE[self.order],)

    def storage_words(self, n: int, m: int) -> int:
        """``order`` gate operands and q, each read once."""
        return (self.order + 1) * n * m

    def compute_words(self, n: int, m: int) -> int:
        """h, written once."""
        return n * m

    def traffic_words(self, n: int, m: int) -> int:
        return self.storage_words(n, m) + self.compute_words(n, m)

    def traffic_bytes(self, n: int, m: int, dtype=torch.float32,
                      storage_dtype=None) -> int:
        """Operands at ``storage_dtype`` (default ``dtype``), h at
        ``dtype``: the JAX engine's accounting."""
        return (self.storage_words(n, m) * _itemsize(storage_dtype or dtype)
                + self.compute_words(n, m) * _itemsize(dtype))

    def sharded_traffic_words(self, n: int, m: int, n_shards: int) -> int:
        """Words one rank moves with M sharded over ``n_shards`` ranks:
        every operand is cut by column, so all of it shrinks with the
        shards (up to the ragged last one)."""
        return self.traffic_words(n, shard_lanes(m, n_shards))

    def route_name(self, route: str) -> str:
        """The traffic entry of ``route``: ``recur1`` (the walk, JAX's
        resident variant's words and name) or ``recur1_tile``, with
        ``_rev`` reversed."""
        _check_route(self.layout, route)
        return (f"recur{self.order}{_ROUTE_SUFFIX[self.layout, route]}"
                + ("_rev" if self.reverse else ""))

    def route_traffic_bytes(self, n: int, m: int, route: str,
                            dtype=torch.float32, storage_dtype=None) -> int:
        """Bytes one launch on ``route`` moves through device memory: the
        floor, ``traffic_bytes``, on both (``csrc/recurrence_sweep.cu``).
        The walk reads each gate and q once and writes h once; the tile
        keeps its chunks' summaries in shared memory and its two walks over
        a window in registers, so it moves the same (order + 2)·NM.  JAX's
        ``*_streamed`` variants have no route of their own: they move the
        words of its resident ones."""
        _check_route(self.layout, route)
        return self.traffic_bytes(n, m, dtype, storage_dtype)


REGISTRY: dict = {
    s.name: s for s in (
        *(SweepSpec(bw, transposed=t, uniform=u)
          for bw in (3, 5) for u in (False, True)
          for t in (False, True) if not (u and bw == 3)),
        *(SweepSpec(bw, layout="batch") for bw in (3, 5)),
        *(RecurrenceSpec(order, reverse=r) for order in (1, 2)
          for r in (False, True)))
}


def find_spec(bandwidth: int, mode: str, *,
              transposed: bool = False) -> SweepSpec:
    """The spec serving (bandwidth, storage mode); tridiagonal ``uniform``
    shares the constant variant (it has no eps row to drop).  The batch
    layout has no transposed variant: its adjoint is another batch system
    on rolled diagonals."""
    if bandwidth not in (3, 5):
        raise ValueError(f"no sweep for bandwidth={bandwidth!r}; "
                         "3 (tridiagonal) and 5 (pentadiagonal) exist")
    if mode == "batch":
        return SweepSpec(bandwidth, layout="batch", transposed=transposed)
    if mode not in ("constant", "uniform"):
        raise ValueError(f"unknown storage mode {mode!r}")
    return SweepSpec(bandwidth, transposed=transposed,
                     uniform=(mode == "uniform" and bandwidth == 5))


def find_recurrence_spec(order: int, *, reverse: bool = False
                         ) -> RecurrenceSpec:
    """The registered recurrence spec of ``order`` and direction."""
    if order not in (1, 2):
        raise ValueError(f"no recurrence kernel for order={order!r}; "
                         "1 (h = p*h' + q) and 2 (h = s*h' + t*h'' + u) "
                         "exist")
    return REGISTRY[RecurrenceSpec(order, reverse=reverse).name]


def pass_table() -> dict:
    """A copy of ``_PASS_TABLE`` (mutating it cannot corrupt the sweep)."""
    return dict(_PASS_TABLE)


def batch_backward_table() -> dict:
    """A copy of ``_BATCH_BWD``."""
    return dict(_BATCH_BWD)


def recurrence_table() -> dict:
    """A copy of ``_RECUR_TABLE``."""
    return dict(_RECUR_TABLE)
