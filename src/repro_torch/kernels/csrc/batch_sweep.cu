// batch_sweep — the per-system-LHS banded solve (cuThomasBatch /
// cuPentBatch) over an interleaved (N, M) batch, for Hopper (sm_90a).
// Every system m has its own diagonals, stored interleaved like the RHS,
// and the LU factorisation is fused into every solve.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/engine.py that
// compute this one function at three VMEM tilings:
//   _batch_resident_kernel (engine.py:947), the streamed pair
//   _batch_streamed_fwd_kernel (engine.py:963) + _batch_streamed_bwd_kernel
//   (engine.py:984), and _batch_fused_kernel (engine.py:1002).
// They tile N only because a TPU core has 12 MiB of VMEM.  Here the kernel
// has two routes, picked by ops.batch_route(N, dtype, bandwidth):
//
//   * on chip: batch_onchip_kernel (tridiagonal, N up to onchip_chunks<C>()
//     * ROWS: 512 at float and bf16 storage, 256 at double) and
//     batch_penta_kernel (pentadiagonal, N up to penta_chunks<C>() *
//     PENTA_ROWS: 512 at float and bf16, 256 at double; forced only, see
//     below) keep every system's factor and intermediate on the SM between
//     the passes;
//   * stream (past that N, every pentadiagonal system, and forced to time
//     it): batch_sweep_kernel, one thread walking all N rows of its system
//     with the factor and intermediate round-tripping through device
//     memory.
//
// Arithmetic, in _factor_pass's order (engine.py:692-729):
//   tridiag  inv = 1 / (b_i - a_i c^_{i-1});  c^_i = c_i inv;
//            d^_i = (d_i - a_i d^_{i-1}) inv
//   penta    beta_i  = b_i - a_i gamma_{i-2}
//            alpha_i = c_i - a_i delta_{i-2} - beta_i gamma_{i-1}
//            inv = 1 / alpha_i;  gamma_i = (d_i - beta_i delta_{i-1}) inv
//            delta_i = e_i inv
//            g_i = (r_i - a_i g_{i-2} - beta_i g_{i-1}) inv
// then back substitution (_BATCH_BWD): x_i = d^_i - c^_i x_{i+1}, or
// x_i = g_i - gamma_i x_{i+1} - delta_i x_{i+2}.  Both routes start every
// carry at zero at both ends; no row -1 or N is ever read: a_0, b_0
// (penta) and the entries that torch.roll wraps across the Dirichlet
// boundary for the adjoint only ever multiply a zero carry.  Storage
// float, double or bf16 (bf16 computes in float; the output and the
// stream route's workspace are float); offsets are 64-bit (N*M overflows
// int32).
//
// Bound: device-memory bytes.  The function needs (bw + 2)·N·M words:
// bw diagonals and the RHS read once, x written once, i.e.
// (bw + 1)·N·M·storage_itemsize + N·M·compute_itemsize bytes over
// 3.35 TB/s.  The operations per row and system, a division counted as
// one, are 9 (tridiag: 7 forward, 2 backward) and 20 (penta: 16 forward,
// 4 backward), far below the byte bound at the card's fp32 and fp64 rates.
//
// Stream route (the paper's CUDA mapping): one thread per system; a warp
// reads 32 consecutive m of row i of each operand, so every access is
// coalesced, and the ragged edge of M is masked.  The forward pass
// ascends and writes c^ (or gamma, delta) into an (order, N, M) workspace
// that the wrapper allocates, and d^ (or g) into the output; the backward
// pass descends and overwrites the output with x.  So it moves about
// 9·N·M words (tridiag) and 13·N·M (penta) against the 5 and 7 the
// function needs.
//
// On-chip route (tridiag): 5·N·M words, each operand read once and x
// written once.  A block takes TILE = 32 adjacent systems (lane j is
// system j, so each row of an operand is one 128-byte segment) and cuts
// their N rows into P chunks of R = ceil(N / P) rows, the last one ragged;
// warp w takes chunk w, its rows in registers and shared memory:
//   1. every thread issues all of its loads first: b and c into registers
//      (2R words), a and d into its own column of two shared-memory planes
//      (cp.async, no registers; bf16 through registers), so the block's
//      whole tile is in flight at once;
//   2. factor split: the factor recurrence is a Moebius map; its 2x2
//      companion form (num_i, den_i) = [[0, c_i], [-a_i, b_i]] (num, den)_{i-1}
//      (thomas_factor(method="assoc"), src/repro/core/tridiag.py:67-95)
//      gives each chunk's product, rescaled by a power of two (exact, as
//      c^ = num / den is a ratio) whenever its largest entry leaves
//      [2^-60, 2^60]; the products go through shared memory and each warp
//      folds the chunks before its own, c^ = (p00 c^ + p01) / (p10 c^ + p11)
//      from c^_{-1} = 0, to its true start;
//   3. each thread re-runs _factor_pass's arithmetic over its rows from that
//      start, keeping c^_i and inv_i in the registers of c_i and b_i, and
//      forms d^ from a zero carry with its response to a unit carry, the
//      running product of -a_i inv_i; one linear fold over the chunks gives
//      each chunk's true d^ carry, and a second walk forms d^_i from it in
//      _factor_pass's arithmetic (into the registers of inv_i);
//   4. back substitution alike: a walk from a zero carry with the running
//      product of -c^_i, one fold, and a walk from the true carry that
//      writes x to device memory, once.
// A thread holds 2R words in registers and 2R in shared memory; shared
// memory also holds 8 summary words a chunk and system.  At float compute
// a block is 32 chunks (1024 threads, 64 registers each, 160 KB of shared
// memory at N = 512); at double 16 chunks (512 threads, 128 registers).  Every row is
// computed in the sequential arithmetic; only the chunks' carries come
// from the folds.  ops.batch_sweep_plain(chunks=P) repeats this order.
//
// On-chip route (pentadiagonal): 7·N·M words from device memory, a..e and
// r read once and x written once.  The factor splits into row chunks too:
// the six Pluecker coordinates of the plane of U rows i-2 and i-1 go to
// those after row i by a linear map that divides by nothing
// (ops._plucker_row), so it holds where e_i = 0.
// ops.batch_sweep_plain(chunks=P) (ops._penta_chunked) repeats this
// kernel's order.  A block takes TILE = 32 systems (128-byte rows, as
// above) and cuts their N rows into P chunks of at most 32 rows, P <= 16
// at float compute (512 threads), 8 at double, warp w chunk w:
//   1. a, d and e into the thread's column of three shared-memory planes at
//      the compute type (cp.async where storage and compute agree), every
//      row's copy in flight at once, and b and c into L2 (prefetch); r into
//      L2 once they have landed;
//   2. each chunk's 6x6 product of its rows' maps (chunk 0: its start
//      column alone; the last chunk's is never used), all 36 entries in
//      registers, rescaled every row by one power of two when its largest
//      entry leaves [2^-60, 2^60]; the fold runs down the chunks, warp k
//      applying its product to chunk k's start column through shared
//      memory, to each chunk's start in echelon form (u, v, gamma_{s-1},
//      delta_{s-1});
//   3. the factor from that start in _factor_pass's arithmetic, gamma and
//      delta written over d and e, with g from a zero carry and its
//      responses to the unit carries g'_{s-2} and g_{s-1}, kept at the
//      chunk's end only; one linear fold of two carries over the chunks;
//   4. g from the chunk's true carry over a, beta and 1 / alpha formed
//      again as in 3. from b, c, gamma and delta;
//   5. back substitution from a zero carry with its two responses, one
//      fold and a walk from the true carry that writes x, once.
// Three planes stay on chip (a, d, e, then g, gamma, delta: 192 KiB at N =
// 512 float, with the folds' 12 words a chunk 221,184 bytes, so one block
// an SM).  b and c are read in 2., 3. and 4., r in 3. and 4., from L2 (the
// prefetches above; eviction hints keep b, c and r there until their last
// reads and let a, d and e go first), each stream UNROLL rows ahead of its
// row: device memory sees each operand once.  Every row loop is rolled: a
// thread's rows unrolled (and b and c kept in registers, which only an
// unrolled loop can index) outgrew the instruction cache and ran slower
// still (PERF.md §6).  On an H100 this kernel still runs slower than
// the stream kernel at (e) (PERF.md §6, row 4b), so ops.batch_route never
// takes it; it is the forced route `onchip`, held to its plain version and
// timed beside the stream kernel, which stays the route for every
// pentadiagonal system.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename C, typename S>
__device__ __forceinline__ C to_compute(S v) {
  return static_cast<C>(v);
}

template <>
__device__ __forceinline__ float to_compute<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The bw diagonals, sub-most first: (a, b, c) or (a, b, c, d, e).
template <typename S>
struct Diags {
  const S* __restrict__ p[5];
};

// One thread solves system j.  ORDER 1: (a, b, c), workspace plane c^.
// ORDER 2: (a, b, c, d, e), workspace planes gamma and delta.
template <typename S, typename C, int ORDER>
__global__ void batch_sweep_kernel(Diags<S> dg, const S* __restrict__ rhs,
                                   C* __restrict__ out, C* __restrict__ work,
                                   int64_t n, int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  C* __restrict__ coef0 = work;          // c^ or gamma
  C* __restrict__ coef1 = work + (ORDER == 2 ? n * m : 0);  // delta

  // forward, ascending: the fused factorisation and forward substitution.
  // Carries at lags 1 and 2: c^ / gamma (h1, h2), delta (l1, l2), and the
  // intermediate d^ / g (g1, g2).
  C h1 = C(0), h2 = C(0), l1 = C(0), l2 = C(0), g1 = C(0), g2 = C(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = i * m + j;
    const C a_i = to_compute<C, S>(dg.p[0][k]);
    if constexpr (ORDER == 1) {
      const C inv = C(1) / (to_compute<C, S>(dg.p[1][k]) - a_i * h1);
      const C chat = to_compute<C, S>(dg.p[2][k]) * inv;
      const C dh = (to_compute<C, S>(rhs[k]) - a_i * g1) * inv;
      coef0[k] = chat;
      out[k] = dh;
      h1 = chat;
      g1 = dh;
    } else {
      const C beta = to_compute<C, S>(dg.p[1][k]) - a_i * h2;
      const C alpha = to_compute<C, S>(dg.p[2][k]) - a_i * l2 - beta * h1;
      const C inv = C(1) / alpha;
      const C gamma = (to_compute<C, S>(dg.p[3][k]) - beta * l1) * inv;
      const C delta = to_compute<C, S>(dg.p[4][k]) * inv;
      const C g = (to_compute<C, S>(rhs[k]) - a_i * g2 - beta * g1) * inv;
      coef0[k] = gamma;
      coef1[k] = delta;
      out[k] = g;
      h2 = h1;
      h1 = gamma;
      l2 = l1;
      l1 = delta;
      g2 = g1;
      g1 = g;
    }
  }

  // backward, descending, in place (_BATCH_BWD):
  //   x_i = d^_i - c^_i x_{i+1}  or  x_i = g_i - gamma_i x_{i+1}
  //                                         - delta_i x_{i+2}
  C x1 = C(0), x2 = C(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t k = i * m + j;
    C x = out[k] - coef0[k] * x1;
    if constexpr (ORDER == 2) x = x - coef1[k] * x2;
    out[k] = x;
    x2 = x1;
    x1 = x;
  }
}

// ---------------------------------------------------------------------------
// The on-chip route (tridiagonal)
// ---------------------------------------------------------------------------

constexpr int TILE = 32;        // systems a block, one per lane
constexpr int ROWS = 16;        // rows a chunk holds at most
constexpr int SUMMARY = 8;      // summary words a chunk and system
constexpr size_t SMEM_MAX = 232448;

// Row chunks (warps) a block at most: 32 at float compute, 16 at double,
// so that a thread's two register arrays of ROWS words and the rest of it
// fit the registers its block leaves it (64 of a 1024-thread block, 128
// of a 512-thread one) without spilling.
template <typename C>
constexpr int onchip_chunks() {
  return sizeof(C) == 4 ? 32 : 16;
}

// Rows of a chunk of the on-chip route over n rows in `chunks` chunks:
// ceil(n / chunks) (ops.batch_chunk_spans); on the host too, for
// batch_sweep_spans.
__host__ __device__ __forceinline__ int64_t onchip_rows(int64_t n,
                                                        int chunks) {
  return (n + chunks - 1) / chunks;
}

// Rows of chunk w: from w * rows, at most `rows`, none past n.
__host__ __device__ __forceinline__ int chunk_len(int64_t n, int64_t rows,
                                                  int w) {
  const int64_t left = n - (int64_t)w * rows;   // rows left from its first
  return left <= 0 ? 0 : (int)(left < rows ? left : rows);
}

// Bounds outside which a companion product is rescaled (ops.RESCALE_AT).
constexpr double RESCALE_HI = 0x1p60;
constexpr double RESCALE_LO = 0x1p-60;

// One element of the thread's own column of a shared-memory plane:
// cp.async where the storage is 4 or 8 bytes, else a plain load.
template <typename S>
__device__ __forceinline__ void copy_in(S* dst, const S* src) {
  if constexpr (sizeof(S) >= 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(sizeof(S))
                 : "memory");
  } else {
    *dst = *src;
  }
}

// Rescale the companion product by a power of two (exact) when its largest
// entry leaves [RESCALE_LO, RESCALE_HI]: the largest entry lands in
// [1/2, 1).  A zero or non-finite product stays as it is.
template <typename C>
__device__ __forceinline__ void rescale(C& p00, C& p01, C& p10, C& p11) {
  const C big = fmax(fmax(fabs(p00), fabs(p01)), fmax(fabs(p10), fabs(p11)));
  if (big > C(RESCALE_HI) || (big < C(RESCALE_LO) && big > C(0))) {
    int e;
    frexp(big, &e);
    p00 = ldexp(p00, -e);
    p01 = ldexp(p01, -e);
    p10 = ldexp(p10, -e);
    p11 = ldexp(p11, -e);
  }
}

// Block (TILE, P), P <= PMAX: lane j is system blockIdx.x * TILE + j, warp
// w its rows [w R, min((w + 1) R, n)), R = rows <= L.  Shared memory: the a and d
// planes (P * L * TILE storage elements each, a thread's rows of its
// column), then SUMMARY planes of P * TILE compute elements: the products
// (p00, p01, p10, p11), the d^ chunk ends from a zero carry and their
// responses, the backward chunk starts from a zero carry and theirs.
template <typename S, typename C, int L, int PMAX>
__global__ void __launch_bounds__(TILE * PMAX, 1)
    batch_onchip_kernel(Diags<S> dg, const S* __restrict__ rhs,
                        C* __restrict__ out, int64_t n, int64_t m, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, w = threadIdx.y, chunks = blockDim.y;
  S* const sa = reinterpret_cast<S*>(smem) + (w * L) * TILE + lane;
  S* const sd = sa + chunks * L * TILE;
  C* const summ = reinterpret_cast<C*>(
      smem + 2 * (size_t)chunks * L * TILE * sizeof(S));
  const auto at = [&](int q, int k) -> C& {
    return summ[(q * chunks + k) * TILE + lane];
  };
  const int64_t col = (int64_t)blockIdx.x * TILE + lane;
  const int64_t r0 = (int64_t)w * rows;
  const int len = col < m ? chunk_len(n, rows, w) : 0;

  // 1. every load first: b, c into registers, a, d into shared memory
  C rb[L], rc[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    if (t < len) {
      const int64_t k = (r0 + t) * m + col;
      copy_in(sa + t * TILE, dg.p[0] + k);
      copy_in(sd + t * TILE, rhs + k);
      rb[t] = to_compute<C, S>(dg.p[1][k]);
      rc[t] = to_compute<C, S>(dg.p[2][k]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // 2. the chunk's companion product, then the fold to the true c^ start
  C p00 = C(1), p01 = C(0), p10 = C(0), p11 = C(1);
#pragma unroll
  for (int t = 0; t < L; ++t) {
    if (t < len) {
      const C a = to_compute<C, S>(sa[t * TILE]);
      const C n0 = rc[t] * p10, n1 = rc[t] * p11;
      const C d0 = rb[t] * p10 - a * p00, d1 = rb[t] * p11 - a * p01;
      p00 = n0;
      p01 = n1;
      p10 = d0;
      p11 = d1;
      rescale(p00, p01, p10, p11);
    }
  }
  at(0, w) = p00;
  at(1, w) = p01;
  at(2, w) = p10;
  at(3, w) = p11;
  __syncthreads();
  C chat = C(0);
  for (int k = 0; k < w; ++k) {
    chat = (at(0, k) * chat + at(1, k)) / (at(2, k) * chat + at(3, k));
  }

  // 3. the factor from its true start; d^ from a zero carry, its response
  C g = C(0), rho = C(1);
#pragma unroll
  for (int t = 0; t < L; ++t) {
    if (t < len) {
      const C a = to_compute<C, S>(sa[t * TILE]);
      const C inv = C(1) / (rb[t] - a * chat);
      chat = rc[t] * inv;
      g = (to_compute<C, S>(sd[t * TILE]) - a * g) * inv;
      rho = -a * inv * rho;
      rb[t] = inv;
      rc[t] = chat;
    }
  }
  at(4, w) = g;
  at(5, w) = rho;
  __syncthreads();
  C dh = C(0);
  for (int k = 0; k < w; ++k) dh = at(4, k) + at(5, k) * dh;
#pragma unroll
  for (int t = 0; t < L; ++t) {
    if (t < len) {
      dh = (to_compute<C, S>(sd[t * TILE]) - to_compute<C, S>(sa[t * TILE]) *
                                                  dh) *
           rb[t];
      rb[t] = dh;
    }
  }

  // 4. back substitution: from a zero carry with its response, the fold,
  // and from the true carry into x
  C y = C(0), sg = C(1);
#pragma unroll
  for (int t = L - 1; t >= 0; --t) {
    if (t < len) {
      y = rb[t] - rc[t] * y;
      sg = -rc[t] * sg;
    }
  }
  at(6, w) = y;
  at(7, w) = sg;
  __syncthreads();
  C x = C(0);
  for (int k = chunks - 1; k > w; --k) x = at(6, k) + at(7, k) * x;
#pragma unroll
  for (int t = L - 1; t >= 0; --t) {
    if (t < len) {
      x = rb[t] - rc[t] * x;
      out[(r0 + t) * m + col] = x;
    }
  }
}

template <typename S, typename C>
size_t onchip_smem(int chunks) {
  return 2 * (size_t)chunks * ROWS * TILE * sizeof(S) +
         (size_t)SUMMARY * chunks * TILE * sizeof(C);
}

// The on-chip kernel of a storage type, opted in to its shared memory.
template <typename S, typename C>
cudaError_t onchip_fn(int chunks, const void** fn, size_t* smem) {
  if (chunks < 1 || chunks > onchip_chunks<C>()) return cudaErrorInvalidValue;
  *fn = (const void*)batch_onchip_kernel<S, C, ROWS, onchip_chunks<C>()>;
  *smem = onchip_smem<S, C>(chunks);
  if (*smem > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// ---------------------------------------------------------------------------
// The on-chip route (pentadiagonal)
// ---------------------------------------------------------------------------

constexpr int PENTA_ROWS = 32;   // rows a chunk holds at most
constexpr int PLUCKER = 6;       // Pluecker coordinates of a state plane
constexpr int UNROLL = 8;        // rows of b, c and r in flight a thread

// Row chunks (warps) a block at most: 16 at float compute, 8 at double, so
// that the three shared planes (a plane of 32 systems is 64 KiB at N_max
// either way) and the region fit one block's shared memory, and a thread's
// 36 product entries and its streams fit the registers its block leaves
// it (128 of a 512-thread block, 255 of a 256-thread one).
template <typename C>
constexpr int penta_chunks() {
  return sizeof(C) == 4 ? 16 : 8;
}

// Words a system of the region after the three planes: the fold's start
// columns (6 a chunk), then the g and x folds' summaries (6 a chunk each).
__host__ __device__ constexpr int penta_region(int chunks) {
  return 2 * PLUCKER * chunks;
}

template <typename C>
size_t penta_smem(int chunks) {
  return ((size_t)3 * chunks * PENTA_ROWS + penta_region(chunks)) * TILE *
         sizeof(C);
}

// L2 eviction policies (createpolicy): lines the block reads again stay
// (evict_last), lines read or written for the last time go first.
__device__ __forceinline__ uint64_t l2_keep() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_drop() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// One row's line of device memory into L2 ahead of its first read.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(p));
}

// One element from device memory under an L2 eviction policy.
__device__ __forceinline__ float load_l2(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ double load_l2(const double* p, uint64_t pol) {
  double v;
  asm("ld.global.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ __nv_bfloat16 load_l2(const __nv_bfloat16* p,
                                                 uint64_t pol) {
  unsigned short v;
  asm("ld.global.L2::cache_hint.b16 %0, [%1], %2;"
      : "=h"(v)
      : "l"(p), "l"(pol));
  return __ushort_as_bfloat16(v);
}

// One element into the thread's column of a shared plane at the compute
// type, under L2 policy `pol`: cp.async where storage and compute agree,
// else through a register.
template <typename S, typename C>
__device__ __forceinline__ void stage_in(C* dst, const S* src, uint64_t pol) {
  if constexpr (sizeof(S) == sizeof(C)) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile(
        "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;\n" ::
            "r"(d),
        "l"(src), "n"(sizeof(S)), "l"(pol)
        : "memory");
  } else {
    *dst = to_compute<C, S>(load_l2(src, pol));
  }
}

// Row (a, b, c, d, e) on one column x = (p01, p02, p03, p12, p13, p23) of
// Pluecker coordinates (ops._plucker_row): linear, free of divisions.
template <typename C>
__device__ __forceinline__ void plucker_row(C* x, C a, C b, C c, C d, C e) {
  const C q0 = x[0] * c - x[1] * b + x[3] * a;
  const C q1 = x[0] * d - x[2] * b + x[4] * a;
  const C q2 = x[0] * e;
  const C q3 = x[1] * d - x[2] * c + x[5] * a;
  const C q4 = x[1] * e;
  const C q5 = x[2] * e;
  x[0] = q0;
  x[1] = q1;
  x[2] = q2;
  x[3] = q3;
  x[4] = q4;
  x[5] = q5;
}

// Scale all K entries by the power of two that brings the largest into
// [1/2, 1) when it leaves [RESCALE_LO, RESCALE_HI] (ops._pow2_scale): one
// ldexp and K multiplications.
template <int K, typename C>
__device__ __forceinline__ void rescale_all(C* p) {
  // the largest entry by a tree of pairs, not a chain of K
  C big[K];
#pragma unroll
  for (int i = 0; i < K; ++i) big[i] = fabs(p[i]);
#pragma unroll
  for (int half = 1; half < K; half *= 2) {
#pragma unroll
    for (int i = 0; i + half < K; i += 2 * half) {
      big[i] = fmax(big[i], big[i + half]);
    }
  }
  if (big[0] > C(RESCALE_HI) || (big[0] < C(RESCALE_LO) && big[0] > C(0))) {
    int e;
    frexp(big[0], &e);
    const C s = ldexp(C(1), -e);
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] *= s;
  }
}

// Rows of b, c and r streamed from device memory UNROLL rows ahead of the
// row they serve: next(t, u, v) hands row t's values (t = t0 + u of a group
// of UNROLL rows) and loads row t + UNROLL in their place.
template <typename S, typename C, int K>
struct RowStream {
  const S* col[K];
  int64_t m;
  int len;
  uint64_t pol[K];   // each stream's L2 policy
  C buf[K][UNROLL];

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (u < len) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          buf[k][u] = to_compute<C, S>(load_l2(col[k] + u * m, pol[k]));
        }
      }
    }
  }

  __device__ __forceinline__ void next(int t, int u, C (&v)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = buf[k][u];
    if (t + UNROLL < len) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        buf[k][u] = to_compute<C, S>(
            load_l2(col[k] + (int64_t)(t + UNROLL) * m, pol[k]));
      }
    }
  }
};

// The product of a chunk's `len` rows' maps on the first K / 6 columns of
// p (column-major, 6 entries a column), each row's result rescaled: a, d
// and e from the thread's shared columns, b and c from `bc`.
template <int K, typename S, typename C>
__device__ __forceinline__ void product_rows(C* p, const C* sa, const C* sd,
                                             const C* se,
                                             RowStream<S, C, 2>& bc,
                                             int len) {
  for (int t0 = 0; t0 < len; t0 += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < len) {
        C v[2];
        bc.next(t, u, v);
        const C a = sa[t * TILE], d = sd[t * TILE], e = se[t * TILE];
#pragma unroll
        for (int j = 0; j < K / PLUCKER; ++j) {
          plucker_row(p + PLUCKER * j, a, v[0], v[1], d, e);
        }
        rescale_all<K>(p);
      }
    }
  }
}

// Block (TILE, P), P <= PMAX: lane j is system blockIdx.x * TILE + j, warp
// w its rows [w R, min((w + 1) R, n)), R = rows <= L.  Shared memory: the
// a, d and e planes (P * L * TILE compute elements each, a thread's rows of
// its column), then the region of penta_region(P) * TILE: word q of chunk
// k at (q P + k) TILE, the fold's start columns (q < 6), later the g
// summaries (q < 6) and the x summaries (6 <= q < 12).  Every row loop is
// rolled, UNROLL rows a step: a thread's rows unrolled outgrow the
// instruction cache.  STOP 1-4 cuts the kernel after that phase (writing
// what it holds into out, no solution), to time the phases; 0 is the
// solve, the only one the default build instantiates (the cuts are built
// with -DBATCH_SWEEP_PHASES, by tools/penta_phases.py).
template <typename S, typename C, int L, int PMAX, int STOP = 0>
__global__ void __launch_bounds__(TILE * PMAX, 1)
    batch_penta_kernel(Diags<S> dg, const S* __restrict__ rhs,
                       C* __restrict__ out, int64_t n, int64_t m, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, w = threadIdx.y, chunks = blockDim.y;
  C* const base = reinterpret_cast<C*>(smem);
  C* const sa = base + (w * L) * TILE + lane;
  C* const sd = sa + chunks * L * TILE;
  C* const se = sd + chunks * L * TILE;
  C* const region = base + 3 * chunks * L * TILE + lane;
  const auto word = [&](int k, int q) -> C& {
    return region[(q * chunks + k) * TILE];
  };
  const int64_t col = (int64_t)blockIdx.x * TILE + lane;
  const int64_t r0 = (int64_t)w * rows;
  const int len = col < m ? chunk_len(n, rows, w) : 0;
  const int64_t at0 = r0 * m + col;

  // 1. a, d, e into shared memory, every row's copy in flight at once; b
  // and c into L2; b, c and r, which 2.-4. read again, kept there until
  // their last reads
  const uint64_t keep = l2_keep(), drop = l2_drop();
#pragma unroll UNROLL
  for (int t = 0; t < len; ++t) {
    const int64_t k = at0 + (int64_t)t * m;
    stage_in<S, C>(sa + t * TILE, dg.p[0] + k, drop);
    stage_in<S, C>(sd + t * TILE, dg.p[3] + k, drop);
    stage_in<S, C>(se + t * TILE, dg.p[4] + k, drop);
    prefetch_l2(dg.p[1] + k);
    prefetch_l2(dg.p[2] + k);
  }
  RowStream<S, C, 2> bc{{dg.p[1] + at0, dg.p[2] + at0}, m, len,
                        {keep, keep}};
  bc.start();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // r into L2 now, nearer its first read in 3.
  for (int t = 0; t < len; ++t) prefetch_l2(rhs + at0 + (int64_t)t * m);
  if constexpr (STOP == 1) {
    for (int t = 0; t < len; ++t) {
      out[at0 + (int64_t)t * m] = sa[t * TILE] + sd[t * TILE] + se[t * TILE];
    }
    return;
  }

  // 2. the chunk's product (chunk 0: its start column), row by row, each
  // row's result rescaled, in registers
  C p[PLUCKER * PLUCKER];
#pragma unroll
  for (int q = 0; q < PLUCKER * PLUCKER; ++q) {
    p[q] = q % (PLUCKER + 1) == 0 ? C(1) : C(0);
  }
  if (w == 0) {
    product_rows<PLUCKER>(p, sa, sd, se, bc, len);
  } else if (w < chunks - 1) {   // the last chunk's product is never used
    product_rows<PLUCKER * PLUCKER>(p, sa, sd, se, bc, len);
  }
  if constexpr (STOP == 2) {
    __syncthreads();
    for (int t = 0; t < len; ++t) out[at0 + (int64_t)t * m] = p[0] + p[1];
    return;
  }
  // b, c and r of the re-run in flight across the fold
  RowStream<S, C, 3> bcr{{dg.p[1] + at0, dg.p[2] + at0, rhs + at0}, m, len,
                         {keep, keep, keep}};
  bcr.start();

  // the fold down the chunks, one product at a time: chunk 0's column is
  // chunk 1's start; warp k applies its product to chunk k's start,
  // rescaled, for chunk k + 1's; each start in echelon form
  if (w == 0 && chunks > 1) {
#pragma unroll
    for (int q = 0; q < PLUCKER; ++q) word(1, q) = p[q];
  }
  for (int k = 1; k < chunks - 1; ++k) {
    __syncthreads();
    if (w == k) {
      C q6[PLUCKER];
#pragma unroll
      for (int i = 0; i < PLUCKER; ++i) {
        C acc = p[i] * word(k, 0);
#pragma unroll
        for (int c = 1; c < PLUCKER; ++c) {
          acc = acc + p[PLUCKER * c + i] * word(k, c);
        }
        q6[i] = acc;
      }
      rescale_all<PLUCKER>(q6);
#pragma unroll
      for (int i = 0; i < PLUCKER; ++i) word(k + 1, i) = q6[i];
    }
  }
  __syncthreads();
  C u0 = C(0), v0 = C(0), gs = C(0), ds = C(0);
  if (w > 0) {
    const C inv = C(1) / word(w, 0);
    u0 = -word(w, 3) * inv;
    v0 = -word(w, 4) * inv;
    gs = word(w, 1) * inv;
    ds = word(w, 2) * inv;
  }
  __syncthreads();   // the region now takes the folds' summaries

  // 3. the factor from the start, gamma and delta over d and e; g from a
  // zero carry (y) and its responses to the unit carries g'_{s-2} (ya) and
  // g_{s-1} (yb), kept at the chunk's end only
  C gam2 = C(0), gam1 = gs, dl2 = C(0), dl1 = ds;
  C y2 = C(0), y1 = C(0), ya2 = C(1), ya1 = C(0), yb2 = C(0), yb1 = C(1);
  for (int t0 = 0; t0 < len; t0 += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < len) {
        C v[3];
        bcr.next(t, u, v);
        const C a = sa[t * TILE], b = v[0], c = v[1];
        C beta, inv, gam;
        if (t == 0) {
          beta = b;
          inv = C(1) / (c - a * u0 - b * gam1);
          gam = (sd[t * TILE] - a * v0 - b * dl1) * inv;
        } else {
          beta = b - a * gam2;
          inv = C(1) / (c - a * dl2 - beta * gam1);
          gam = (sd[t * TILE] - beta * dl1) * inv;
        }
        const C dl = se[t * TILE] * inv;
        const C yy = (v[2] - a * y2 - beta * y1) * inv;
        const C ya = (-a * ya2 - beta * ya1) * inv;
        const C yb = (-a * yb2 - beta * yb1) * inv;
        sd[t * TILE] = gam;
        se[t * TILE] = dl;
        gam2 = gam1;
        gam1 = gam;
        dl2 = dl1;
        dl1 = dl;
        y2 = y1;
        y1 = yy;
        ya2 = ya1;
        ya1 = ya;
        yb2 = yb1;
        yb1 = yb;
      }
    }
  }
  if constexpr (STOP == 3) {
    for (int t = 0; t < len; ++t) {
      out[at0 + (int64_t)t * m] = sd[t * TILE] + se[t * TILE] + y1;
    }
    return;
  }
  // b, c and r of the g walk, their last reads, in flight across the fold
  RowStream<S, C, 3> bcr2{{dg.p[1] + at0, dg.p[2] + at0, rhs + at0}, m,
                          len, {drop, drop, drop}};
  bcr2.start();
  // the chunk's end (g'_{e-2}, g_{e-1}) from a zero carry, its responses
  word(w, 0) = y2 - gam2 * y1;
  word(w, 1) = y1;
  word(w, 2) = ya2 - gam2 * ya1;
  word(w, 3) = ya1;
  word(w, 4) = yb2 - gam2 * yb1;
  word(w, 5) = yb1;
  __syncthreads();
  C g2 = C(0), g1 = C(0);
  for (int k = 0; k < w; ++k) {
    const C n2 = word(k, 0) + word(k, 2) * g2 + word(k, 4) * g1;
    const C n1 = word(k, 1) + word(k, 3) * g2 + word(k, 5) * g1;
    g2 = n2;
    g1 = n1;
  }

  // 4. g from the chunk's true carry (g'_{s-2}, g_{s-1}) over a, with beta
  // and 1 / alpha formed again as in 3. from gamma and delta
  gam2 = C(0);
  gam1 = gs;
  dl2 = C(0);
  dl1 = ds;
  for (int t0 = 0; t0 < len; t0 += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < len) {
        C v[3];
        bcr2.next(t, u, v);
        const C a = sa[t * TILE], b = v[0], c = v[1];
        C beta, inv;
        if (t == 0) {
          beta = b;
          inv = C(1) / (c - a * u0 - b * gam1);
        } else {
          beta = b - a * gam2;
          inv = C(1) / (c - a * dl2 - beta * gam1);
        }
        const C g = (v[2] - a * g2 - beta * g1) * inv;
        sa[t * TILE] = g;
        g2 = g1;
        g1 = g;
        gam2 = gam1;
        gam1 = sd[t * TILE];
        dl2 = dl1;
        dl1 = se[t * TILE];
      }
    }
  }

  if constexpr (STOP == 4) {
    for (int t = 0; t < len; ++t) out[at0 + (int64_t)t * m] = sa[t * TILE];
    return;
  }

  // 5. back substitution: from a zero carry (x_e, x_{e+1}) with its
  // responses, the fold, and from the true carry into x
  C x1 = C(0), x2 = C(0), xa1 = C(1), xa2 = C(0), xb1 = C(0), xb2 = C(1);
  for (int t = len - 1; t >= 0; --t) {
    const C gam = sd[t * TILE], dl = se[t * TILE];
    const C x = sa[t * TILE] - gam * x1 - dl * x2;
    const C xa = -gam * xa1 - dl * xa2;
    const C xb = -gam * xb1 - dl * xb2;
    x2 = x1;
    x1 = x;
    xa2 = xa1;
    xa1 = xa;
    xb2 = xb1;
    xb1 = xb;
  }
  word(w, 6) = x1;
  word(w, 7) = x2;
  word(w, 8) = xa1;
  word(w, 9) = xa2;
  word(w, 10) = xb1;
  word(w, 11) = xb2;
  __syncthreads();
  C X1 = C(0), X2 = C(0);
  for (int k = chunks - 1; k > w; --k) {
    const C n1 = word(k, 6) + word(k, 8) * X1 + word(k, 10) * X2;
    const C n2 = word(k, 7) + word(k, 9) * X1 + word(k, 11) * X2;
    X1 = n1;
    X2 = n2;
  }
  for (int t = len - 1; t >= 0; --t) {
    const C x = sa[t * TILE] - sd[t * TILE] * X1 - se[t * TILE] * X2;
    out[at0 + (int64_t)t * m] = x;
    X2 = X1;
    X1 = x;
  }
}

// The pentadiagonal on-chip kernel of a storage type, opted in to its
// shared memory.
template <typename S, typename C>
cudaError_t penta_fn(int chunks, const void** fn, size_t* smem) {
  if (chunks < 1 || chunks > penta_chunks<C>()) return cudaErrorInvalidValue;
  *fn = (const void*)batch_penta_kernel<S, C, PENTA_ROWS, penta_chunks<C>()>;
  *smem = penta_smem<C>(chunks);
  if (*smem > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

#ifdef BATCH_SWEEP_PHASES
// The pentadiagonal on-chip kernel at float cut after phase STOP, opted in
// to its shared memory and launched.
template <int STOP>
int penta_cut(const Diags<float>& dg, const float* rhs, float* out,
              int64_t n, int64_t m, int chunks, cudaStream_t stream) {
  const void* fn =
      (const void*)batch_penta_kernel<float, float, PENTA_ROWS,
                                      penta_chunks<float>(), STOP>;
  const size_t smem = penta_smem<float>(chunks);
  if (chunks < 1 || chunks > penta_chunks<float>() ||
      onchip_rows(n, chunks) > PENTA_ROWS || smem > SMEM_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  batch_penta_kernel<float, float, PENTA_ROWS, penta_chunks<float>(), STOP>
      <<<dim3((unsigned)((m + TILE - 1) / TILE)), dim3(TILE, chunks), smem,
         stream>>>(dg, rhs, out, n, m, (int)onchip_rows(n, chunks));
  return (int)cudaGetLastError();
}
#endif  // BATCH_SWEEP_PHASES

// The on-chip kernel of a bandwidth (3 or 5) and storage type.
template <typename S, typename C>
cudaError_t tile_fn(int bandwidth, int chunks, const void** fn,
                    size_t* smem) {
  if (bandwidth == 3) return onchip_fn<S, C>(chunks, fn, smem);
  if (bandwidth == 5) return penta_fn<S, C>(chunks, fn, smem);
  return cudaErrorInvalidValue;
}

// Rows a chunk of the on-chip route holds at most, by bandwidth.
template <typename C>
int tile_rows(int bandwidth) {
  return bandwidth == 3 ? ROWS : PENTA_ROWS;
}

template <typename S, typename C>
int launch(int bandwidth, int route, int chunks, const void* const* diags,
           const void* rhs, void* out, void* work, int64_t n, int64_t m,
           int threads, cudaStream_t stream) {
  Diags<S> dg;
  for (int r = 0; r < 5; ++r) {
    dg.p[r] = r < bandwidth ? static_cast<const S*>(diags[r]) : nullptr;
  }
  const S* r = static_cast<const S*>(rhs);
  C* o = static_cast<C*>(out);
  C* w = static_cast<C*>(work);
  if (route == 1) {
    // on chip: `chunks` chunks of at most tile_rows(bandwidth) rows
    const int64_t rows = chunks < 1 ? 0 : onchip_rows(n, chunks);
    if (chunks < 1 || (bandwidth != 3 && bandwidth != 5) ||
        rows > tile_rows<C>(bandwidth)) {
      return (int)cudaErrorInvalidValue;
    }
    const void* fn;
    size_t smem;
    cudaError_t e = tile_fn<S, C>(bandwidth, chunks, &fn, &smem);
    if (e != cudaSuccess) return (int)e;
    if (bandwidth == 3) {
      const dim3 grid((unsigned)((m + TILE - 1) / TILE));
      batch_onchip_kernel<S, C, ROWS, onchip_chunks<C>()>
          <<<grid, dim3(TILE, chunks), smem, stream>>>(dg, r, o, n, m,
                                                       (int)rows);
    } else {
      const dim3 grid((unsigned)((m + TILE - 1) / TILE));
      batch_penta_kernel<S, C, PENTA_ROWS, penta_chunks<C>()>
          <<<grid, dim3(TILE, chunks), smem, stream>>>(dg, r, o, n, m,
                                                       (int)rows);
    }
    return (int)cudaGetLastError();
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + threads - 1) / threads));
  const dim3 block(threads);
  if (bandwidth == 3) {
    batch_sweep_kernel<S, C, 1><<<grid, block, 0, stream>>>(dg, r, o, w, n, m);
  } else if (bandwidth == 5) {
    batch_sweep_kernel<S, C, 2><<<grid, block, 0, stream>>>(dg, r, o, w, n, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename S, typename C>
int onchip_blocks(int bandwidth, int chunks, int* out) {
  const void* fn;
  size_t smem;
  cudaError_t e = tile_fn<S, C>(bandwidth, chunks, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, TILE * chunks, smem);
}

// Whether the on-chip kernel of `bandwidth` takes n rows in `chunks`
// chunks with `smem` bytes of shared memory.
template <typename C>
bool tile_fits(int bandwidth, int64_t n, int chunks, size_t smem) {
  const int most = bandwidth == 3 ? onchip_chunks<C>() : penta_chunks<C>();
  return chunks >= 1 && chunks <= most &&
         onchip_rows(n, chunks) <= tile_rows<C>(bandwidth) &&
         smem <= SMEM_MAX;
}

}  // namespace

// Plain C entry points for ctypes.
//
// batch_sweep: one solve.
//   dtype:     0 float, 1 double, 2 bf16 storage with float compute, output
//              and workspace
//   bandwidth: 3 or 5; diags holds that many (N, M) operand pointers
//   route:     0 stream (work: (bandwidth / 2, N, M) workspace at the
//              compute type; threads a block), 1 on chip (bandwidth 3:
//              1..32 chunks at float and bf16, 1..16 at double, of
//              ceil(N / chunks) <= 16 rows; bandwidth 5: 1..8 chunks of
//              ceil(N / chunks) <= 64 rows at float and bf16, 16 at
//              double; work and threads unused)
// Returns the launch's error (0 on success), or the error that refused the
// arguments.
extern "C" int batch_sweep(int dtype, int bandwidth, int route, int chunks,
                           const void* const* diags, const void* rhs,
                           void* out, void* work, long long n, long long m,
                           int threads, void* stream) {
  if (n <= 0 || m <= 0 || threads <= 0 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(bandwidth, route, chunks, diags, rhs, out,
                                  work, n, m, threads, s);
    case 1:
      return launch<double, double>(bandwidth, route, chunks, diags, rhs, out,
                                    work, n, m, threads, s);
    case 2:
      return launch<__nv_bfloat16, float>(bandwidth, route, chunks, diags,
                                          rhs, out, work, n, m, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// batch_sweep_spans: the row spans [s, e) of the route's chunks at (n,
// chunks), as the on-chip kernel of `bandwidth` (3 or 5) cuts them
// (onchip_rows, chunk_len): route 0 stream (one span over n), 1 on chip
// (`chunks` chunks in row order; a chunk past n holds none, at n), 2 ints a
// span into out (room for `cap` spans).  Returns the spans written, or -1
// where a launch at the dtype would refuse the geometry.
extern "C" int batch_sweep_spans(int dtype, int bandwidth, int route,
                                 long long n, int chunks, int* out,
                                 int cap) {
  if (n <= 0 || cap < 1 || (bandwidth != 3 && bandwidth != 5)) return -1;
  if (route == 0) {
    out[0] = 0;
    out[1] = (int)n;
    return 1;
  }
  const bool tri = bandwidth == 3;
  bool fits;
  switch (dtype) {
    case 0:
      fits = tile_fits<float>(bandwidth, n, chunks,
                              tri ? onchip_smem<float, float>(chunks)
                                  : penta_smem<float>(chunks));
      break;
    case 1:
      fits = tile_fits<double>(bandwidth, n, chunks,
                               tri ? onchip_smem<double, double>(chunks)
                                   : penta_smem<double>(chunks));
      break;
    case 2:
      fits = tile_fits<float>(bandwidth, n, chunks,
                              tri ? onchip_smem<__nv_bfloat16, float>(chunks)
                                  : penta_smem<float>(chunks));
      break;
    default:
      return -1;
  }
  if (route != 1 || !fits || chunks > cap) return -1;
  const int64_t rows = onchip_rows(n, chunks);
  for (int w = 0; w < chunks; ++w) {
    const int64_t s = (int64_t)w * rows < n ? (int64_t)w * rows : n;
    out[2 * w] = (int)s;
    out[2 * w + 1] = (int)(s + chunk_len(n, rows, w));
  }
  return chunks;
}

#ifdef BATCH_SWEEP_PHASES
// batch_sweep_penta_phase: the pentadiagonal on-chip kernel at float cut
// after phase `stop` (1 loads, 2 products, 3 fold and re-run, 4 g walk;
// the back substitution completes the solve), in `chunks` chunks, writing
// what it holds into out: a timing aid, no solution, built only with
// -DBATCH_SWEEP_PHASES.  Returns the launch's error.
extern "C" int batch_sweep_penta_phase(int stop, const void* const* diags,
                                       const void* rhs, void* out,
                                       long long n, long long m, int chunks,
                                       void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  Diags<float> dg;
  for (int r = 0; r < 5; ++r) dg.p[r] = static_cast<const float*>(diags[r]);
  const float* r = static_cast<const float*>(rhs);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stop) {
    case 1:
      return penta_cut<1>(dg, r, o, n, m, chunks, s);
    case 2:
      return penta_cut<2>(dg, r, o, n, m, chunks, s);
    case 3:
      return penta_cut<3>(dg, r, o, n, m, chunks, s);
    case 4:
      return penta_cut<4>(dg, r, o, n, m, chunks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif  // BATCH_SWEEP_PHASES

// batch_sweep_onchip_blocks: blocks of the on-chip kernel of `bandwidth`
// (3 or 5) in `chunks` chunks that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int batch_sweep_onchip_blocks(int dtype, int bandwidth, int chunks,
                                         int* blocks) {
  switch (dtype) {
    case 0:
      return onchip_blocks<float, float>(bandwidth, chunks, blocks);
    case 1:
      return onchip_blocks<double, double>(bandwidth, chunks, blocks);
    case 2:
      return onchip_blocks<__nv_bfloat16, float>(bandwidth, chunks, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
