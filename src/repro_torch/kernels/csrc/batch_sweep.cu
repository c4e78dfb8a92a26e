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
//   * on chip (tridiagonal only, N up to onchip_chunks<C>() * ROWS:
//     512 at float and bf16 storage, 256 at double): batch_onchip_kernel
//     keeps every system's factor and intermediate on the SM between the
//     passes;
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
// Pentadiagonal systems stream at every N.  Their factor splits into row
// chunks too: the six Pluecker coordinates of the plane of U rows i-2 and
// i-1 go to those after row i by a linear map that divides by nothing, so
// it holds where e_i = 0.  That order has a plain version,
// ops.batch_sweep_plain(chunks=P) (ops._penta_chunked), but a tile of it
// (16 systems a block, six words a row and system on chip) ran slower than
// the stream kernel on an H100 (PERF.md), so no kernel runs it.

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
  const int64_t left = col < m ? n - r0 : 0;   // rows left from r0
  const int len = left <= 0 ? 0 : (int)(left < rows ? left : rows);

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
    // on chip: tridiagonal, `chunks` chunks of at most ROWS rows
    const int64_t rows = (n + chunks - 1) / chunks;
    if (bandwidth != 3 || chunks < 1 || rows > ROWS) {
      return (int)cudaErrorInvalidValue;
    }
    const void* fn;
    size_t smem;
    cudaError_t e = onchip_fn<S, C>(chunks, &fn, &smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((m + TILE - 1) / TILE));
    batch_onchip_kernel<S, C, ROWS, onchip_chunks<C>()>
        <<<grid, dim3(TILE, chunks), smem, stream>>>(dg, r, o, n, m,
                                                     (int)rows);
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
int onchip_blocks(int chunks, int* out) {
  const void* fn;
  size_t smem;
  cudaError_t e = onchip_fn<S, C>(chunks, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, TILE * chunks, smem);
}

}  // namespace

// Plain C entry points for ctypes.
//
// batch_sweep: one solve.
//   dtype:     0 float, 1 double, 2 bf16 storage with float compute, output
//              and workspace
//   bandwidth: 3 or 5; diags holds that many (N, M) operand pointers
//   route:     0 stream (work: (bandwidth / 2, N, M) workspace at the
//              compute type; threads a block), 1 on chip (bandwidth 3;
//              1..32 chunks at float and bf16, 1..16 at double, of
//              ceil(N / chunks) <= 16 rows; work and threads unused)
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

// batch_sweep_onchip_blocks: blocks of the on-chip kernel in `chunks`
// chunks that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int batch_sweep_onchip_blocks(int dtype, int chunks, int* blocks) {
  switch (dtype) {
    case 0:
      return onchip_blocks<float, float>(chunks, blocks);
    case 1:
      return onchip_blocks<double, double>(chunks, blocks);
    case 2:
      return onchip_blocks<__nv_bfloat16, float>(chunks, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
