// recurrence_sweep — the gated linear recurrence over an interleaved
// (N, M) batch, for Hopper (sm_90a):
//   order 1:  h_i = p_i h_{i-1} + q_i
//   order 2:  h_i = s_i h_{i-1} + t_i h_{i-2} + u_i
// walked ascending, or descending (h_i reads h_{i+1}, h_{i+2}), from zero
// carries.  A nonzero h0 is folded into the boundary rows of q on the host
// (repro_torch.kernels.ops.recurrence), and the backward pass of
// core.recurrence runs this same kernel in the other direction on shifted
// gates.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/engine.py that
// compute this one function at two VMEM tilings:
//   _recurrence_resident_kernel (engine.py:1156) and
//   _recurrence_streamed_kernel (engine.py:1169).
// The streamed one chunks N because a TPU core has 12 MiB of VMEM; here
// both are served by one kernel with two routes, picked by
// ops.recurrence_route(N, M, dtype, order).
//
// Arithmetic: acc = q_i + g0_i h_{i-1} (+ g1_i h_{i-2}), in that term
// order.  The JAX engine subtracts gates read negated, which is bitwise
// q + p h only inside JAX; nvcc contracts the expression into FMAs, so this
// kernel and its plain version (ops.recurrence_plain) agree to a few ulps.
// Carries at float for bf16 and fp16 storage (h is rounded to the storage
// type only where it is stored) and at double for double; 64-bit offsets
// (N*M overflows int32); no padding of N or M.  Built without
// --use_fast_math.
//
// Bound: device-memory bytes.  The function moves (order + 2)·N·M words:
// the order gates and q read once, h written once.  Both routes move
// exactly that, with no scratch in device memory and no memset; their
// operations, 2·order per element on the walk (about three times that on
// the tile, which walks every row twice and carries the unit responses),
// are far below the byte bound at the card's fp32 and fp64 rates.
//
// Walk route (recurrence_kernel): one thread walks all N rows of column m;
// a warp reads 32 consecutive m of row i, so every access is coalesced,
// and the ragged edge of M is masked.  The loop is unrolled so that a few
// rows' loads are issued ahead of the carry chain.  The host passes the
// block size (ops.DEFAULT_THREADS, 256).
//
// Tile route (recurrence_tile_kernel), for operands too narrow to fill the
// card one thread a column: a block takes TILE = 32 adjacent columns (lane
// j is column j, so each row of an operand is one 128-byte segment) and
// P warps; it walks N in windows of P·R rows (R = ROWS = 8), warp w taking
// chunk w, R rows, of each window (in walk order: chunks and windows
// descend when reversed).  Per window:
//   1. loads first: a thread keeps two register buffers of a window's
//      gates and q at the storage type, one for the even windows and one
//      for the odd; entering window v it issues all of window v + 1's
//      loads into the other buffer, so they are in flight while window v's
//      walks and fold run (q rides registers too: a cp.async route for q
//      into two shared-memory stages, as the batch sweep's on-chip block
//      loads, ran slower on an H100, PERF.md §6);
//   2. walk from zero: each thread walks its R rows from a zero carry and
//      carries its response to a unit carry: the running product of the
//      gate (order 1), or the 2x2 companion product, its state's responses
//      to a unit h_{-1} and to a unit h_{-2} (order 2);
//   3. fold: the chunk summaries go through shared memory (two stages, by
//      window parity, so one barrier a window suffices); warp w folds
//      chunks 0..w-1 linearly, c = e_k + r_k c, from the previous window's
//      last `order` values, which its last warp left in shared memory;
//   4. walk from the true carry: the sequential arithmetic again, from the
//      folded carry, writing h to device memory once.  Every row is computed
//      in the kernel's term order; only the chunks' start carries come from
//      the fold.  ops.recurrence_plain(chunks=P, rows=R) repeats this order.
// Shared memory holds only the summaries and the window carries (8.3 KB at
// 16 chunks, fp32, order 1); ops.recurrence_tile_blocks_per_sm reads the
// occupancy.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

template <>
__device__ __forceinline__ float to_compute<float, __half>(__half v) {
  return __half2float(v);
}

template <typename S, typename C>
__device__ __forceinline__ S to_storage(C v) {
  return static_cast<S>(v);
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_storage<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16(v);
}

template <>
__device__ __forceinline__ __half to_storage<__half, float>(float v) {
  return __float2half(v);
}

// ---------------------------------------------------------------------------
// The walk route
// ---------------------------------------------------------------------------

// One thread walks column j.  g0 is the lag-1 gate, g1 the lag-2 gate
// (ORDER 2 only).
template <typename S, typename C, int ORDER, bool REVERSE>
__global__ void recurrence_kernel(const S* __restrict__ g0,
                                  const S* __restrict__ g1,
                                  const S* __restrict__ q,
                                  S* __restrict__ out, int64_t n, int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  C h1 = C(0), h2 = C(0);
#pragma unroll 4
  for (int64_t t = 0; t < n; ++t) {
    const int64_t i = REVERSE ? n - 1 - t : t;
    const int64_t k = i * m + j;
    C acc = to_compute<C, S>(q[k]) + to_compute<C, S>(g0[k]) * h1;
    if constexpr (ORDER == 2) acc = acc + to_compute<C, S>(g1[k]) * h2;
    out[k] = to_storage<S, C>(acc);
    h2 = h1;
    h1 = acc;
  }
}

// ---------------------------------------------------------------------------
// The tile route
// ---------------------------------------------------------------------------

constexpr int TILE = 32;     // columns a block, one per lane
constexpr int ROWS = 8;      // rows a chunk (ops.RECURRENCE_ROWS)
constexpr int PMAX = 16;     // chunks (warps) a block at most

// Summary words a chunk and column: the zero-carry end state and its
// responses (order 1: e, r; order 2: z1, z2, a1, a2, b1, b2).
template <int ORDER>
constexpr int kSummaryWords = ORDER == 1 ? 2 : 6;

// Shared memory: the summaries [2][SW][P][TILE] and the window carries
// [2][ORDER][TILE], at the compute type.
template <typename C, int ORDER>
size_t tile_smem(int chunks) {
  return (2 * (size_t)kSummaryWords<ORDER> * chunks + 2 * ORDER) * TILE *
         sizeof(C);
}

// Block (TILE, P): lane j is column blockIdx.x * TILE + j; warp w walks
// rows [v P R + w R, v P R + (w + 1) R) of window v, in walk order
// (position s is row s ascending, row n - 1 - s descending).
template <typename S, typename C, int ORDER, bool REVERSE>
__global__ void __launch_bounds__(TILE * PMAX)
    recurrence_tile_kernel(const S* __restrict__ g0,
                           const S* __restrict__ g1,
                           const S* __restrict__ q, S* __restrict__ out,
                           int64_t n, int64_t m) {
  constexpr int R = ROWS, SW = kSummaryWords<ORDER>;
  constexpr int R1 = ORDER == 2 ? R : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, w = threadIdx.y, chunks = blockDim.y;
  C* const summ = reinterpret_cast<C*>(smem);
  C* const carry = summ + 2 * SW * chunks * TILE;
  const auto at = [&](int stage, int word, int k) -> C& {
    return summ[((stage * SW + word) * chunks + k) * TILE + lane];
  };
  const int64_t col = (int64_t)blockIdx.x * TILE + lane;
  const bool live = col < m;
  const int64_t span = (int64_t)chunks * R;
  const int64_t windows = (n + span - 1) / span;
  const int64_t step = REVERSE ? -m : m;   // offset of the next walked row

  // rows of this thread's chunk in window v, and the offset of its first
  const auto rows_in = [&](int64_t v) -> int {
    const int64_t left = n - (v * span + (int64_t)w * R);
    if (!live || left <= 0) return 0;
    return left < R ? (int)left : R;
  };
  const auto first = [&](int64_t v) -> int64_t {
    const int64_t s = v * span + (int64_t)w * R;
    return (REVERSE ? n - 1 - s : s) * m + col;
  };

  // a window's operands at the storage type, in registers: window v in
  // buffer v % 2
  struct Buf {
    S a[R], b[R1], u[R];   // lag-1 gate, lag-2 gate, q
  };
  const auto issue = [&](int64_t v, Buf& buf) {
    const int len = rows_in(v);
    const int64_t k0 = first(v);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t < len) {
        const int64_t k = k0 + t * step;
        buf.a[t] = g0[k];
        if constexpr (ORDER == 2) buf.b[t] = g1[k];
        buf.u[t] = q[k];
      }
    }
  };

  // walk window v from buf, after issuing window v + 1 into next
  const auto window = [&](int64_t v, Buf& buf, Buf& next) {
    const int len = rows_in(v);
    if (v + 1 < windows) issue(v + 1, next);
    C c0[R], c1[R1], cq[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      c0[t] = to_compute<C, S>(buf.a[t]);
      if constexpr (ORDER == 2) c1[t] = to_compute<C, S>(buf.b[t]);
      cq[t] = to_compute<C, S>(buf.u[t]);
    }

    // 2. walk from zero with the unit-carry responses
    C z1 = C(0), z2 = C(0), a1 = C(1), a2 = C(0), u1 = C(0), u2 = C(1);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t < len) {
        if constexpr (ORDER == 1) {
          z1 = cq[t] + c0[t] * z1;
          a1 = c0[t] * a1;
        } else {
          const C z = cq[t] + c0[t] * z1 + c1[t] * z2;
          const C a = c0[t] * a1 + c1[t] * a2;
          const C u = c0[t] * u1 + c1[t] * u2;
          z2 = z1;
          z1 = z;
          a2 = a1;
          a1 = a;
          u2 = u1;
          u1 = u;
        }
      }
    }
    const int stage = (int)(v & 1);
    at(stage, 0, w) = z1;
    at(stage, 1, w) = a1;
    if constexpr (ORDER == 2) {
      at(stage, 2, w) = z2;
      at(stage, 3, w) = a2;
      at(stage, 4, w) = u1;
      at(stage, 5, w) = u2;
    }
    __syncthreads();

    // 3. fold the chunks before this one from the window's carry
    C h1 = C(0), h2 = C(0);
    if (v > 0) {
      const C* const cin = carry + (int)((v - 1) & 1) * ORDER * TILE + lane;
      h1 = cin[0];
      if constexpr (ORDER == 2) h2 = cin[TILE];
    }
    for (int k = 0; k < w; ++k) {
      if constexpr (ORDER == 1) {
        h1 = at(stage, 0, k) + at(stage, 1, k) * h1;
      } else {
        const C e1 = at(stage, 0, k) + at(stage, 1, k) * h1 +
                     at(stage, 4, k) * h2;
        const C e2 = at(stage, 2, k) + at(stage, 3, k) * h1 +
                     at(stage, 5, k) * h2;
        h1 = e1;
        h2 = e2;
      }
    }

    // 4. walk from the true carry, writing h
    const int64_t k0 = first(v);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t < len) {
        C acc = cq[t] + c0[t] * h1;
        if constexpr (ORDER == 2) acc = acc + c1[t] * h2;
        out[k0 + t * step] = to_storage<S, C>(acc);
        h2 = h1;
        h1 = acc;
      }
    }
    if (w == chunks - 1 && v + 1 < windows) {
      C* const cout = carry + stage * ORDER * TILE + lane;
      cout[0] = h1;
      if constexpr (ORDER == 2) cout[TILE] = h2;
    }
  };

  Buf even, odd;
  issue(0, even);
  for (int64_t v = 0; v < windows; v += 2) {
    window(v, even, odd);
    if (v + 1 < windows) window(v + 1, odd, even);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename S, typename C, int ORDER, bool REVERSE>
cudaError_t tile_fn(int chunks, const void** fn, size_t* smem) {
  if (chunks < 1 || chunks > PMAX) return cudaErrorInvalidValue;
  *fn = (const void*)recurrence_tile_kernel<S, C, ORDER, REVERSE>;
  *smem = tile_smem<C, ORDER>(chunks);
  // past 48 KB (double, order 2, more than 15 chunks) the block opts in
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

struct Args {
  const void* g0;
  const void* g1;
  const void* q;
  void* out;
  int64_t n, m;
  int chunks, threads;
  cudaStream_t stream;
};

template <typename S, typename C, int ORDER, bool REVERSE>
int launch_route(int route, const Args& a) {
  if (route == 1) {
    const void* fn;
    size_t smem;
    cudaError_t e = tile_fn<S, C, ORDER, REVERSE>(a.chunks, &fn, &smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((a.m + TILE - 1) / TILE));
    recurrence_tile_kernel<S, C, ORDER, REVERSE>
        <<<grid, dim3(TILE, a.chunks), smem, a.stream>>>(
            static_cast<const S*>(a.g0), static_cast<const S*>(a.g1),
            static_cast<const S*>(a.q), static_cast<S*>(a.out), a.n, a.m);
    return (int)cudaGetLastError();
  }
  if (route != 0 || a.threads <= 0 || a.threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((a.m + a.threads - 1) / a.threads));
  recurrence_kernel<S, C, ORDER, REVERSE>
      <<<grid, dim3(a.threads), 0, a.stream>>>(
          static_cast<const S*>(a.g0), static_cast<const S*>(a.g1),
          static_cast<const S*>(a.q), static_cast<S*>(a.out), a.n, a.m);
  return (int)cudaGetLastError();
}

template <typename S, typename C>
int launch(int order, int reverse, int route, const Args& a) {
  if (order == 1 && !reverse) {
    return launch_route<S, C, 1, false>(route, a);
  } else if (order == 1) {
    return launch_route<S, C, 1, true>(route, a);
  } else if (order == 2 && !reverse) {
    return launch_route<S, C, 2, false>(route, a);
  } else if (order == 2) {
    return launch_route<S, C, 2, true>(route, a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename S, typename C>
int tile_blocks(int order, int chunks, int* out) {
  const void* fn;
  size_t smem;
  cudaError_t e = order == 1 ? tile_fn<S, C, 1, false>(chunks, &fn, &smem)
                  : order == 2 ? tile_fn<S, C, 2, false>(chunks, &fn, &smem)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, TILE * chunks, smem);
}

}  // namespace

// Plain C entry points for ctypes.
//
// recurrence_sweep: one recurrence.
//   dtype:   0 float, 1 double, 2 bf16, 3 fp16 (bf16 and fp16: float
//            carries, output at the storage type)
//   order:   1 or 2; gates holds that many (N, M) operand pointers
//   reverse: 0 ascending, 1 descending
//   route:   0 walk (threads a block, 1..1024), 1 tile (chunks 1..16
//            warps of rows = 8 rows; threads unused)
// Every operand and the output are (N, M), contiguous, of the storage
// type.  Returns the launch's error (0 on success), or the error that
// refused the arguments.
extern "C" int recurrence_sweep(int dtype, int order, int reverse, int route,
                                int chunks, int rows,
                                const void* const* gates, const void* q,
                                void* out, long long n, long long m,
                                int threads, void* stream) {
  if (n <= 0 || m <= 0 || (route == 1 && rows != ROWS)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{gates[0], order == 2 ? gates[1] : nullptr, q, out, n, m,
               chunks, threads, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return launch<float, float>(order, reverse, route, a);
    case 1:
      return launch<double, double>(order, reverse, route, a);
    case 2:
      return launch<__nv_bfloat16, float>(order, reverse, route, a);
    case 3:
      return launch<__half, float>(order, reverse, route, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// recurrence_tile_blocks: blocks of the tile kernel (ascending) in `chunks`
// chunks that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int recurrence_tile_blocks(int dtype, int order, int chunks,
                                      int* blocks) {
  switch (dtype) {
    case 0:
      return tile_blocks<float, float>(order, chunks, blocks);
    case 1:
      return tile_blocks<double, double>(order, chunks, blocks);
    case 2:
      return tile_blocks<__nv_bfloat16, float>(order, chunks, blocks);
    case 3:
      return tile_blocks<__half, float>(order, chunks, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
