// fused_cn — one periodic Crank-Nicolson time step in one kernel, over an
// interleaved (N, M) batch of fields, for Hopper (sm_90a):
//
//   fused_cn_tridiag  diffusion (paper §III): the 3-point CN stencil RHS,
//                     the Thomas sweeps on the Sherman-Morrison core A',
//                     and the rank-1 correction
//                       x = y - ((y_0 + v_last y_{N-1}) inv_sm) z
//   fused_cn_penta    hyperdiffusion (paper §IV): the 5-point CN stencil
//                     RHS, the penta LR sweeps on the core A', and the
//                     rank-4 Woodbury correction x = y - Z Minv V^T y
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fused_cn.py:32       fused_cn_tridiag_kernel
//   src/repro/kernels/fused_cn_penta.py:31 fused_cn_penta_kernel
// and follows their arithmetic term by term: the stencil sums its terms
// from offset -r up, the forward sweep subtracts eps g_{i-2} before
// beta g_{i-1}, and the correction sums Z[i, k] w_k for k = 0..3 inside
// the kernel (the TPU kernel's (N, 4)·(4, M) product on its MXU).  The
// plain versions in repro_torch/kernels/fused_cn.py repeat that order.
// Built without --use_fast_math; nvcc contracts a - b*c into FMAs, so the
// kernel and its plain version agree to a few ulps, not bitwise.
//
// Bound: device-memory bytes.  The function needs (2NM + 4N + 8) words
// (tridiag) or (2NM + 9N + 32) words (penta): the field read once, the
// next field written once.  The operations per element (about 12
// tridiag, 26 penta) are far below the byte bound.  The TPU kernel
// reaches the floor because its VMEM holds the whole column block between
// the three passes; each route below says how it stands to that.
//
// Two routes, picked by repro_torch/kernels/fused_cn.py::route from
// (N, dtype); each counts its launches under its own name.
//
// On-chip route (fused_cn_tridiag / fused_cn_penta), N <= N_max:
//   * a block owns a tile of TILE_M = 32 adjacent columns (a 128-byte row
//     segment at fp32) over all N rows, held in dynamic shared memory
//     with RESP_ROWS = 4 rows of carry responses after it:
//     N * 36 * itemsize bytes, at most the 232,448 a block may opt in to,
//     so N_max = 1614 (fp32) or 807 (fp64);
//   * one warp for each of P row chunks (P = chunk_count(N, dtype): one per
//     256 bytes of column, 8 at N = 512 fp32, 16 at fp64, at most 16).  A
//     thread owns one column of its chunk: it alone loads those rows, with
//     cp.async (4 or 8 bytes a thread, a warp's copy of a row one coalesced
//     line) in GROUPS commit groups so its forward sweep starts on the
//     first group while the later ones are in flight, and reads the
//     stencil's halo rows (1 or 2 each side) straight from device memory.
//     cp.async and not TMA: TMA needs a tensor map per field built through
//     the driver API, whose row stride must be a multiple of 16 bytes (a
//     ragged M such as 333 is not) and whose box is at most 256 rows, and
//     an mbarrier to wait on; a thread-owned column needs none of that;
//   * the three passes run in shared memory: the forward sweep writes d^
//     (g) in place over c (the stencil's window reads row i + 1, or i + 3
//     for penta, one step ahead and keeps the rows it still needs, and the
//     halo, in registers, so row i is free when step i writes it), the
//     backward sweep turns the tile into y in place, and the correction
//     writes x = y - correction to device memory once, a line per row;
//   * why the chunks: shared memory holds only about 100 whole columns an
//     SM (three 64 KB tiles at N = 512 fp32), and with one thread a column
//     each ran a dependent chain of 3N steps, about 55 cycles a step: on
//     an H100 that took 6.5 ms, slower than the global route (PERF.md).
//     Split into P chunks (the split sweep below), a chain is 3N/P steps
//     and the SM runs P times the warps;
//   * the factor rows, z / Z (a row of Z as 16-byte loads, so Z must be
//     16-byte aligned), Minv and the parameters are read as broadcasts
//     through the read-only cache;
//   * device memory sees the floor: c read once (plus the halo, 2 or 4
//     rows a chunk, mostly served by L2: the neighbouring chunk's warp
//     loads those lines), x written once.  fp64 fits one 144 KB tile an
//     SM at N = 512, so its sweeps overlap no other block's loads there.
//
// Global route (fused_cn_tridiag_global / fused_cn_penta_global), any N:
//   * one thread per field m over all N rows, walking its column three
//     times through device memory: the forward pass reads c and writes
//     d^ (g) into x, the backward pass reads and writes x, the correction
//     reads and writes x once more, about 6NM words.  It stays because
//     the JAX step takes any N whose column block fits 12 MiB of VMEM (N
//     up to about 12,000 at fp32), far past what shared memory holds; it
//     is the size route there, not a fallback, and a caller can force it
//     at any N to time it against the on-chip route.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 32;          // columns of an on-chip tile: a warp
constexpr int RESP_ROWS = 4;        // response rows after the tile's N rows
constexpr int MAX_CHUNKS = 16;      // warps (row chunks) of an on-chip block
constexpr size_t SMEM_MAX = 232448; // shared memory a block may opt in to
constexpr int GROUPS = 4;           // cp.async commit groups per chunk
constexpr int UNROLL = 4;           // rows a backward step loads at once

__device__ __forceinline__ int64_t wrap(int64_t k, int64_t n) {
  return k < 0 ? k + n : (k >= n ? k - n : k);
}

// ---------------------------------------------------------------------------
// Global route: the field walked three times through device memory
// ---------------------------------------------------------------------------

// lhs (3, N) [a, inv_denom, c_hat] of A'; z (N,); params [sl, sc, sr,
// v_last, inv_sm, ...].
template <typename T>
__global__ void fused_cn_tridiag_global_kernel(const T* __restrict__ lhs,
                                               const T* __restrict__ z,
                                               const T* __restrict__ params,
                                               const T* __restrict__ c,
                                               T* __restrict__ x, int64_t n,
                                               int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const T* a = lhs;
  const T* inv = lhs + n;
  const T* chat = lhs + 2 * n;
  const T sl = __ldg(params + 0), sc = __ldg(params + 1);
  const T sr = __ldg(params + 2), v_last = __ldg(params + 3);
  const T inv_sm = __ldg(params + 4);

  // forward: d^_i = (rhs_i - a_i d^_{i-1}) inv_i, rhs from the window
  const T c_first = c[j];
  T cm1 = c[wrap(n - 1, n) * m + j], c0 = c_first;
  T dh = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const T cp1 = i + 1 < n ? c[(i + 1) * m + j] : c_first;
    const T r = sl * cm1 + sc * c0 + sr * cp1;
    dh = (r - __ldg(a + i) * dh) * __ldg(inv + i);
    x[i * m + j] = dh;
    cm1 = c0;
    c0 = cp1;
  }
  const T y_last = dh;

  // backward: y_i = d^_i - c^_i y_{i+1}
  T y = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t k = i * m + j;
    y = x[k] - __ldg(chat + i) * y;
    x[k] = y;
  }

  // rank-1 Sherman-Morrison correction
  const T corr = (y + v_last * y_last) * inv_sm;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = i * m + j;
    x[k] = x[k] - corr * __ldg(z + i);
  }
}

// lhs (5, N) [eps, beta, inv_alpha, gamma, delta] of A'; zz (N, 4);
// minv (4, 4); params [w0..w4, a0, b0, a1, eN2, dN1, eN1, ...].  N >= 2.
template <typename T>
__global__ void fused_cn_penta_global_kernel(const T* __restrict__ lhs,
                                             const T* __restrict__ zz,
                                             const T* __restrict__ minv,
                                             const T* __restrict__ params,
                                             const T* __restrict__ c,
                                             T* __restrict__ x, int64_t n,
                                             int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const T* eps = lhs;
  const T* beta = lhs + n;
  const T* inv_alpha = lhs + 2 * n;
  const T* gamma = lhs + 3 * n;
  const T* delta = lhs + 4 * n;
  T w[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) w[t] = __ldg(params + t);

  // forward: g_i = (rhs_i - eps_i g_{i-2} - beta_i g_{i-1}) inv_alpha_i
  T cm2 = c[wrap(-2, n) * m + j], cm1 = c[wrap(-1, n) * m + j];
  T c0 = c[j], cp1 = c[wrap(1, n) * m + j], cp2 = c[wrap(2, n) * m + j];
  T g1 = T(0), g2 = T(0);
  for (int64_t i = 0; i < n; ++i) {
    T r = w[0] * cm2;
    r = r + w[1] * cm1;
    r = r + w[2] * c0;
    r = r + w[3] * cp1;
    r = r + w[4] * cp2;
    const T g = (r - __ldg(eps + i) * g2 - __ldg(beta + i) * g1) *
                __ldg(inv_alpha + i);
    x[i * m + j] = g;
    g2 = g1;
    g1 = g;
    cm2 = cm1;
    cm1 = c0;
    c0 = cp1;
    cp1 = cp2;
    if (i + 1 < n) cp2 = c[wrap(i + 3, n) * m + j];
  }

  // backward: y_i = g_i - gamma_i y_{i+1} - delta_i y_{i+2}
  const T yN1 = g1;
  T yN2 = g1, y1 = T(0), y2 = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t k = i * m + j;
    const T y = x[k] - __ldg(gamma + i) * y1 - __ldg(delta + i) * y2;
    x[k] = y;
    if (i == n - 2) yN2 = y;
    y2 = y1;
    y1 = y;
  }
  const T y0 = y1, y_1 = y2;   // rows 0 and 1

  // rank-4 Woodbury correction: x = y - Z (Minv V^T y)
  const T a0 = __ldg(params + 5), b0 = __ldg(params + 6);
  const T a1 = __ldg(params + 7), eN2 = __ldg(params + 8);
  const T dN1 = __ldg(params + 9), eN1 = __ldg(params + 10);
  const T vty[4] = {a0 * yN2 + b0 * yN1, a1 * yN1, eN2 * y0,
                    dN1 * y0 + eN1 * y_1};
  T wv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T acc = __ldg(minv + 4 * r) * vty[0];
#pragma unroll
    for (int q = 1; q < 4; ++q) acc = acc + __ldg(minv + 4 * r + q) * vty[q];
    wv[r] = acc;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = i * m + j;
    const T* zi = zz + 4 * i;
    T corr = __ldg(zi) * wv[0];
    corr = corr + __ldg(zi + 1) * wv[1];
    corr = corr + __ldg(zi + 2) * wv[2];
    corr = corr + __ldg(zi + 3) * wv[3];
    x[k] = x[k] - corr;
  }
}

// ---------------------------------------------------------------------------
// On-chip route: the tile held in shared memory through all three passes
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's newest groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
static_assert(GROUPS == 4, "cp_async_wait covers 0..3 pending groups");

// One row of Z (N, 4), read as one 16-byte (float) or two (double) loads.
template <typename T>
struct Row4 {
  T v[4];
};

__device__ __forceinline__ Row4<float> load_row4(const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}

__device__ __forceinline__ Row4<double> load_row4(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {{a.x, a.y, b.x, b.y}};
}

// first row of chunk k of p over n rows (the plain versions' chunk_bounds)
__device__ __forceinline__ int chunk_begin(int k, int n, int p) {
  return (int)(((int64_t)k * n) / p);
}

// first row of commit group g of the chunk [s, e)
__device__ __forceinline__ int group_begin(int g, int s, int e) {
  return s + (e - s) * g / GROUPS;
}

// Issue the copy of this thread's rows [s, e) of its column of c into its
// column of the tile, one commit group per quarter of the chunk.
template <typename T>
__device__ __forceinline__ void load_chunk(T* col, const T* cj, int s, int e,
                                           int64_t m) {
  for (int g = 0; g < GROUPS; ++g) {
    for (int i = group_begin(g, s, e); i < group_begin(g + 1, s, e); ++i) {
      cp_async(col + i * TILE_M, cj + (int64_t)i * m);
    }
    cp_async_commit();
  }
}

// Wait until every row of [s, last] has landed in this thread's column.
__device__ __forceinline__ void wait_rows(int last, int s, int e) {
  int g = 0;
  while (g < GROUPS - 1 && group_begin(g + 1, s, e) <= last) ++g;
  cp_async_wait(GROUPS - 1 - g);
}

// The split sweep.  A block is P warps over one tile of TILE_M columns;
// warp k sweeps rows [s_k, e_k) = [k N / P, (k + 1) N / P) of every column
// from zero carries, so a dependent chain is N / P steps long, not N.  The
// true sweep is the chunk's sweep plus the chunk's response to a unit
// carry times the carry it really receives.  The responses depend on the
// factor only: each lane runs them beside its own sweep, on the
// coefficients that sweep loads anyway (an independent chain, so nearly
// free), and lanes 0 and 1 store them in the rows of shared memory after
// the tile.  The carries are chained over the P chunk ends in shared
// memory after a barrier.  So each pass adds one FMA per element per
// carry, and P = 1 is the plain sequential sweep (its carries are zero).
// fused_cn_{tridiag,penta}_plain and carry_responses repeat this order.

template <typename T>
__global__ void __launch_bounds__(MAX_CHUNKS * TILE_M)
    fused_cn_tridiag_tile_kernel(const T* __restrict__ lhs,
                                 const T* __restrict__ z,
                                 const T* __restrict__ params,
                                 const T* __restrict__ c, T* __restrict__ x,
                                 int n, int64_t m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* resp_f = tile + n * TILE_M;   // forward response to d^_{s-1} = 1
  T* resp_b = resp_f + n;          // backward response to y_e = 1
  const int lane = threadIdx.x % TILE_M, k = threadIdx.x / TILE_M;
  const int p = blockDim.x / TILE_M;
  const int s = chunk_begin(k, n, p), e = chunk_begin(k + 1, n, p);
  const int64_t j = (int64_t)blockIdx.x * TILE_M + lane;
  // a masked lane sweeps a real column (the last) and stores nothing; it
  // still reaches every barrier
  const T* cj = c + (j < m ? j : m - 1);
  T* col = tile + lane;
  const T* a = lhs;
  const T* inv = lhs + n;
  const T* chat = lhs + 2 * n;

  // the stencil's halo rows s - 1 and e, straight from device memory
  const T c_lo = __ldg(cj + wrap(s - 1, n) * m);
  const T c_hi = __ldg(cj + wrap(e, n) * m);
  load_chunk(col, cj, s, e, m);
  const T sl = __ldg(params + 0), sc = __ldg(params + 1);
  const T sr = __ldg(params + 2), v_last = __ldg(params + 3);
  const T inv_sm = __ldg(params + 4);

  // forward from a zero carry: d^0_i over c_i in place (row i + 1 is the
  // window's look-ahead, row e the halo); beside it the forward response
  // rf to d^_{s-1} = 1
  wait_rows(s, s, e);
  T cm1 = c_lo, c0 = col[s * TILE_M];
  T dh = T(0), rf = T(1);
  for (int g = 0; g < GROUPS; ++g) {
    const int lo = group_begin(g, s, e), hi = group_begin(g + 1, s, e);
    if (lo == hi) continue;
    wait_rows(min(hi, e - 1), s, e);
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      const T cp1 = i + 1 < e ? col[(i + 1) * TILE_M] : c_hi;
      const T r = sl * cm1 + sc * c0 + sr * cp1;
      const T ai = __ldg(a + i), invi = __ldg(inv + i);
      dh = (r - ai * dh) * invi;
      rf = (T(0) - ai * rf) * invi;
      col[i * TILE_M] = dh;
      if (lane == 0) resp_f[i] = rf;
      cm1 = c0;
      c0 = cp1;
    }
  }
  __syncthreads();

  // the carry into this chunk, d^_{s-1}, chained over the chunk ends; the
  // chain's end is d^_{N-1} = y_{N-1}
  T carry = T(0), carry_in = T(0);
  for (int q = 0; q < p; ++q) {
    if (q == k) carry_in = carry;
    const int last = chunk_begin(q + 1, n, p) - 1;
    carry = col[last * TILE_M] + resp_f[last] * carry;
  }
  const T y_last = carry;
  __syncthreads();   // every chunk end read before the backward overwrites

  // backward from a zero carry on the corrected d^: y^0_i in place, and
  // beside it the backward response rb to y_e = 1; UNROLL rows at a time,
  // every load of a batch ahead of its stores (the compiler cannot tell
  // the response rows from the tile's)
  T y = T(0), rb = T(1);
  int i = e - 1;
  for (; i - (UNROLL - 1) >= s; i -= UNROLL) {
    T d[UNROLL], r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      d[u] = col[(i - u) * TILE_M];
      r[u] = resp_f[i - u];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const T ch = __ldg(chat + i - u);
      y = (d[u] + r[u] * carry_in) - ch * y;
      rb = T(0) - ch * rb;
      d[u] = y;
      r[u] = rb;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      col[(i - u) * TILE_M] = d[u];
      if (lane == 0) resp_b[i - u] = r[u];
    }
  }
  for (; i >= s; --i) {
    const T ch = __ldg(chat + i);
    y = (col[i * TILE_M] + resp_f[i] * carry_in) - ch * y;
    rb = T(0) - ch * rb;
    col[i * TILE_M] = y;
    if (lane == 0) resp_b[i] = rb;
  }
  __syncthreads();

  // the carry into this chunk from above, y_e, chained down over the chunk
  // starts; the chain's end is y_0
  T ycarry = T(0), ycarry_in = T(0);
  for (int q = p - 1; q >= 0; --q) {
    if (q == k) ycarry_in = ycarry;
    const int first = chunk_begin(q, n, p);
    ycarry = col[first * TILE_M] + resp_b[first] * ycarry;
  }

  // rank-1 Sherman-Morrison correction, x written once
  const T corr = (ycarry + v_last * y_last) * inv_sm;
  if (j >= m) return;
  T* xj = x + j;
#pragma unroll 4
  for (int i = s; i < e; ++i) {
    xj[(int64_t)i * m] =
        (col[i * TILE_M] + resp_b[i] * ycarry_in) - corr * __ldg(z + i);
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_CHUNKS * TILE_M)
    fused_cn_penta_tile_kernel(const T* __restrict__ lhs,
                               const T* __restrict__ zz,
                               const T* __restrict__ minv,
                               const T* __restrict__ params,
                               const T* __restrict__ c, T* __restrict__ x,
                               int n, int64_t m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  // responses: forward to g_{s-1} = 1 and to g_{s-2} = 1, backward to
  // y_e = 1 and to y_{e+1} = 1
  T* resp = tile + n * TILE_M;
  const T* ru = resp;
  const T* rv = resp + n;
  const T* rw = resp + 2 * n;
  const T* rq = resp + 3 * n;
  const int lane = threadIdx.x % TILE_M, k = threadIdx.x / TILE_M;
  const int p = blockDim.x / TILE_M;
  const int s = chunk_begin(k, n, p), e = chunk_begin(k + 1, n, p);
  const int64_t j = (int64_t)blockIdx.x * TILE_M + lane;
  const T* cj = c + (j < m ? j : m - 1);
  T* col = tile + lane;
  const T* eps = lhs;
  const T* beta = lhs + n;
  const T* inv_alpha = lhs + 2 * n;
  const T* gamma = lhs + 3 * n;
  const T* delta = lhs + 4 * n;

  // the stencil's halo rows s - 2, s - 1, e and e + 1 (a chunk has at
  // least two rows), straight from device memory
  const T h_m2 = __ldg(cj + wrap(s - 2, n) * m);
  const T h_m1 = __ldg(cj + wrap(s - 1, n) * m);
  const T h_p0 = __ldg(cj + wrap(e, n) * m);
  const T h_p1 = __ldg(cj + wrap(e + 1, n) * m);
  load_chunk(col, cj, s, e, m);
  T w[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) w[t] = __ldg(params + t);

  // forward from zero carries: g^0_i over c_i in place (row i + 3 is the
  // window's look-ahead, rows e and e + 1 the halo); beside it a forward
  // response (v1, v2) = one and two rows back: even lanes the one to
  // g_{s-1} = 1, odd lanes the one to g_{s-2} = 1, stored by lanes 0 and 1
  wait_rows(min(s + 2, e - 1), s, e);
  const bool odd = lane & 1;
  T* resp_lane = resp + (lane & 1) * n;
  T cm2 = h_m2, cm1 = h_m1, c0 = col[s * TILE_M];
  T cp1 = s + 1 < e ? col[(s + 1) * TILE_M] : h_p0;
  T cp2 = s + 2 < e ? col[(s + 2) * TILE_M] : (s + 2 == e ? h_p0 : h_p1);
  T g1 = T(0), g2 = T(0);
  T v1 = odd ? T(0) : T(1), v2 = odd ? T(1) : T(0);
  for (int g = 0; g < GROUPS; ++g) {
    const int lo = group_begin(g, s, e), hi = group_begin(g + 1, s, e);
    if (lo == hi) continue;
    wait_rows(min(hi + 2, e - 1), s, e);
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      T r = w[0] * cm2;
      r = r + w[1] * cm1;
      r = r + w[2] * c0;
      r = r + w[3] * cp1;
      r = r + w[4] * cp2;
      const T ei = __ldg(eps + i), bi = __ldg(beta + i);
      const T iai = __ldg(inv_alpha + i);
      const T gi = (r - ei * g2 - bi * g1) * iai;
      const T vi = (T(0) - ei * v2 - bi * v1) * iai;
      col[i * TILE_M] = gi;
      if (lane < 2) resp_lane[i] = vi;
      g2 = g1;
      g1 = gi;
      v2 = v1;
      v1 = vi;
      cm2 = cm1;
      cm1 = c0;
      c0 = cp1;
      cp1 = cp2;
      const int i3 = i + 3;
      cp2 = i3 < e ? col[i3 * TILE_M] : (i3 == e ? h_p0 : h_p1);
    }
  }
  __syncthreads();

  // the carries into this chunk, (g_{s-1}, g_{s-2}), chained over the chunk
  // ends; the chain's end is (g_{N-1}, g_{N-2}), and y_{N-1} = g_{N-1}
  T G1 = T(0), G2 = T(0), in1 = T(0), in2 = T(0);
  for (int q = 0; q < p; ++q) {
    if (q == k) {
      in1 = G1;
      in2 = G2;
    }
    const int l1 = chunk_begin(q + 1, n, p) - 1, l2 = l1 - 1;
    const T n1 = col[l1 * TILE_M] + ru[l1] * G1 + rv[l1] * G2;
    const T n2 = col[l2 * TILE_M] + ru[l2] * G1 + rv[l2] * G2;
    G1 = n1;
    G2 = n2;
  }
  const T yN1 = G1;
  __syncthreads();   // every chunk end read before the backward overwrites

  // backward from zero carries on the corrected g: y^0_i in place, and
  // beside it a backward response (even lanes to y_e = 1, odd lanes to
  // y_{e+1} = 1); UNROLL rows at a time, every load of a batch ahead of
  // its stores
  T y1 = T(0), y2 = T(0);
  T w1 = odd ? T(0) : T(1), w2 = odd ? T(1) : T(0);
  resp_lane += 2 * n;
  int i = e - 1;
  for (; i - (UNROLL - 1) >= s; i -= UNROLL) {
    T d[UNROLL], ua[UNROLL], va[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      d[u] = col[(i - u) * TILE_M];
      ua[u] = ru[i - u];
      va[u] = rv[i - u];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const T gm = __ldg(gamma + i - u), dl = __ldg(delta + i - u);
      const T gi = d[u] + ua[u] * in1 + va[u] * in2;
      const T yi = gi - gm * y1 - dl * y2;
      const T wi = T(0) - gm * w1 - dl * w2;
      d[u] = yi;
      ua[u] = wi;
      y2 = y1;
      y1 = yi;
      w2 = w1;
      w1 = wi;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      col[(i - u) * TILE_M] = d[u];
      if (lane < 2) resp_lane[i - u] = ua[u];
    }
  }
  for (; i >= s; --i) {
    const T gm = __ldg(gamma + i), dl = __ldg(delta + i);
    const T gi = col[i * TILE_M] + ru[i] * in1 + rv[i] * in2;
    const T yi = gi - gm * y1 - dl * y2;
    const T wi = T(0) - gm * w1 - dl * w2;
    col[i * TILE_M] = yi;
    if (lane < 2) resp_lane[i] = wi;
    y2 = y1;
    y1 = yi;
    w2 = w1;
    w1 = wi;
  }
  __syncthreads();

  // the carries into this chunk from above, (y_e, y_{e+1}), chained down
  // over the chunk starts; the chain's end is (y_0, y_1).  The last chunk
  // gets zero carries, so its row N - 2 holds y_{N-2} already.
  T Y1 = T(0), Y2 = T(0), yi1 = T(0), yi2 = T(0);
  for (int q = p - 1; q >= 0; --q) {
    if (q == k) {
      yi1 = Y1;
      yi2 = Y2;
    }
    const int f0 = chunk_begin(q, n, p), f1 = f0 + 1;
    const T n1 = col[f0 * TILE_M] + rw[f0] * Y1 + rq[f0] * Y2;
    const T n2 = col[f1 * TILE_M] + rw[f1] * Y1 + rq[f1] * Y2;
    Y1 = n1;
    Y2 = n2;
  }
  const T y0 = Y1, y_1 = Y2, yN2 = col[(n - 2) * TILE_M];

  // rank-4 Woodbury correction: x = y - Z (Minv V^T y), x written once
  const T a0 = __ldg(params + 5), b0 = __ldg(params + 6);
  const T a1 = __ldg(params + 7), eN2 = __ldg(params + 8);
  const T dN1 = __ldg(params + 9), eN1 = __ldg(params + 10);
  const T vty[4] = {a0 * yN2 + b0 * yN1, a1 * yN1, eN2 * y0,
                    dN1 * y0 + eN1 * y_1};
  T wv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T acc = __ldg(minv + 4 * r) * vty[0];
#pragma unroll
    for (int q = 1; q < 4; ++q) acc = acc + __ldg(minv + 4 * r + q) * vty[q];
    wv[r] = acc;
  }
  if (j >= m) return;
  T* xj = x + j;
#pragma unroll 4
  for (int i = s; i < e; ++i) {
    const Row4<T> zi = load_row4(zz + 4 * i);
    T corr = zi.v[0] * wv[0];
    corr = corr + zi.v[1] * wv[1];
    corr = corr + zi.v[2] * wv[2];
    corr = corr + zi.v[3] * wv[3];
    xj[(int64_t)i * m] =
        (col[i * TILE_M] + rw[i] * yi1 + rq[i] * yi2) - corr;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T>
const void* tile_kernel(int bandwidth) {
  return bandwidth == 3 ? (const void*)fused_cn_tridiag_tile_kernel<T>
                        : (const void*)fused_cn_penta_tile_kernel<T>;
}

// Opt the on-chip kernel in to `smem` bytes of dynamic shared memory, with
// the SM's unified memory carved out for shared memory first.
template <typename T>
cudaError_t prepare_tile_kernel(int bandwidth, size_t smem) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const void* fn = tile_kernel<T>(bandwidth);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Shared memory of an on-chip block: the tile and the response rows.
template <typename T>
size_t tile_smem(int64_t n) {
  return (size_t)n * (TILE_M + RESP_ROWS) * sizeof(T);
}

// An on-chip block of `chunks` warps takes N when every chunk has a row
// (two for the penta stencil's two-row carries) and its tile fits.
template <typename T>
bool tile_fits(int bandwidth, int64_t n, int chunks) {
  return chunks >= 1 && chunks <= MAX_CHUNKS &&
         n >= (int64_t)chunks * (bandwidth == 5 ? 2 : 1) &&
         tile_smem<T>(n) <= SMEM_MAX;
}

template <typename T>
int launch(int bandwidth, int chunks, const void* lhs, const void* z,
           const void* minv, const void* params, const void* c, void* x,
           int64_t n, int64_t m, int threads, cudaStream_t stream) {
  if ((bandwidth != 3 && bandwidth != 5) || (bandwidth == 5 && n < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const T* l = static_cast<const T*>(lhs);
  const T* zz = static_cast<const T*>(z);
  const T* mi = static_cast<const T*>(minv);
  const T* p = static_cast<const T*>(params);
  const T* cc = static_cast<const T*>(c);
  T* xx = static_cast<T*>(x);
  if (chunks > 0) {
    if (!tile_fits<T>(bandwidth, n, chunks) ||
        (bandwidth == 5 && reinterpret_cast<uintptr_t>(z) % 16 != 0)) {
      return (int)cudaErrorInvalidValue;
    }
    const size_t smem = tile_smem<T>(n);
    const cudaError_t e = prepare_tile_kernel<T>(bandwidth, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((m + TILE_M - 1) / TILE_M));
    const dim3 block(chunks * TILE_M);
    if (bandwidth == 3) {
      fused_cn_tridiag_tile_kernel<T><<<grid, block, smem, stream>>>(
          l, zz, p, cc, xx, (int)n, m);
    } else {
      fused_cn_penta_tile_kernel<T><<<grid, block, smem, stream>>>(
          l, zz, mi, p, cc, xx, (int)n, m);
    }
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((m + threads - 1) / threads));
  if (bandwidth == 3) {
    fused_cn_tridiag_global_kernel<T><<<grid, threads, 0, stream>>>(
        l, zz, p, cc, xx, n, m);
  } else {
    fused_cn_penta_global_kernel<T><<<grid, threads, 0, stream>>>(
        l, zz, mi, p, cc, xx, n, m);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int bandwidth, int64_t n, int chunks, int* blocks) {
  if (!tile_fits<T>(bandwidth, n, chunks)) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem<T>(n);
  cudaError_t e = prepare_tile_kernel<T>(bandwidth, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tile_kernel<T>(bandwidth), chunks * TILE_M, smem);
}

}  // namespace

// Plain C entry points for ctypes.
//
// fused_cn: one step.
//   dtype:     0 float, 1 double; every operand is contiguous, of that type
//   bandwidth: 3 fused_cn_tridiag (lhs (3, N), z (N,), params (8,); minv
//              is unused), 5 fused_cn_penta (lhs (5, N), z the (N, 4) Z,
//              minv (4, 4), params (16,); N >= 2)
//   chunks:    0 the global route, with `threads` threads a block; P in
//              1..16 the on-chip route with P row chunks (warps) a block
//              (`threads` unused): N * 36 * itemsize <= 232,448 bytes and
//              N >= P (tridiag) or 2P (penta)
// c and x are (N, M).  Returns cudaGetLastError() after the launch (0 on
// success), or the error that refused it.
extern "C" int fused_cn(int dtype, int bandwidth, int chunks,
                        const void* lhs, const void* z, const void* minv,
                        const void* params, const void* c, void* x,
                        long long n, long long m, int threads, void* stream) {
  if (n <= 0 || m <= 0 || threads <= 0 || threads > 1024 || chunks < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(bandwidth, chunks, lhs, z, minv, params, c, x, n,
                           m, threads, s);
    case 1:
      return launch<double>(bandwidth, chunks, lhs, z, minv, params, c, x, n,
                            m, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// fused_cn_onchip_blocks: blocks of the on-chip kernel for (dtype,
// bandwidth, N, chunks) that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int fused_cn_onchip_blocks(int dtype, int bandwidth, long long n,
                                      int chunks, int* blocks) {
  if (n <= 0 || (bandwidth != 3 && bandwidth != 5)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return blocks_per_sm<float>(bandwidth, n, chunks, blocks);
    case 1:
      return blocks_per_sm<double>(bandwidth, n, chunks, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
