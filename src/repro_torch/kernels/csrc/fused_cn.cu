// fused_cn — one periodic Crank-Nicolson time step, over an interleaved
// (N, M) batch of fields, for Hopper (sm_90a):
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
// Three routes, picked by repro_torch/kernels/fused_cn.py::route from
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
// Partitioned route (fused_cn_tridiag_partition / fused_cn_penta_partition),
// N > N_max, up to the about 12,000 rows the JAX step takes and beyond:
// each column is cut into B row blocks of about R rows (512 at fp32, 256
// at fp64: a 72 KB tile), as the shared sweep's partitioned route cuts it,
// and the step's solve is that route's shared-factor sweep on the core A'
// (the thomas_constant / penta_constant pass table), in four launches:
//   K0 (coefficients, from the factor alone): partition.cuh's
//     shared_coef_kernel, unchanged;
//   K1 (summaries): one thread a column walks its block's rows plus the
//     stencil's halo (r = 1 or 2 rows each side, wrapping), forms the RHS
//     in registers from a sliding window of 2r + 1 field rows (each row
//     read once) and sums weight * RHS into the block's 2r summaries:
//     NM words read, no dependent chain;
//   K2 (chain): partition.cuh's column walk over the blocks, which ends
//     with the forward values (f_{N-1}, f_{N-2}) and y (y_0, y_1): all the
//     corner correction needs (y_{N-1} = f_{N-1}; y_{N-2} = f_{N-2} -
//     gamma_{N-2} y_{N-1}).  So K2 writes each column's correction
//     scalar (tridiag) or its four Woodbury weights Minv V^T y (penta):
//     M or 4M words;
//   K3 (finish): the on-chip tile kernel on row block blockIdx.y from the
//     block's true entry carries: the RHS formed with the block's halo,
//     the block swept in chunks and fixed up, the correction subtracted,
//     x written once.
// About 3NM words plus O(B M): K1 reads the field, K3 reads it again and
// writes the next one.  No host synchronisation between the launches.
//
// Global route (fused_cn_tridiag_global / fused_cn_penta_global), forced
// only, at any N, to time the other routes against:
//   * one thread per field m over all N rows, walking its column three
//     times through device memory: the forward pass reads c and writes
//     d^ (g) into x, the backward pass reads and writes x, the correction
//     reads and writes x once more, about 6NM words.  It was the size route
//     past N_max until the partitioned route replaced it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

namespace {

constexpr int TILE_M = 32;          // columns of an on-chip tile: a warp
constexpr int RESP_ROWS = 4;        // response rows after the tile's rows
constexpr int COLUMN_THREADS = 256; // threads a block of K1 and K2

__device__ __forceinline__ int64_t wrap(int64_t k, int64_t n) {
  return k < 0 ? k + n : (k >= n ? k - n : k);
}

// The rank-4 Woodbury weights Minv V^T y from y's corner rows: V^T y =
// (a0 y_{N-2} + b0 y_{N-1}, a1 y_{N-1}, eN2 y_0, dN1 y_0 + eN1 y_1), the
// wrap coefficients at params[5..10].
template <typename T>
__device__ __forceinline__ void woodbury_weights(const T* __restrict__ minv,
                                                 const T* __restrict__ params,
                                                 T y0, T y_1, T yN2, T yN1,
                                                 T (&wv)[4]) {
  const T a0 = __ldg(params + 5), b0 = __ldg(params + 6);
  const T a1 = __ldg(params + 7), eN2 = __ldg(params + 8);
  const T dN1 = __ldg(params + 9), eN1 = __ldg(params + 10);
  const T vty[4] = {a0 * yN2 + b0 * yN1, a1 * yN1, eN2 * y0,
                    dN1 * y0 + eN1 * y_1};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T acc = __ldg(minv + 4 * r) * vty[0];
#pragma unroll
    for (int q = 1; q < 4; ++q) acc = acc + __ldg(minv + 4 * r + q) * vty[q];
    wv[r] = acc;
  }
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

  // rank-4 Woodbury correction: x = y - Z (Minv V^T y)
  T wv[4];
  woodbury_weights(minv, params, y1, y2, yN2, yN1, wv);   // y1, y2: rows 0, 1
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
// On-chip and partitioned routes: a tile held in shared memory through all
// three passes
// ---------------------------------------------------------------------------

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

// The split sweep.  A block is P warps over one tile of TILE_M columns;
// warp k sweeps rows [s_k, e_k) = [k R / P, (k + 1) R / P) of the tile's
// R rows from zero carries, so a dependent chain is R / P steps long, not
// R.  The true sweep is the chunk's sweep plus the chunk's response to a
// unit carry times the carry it really receives.  The responses depend on
// the factor only: each lane runs them beside its own sweep, on the
// coefficients that sweep loads anyway (an independent chain, so nearly
// free), and lanes 0 and 1 store them in the rows of shared memory after
// the tile.  The carries are chained over the P chunk ends in shared
// memory after a barrier.  So each pass adds one FMA per element per
// carry, and P = 1 is the plain sequential sweep (its carries are zero).
//
// On chip (PART false) the tile is all N rows, its chains start from zero
// and the correction comes from the chains' ends.  As the partitioned
// route's K3 (PART true) the tile is row block blockIdx.y of `blocks`,
// rows [rs, rs + R): its halo comes from the neighbouring blocks' rows,
// its chains start from the block's entry carries (`carries`, (B, 2,
// order, M)), and the correction is the column's from K2 (`corrs`).
// fused_cn_{tridiag,penta}_plain and carry_responses repeat this order.

template <typename T, bool PART>
__global__ void __launch_bounds__(MAX_CHUNKS * TILE_M)
    fused_cn_tridiag_tile_kernel(const T* __restrict__ lhs,
                                 const T* __restrict__ z,
                                 const T* __restrict__ params,
                                 const T* __restrict__ c, T* __restrict__ x,
                                 int n, int64_t m, int blocks,
                                 const T* __restrict__ carries,
                                 const T* __restrict__ corrs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = PART ? (int)blockIdx.y : 0;
  const int rs = PART ? part_begin(b, n, blocks) : 0;
  const int rows = PART ? part_begin(b + 1, n, blocks) - rs : n;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* resp_f = tile + rows * TILE_M;   // forward response to d^_{s-1} = 1
  T* resp_b = resp_f + rows;          // backward response to y_e = 1
  const int lane = threadIdx.x % TILE_M, k = threadIdx.x / TILE_M;
  const int p = blockDim.x / TILE_M;
  const int s = part_begin(k, rows, p), e = part_begin(k + 1, rows, p);
  const int64_t j = (int64_t)blockIdx.x * TILE_M + lane;
  // a masked lane sweeps a real column (the last) and stores nothing; it
  // still reaches every barrier
  const int64_t jc = j < m ? j : m - 1;
  const T* cj = c + jc;
  T* col = tile + lane;
  const T* a = lhs + rs;
  const T* inv = lhs + n + rs;
  const T* chat = lhs + 2 * n + rs;

  // the stencil's halo rows s - 1 and e, straight from device memory
  const T c_lo = __ldg(cj + wrap(rs + s - 1, n) * m);
  const T c_hi = __ldg(cj + wrap(rs + e, n) * m);
  load_rows<T, T, TILE_M>(col, cj + (int64_t)rs * m, s, e, m);
  const T sl = __ldg(params + 0), sc = __ldg(params + 1);
  const T sr = __ldg(params + 2);

  // forward from a zero carry: d^0_i over c_i in place (row i + 1 is the
  // window's look-ahead, row e the halo); beside it the forward response
  // rf to d^_{s-1} = 1
  wait_rows<T, T>(s, s, e);
  T cm1 = c_lo, c0 = col[s * TILE_M];
  T dh = T(0), rf = T(1);
  for (int g = 0; g < GROUPS; ++g) {
    const int lo = group_begin(g, s, e), hi = group_begin(g + 1, s, e);
    if (lo == hi) continue;
    wait_rows<T, T>(min(hi, e - 1), s, e);
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

  // the carry into this chunk, d^_{s-1}, chained over the chunk ends from
  // the tile's entry carry; on chip the chain's end is d^_{N-1} = y_{N-1}
  T carry = PART ? carries[(int64_t)(2 * b) * m + jc] : T(0);
  T carry_in = T(0);
  for (int q = 0; q < p; ++q) {
    if (q == k) carry_in = carry;
    const int last = part_begin(q + 1, rows, p) - 1;
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
  // starts from the tile's entry carry; on chip the chain's end is y_0
  T ycarry = PART ? carries[(int64_t)(2 * b + 1) * m + jc] : T(0);
  T ycarry_in = T(0);
  for (int q = p - 1; q >= 0; --q) {
    if (q == k) ycarry_in = ycarry;
    const int first = part_begin(q, rows, p);
    ycarry = col[first * TILE_M] + resp_b[first] * ycarry;
  }

  // rank-1 Sherman-Morrison correction, x written once
  const T corr = PART ? corrs[jc]
                      : (ycarry + __ldg(params + 3) * y_last) *
                            __ldg(params + 4);
  if (j >= m) return;
  T* xj = x + (int64_t)rs * m + j;
  const T* zb = z + rs;
#pragma unroll 4
  for (int i = s; i < e; ++i) {
    xj[(int64_t)i * m] =
        (col[i * TILE_M] + resp_b[i] * ycarry_in) - corr * __ldg(zb + i);
  }
}

template <typename T, bool PART>
__global__ void __launch_bounds__(MAX_CHUNKS * TILE_M)
    fused_cn_penta_tile_kernel(const T* __restrict__ lhs,
                               const T* __restrict__ zz,
                               const T* __restrict__ minv,
                               const T* __restrict__ params,
                               const T* __restrict__ c, T* __restrict__ x,
                               int n, int64_t m, int blocks,
                               const T* __restrict__ carries,
                               const T* __restrict__ corrs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = PART ? (int)blockIdx.y : 0;
  const int rs = PART ? part_begin(b, n, blocks) : 0;
  const int rows = PART ? part_begin(b + 1, n, blocks) - rs : n;
  T* tile = reinterpret_cast<T*>(smem_raw);
  // responses: forward to g_{s-1} = 1 and to g_{s-2} = 1, backward to
  // y_e = 1 and to y_{e+1} = 1
  T* resp = tile + rows * TILE_M;
  const T* ru = resp;
  const T* rv = resp + rows;
  const T* rw = resp + 2 * rows;
  const T* rq = resp + 3 * rows;
  const int lane = threadIdx.x % TILE_M, k = threadIdx.x / TILE_M;
  const int p = blockDim.x / TILE_M;
  const int s = part_begin(k, rows, p), e = part_begin(k + 1, rows, p);
  const int64_t j = (int64_t)blockIdx.x * TILE_M + lane;
  const int64_t jc = j < m ? j : m - 1;
  const T* cj = c + jc;
  T* col = tile + lane;
  const T* eps = lhs + rs;
  const T* beta = lhs + n + rs;
  const T* inv_alpha = lhs + 2 * n + rs;
  const T* gamma = lhs + 3 * n + rs;
  const T* delta = lhs + 4 * n + rs;

  // the stencil's halo rows s - 2, s - 1, e and e + 1 (a chunk has at
  // least two rows), straight from device memory
  const T h_m2 = __ldg(cj + wrap(rs + s - 2, n) * m);
  const T h_m1 = __ldg(cj + wrap(rs + s - 1, n) * m);
  const T h_p0 = __ldg(cj + wrap(rs + e, n) * m);
  const T h_p1 = __ldg(cj + wrap(rs + e + 1, n) * m);
  load_rows<T, T, TILE_M>(col, cj + (int64_t)rs * m, s, e, m);
  T w[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) w[t] = __ldg(params + t);

  // forward from zero carries: g^0_i over c_i in place (row i + 3 is the
  // window's look-ahead, rows e and e + 1 the halo); beside it a forward
  // response (v1, v2) = one and two rows back: even lanes the one to
  // g_{s-1} = 1, odd lanes the one to g_{s-2} = 1, stored by lanes 0 and 1
  wait_rows<T, T>(min(s + 2, e - 1), s, e);
  const bool odd = lane & 1;
  T* resp_lane = resp + (lane & 1) * rows;
  T cm2 = h_m2, cm1 = h_m1, c0 = col[s * TILE_M];
  T cp1 = s + 1 < e ? col[(s + 1) * TILE_M] : h_p0;
  T cp2 = s + 2 < e ? col[(s + 2) * TILE_M] : (s + 2 == e ? h_p0 : h_p1);
  T g1 = T(0), g2 = T(0);
  T v1 = odd ? T(0) : T(1), v2 = odd ? T(1) : T(0);
  for (int g = 0; g < GROUPS; ++g) {
    const int lo = group_begin(g, s, e), hi = group_begin(g + 1, s, e);
    if (lo == hi) continue;
    wait_rows<T, T>(min(hi + 2, e - 1), s, e);
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
  // ends from the tile's entry carries; on chip the chain's end is
  // (g_{N-1}, g_{N-2}), and y_{N-1} = g_{N-1}
  T G1 = PART ? carries[(int64_t)(4 * b) * m + jc] : T(0);
  T G2 = PART ? carries[(int64_t)(4 * b + 1) * m + jc] : T(0);
  T in1 = T(0), in2 = T(0);
  for (int q = 0; q < p; ++q) {
    if (q == k) {
      in1 = G1;
      in2 = G2;
    }
    const int l1 = part_begin(q + 1, rows, p) - 1, l2 = l1 - 1;
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
  resp_lane += 2 * rows;
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
  // over the chunk starts from the tile's entry carries; on chip the
  // chain's end is (y_0, y_1), and the last chunk gets zero carries, so its
  // row N - 2 holds y_{N-2} already
  T Y1 = PART ? carries[(int64_t)(4 * b + 2) * m + jc] : T(0);
  T Y2 = PART ? carries[(int64_t)(4 * b + 3) * m + jc] : T(0);
  T yi1 = T(0), yi2 = T(0);
  for (int q = p - 1; q >= 0; --q) {
    if (q == k) {
      yi1 = Y1;
      yi2 = Y2;
    }
    const int f0 = part_begin(q, rows, p), f1 = f0 + 1;
    const T n1 = col[f0 * TILE_M] + rw[f0] * Y1 + rq[f0] * Y2;
    const T n2 = col[f1 * TILE_M] + rw[f1] * Y1 + rq[f1] * Y2;
    Y1 = n1;
    Y2 = n2;
  }

  // rank-4 Woodbury correction: x = y - Z (Minv V^T y), x written once
  T wv[4];
  if constexpr (PART) {
#pragma unroll
    for (int r = 0; r < 4; ++r) wv[r] = corrs[r * m + jc];
  } else {
    woodbury_weights(minv, params, Y1, Y2, col[(n - 2) * TILE_M], yN1, wv);
  }
  if (j >= m) return;
  T* xj = x + (int64_t)rs * m + j;
  const T* zb = zz + 4 * (int64_t)rs;
#pragma unroll 4
  for (int i = s; i < e; ++i) {
    const Row4<T> zi = load_row4(zb + 4 * i);
    T corr = zi.v[0] * wv[0];
    corr = corr + zi.v[1] * wv[1];
    corr = corr + zi.v[2] * wv[2];
    corr = corr + zi.v[3] * wv[3];
    xj[(int64_t)i * m] =
        (col[i * TILE_M] + rw[i] * yi1 + rq[i] * yi2) - corr;
  }
}

// ---------------------------------------------------------------------------
// Partitioned route: K1 and K2 (K0 and K2's walk are partition.cuh's)
// ---------------------------------------------------------------------------

// K1: one thread a column of row block blockIdx.y forms the stencil RHS of
// the block's rows from a window of the 2R + 1 field rows around each
// (R = 1 tridiag, 2 penta; the halo wraps), each field row read once, and
// sums weights * RHS over the rows in row order: its 2R summaries (the
// sweep's order is R).  The weights are K0's (2R, N).
template <typename T, int R>
__global__ void fused_summary_kernel(const T* __restrict__ c,
                                     const T* __restrict__ params,
                                     const T* __restrict__ weights,
                                     T* __restrict__ summ, int n, int64_t m,
                                     int blocks) {
  constexpr int W = 2 * R + 1;
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int b = blockIdx.y;
  const int s = part_begin(b, n, blocks), e = part_begin(b + 1, n, blocks);
  const T* cj = c + j;
  T w[W], win[W], acc[2 * R];
#pragma unroll
  for (int t = 0; t < W; ++t) w[t] = __ldg(params + t);
#pragma unroll
  for (int t = 0; t < W - 1; ++t) win[t] = cj[wrap(s - R + t, n) * m];
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) acc[k] = T(0);
#pragma unroll 4
  for (int i = s; i < e; ++i) {
    win[W - 1] = cj[wrap(i + R, n) * m];
    T r = w[0] * win[0];
#pragma unroll
    for (int t = 1; t < W; ++t) r = r + w[t] * win[t];
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) {
      acc[k] = acc[k] + __ldg(weights + (int64_t)k * n + i) * r;
    }
#pragma unroll
    for (int t = 0; t < W - 1; ++t) win[t] = win[t + 1];
  }
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) {
    summ[((int64_t)b * 2 * R + k) * m + j] = acc[k];
  }
}

// K2: one thread a column chains the blocks' entry carries
// (partition.cuh's walk) and, from the chain's ends, writes the column's
// correction: the Sherman-Morrison scalar (y_0 + v_last y_{N-1}) inv_sm
// (tridiag, corrs (1, M)) or the Woodbury weights Minv V^T y (penta,
// corrs (4, M)), with y_{N-1} = f_{N-1} and y_{N-2} = f_{N-2} -
// gamma_{N-2} y_{N-1} (the backward pass's first two rows).
template <typename T, int ORDER>
__global__ void fused_chain_kernel(const T* __restrict__ summ,
                                   T* __restrict__ carries,
                                   const T* __restrict__ coefs, int blocks,
                                   int64_t m, const T* __restrict__ lhs,
                                   const T* __restrict__ minv,
                                   const T* __restrict__ params,
                                   T* __restrict__ corrs, int n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  T fend[ORDER], ystart[ORDER];
  chain_column<T, ORDER>(summ, carries, coefs, blocks, m, j, fend, ystart);
  if constexpr (ORDER == 1) {
    corrs[j] = (ystart[0] + __ldg(params + 3) * fend[0]) * __ldg(params + 4);
  } else {
    const T yN1 = fend[0];
    const T yN2 = fend[1] - __ldg(lhs + 3 * (int64_t)n + n - 2) * yN1;
    T wv[4];
    woodbury_weights(minv, params, ystart[0], ystart[1], yN2, yN1, wv);
#pragma unroll
    for (int r = 0; r < 4; ++r) corrs[r * m + j] = wv[r];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Route { GLOBAL = 0, ONCHIP = 1, PARTITION = 2 };

// One step's operands, typed.
template <typename T>
struct Step {
  const T* lhs;
  const T* z;      // z (N,) or Z (N, 4)
  const T* minv;   // penta only
  const T* params;
  const T* c;
  T* x;
  int n;
  int64_t m;
};

template <typename T>
const void* tile_kernel(int bandwidth, bool part) {
  if (bandwidth == 3) {
    return part ? (const void*)fused_cn_tridiag_tile_kernel<T, true>
                : (const void*)fused_cn_tridiag_tile_kernel<T, false>;
  }
  return part ? (const void*)fused_cn_penta_tile_kernel<T, true>
              : (const void*)fused_cn_penta_tile_kernel<T, false>;
}

// Shared memory of a tile over `rows` rows: the tile and the response rows.
template <typename T>
size_t tile_smem(int64_t rows) {
  return (size_t)rows * (TILE_M + RESP_ROWS) * sizeof(T);
}

// Tiles of `chunks` warps over `blocks` row blocks take N when every chunk
// of every block has a row (two for the penta stencil's two-row carries)
// and the largest block's tile fits.
template <typename T>
bool tiles_fit(int bandwidth, int64_t n, int blocks, int chunks) {
  return blocks >= 1 && chunks >= 1 && chunks <= MAX_CHUNKS &&
         n / blocks >= (int64_t)chunks * (bandwidth == 5 ? 2 : 1) &&
         tile_smem<T>((n + blocks - 1) / blocks) <= SMEM_MAX;
}

template <typename T>
int launch_tile(int bandwidth, bool part, const Step<T>& st, int blocks,
                int chunks, const T* carries, const T* corrs,
                cudaStream_t stream) {
  const size_t smem = tile_smem<T>((st.n + blocks - 1) / blocks);
  const cudaError_t e = prepare(tile_kernel<T>(bandwidth, part), smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((st.m + TILE_M - 1) / TILE_M), (unsigned)blocks);
  const dim3 block(chunks * TILE_M);
  if (bandwidth == 3) {
    if (part) {
      fused_cn_tridiag_tile_kernel<T, true><<<grid, block, smem, stream>>>(
          st.lhs, st.z, st.params, st.c, st.x, st.n, st.m, blocks, carries,
          corrs);
    } else {
      fused_cn_tridiag_tile_kernel<T, false><<<grid, block, smem, stream>>>(
          st.lhs, st.z, st.params, st.c, st.x, st.n, st.m, 1, nullptr,
          nullptr);
    }
  } else if (part) {
    fused_cn_penta_tile_kernel<T, true><<<grid, block, smem, stream>>>(
        st.lhs, st.z, st.minv, st.params, st.c, st.x, st.n, st.m, blocks,
        carries, corrs);
  } else {
    fused_cn_penta_tile_kernel<T, false><<<grid, block, smem, stream>>>(
        st.lhs, st.z, st.minv, st.params, st.c, st.x, st.n, st.m, 1, nullptr,
        nullptr);
  }
  return (int)cudaGetLastError();
}

// The partitioned route's K0-K3 (stage 0), or one of them alone (stage
// 1-4), on the workspace `work`: summaries (B, 2, order, M), carries (the
// same), coefficients (B, 3, order, order), summary weights (2, order, N),
// corrections (1 or 4, M).
template <typename T>
int launch_partition(int bandwidth, const Step<T>& st, int blocks, int chunks,
                     int stage, void* work, const SweepDesc& desc,
                     cudaStream_t stream) {
  const int order = bandwidth / 2;
  const int64_t m = st.m;
  T* summ = static_cast<T*>(work);
  T* carries = summ + (int64_t)2 * blocks * order * m;
  T* coefs = carries + (int64_t)2 * blocks * order * m;
  T* weights = coefs + 3 * blocks * order * order;
  T* corrs = weights + (int64_t)2 * order * st.n;
  int rc = 0;
  if (stage == 0 || stage == 1) {
    TileArgs a = {};
    a.lhs = st.lhs;
    a.lhs_rows = bandwidth;
    a.desc = desc;
    a.n = st.n;
    a.m = m;
    a.blocks = blocks;
    a.coefs = coefs;
    a.weights = weights;
    rc = launch_coefs<T, T>(a, order, stream);
  }
  const dim3 cols((unsigned)((m + COLUMN_THREADS - 1) / COLUMN_THREADS));
  if (rc == 0 && (stage == 0 || stage == 2)) {
    const dim3 grid(cols.x, (unsigned)blocks);
    if (order == 1) {
      fused_summary_kernel<T, 1><<<grid, COLUMN_THREADS, 0, stream>>>(
          st.c, st.params, weights, summ, st.n, m, blocks);
    } else {
      fused_summary_kernel<T, 2><<<grid, COLUMN_THREADS, 0, stream>>>(
          st.c, st.params, weights, summ, st.n, m, blocks);
    }
    rc = (int)cudaGetLastError();
  }
  if (rc == 0 && (stage == 0 || stage == 3)) {
    if (order == 1) {
      fused_chain_kernel<T, 1><<<cols, COLUMN_THREADS, 0, stream>>>(
          summ, carries, coefs, blocks, m, st.lhs, st.minv, st.params, corrs,
          st.n);
    } else {
      fused_chain_kernel<T, 2><<<cols, COLUMN_THREADS, 0, stream>>>(
          summ, carries, coefs, blocks, m, st.lhs, st.minv, st.params, corrs,
          st.n);
    }
    rc = (int)cudaGetLastError();
  }
  if (rc == 0 && (stage == 0 || stage == 4)) {
    rc = launch_tile<T>(bandwidth, true, st, blocks, chunks, carries, corrs,
                        stream);
  }
  return rc;
}

template <typename T>
int launch(int bandwidth, int route, int blocks, int chunks, int stage,
           const Step<T>& st, void* work, const int* desc, int threads,
           cudaStream_t stream) {
  if (route == GLOBAL) {
    if (stage != 0 || threads <= 0 || threads > 1024) {
      return (int)cudaErrorInvalidValue;
    }
    const dim3 grid((unsigned)((st.m + threads - 1) / threads));
    if (bandwidth == 3) {
      fused_cn_tridiag_global_kernel<T><<<grid, threads, 0, stream>>>(
          st.lhs, st.z, st.params, st.c, st.x, st.n, st.m);
    } else {
      fused_cn_penta_global_kernel<T><<<grid, threads, 0, stream>>>(
          st.lhs, st.z, st.minv, st.params, st.c, st.x, st.n, st.m);
    }
    return (int)cudaGetLastError();
  }
  const bool part = route == PARTITION;
  if ((part ? blocks < 2 : blocks != 1 || stage != 0) ||
      !tiles_fit<T>(bandwidth, st.n, blocks, chunks) ||
      (bandwidth == 5 && reinterpret_cast<uintptr_t>(st.z) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!part) {
    return launch_tile<T>(bandwidth, false, st, 1, chunks, nullptr, nullptr,
                          stream);
  }
  if (work == nullptr || desc == nullptr || desc[0] != bandwidth / 2) {
    return (int)cudaErrorInvalidValue;
  }
  SweepDesc d;
  d.fwd = read_pass(desc + 1);
  d.bwd = read_pass(desc + 6);
  if (!desc_fits(d, bandwidth / 2, bandwidth, false) || d.fwd.scale < 0) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_partition<T>(bandwidth, st, blocks, chunks, stage, work, d,
                             stream);
}

template <typename T>
int blocks_per_sm(int bandwidth, int64_t n, int chunks, int* blocks) {
  if (!tiles_fit<T>(bandwidth, n, 1, chunks)) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem<T>(n);
  const void* fn = tile_kernel<T>(bandwidth, false);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, chunks * TILE_M, smem);
}

template <typename T>
int run(int bandwidth, int route, int blocks, int chunks, int stage,
        const void* lhs, const void* z, const void* minv, const void* params,
        const void* c, void* x, void* work, const int* desc, int64_t n,
        int64_t m, int threads, cudaStream_t stream) {
  Step<T> st;
  st.lhs = static_cast<const T*>(lhs);
  st.z = static_cast<const T*>(z);
  st.minv = static_cast<const T*>(minv);
  st.params = static_cast<const T*>(params);
  st.c = static_cast<const T*>(c);
  st.x = static_cast<T*>(x);
  st.n = (int)n;
  st.m = m;
  return launch<T>(bandwidth, route, blocks, chunks, stage, st, work, desc,
                   threads, stream);
}

}  // namespace

// Plain C entry points for ctypes.
//
// fused_cn: one step.
//   dtype:     0 float, 1 double; every operand is contiguous, of that type
//   bandwidth: 3 fused_cn_tridiag (lhs (3, N), z (N,), params (8,); minv
//              is unused), 5 fused_cn_penta (lhs (5, N), z the (N, 4) Z,
//              16-byte aligned on the tile routes, minv (4, 4), params
//              (16,); N >= 2)
//   route:     0 global (`threads` threads a block; blocks, chunks, work
//              and desc unused), 1 on chip (blocks = 1), 2 partitioned
//              (blocks >= 2; work: 4 B order M + 3 B order^2 + 2 order N +
//              (1 or 4) M elements, order = bandwidth / 2; desc: the 11
//              ints of the thomas_constant / penta_constant pass table,
//              [order, fwd src0 lag0 src1 lag1 scale, bwd ...])
//   blocks, chunks: row blocks and row chunks (warps) a block's tile,
//              1..16; every chunk needs a row (two for penta) and the
//              largest block's tile N / B * 36 * itemsize <= 232,448 bytes
//   stage:     0 the whole step; on the partitioned route 1, 2, 3 or 4
//              launches K0, K1, K2 or K3 alone (to time them)
// c and x are (N, M).  Returns the first launch error (0 on success), or
// the error that refused the arguments.
extern "C" int fused_cn(int dtype, int bandwidth, int route, int blocks,
                        int chunks, int stage, const void* lhs, const void* z,
                        const void* minv, const void* params, const void* c,
                        void* x, void* work, const int* desc, long long n,
                        long long m, int threads, void* stream) {
  if (n <= 0 || n > INT32_MAX || m <= 0 || route < GLOBAL ||
      route > PARTITION || stage < 0 || stage > 4 ||
      (bandwidth != 3 && bandwidth != 5) || (bandwidth == 5 && n < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run<float>(bandwidth, route, blocks, chunks, stage, lhs, z, minv,
                        params, c, x, work, desc, n, m, threads, s);
    case 1:
      return run<double>(bandwidth, route, blocks, chunks, stage, lhs, z,
                         minv, params, c, x, work, desc, n, m, threads, s);
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
