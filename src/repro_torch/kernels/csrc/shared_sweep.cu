// shared_sweep — the two-pass banded sweep of ONE shared factored LHS over
// an interleaved (N, M) batch of right-hand sides, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/engine.py
// that compute this one function at three VMEM tilings:
//   _shared_resident_kernel (engine.py:760), _shared_streamed_kernel
//   (engine.py:777), _shared_fused_kernel (engine.py:795).
//
// Each pass is  out_i = (in_i - sum_t coef_t(i) * carry_{lag_t}) * scale(i)
// with the (row, lag) terms in subtraction order and the scale row taken
// from the pass table (repro_torch/kernels/engine.py::_PASS_TABLE) and
// handed in as a SweepDesc: one template serves tridiagonal and
// pentadiagonal, forward and transposed, constant and uniform variants.
// Storage float, double or bf16 (bf16 computes in float); the output is at
// the compute type.  Built without --use_fast_math; nvcc contracts a - b*c
// into FMAs, so the kernels and their plain version agree to a few ulps.
//
// Bound: device-memory bytes.  The function needs 2NM + kN words (each RHS
// word read once, each x word written once, k factor rows); its 4*order + 1
// operations per element are far below that at the card's rates.
//
// Three routes, picked by repro_torch/kernels/ops.py::shared_route from
// (N, dtype); every solve counts one launch under its spec's name.
//
// On-chip route, N <= N_max (1614 at fp32 and bf16, 807 at fp64):
//   * a block owns a tile of TILE columns (32; 16 when forced, to time it)
//     over all N rows in dynamic shared memory at the compute type, with
//     2 * order rows of carry responses after it (one per carry lag, per
//     pass); the route's N_max leaves room for 4 such rows at 32 columns,
//     the 232,448 bytes a block may opt in to;
//   * P row chunks, one group of TILE threads each (a warp at TILE = 32);
//     a thread owns one column of its chunk and alone loads it (cp.async,
//     4 or 8 bytes, in GROUPS commit groups, so its forward sweep starts
//     on the first group while the later ones are in flight; bf16 rides
//     plain loads, converted to float as they are stored, since cp.async
//     copies 4, 8 or 16 bytes and a ragged M leaves odd bf16 rows 2-byte
//     aligned), sweeps it forward and backward in place, and writes x to
//     device memory once: the 2NM floor;
//   * the split sweep: each chunk is swept from zero carries; after a
//     barrier the carries are chained over the chunk ends; each row is then
//     fixed up by its chunk's response to a unit carry times the carry the
//     chunk really receives.  The response of a pass to a unit carry at lag
//     l is that pass swept over zeros, r_i = (0 - sum_t coef_t(i) *
//     r_{i-lag_t}) * scale(i): even lanes run the one to lag 1 beside
//     their own sweep, odd lanes (order 2) the one to lag 2, on the
//     coefficients the sweep loads anyway, and lanes 0 and 1 store them.
//     A chain is N / P steps long, not 2N, and the SM runs P times the
//     warps of one thread a column;
//   * the factor rows and the uniform eps are read as broadcasts through
//     the read-only cache, and the pass table's shape (lags by direction,
//     one scaled pass) is compiled in, so a step is loads and FMAs;
//   * 3 blocks an SM at N = 512 fp32 (8 chunks), 1 at N = 1024 (16): the
//     times and what holds them at 1.7-3.1x the bound are in PERF.md.
//
// Partitioned route, N > N_max: each column is cut into B row blocks of
// about R rows (512 at fp32 and bf16, 256 at fp64; a 68-72 KB tile):
//   K0 (coefficients, B blocks, from the factor alone, once per call): each
//     row block's forward unit responses at its end (phi), the backward
//     sweep of those responses at its start (w), its backward unit
//     responses at its start (psi), and the summary weights: the adjoint
//     of the block's forward sweep from its `order` end rows, and of its
//     backward-after-forward sweep from its `order` start rows;
//   K1 (summarise): the block's forward end values and backward start
//     values from zero carries are linear in its rows of the RHS, so one
//     thread a column sums weight * rhs over the block's rows: 2 * order
//     words per column per block written, NM read with no dependent chain;
//   K2 (chain): one thread a column walks the blocks up to chain the forward
//     carries, then down to chain the backward ones;
//   K3 (finish): each block swept on chip as above from its true entry
//     carries, x written once.
// About 3NM words plus O(B M), against the 2NM floor; no host sync.
// K0, K2's column walk and the tile helpers live in partition.cuh, which
// fused_cn.cu's partitioned route shares.
//
// Serial route (forced only, to time against): the first design, one
// thread per system walking all N rows, the factor staged in shared memory
// SERIAL_CHUNK_N rows at a time; the intermediate round-trips through the
// output, about 4NM words.


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "partition.cuh"

namespace {

constexpr int SERIAL_THREADS = 256;
constexpr int SERIAL_CHUNK_N = 512;  // factor rows the serial kernel stages

// ---------------------------------------------------------------------------
// Serial route: the first design, one thread a column
// ---------------------------------------------------------------------------

// Stage rows [base, base + len) of the (rows, n) factor, plus the eps row
// when there is one, into coef[(rows + 1) * chunk_n] at the compute type.
template <typename S, typename C>
__device__ __forceinline__ void stage_chunk(C* coef, const S* __restrict__ lhs,
                                            int rows, int stage_rows,
                                            int64_t n, int64_t base, int len,
                                            int chunk_n, C eps_c) {
  const int total = stage_rows * len;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t / len;
    const int k = t - r * len;
    coef[r * chunk_n + k] =
        r < rows ? to_compute<C, S>(lhs[(int64_t)r * n + base + k]) : eps_c;
  }
}

template <int ORDER, typename C>
__device__ __forceinline__ C sweep_step(C acc, const C* coef, int chunk_n,
                                        int k, const PassDesc& p, C& h1,
                                        C& h2) {
  acc = acc - coef[p.src[0] * chunk_n + k] * (p.lag[0] == 1 ? h1 : h2);
  if (ORDER == 2) {
    acc = acc - coef[p.src[1] * chunk_n + k] * (p.lag[1] == 1 ? h1 : h2);
  }
  if (p.scale >= 0) acc = acc * coef[p.scale * chunk_n + k];
  h2 = h1;
  h1 = acc;
  return acc;
}

template <typename S, typename C, int ORDER>
__global__ void shared_serial_kernel(const S* __restrict__ lhs, int rows,
                                     const S* __restrict__ rhs, C* out,
                                     const S* __restrict__ eps, int64_t n,
                                     int64_t m, SweepDesc desc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* coef = reinterpret_cast<C*>(smem_raw);
  constexpr int chunk_n = SERIAL_CHUNK_N;

  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < m;
  const int stage_rows = rows + (eps != nullptr ? 1 : 0);
  const C eps_c = eps != nullptr ? to_compute<C, S>(eps[0]) : C(0);
  const int64_t num_chunks = (n + chunk_n - 1) / chunk_n;

  // forward pass, ascending: out <- intermediate (d_hat / g)
  C h1 = C(0), h2 = C(0);
  for (int64_t c = 0; c < num_chunks; ++c) {
    const int64_t base = c * chunk_n;
    const int len = (int)(n - base < chunk_n ? n - base : chunk_n);
    __syncthreads();  // the previous chunk's coefficients are consumed
    stage_chunk<S, C>(coef, lhs, rows, stage_rows, n, base, len, chunk_n,
                      eps_c);
    __syncthreads();
    if (active) {
      const S* in_row = rhs + base * m + j;
      C* out_row = out + base * m + j;
#pragma unroll 4
      for (int k = 0; k < len; ++k) {
        const C acc = to_compute<C, S>(in_row[(int64_t)k * m]);
        out_row[(int64_t)k * m] =
            sweep_step<ORDER>(acc, coef, chunk_n, k, desc.fwd, h1, h2);
      }
    }
  }

  // backward pass, descending, in place: out <- x
  h1 = C(0);
  h2 = C(0);
  for (int64_t c = num_chunks - 1; c >= 0; --c) {
    const int64_t base = c * chunk_n;
    const int len = (int)(n - base < chunk_n ? n - base : chunk_n);
    __syncthreads();
    stage_chunk<S, C>(coef, lhs, rows, stage_rows, n, base, len, chunk_n,
                      eps_c);
    __syncthreads();
    if (active) {
      C* row = out + base * m + j;
#pragma unroll 4
      for (int k = len - 1; k >= 0; --k) {
        const C acc = row[(int64_t)k * m];
        row[(int64_t)k * m] =
            sweep_step<ORDER>(acc, coef, chunk_n, k, desc.bwd, h1, h2);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// On-chip and partitioned routes: tiles held in shared memory
// ---------------------------------------------------------------------------

// K1: one thread a column of row block blockIdx.y sums weights * rhs over
// the block's rows, in row order: its 2 * order summaries.
template <typename S, typename C, int ORDER>
__global__ void shared_summary_kernel(const S* __restrict__ rhs,
                                      const C* __restrict__ weights,
                                      C* __restrict__ summ, int n, int64_t m,
                                      int blocks) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int b = blockIdx.y;
  const int s = part_begin(b, n, blocks), e = part_begin(b + 1, n, blocks);
  C acc[2 * ORDER];
#pragma unroll
  for (int k = 0; k < 2 * ORDER; ++k) acc[k] = C(0);
  const S* col = rhs + j;
#pragma unroll 8
  for (int i = s; i < e; ++i) {
    const C x = to_compute<C, S>(col[(int64_t)i * m]);
#pragma unroll
    for (int k = 0; k < 2 * ORDER; ++k) {
      acc[k] = acc[k] + __ldg(weights + (int64_t)k * n + i) * x;
    }
  }
#pragma unroll
  for (int k = 0; k < 2 * ORDER; ++k) {
    summ[((int64_t)b * 2 * ORDER + k) * m + j] = acc[k];
  }
}

// One tile: TILE columns of row block blockIdx.y, P = blockDim.x / TILE
// row chunks, from zero entry carries (the on-chip route: carries ==
// nullptr) or from the ones K2 chained (K3); writes x.
template <typename S, typename C, int ORDER, int TILE, bool SCALE_FWD>
__global__ void __launch_bounds__(MAX_CHUNKS * 32)
    shared_tile_kernel(const TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* tile = reinterpret_cast<C*>(smem_raw);
  const S* __restrict__ lhs = static_cast<const S*>(a.lhs);
  const S* __restrict__ eps = static_cast<const S*>(a.eps);
  const int n = a.n, nb = a.blocks, b = blockIdx.y;
  const int64_t m = a.m;
  const Pass<S, C, ORDER, true, SCALE_FWD> fw(a.desc.fwd, lhs, eps,
                                              a.lhs_rows, n);
  const Pass<S, C, ORDER, false, !SCALE_FWD> bw(a.desc.bwd, lhs, eps,
                                                a.lhs_rows, n);

  const int rs = part_begin(b, n, nb);
  const int rows = part_begin(b + 1, n, nb) - rs;
  C* resp = tile + rows * TILE;   // RF_0 (, RF_1), RB_0 (, RB_1), `rows` each
  const int lane = threadIdx.x % TILE, k = threadIdx.x / TILE;
  const int p = blockDim.x / TILE;
  const int s = part_begin(k, rows, p), e = part_begin(k + 1, rows, p);
  const int64_t j = (int64_t)blockIdx.x * TILE + lane;
  // a masked lane sweeps a real column (the last) and stores nothing; it
  // still reaches every barrier
  const int64_t jc = j < m ? j : m - 1;
  C* col = tile + lane;
  load_rows<S, C, TILE>(col, static_cast<const S*>(a.rhs) + rs * m + jc, s,
                        e, m);

  // entry carries: (f_{rs-1}, f_{rs-2}) forward, (y_re, y_re+1) backward
  C fin[ORDER], yin[ORDER];
  const C* carries = static_cast<const C*>(a.carries);
#pragma unroll
  for (int r = 0; r < ORDER; ++r) {
    fin[r] = carries != nullptr ? carries[((b * 2) * ORDER + r) * m + jc]
                                : C(0);
    yin[r] = carries != nullptr ? carries[((b * 2 + 1) * ORDER + r) * m + jc]
                                : C(0);
  }

  // forward from zero carries in place; beside it the forward response to
  // a unit carry at lag 1 (even lanes) or 2 (odd lanes, order 2)
  const int which = ORDER == 2 ? (lane & 1) : 0;
  C h1 = C(0), h2 = C(0);
  C v1 = which == 0 ? C(1) : C(0), v2 = which == 1 ? C(1) : C(0);
  C* rf_mine = resp + which * rows;
  for (int g = 0; g < GROUPS; ++g) {
    const int lo = group_begin(g, s, e), hi = group_begin(g + 1, s, e);
    if (lo == hi) continue;
    wait_rows<S, C>(hi - 1, s, e);
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      const Row<C> kf = load_row(fw, rs + i);
      const C x = apply(fw, kf, col[i * TILE], h1, h2);
      const C r = apply(fw, kf, C(0), v1, v2);
      col[i * TILE] = x;
      if (lane < ORDER) rf_mine[i] = r;
      h2 = h1;
      h1 = x;
      v2 = v1;
      v1 = r;
    }
  }
  __syncthreads();

  // the forward carries into this chunk, chained over the chunk ends from
  // the block's entry carries
  C G[ORDER], Gin[ORDER];
#pragma unroll
  for (int r = 0; r < ORDER; ++r) {
    G[r] = fin[r];
    Gin[r] = C(0);
  }
  for (int q = 0; q < p; ++q) {
    if (q == k) {
#pragma unroll
      for (int r = 0; r < ORDER; ++r) Gin[r] = G[r];
    }
    const int first = part_begin(q, rows, p);
    const int last = part_begin(q + 1, rows, p) - 1;
    C nG[ORDER];
#pragma unroll
    for (int r = 0; r < ORDER; ++r) {
      if (last - r >= first) {
        C v = col[(last - r) * TILE];
#pragma unroll
        for (int l = 0; l < ORDER; ++l) {
          v = v + resp[l * rows + last - r] * G[l];
        }
        nG[r] = v;
      } else {
        nG[r] = G[0];   // a one-row chunk passes its lag-1 carry on
      }
    }
#pragma unroll
    for (int r = 0; r < ORDER; ++r) G[r] = nG[r];
  }
  __syncthreads();   // every chunk end read before the backward overwrites

  // backward from zero carries on the fixed-up forward values, in place;
  // beside it the backward response to a unit carry at lag 1 or 2; UNROLL
  // rows at a time, every load of a batch ahead of its stores
  C* rb_mine = resp + (ORDER + which) * rows;
  const C* rf0 = resp;
  const C* rf1 = resp + rows;
  C y1 = C(0), y2 = C(0);
  C w1 = which == 0 ? C(1) : C(0), w2 = which == 1 ? C(1) : C(0);
  int i = e - 1;
  for (; i - (UNROLL - 1) >= s; i -= UNROLL) {
    C d[UNROLL], r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      C v = col[(i - u) * TILE] + rf0[i - u] * Gin[0];
      if (ORDER == 2) v = v + rf1[i - u] * Gin[ORDER - 1];
      d[u] = v;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const Row<C> kb = load_row(bw, rs + i - u);
      const C y = apply(bw, kb, d[u], y1, y2);
      const C wv = apply(bw, kb, C(0), w1, w2);
      y2 = y1;
      y1 = y;
      w2 = w1;
      w1 = wv;
      d[u] = y;
      r[u] = wv;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      col[(i - u) * TILE] = d[u];
      if (lane < ORDER) rb_mine[i - u] = r[u];
    }
  }
  for (; i >= s; --i) {
    C v = col[i * TILE] + rf0[i] * Gin[0];
    if (ORDER == 2) v = v + rf1[i] * Gin[ORDER - 1];
    const Row<C> kb = load_row(bw, rs + i);
    const C y = apply(bw, kb, v, y1, y2);
    const C wv = apply(bw, kb, C(0), w1, w2);
    y2 = y1;
    y1 = y;
    w2 = w1;
    w1 = wv;
    col[i * TILE] = y;
    if (lane < ORDER) rb_mine[i] = wv;
  }
  __syncthreads();

  // the backward carries into this chunk, chained down over the chunk
  // starts from the block's entry carries
  const C* rb = resp + ORDER * rows;
  C Y[ORDER], Yin[ORDER];
#pragma unroll
  for (int r = 0; r < ORDER; ++r) {
    Y[r] = yin[r];
    Yin[r] = C(0);
  }
  for (int q = p - 1; q >= 0; --q) {
    if (q == k) {
#pragma unroll
      for (int r = 0; r < ORDER; ++r) Yin[r] = Y[r];
    }
    const int first = part_begin(q, rows, p);
    const int end = part_begin(q + 1, rows, p);
    C nY[ORDER];
#pragma unroll
    for (int r = 0; r < ORDER; ++r) {
      if (first + r < end) {
        C v = col[(first + r) * TILE];
#pragma unroll
        for (int l = 0; l < ORDER; ++l) {
          v = v + rb[l * rows + first + r] * Y[l];
        }
        nY[r] = v;
      } else {
        nY[r] = Y[0];   // a one-row chunk passes its lag-1 carry on
      }
    }
#pragma unroll
    for (int r = 0; r < ORDER; ++r) Y[r] = nY[r];
  }
  // x = y + the chunk's backward responses times its entry carries,
  // written to device memory once
  if (j >= m) return;
  C* xj = static_cast<C*>(a.out) + rs * m + j;
  const C* rb1 = rb + rows;
#pragma unroll 4
  for (int i2 = s; i2 < e; ++i2) {
    C v = col[i2 * TILE] + rb[i2] * Yin[0];
    if (ORDER == 2) v = v + rb1[i2] * Yin[ORDER - 1];
    xj[(int64_t)i2 * m] = v;
  }
}

// K2: one thread a column walks the row blocks up (forward carries), then
// down (backward carries), from K1's summaries and the blocks' coefficients.
template <typename C, int ORDER>
__global__ void shared_chain_kernel(const C* __restrict__ summ,
                                    C* __restrict__ carries,
                                    const C* __restrict__ coefs, int blocks,
                                    int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  C fend[ORDER], ystart[ORDER];
  chain_column<C, ORDER>(summ, carries, coefs, blocks, m, j, fend, ystart);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// shared memory of a tile kernel over `rows` rows: the tile and the
// 2 * order response rows
template <typename C>
size_t tile_smem(int order, int rows, int tile) {
  return (size_t)rows * (tile + 2 * order) * sizeof(C);
}

template <typename S, typename C, int ORDER, bool SCALE_FWD>
const void* tile_fn(int tile) {
  return tile == 16
             ? (const void*)shared_tile_kernel<S, C, ORDER, 16, SCALE_FWD>
             : (const void*)shared_tile_kernel<S, C, ORDER, 32, SCALE_FWD>;
}

// the tile kernel of (order, tile, which pass is scaled)
template <typename S, typename C>
const void* pick_tile_fn(int order, int tile, bool scale_fwd) {
  if (order == 1) {
    return scale_fwd ? tile_fn<S, C, 1, true>(tile)
                     : tile_fn<S, C, 1, false>(tile);
  }
  return scale_fwd ? tile_fn<S, C, 2, true>(tile)
                   : tile_fn<S, C, 2, false>(tile);
}

template <typename S, typename C>
int launch_tile(const TileArgs& a, int order, int chunks, int tile,
                cudaStream_t stream) {
  const int cap = (a.n + a.blocks - 1) / a.blocks;
  const dim3 grid((unsigned)((a.m + tile - 1) / tile), (unsigned)a.blocks);
  return (int)launch_fn(pick_tile_fn<S, C>(order, tile, a.desc.fwd.scale >= 0),
                        grid,
                        dim3(chunks * tile), tile_smem<C>(order, cap, tile),
                        a, stream);
}

template <typename S, typename C>
int launch_summary(const TileArgs& a, int order, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.m + SERIAL_THREADS - 1) / SERIAL_THREADS),
                  (unsigned)a.blocks);
  const S* rhs = static_cast<const S*>(a.rhs);
  const C* w = static_cast<const C*>(a.weights);
  C* summ = static_cast<C*>(a.summ);
  if (order == 1) {
    shared_summary_kernel<S, C, 1><<<grid, SERIAL_THREADS, 0, stream>>>(
        rhs, w, summ, a.n, a.m, a.blocks);
  } else {
    shared_summary_kernel<S, C, 2><<<grid, SERIAL_THREADS, 0, stream>>>(
        rhs, w, summ, a.n, a.m, a.blocks);
  }
  return (int)cudaGetLastError();
}

template <typename S, typename C>
int launch_serial(const TileArgs& a, int order, cudaStream_t stream) {
  const int stage_rows = a.lhs_rows + (a.eps != nullptr ? 1 : 0);
  const size_t smem = (size_t)stage_rows * SERIAL_CHUNK_N * sizeof(C);
  const dim3 grid((unsigned)((a.m + SERIAL_THREADS - 1) / SERIAL_THREADS));
  const S* l = static_cast<const S*>(a.lhs);
  const S* r = static_cast<const S*>(a.rhs);
  const S* e = static_cast<const S*>(a.eps);
  C* o = static_cast<C*>(a.out);
  if (order == 1) {
    shared_serial_kernel<S, C, 1><<<grid, SERIAL_THREADS, smem, stream>>>(
        l, a.lhs_rows, r, o, e, a.n, a.m, a.desc);
  } else {
    shared_serial_kernel<S, C, 2><<<grid, SERIAL_THREADS, smem, stream>>>(
        l, a.lhs_rows, r, o, e, a.n, a.m, a.desc);
  }
  return (int)cudaGetLastError();
}

template <typename C>
int launch_chain(const TileArgs& a, int order, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.m + SERIAL_THREADS - 1) / SERIAL_THREADS));
  const C* summ = static_cast<const C*>(a.summ);
  C* carries = static_cast<C*>(const_cast<void*>(a.carries));
  const C* coefs = static_cast<const C*>(a.coefs);
  if (order == 1) {
    shared_chain_kernel<C, 1><<<grid, SERIAL_THREADS, 0, stream>>>(
        summ, carries, coefs, a.blocks, a.m);
  } else {
    shared_chain_kernel<C, 2><<<grid, SERIAL_THREADS, 0, stream>>>(
        summ, carries, coefs, a.blocks, a.m);
  }
  return (int)cudaGetLastError();
}

enum Route { SERIAL = 0, ONCHIP = 1, PARTITION = 2 };

// A tile launch takes (blocks, chunks, tile) when every chunk of every row
// block has a row and the tile fits.
template <typename C>
bool tiles_fit(int order, int64_t n, int blocks, int chunks, int tile) {
  if (blocks < 1 || chunks < 1 || chunks > MAX_CHUNKS ||
      (tile != 16 && tile != 32)) {
    return false;
  }
  const int cap = (int)((n + blocks - 1) / blocks);
  return n / blocks >= chunks && tile_smem<C>(order, cap, tile) <= SMEM_MAX;
}

template <typename S, typename C>
int launch(int route, int blocks, int chunks, int tile, int stage,
           TileArgs a, int order, void* work, cudaStream_t stream) {
  if (order != 1 && order != 2) return (int)cudaErrorInvalidValue;
  if (route == SERIAL) {
    return stage == 0 ? launch_serial<S, C>(a, order, stream)
                      : (int)cudaErrorInvalidValue;
  }
  if (!tiles_fit<C>(order, a.n, blocks, chunks, tile) ||
      !desc_fits(a.desc, order, a.lhs_rows, a.eps != nullptr) ||
      (route == ONCHIP && (blocks != 1 || stage != 0)) ||
      (route == PARTITION && work == nullptr) || stage < 0 || stage > 4) {
    return (int)cudaErrorInvalidValue;
  }
  a.blocks = blocks;
  if (route == ONCHIP) return launch_tile<S, C>(a, order, chunks, tile, stream);
  // work: summaries (B, 2, order, m), carries (the same), coefficients
  // (B, 3, order, order), summary weights (2, order, n)
  C* summ = static_cast<C*>(work);
  C* carries = summ + (int64_t)2 * blocks * order * a.m;
  C* coefs = carries + (int64_t)2 * blocks * order * a.m;
  a.summ = summ;
  a.carries = carries;
  a.coefs = coefs;
  a.weights = coefs + 3 * blocks * order * order;
  int rc = 0;
  if (stage == 0 || stage == 1) rc = launch_coefs<S, C>(a, order, stream);
  if (rc == 0 && (stage == 0 || stage == 2)) {
    rc = launch_summary<S, C>(a, order, stream);
  }
  if (rc == 0 && (stage == 0 || stage == 3)) {
    rc = launch_chain<C>(a, order, stream);
  }
  if (rc == 0 && (stage == 0 || stage == 4)) {
    rc = launch_tile<S, C>(a, order, chunks, tile, stream);
  }
  return rc;
}

template <typename S, typename C>
int blocks_per_sm(int order, int64_t rows, int chunks, int tile, int* out) {
  if ((order != 1 && order != 2) ||
      !tiles_fit<C>(order, rows, 1, chunks, tile)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = tile_smem<C>(order, (int)rows, tile);
  const void* fn = pick_tile_fn<S, C>(order, tile, true);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, chunks * tile, smem);
}

}  // namespace

// Plain C entry points for ctypes.
//
// shared_sweep: one solve.
//   dtype:  0 float, 1 double, 2 bf16 storage with float compute and output
//   route:  0 serial (blocks, chunks, tile, work unused), 1 on chip
//           (blocks = 1), 2 partitioned (work: 4 * blocks * order * m +
//           3 * blocks * order^2 + 2 * order * n elements of the compute
//           type)
//   blocks, chunks, tile: row blocks, row chunks a block (1..16) and columns
//           a tile (16 or 32); every chunk needs a row and a block's tile
//           must fit 232,448 bytes
//   stage:  0 the whole solve; on the partitioned route 1, 2, 3 or 4
//           launches K0, K1, K2 or K3 alone (to time them)
//   desc:   11 ints, [order, fwd src0 lag0 src1 lag1 scale, bwd ...]; a
//           coefficient row equal to `rows` is the eps operand
// Returns the first launch error (0 on success), or the error that
// refused the arguments.
extern "C" int shared_sweep(int dtype, int route, int blocks, int chunks,
                            int tile, int stage, const void* lhs, int rows,
                            const void* rhs, void* out, const void* eps,
                            void* work, long long n, long long m,
                            const int* desc, void* stream) {
  if (n <= 0 || n > INT32_MAX || m <= 0 || route < SERIAL ||
      route > PARTITION) {
    return (int)cudaErrorInvalidValue;
  }
  TileArgs a;
  a.lhs = lhs;
  a.lhs_rows = rows;
  a.rhs = rhs;
  a.out = out;
  a.eps = eps;
  a.desc.fwd = read_pass(desc + 1);
  a.desc.bwd = read_pass(desc + 6);
  a.n = (int)n;
  a.m = m;
  a.blocks = 1;
  a.summ = nullptr;
  a.carries = nullptr;
  a.coefs = nullptr;
  a.weights = nullptr;
  const int order = desc[0];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(route, blocks, chunks, tile, stage, a, order,
                                  work, s);
    case 1:
      return launch<double, double>(route, blocks, chunks, tile, stage, a,
                                    order, work, s);
    case 2:
      return launch<__nv_bfloat16, float>(route, blocks, chunks, tile, stage,
                                          a, order, work, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// shared_sweep_spans: the row spans [s, e) the route sweeps at (n, blocks,
// chunks), by part_begin as the kernels cut them: route 0 serial (one span
// over n), 1 on chip and 2 partitioned (every chunk of every row block, in
// row order; chunks = 1 gives K0-K2's row blocks), 2 ints a span into out
// (room for `cap` spans).  Returns the spans written, or -1 where a launch
// at (dtype, order) with `tile` columns a tile would refuse the geometry
// (tiles_fit).
extern "C" int shared_sweep_spans(int dtype, int order, int route,
                                  long long n, int blocks, int chunks,
                                  int tile, int* out, int cap) {
  if (n <= 0 || n > INT32_MAX || (order != 1 && order != 2) || cap < 1) {
    return -1;
  }
  if (route == SERIAL) {
    out[0] = 0;
    out[1] = (int)n;
    return 1;
  }
  bool fits;
  switch (dtype) {
    case 0:
    case 2:
      fits = tiles_fit<float>(order, n, blocks, chunks, tile);
      break;
    case 1:
      fits = tiles_fit<double>(order, n, blocks, chunks, tile);
      break;
    default:
      return -1;
  }
  if (!fits || (route == ONCHIP && blocks != 1) || route < SERIAL ||
      route > PARTITION) {
    return -1;
  }
  return write_spans((int)n, blocks, chunks, out, cap);
}

// shared_sweep_tile_blocks: blocks of the tile kernel over `rows` rows,
// `chunks` chunks and `tile` columns that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int shared_sweep_tile_blocks(int dtype, int order, long long rows,
                                        int chunks, int tile, int* blocks) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return blocks_per_sm<float, float>(order, rows, chunks, tile, blocks);
    case 1:
      return blocks_per_sm<double, double>(order, rows, chunks, tile, blocks);
    case 2:
      return blocks_per_sm<__nv_bfloat16, float>(order, rows, chunks, tile,
                                                 blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
