// partition.cuh — what the tile and row-partitioned routes of
// shared_sweep.cu and fused_cn.cu share, for Hopper (sm_90a): the pass
// descriptor of a shared-factor sweep (repro_torch/kernels/engine.py::
// _PASS_TABLE), the tile helpers (row parts, cp.async commit groups), and
// the partitioned route's factor-only and chain steps:
//
//   K0 shared_coef_kernel  each row block's unit-carry responses and the
//                          summary weights, from the factor alone;
//   K2 chain_column        one column's walk over the row blocks, which
//                          chains the blocks' entry carries from K1's
//                          summaries and leaves the chain's ends.
//
// Each source builds it into its own library (an anonymous namespace), so
// shared_sweep.cu's arithmetic is the same as before it was shared, and a
// change here rebuilds both (repro_torch/kernels/build.py hashes every
// header a source includes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_CHUNKS = 16;       // row chunks (thread groups) a block
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may opt in to
constexpr int GROUPS = 4;            // cp.async commit groups per chunk
constexpr int UNROLL = 4;            // rows a backward step loads at once

struct PassDesc {
  int src[2];  // factor row of each term's coefficient (-1: none; the
               // number of factor rows: the eps operand)
  int lag[2];  // carry lag of each term (1 or 2)
  int scale;   // factor row of the scale (-1: unscaled pass)
};

struct SweepDesc {
  PassDesc fwd, bwd;
};

template <typename C, typename S>
__device__ __forceinline__ C to_compute(S v) {
  return static_cast<C>(v);
}

template <>
__device__ __forceinline__ float to_compute<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}


// One pass with its coefficient rows resolved to pointers, each with a row
// stride (0 for the eps operand: one value).  The pass table fixes the rest
// (checked on the host by desc_fits): a forward pass subtracts its carry at
// lag `order` first, then lag 1; a backward pass lag 1, then lag 2; exactly
// one of the two passes is scaled.  So lags and scale are compile-time.
template <typename S_, typename C_, int ORDER_, bool FWD, bool SCALED_>
struct Pass {
  using S = S_;
  using C = C_;
  static constexpr int ORDER = ORDER_;
  static constexpr bool LAG2_FIRST = FWD && ORDER_ == 2;  // term 0 at lag 2
  static constexpr bool SCALED = SCALED_;
  const S* row[2];
  int stride[2];
  const S* scale;

  __device__ Pass(const PassDesc& d, const S* lhs, const S* eps, int lhs_rows,
                  int64_t n)
      : scale(SCALED_ ? lhs + (int64_t)d.scale * n : nullptr) {
    for (int t = 0; t < 2; ++t) {
      const bool is_eps = d.src[t] == lhs_rows;
      row[t] = is_eps ? eps : lhs + (int64_t)(d.src[t] < 0 ? 0 : d.src[t]) * n;
      stride[t] = is_eps ? 0 : 1;
    }
  }
};

// The coefficients of one row of a pass, at the compute type.
template <typename C>
struct Row {
  C c0, c1, s;
};

template <typename P>
__device__ __forceinline__ Row<typename P::C> load_row(const P& p, int64_t i) {
  using C = typename P::C;
  using S = typename P::S;
  Row<C> k;
  k.c0 = to_compute<C, S>(__ldg(p.row[0] + i * p.stride[0]));
  k.c1 = P::ORDER == 1 ? C(0)
                       : to_compute<C, S>(__ldg(p.row[1] + i * p.stride[1]));
  k.s = P::SCALED ? to_compute<C, S>(__ldg(p.scale + i)) : C(1);
  return k;
}

// (acc - c0 carry_{lag0} - c1 carry_{lag1}) * scale, carries (h1, h2)
template <typename P, typename C = typename P::C>
__device__ __forceinline__ C apply(const P&, const Row<C>& k, C acc, C h1,
                                   C h2) {
  acc = acc - k.c0 * (P::LAG2_FIRST ? h2 : h1);
  if (P::ORDER == 2) acc = acc - k.c1 * (P::LAG2_FIRST ? h1 : h2);
  if (P::SCALED) acc = acc * k.s;
  return acc;
}

// first row of part k of p parts over n rows (ops.chunk_bounds)
__device__ __forceinline__ int part_begin(int k, int n, int p) {
  return (int)(((int64_t)k * n) / p);
}

// first row of commit group g of the chunk [s, e)
__device__ __forceinline__ int group_begin(int g, int s, int e) {
  return s + (e - s) * g / GROUPS;
}

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

// Load this thread's rows [s, e) of its column (src[i * m]) into its column
// of the tile (col[i * TILE]): cp.async in GROUPS commit groups when the
// storage is the compute type, else plain loads converted as stored.
template <typename S, typename C, int TILE>
__device__ __forceinline__ void load_rows(C* col, const S* src, int s, int e,
                                          int64_t m) {
  if constexpr (std::is_same<S, C>::value) {
    for (int g = 0; g < GROUPS; ++g) {
      for (int i = group_begin(g, s, e); i < group_begin(g + 1, s, e); ++i) {
        cp_async(col + i * TILE, src + (int64_t)i * m);
      }
      cp_async_commit();
    }
  } else {
#pragma unroll 8
    for (int i = s; i < e; ++i) {
      col[i * TILE] = to_compute<C, S>(src[(int64_t)i * m]);
    }
  }
}

// Wait until every row of [s, last] has landed in this thread's column.
template <typename S, typename C>
__device__ __forceinline__ void wait_rows(int last, int s, int e) {
  if constexpr (std::is_same<S, C>::value) {
    int g = 0;
    while (g < GROUPS - 1 && group_begin(g + 1, s, e) <= last) ++g;
    cp_async_wait(GROUPS - 1 - g);
  }
}

// Everything a tile launch reads, typed inside the kernel.
struct TileArgs {
  const void* lhs;      // (lhs_rows, n) factor rows, storage type
  int lhs_rows;
  const void* rhs;      // (n, m), storage type
  void* out;            // (n, m) x, compute type (unused by K1)
  const void* eps;      // 1 element or nullptr
  SweepDesc desc;
  int n;
  int64_t m;
  int blocks;           // row blocks B (1 on the on-chip route)
  void* summ;           // K1's output: (B, 2, order, m)
  const void* carries;  // K3's entry carries (B, 2, order, m), or nullptr
  void* coefs;          // (B, 3, order, order): phi, w, psi
  void* weights;        // (2, order, n): K1's summary weights
};

// Row block q's coefficients, by threads 0 .. 2 * order - 1 of one block;
// thread l < order keeps its forward response in scratch[rows of q].
template <typename FW, typename BW, typename C = typename FW::C>
__device__ void block_coefs(const FW& fw, const BW& bw, int q, int n,
                            int blocks, C* scratch, C* coefs) {
  constexpr int ORDER = FW::ORDER;
  const int s = part_begin(q, n, blocks), e = part_begin(q + 1, n, blocks);
  C* phi = coefs + q * 3 * ORDER * ORDER;
  C* w = phi + ORDER * ORDER;
  C* psi = w + ORDER * ORDER;
  const int t = threadIdx.x;
  if (t < ORDER) {
    // the forward response to a unit carry at lag t + 1, at rows e-1, e-2
    C v1 = t == 0 ? C(1) : C(0), v2 = t == 1 ? C(1) : C(0);
    for (int i = s; i < e; ++i) {
      const C r = apply(fw, load_row(fw, i), C(0), v1, v2);
      scratch[i - s] = r;
      v2 = v1;
      v1 = r;
    }
    phi[t] = v1;
    if (ORDER == 2) phi[ORDER + t] = v2;
    // the backward sweep of it from zero carries, at rows s, s+1
    C y1 = C(0), y2 = C(0);
    for (int i = e - 1; i >= s; --i) {
      const C y = apply(bw, load_row(bw, i), scratch[i - s], y1, y2);
      y2 = y1;
      y1 = y;
    }
    w[t] = y1;
    if (ORDER == 2) w[ORDER + t] = y2;
  } else if (t < 2 * ORDER) {
    // the backward response to a unit carry at lag l + 1, at rows s, s+1
    const int l = t - ORDER;
    C v1 = l == 0 ? C(1) : C(0), v2 = l == 1 ? C(1) : C(0);
    for (int i = e - 1; i >= s; --i) {
      const C r = apply(bw, load_row(bw, i), C(0), v1, v2);
      v2 = v1;
      v1 = r;
    }
    psi[l] = v1;
    if (ORDER == 2) psi[ORDER + l] = v2;
  }
}

// The adjoint of pass p over rows [s, e), from zero carries outside them:
// out(i, d/d in_i of sum_k seed(k) out_k), walked against the pass
// (descending for a forward pass, ascending for a backward one).  With
// u_i = (seed_i + pending_i) * scale(i), each term hands -coef_t(i) * u_i
// on to the row lag_t back along the walk; pending contributions are summed
// in term order (ops._adjoint repeats it).
template <typename P, typename Seed, typename Out>
__device__ void adjoint(const P& p, int s, int e, bool descending, Seed seed,
                        Out out) {
  using C = typename P::C;
  C p1 = C(0), p2 = C(0);
  for (int k = 0; k < e - s; ++k) {
    const int i = descending ? e - 1 - k : s + k;
    const Row<C> kr = load_row(p, i);
    C u = seed(i) + p1;
    if (P::SCALED) u = u * kr.s;
    out(i, u);
    C n1 = p2, n2 = C(0);
    if (P::LAG2_FIRST) {
      n2 = n2 - kr.c0 * u;
      n1 = n1 - kr.c1 * u;
    } else {
      n1 = n1 - kr.c0 * u;
      if (P::ORDER == 2) n2 = n2 - kr.c1 * u;
    }
    p1 = n1;
    p2 = n2;
  }
}

// K0: row block blockIdx.x's coefficients (threads 0 .. 2 order - 1) and its
// rows of the summary weights (threads 2 order .. 4 order - 1): weights[r]
// gives its forward end value f_{e-1-r}, weights[order + r] its backward
// start value y_{s+r}, both from zero carries.  Dynamic shared memory:
// 4 * order scratch rows of ceil(N / B).
template <typename S, typename C, int ORDER, bool SCALE_FWD>
__global__ void shared_coef_kernel(const TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const S* lhs = static_cast<const S*>(a.lhs);
  const S* eps = static_cast<const S*>(a.eps);
  const int n = a.n, nb = a.blocks, q = blockIdx.x;
  const Pass<S, C, ORDER, true, SCALE_FWD> fw(a.desc.fwd, lhs, eps,
                                              a.lhs_rows, n);
  const Pass<S, C, ORDER, false, !SCALE_FWD> bw(a.desc.bwd, lhs, eps,
                                                a.lhs_rows, n);
  const int cap = (n + nb - 1) / nb;
  const int t = threadIdx.x;
  const int s = part_begin(q, n, nb), e = part_begin(q + 1, n, nb);
  C* scratch = reinterpret_cast<C*>(smem_raw) + t * cap;   // row i at i - s
  C* w = static_cast<C*>(a.weights);
  if (t < 2 * ORDER) {
    block_coefs(fw, bw, q, n, nb, scratch, static_cast<C*>(a.coefs));
  } else if (t < 3 * ORDER) {
    const int r = t - 2 * ORDER, row = e - 1 - r;
    adjoint(fw, s, e, true, [&](int i) { return C(i == row); },
            [&](int i, C u) { w[(int64_t)r * n + i] = u; });
  } else if (t < 4 * ORDER) {
    const int r = t - 3 * ORDER, row = s + r;
    adjoint(bw, s, e, false, [&](int i) { return C(i == row); },
            [&](int i, C u) { scratch[i - s] = u; });
    adjoint(fw, s, e, true, [&](int i) { return scratch[i - s]; },
            [&](int i, C u) { w[(int64_t)(ORDER + r) * n + i] = u; });
  }
}

// K2's walk for column j: up the row blocks to chain the forward carries,
// then down to chain the backward ones, from K1's summaries and the
// blocks' coefficients, writing each block's entry carries to `carries`
// ((B, 2, order, m)).  Leaves the chain's ends in fend (f_{N-1}, f_{N-2}:
// the forward values of the last rows) and ystart (y_0, y_1).
template <typename C, int ORDER>
__device__ __forceinline__ void chain_column(const C* __restrict__ summ,
                                             C* __restrict__ carries,
                                             const C* __restrict__ coefs,
                                             int blocks, int64_t m, int64_t j,
                                             C (&fend)[ORDER],
                                             C (&ystart)[ORDER]) {
  C F[ORDER], Y[ORDER], nv[ORDER];
#pragma unroll
  for (int r = 0; r < ORDER; ++r) F[r] = Y[r] = C(0);
  for (int b = 0; b < blocks; ++b) {
    const C* phi = coefs + b * 3 * ORDER * ORDER;
#pragma unroll
    for (int r = 0; r < ORDER; ++r) {
      const int64_t at = ((int64_t)(b * 2) * ORDER + r) * m + j;
      carries[at] = F[r];
      C v = summ[at];
#pragma unroll
      for (int l = 0; l < ORDER; ++l) v = v + __ldg(phi + r * ORDER + l) * F[l];
      nv[r] = v;
    }
#pragma unroll
    for (int r = 0; r < ORDER; ++r) F[r] = nv[r];
  }
#pragma unroll
  for (int r = 0; r < ORDER; ++r) fend[r] = F[r];
  for (int b = blocks - 1; b >= 0; --b) {
    const C* w = coefs + b * 3 * ORDER * ORDER + ORDER * ORDER;
    const C* psi = w + ORDER * ORDER;
#pragma unroll
    for (int r = 0; r < ORDER; ++r) {
      F[r] = carries[((int64_t)(b * 2) * ORDER + r) * m + j];
    }
#pragma unroll
    for (int r = 0; r < ORDER; ++r) {
      const int64_t at = ((int64_t)(b * 2 + 1) * ORDER + r) * m + j;
      carries[at] = Y[r];
      C v = summ[at];
#pragma unroll
      for (int l = 0; l < ORDER; ++l) v = v + __ldg(w + r * ORDER + l) * F[l];
#pragma unroll
      for (int l = 0; l < ORDER; ++l) v = v + __ldg(psi + r * ORDER + l) * Y[l];
      nv[r] = v;
    }
#pragma unroll
    for (int r = 0; r < ORDER; ++r) Y[r] = nv[r];
  }
#pragma unroll
  for (int r = 0; r < ORDER; ++r) ystart[r] = Y[r];
}

// The pass table's shape, which the tile routes compile in: forward lags
// (order, 1), backward lags (1, 2), exactly one scaled pass, every
// coefficient a factor row or (index `rows`) the eps operand.
bool desc_fits(const SweepDesc& d, int order, int rows, bool has_eps) {
  const PassDesc* passes[2] = {&d.fwd, &d.bwd};
  for (int k = 0; k < 2; ++k) {
    const PassDesc& p = *passes[k];
    if (p.lag[0] != (k == 0 ? order : 1) ||
        (order == 2 && p.lag[1] != (k == 0 ? 1 : 2)) || p.scale >= rows) {
      return false;
    }
    for (int t = 0; t < order; ++t) {
      if (p.src[t] < 0 || p.src[t] > rows || (p.src[t] == rows && !has_eps)) {
        return false;
      }
    }
  }
  return (d.fwd.scale >= 0) != (d.bwd.scale >= 0);
}

// Opt a kernel in to `smem` bytes of dynamic shared memory, with the SM's
// unified memory carved out for shared memory first.
cudaError_t prepare(const void* fn, size_t smem) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch_fn(const void* fn, dim3 grid, dim3 block, size_t smem,
                      const TileArgs& a, cudaStream_t stream) {
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<TileArgs*>(&a)};
  e = cudaLaunchKernel(fn, grid, block, args, smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename S, typename C>
int launch_coefs(const TileArgs& a, int order, cudaStream_t stream) {
  const int cap = (a.n + a.blocks - 1) / a.blocks;
  const bool fwd = a.desc.fwd.scale >= 0;
  const void* fn =
      order == 1 ? (fwd ? (const void*)shared_coef_kernel<S, C, 1, true>
                        : (const void*)shared_coef_kernel<S, C, 1, false>)
                 : (fwd ? (const void*)shared_coef_kernel<S, C, 2, true>
                        : (const void*)shared_coef_kernel<S, C, 2, false>);
  return (int)launch_fn(fn, dim3((unsigned)a.blocks), dim3(32),
                        (size_t)4 * order * cap * sizeof(C), a, stream);
}

PassDesc read_pass(const int* d) {
  PassDesc p;
  p.src[0] = d[0];
  p.lag[0] = d[1];
  p.src[1] = d[2];
  p.lag[1] = d[3];
  p.scale = d[4];
  return p;
}

}  // namespace
