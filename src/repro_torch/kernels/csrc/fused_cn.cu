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
// Design:
//   * one thread per field m; a warp reads 32 consecutive m of row i, so
//     every access to c and x is coalesced; the ragged edge of M is
//     masked; 64-bit offsets;
//   * the forward pass builds the stencil on the fly from a sliding
//     register window of c (3 or 5 rows), wrapping at rows 0 and N-1, and
//     writes d^ (or g) into x; the backward pass turns x into y in place;
//     a third pass applies the correction in place.  Carries stay in
//     registers, at the storage type (float or double);
//   * the factor rows, z / Z, Minv and the scalar parameters are shared by
//     every thread: read with broadcast loads through the read-only cache.
//
// Bound: device-memory bytes.  The function needs (2NM + 4N + 8) words
// (tridiag) or (2NM + 9N + 32) words (penta): the field read once, the
// next field written once (the TPU kernel reaches that because VMEM holds
// the whole column).  This simple design moves about 6NM words: c read,
// the intermediate written, read and written again by the backward pass,
// and read and written once more by the correction.  The operations per
// element (about 12 tridiag, 26 penta) are far below the byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t wrap(int64_t k, int64_t n) {
  return k < 0 ? k + n : (k >= n ? k - n : k);
}

// lhs (3, N) [a, inv_denom, c_hat] of A'; z (N,); params [sl, sc, sr,
// v_last, inv_sm, ...].
template <typename T>
__global__ void fused_cn_tridiag_kernel(const T* __restrict__ lhs,
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
__global__ void fused_cn_penta_kernel(const T* __restrict__ lhs,
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

template <typename T>
int launch(int bandwidth, const void* lhs, const void* z, const void* minv,
           const void* params, const void* c, void* x, int64_t n, int64_t m,
           int threads, cudaStream_t stream) {
  const dim3 grid((unsigned)((m + threads - 1) / threads));
  const dim3 block(threads);
  const T* l = static_cast<const T*>(lhs);
  const T* zz = static_cast<const T*>(z);
  const T* p = static_cast<const T*>(params);
  const T* cc = static_cast<const T*>(c);
  T* xx = static_cast<T*>(x);
  if (bandwidth == 3) {
    fused_cn_tridiag_kernel<T><<<grid, block, 0, stream>>>(l, zz, p, cc, xx,
                                                           n, m);
  } else if (bandwidth == 5 && n >= 2) {
    fused_cn_penta_kernel<T><<<grid, block, 0, stream>>>(
        l, zz, static_cast<const T*>(minv), p, cc, xx, n, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.
//   dtype:     0 float, 1 double; every operand is contiguous, of that type
//   bandwidth: 3 fused_cn_tridiag (lhs (3, N), z (N,), params (8,); minv
//              is unused), 5 fused_cn_penta (lhs (5, N), z the (N, 4) Z,
//              minv (4, 4), params (16,); N >= 2)
// c and x are (N, M).  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fused_cn(int dtype, int bandwidth, const void* lhs,
                        const void* z, const void* minv, const void* params,
                        const void* c, void* x, long long n, long long m,
                        int threads, void* stream) {
  if (n <= 0 || m <= 0 || threads <= 0 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(bandwidth, lhs, z, minv, params, c, x, n, m,
                           threads, s);
    case 1:
      return launch<double>(bandwidth, lhs, z, minv, params, c, x, n, m,
                            threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
