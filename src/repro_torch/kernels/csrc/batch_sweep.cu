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
// They tile N only because a TPU core has 12 MiB of VMEM; a Hopper thread
// walks all N rows of its system out of device memory, so one kernel
// serves all three.
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
// x_i = g_i - gamma_i x_{i+1} - delta_i x_{i+2}.
//
// Design (the paper's CUDA mapping):
//   * one thread per system m; a warp reads 32 consecutive m of row i of
//     each operand, so every access is coalesced; the ragged edge of M is
//     masked;
//   * the forward pass ascends, writes c^ (or gamma, delta) into a
//     workspace of shape (order, N, M) at the compute type, which the
//     wrapper allocates, and writes d^ (or g) into the output; the
//     backward pass descends and overwrites the output with x;
//   * carries stay in registers and start at zero at both ends.  No row
//     -1 or N is ever read: a_0, b_0 (penta) and the entries that
//     torch.roll wraps across the Dirichlet boundary for the adjoint only
//     ever multiply a zero carry;
//   * storage float, double or bf16 (bf16 computes in float; the output
//     and the workspace are float); offsets are 64-bit (N*M overflows
//     int32).
//
// Bound: device-memory bytes.  The function needs (bw + 2)·N·M words:
// bw diagonals and the RHS read once, x written once, i.e.
// (bw + 1)·N·M·storage_itemsize + N·M·compute_itemsize bytes over
// 3.35 TB/s.  This simple design moves about 9·N·M words (tridiag) and
// 13·N·M (penta): the coefficients and the intermediate round-trip
// through device memory between the two passes.  The operations per row
// and system, a division counted as one, are 9 (tridiag: 7 forward,
// 2 backward) and 20 (penta: 16 forward, 4 backward), far below the byte
// bound at the card's fp32 and fp64 rates.

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

template <typename S, typename C>
int launch(int bandwidth, const void* const* diags, const void* rhs,
           void* out, void* work, int64_t n, int64_t m, int threads,
           cudaStream_t stream) {
  Diags<S> dg;
  for (int r = 0; r < 5; ++r) {
    dg.p[r] = r < bandwidth ? static_cast<const S*>(diags[r]) : nullptr;
  }
  const dim3 grid((unsigned)((m + threads - 1) / threads));
  const dim3 block(threads);
  const S* r = static_cast<const S*>(rhs);
  C* o = static_cast<C*>(out);
  C* w = static_cast<C*>(work);
  if (bandwidth == 3) {
    batch_sweep_kernel<S, C, 1><<<grid, block, 0, stream>>>(dg, r, o, w, n, m);
  } else if (bandwidth == 5) {
    batch_sweep_kernel<S, C, 2><<<grid, block, 0, stream>>>(dg, r, o, w, n, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.
//   dtype:     0 float, 1 double, 2 bf16 storage with float compute, output
//              and workspace
//   bandwidth: 3 or 5; diags holds that many (N, M) operand pointers
//   work:      (bandwidth / 2, N, M) workspace at the compute type
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int batch_sweep(int dtype, int bandwidth, const void* const* diags,
                           const void* rhs, void* out, void* work,
                           long long n, long long m, int threads,
                           void* stream) {
  if (n <= 0 || m <= 0 || threads <= 0 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(bandwidth, diags, rhs, out, work, n, m,
                                  threads, s);
    case 1:
      return launch<double, double>(bandwidth, diags, rhs, out, work, n, m,
                                    threads, s);
    case 2:
      return launch<__nv_bfloat16, float>(bandwidth, diags, rhs, out, work, n,
                                          m, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
