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
// The streamed one chunks N because a TPU core has 12 MiB of VMEM; a
// Hopper thread walks all N rows of its column out of device memory, so
// one kernel serves both.
//
// Arithmetic: acc = q_i + g0_i h_{i-1} (+ g1_i h_{i-2}), in that term
// order.  The JAX engine subtracts gates read negated, which is bitwise
// q + p h only inside JAX; nvcc contracts the expression into FMAs, so this
// kernel and its plain version (ops.recurrence_plain) agree to a few ulps.
// Built without --use_fast_math.
//
// Design:
//   * one thread per column m; a warp reads 32 consecutive m of row i, so
//     every access is coalesced; the ragged edge of M is masked;
//   * carries in registers, at float for bf16 and fp16 storage (h is
//     rounded to the storage type only where it is stored) and at double
//     for double;
//   * 64-bit offsets (N*M overflows int32); no padding of N or M.
//
// Bound: device-memory bytes.  The function moves (order + 2)·N·M words:
// the order gates and q read once, h written once; this kernel moves
// exactly that, so the simple design is already at the byte floor.  Its
// operations, 2·order per element, are far below the byte bound at the
// card's fp32 and fp64 rates.  What it lacks is threads in flight when M
// is small: the loop is unrolled so that several rows' loads are issued
// ahead of the carry chain.

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

template <typename S, typename C>
int launch(int order, int reverse, const void* const* gates, const void* q,
           void* out, int64_t n, int64_t m, int threads,
           cudaStream_t stream) {
  const S* g0 = static_cast<const S*>(gates[0]);
  const S* g1 = order == 2 ? static_cast<const S*>(gates[1]) : nullptr;
  const S* qq = static_cast<const S*>(q);
  S* o = static_cast<S*>(out);
  const dim3 grid((unsigned)((m + threads - 1) / threads));
  const dim3 block(threads);
  if (order == 1 && !reverse) {
    recurrence_kernel<S, C, 1, false><<<grid, block, 0, stream>>>(
        g0, g1, qq, o, n, m);
  } else if (order == 1) {
    recurrence_kernel<S, C, 1, true><<<grid, block, 0, stream>>>(
        g0, g1, qq, o, n, m);
  } else if (order == 2 && !reverse) {
    recurrence_kernel<S, C, 2, false><<<grid, block, 0, stream>>>(
        g0, g1, qq, o, n, m);
  } else if (order == 2) {
    recurrence_kernel<S, C, 2, true><<<grid, block, 0, stream>>>(
        g0, g1, qq, o, n, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.
//   dtype:   0 float, 1 double, 2 bf16, 3 fp16 (bf16 and fp16: float
//            carries, output at the storage type)
//   order:   1 or 2; gates holds that many (N, M) operand pointers
//   reverse: 0 ascending, 1 descending
// Every operand and the output are (N, M), contiguous, of the storage
// type.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int recurrence_sweep(int dtype, int order, int reverse,
                                const void* const* gates, const void* q,
                                void* out, long long n, long long m,
                                int threads, void* stream) {
  if (n <= 0 || m <= 0 || threads <= 0 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(order, reverse, gates, q, out, n, m,
                                  threads, s);
    case 1:
      return launch<double, double>(order, reverse, gates, q, out, n, m,
                                    threads, s);
    case 2:
      return launch<__nv_bfloat16, float>(order, reverse, gates, q, out, n,
                                          m, threads, s);
    case 3:
      return launch<__half, float>(order, reverse, gates, q, out, n, m,
                                   threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
