// shared_sweep — the two-pass banded sweep of ONE shared factored LHS over
// an interleaved (N, M) batch of right-hand sides, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/engine.py
// that compute this one function at three VMEM tilings:
//   _shared_resident_kernel (engine.py:760), _shared_streamed_kernel
//   (engine.py:777), _shared_fused_kernel (engine.py:795).
// They tile N only because a TPU core has 12 MiB of VMEM; a Hopper thread
// walks all N rows out of device memory, so one kernel serves all three.
//
// Each pass is  out_i = (in_i - sum_t coef_t(i) * carry_{lag_t}) * scale(i)
// with the (row, lag) terms in subtraction order and the scale row taken
// from the pass table (repro_torch/kernels/engine.py::_PASS_TABLE) and
// handed in as a SweepDesc: one template serves tridiagonal and
// pentadiagonal, forward and transposed, constant and uniform variants.
//
// Design (the paper's CUDA mapping):
//   * one thread per system m; a warp reads 32 consecutive m of row i, so
//     every RHS access is coalesced; blocks tile M and the ragged edge of
//     M is masked (masked threads still reach every __syncthreads);
//   * the factor is staged in shared memory chunk_n rows at a time, read
//     once per block and broadcast to its threads; the uniform eps value
//     is staged as one more row, read from a 1-element device tensor;
//   * carries stay in registers and start at zero at both ends, so the
//     first and last rows need no special case;
//   * the forward pass ascends and writes the intermediate into the
//     output; the backward pass descends and overwrites it in place;
//   * storage float, double or bf16 (bf16 computes in float); the output
//     is at the compute type; offsets are 64-bit (N*M overflows int32).
//
// Bound: device-memory bytes.  The function needs 2NM + kN words (each
// RHS word read once, each x word written once, k factor rows).  This
// simple design moves about 4NM: the intermediate round-trips through the
// output (write, read back, write).  Reaching the floor is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct PassDesc {
  int src[2];  // shared-memory row of each term's coefficient (-1: none)
  int lag[2];  // carry lag of each term (1 or 2)
  int scale;   // shared-memory row of the scale (-1: unscaled pass)
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
__global__ void shared_sweep_kernel(const S* __restrict__ lhs, int rows,
                                    const S* __restrict__ rhs, C* out,
                                    const S* __restrict__ eps, int64_t n,
                                    int64_t m, SweepDesc desc, int chunk_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* coef = reinterpret_cast<C*>(smem_raw);

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

PassDesc read_pass(const int* d) {
  PassDesc p;
  p.src[0] = d[0];
  p.lag[0] = d[1];
  p.src[1] = d[2];
  p.lag[1] = d[3];
  p.scale = d[4];
  return p;
}

template <typename S, typename C>
int launch(const void* lhs, int rows, const void* rhs, void* out,
           const void* eps, int64_t n, int64_t m, int order,
           const SweepDesc& desc, int threads, int chunk_n,
           cudaStream_t stream) {
  const int stage_rows = rows + (eps != nullptr ? 1 : 0);
  const size_t smem = (size_t)stage_rows * chunk_n * sizeof(C);
  const dim3 grid((unsigned)((m + threads - 1) / threads));
  const dim3 block(threads);
  const S* l = static_cast<const S*>(lhs);
  const S* r = static_cast<const S*>(rhs);
  const S* e = static_cast<const S*>(eps);
  C* o = static_cast<C*>(out);
  if (order == 1) {
    shared_sweep_kernel<S, C, 1>
        <<<grid, block, smem, stream>>>(l, rows, r, o, e, n, m, desc, chunk_n);
  } else if (order == 2) {
    shared_sweep_kernel<S, C, 2>
        <<<grid, block, smem, stream>>>(l, rows, r, o, e, n, m, desc, chunk_n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.
//   dtype: 0 float, 1 double, 2 bf16 storage with float compute and output
//   desc:  11 ints, [order, fwd src0 lag0 src1 lag1 scale, bwd ...]; a
//          coefficient row equal to `rows` is the staged eps row
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int shared_sweep(int dtype, const void* lhs, int rows,
                            const void* rhs, void* out, const void* eps,
                            long long n, long long m, const int* desc,
                            int threads, int chunk_n, void* stream) {
  if (n <= 0 || m <= 0 || threads <= 0 || chunk_n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  SweepDesc sd;
  sd.fwd = read_pass(desc + 1);
  sd.bwd = read_pass(desc + 6);
  const int order = desc[0];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(lhs, rows, rhs, out, eps, n, m, order, sd,
                                  threads, chunk_n, s);
    case 1:
      return launch<double, double>(lhs, rows, rhs, out, eps, n, m, order, sd,
                                    threads, chunk_n, s);
    case 2:
      return launch<__nv_bfloat16, float>(lhs, rows, rhs, out, eps, n, m,
                                          order, sd, threads, chunk_n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
