// Backward of the fused row RMSNorm (rmsnorm.cu): dx and dgamma from x,
// gamma and the output's gradient dy, f32 math.
//
// Replaces: the reverse-mode of repro/kernels/rmsnorm.py::rmsnorm, which the
// JAX package does not have (jax.grad through a Pallas kernel fails, so JAX
// trains through its jnp oracle). This is the gradient of the forward kernel,
// which the port's trainer runs on the card (ops._RMSNorm).
//
// With r = rsqrt(mean(x^2) + eps) and u = dy * gamma over a row of d:
//   dx = r * u - x * (r^3 * mean(u * x)),   dgamma = sum over rows of dy * x * r.
//
// Bound on the H100: bytes. x and dy are read and dx written once (three
// flops an element a pass), gamma read and dgamma written once: at
// stablelm-1.6b's training shape (4096 x 2048 bf16) 50 MB, 0.015 ms.
//
// Design: two launches, no float atomics, so the result is the same bit for
// bit run after run on one card.
// 1. One CTA of 256 threads walks a run of rows_per_cta rows (the wrapper
//    picks it from the row count and the SMs, _build.rmsnorm_bwd_rows); gamma
//    is staged once in shared memory as f32. A row takes two passes over its
//    columns (thread t owns columns t, t + 256, ...; neighbouring threads on
//    neighbouring elements): the first sums x^2 and u * x (warp shuffles, then
//    one exchange of the 8 warps' sums, every thread adding them in the same
//    order), the second reads x and dy again (from L1/L2) and writes dx rounded
//    once, and adds dy * x * r to the CTA's f32 dgamma partial in shared
//    memory, at the thread's own columns (no race, no atomics). The CTA then
//    writes its partial row to an f32 scratch (ctas, d).
// 2. One thread a column sums the CTAs' partials in CTA order and writes
//    dgamma, rounded once to gamma's dtype.
// x, dy and dx are contiguous rows of d; d up to _build.RMSNORM_BWD_MAX_D
// (two f32 rows of shared memory); the wrapper refuses wider rows and
// launches nothing for rows = 0.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// sums of a and b over the CTA, the same value in every thread
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    s.x += red[w];
    s.y += red[kWarps + w];
  }
  __syncthreads();  // red is free for the next row
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int rows, int d, int rows_per_cta,
                       float eps) {
  extern __shared__ float smem[];
  float* g_s = smem;        // [d] gamma, f32
  float* dg_s = g_s + d;    // [d] this CTA's dgamma partial
  __shared__ float red[2 * kWarps];
  const int tid = threadIdx.x;
  for (int c = tid; c < d; c += kThreads) {
    g_s[c] = to_f32(gamma[c]);
    dg_s[c] = 0.f;
  }
  __syncthreads();
  const int first = blockIdx.x * rows_per_cta;
  const int last = min(rows, first + rows_per_cta);
  const float inv_d = 1.f / static_cast<float>(d);
  for (int row = first; row < last; ++row) {
    const T* xr = x + static_cast<size_t>(row) * d;
    const T* dyr = dy + static_cast<size_t>(row) * d;
    T* dxr = dx + static_cast<size_t>(row) * d;
    float ss = 0.f, ux = 0.f;
    for (int c = tid; c < d; c += kThreads) {
      const float xv = to_f32(xr[c]);
      ss = fmaf(xv, xv, ss);
      ux = fmaf(to_f32(dyr[c]) * g_s[c], xv, ux);
    }
    const float2 s = block_sum2(ss, ux, red);
    const float r = rsqrtf(s.x * inv_d + eps);
    const float coef = r * r * r * (s.y * inv_d);
    for (int c = tid; c < d; c += kThreads) {
      const float xv = to_f32(xr[c]);
      const float dv = to_f32(dyr[c]);
      dxr[c] = from_f32<T>(r * (dv * g_s[c]) - xv * coef);
      dg_s[c] = fmaf(dv * xv, r, dg_s[c]);
    }
  }
  for (int c = tid; c < d; c += kThreads)
    partial[static_cast<size_t>(blockIdx.x) * d + c] = dg_s[c];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dgamma_kernel(const float* __restrict__ partial, T* __restrict__ dgamma, int ctas, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int i = 0; i < ctas; ++i) acc += partial[static_cast<size_t>(i) * d + c];
  dgamma[c] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* dy, void* dx, void* partial,
           void* dgamma, int rows, int d, int rows_per_cta, float eps, void* stream) {
  if (rows < 1 || d < 1 || rows_per_cta < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(d);
  static size_t granted[kMaxDevices] = {};
  cudaError_t err = allow_smem(rmsnorm_bwd_kernel<T>, smem, granted,
                               48 * 1024 - 2 * kWarps * sizeof(float));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  rmsnorm_bwd_kernel<T><<<ctas, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d, rows_per_cta, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dgamma_kernel<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<T*>(dgamma), ctas, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

extern "C" int rmsnorm_bwd_f32(const void* x, const void* gamma, const void* dy, void* dx,
                               void* partial, void* dgamma, int rows, int d, int rows_per_cta,
                               float eps, void* stream) {
  return repro_torch::launch<float>(x, gamma, dy, dx, partial, dgamma, rows, d, rows_per_cta,
                                    eps, stream);
}

extern "C" int rmsnorm_bwd_bf16(const void* x, const void* gamma, const void* dy, void* dx,
                                void* partial, void* dgamma, int rows, int d, int rows_per_cta,
                                float eps, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(x, gamma, dy, dx, partial, dgamma, rows, d,
                                            rows_per_cta, eps, stream);
}
