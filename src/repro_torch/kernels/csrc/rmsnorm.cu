// Fused row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * gamma, f32 math.
//
// Replaces: repro/kernels/rmsnorm.py::rmsnorm (Pallas, _rmsnorm_kernel).
// Bound on the H100: bytes. A row of d elements is read once, gamma once
// (it stays in L2 across rows) and the row written once; the arithmetic is
// three flops an element, far below the card's rate.
// Design: one block per row, so a row's sum of squares is a block-local
// reduction (warp shuffles, then one shared-memory pass over the warps'
// partials) and nothing crosses blocks. The second pass re-reads the row,
// which at d = 2048 is still in L1/L2; coalesced loads, one element a thread
// per step.
#include "common.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block; every thread gets the total.
__device__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    float w = lane < n_warps ? partial[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                               T* __restrict__ out, int d, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = block_sum(ss);
  const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    orow[i] = from_f32<T>(to_f32(xr[i]) * rstd * to_f32(gamma[i]));
  }
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* x, const void* gamma, void* out, int rows, int d, float eps,
           void* stream) {
  if (rows == 0) return 0;
  rmsnorm_kernel<T><<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out), d,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

extern "C" int rmsnorm_f32(const void* x, const void* gamma, void* out, int rows, int d,
                           float eps, void* stream) {
  return repro_torch::launch<float>(x, gamma, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* gamma, void* out, int rows, int d,
                            float eps, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(x, gamma, out, rows, d, eps, stream);
}
