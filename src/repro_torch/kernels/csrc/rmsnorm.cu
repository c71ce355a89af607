// Fused row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * gamma, f32 math.
//
// Replaces: repro/kernels/rmsnorm.py::rmsnorm (Pallas, _rmsnorm_kernel).
//
// Bound on the H100: at the main path's sizes, latency. A row is read once
// and written once and gamma is read once (three flops an element), so the
// bytes bound is 0.16 us at 64 x 2048 bf16 and 5 us at Jamba's 512 x 8192,
// against an empty launch's ~2 us. What costs is the chain inside a row:
// load, reduce, scale, store. The body it replaces (one 256-thread block a
// row, one element a thread a step, two __syncthreads() a row, the row read
// twice) spent 4.2 us at 64 x 2048 bf16.
//
// Design: W warps hold a row (W from _build.rmsnorm_warps: one warp up to
// 2048 bf16 or 1024 f32 values, doubling with d, at most 16). Each thread
// holds kSlots 16-byte vectors of the row in registers (8 bf16 or 4 f32 a
// vector, neighbouring lanes on neighbouring vectors), so the row comes from
// device memory once: all of a thread's loads are in flight together, the sum
// of squares is taken from the registers, reduced by warp shuffles (and, for
// W > 1, one shared-memory exchange of the W partial sums), and the output is
// written from the same registers with 16-byte stores. A CTA holds one row,
// and its gamma loads are issued with the row's, so both are in flight at
// once. (A CTA that walks several rows with gamma loaded once was slower at
// every row count swept, 8 to 8192: its rows wait on one another.) The math
// is f32 in the plain version's order, (x * rstd) * gamma, cast once; only
// the sum of squares is in another order.
//
// Every shape the plain version takes runs here, in this one body: a vector
// that runs past d (a ragged tail), or one of a row whose base is off 16 bytes
// (a misaligned x, gamma or output, or odd rows when d is not a multiple of
// the vector width), is read and written element by element into the same
// slot; values of a row wider than the slots hold (more than 32768 bf16 or
// 16384 f32) are streamed and read again for the output; rows = 0 launches
// nothing. The launcher refuses a W it has no form for.
#include "row_vec.cuh"

namespace repro_torch {
namespace {

constexpr int kSlots = 8;  // 16-byte vectors of a row a thread holds

template <typename T>
__device__ __forceinline__ float sum_squares(const Vec& v, float ss) {
#pragma unroll
  for (int k = 0; k < Elem<T>::kV; ++k) {
    const float f = Elem<T>::get(v, k);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// out = (x * rstd) * gamma, rounded once
template <typename T>
__device__ __forceinline__ Vec scale(const Vec& xv, const Vec& gv, float rstd) {
  using E = Elem<T>;
  Vec o = {{0u, 0u, 0u, 0u}};
#pragma unroll
  for (int k = 0; k < E::kV; ++k) E::put(o, k, E::bits(E::get(xv, k) * rstd * E::get(gv, k)));
  return o;
}

template <typename T, int W>
__global__ void __launch_bounds__(W * 32)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
                   int d, float eps) {
  constexpr int V = Elem<T>::kV;
  constexpr int kStride = W * 32 * V;  // values between a thread's slots
  __shared__ float partial[W];
  const int tid = threadIdx.x;
  const int first = tid * V;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  const bool xa = aligned16(xr), oa = aligned16(orow), ga = aligned16(gamma);
  Vec v[kSlots], g[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) v[j] = load_vec(xr, first + j * kStride, d, xa);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) g[j] = load_vec(gamma, first + j * kStride, d, ga);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) ss = sum_squares<T>(v[j], ss);
  // the values past the slots (rows wider than kSlots * kStride)
  for (int e = first + kSlots * kStride; e < d; e += kStride)
    ss = sum_squares<T>(load_vec(xr, e, d, xa), ss);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (W > 1) {  // one exchange of the warps' sums
    if ((tid & 31) == 0) partial[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) ss += partial[w];
  }
  const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    store_vec(orow, first + j * kStride, d, oa, scale<T>(v[j], g[j], rstd));
  for (int e = first + kSlots * kStride; e < d; e += kStride)
    store_vec(orow, e, d, oa, scale<T>(load_vec(xr, e, d, xa), load_vec(gamma, e, d, ga), rstd));
}

// warps: warps a row (1, 2, 4, 8 or 16), from _build.rmsnorm_warps; refused
// when the launcher has no form for it
template <typename T>
int launch(const void* x, const void* gamma, void* out, int rows, int d, int warps, float eps,
           void* stream) {
  if (rows < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  T* op = static_cast<T*>(out);
  switch (warps) {
#define REPRO_RMSNORM_WARPS(W)                                                  \
  case W:                                                                       \
    if (rows) rmsnorm_kernel<T, W><<<rows, W * 32, 0, s>>>(xp, gp, op, d, eps); \
    return static_cast<int>(cudaGetLastError());
    REPRO_RMSNORM_WARPS(1)
    REPRO_RMSNORM_WARPS(2)
    REPRO_RMSNORM_WARPS(4)
    REPRO_RMSNORM_WARPS(8)
    REPRO_RMSNORM_WARPS(16)
#undef REPRO_RMSNORM_WARPS
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int rmsnorm_f32(const void* x, const void* gamma, void* out, int rows, int d,
                           int warps, float eps, void* stream) {
  return repro_torch::launch<float>(x, gamma, out, rows, d, warps, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* gamma, void* out, int rows, int d,
                            int warps, float eps, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(x, gamma, out, rows, d, warps, eps, stream);
}
