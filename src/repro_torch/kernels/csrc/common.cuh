// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is templated on its element type (float or __nv_bfloat16;
// the paged kernels' pools may also be int8_t, dequantized through f32
// scale pools), computes in f32 and converts only through the intrinsics
// below, so the sources build with or without the toolkit's implicit bf16
// conversions.
// Entry points have a plain C interface (loaded with ctypes), launch on the
// stream they are given, allocate nothing, and return cudaGetLastError()
// right after the launch so the caller sees a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro_torch {

// Masked scores are *replaced* by this value (never added to), exactly as
// the Pallas kernels do with jnp.where(mask, s, NEG_INF).
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);  // exact: every int8 is a float
}

// int8 pages carry f32 scale pools; float and bf16 pages do not
template <typename TP>
constexpr bool kQuantized = std::is_same<TP, int8_t>::value;

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

constexpr int kMaxDevices = 16;

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than `free_bytes` (the default 48 KB, less any static shared memory the
// kernel also holds; up to the 227 KB a Hopper block may use), once per
// device and size: `granted` is the launcher's record of what each device
// already allows this kernel (a function-local static of the launcher, so
// one record per kernel instantiation), so a steady stream of launches makes
// no attribute call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t (&granted)[kMaxDevices],
                              size_t free_bytes = 48 * 1024) {
  if (bytes <= free_bytes) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev] = bytes;
  return err;
}

}  // namespace repro_torch
