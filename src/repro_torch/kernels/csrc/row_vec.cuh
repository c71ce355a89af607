// 16-byte vectors of a row of float or bf16 values: the loads and stores
// the two RMSNorm kernels (rmsnorm.cu, rmsnorm_bwd.cu) share. A vector that
// runs past the row's end, or one of a row whose base is off 16 bytes, is
// read and written element by element into the same slot.
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace {  // each source instantiates its own copy

// a 16-byte vector of a row, as four words
struct Vec {
  uint32_t w[4];
};

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Raw = uint32_t;
  static constexpr int kV = 4;  // values a vector
  __device__ static float get(const Vec& v, int k) { return __uint_as_float(v.w[k]); }
  __device__ static void put(Vec& v, int k, Raw bits) { v.w[k] = bits; }
  __device__ static Raw raw(const Vec& v, int k) { return v.w[k]; }
  __device__ static Raw bits(float f) { return __float_as_uint(f); }
};
template <>
struct Elem<__nv_bfloat16> {
  using Raw = uint16_t;
  static constexpr int kV = 8;
  // a bf16 is the upper half of the f32 with the same value
  __device__ static float get(const Vec& v, int k) {
    const uint32_t w = v.w[k >> 1];
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static void put(Vec& v, int k, Raw bits) {
    v.w[k >> 1] |= static_cast<uint32_t>(bits) << (16 * (k & 1));
  }
  __device__ static Raw raw(const Vec& v, int k) {
    return static_cast<Raw>(v.w[k >> 1] >> (16 * (k & 1)));
  }
  __device__ static Raw bits(float f) { return __bfloat16_as_ushort(__float2bfloat16(f)); }
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Values e .. e + kV - 1 of a row (zeros past d): one 16-byte load where the
// row is aligned and the vector lies inside it, else element by element.
template <typename T>
__device__ __forceinline__ Vec load_vec(const T* row, int e, int d, bool aligned) {
  using E = Elem<T>;
  Vec v = {{0u, 0u, 0u, 0u}};
  if (aligned && e + E::kV <= d) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + e);
    v.w[0] = u.x;
    v.w[1] = u.y;
    v.w[2] = u.z;
    v.w[3] = u.w;
  } else {
    const typename E::Raw* raw = reinterpret_cast<const typename E::Raw*>(row);
#pragma unroll
    for (int k = 0; k < E::kV; ++k) {
      if (e + k < d) E::put(v, k, raw[e + k]);
    }
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* row, int e, int d, bool aligned, const Vec& v) {
  using E = Elem<T>;
  if (aligned && e + E::kV <= d) {
    *reinterpret_cast<uint4*>(row + e) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else {
    typename E::Raw* raw = reinterpret_cast<typename E::Raw*>(row);
#pragma unroll
    for (int k = 0; k < E::kV; ++k) {
      if (e + k < d) raw[e + k] = E::raw(v, k);
    }
  }
}

}  // namespace
}  // namespace repro_torch
