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
// Design: one pass over memory, two launches, no float atomics, so the
// result is the same bit for bit run after run on one card.
// 1. One CTA of 256 threads holds a row: thread t owns the 16-byte vectors
//    at columns (t + 256 j) * V, j < S (V = 8 bf16 or 4 f32 values a vector,
//    neighbouring threads on neighbouring vectors; S slots, 1, 2 or 4, from
//    _build.rmsnorm_bwd_slots). The CTA walks a run of rows_per_cta rows
//    (_build.rmsnorm_bwd_rows: as many CTAs as the SMs hold at once, by
//    the occupancy of the form launched, rmsnorm_bwd_ctas_per_sm_*), 4 / S
//    rows at a time, so each thread keeps four 16-byte loads of x and four
//    of dy in flight whatever the width. A
//    row's x and dy are read from device memory once into registers: the
//    sums of x^2 and u * x come from the registers (warp shuffles, then one
//    exchange of the 8 warps' sums for all the rows in flight, every thread
//    adding them in the same order), and dx is written from the same
//    registers, rounded once, with 16-byte stores. gamma is read once into
//    registers. Because a thread owns the same columns in every row, its
//    share of the CTA's dgamma partial (dy * x * r summed over the run, in
//    row order) stays in f32 registers and is written once, to an f32
//    scratch row (ctas, d).
//    A row wider than the slots hold (more than 8192 bf16 or 4096 f32
//    values) takes its columns past them in a streamed loop: they are read
//    a second time (from L2) for dx, and their partial is kept in shared
//    memory, each thread at its own columns (no race, no atomics).
// 2. dgamma: one CTA of 512 threads a slice of 32 columns. Its 16 warps each
//    sum every 16th partial row in CTA order (a warp reads 128 contiguous
//    bytes of a row), and the 16 sums of a column are added in warp order
//    and rounded once to gamma's dtype: ceil(d / 32) CTAs, each thread a
//    sixteenth of the partials, where one thread a column summed them all.
// x, dy and dx are contiguous rows of d, d up to _build.RMSNORM_BWD_MAX_D
// (the streamed tail's partial in shared memory). Two forms of stage 1,
// picked by the wrapper and checked by the launcher: where x, dy, dx and
// gamma start on 16 bytes and d is a multiple of V, every vector is one
// plain 16-byte access; elsewhere a
// vector that runs past d, or one of a row whose base is off 16 bytes, is
// read and written element by element (one kernel with both paths holds
// registers for both). The wrapper refuses wider rows and launches nothing
// for rows = 0.
#include "row_vec.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;   // 16-byte vectors of x (and of dy) a thread loads at once
constexpr int kSumWarps = 16;  // the dgamma stage's warps a column slice

// Values e .. e + V - 1 of a row (zeros past d). A: every row of x, dy and
// dx and gamma start on 16 bytes and d is a multiple of V, so a vector is a
// plain 16-byte access or lies wholly past d; else row_vec.cuh's checked
// forms (the two paths of one kernel would hold registers for both).
template <bool A, typename T>
__device__ __forceinline__ Vec load_row(const T* row, int e, int d, bool aligned) {
  if constexpr (A) {
    if (e >= d) return Vec{{0u, 0u, 0u, 0u}};
    const uint4 u = *reinterpret_cast<const uint4*>(row + e);
    return Vec{{u.x, u.y, u.z, u.w}};
  } else {
    return load_vec(row, e, d, aligned);
  }
}

template <bool A, typename T>
__device__ __forceinline__ void store_row(T* row, int e, int d, bool aligned, const Vec& v) {
  if constexpr (A) {
    if (e < d) *reinterpret_cast<uint4*>(row + e) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else {
    store_vec(row, e, d, aligned, v);
  }
}

template <typename T, int S, bool A>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int rows, int d, int rows_per_cta,
                       float eps) {
  using E = Elem<T>;
  constexpr int V = E::kV;
  constexpr int R = kInFlight / S;          // rows in flight
  constexpr int kStride = kThreads * V;     // values between a thread's slots
  constexpr int kHeld = S * kStride;        // values of a row the slots hold
  extern __shared__ float tail_dg[];        // [d - kHeld]: the tail's partial
  __shared__ float red[kWarps][2 * R];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int first_col = tid * V;
  const bool has_tail = d > kHeld;
  for (int e = kHeld + first_col; e < d; e += kStride)
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (e + k < d) tail_dg[e - kHeld + k] = 0.f;

  Vec gv[S];
  float dg[S][V];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    gv[j] = load_row<A>(gamma, first_col + j * kStride, d, aligned16(gamma));
#pragma unroll
    for (int k = 0; k < V; ++k) dg[j][k] = 0.f;
  }
  const int first = blockIdx.x * rows_per_cta;
  const int last = min(rows, first + rows_per_cta);
  const float inv_d = 1.f / static_cast<float>(d);

  for (int row0 = first; row0 < last; row0 += R) {
    Vec xv[R][S], dv[R][S];
    float sums[2 * R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t at = static_cast<size_t>(row0 + r) * d;
      const bool live = row0 + r < last;
      const bool xa = aligned16(x + at), da = aligned16(dy + at);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int e = first_col + j * kStride;
        xv[r][j] = live ? load_row<A>(x + at, e, d, xa) : Vec{{0u, 0u, 0u, 0u}};
        dv[r][j] = live ? load_row<A>(dy + at, e, d, da) : Vec{{0u, 0u, 0u, 0u}};
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ss = 0.f, ux = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xf = E::get(xv[r][j], k);
          ss = fmaf(xf, xf, ss);
          ux = fmaf(E::get(dv[r][j], k) * E::get(gv[j], k), xf, ux);
        }
      }
      if (R == 1 && has_tail && row0 < last) {  // the columns past the slots
        const size_t at = static_cast<size_t>(row0) * d;
        const bool xa = aligned16(x + at), da = aligned16(dy + at), ga = aligned16(gamma);
        for (int e = kHeld + first_col; e < d; e += kStride) {
          const Vec a = load_row<A>(x + at, e, d, xa), b = load_row<A>(dy + at, e, d, da);
          const Vec c = load_row<A>(gamma, e, d, ga);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float xf = E::get(a, k);
            ss = fmaf(xf, xf, ss);
            ux = fmaf(E::get(b, k) * E::get(c, k), xf, ux);
          }
        }
      }
      sums[2 * r] = ss;
      sums[2 * r + 1] = ux;
    }
    // the rows' sums over the CTA: shuffles, then one exchange of the warps'
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sums[i] += __shfl_xor_sync(0xffffffffu, sums[i], off);
    }
    if ((tid & 31) == 0) {
#pragma unroll
      for (int i = 0; i < 2 * R; ++i) red[warp][i] = sums[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][i];
      sums[i] = s;
    }
    __syncthreads();  // red is free for the next rows

#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r >= last) continue;
      const float rs = rsqrtf(sums[2 * r] * inv_d + eps);
      const float coef = rs * rs * rs * (sums[2 * r + 1] * inv_d);
      const size_t at = static_cast<size_t>(row0 + r) * d;
      const bool oa = aligned16(dx + at);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        Vec o = {{0u, 0u, 0u, 0u}};
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xf = E::get(xv[r][j], k);
          const float df = E::get(dv[r][j], k);
          E::put(o, k, E::bits(rs * (df * E::get(gv[j], k)) - xf * coef));
          dg[j][k] = fmaf(df * xf, rs, dg[j][k]);
        }
        store_row<A>(dx + at, first_col + j * kStride, d, oa, o);
      }
      if (R == 1 && has_tail) {
        const bool xa = aligned16(x + at), da = aligned16(dy + at), ga = aligned16(gamma);
        for (int e = kHeld + first_col; e < d; e += kStride) {
          const Vec a = load_row<A>(x + at, e, d, xa), b = load_row<A>(dy + at, e, d, da);
          const Vec c = load_row<A>(gamma, e, d, ga);
          Vec o = {{0u, 0u, 0u, 0u}};
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float xf = E::get(a, k);
            const float df = E::get(b, k);
            E::put(o, k, E::bits(rs * (df * E::get(c, k)) - xf * coef));
            if (e + k < d) tail_dg[e - kHeld + k] = fmaf(df * xf, rs, tail_dg[e - kHeld + k]);
          }
          store_row<A>(dx + at, e, d, oa, o);
        }
      }
    }
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = first_col + j * kStride;
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (e + k < d) out[e + k] = dg[j][k];
  }
  for (int e = kHeld + first_col; e < d; e += kStride)
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (e + k < d) out[e + k] = tail_dg[e - kHeld + k];
}

template <typename T>
__global__ void __launch_bounds__(32 * kSumWarps)
    dgamma_kernel(const float* __restrict__ partial, T* __restrict__ dgamma, int ctas, int d) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int i = warp; i < ctas; i += kSumWarps) acc += partial[static_cast<size_t>(i) * d + c];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < d) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) s += sums[w][lane];
    dgamma[c] = from_f32<T>(s);
  }
}

// The dynamic shared memory of a form at width d (the streamed tail's
// dgamma partial), with the kernel allowed to take it on this device.
template <typename T, int S, bool A>
cudaError_t prepare_form(int d, size_t* smem) {
  constexpr int kHeld = S * kThreads * Elem<T>::kV;
  *smem = d > kHeld ? sizeof(float) * static_cast<size_t>(d - kHeld) : 0;
  static size_t granted[kMaxDevices] = {};
  return allow_smem(rmsnorm_bwd_kernel<T, S, A>, *smem, granted,
                    48 * 1024 - 2 * kInFlight * kWarps * sizeof(float));
}

template <typename T, int S, bool A>
int launch_form(const T* x, const T* gamma, const T* dy, T* dx, float* partial, int rows,
                int d, int rows_per_cta, float eps, cudaStream_t s) {
  size_t smem = 0;
  const cudaError_t err = prepare_form<T, S, A>(d, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_kernel<T, S, A><<<(rows + rows_per_cta - 1) / rows_per_cta, kThreads, smem, s>>>(
      x, gamma, dy, dx, partial, rows, d, rows_per_cta, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_slots(const T* x, const T* gamma, const T* dy, T* dx, float* partial, T* dgamma,
                 int rows, int d, int rows_per_cta, bool aligned, float eps, cudaStream_t s) {
  constexpr int kHeld = S * kThreads * Elem<T>::kV;
  // a row the slots do not hold streams its tail one row at a time
  if (d > kHeld && kInFlight / S > 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = static_cast<cudaError_t>(
      aligned ? launch_form<T, S, true>(x, gamma, dy, dx, partial, rows, d, rows_per_cta, eps, s)
              : launch_form<T, S, false>(x, gamma, dy, dx, partial, rows, d, rows_per_cta, eps,
                                         s));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  dgamma_kernel<T><<<(d + 31) / 32, 32 * kSumWarps, 0, s>>>(partial, dgamma, ctas, d);
  return static_cast<int>(cudaGetLastError());
}

// slots: 16-byte vectors of a row a thread holds (1, 2 or 4), from
// _build.rmsnorm_bwd_slots; aligned: the form of plain 16-byte accesses,
// from rmsnorm.rmsnorm_bwd_aligned. Refused when the launcher has no form
// for the slots, or when the pointers or d do not allow the aligned form.
template <typename T>
int launch(const void* x, const void* gamma, const void* dy, void* dx, void* partial,
           void* dgamma, int rows, int d, int rows_per_cta, int slots, int aligned, float eps,
           void* stream) {
  if (rows < 1 || d < 1 || rows_per_cta < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (aligned && !(aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(gamma) &&
                   d % Elem<T>::kV == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  T* dgp = static_cast<T*>(dgamma);
  const bool a = aligned != 0;
  switch (slots) {
    case 1: return launch_slots<T, 1>(xp, gp, dyp, dxp, pp, dgp, rows, d, rows_per_cta, a, eps, s);
    case 2: return launch_slots<T, 2>(xp, gp, dyp, dxp, pp, dgp, rows, d, rows_per_cta, a, eps, s);
    case 4: return launch_slots<T, 4>(xp, gp, dyp, dxp, pp, dgp, rows, d, rows_per_cta, a, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of one form that a SM of the current device holds at once, from the
// registers and shared memory ptxas left it: the row split's target
// (_build.rmsnorm_bwd_rows), so that every CTA of a launch runs in one wave.
template <typename T, int S, bool A>
int form_ctas_per_sm(int d, int* out) {
  size_t smem = 0;
  cudaError_t err = prepare_form<T, S, A>(d, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, rmsnorm_bwd_kernel<T, S, A>, kThreads,
                                                      smem);
  return static_cast<int>(err);
}

template <typename T>
int ctas_per_sm(int d, int slots, int aligned, void* out) {
  int* n = static_cast<int*>(out);
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (slots * 2 + (aligned != 0)) {
    case 2: return form_ctas_per_sm<T, 1, false>(d, n);
    case 3: return form_ctas_per_sm<T, 1, true>(d, n);
    case 4: return form_ctas_per_sm<T, 2, false>(d, n);
    case 5: return form_ctas_per_sm<T, 2, true>(d, n);
    case 8: return form_ctas_per_sm<T, 4, false>(d, n);
    case 9: return form_ctas_per_sm<T, 4, true>(d, n);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int rmsnorm_bwd_f32(const void* x, const void* gamma, const void* dy, void* dx,
                               void* partial, void* dgamma, int rows, int d, int rows_per_cta,
                               int slots, int aligned, float eps, void* stream) {
  return repro_torch::launch<float>(x, gamma, dy, dx, partial, dgamma, rows, d, rows_per_cta,
                                    slots, aligned, eps, stream);
}

extern "C" int rmsnorm_bwd_bf16(const void* x, const void* gamma, const void* dy, void* dx,
                                void* partial, void* dgamma, int rows, int d, int rows_per_cta,
                                int slots, int aligned, float eps, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(x, gamma, dy, dx, partial, dgamma, rows, d,
                                            rows_per_cta, slots, aligned, eps, stream);
}

// out: an int, the CTAs a SM of the form (slots, aligned) holds at width d
extern "C" int rmsnorm_bwd_ctas_per_sm_f32(int d, int slots, int aligned, void* out) {
  return repro_torch::ctas_per_sm<float>(d, slots, aligned, out);
}

extern "C" int rmsnorm_bwd_ctas_per_sm_bf16(int d, int slots, int aligned, void* out) {
  return repro_torch::ctas_per_sm<__nv_bfloat16>(d, slots, aligned, out);
}
