// Mamba selective scan with a float32 state carried over T:
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t + D x_t,
// returning y (x's dtype) and the final state h_T (f32).
//
// Replaces: repro/kernels/ssm_scan.py::ssm_scan (Pallas, _ssm_kernel). The
// TPU kernel sweeps T as a sequential grid axis in chunks and keeps the
// (d_block, N) state in VMEM scratch between grid steps. Hopper's blocks run
// in no order, so here one block owns kChannels channels of one sequence for
// the whole sweep: a loop over T inside the block takes the place of that
// grid axis, and each thread keeps its channel's state h[N] in registers.
//
// Bound on the H100: operations. Every (t, d, n) needs one exp on the
// special-function units (16 a clock per SM), which outweighs the bytes
// (x, dt and y once, B and C once a step, A and the states once): at the
// main path's prefill (B = 1, T = 512, D = 16384, N = 16) that is 134 M exps,
// ~32 us at 1.98 GHz, against 52.5 MB, ~15.7 us at 3.35 TB/s.
//
// Design: grid (ceil(D / kChannels), B), kChannels threads, one channel a
// thread. For each chunk of kChunk steps the block stages x and dt of its
// channels (coalesced: neighbouring threads read neighbouring channels) and
// the chunk's B_t and C_t rows, which every channel reads, in shared memory;
// the sequential walk over t then touches only shared memory and registers.
// Inputs are read through their strides (B and C are column slices of the
// x_proj output and are never copied). Channels past D are masked, any
// T >= 1 runs, so no shape needs the plain version. State math is f32 with
// expf (not __expf), so the kernel keeps the plain version's accuracy.
// Known limit: at B = 1, D = 16384 the grid is 128 blocks of 4 warps, under
// one block per SM; splitting N across lanes (a warp reduction for y) is the
// next step.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChannels = 128;  // threads a block, one channel each
constexpr int kChunk = 32;      // time steps staged in shared memory at once
constexpr int kMaxState = 16;   // largest N the registers hold (Jamba: 16)

template <typename T>
__global__ void __launch_bounds__(kChannels)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ Dskip,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ hT, int T_len, int D, int N, long long sxb,
                    long long sxt, long long sxd, long long sdb, long long sdt,
                    long long sdd, long long sbb, long long sbt, long long sbn,
                    long long scb, long long sct, long long scn) {
  __shared__ float xs[kChunk][kChannels];
  __shared__ float ds[kChunk][kChannels];
  __shared__ float bs[kChunk][kMaxState];
  __shared__ float cs[kChunk][kMaxState];

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int d = blockIdx.x * kChannels + tid;
  const bool live = d < D;

  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    const bool on = live && n < N;
    a[n] = on ? A[static_cast<long long>(d) * N + n] : 0.f;
    h[n] = (on && h0 != nullptr) ? h0[(b * D + d) * N + n] : 0.f;
  }
  const float skip = live ? to_f32(Dskip[d]) : 0.f;
  const T* xb = x + b * sxb + static_cast<long long>(d) * sxd;
  const T* db = dt + b * sdb + static_cast<long long>(d) * sdd;
  const T* bb = Bm + b * sbb;
  const T* cb = Cm + b * scb;
  T* yb = y + b * T_len * D + d;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int tc = min(kChunk, T_len - t0);
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll 8
    for (int tt = 0; tt < tc; ++tt) {
      const long long t = t0 + tt;
      xs[tt][tid] = live ? to_f32(xb[t * sxt]) : 0.f;
      ds[tt][tid] = live ? to_f32(db[t * sdt]) : 0.f;
    }
    for (int i = tid; i < tc * N; i += kChannels) {
      const long long t = t0 + i / N;
      const int n = i % N;
      bs[i / N][n] = to_f32(bb[t * sbt + n * sbn]);
      cs[i / N][n] = to_f32(cb[t * sct + n * scn]);
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < tc; ++tt) {
      const float xv = xs[tt][tid];
      const float dv = ds[tt][tid];
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxState; ++n) {
        if (n < N) {
          h[n] = expf(dv * a[n]) * h[n] + dx * bs[tt][n];
          acc += h[n] * cs[tt][n];
        }
      }
      yb[static_cast<long long>(t0 + tt) * D] = from_f32<T>(acc + xv * skip);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) {
      if (n < N) hT[(b * D + d) * N + n] = h[n];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* Dskip, const void* h0, void* y, void* hT, int B, int T_len, int D,
           int N, long long sxb, long long sxt, long long sxd, long long sdb,
           long long sdt, long long sdd, long long sbb, long long sbt, long long sbn,
           long long scb, long long sct, long long scn, void* stream) {
  if (B == 0 || D == 0 || T_len == 0) return 0;
  if (N < 1 || N > kMaxState) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<T><<<grid, kChannels, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const T*>(Dskip),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hT), T_len,
      D, N, sxb, sxt, sxd, sdb, sdt, sdd, sbb, sbt, sbn, scb, sct, scn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

#define REPRO_SSM_SCAN_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* x, const void* dt, const void* A, const void* Bm,    \
                      const void* Cm, const void* Dskip, const void* h0, void* y,       \
                      void* hT, int B, int T_len, int D, int N, long long sxb,          \
                      long long sxt, long long sxd, long long sdb, long long sdt,       \
                      long long sdd, long long sbb, long long sbt, long long sbn,       \
                      long long scb, long long sct, long long scn, void* stream) {      \
    return repro_torch::launch<T>(x, dt, A, Bm, Cm, Dskip, h0, y, hT, B, T_len, D, N,   \
                                  sxb, sxt, sxd, sdb, sdt, sdd, sbb, sbt, sbn, scb, sct, \
                                  scn, stream);                                          \
  }

REPRO_SSM_SCAN_ENTRY(ssm_scan_f32, float)
REPRO_SSM_SCAN_ENTRY(ssm_scan_bf16, __nv_bfloat16)
