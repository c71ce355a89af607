// Backward of the Mamba selective scan (ssm_scan.cu). With a_t = exp(dt_t A)
// and g_t = dL/dh_t (what reaches h_t from y_t and from h_{t+1}):
//   g_t   = dy_t C_t + a_{t+1} g_{t+1}        (from dh_T, or zeros, at t = T)
//   dx_t  = D dy_t + dt_t sum_n g_t B_t
//   ddt_t = x_t sum_n g_t B_t + sum_n g_t A a_t h_{t-1}
//   dB_t  = sum_d g_t dt_t x_t,   dC_t = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1},   dD = sum_{b,t} dy_t x_t
//   dh0   = a_1 g_1 (h0 given)
//
// Replaces: the reverse mode of repro/kernels/ssm_scan.py::ssm_scan, which the
// JAX package does not have (jax.grad through a Pallas kernel fails, so JAX
// trains through its jnp oracle). This is the gradient of the forward kernel,
// which the port's trainer runs on the card (ops._SSMScan).
//
// Bound on the H100: operations. Every (t, d, n) needs an exp on the
// special-function units (16 a clock per SM) for a_t: at Jamba-1.5-Large's
// training shape (B = 1, T = 1024, D = 16384, N = 16) 268 M exps, ~64 us at
// 1.98 GHz, against ~50 us for the bytes (x, dt, dy in and dx, ddt out, bf16;
// B, C, dB, dC; the checkpoints). This kernel takes each exp twice (below).
//
// Design. The forward kernel's layout: a CTA holds kChannels (64) channels of
// one sequence, a channel's N states split over L lanes of 4 (L from
// _build.ssm_scan_lanes: 4 at N = 16), inputs read through their strides (B
// and C are column slices of x_proj's output).
// - Reverse access to h_{t-1} without storing every state (1.07 GB a layer at
//   that shape): the forward writes the state before every kCkpt-step chunk
//   (ssm_scan.cu's optional output). The backward walks the chunks in
//   reverse. For each it stages the chunk's x, dt, dy, B and C in shared
//   memory, recomputes the chunk's states from its checkpoint keeping the
//   state before every kSub-step sub-chunk (shared memory, a float4 a
//   thread), then walks the sub-chunks in reverse: each recomputes its kSub
//   states and decays into registers (fully unrolled) and runs the reverse
//   recurrence through them. Recomputation repeats the forward's arithmetic
//   (exp2f of dt * A log2 e, one FMA a state), so it gives the forward's bits.
// - Sums over n (dx, ddt): each lane writes its part to shared memory, and
//   after the sub-chunk one pass adds the L parts in lane order and stores
//   dx and ddt with neighbouring threads on neighbouring channels.
// - Sums over d (dB, dC): a warp's channels are added by xor shuffles, the
//   warps' sums in warp order after the sub-chunk, and each CTA writes its
//   sums as partials (2, ceil(D / 64), B, T, N) f32. dA (a lane's states over
//   all T of its sequence) and dD (a channel's) stay in registers and are
//   written as partials (B, D, N) and (B, D). A second launch sums every
//   partial in a fixed order: no atomics, so a rerun gives the same bits.
// - Ragged T and D: steps past T and channels past D are staged as zeros:
//   a step with dt = 0 has a_t = 1 and carries g through unchanged, and
//   contributes nothing; no such step or channel is written. Any T >= 1, any
//   D, 1 <= N <= 16, h0 and dh_T given or not: no shape needs the plain
//   version; the launcher refuses an L it has no form for.
#include "common.cuh"

// The layout's two sizes come from _build.py (SSM_CHANNELS_PER_CTA,
// SSM_CKPT_STEPS), which compiles every source with them and sizes the
// buffers these kernels write from the same values.
#if !defined(REPRO_SSM_CHANNELS) || !defined(REPRO_SSM_CKPT)
#error "build through repro_torch.kernels._build, which defines REPRO_SSM_CHANNELS and REPRO_SSM_CKPT"
#endif

namespace repro_torch {
namespace {

constexpr int kChannels = REPRO_SSM_CHANNELS;  // channels a CTA
constexpr int kStates = 4;                     // states a lane
constexpr int kMaxState = 16;                  // largest N: 4 lanes of 4
constexpr int kCkpt = REPRO_SSM_CKPT;          // steps a chunk: the forward's checkpoint interval
constexpr int kSub = 8;                        // steps a sub-chunk, whose states stay in registers
constexpr int kSubs = kCkpt / kSub;
static_assert(kChannels % 32 == 0, "ssm_scan_bwd: a CTA holds whole warps of channels");
static_assert(kCkpt > 0 && kCkpt % kSub == 0, "ssm_scan_bwd: a chunk is whole sub-chunks");
constexpr float kLog2e = 1.4426950408889634f;

// the dynamic shared memory of the L-lane form, in floats
template <int L>
struct Smem {
  static constexpr int kThreads = kChannels * L;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTile = kCkpt * kChannels;          // x, dt and dy: [kCkpt][kChannels]
  static constexpr int kBC = kCkpt * kMaxState;            // B and C: [kCkpt][kMaxState]
  static constexpr int kStarts = kSubs * kThreads * kStates;  // [kSubs][kThreads] float4
  static constexpr int kParts = 2 * kSub * kThreads;       // [2][kSub][kThreads]: sum g B, sum g A a h
  static constexpr int kWarpSums = 2 * kSub * kMaxState * kWarps;  // [2][kSub][kMaxState][kWarps]
  static constexpr size_t kBytes =
      sizeof(float) * (3 * kTile + 2 * kBC + kStarts + kParts + kWarpSums);
};

template <typename T, int L>
__global__ void __launch_bounds__(kChannels * L)
    ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const T* __restrict__ Dskip,
                        const float* __restrict__ states, const T* __restrict__ dy,
                        const float* __restrict__ dhT, T* __restrict__ dx, T* __restrict__ ddt,
                        float* __restrict__ part_bc, float* __restrict__ part_a,
                        float* __restrict__ part_d, float* __restrict__ dh0, int n_seq,
                        int T_len, int D, int N, long long sxb, long long sxt, long long sxd,
                        long long sdb, long long sdt, long long sdd, long long sbb,
                        long long sbt, long long sbn, long long scb, long long sct,
                        long long scn) {
  using S = Smem<L>;
  constexpr int kThreads = S::kThreads;
  constexpr int kWarps = S::kWarps;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ds = xs + S::kTile;
  float* gs = ds + S::kTile;  // dy
  float* bs = gs + S::kTile;
  float* cs = bs + S::kBC;
  float4* starts = reinterpret_cast<float4*>(cs + S::kBC);
  float* parts = reinterpret_cast<float*>(starts + kSubs * kThreads);
  float* wsum = parts + S::kParts;

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int blk = blockIdx.x;
  const int n_blk = gridDim.x;
  const int d0 = blk * kChannels;
  // the compute role: lane l of channel c holds states n0 .. n0 + 3
  const int c = tid / L, l = tid % L;
  const int d = d0 + c;
  const bool live = d < D;
  const int n0 = l * kStates;
  const int warp = tid / 32;
  float a2[kStates], an[kStates], G[kStates], dA[kStates];
  bool on[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    on[s] = live && n0 + s < N;
    an[s] = on[s] ? A[static_cast<long long>(d) * N + n0 + s] : 0.f;
    a2[s] = an[s] * kLog2e;
    // G: what reaches h_t from h_{t+1}; at t = T - 1, dh_T
    G[s] = (on[s] && dhT != nullptr) ? dhT[(b * D + d) * N + n0 + s] : 0.f;
    dA[s] = 0.f;
  }
  // the finishing role: thread tid finishes channel sc at steps st, st + L, ...
  const int sc = tid % kChannels, st = tid / kChannels;
  const bool s_live = d0 + sc < D;
  const float skip = s_live ? to_f32(Dskip[d0 + sc]) : 0.f;
  float dD = 0.f;

  const int n_ckpt = (T_len + kCkpt - 1) / kCkpt;
  for (int ck = n_ckpt - 1; ck >= 0; --ck) {
    const int t0 = ck * kCkpt;
    const int tc = min(kCkpt, T_len - t0);
    __syncthreads();  // the last chunk's tiles are read before they are written again
    for (int e = tid; e < kCkpt * kChannels; e += kThreads) {
      const int tt = e / kChannels, cc = e % kChannels;
      const long long t = t0 + tt;
      const bool in = tt < tc && d0 + cc < D;
      const long long dd = d0 + cc;
      xs[e] = in ? to_f32(x[b * sxb + t * sxt + dd * sxd]) : 0.f;
      ds[e] = in ? to_f32(dt[b * sdb + t * sdt + dd * sdd]) : 0.f;
      gs[e] = in ? to_f32(dy[(b * T_len + t) * D + dd]) : 0.f;
    }
    for (int e = tid; e < kCkpt * kMaxState; e += kThreads) {
      const int tt = e / kMaxState, n = e % kMaxState;
      const long long t = t0 + tt;
      const bool in = tt < tc && n < N;
      bs[e] = in ? to_f32(Bm[b * sbb + t * sbt + n * sbn]) : 0.f;
      cs[e] = in ? to_f32(Cm[b * scb + t * sct + n * scn]) : 0.f;
    }
    float h[kStates];
    const float* sp = states + ((b * n_ckpt + ck) * D + d) * N + n0;
#pragma unroll
    for (int s = 0; s < kStates; ++s) h[s] = on[s] ? sp[s] : 0.f;
    __syncthreads();

    // the chunk's states again, from its checkpoint: keep each sub-chunk's first
    const int n_sub = (tc + kSub - 1) / kSub;
    for (int sub = 0; sub < n_sub; ++sub) {
      starts[sub * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
      if (sub + 1 == n_sub) break;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int tt = sub * kSub + j;
        const float dv = ds[tt * kChannels + c];
        const float dxv = dv * xs[tt * kChannels + c];
        const float4 bv = *reinterpret_cast<const float4*>(&bs[tt * kMaxState + n0]);
        h[0] = exp2f(dv * a2[0]) * h[0] + dxv * bv.x;
        h[1] = exp2f(dv * a2[1]) * h[1] + dxv * bv.y;
        h[2] = exp2f(dv * a2[2]) * h[2] + dxv * bv.z;
        h[3] = exp2f(dv * a2[3]) * h[3] + dxv * bv.w;
      }
    }

    for (int sub = n_sub - 1; sub >= 0; --sub) {
      // the sub-chunk's decays and states, in registers
      float aa[kSub][kStates], hh[kSub][kStates];
      const float4 h0v = starts[sub * kThreads + tid];
      const float hs[kStates] = {h0v.x, h0v.y, h0v.z, h0v.w};
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int tt = sub * kSub + j;
        const float dv = ds[tt * kChannels + c];
        const float dxv = dv * xs[tt * kChannels + c];
        const float4 bv = *reinterpret_cast<const float4*>(&bs[tt * kMaxState + n0]);
        const float bb[kStates] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int s = 0; s < kStates; ++s) {
          aa[j][s] = exp2f(dv * a2[s]);
          hh[j][s] = aa[j][s] * (j ? hh[j - 1][s] : hs[s]) + dxv * bb[s];
        }
      }
      // the reverse recurrence through them
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        const int tt = sub * kSub + j;
        const float dv = ds[tt * kChannels + c];
        const float xv = xs[tt * kChannels + c];
        const float gv = gs[tt * kChannels + c];
        const float4 bv = *reinterpret_cast<const float4*>(&bs[tt * kMaxState + n0]);
        const float4 cv = *reinterpret_cast<const float4*>(&cs[tt * kMaxState + n0]);
        const float bb[kStates] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[kStates] = {cv.x, cv.y, cv.z, cv.w};
        float gb = 0.f, ga = 0.f, pb[kStates], pc[kStates];
        const float dxv = dv * xv;
#pragma unroll
        for (int s = 0; s < kStates; ++s) {
          const float g = gv * cc[s] + G[s];
          const float w = g * aa[j][s] * (j ? hh[j - 1][s] : hs[s]);
          gb += g * bb[s];
          ga += w * an[s];
          dA[s] += w * dv;
          pb[s] = g * dxv;
          pc[s] = gv * hh[j][s];
          G[s] = aa[j][s] * g;
        }
        parts[j * kThreads + tid] = gb;
        parts[(kSub + j) * kThreads + tid] = ga;
        // dB_t and dC_t: the warp's channels (the same lane of each) added
#pragma unroll
        for (int off = L; off < 32; off <<= 1) {
#pragma unroll
          for (int s = 0; s < kStates; ++s) {
            pb[s] += __shfl_xor_sync(0xffffffffu, pb[s], off);
            pc[s] += __shfl_xor_sync(0xffffffffu, pc[s], off);
          }
        }
        if (tid % 32 < L) {
#pragma unroll
          for (int s = 0; s < kStates; ++s) {
            wsum[((j * kMaxState) + n0 + s) * kWarps + warp] = pb[s];
            wsum[(((kSub + j) * kMaxState) + n0 + s) * kWarps + warp] = pc[s];
          }
        }
      }
      __syncthreads();
      // dx_t and ddt_t: the L lanes' parts in lane order
      T* dxb = dx + b * T_len * D + d0 + sc;
      T* ddb = ddt + b * T_len * D + d0 + sc;
      for (int j = st; j < kSub; j += L) {
        const int tt = sub * kSub + j;
        if (!s_live || tt >= tc) continue;
        float gb = parts[j * kThreads + sc * L];
        float ga = parts[(kSub + j) * kThreads + sc * L];
#pragma unroll
        for (int q = 1; q < L; ++q) {
          gb += parts[j * kThreads + sc * L + q];
          ga += parts[(kSub + j) * kThreads + sc * L + q];
        }
        const float xv = xs[tt * kChannels + sc];
        const float dv = ds[tt * kChannels + sc];
        const float gv = gs[tt * kChannels + sc];
        const long long at = static_cast<long long>(t0 + tt) * D;
        dxb[at] = from_f32<T>(skip * gv + dv * gb);
        ddb[at] = from_f32<T>(xv * gb + ga);
        dD += gv * xv;
      }
      // this CTA's dB_t and dC_t: the warps' sums in warp order
      for (int e = tid; e < 2 * kSub * kMaxState; e += kThreads) {
        const int which = e / (kSub * kMaxState);
        const int j = (e / kMaxState) % kSub;
        const int n = e % kMaxState;
        const int tt = sub * kSub + j;
        if (tt >= tc || n >= N) continue;
        float acc = wsum[e * kWarps];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += wsum[e * kWarps + w];
        part_bc[(((static_cast<long long>(which) * n_blk + blk) * n_seq + b) * T_len + t0 + tt) *
                    N + n] = acc;
      }
      __syncthreads();  // the parts are read before the next sub-chunk writes them
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      if (!on[s]) continue;
      part_a[(b * D + d) * N + n0 + s] = dA[s];
      if (dh0 != nullptr) dh0[(b * D + d) * N + n0 + s] = G[s];
    }
  }
  // dD: the L finishing threads of a channel in order
  parts[st * kChannels + sc] = dD;
  __syncthreads();
  if (st == 0 && s_live) {
    float acc = parts[sc];
#pragma unroll
    for (int q = 1; q < L; ++q) acc += parts[q * kChannels + sc];
    part_d[b * D + d0 + sc] = acc;
  }
}

// the second launch: every partial summed in a fixed order into dB and dC (B's
// dtype, (n_seq, T, N)), dA (f32, (D, N)) and dD (D's dtype, (D,))
template <typename T>
__global__ void __launch_bounds__(256)
    ssm_scan_bwd_sum_kernel(const float* __restrict__ part_bc, const float* __restrict__ part_a,
                            const float* __restrict__ part_d, T* __restrict__ dB,
                            T* __restrict__ dC, float* __restrict__ dA, T* __restrict__ dD,
                            int n_seq, int T_len, int D, int N, int n_blk) {
  const long long btn = static_cast<long long>(n_seq) * T_len * N;
  const long long dn = static_cast<long long>(D) * N;
  const long long total = 2 * btn + dn + D;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    if (i < 2 * btn) {
      const long long which = i / btn, r = i % btn;
      const float* p = part_bc + which * n_blk * btn + r;
      float acc = p[0];
      for (int k = 1; k < n_blk; ++k) acc += p[k * btn];
      (which ? dC : dB)[r] = from_f32<T>(acc);
    } else if (i < 2 * btn + dn) {
      const long long r = i - 2 * btn;
      float acc = part_a[r];
      for (int k = 1; k < n_seq; ++k) acc += part_a[k * dn + r];
      dA[r] = acc;
    } else {
      const long long r = i - 2 * btn - dn;
      float acc = part_d[r];
      for (int k = 1; k < n_seq; ++k) acc += part_d[k * D + r];
      dD[r] = from_f32<T>(acc);
    }
  }
}

template <typename T, int L>
int launch_l(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             const void* Dskip, const void* states, const void* dy, const void* dhT, void* dx,
             void* ddt, void* part_bc, void* part_a, void* part_d, void* dB, void* dC,
             void* dA, void* dD, void* dh0, int B, int T_len, int D, int N, long long sxb,
             long long sxt, long long sxd, long long sdb, long long sdt, long long sdd,
             long long sbb, long long sbt, long long sbn, long long scb, long long sct,
             long long scn, cudaStream_t stream) {
  if (N > L * kStates) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0 || T_len == 0) return 0;
  auto kernel = ssm_scan_bwd_kernel<T, L>;
  static size_t granted[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, Smem<L>::kBytes, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blk = (D + kChannels - 1) / kChannels;
  kernel<<<dim3(n_blk, B), kChannels * L, Smem<L>::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const T*>(Dskip),
      static_cast<const float*>(states), static_cast<const T*>(dy),
      static_cast<const float*>(dhT), static_cast<T*>(dx), static_cast<T*>(ddt),
      static_cast<float*>(part_bc), static_cast<float*>(part_a), static_cast<float*>(part_d),
      static_cast<float*>(dh0), B, T_len, D, N, sxb, sxt, sxd, sdb, sdt, sdd, sbb, sbt, sbn,
      scb, sct, scn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 2ll * B * T_len * N + static_cast<long long>(D) * N + D;
  const long long blocks = (total + 255) / 256;
  ssm_scan_bwd_sum_kernel<T><<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), 256, 0,
                               stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<const float*>(part_d), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), static_cast<T*>(dD), B, T_len, D, N, n_blk);
  return static_cast<int>(cudaGetLastError());
}

// lanes: lanes a channel (1, 2 or 4), from _build.ssm_scan_lanes, as the forward
template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* Dskip, const void* states, const void* dy, const void* dhT, void* dx,
           void* ddt, void* part_bc, void* part_a, void* part_d, void* dB, void* dC, void* dA,
           void* dD, void* dh0, int B, int T_len, int D, int N, int lanes, long long sxb,
           long long sxt, long long sxd, long long sdb, long long sdt, long long sdd,
           long long sbb, long long sbt, long long sbn, long long scb, long long sct,
           long long scn, void* stream) {
  if (N < 1 || N > kMaxState || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SSM_BWD_LANES(LANES)                                                          \
  case LANES:                                                                               \
    return launch_l<T, LANES>(x, dt, A, Bm, Cm, Dskip, states, dy, dhT, dx, ddt, part_bc,  \
                              part_a, part_d, dB, dC, dA, dD, dh0, B, T_len, D, N, sxb, sxt, \
                              sxd, sdb, sdt, sdd, sbb, sbt, sbn, scb, sct, scn, s);
  switch (lanes) {
    REPRO_SSM_BWD_LANES(1)
    REPRO_SSM_BWD_LANES(2)
    REPRO_SSM_BWD_LANES(4)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SSM_BWD_LANES
}

}  // namespace
}  // namespace repro_torch

#define REPRO_SSM_SCAN_BWD_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* x, const void* dt, const void* A, const void* Bm,         \
                      const void* Cm, const void* Dskip, const void* states, const void* dy, \
                      const void* dhT, void* dx, void* ddt, void* part_bc, void* part_a,     \
                      void* part_d, void* dB, void* dC, void* dA, void* dD, void* dh0,       \
                      int B, int T_len, int D, int N, int lanes, long long sxb,             \
                      long long sxt, long long sxd, long long sdb, long long sdt,            \
                      long long sdd, long long sbb, long long sbt, long long sbn,            \
                      long long scb, long long sct, long long scn, void* stream) {           \
    return repro_torch::launch<T>(x, dt, A, Bm, Cm, Dskip, states, dy, dhT, dx, ddt,         \
                                  part_bc, part_a, part_d, dB, dC, dA, dD, dh0, B, T_len, D, \
                                  N, lanes, sxb, sxt, sxd, sdb, sdt, sdd, sbb, sbt, sbn, scb, \
                                  sct, scn, stream);                                          \
  }

REPRO_SSM_SCAN_BWD_ENTRY(ssm_scan_bwd_f32, float)
REPRO_SSM_SCAN_BWD_ENTRY(ssm_scan_bwd_bf16, __nv_bfloat16)
