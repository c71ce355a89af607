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
// 1.98 GHz, against ~61 us for the bytes (x, dt, dy in and dx, ddt out, bf16;
// B, C, dB, dC; the checkpoints). This kernel takes 1.875 exps a (t, d, n)
// (below) and some 30 other instructions, so issue and the latency of a
// warp's chain of shuffles bound it, not the exps.
//
// Design. The forward kernel's layout: a CTA holds kChannels (64) channels of
// one sequence for all T, a channel's N states split over L lanes of 4 (L
// from _build.ssm_scan_lanes: 4 at N = 16), B and C read through their
// strides (column slices of x_proj's output). Each form holds at most 128
// registers a thread (__launch_bounds__(threads, 2)) and at most 112 KB of
// shared memory a CTA, so two CTAs (16 warps) share a SM and Jamba's 256
// CTAs run in one wave (ssm_scan_bwd_form_* reports it).
// - Reverse access to h_{t-1} without storing every state (1.07 GB a layer at
//   that shape): the forward writes the state before every kCkpt-step chunk
//   (32: ssm_scan.cu's optional output). The backward walks the chunks in
//   reverse. For each it stages the chunk's x, dt, dy, B and C in shared
//   memory (f32), recomputes the chunk's states from its checkpoint keeping
//   the state before every kSub-step sub-chunk (4 steps; in registers until
//   the chunk's end, then shared memory, a float4 a thread), then walks the
//   sub-chunks in reverse: each recomputes its 4 states and decays into
//   registers and runs the reverse recurrence through them, fully unrolled.
//   The exps are one ex2.approx.ftz each (exp2f's guard for subnormal
//   results is three more instructions), so a recomputed state has the
//   forward's bits wherever a decay is a normal number.
// - Sums over n (dx, ddt): the L lanes of a channel are neighbours in a warp;
//   two xor shuffles and one down leave lane 0 with sum g B and sum g A a h
//   (in units of log2: A is kept as A log2 e for the exps, and the sum is
//   scaled by ln 2 once). Lane 0 writes dx_t and ddt_t to two more tiles, and
//   the next chunk's finishing pass stores them with neighbouring threads on
//   neighbouring channels.
// - Sums over d (dB, dC): each step's 8 values a thread (g dt x and dy h of
//   its 4 states) go through a reduce-scatter over the warp's 8 channels:
//   three xor shuffles (of 4, 2 and 1 values; lane bits 4, 3, 2) leave each
//   lane one (dB or dC, n) sum, kept for the whole chunk. After the chunk one
//   pass adds the 8 warps in warp order and writes the CTA's sums as
//   partials (2, ceil(D / 64), B, T, N) f32. dA (a lane's states over all T
//   of its sequence) and dD (a channel's) stay in registers and are written
//   as partials (B, D, N) and (B, D). A second launch sums every partial in
//   a fixed order (a CTA holds 32 outputs, each of its 8 warps adds every
//   8th partial, then the warps' sums in warp order): no atomics, so a rerun
//   gives the same bits.
// - What keeps a warp's steps apart: the stores of a reverse step to shared
//   memory wait for the sub-chunk's end, and the chunk pass keeps its starts
//   in registers until its end (the compiler cannot tell those stores from
//   the tiles, and would keep every later load behind them); a chunk's
//   finishing pass runs while the next chunk's loads are in flight; two
//   barriers a chunk.
// - Two forms of staging: where x, dt, dy, dx and ddt rows are contiguous
//   and on 16 bytes (the trainer's layout), 16-byte vectors; else element by
//   element through any strides. One form is one instantiation (V), so
//   neither holds the other's registers.
// - Ragged T and D: steps past T and channels past D are staged as zeros:
//   a step with dt = 0 has a_t = 1 and carries g through unchanged, and
//   contributes nothing; no such step or channel is written. Any T >= 1, any
//   D, 1 <= N <= 16, h0 and dh_T given or not: no shape needs the plain
//   version; the launcher refuses an L it has no form for.
// What it leaves: about 6.6x the exp bound at Jamba's training shape on the
// H100 (PERF.md, row 6b). A lone CTA a SM (half that width) takes ~0.27 ms
// where two a SM take ~0.43 for the whole: a warp's chains of shuffles (the
// n-sums and the reduce-scatter, three rounds each a step) and recomputed
// exps set the pace, and 128 registers leave no room for more warps. The
// chunk pass recomputes 28 of every 32 steps a second time, the price of
// 4-step sub-chunks (8 steps of decays and states in registers spilled).
// The sum launch reads every CTA's dB/dC partial once (33.5 MB there).
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
constexpr int kSub = 4;                        // steps a sub-chunk, whose states stay in registers
constexpr int kSubs = kCkpt / kSub;
static_assert(kChannels % 32 == 0, "ssm_scan_bwd: a CTA holds whole warps of channels");
static_assert(kCkpt > 0 && kCkpt % kSub == 0, "ssm_scan_bwd: a chunk is whole sub-chunks");
static_assert(kCkpt * kChannels % 256 == 0 && kCkpt * kMaxState % 256 == 0,
              "ssm_scan_bwd: a chunk's tiles are staged in whole rounds of the CTA");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x, a subnormal result flushed to zero: one MUFU.EX2
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of T (8 bf16 or 4 f32 values) as f32, and back (rounded as from_f32)
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* f) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the dynamic shared memory of the L-lane form, in floats
template <int L>
struct Smem {
  static constexpr int kThreads = kChannels * L;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kLaneStates = kStates * L;          // states a channel's lanes cover
  static constexpr int kOut = 2 * kLaneStates;             // (dB or dC, n) sums a warp holds
  static constexpr int kTile = kCkpt * kChannels;          // x, dt and dy: [kCkpt][kChannels]
  static constexpr int kBC = kCkpt * kMaxState;            // B and C: [kCkpt][kMaxState]
  static constexpr int kStarts = kSubs * kThreads * kStates;  // [kSubs][kThreads] float4
  // the warps' dB/dC sums of a chunk: [kCkpt][kWarps][kOut + 1]
  static constexpr int kWsumRow = kOut + 1;
  static constexpr int kWsum = kCkpt * kWarps * kWsumRow;
  // x, dt, dy, dx and ddt: [kCkpt][kChannels] each
  static constexpr size_t kBytes = sizeof(float) * (5 * kTile + 2 * kBC + kStarts + kWsum);
};
// two CTAs of the 4-lane form fit a SM's 228 KB (each also reserves 1 KB)
static_assert(2 * (Smem<4>::kBytes + 1024) <= 228 * 1024,
              "ssm_scan_bwd: two CTAs of the 4-lane form must share a SM");

// V: the vector form, for x, dt, dy, dx and ddt rows contiguous and on 16
// bytes (the trainer's layout), staged and stored 16 bytes at a time; the
// other form reads and writes them an element at a time through any strides
template <typename T, int L, bool V>
__global__ void __launch_bounds__(kChannels * L, 2)
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
  constexpr int kLS = S::kLaneStates;
  constexpr int kOut = S::kOut;
  constexpr int kStageX = kCkpt * kChannels / kThreads;   // x, dt and dy values a thread stages
  constexpr int kStageBC = kCkpt * kMaxState / kThreads;  // B and C values
  // the vector form: 16-byte vectors of x (dt, dy) a thread stages, of kVec
  // values
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = kChannels / kVec;
  constexpr int kStageV = kCkpt * kRowVecs / kThreads;
  static_assert(kCkpt * kRowVecs % kThreads == 0, "ssm_scan_bwd: whole vector rounds");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ds = xs + S::kTile;
  float* gs = ds + S::kTile;  // dy
  float* dxs = gs + S::kTile;
  float* dds = dxs + S::kTile;  // ddt
  float* bs = dds + S::kTile;
  float* cs = bs + S::kBC;
  float4* starts = reinterpret_cast<float4*>(cs + S::kBC);
  float* wsum = reinterpret_cast<float*>(starts + kSubs * kThreads);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const long long b = blockIdx.y;
  const int blk = blockIdx.x;
  const int n_blk = gridDim.x;
  const int d0 = blk * kChannels;
  // lane l of channel c holds states n0 .. n0 + 3; lane 0 also finishes the
  // channel's dx, ddt and dD
  const int c = tid / L, l = tid % L;
  const int d = d0 + c;
  const bool live = d < D;
  const int n0 = l * kStates;
  float a2[kStates], G[kStates], dA[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    const bool on = live && n0 + s < N;
    a2[s] = on ? A[static_cast<long long>(d) * N + n0 + s] * kLog2e : 0.f;
    // G: what reaches h_t from h_{t+1}; at t = T - 1, dh_T
    G[s] = (on && dhT != nullptr) ? dhT[(b * D + d) * N + n0 + s] : 0.f;
    dA[s] = 0.f;
  }
  const bool finisher = live && l == 0;
  const float skip = finisher ? to_f32(Dskip[d]) : 0.f;
  float dD = 0.f;
  // the dB/dC sum a lane holds after the reduce-scatter over the warp's
  // channels (lane bits 2, 3 and 4 pick dB or dC and the state of its 4), and
  // the lanes that write it (channel bits below bit 2, for L < 4, added in)
  const int o = ((lane >> 4) & 1) * kLS + n0 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  const bool writer = (lane & (3 & ~(L - 1))) == 0;

  const int n_ckpt = (T_len + kCkpt - 1) / kCkpt;
  for (int ck = n_ckpt - 1; ck >= -1; --ck) {
    // the chunk walked last has read its tiles and written its warps' sums
    __syncthreads();
    const int t0 = ck * kCkpt;
    const int tc = min(kCkpt, T_len - t0);
    // chunk ck's loads first, every thread the same count, fully unrolled, so
    // that all are in flight while the last chunk's sums are finished
    float px[V ? 1 : kStageX], pd[V ? 1 : kStageX], pg[V ? 1 : kStageX];
    uint4 vx[V ? kStageV : 1], vd[V ? kStageV : 1], vg[V ? kStageV : 1];
    float pb[kStageBC], pc[kStageBC];
    if constexpr (V) {
      if (ck >= 0) {
#pragma unroll
      for (int k = 0; k < kStageV; ++k) {
        const int e = tid + k * kThreads;
        const int tt = e / kRowVecs, cc = e % kRowVecs * kVec;
        const long long t = t0 + tt;
        const bool in = tt < tc && d0 + cc < D;
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        vx[k] = in ? *reinterpret_cast<const uint4*>(x + b * sxb + t * sxt + d0 + cc) : z;
        vd[k] = in ? *reinterpret_cast<const uint4*>(dt + b * sdb + t * sdt + d0 + cc) : z;
        vg[k] = in ? *reinterpret_cast<const uint4*>(dy + (b * T_len + t) * D + d0 + cc) : z;
      }
      }
    } else if (ck >= 0) {
#pragma unroll
      for (int k = 0; k < kStageX; ++k) {
        const int e = tid + k * kThreads;
        const int tt = e / kChannels, cc = e % kChannels;
        const long long t = t0 + tt;
        const bool in = tt < tc && d0 + cc < D;
        const long long dd = d0 + cc;
        px[k] = in ? to_f32(x[b * sxb + t * sxt + dd * sxd]) : 0.f;
        pd[k] = in ? to_f32(dt[b * sdb + t * sdt + dd * sdd]) : 0.f;
        pg[k] = in ? to_f32(dy[(b * T_len + t) * D + dd]) : 0.f;
      }
    }
    if (ck >= 0) {
#pragma unroll
      for (int k = 0; k < kStageBC; ++k) {
        const int e = tid + k * kThreads;
        const int tt = e / kMaxState, n = e % kMaxState;
        const long long t = t0 + tt;
        const bool in = tt < tc && n < N;
        pb[k] = in ? to_f32(Bm[b * sbb + t * sbt + n * sbn]) : 0.f;
        pc[k] = in ? to_f32(Cm[b * scb + t * sct + n * scn]) : 0.f;
      }
    }
    // the last chunk's dx_t and ddt_t (neighbouring threads on neighbouring
    // channels), and its dB_t and dC_t: its warps' sums in warp order
    if (ck + 1 < n_ckpt) {
      const int t1 = t0 + kCkpt;
      const int tc1 = min(kCkpt, T_len - t1);
      if constexpr (V) {
#pragma unroll
        for (int k = 0; k < kStageV; ++k) {
          const int e = tid + k * kThreads;
          const int tt = e / kRowVecs, cc = e % kRowVecs * kVec;
          if (tt < tc1 && d0 + cc < D) {
            const long long at = (b * T_len + t1 + tt) * D + d0 + cc;
            *reinterpret_cast<uint4*>(dx + at) = pack16<T>(&dxs[tt * kChannels + cc]);
            *reinterpret_cast<uint4*>(ddt + at) = pack16<T>(&dds[tt * kChannels + cc]);
          }
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < kStageX; ++k) {
          const int e = tid + k * kThreads;
          const int tt = e / kChannels, cc = e % kChannels;
          if (tt < tc1 && d0 + cc < D) {
            const long long at = (b * T_len + t1 + tt) * D + d0 + cc;
            dx[at] = from_f32<T>(dxs[e]);
            ddt[at] = from_f32<T>(dds[e]);
          }
        }
      }
      for (int e = tid; e < kCkpt * kOut; e += kThreads) {
        const int tt = e / kOut, oo = e % kOut;
        const int which = oo / kLS, n = oo % kLS;
        if (tt >= tc1 || n >= N) continue;
        const float* ws = wsum + tt * kWarps * S::kWsumRow + oo;
        float acc = ws[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += ws[w * S::kWsumRow];
        part_bc[(((static_cast<long long>(which) * n_blk + blk) * n_seq + b) * T_len + t1 + tt) *
                    N + n] = acc;
      }
    }
    if (ck < 0) break;
    if constexpr (V) {
#pragma unroll
      for (int k = 0; k < kStageV; ++k) {
        const int e = tid + k * kThreads;
        const int at = e / kRowVecs * kChannels + e % kRowVecs * kVec;
        float f[kVec];
        unpack16<T>(vx[k], f);
#pragma unroll
        for (int i = 0; i < kVec; i += 4)
          *reinterpret_cast<float4*>(&xs[at + i]) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
        unpack16<T>(vd[k], f);
#pragma unroll
        for (int i = 0; i < kVec; i += 4)
          *reinterpret_cast<float4*>(&ds[at + i]) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
        unpack16<T>(vg[k], f);
#pragma unroll
        for (int i = 0; i < kVec; i += 4)
          *reinterpret_cast<float4*>(&gs[at + i]) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kStageX; ++k) {
        xs[tid + k * kThreads] = px[k];
        ds[tid + k * kThreads] = pd[k];
        gs[tid + k * kThreads] = pg[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBC; ++k) {
      bs[tid + k * kThreads] = pb[k];
      cs[tid + k * kThreads] = pc[k];
    }
    float h[kStates];
    const float* sp = states + ((b * n_ckpt + ck) * D + d) * N + n0;
#pragma unroll
    for (int s = 0; s < kStates; ++s) h[s] = (live && n0 + s < N) ? sp[s] : 0.f;
    __syncthreads();

    // the chunk's states again, from its checkpoint: keep each sub-chunk's
    // first. A whole chunk runs its first kSubs - 1 sub-chunks unrolled, the
    // starts in registers until the end (a store to shared memory between
    // steps would keep the next steps' loads behind it)
    auto step = [&](int tt) {
      const float dv = ds[tt * kChannels + c];
      const float dxv = dv * xs[tt * kChannels + c];
      const float4 bv = *reinterpret_cast<const float4*>(&bs[tt * kMaxState + n0]);
      h[0] = exp2_ftz(dv * a2[0]) * h[0] + dxv * bv.x;
      h[1] = exp2_ftz(dv * a2[1]) * h[1] + dxv * bv.y;
      h[2] = exp2_ftz(dv * a2[2]) * h[2] + dxv * bv.z;
      h[3] = exp2_ftz(dv * a2[3]) * h[3] + dxv * bv.w;
    };
    const int n_sub = (tc + kSub - 1) / kSub;
    if (n_sub == kSubs) {
      float4 hk[kSubs];
      hk[0] = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
      for (int tt = 0; tt < (kSubs - 1) * kSub; ++tt) {
        step(tt);
        if ((tt + 1) % kSub == 0) hk[(tt + 1) / kSub] = make_float4(h[0], h[1], h[2], h[3]);
      }
#pragma unroll
      for (int sub = 0; sub < kSubs; ++sub) starts[sub * kThreads + tid] = hk[sub];
    } else {
      for (int sub = 0; sub < n_sub; ++sub) {
        starts[sub * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
        if (sub + 1 == n_sub) break;
#pragma unroll
        for (int j = 0; j < kSub; ++j) step(sub * kSub + j);
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
          aa[j][s] = exp2_ftz(dv * a2[s]);
          hh[j][s] = aa[j][s] * (j ? hh[j ? j - 1 : 0][s] : hs[s]) + dxv * bb[s];
        }
      }
      // the reverse recurrence through them. Its stores to shared memory wait
      // for the sub-chunk's end: the compiler cannot tell them from the
      // tiles, and would keep each step's loads behind the last step's stores
      float ox[kSub], od[kSub], of[kSub];
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
        float gb = 0.f, ga = 0.f, vb[kStates], vc[kStates];
        const float dxv = dv * xv;
#pragma unroll
        for (int s = 0; s < kStates; ++s) {
          const float g = gv * cc[s] + G[s];
          const float Gn = aa[j][s] * g;
          const float w = Gn * (j ? hh[j ? j - 1 : 0][s] : hs[s]);
          gb += g * bb[s];
          ga += w * a2[s];
          dA[s] += w * dv;
          vb[s] = g * dxv;
          vc[s] = gv * hh[j][s];
          G[s] = Gn;
        }
        // dx_t and ddt_t: lane 0 of the channel gathers sum g B and sum g A
        // a h (kept in units of log2: scaled by ln 2 here) from its lanes
        float sb = gb, sa = ga;
        if constexpr (L > 1) {
          const bool odd = l & 1;
          float keep = odd ? ga : gb;
          keep += __shfl_xor_sync(0xffffffffu, odd ? gb : ga, 1);
          if constexpr (L == 4) keep += __shfl_xor_sync(0xffffffffu, keep, 2);
          sb = keep;
          sa = __shfl_down_sync(0xffffffffu, keep, 1);
        }
        ox[j] = skip * gv + dv * sb;
        od[j] = xv * sb + sa * kLn2;
        dD += gv * xv;  // zeros at a step past T
        // dB_t and dC_t: a reduce-scatter over the warp's channels (lane bits
        // 4, 3, 2 halve what a lane holds), then the channel bits below
        float r[4], q[2];
        const bool p4 = lane & 16, p3 = lane & 8, p2 = lane & 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = (p4 ? vc[i] : vb[i]) + __shfl_xor_sync(0xffffffffu, p4 ? vb[i] : vc[i], 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          q[i] = (p3 ? r[i + 2] : r[i]) + __shfl_xor_sync(0xffffffffu, p3 ? r[i] : r[i + 2], 8);
        float f = (p2 ? q[1] : q[0]) + __shfl_xor_sync(0xffffffffu, p2 ? q[0] : q[1], 4);
        if constexpr (L < 4) f += __shfl_xor_sync(0xffffffffu, f, 2);
        if constexpr (L < 2) f += __shfl_xor_sync(0xffffffffu, f, 1);
        of[j] = f;
      }
      // dx_t and ddt_t (lane 0 of a channel: global memory by the next
      // chunk's finishing pass) and the warp's dB_t and dC_t
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int tt = sub * kSub + j;
        if (l == 0) {
          dxs[tt * kChannels + c] = ox[j];
          dds[tt * kChannels + c] = od[j];
        }
        if (writer) wsum[(tt * kWarps + warp) * S::kWsumRow + o] = of[j];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      if (n0 + s >= N) continue;
      part_a[(b * D + d) * N + n0 + s] = dA[s];
      if (dh0 != nullptr) dh0[(b * D + d) * N + n0 + s] = G[s];
    }
  }
  if (finisher) part_d[b * D + d] = dD;
}

// the second launch: every partial summed in a fixed order into dB and dC (B's
// dtype, (n_seq, T, N)), dA (f32, (D, N)) and dD (D's dtype, (D,)). The first
// n_bc_ctas CTAs hold kSumCols outputs of dB or dC each: warp w adds the
// partials of CTA blocks w, w + kSumWarps, ... (a warp reads 128 contiguous
// bytes a block), then the warps' sums are added in warp order. The rest
// take dA and dD, one output a thread, summed over the sequences in order.
constexpr int kSumCols = 32;
constexpr int kSumWarps = 8;
constexpr int kSumThreads = kSumCols * kSumWarps;

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    ssm_scan_bwd_sum_kernel(const float* __restrict__ part_bc, const float* __restrict__ part_a,
                            const float* __restrict__ part_d, T* __restrict__ dB,
                            T* __restrict__ dC, float* __restrict__ dA, T* __restrict__ dD,
                            int n_seq, int T_len, int D, int N, int n_blk, int n_bc_ctas) {
  __shared__ float sums[kSumWarps][kSumCols];
  const long long btn = static_cast<long long>(n_seq) * T_len * N;
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < n_bc_ctas) {
    const int col = tid % kSumCols, w = tid / kSumCols;
    const long long i = static_cast<long long>(blockIdx.x) * kSumCols + col;
    const bool in = i < 2 * btn;
    const long long which = in ? i / btn : 0, r = in ? i % btn : 0;
    float acc = 0.f;
    if (in) {
      const float* p = part_bc + which * n_blk * btn + r;
#pragma unroll 8
      for (int k = w; k < n_blk; k += kSumWarps) acc += p[k * btn];
    }
    sums[w][col] = acc;
    __syncthreads();
    if (w == 0 && in) {
      float s = sums[0][col];
#pragma unroll
      for (int v = 1; v < kSumWarps; ++v) s += sums[v][col];
      (which ? dC : dB)[r] = from_f32<T>(s);
    }
    return;
  }
  const long long dn = static_cast<long long>(D) * N;
  const long long i = static_cast<long long>(blockIdx.x - n_bc_ctas) * kSumThreads + tid;
  if (i < dn) {
    float acc = part_a[i];
    for (int k = 1; k < n_seq; ++k) acc += part_a[k * dn + i];
    dA[i] = acc;
  } else if (i < dn + D) {
    const long long r = i - dn;
    float acc = part_d[r];
    for (int k = 1; k < n_seq; ++k) acc += part_d[k * D + r];
    dD[r] = from_f32<T>(acc);
  }
}

// Raise the form's dynamic shared-memory cap to what it takes and ask for the
// largest shared-memory carveout, once per device: two CTAs a SM need
// 2 x Smem<4>::kBytes of the SM's 228 KB.
template <typename T, int L, bool V>
cudaError_t prepare_form() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  auto kernel = ssm_scan_bwd_kernel<T, L, V>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Smem<L>::kBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
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
  // the vector form where x, dt, dy, dx and ddt rows are whole 16-byte vectors
  const long long kv = 16 / sizeof(T);
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = sxd == 1 && sdd == 1 && D % kv == 0 && sxt % kv == 0 && sdt % kv == 0 &&
                   (B == 1 || (sxb % kv == 0 && sdb % kv == 0)) && a16(x) && a16(dt) &&
                   a16(dy) && a16(dx) && a16(ddt);
  auto kernel = vec ? ssm_scan_bwd_kernel<T, L, true> : ssm_scan_bwd_kernel<T, L, false>;
  cudaError_t err = vec ? prepare_form<T, L, true>() : prepare_form<T, L, false>();
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
  const long long n_bc = (2ll * B * T_len * N + kSumCols - 1) / kSumCols;
  const long long n_ad = (static_cast<long long>(D) * N + D + kSumThreads - 1) / kSumThreads;
  if (n_bc + n_ad > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  ssm_scan_bwd_sum_kernel<T><<<static_cast<unsigned>(n_bc + n_ad), kSumThreads, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<const float*>(part_d), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), static_cast<T*>(dD), B, T_len, D, N, n_blk,
      static_cast<int>(n_bc));
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

// What the form (L lanes, vector or not) takes on the current device: out[0]
// CTAs a SM (the occupancy of the kernel as ptxas built it), out[1] dynamic
// shared bytes a CTA, out[2] registers a thread, out[3] local (spilled) bytes
// a thread.
template <typename T, int L, bool V>
int form_l(int* out) {
  cudaError_t err = prepare_form<T, L, V>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, ssm_scan_bwd_kernel<T, L, V>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = static_cast<int>(Smem<L>::kBytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, ssm_scan_bwd_kernel<T, L, V>, kChannels * L, Smem<L>::kBytes));
}

template <typename T>
int form(int lanes, int vec, void* out) {
  int* o = static_cast<int*>(out);
  switch (lanes * 2 + (vec != 0)) {
    case 2: return form_l<T, 1, false>(o);
    case 3: return form_l<T, 1, true>(o);
    case 4: return form_l<T, 2, false>(o);
    case 5: return form_l<T, 2, true>(o);
    case 8: return form_l<T, 4, false>(o);
    case 9: return form_l<T, 4, true>(o);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// out: four ints, what the form of `lanes` lanes (vector or not) takes (form_l
// above)
extern "C" int ssm_scan_bwd_form_f32(int lanes, int vec, void* out) {
  return repro_torch::form<float>(lanes, vec, out);
}

extern "C" int ssm_scan_bwd_form_bf16(int lanes, int vec, void* out) {
  return repro_torch::form<__nv_bfloat16>(lanes, vec, out);
}
