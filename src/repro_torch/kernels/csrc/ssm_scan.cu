// Mamba selective scan with a float32 state carried over T:
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t + D x_t,
// returning y (x's dtype) and the final state h_T (f32); for training, also
// the state at the start of every kCkpt-step chunk (f32 (B, ceil(T / kCkpt),
// D, N)), from which the backward (ssm_scan_bwd.cu) recomputes the chunk's
// states instead of storing all B * T * D * N of them.
//
// Replaces: repro/kernels/ssm_scan.py::ssm_scan (Pallas, _ssm_kernel). The
// TPU kernel sweeps T as a sequential grid axis in chunks and keeps the
// (d_block, N) state in VMEM scratch between grid steps. Hopper's blocks run
// in no order, so here one block owns kChannels channels of one sequence for
// the whole sweep: a loop over T inside the block takes the place of that
// grid axis, and the state stays in registers.
//
// Bound on the H100: operations. Every (t, d, n) needs one exp on the
// special-function units (16 a clock per SM), which outweighs the bytes
// (x, dt and y once, B and C once a step, A and the states once): at the
// main path's prefill (B = 1, T = 512, D = 16384, N = 16) that is 134 M exps,
// ~32 us at 1.98 GHz, against 52.5 MB, ~15.7 us at 3.35 TB/s. A decode step
// (T = 1) is bound by the bytes of the states it reads and writes.
//
// Design: the N states of a channel are split over L lanes of 4 states (L
// from _build.ssm_scan_lanes: the fewest that hold N; 4 at Jamba's N = 16),
// so B = 1, D = 16384 runs 2048 warps, ~15 an SM, where one thread a channel
// ran 512. Lanes map (d, n) with n fastest, so A and h0 are read and h_T
// written with coalesced 16-byte accesses. Each lane walks T for its states,
// and steps depend on one another only through h (one FMA): a whole chunk of
// steps is unrolled, and each lane writes its part of y_t's sum over n to
// shared memory, with no shuffle and no branch inside a step. After the
// chunk, one pass sums the L parts in lane order, adds D x_t and stores y
// with neighbouring threads on neighbouring channels. The order of every sum
// is the same at every t, so a scan split in two halves with the state
// carried gives the whole call's bits. The exps are exp2f of dt * (A log2 e),
// A scaled once (exp2f keeps subnormals and 2-ulp accuracy). x, dt, B and C
// are staged kChunk steps at a time in shared memory, double-buffered: the
// next chunk's loads are issued into registers before the current chunk
// computes and land in the other buffer after it. (cp.async would need
// 4-byte-aligned sources; x and dt are bf16 read through any strides, a
// transposed x for one.) Inputs are read through their strides: B and C are
// column slices of the x_proj output and are never copied. Channels past D
// and states past N are zeros, any T >= 1 runs, and h0 may be absent, so no
// shape needs the plain version; the launcher refuses an L it has no form
// for.
// What it leaves: about 3x the exp bound at T = 512 on the H100 (PERF.md).
// A step costs a lane ~43 instructions for its 4 states (four shared-memory
// loads, exp2f's subnormal guard, the store of its part), and by that count
// and its time the schedulers issue about one instruction every other cycle.
// Neither the exps nor the warps a scheduler set that: copies of this body
// without exp2f, with an ftz ex2, or with twice the warps (8 lanes of 2
// states) were not much faster. Fewer instructions a state, e.g. a lane that
// keeps two channels' states against one load of B_t and C_t, is the next
// thing to try.
#include "common.cuh"

// The layout's two sizes come from _build.py (SSM_CHANNELS_PER_CTA,
// SSM_CKPT_STEPS), which compiles every source with them and sizes the
// buffers these kernels write from the same values.
#if !defined(REPRO_SSM_CHANNELS) || !defined(REPRO_SSM_CKPT)
#error "build through repro_torch.kernels._build, which defines REPRO_SSM_CHANNELS and REPRO_SSM_CKPT"
#endif

namespace repro_torch {
namespace {

constexpr int kChannels = REPRO_SSM_CHANNELS;  // channels a block
constexpr int kStates = 4;                     // states a lane
constexpr int kMaxState = 16;                  // largest N (Jamba: 16): 4 lanes of 4
constexpr int kCkpt = REPRO_SSM_CKPT;          // steps between checkpoints
// whole warps, and a chunk's B/C tile (8 L steps of kMaxState) staged in
// whole values a thread; a checkpoint on a chunk boundary of every form
// (kChunk = 8 L, L <= 4)
static_assert(kChannels % 32 == 0 && (8 * kMaxState) % kChannels == 0,
              "ssm_scan: no form for this many channels a block");
static_assert(kCkpt > 0 && kCkpt % 32 == 0, "ssm_scan: checkpoints must fall on chunk ends");
constexpr float kLog2e = 1.4426950408889634f;

// bytes of dynamic shared memory a block of the L-lane form takes: one
// chunk's partial sums of y, a float a (step, lane)
constexpr size_t partial_bytes(int L) { return sizeof(float) * (8 * L) * (kChannels * L); }

template <typename T, int L>
__global__ void __launch_bounds__(kChannels * L)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ Dskip,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ hT, float* __restrict__ states, int T_len, int D,
                    int N, bool vec_state,
                    long long sxb, long long sxt, long long sxd, long long sdb, long long sdt,
                    long long sdd, long long sbb, long long sbt, long long sbn, long long scb,
                    long long sct, long long scn) {
  constexpr int kThreads = kChannels * L;
  constexpr int kChunk = 8 * L;                            // steps a chunk
  constexpr int kStageX = kChunk * kChannels / kThreads;   // x (and dt) values a thread stages: 8
  constexpr int kStageBC = kChunk * kMaxState / kThreads;  // B (and C) values: 2
  __shared__ float xs[2][kChunk][kChannels];
  __shared__ float ds[2][kChunk][kChannels];
  __shared__ __align__(16) float bs[2][kChunk][kMaxState];
  __shared__ __align__(16) float cs[2][kChunk][kMaxState];
  extern __shared__ __align__(16) float partial_smem[];
  float(*ps)[kThreads] = reinterpret_cast<float(*)[kThreads]>(partial_smem);

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  // the compute role: lane l of channel c holds states n0 .. n0 + 3
  const int c = tid / L, l = tid % L;
  const int d = d0 + c;
  const bool live = d < D;
  const int n0 = l * kStates;

  float a2[kStates], h[kStates];
  const long long at = static_cast<long long>(d) * N + n0;  // A[d, n0]
  const long long hs = (b * D + d) * N + n0;                 // h0/hT[b, d, n0]
  if (vec_state) {  // N == 4L and A, h0, hT 16-byte aligned: so is every lane's run
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 av = live ? *reinterpret_cast<const float4*>(A + at) : z;
    const float4 hv = (live && h0 != nullptr) ? *reinterpret_cast<const float4*>(h0 + hs) : z;
    a2[0] = av.x, a2[1] = av.y, a2[2] = av.z, a2[3] = av.w;
    h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
  } else {
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      const bool on = live && n0 + s < N;
      a2[s] = on ? A[at + s] : 0.f;
      h[s] = (on && h0 != nullptr) ? h0[hs + s] : 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) a2[s] *= kLog2e;

  // the staging role: thread tid stages channel sc at steps st, st + L, ...
  // (neighbouring threads on neighbouring channels) and B/C values tid,
  // tid + kThreads, ... of the chunk's (kChunk, kMaxState) tiles; at a
  // chunk's end it also sums y for channel sc at the steps it staged
  const int sc = tid % kChannels, st = tid / kChannels;
  const bool s_live = d0 + sc < D;
  const float skip = s_live ? to_f32(Dskip[d0 + sc]) : 0.f;
  const T* xb = x + b * sxb + static_cast<long long>(d0 + sc) * sxd;
  const T* db = dt + b * sdb + static_cast<long long>(d0 + sc) * sdd;
  const T* bb = Bm + b * sbb;
  const T* cb = Cm + b * scb;
  T* yb = y + b * T_len * D + d0 + sc;
  float px[kStageX], pd[kStageX], pb[kStageBC], pc[kStageBC];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kStageX; ++j) {
      const long long t = t0 + st + j * L;
      const bool on = s_live && t < T_len;
      px[j] = on ? to_f32(xb[t * sxt]) : 0.f;
      pd[j] = on ? to_f32(db[t * sdt]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kStageBC; ++j) {
      const int e = tid + j * kThreads;
      const long long t = t0 + e / kMaxState;
      const int n = e % kMaxState;
      const bool on = t < T_len && n < N;
      pb[j] = on ? to_f32(bb[t * sbt + n * sbn]) : 0.f;
      pc[j] = on ? to_f32(cb[t * sct + n * scn]) : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kStageX; ++j) {
      xs[buf][st + j * L][sc] = px[j];
      ds[buf][st + j * L][sc] = pd[j];
    }
#pragma unroll
    for (int j = 0; j < kStageBC; ++j) {
      const int e = tid + j * kThreads;
      bs[buf][e / kMaxState][e % kMaxState] = pb[j];
      cs[buf][e / kMaxState][e % kMaxState] = pc[j];
    }
  };
  // one step's values of this lane (dt, x; its B and C), and the step: the
  // lane's states and its part of y_t's sum over n
  struct Tile {
    float dv, xv;
    float4 bv, cv;
  };
  auto tile = [&](int buf, int tt) {
    return Tile{ds[buf][tt][c], xs[buf][tt][c],
                *reinterpret_cast<const float4*>(&bs[buf][tt][n0]),
                *reinterpret_cast<const float4*>(&cs[buf][tt][n0])};
  };
  auto step = [&](const Tile& q, int tt) {
    const float dx = q.dv * q.xv;
    h[0] = exp2f(q.dv * a2[0]) * h[0] + dx * q.bv.x;
    h[1] = exp2f(q.dv * a2[1]) * h[1] + dx * q.bv.y;
    h[2] = exp2f(q.dv * a2[2]) * h[2] + dx * q.bv.z;
    h[3] = exp2f(q.dv * a2[3]) * h[3] + dx * q.bv.w;
    ps[tt][tid] = ((h[0] * q.cv.x + h[1] * q.cv.y) + h[2] * q.cv.z) + h[3] * q.cv.w;
  };

  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  const int n_ckpt = (T_len + kCkpt - 1) / kCkpt;
  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    if (states != nullptr && live && t0 % kCkpt == 0) {  // the state before step t0
      float* sp = states + ((b * n_ckpt + t0 / kCkpt) * D + d) * N + n0;
      if (vec_state) {
        *reinterpret_cast<float4*>(sp) = make_float4(h[0], h[1], h[2], h[3]);
      } else {
#pragma unroll
        for (int s = 0; s < kStates; ++s) {
          if (n0 + s < N) sp[s] = h[s];
        }
      }
    }
    const bool more = t0 + kChunk < T_len;
    if (more) fetch(t0 + kChunk);  // in flight while this chunk computes
    const int tc = min(kChunk, T_len - t0);
    if (tc == kChunk) {
      // the next step's values are read before this step's part is stored:
      // the compiler cannot tell the parts' buffer from the tiles, and would
      // keep each step's loads behind the last step's store
      Tile q = tile(buf, 0);
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        const Tile next = tt + 1 < kChunk ? tile(buf, tt + 1) : q;
        step(q, tt);
        q = next;
      }
    } else {
#pragma unroll 4
      for (int tt = 0; tt < tc; ++tt) step(tile(buf, tt), tt);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    // y_t = (sum of the L lanes' parts, in lane order) + D x_t, one store a
    // (step, channel), neighbouring threads on neighbouring channels
    if (s_live) {
#pragma unroll
      for (int j = 0; j < kStageX; ++j) {
        const int tt = st + j * L;
        if (tt < tc) {
          float acc = ps[tt][sc * L];
#pragma unroll
          for (int q = 1; q < L; ++q) acc += ps[tt][sc * L + q];
          yb[static_cast<long long>(t0 + tt) * D] = from_f32<T>(acc + xs[buf][tt][sc] * skip);
        }
      }
    }
    __syncthreads();  // the parts and this chunk's x are read before they are written again
    buf ^= 1;
  }
  if (!live) return;
  if (vec_state) {
    *reinterpret_cast<float4*>(hT + hs) = make_float4(h[0], h[1], h[2], h[3]);
  } else {
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      if (n0 + s < N) hT[hs + s] = h[s];
    }
  }
}

template <typename T, int L>
int launch_l(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             const void* Dskip, const void* h0, void* y, void* hT, void* states, int B,
             int T_len, int D, int N, long long sxb, long long sxt, long long sxd, long long sdb, long long sdt,
             long long sdd, long long sbb, long long sbt, long long sbn, long long scb,
             long long sct, long long scn, cudaStream_t stream) {
  if (N > L * kStates) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0 || T_len == 0) return 0;
  auto kernel = ssm_scan_kernel<T, L>;
  static size_t granted[kMaxDevices] = {};
  // the static tiles take 2 * 2 * kChunk * (kChannels + kMaxState) floats
  const size_t static_bytes = sizeof(float) * 4 * (8 * L) * (kChannels + kMaxState);
  cudaError_t err = allow_smem(kernel, partial_bytes(L), granted, 48 * 1024 - static_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec_state = N == L * kStates && a16(A) && a16(hT) && (h0 == nullptr || a16(h0)) &&
                         (states == nullptr || a16(states));
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  kernel<<<grid, kChannels * L, partial_bytes(L), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const T*>(Dskip),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hT),
      static_cast<float*>(states), T_len, D, N, vec_state, sxb, sxt, sxd, sdb, sdt, sdd, sbb,
      sbt, sbn, scb, sct, scn);
  return static_cast<int>(cudaGetLastError());
}

// lanes: lanes a channel (1, 2 or 4), from _build.ssm_scan_lanes; refused
// when the launcher has no form for it or its lanes cannot hold N
template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* Dskip, const void* h0, void* y, void* hT, void* states, int B,
           int T_len, int D, int N, int lanes, long long sxb, long long sxt, long long sxd, long long sdb,
           long long sdt, long long sdd, long long sbb, long long sbt, long long sbn,
           long long scb, long long sct, long long scn, void* stream) {
  if (N < 1 || N > kMaxState || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SSM_LANES(LANES)                                                               \
  case LANES:                                                                                \
    return launch_l<T, LANES>(x, dt, A, Bm, Cm, Dskip, h0, y, hT, states, B, T_len, D, N, sxb, \
                              sxt, sxd, sdb, sdt, sdd, sbb, sbt, sbn, scb, sct, scn, s);
  switch (lanes) {
    REPRO_SSM_LANES(1)
    REPRO_SSM_LANES(2)
    REPRO_SSM_LANES(4)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SSM_LANES
}

}  // namespace
}  // namespace repro_torch

#define REPRO_SSM_SCAN_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* x, const void* dt, const void* A, const void* Bm,      \
                      const void* Cm, const void* Dskip, const void* h0, void* y,         \
                      void* hT, void* states, int B, int T_len, int D, int N, int lanes,  \
                      long long sxb, long long sxt, long long sxd, long long sdb,         \
                      long long sdt, long long sdd, long long sbb, long long sbt,         \
                      long long sbn, long long scb, long long sct, long long scn,         \
                      void* stream) {                                                     \
    return repro_torch::launch<T>(x, dt, A, Bm, Cm, Dskip, h0, y, hT, states, B, T_len, D, N, \
                                  lanes, sxb, sxt, sxd, sdb, sdt, sdd, sbb, sbt, sbn, scb, \
                                  sct, scn, stream);                                       \
  }

REPRO_SSM_SCAN_ENTRY(ssm_scan_f32, float)
REPRO_SSM_SCAN_ENTRY(ssm_scan_bf16, __nv_bfloat16)
