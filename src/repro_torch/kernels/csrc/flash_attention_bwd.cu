// Backward of GQA flash attention: dq, dk, dv from q, k, v, the forward's
// output o and row log-sum-exp lse, and the output's gradient dout.
//
// Replaces: the reverse-mode of repro/kernels/flash_attention.py::
// flash_attention, which the JAX package does not have (jax.grad through a
// Pallas kernel fails, so JAX trains through its jnp oracle). This is the
// gradient of the forward kernel (flash_attention.cu), which the port's
// trainer runs on the card (ops._FlashAttention).
//
// Bound on the H100: operations. At stablelm-1.6b's training shape (B = 4,
// S = 1024, causal, H = K = 32, hd = 64) the five products of the gradient
// over the 524,800 live (query, key) pairs a head are 43 GFLOP, 0.043 ms at
// the bf16 tensor-core rate, against 0.025 ms for the bytes (q, k, v, o,
// dout, lse in; dq, dk, dv out). Recomputing S and dP in the dQ pass makes
// the work seven products, ~64 GFLOP over the live 64 x 64 tiles.
//
// Three launches, no atomics, so the result is the same bit for bit run
// after run (FlashAttention-2's backward):
// 1. delta: D = rowsum(dout * o) a (batch, head, token) row into an f32
//    scratch (B, H, Sq) the wrapper allocates;
// 2. dk/dv: one CTA per (batch, kv head, block of keys). The query-head
//    group is folded into the query rows as in the forward (row r is token
//    r / g of head kh*g + r % g), so the CTA walks the row blocks of the
//    whole group (causal: only those whose tokens reach its keys), and for
//    each recomputes P = exp(S*scale - lse) and dP = dout V^T, and adds
//    dV += P^T dout and dK += dS^T Q with dS = P * (dP - D). Its dk and dv
//    stay in registers over the walk and are written once;
// 3. dq: one CTA per block of folded query rows (the forward's grid, longest
//    first), walking the key blocks it sees (causal: up to its last row's
//    token), dQ += dS K, written once.
// Masking as in the forward: a key at or past Sk, or (causal) past the row's
// token, and a row past Sq*g, have P = 0 by select; keys past Sk and rows
// past the end are never read (zeros are staged), so garbage there, even
// NaN, moves no gradient. dq, dk, dv are contiguous, rounded once from f32.
// Head dims (hd, hd_v): 16, 64 and 128 with hd == hd_v, and MLA's (24, 16)
// (DeepSeek's smoke config, CUDA-core body only) and (192, 128)
// (DeepSeek-V2-Lite) (_build.BWD_HEAD_DIM_PAIRS); the wrapper refuses others.
//
// At MLA's 192 / 128 (DeepSeek-V2-Lite's training shape: B = 4, S = 1024,
// H = K = 16, causal) the bound is operations: 0.0565 ms for the five
// products at the bf16 rate. What bounds the tensor-core body there is
// registers and the latency they leave unhidden: with 16 keys a warp, the
// dK/dV pass's f32 dk (16 x 192) and dv (16 x 128) take 160 registers a
// thread before any fragment, and the dQ pass's dq 96. The dK/dV pass keeps
// 64 keys and 4 warps a CTA and walks 32 folded rows a step (kWideRows: S^T
// and dP^T 16 registers each; 255 registers, no spill; 82 KB of shared
// memory, two CTAs a SM); the dQ pass walks 32 keys a step where hd == hd_v
// walks 64 (kWideDqKeys: S and dP 16 registers each, a 20 KB ring stage, 80
// KB a CTA, so two CTAs a SM where 64 keys' 120 KB left one). The other
// values of both took 7-12 % longer (tools/flash_mla_variants.py).
// Products stay on mma.sync with no atomics, so a rerun is bit-equal.
//
// Two bodies; the wrapper (flash_attention.py, backward_uses_tensor_cores)
// picks one by shape:
// - bf16 at (hd, hd_v) in _build.TC_HEAD_DIM_PAIRS ((16, 16), (64, 64),
//   (128, 128), (192, 128)) whose q, k, v, o and dout rows are 16-byte
//   aligned with inner stride 1: the tensor-core body (entry
//   flash_attention_bwd_tc_bf16),
//   built from attention_tc.cuh's pieces (mma.sync m16n8k16 bf16 with f32
//   accumulation, ldmatrix and ldmatrix.trans on XOR-swizzled tiles,
//   cp.async with zero-fill). 128 threads, 4 warps of 16 rows each.
//   - delta: 16-byte loads, hd_v / 8 lanes a row;
//   - dk/dv: 64 keys a CTA, 16 a warp. K and V stay resident in shared
//     memory; the walk's Q, dout, LSE and D tiles come through a
//     double-buffered cp.async ring. A warp computes S^T = K Q^T and
//     dP^T = V dout^T (its 16 keys x the block's rows) directly, so P^T and
//     dS^T are already A operands in registers for dV += P^T dout and
//     dK += dS^T Q (dout and Q through ldmatrix.trans): P and dS are
//     rounded once to bf16 there, as FlashAttention-2 and SDPA's backward
//     do, with no trip through shared memory. Steps of 32 rows (64 at hd
//     16), so the f32 dk, dv, S^T and dP^T fit the registers without
//     spilling;
//   - dq: 64 rows a CTA, 16 a warp, Q and dout resident in shared memory,
//     K and V tiles of 64 keys (32 at 192 / 128) through the ring; S and
//     dP on the tensor cores, dS rounded once to bf16 as the A operand of
//     dQ += dS K (K through ldmatrix.trans).
// - f32, bf16 at (24, 16), and bf16 with rows off 16 bytes or strided
//   inner dims: the CUDA-core body, f32 math (held_train runs the card in
//   f32 against the CPU). Tiles are staged in shared memory as f32 (bf16 widened as it is
//   read), 256 threads a CTA as a 16 x 16 grid, each thread a 4 x 4 patch of
//   a 64 x 64 product (rows ty + 16 i, columns tx + 16 j: one row pair a
//   warp, so the row operand is a broadcast and the column operand
//   conflict-free through a padded row stride); q, k, v, o and dout are read
//   through their strides ((B, S, heads, d)). Two head dims: HD for q and k
//   (S, dK, dQ), HDV for v, o and dout (dP, dV, delta), each staged in
//   columns rounded up to a multiple of 16 (24 -> 32), the pad zero-filled,
//   so it adds nothing to a product and is never written. At (192, 128) the
//   four f32 tiles and P/dS take ~178 KB of shared memory (the launcher opts
//   in above 48 KB).
#include "attention_tc.cuh"
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBM = 64;        // folded query rows a tile
constexpr int kBN = 64;        // keys a tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

struct BwdParams {
  const void* q;      // (B, Sq, H, hd) via qs
  const void* k;      // (B, Sk, K, hd) via ks
  const void* v;      // (B, Sk, K, hd_v) via vs
  const void* o;      // (B, Sq, H, hd_v) via os
  const void* dout;   // (B, Sq, H, hd_v) via dos
  const float* lse;   // (B, H, Sq) contiguous
  float* delta;       // (B, H, Sq) scratch
  void* dq;           // (B, Sq, H, hd) contiguous
  void* dk;           // (B, Sk, K, hd) contiguous
  void* dv;           // (B, Sk, K, hd_v) contiguous
  int B, Sq, Sk, H, K, causal;
  long long qs[4], ks[4], vs[4], os[4], dos[4];
  float scale;
};

// 1. D = rowsum(dout * o), one warp a (b, token, head) row
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const BwdParams p, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const long long n_rows = static_cast<long long>(p.B) * p.Sq * p.H;
  if (row >= n_rows) return;
  const int h = static_cast<int>(row % p.H);
  const long long bt = row / p.H;
  const int t = static_cast<int>(bt % p.Sq);
  const int b = static_cast<int>(bt / p.Sq);
  const T* o = static_cast<const T*>(p.o) + b * p.os[0] + t * p.os[1] + h * p.os[2];
  const T* d = static_cast<const T*>(p.dout) + b * p.dos[0] + t * p.dos[1] + h * p.dos[2];
  float acc = 0.f;
  for (int i = threadIdx.x % 32; i < hd; i += 32)
    acc += to_f32(d[i * p.dos[3]]) * to_f32(o[i * p.os[3]]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.Sq + t] = acc;
}

// a head dim's columns in the staged tiles: a multiple of 16 (the thread
// grid's column step), the pad zero-filled
__host__ __device__ constexpr int padded(int hd) { return (hd + 15) / 16 * 16; }

// stage rows [r0, r0 + kBM) of a folded query-side tensor (q, o or dout) of
// kv head kh as f32 [kBM][padded(HD) + 1]; rows past n_rows and the pad
// columns are zeros, never read
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const void* src, const long long* st,
                                           int b, int kh, int g, int r0, int n_rows) {
  constexpr int kP = padded(HD);
  const T* base = static_cast<const T*>(src) + b * st[0];
  for (int i = threadIdx.x; i < kBM * kP; i += kThreads) {
    const int r = i / kP;
    const int d = i % kP;
    const int row = r0 + r;
    float x = 0.f;
    if (row < n_rows && d < HD)
      x = to_f32(base[(row / g) * st[1] + static_cast<long long>(kh * g + row % g) * st[2] +
                      d * st[3]]);
    dst[r * (kP + 1) + d] = x;
  }
}

// stage keys [n0, n0 + kBN) of k or v (kv head kh) as f32 [kBN][padded(HD) +
// 1]; keys at or past Sk and the pad columns are zeros, never read
template <typename T, int HD>
__device__ __forceinline__ void stage_keys(float* dst, const void* src, const long long* st,
                                           int b, int kh, int n0, int Sk) {
  constexpr int kP = padded(HD);
  const T* base = static_cast<const T*>(src) + b * st[0] + kh * st[2];
  for (int i = threadIdx.x; i < kBN * kP; i += kThreads) {
    const int n = i / kP;
    const int d = i % kP;
    dst[n * (kP + 1) + d] =
        n0 + n < Sk && d < HD ? to_f32(base[(n0 + n) * st[1] + d * st[3]]) : 0.f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over rows of stride HD + 1
// (HD a multiple of 16: a padded head dim)
template <int HD>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_m w[m][ty + 16 i] * x[m][tx + 16 j]: a transposed product
// over the kBM rows of w ([kBM][kBN + 1]) and x ([kBM][HD + 1], HD padded)
template <int HD>
__device__ __forceinline__ void add_wt_x(float (&acc)[4][HD / 16], const float* w,
                                         const float* x, int ty, int tx) {
#pragma unroll 4
  for (int m = 0; m < kBM; ++m) {
    float wv[4], xv[HD / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[m * (kBN + 1) + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) xv[j] = x[m * (HD + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
  }
}

template <int HD, int HDV>
struct BwdSmem {
  static constexpr int kP = padded(HD);                 // q's and k's columns
  static constexpr int kPV = padded(HDV);               // v's, o's and dout's
  static constexpr int kTile = kBM * (kP + 1);          // kBM == kBN
  static constexpr int kTileV = kBM * (kPV + 1);
  static constexpr int kW = kBM * (kBN + 1);
  static constexpr size_t kBytes = sizeof(float) * (2 * kTile + 2 * kTileV + kW + 2 * kBM);
};

// P and dS of one (row block, key block) pair, in the thread's 4 x 4 patch:
// p = live ? exp(s * scale - lse) : 0; ds = p * (dp - D)
__device__ __forceinline__ bool live(const BwdParams& p, int row, int key, int n_rows, int g) {
  return row < n_rows && key < p.Sk && (!p.causal || key <= row / g);
}

// 2. dk, dv: one CTA per (b * K + kh, key block)
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  using S = BwdSmem<HD, HDV>;
  constexpr int kP = S::kP, kPV = S::kPV;
  float* k_s = smem;
  float* v_s = k_s + S::kTile;
  float* q_s = v_s + S::kTileV;
  float* do_s = q_s + S::kTile;
  float* w_s = do_s + S::kTileV;   // [kBM][kBN + 1]: P, then dS
  float* lse_s = w_s + S::kW;
  float* dd_s = lse_s + kBM;
  const int g = p.H / p.K;
  const int b = blockIdx.x / p.K;
  const int kh = blockIdx.x % p.K;
  const int n0 = blockIdx.y * kBN;
  const int n_rows = p.Sq * g;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  stage_keys<T, HD>(k_s, p.k, p.ks, b, kh, n0, p.Sk);
  stage_keys<T, HDV>(v_s, p.v, p.vs, b, kh, n0, p.Sk);
  float dk[4][kP / 16], dv[4][kPV / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kP / 16; ++j) dk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < kPV / 16; ++j) dv[i][j] = 0.f;
  }

  // causal: rows whose token is at least n0 see this block's keys
  const int rb0 = p.causal ? (n0 * g) / kBM : 0;
  for (int r0 = rb0 * kBM; r0 < n_rows; r0 += kBM) {
    __syncthreads();  // the previous block's reads of q_s, do_s, w_s are done
    stage_rows<T, HD>(q_s, p.q, p.qs, b, kh, g, r0, n_rows);
    stage_rows<T, HDV>(do_s, p.dout, p.dos, b, kh, g, r0, n_rows);
    for (int m = threadIdx.x; m < kBM; m += kThreads) {
      const int row = r0 + m;
      const long long at = (static_cast<long long>(b) * p.H + kh * g + row % g) * p.Sq + row / g;
      lse_s[m] = row < n_rows ? p.lse[at] : __int_as_float(0x7f800000);  // P = 0
      dd_s[m] = row < n_rows ? p.delta[at] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<kP>(s, q_s, k_s, ty, tx);
    dot_tile<kPV>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        const float pv = live(p, r0 + m, n0 + n, n_rows, g)
                             ? expf(s[i][j] * p.scale - lse_s[m]) : 0.f;
        s[i][j] = pv;
        w_s[m * (kBN + 1) + n] = pv;
      }
    }
    __syncthreads();
    add_wt_x<kPV>(dv, w_s, do_s, ty, tx);  // dV += P^T dout
    __syncthreads();                      // every read of P is done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w_s[m * (kBN + 1) + tx + 16 * j] = s[i][j] * (dp[i][j] - dd_s[m]);
    }
    __syncthreads();
    add_wt_x<kP>(dk, w_s, q_s, ty, tx);    // dK += dS^T Q
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + ty + 16 * i;
    if (key >= p.Sk) continue;
    const long long kv = (static_cast<long long>(b) * p.Sk + key) * p.K + kh;
#pragma unroll
    for (int j = 0; j < kP / 16; ++j)
      if (tx + 16 * j < HD) dkp[kv * HD + tx + 16 * j] = from_f32<T>(dk[i][j] * p.scale);
#pragma unroll
    for (int j = 0; j < kPV / 16; ++j)
      if (tx + 16 * j < HDV) dvp[kv * HDV + tx + 16 * j] = from_f32<T>(dv[i][j]);
  }
}

// 3. dq: one CTA per (b * K + kh, folded row block), longest first
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  using S = BwdSmem<HD, HDV>;
  constexpr int kP = S::kP, kPV = S::kPV;
  float* q_s = smem;
  float* do_s = q_s + S::kTile;
  float* k_s = do_s + S::kTileV;
  float* v_s = k_s + S::kTile;
  float* w_s = v_s + S::kTileV;   // [kBM][kBN + 1]: dS
  float* lse_s = w_s + S::kW;
  float* dd_s = lse_s + kBM;
  const int g = p.H / p.K;
  const int b = blockIdx.x / p.K;
  const int kh = blockIdx.x % p.K;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int n_rows = p.Sq * g;
  const int rows = min(kBM, n_rows - r0);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  stage_rows<T, HD>(q_s, p.q, p.qs, b, kh, g, r0, n_rows);
  stage_rows<T, HDV>(do_s, p.dout, p.dos, b, kh, g, r0, n_rows);
  for (int m = threadIdx.x; m < kBM; m += kThreads) {
    const int row = r0 + m;
    const long long at = (static_cast<long long>(b) * p.H + kh * g + row % g) * p.Sq + row / g;
    lse_s[m] = row < n_rows ? p.lse[at] : __int_as_float(0x7f800000);  // P = 0
    dd_s[m] = row < n_rows ? p.delta[at] : 0.f;
  }
  float dq[4][kP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kP / 16; ++j) dq[i][j] = 0.f;

  // causal: the block's last row sees keys 0 .. its own token
  const int n_k = p.causal ? min(p.Sk, (r0 + rows - 1) / g + 1) : p.Sk;
  for (int n0 = 0; n0 < n_k; n0 += kBN) {
    __syncthreads();  // the previous block's reads of k_s, v_s, w_s are done
    stage_keys<T, HD>(k_s, p.k, p.ks, b, kh, n0, p.Sk);
    stage_keys<T, HDV>(v_s, p.v, p.vs, b, kh, n0, p.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<kP>(s, q_s, k_s, ty, tx);
    dot_tile<kPV>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        const float pv = live(p, r0 + m, n0 + n, n_rows, g)
                             ? expf(s[i][j] * p.scale - lse_s[m]) : 0.f;
        w_s[m * (kBN + 1) + n] = pv * (dp[i][j] - dd_s[m]);
      }
    }
    __syncthreads();
    // dQ += dS K: rows ty + 16 i, dims tx + 16 j
#pragma unroll 4
    for (int n = 0; n < kBN; ++n) {
      float wv[4], kv[kP / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = w_s[(ty + 16 * i) * (kBN + 1) + n];
#pragma unroll
      for (int j = 0; j < kP / 16; ++j) kv[j] = k_s[n * (kP + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kP / 16; ++j) dq[i][j] = fmaf(wv[i], kv[j], dq[i][j]);
    }
  }

  T* dqp = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n_rows) continue;
    const long long base =
        ((static_cast<long long>(b) * p.Sq + row / g) * p.H + kh * g + row % g) * HD;
#pragma unroll
    for (int j = 0; j < kP / 16; ++j)
      if (tx + 16 * j < HD) dqp[base + tx + 16 * j] = from_f32<T>(dq[i][j] * p.scale);
  }
}

template <typename T, int HD, int HDV>
int launch_hd(const BwdParams& p, cudaStream_t s) {
  constexpr size_t smem = BwdSmem<HD, HDV>::kBytes;
  static size_t granted_kv[kMaxDevices] = {};
  static size_t granted_q[kMaxDevices] = {};
  cudaError_t err = allow_smem(dkdv_kernel<T, HD, HDV>, smem, granted_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(dq_kernel<T, HD, HDV>, smem, granted_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  delta_kernel<T><<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads,
                    0, s>>>(p, HDV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = p.H / p.K;
  dkdv_kernel<T, HD, HDV><<<dim3(p.B * p.K, (p.Sk + kBN - 1) / kBN), kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, HD, HDV><<<dim3(p.B * p.K, (p.Sq * g + kBM - 1) / kBM), kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the (hd, hd_v) pairs of _build.BWD_HEAD_DIM_PAIRS
template <typename T>
int launch(const BwdParams& p, int hd, int hd_v, void* stream) {
  if (p.B == 0 || p.Sq == 0 || p.Sk == 0 || p.H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 16 && hd_v == 16) return launch_hd<T, 16, 16>(p, s);
  if (hd == 64 && hd_v == 64) return launch_hd<T, 64, 64>(p, s);
  if (hd == 128 && hd_v == 128) return launch_hd<T, 128, 128>(p, s);
  if (hd == 24 && hd_v == 16) return launch_hd<T, 24, 16>(p, s);      // MLA, smoke widths
  if (hd == 192 && hd_v == 128) return launch_hd<T, 192, 128>(p, s);  // DeepSeek-V2-Lite
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16)
// ---------------------------------------------------------------------------
namespace tcb {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::exp2_approx;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_addr;
using tc::swz;

constexpr int kThreads = 128;  // 4 warps, 16 rows (keys or folded rows) each
constexpr int kTile = 64;      // keys of a dk/dv CTA, rows of a dq CTA, keys a dq step
constexpr int kStages = 2;     // the walk's tiles in flight: double-buffered

// folded query rows a step of the dk/dv walk: 32 at hd 64, 128 and MLA's
// 192 / 128 (kWideRows). Each thread holds the f32 dk and dv (hd / 2 and
// hd_v / 2 registers) and S^T and dP^T (rows / 2 each): at hd 128 32 rows
// keep them in registers, at hd 64 they take 164 registers a thread
// (chip_smoke.py's env line), so three CTAs share a SM where 64 rows left
// two; at 192 / 128 dk and dv alone take 160, and 32 rows still fit 255
// registers without a spill, two CTAs a SM: 16 rows a step (half the
// products between two barriers) took 9-12 % longer at DeepSeek-V2-Lite's
// training shape (tools/flash_mla_variants.py)
constexpr int kWideRows = 32;
// keys a step of the dQ walk at MLA's 192 / 128 (kTile at hd == hd_v): see
// Q below
constexpr int kWideDqKeys = 32;
template <int HD, int HDV>
struct KV {
  static constexpr int kRows = HD != HDV ? kWideRows : HD >= 64 ? 32 : 64;
  static constexpr uint32_t kKeyTile = kTile * HD * 2;    // bytes of K
  static constexpr uint32_t kValTile = kTile * HDV * 2;   // bytes of V
  static constexpr uint32_t kRowTile = kRows * HD * 2;    // bytes of Q a step
  static constexpr uint32_t kDoTile = kRows * HDV * 2;    // bytes of dout a step
  static constexpr uint32_t kStage = kRowTile + kDoTile + 2 * kRows * sizeof(float);
  static constexpr size_t kBytes = kKeyTile + kValTile + kStages * kStage;
};

// the dQ pass: Q and dout resident ([64][HD], [64][HDV]), a ring of K and V
// tiles of kKeys keys. At 192 / 128 a 64-key stage is 40 KB and the CTA
// needs 120 KB, one a SM; kWideDqKeys keys a step halve the ring (and S
// and dP's registers)
template <int HD, int HDV>
struct Q {
  static constexpr int kKeys = HD == HDV ? kTile : kWideDqKeys;
  static constexpr uint32_t kQTile = kTile * HD * 2;     // bytes of Q's [64][HD]
  static constexpr uint32_t kVTile = kTile * HDV * 2;    // bytes of dout's [64][HDV]
  static constexpr uint32_t kStage = kKeys * (HD + HDV) * 2;  // a K and a V tile
  static constexpr size_t kBytes = kQTile + kVTile + kStages * static_cast<size_t>(kStage);
};

// Copy rows [r0, r0 + ROWS) of a (B, S, heads, HD) bf16 tensor into a
// swizzled [ROWS][HD] tile, 16 bytes a copy: with FOLDED (q, dout) row r is
// token r / g of head kh*g + r % g, else (k, v) token r of head kh. Rows at
// or past `limit` are zero-filled and never read.  A row's chunks are
// copied by kLanes threads side by side, each kSegs chunks kLanes apart (at
// hd 192: 8 lanes of 3 of its 24 chunks).
template <int HD, int ROWS, bool FOLDED>
__device__ __forceinline__ void copy_rows(uint32_t dst, const void* src, const long long* st,
                                          int b, int kh, int g, int r0, int limit) {
  constexpr int kLanes = tc::chunk_lanes(HD / 8, HD / 8);
  constexpr int kSegs = HD / 8 / kLanes;
  constexpr int kStep = kThreads / kLanes;
  static_assert(kThreads % kLanes == 0 && (kSegs == 1 || kLanes >= 8), "copy plan");
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(src) + b * st[0];
  const int c = threadIdx.x % kLanes;
#pragma unroll
  for (int t = threadIdx.x / kLanes; t < ROWS; t += kStep) {
    const int row = r0 + t;
    const bool live = row < limit;
    const __nv_bfloat16* s = base;
    if (live) {
      s += c * 8;
      if (FOLDED)
        s += (row / g) * st[1] + static_cast<long long>(kh * g + row % g) * st[2];
      else
        s += row * st[1] + kh * st[2];
    }
    const uint32_t d = dst + 2 * swz<HD>(t, c);
#pragma unroll
    for (int j = 0; j < kSegs; ++j) cp_async16(d + j * kLanes * 16, s + j * kLanes * 8, live);
  }
}

// LSE and D of folded rows [r0, r0 + ROWS) (f32 (B, H, Sq)), ROWS floats
// each; rows past n_rows are zero-filled (their tiles are masked)
template <int ROWS>
__device__ __forceinline__ void copy_stats(uint32_t dst, const BwdParams& p, int b, int kh,
                                           int g, int r0, int n_rows) {
  const int t = threadIdx.x;
  if (t >= 2 * ROWS) return;
  const int m = t % ROWS;
  const int row = r0 + m;
  const bool live = row < n_rows;
  const float* src = t < ROWS ? p.lse : p.delta;
  if (live) src += (static_cast<long long>(b) * p.H + kh * g + row % g) * p.Sq + row / g;
  cp_async4(dst + t * sizeof(float), src, live);
}

// 1. D = rowsum(dout * o): hd_v / 8 lanes a (b, token, head) row, 16 bytes each
template <int HDV>
__global__ void __launch_bounds__(256) delta_tc_kernel(const BwdParams p) {
  constexpr int L = HDV / 8;
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / L;
  const int c = threadIdx.x % L;
  const bool live = row < static_cast<long long>(p.B) * p.Sq * p.H;
  float acc = 0.f;
  int b = 0, t = 0, h = 0;
  if (live) {
    h = static_cast<int>(row % p.H);
    const long long bt = row / p.H;
    t = static_cast<int>(bt % p.Sq);
    b = static_cast<int>(bt / p.Sq);
    const uint4 o = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.o) + b * p.os[0] + t * p.os[1] + h * p.os[2] + c * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.dos[0] + t * p.dos[1] +
        h * p.dos[2] + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 df = __bfloat1622float2(d2[i]);
      acc = fmaf(df.x, of.x, acc);
      acc = fmaf(df.y, of.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && c == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.Sq + t] = acc;
}

// 2. dk, dv: one CTA per (b * K + kh, block of 64 keys), longest first
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads) dkdv_tc_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = KV<HD, HDV>;
  constexpr int kD = (HD > HDV ? HD : HDV) / 16;  // k-steps (and n-steps) of the wider dim
  constexpr int BM = S::kRows;
  const int g = p.H / p.K;
  const int b = blockIdx.x / p.K;
  const int kh = blockIdx.x - b * p.K;
  const int n0 = blockIdx.y * kTile;
  const int n_rows = p.Sq * g;
  const int causal = p.causal;
  const float scale_log2 = p.scale * tc::kLog2e;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int lm = lane >> 3;  // ldmatrix: the matrix this lane addresses
  const int lr = lane & 7;   // ... and its row

  const uint32_t k_s = smem_addr(smem);
  const uint32_t v_s = k_s + S::kKeyTile;
  const uint32_t ring = v_s + S::kValTile;

  // causal: rows whose token is at least n0 see this block's keys
  const int rb0 = causal ? (n0 * g) / BM : 0;
  const int rb_end = (n_rows + BM - 1) / BM;
  copy_rows<HD, kTile, false>(k_s, p.k, p.ks, b, kh, 1, n0, p.Sk);
  copy_rows<HDV, kTile, false>(v_s, p.v, p.vs, b, kh, 1, n0, p.Sk);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (rb0 + i < rb_end) {
      const uint32_t st = ring + i * S::kStage;
      copy_rows<HD, BM, true>(st, p.q, p.qs, b, kh, g, (rb0 + i) * BM, n_rows);
      copy_rows<HDV, BM, true>(st + S::kRowTile, p.dout, p.dos, b, kh, g, (rb0 + i) * BM, n_rows);
      copy_stats<BM>(st + S::kRowTile + S::kDoTile, p, b, kh, g, (rb0 + i) * BM, n_rows);
    }
    cp_async_commit();
  }

  // this thread's two keys (rows of S^T), and the first folded row each sees
  const int nA = n0 + warp * 16 + (lane >> 2);
  const int nB = nA + 8;
  const int lowA = causal ? nA * g : 0;
  const int lowB = causal ? nB * g : 0;
  const int n_last = n0 + warp * 16 + 15;  // the warp's last key
  float dk[HD / 8][4], dv[HDV / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < HDV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = 0.f;

  for (int rb = rb0; rb < rb_end; ++rb) {
    const int slot = (rb - rb0) % kStages;
    const int next = rb + kStages - 1;
    if (next < rb_end) {
      const uint32_t st = ring + ((next - rb0) % kStages) * S::kStage;
      copy_rows<HD, BM, true>(st, p.q, p.qs, b, kh, g, next * BM, n_rows);
      copy_rows<HDV, BM, true>(st + S::kRowTile, p.dout, p.dos, b, kh, g, next * BM, n_rows);
      copy_stats<BM>(st + S::kRowTile + S::kDoTile, p, b, kh, g, next * BM, n_rows);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this step's tiles (and K, V) have landed
    __syncthreads();
    const uint32_t q_t = ring + slot * S::kStage;
    const uint32_t do_t = q_t + S::kRowTile;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (q_t - k_s) + S::kRowTile + S::kDoTile);
    const float* dd_s = lse_s + BM;
    const int r0 = rb * BM;

    // S^T = K Q^T and dP^T = V dout^T: the warp's 16 keys x BM rows
    float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // (k-steps past HD or HDV are compiled out)
#pragma unroll
    for (int kk = 0; kk < kD; ++kk) {
      const int a_row = warp * 16 + (lm & 1) * 8 + lr;
      const int b_row = (lm >> 1) * 8 + lr;
      if (kk < HD / 16) {
        uint32_t ka[4];
        ldsm_x4(k_s + 2 * swz<HD>(a_row, 2 * kk + (lm >> 1)), ka[0], ka[1], ka[2], ka[3]);
#pragma unroll
        for (int n2 = 0; n2 < BM / 16; ++n2) {
          uint32_t f[4];
          ldsm_x4(q_t + 2 * swz<HD>(n2 * 16 + b_row, 2 * kk + (lm & 1)), f[0], f[1], f[2], f[3]);
          mma_bf16(s[2 * n2], ka, f[0], f[1]);
          mma_bf16(s[2 * n2 + 1], ka, f[2], f[3]);
        }
      }
      if (kk < HDV / 16) {
        uint32_t va[4];
        ldsm_x4(v_s + 2 * swz<HDV>(a_row, 2 * kk + (lm >> 1)), va[0], va[1], va[2], va[3]);
#pragma unroll
        for (int n2 = 0; n2 < BM / 16; ++n2) {
          uint32_t f[4];
          ldsm_x4(do_t + 2 * swz<HDV>(n2 * 16 + b_row, 2 * kk + (lm & 1)), f[0], f[1], f[2],
                  f[3]);
          mma_bf16(dp[2 * n2], va, f[0], f[1]);
          mma_bf16(dp[2 * n2 + 1], va, f[2], f[3]);
        }
      }
    }

    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)), dS^T = P^T (dP^T - D);
    // a step that crosses the diagonal, the last rows or Sk selects P = 0
    // for each dead (key, row) pair
    const bool masked = (causal && r0 < n_last * g) || r0 + BM > n_rows || n_last >= p.Sk;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int c = j * 8 + quad * 2;
      const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dd = *reinterpret_cast<const float2*>(dd_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2_approx(fmaf(s[j][e], scale_log2, -((e & 1) ? l.y : l.x) * tc::kLog2e));
        if (masked) {
          const int m = r0 + c + (e & 1);
          const bool live = m >= (e < 2 ? lowA : lowB) && m < n_rows && (e < 2 ? nA : nB) < p.Sk;
          pv = live ? pv : 0.f;
        }
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - ((e & 1) ? dd.y : dd.x));
      }
    }
    // the accumulators of two 8-row column blocks are the A operand of a
    // 16-row k-step: P^T and dS^T rounded once to bf16
    uint32_t pa[BM / 16][4], sa[BM / 16][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      pa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
      sa[j >> 1][(j & 1) * 2] = pack_bf16(dp[j][0], dp[j][1]);
      sa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(dp[j][2], dp[j][3]);
    }
    // dV += P^T dout and dK += dS^T Q (ldmatrix.trans: k = rows, n = head dims)
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const int row = kk * 16 + (lm & 1) * 8 + lr;
#pragma unroll
      for (int d2 = 0; d2 < kD; ++d2) {
        uint32_t f[4];
        if (d2 < HDV / 16) {
          ldsm_x4_t(do_t + 2 * swz<HDV>(row, 2 * d2 + (lm >> 1)), f[0], f[1], f[2], f[3]);
          mma_bf16(dv[2 * d2], pa[kk], f[0], f[1]);
          mma_bf16(dv[2 * d2 + 1], pa[kk], f[2], f[3]);
        }
        if (d2 < HD / 16) {
          ldsm_x4_t(q_t + 2 * swz<HD>(row, 2 * d2 + (lm >> 1)), f[0], f[1], f[2], f[3]);
          mma_bf16(dk[2 * d2], sa[kk], f[0], f[1]);
          mma_bf16(dk[2 * d2 + 1], sa[kk], f[2], f[3]);
        }
      }
    }
    __syncthreads();  // the next step's copies reuse this stage
  }
  // causal with Sk > Sq: a block of keys no row reaches walks no step, and
  // its K and V copies must land before the CTA exits
  cp_async_wait<0>();

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? nB : nA;
    if (key >= p.Sk) continue;
    const long long kv = (static_cast<long long>(b) * p.Sk + key) * p.K + kh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dkp + kv * HD + quad * 2 + j * 8) =
          __floats2bfloat162_rn(dk[j][2 * half] * p.scale, dk[j][2 * half + 1] * p.scale);
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dvp + kv * HDV + quad * 2 + j * 8) =
          __floats2bfloat162_rn(dv[j][2 * half], dv[j][2 * half + 1]);
  }
}

// 3. dq: one CTA per (b * K + kh, block of 64 folded rows), longest first.
// Three CTAs a SM at hd <= 64: ptxas's own register target there spilled a
// word; at hd 128 the f32 dq takes the registers of two; at 192 / 128 dq's
// 96 registers a thread with S and dP of 32 keys take 255, and two CTAs fit
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads, HD >= 128 ? 1 : 3) dq_tc_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Q<HD, HDV>;
  constexpr int KT = S::kKeys;                    // keys a step
  constexpr int kD = (HD > HDV ? HD : HDV) / 16;  // k-steps of the wider dim
  const int g = p.H / p.K;
  const int b = blockIdx.x / p.K;
  const int kh = blockIdx.x - b * p.K;
  const int n_rows = p.Sq * g;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int rows = min(kTile, n_rows - r0);
  const int causal = p.causal;
  const float scale_log2 = p.scale * tc::kLog2e;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int lm = lane >> 3;
  const int lr = lane & 7;

  const uint32_t q_s = smem_addr(smem);
  const uint32_t do_s = q_s + S::kQTile;
  const uint32_t ring = do_s + S::kVTile;  // stages of [K tile | V tile]

  // causal: the block's last row sees keys 0 .. its own token
  const int n_k = causal ? min(p.Sk, (r0 + rows - 1) / g + 1) : p.Sk;
  const int n_tiles = (n_k + KT - 1) / KT;
  copy_rows<HD, kTile, true>(q_s, p.q, p.qs, b, kh, g, r0, n_rows);
  copy_rows<HDV, kTile, true>(do_s, p.dout, p.dos, b, kh, g, r0, n_rows);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      const uint32_t st = ring + i * S::kStage;
      copy_rows<HD, KT, false>(st, p.k, p.ks, b, kh, 1, i * KT, n_k);
      copy_rows<HDV, KT, false>(st + KT * HD * 2, p.v, p.vs, b, kh, 1, i * KT, n_k);
    }
    cp_async_commit();
  }

  // this thread's two rows: log2-domain LSE (+inf past the end: P = 0), D,
  // and the end of the keys each sees
  const int rA = r0 + warp * 16 + (lane >> 2);
  const int rB = rA + 8;
  float lseA = __int_as_float(0x7f800000), lseB = lseA, dA = 0.f, dB = 0.f;
  if (rA < n_rows) {
    const long long at = (static_cast<long long>(b) * p.H + kh * g + rA % g) * p.Sq + rA / g;
    lseA = p.lse[at] * tc::kLog2e;
    dA = p.delta[at];
  }
  if (rB < n_rows) {
    const long long at = (static_cast<long long>(b) * p.H + kh * g + rB % g) * p.Sq + rB / g;
    lseB = p.lse[at] * tc::kLog2e;
    dB = p.delta[at];
  }
  const int endA = causal ? min(n_k, rA / g + 1) : n_k;
  const int endB = causal ? min(n_k, rB / g + 1) : n_k;
  // a tile that ends at or before the warp's first row's end needs no mask
  const int end_warp = causal ? min(n_k, (r0 + warp * 16) / g + 1) : n_k;

  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int next = tile + kStages - 1;
    if (next < n_tiles) {
      const uint32_t st = ring + (next % kStages) * S::kStage;
      copy_rows<HD, KT, false>(st, p.k, p.ks, b, kh, 1, next * KT, n_k);
      copy_rows<HDV, KT, false>(st + KT * HD * 2, p.v, p.vs, b, kh, 1, next * KT, n_k);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this tile (and Q, dout) have landed
    __syncthreads();
    const uint32_t k_t = ring + (tile % kStages) * S::kStage;
    const uint32_t v_t = k_t + KT * HD * 2;
    const int t0 = tile * KT;

    // S = Q K^T and dP = dout V^T: the warp's 16 rows x KT keys
    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // (k-steps past HD or HDV are compiled out)
#pragma unroll
    for (int kk = 0; kk < kD; ++kk) {
      const int a_row = warp * 16 + (lm & 1) * 8 + lr;
      const int b_row = (lm >> 1) * 8 + lr;
      if (kk < HD / 16) {
        uint32_t qa[4];
        ldsm_x4(q_s + 2 * swz<HD>(a_row, 2 * kk + (lm >> 1)), qa[0], qa[1], qa[2], qa[3]);
#pragma unroll
        for (int n2 = 0; n2 < KT / 16; ++n2) {
          uint32_t f[4];
          ldsm_x4(k_t + 2 * swz<HD>(n2 * 16 + b_row, 2 * kk + (lm & 1)), f[0], f[1], f[2], f[3]);
          mma_bf16(s[2 * n2], qa, f[0], f[1]);
          mma_bf16(s[2 * n2 + 1], qa, f[2], f[3]);
        }
      }
      if (kk < HDV / 16) {
        uint32_t oa[4];
        ldsm_x4(do_s + 2 * swz<HDV>(a_row, 2 * kk + (lm >> 1)), oa[0], oa[1], oa[2], oa[3]);
#pragma unroll
        for (int n2 = 0; n2 < KT / 16; ++n2) {
          uint32_t f[4];
          ldsm_x4(v_t + 2 * swz<HDV>(n2 * 16 + b_row, 2 * kk + (lm & 1)), f[0], f[1], f[2], f[3]);
          mma_bf16(dp[2 * n2], oa, f[0], f[1]);
          mma_bf16(dp[2 * n2 + 1], oa, f[2], f[3]);
        }
      }
    }

    // dS = P (dP - D), P = 0 by select past each row's end on a tile that
    // crosses the diagonal or the last key; rounded once to bf16 A operands
    const bool masked = t0 + KT > end_warp;
    const int col = t0 + quad * 2;
    uint32_t sa[KT / 16][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2_approx(fmaf(s[j][e], scale_log2, -(e < 2 ? lseA : lseB)));
        if (masked) pv = col + j * 8 + (e & 1) < (e < 2 ? endA : endB) ? pv : 0.f;
        ds[e] = pv * (dp[j][e] - (e < 2 ? dA : dB));
      }
      sa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      sa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K (ldmatrix.trans: k = keys, n = head dims)
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        uint32_t f[4];
        ldsm_x4_t(k_t + 2 * swz<HD>(kk * 16 + (lm & 1) * 8 + lr, 2 * d2 + (lm >> 1)), f[0], f[1],
                  f[2], f[3]);
        mma_bf16(dq[2 * d2], sa[kk], f[0], f[1]);
        mma_bf16(dq[2 * d2 + 1], sa[kk], f[2], f[3]);
      }
    }
    __syncthreads();  // the next tile's copies reuse this stage
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rB : rA;
    if (r >= n_rows) continue;
    const long long base =
        ((static_cast<long long>(b) * p.Sq + r / g) * p.H + kh * g + r % g) * HD + quad * 2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqp + base + j * 8) =
          __floats2bfloat162_rn(dq[j][2 * half] * p.scale, dq[j][2 * half + 1] * p.scale);
  }
}

template <int HD, int HDV>
int launch_hd(const BwdParams& p, cudaStream_t s) {
  using KVS = KV<HD, HDV>;
  using QS = Q<HD, HDV>;
  static size_t granted_kv[kMaxDevices] = {};
  static size_t granted_q[kMaxDevices] = {};
  cudaError_t err = allow_smem(dkdv_tc_kernel<HD, HDV>, KVS::kBytes, granted_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(dq_tc_kernel<HD, HDV>, QS::kBytes, granted_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long lanes = static_cast<long long>(p.B) * p.Sq * p.H * (HDV / 8);
  delta_tc_kernel<HDV><<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = p.H / p.K;
  dkdv_tc_kernel<HD, HDV><<<dim3(p.B * p.K, (p.Sk + kTile - 1) / kTile), kThreads, KVS::kBytes,
                            s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<HD, HDV><<<dim3(p.B * p.K, (p.Sq * g + kTile - 1) / kTile), kThreads, QS::kBytes,
                          s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the pairs of _build.TC_HEAD_DIM_PAIRS
int launch(const BwdParams& p, int hd, int hd_v, void* stream) {
  if (p.B == 0 || p.Sq == 0 || p.Sk == 0 || p.H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 16 && hd_v == 16) return launch_hd<16, 16>(p, s);
  if (hd == 64 && hd_v == 64) return launch_hd<64, 64>(p, s);
  if (hd == 128 && hd_v == 128) return launch_hd<128, 128>(p, s);
  if (hd == 192 && hd_v == 128) return launch_hd<192, 128>(p, s);  // MLA: DeepSeek-V2-Lite
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tcb


}  // namespace
}  // namespace repro_torch

#define REPRO_FLASH_BWD_ENTRY(NAME, LAUNCH)                                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* o,          \
                      const void* dout, const float* lse, float* delta, void* dq, void* dk, \
                      void* dv, int B, int Sq, int Sk, int H, int K, int hd, int hd_v,      \
                      int causal,                                                           \
                      long long qs0, long long qs1, long long qs2, long long qs3,           \
                      long long ks0, long long ks1, long long ks2, long long ks3,           \
                      long long vs0, long long vs1, long long vs2, long long vs3,           \
                      long long os0, long long os1, long long os2, long long os3,           \
                      long long ds0, long long ds1, long long ds2, long long ds3,           \
                      float scale, void* stream) {                                          \
    repro_torch::BwdParams p{};                                                             \
    p.q = q;                                                                                \
    p.k = k;                                                                                \
    p.v = v;                                                                                \
    p.o = o;                                                                                \
    p.dout = dout;                                                                          \
    p.lse = lse;                                                                            \
    p.delta = delta;                                                                        \
    p.dq = dq;                                                                              \
    p.dk = dk;                                                                              \
    p.dv = dv;                                                                              \
    p.B = B;                                                                                \
    p.Sq = Sq;                                                                              \
    p.Sk = Sk;                                                                              \
    p.H = H;                                                                                \
    p.K = K;                                                                                \
    p.causal = causal;                                                                      \
    const long long st[20] = {qs0, qs1, qs2, qs3, ks0, ks1, ks2, ks3, vs0, vs1,             \
                              vs2, vs3, os0, os1, os2, os3, ds0, ds1, ds2, ds3};            \
    for (int i = 0; i < 4; ++i) {                                                           \
      p.qs[i] = st[i];                                                                      \
      p.ks[i] = st[4 + i];                                                                  \
      p.vs[i] = st[8 + i];                                                                  \
      p.os[i] = st[12 + i];                                                                 \
      p.dos[i] = st[16 + i];                                                                \
    }                                                                                       \
    p.scale = scale;                                                                        \
    return LAUNCH(p, hd, hd_v, stream);                                                     \
  }

REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_f32, repro_torch::launch<float>)
REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_bf16, repro_torch::launch<__nv_bfloat16>)
// the tensor-core body: bf16 rows 16-byte aligned, inner stride 1 (the wrapper checks)
REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_tc_bf16, repro_torch::tcb::launch)
