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
// dout, lse in; dq, dk, dv out). This body does not reach that: it is the
// simple, deterministic first form, f32 math on the CUDA cores (a later PR
// moves its products to the tensor cores).
//
// Design (FlashAttention-2's backward, three launches, no atomics, so the
// result is the same bit for bit run after run):
// 1. delta: D = rowsum(dout * o) a (batch, head, token) row, one warp a row,
//    into an f32 scratch (B, H, Sq) the wrapper allocates;
// 2. dk/dv: one CTA per (batch, kv head, block of kBN keys). The query-head
//    group is folded into the query rows as in the forward (row r is token
//    r / g of head kh*g + r % g), so the CTA walks the row blocks of the
//    whole group (causal: only those whose tokens reach its keys), and for
//    each recomputes P = exp(S*scale - lse) and dP = dout V^T, and adds
//    dV += P^T dout and dK += dS^T Q with dS = P * (dP - D). Its dk and dv
//    stay in registers over the walk and are written once;
// 3. dq: one CTA per block of kBM folded query rows (the forward's grid),
//    walking the key blocks it sees (causal: up to its last row's token),
//    dQ += dS K, written once.
// Tiles are staged in shared memory as f32 (bf16 widened as it is read), 256
// threads a CTA as a 16 x 16 grid, each thread a 4 x 4 patch of a 64 x 64
// product (rows ty + 16 i, columns tx + 16 j: one row pair a warp, so the
// row operand is a broadcast and the column operand conflict-free through a
// padded row stride). q, k, v, o and dout are read through their strides
// ((B, S, heads, d)); dq, dk, dv are contiguous, rounded once from f32.
// Masking as in the forward: a key at or past Sk, or (causal) past the row's
// token, and a row past Sq*g, have P = 0 by select; keys past Sk and rows
// past the end are never read (zeros are staged), so garbage there, even
// NaN, moves no gradient. Head dims 16, 64, 128 with hd == hd_v; the wrapper
// refuses others.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBM = 64;        // folded query rows a tile
constexpr int kBN = 64;        // keys a tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

struct BwdParams {
  const void* q;      // (B, Sq, H, hd) via qs
  const void* k;      // (B, Sk, K, hd) via ks
  const void* v;      // (B, Sk, K, hd) via vs
  const void* o;      // (B, Sq, H, hd) via os
  const void* dout;   // (B, Sq, H, hd) via dos
  const float* lse;   // (B, H, Sq) contiguous
  float* delta;       // (B, H, Sq) scratch
  void* dq;           // (B, Sq, H, hd) contiguous
  void* dk;           // (B, Sk, K, hd) contiguous
  void* dv;           // (B, Sk, K, hd) contiguous
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

// stage rows [r0, r0 + kBM) of a folded query-side tensor (q, o or dout) of
// kv head kh as f32 [kBM][HD + 1]; rows past n_rows are zeros, never read
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const void* src, const long long* st,
                                           int b, int kh, int g, int r0, int n_rows) {
  const T* base = static_cast<const T*>(src) + b * st[0];
  for (int i = threadIdx.x; i < kBM * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int row = r0 + r;
    float x = 0.f;
    if (row < n_rows)
      x = to_f32(base[(row / g) * st[1] + static_cast<long long>(kh * g + row % g) * st[2] +
                      d * st[3]]);
    dst[r * (HD + 1) + d] = x;
  }
}

// stage keys [n0, n0 + kBN) of k or v (kv head kh) as f32 [kBN][HD + 1];
// keys at or past Sk are zeros, never read
template <typename T, int HD>
__device__ __forceinline__ void stage_keys(float* dst, const void* src, const long long* st,
                                           int b, int kh, int n0, int Sk) {
  const T* base = static_cast<const T*>(src) + b * st[0] + kh * st[2];
  for (int i = threadIdx.x; i < kBN * HD; i += kThreads) {
    const int n = i / HD;
    const int d = i % HD;
    dst[n * (HD + 1) + d] = n0 + n < Sk ? to_f32(base[(n0 + n) * st[1] + d * st[3]]) : 0.f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over rows of stride HD + 1
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
// over the kBM rows of w ([kBM][kBN + 1]) and x ([kBM][HD + 1])
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

template <int HD>
struct BwdSmem {
  static constexpr int kTile = kBM * (HD + 1);  // kBM == kBN
  static constexpr int kW = kBM * (kBN + 1);
  static constexpr size_t kBytes = sizeof(float) * (4 * kTile + kW + 2 * kBM);
};

// P and dS of one (row block, key block) pair, in the thread's 4 x 4 patch:
// p = live ? exp(s * scale - lse) : 0; ds = p * (dp - D)
__device__ __forceinline__ bool live(const BwdParams& p, int row, int key, int n_rows, int g) {
  return row < n_rows && key < p.Sk && (!p.causal || key <= row / g);
}

// 2. dk, dv: one CTA per (b * K + kh, key block)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  constexpr int kTile = BwdSmem<HD>::kTile;
  float* k_s = smem;
  float* v_s = k_s + kTile;
  float* q_s = v_s + kTile;
  float* do_s = q_s + kTile;
  float* w_s = do_s + kTile;   // [kBM][kBN + 1]: P, then dS
  float* lse_s = w_s + BwdSmem<HD>::kW;
  float* dd_s = lse_s + kBM;
  const int g = p.H / p.K;
  const int b = blockIdx.x / p.K;
  const int kh = blockIdx.x % p.K;
  const int n0 = blockIdx.y * kBN;
  const int n_rows = p.Sq * g;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  stage_keys<T, HD>(k_s, p.k, p.ks, b, kh, n0, p.Sk);
  stage_keys<T, HD>(v_s, p.v, p.vs, b, kh, n0, p.Sk);
  float dk[4][HD / 16], dv[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: rows whose token is at least n0 see this block's keys
  const int rb0 = p.causal ? (n0 * g) / kBM : 0;
  for (int r0 = rb0 * kBM; r0 < n_rows; r0 += kBM) {
    __syncthreads();  // the previous block's reads of q_s, do_s, w_s are done
    stage_rows<T, HD>(q_s, p.q, p.qs, b, kh, g, r0, n_rows);
    stage_rows<T, HD>(do_s, p.dout, p.dos, b, kh, g, r0, n_rows);
    for (int m = threadIdx.x; m < kBM; m += kThreads) {
      const int row = r0 + m;
      const long long at = (static_cast<long long>(b) * p.H + kh * g + row % g) * p.Sq + row / g;
      lse_s[m] = row < n_rows ? p.lse[at] : __int_as_float(0x7f800000);  // P = 0
      dd_s[m] = row < n_rows ? p.delta[at] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<HD>(s, q_s, k_s, ty, tx);
    dot_tile<HD>(dp, do_s, v_s, ty, tx);
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
    add_wt_x<HD>(dv, w_s, do_s, ty, tx);  // dV += P^T dout
    __syncthreads();                      // every read of P is done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w_s[m * (kBN + 1) + tx + 16 * j] = s[i][j] * (dp[i][j] - dd_s[m]);
    }
    __syncthreads();
    add_wt_x<HD>(dk, w_s, q_s, ty, tx);   // dK += dS^T Q
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + ty + 16 * i;
    if (key >= p.Sk) continue;
    const long long base = ((static_cast<long long>(b) * p.Sk + key) * p.K + kh) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      dkp[base + tx + 16 * j] = from_f32<T>(dk[i][j] * p.scale);
      dvp[base + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

// 3. dq: one CTA per (b * K + kh, folded row block), longest first
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  constexpr int kTile = BwdSmem<HD>::kTile;
  float* q_s = smem;
  float* do_s = q_s + kTile;
  float* k_s = do_s + kTile;
  float* v_s = k_s + kTile;
  float* w_s = v_s + kTile;   // [kBM][kBN + 1]: dS
  float* lse_s = w_s + BwdSmem<HD>::kW;
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
  stage_rows<T, HD>(do_s, p.dout, p.dos, b, kh, g, r0, n_rows);
  for (int m = threadIdx.x; m < kBM; m += kThreads) {
    const int row = r0 + m;
    const long long at = (static_cast<long long>(b) * p.H + kh * g + row % g) * p.Sq + row / g;
    lse_s[m] = row < n_rows ? p.lse[at] : __int_as_float(0x7f800000);  // P = 0
    dd_s[m] = row < n_rows ? p.delta[at] : 0.f;
  }
  float dq[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dq[i][j] = 0.f;

  // causal: the block's last row sees keys 0 .. its own token
  const int n_k = p.causal ? min(p.Sk, (r0 + rows - 1) / g + 1) : p.Sk;
  for (int n0 = 0; n0 < n_k; n0 += kBN) {
    __syncthreads();  // the previous block's reads of k_s, v_s, w_s are done
    stage_keys<T, HD>(k_s, p.k, p.ks, b, kh, n0, p.Sk);
    stage_keys<T, HD>(v_s, p.v, p.vs, b, kh, n0, p.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<HD>(s, q_s, k_s, ty, tx);
    dot_tile<HD>(dp, do_s, v_s, ty, tx);
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
      float wv[4], kv[HD / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = w_s[(ty + 16 * i) * (kBN + 1) + n];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) kv[j] = k_s[n * (HD + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) dq[i][j] = fmaf(wv[i], kv[j], dq[i][j]);
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
    for (int j = 0; j < HD / 16; ++j) dqp[base + tx + 16 * j] = from_f32<T>(dq[i][j] * p.scale);
  }
}

template <typename T, int HD>
int launch_hd(const BwdParams& p, cudaStream_t s) {
  constexpr size_t smem = BwdSmem<HD>::kBytes;
  static size_t granted_kv[kMaxDevices] = {};
  static size_t granted_q[kMaxDevices] = {};
  cudaError_t err = allow_smem(dkdv_kernel<T, HD>, smem, granted_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(dq_kernel<T, HD>, smem, granted_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  delta_kernel<T><<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads,
                    0, s>>>(p, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = p.H / p.K;
  dkdv_kernel<T, HD><<<dim3(p.B * p.K, (p.Sk + kBN - 1) / kBN), kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, HD><<<dim3(p.B * p.K, (p.Sq * g + kBM - 1) / kBM), kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const BwdParams& p, int hd, void* stream) {
  if (p.B == 0 || p.Sq == 0 || p.Sk == 0 || p.H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<T, 16>(p, s);
    case 64: return launch_hd<T, 64>(p, s);
    case 128: return launch_hd<T, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

#define REPRO_FLASH_BWD_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* o,          \
                      const void* dout, const float* lse, float* delta, void* dq, void* dk, \
                      void* dv, int B, int Sq, int Sk, int H, int K, int hd, int causal,    \
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
    return repro_torch::launch<T>(p, hd, stream);                                           \
  }

REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)
