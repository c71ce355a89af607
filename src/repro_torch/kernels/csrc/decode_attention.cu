// GQA decode attention over a dense slot KV cache: one query token per row.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention
// (Pallas, _decode_kernel).
// Bound on the H100: bytes. Each (row, kv head) reads its len x hd K and
// len x hd_v V once and does ~4 flops per K/V element pair per grouped
// query head, so even at group size 8 the work is ~8 flops a byte, far
// under the ~20 at which f32 FMAs (and the ~295 at which bf16 tensor cores)
// would bind. At the testbed's shape (B = 4, S_max = 1024, H = K = 32,
// hd = 64, 1676 visible rows) the bytes are 13.7 MB, 4.1 us at 3.35 TB/s.
// Two bodies; the wrapper (decode_attention.py) picks one by shape:
// - f32 or bf16 with hd == hd_v in {16, 64, 128} and 16-byte cache rows of
//   inner stride 1: the split-context body of decode_split.cuh, entry
//   points decode_attention_split_{f32,bf16}. Grid (B * K * row groups,
//   splits): the host picks splits (1-8, decode_splits) from B, K, S_max and
//   the SM count, never from the lengths, and each split walks an equal run
//   of whole 32-row tiles of the row's visible cache rows. A CTA's 8 warps
//   walk the run side by side through per-warp cp.async rings; g <= 2 (and
//   f32) computes on CUDA cores, lanes across the head dim; bf16 with g >= 3
//   (Jamba-1.5-Large's 8, internlm2-20b's 6) on tensor cores (mma.sync, all
//   16 rows of a group in one A operand); the splits of a row merge in one
//   cluster through distributed shared memory. At the testbed's shape: 128
//   CTAs, no split; at Jamba's (B = 4, K = 8): 32 x 2 splits;
// - any other shape (MLA decode's hd 192 / hd_v 128, hd 256, misaligned or
//   strided rows): the CUDA-core body below, entry points
//   decode_attention_{f32,bf16}, one block per (row, kv head).
// Both read the cache through its strides, (B, S_max, K, hd) as the slot
// engine keeps it, so no call transposes or copies the cache (the JAX
// wrapper transposes the whole cache per call); read no cache row at or past
// min(lengths[b], S_max), so whatever the unused tail of a slot holds (even
// NaN) cannot reach the output; and return acc / max(l, 1e-30) rounded
// once to q's dtype (length 0 gives zeros, as the TPU kernel does).
// The CUDA-core body:
// - one block per (row b, kv head kh) holds that head's g query rows,
//   pre-scaled, in f32 shared memory, and loops over the live cache rows
//   in tiles of kTile rows, staged as f32 (K padded by one float against
//   bank conflicts);
// - the last tile's slots past the length are *replaced* by -1e30 (never
//   added to), get weight exactly 0 and their V rows are zeroed;
// - online softmax (running max m, sum l, f32 accumulator) across tiles.
// hd and hd_v are runtime arguments there (MLA decode has hd 192, hd_v 128).
#include "decode_split.cuh"
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 32;  // cache rows staged per iteration

template <typename T>
__global__ void decode_attention_kernel(
    const T* __restrict__ q,       // (B, H, hd) contiguous
    const T* __restrict__ kc,      // (B, S, K, hd) via strides
    const T* __restrict__ vc,      // (B, S, K, hd_v) via strides
    const int* __restrict__ lens,  // (B,) valid cache rows
    T* __restrict__ out,           // (B, H, hd_v) contiguous
    int H, int K, int hd, int hd_v, int S,
    long long ks0, long long ks1, long long ks2, long long ks3,
    long long vs0, long long vs1, long long vs2, long long vs3,
    float scale) {
  extern __shared__ float smem[];
  const int g = H / K;
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int ld = hd + 1;  // padded row stride of q_s and k_s
  float* q_s = smem;                 // [g][ld]
  float* k_s = q_s + g * ld;         // [kTile][ld]
  float* v_s = k_s + kTile * ld;     // [kTile][hd_v]
  float* s_s = v_s + kTile * hd_v;   // [g][kTile]  scores, then weights
  float* acc_s = s_s + g * kTile;    // [g][hd_v]
  float* m_s = acc_s + g * hd_v;     // [g] running max
  float* l_s = m_s + g;              // [g] running sum
  float* a_s = l_s + g;              // [g] this tile's rescale factor
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = min(max(lens[b], 0), S);

  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g) * hd;
  for (int i = tid; i < g * hd; i += nt) q_s[(i / hd) * ld + i % hd] = to_f32(qb[i]) * scale;
  for (int i = tid; i < g * hd_v; i += nt) acc_s[i] = 0.f;
  for (int r = tid; r < g; r += nt) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const T* kb = kc + b * ks0 + kh * ks2;
  const T* vb = vc + b * vs0 + kh * vs2;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);  // live rows of this tile
    for (int i = tid; i < kTile * hd; i += nt) {
      const int t = i / hd;
      const int d = i % hd;
      k_s[t * ld + d] = t < n ? to_f32(kb[(t0 + t) * ks1 + d * ks3]) : 0.f;
    }
    for (int i = tid; i < kTile * hd_v; i += nt) {
      const int t = i / hd_v;
      const int d = i % hd_v;
      v_s[i] = t < n ? to_f32(vb[(t0 + t) * vs1 + d * vs3]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < g * kTile; i += nt) {
      const int r = i / kTile;
      const int t = i % kTile;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += q_s[r * ld + d] * k_s[t * ld + d];
      s_s[i] = t < n ? dot : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < g; r += nt) {
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, s_s[r * kTile + t]);
      float sum = 0.f;
      for (int t = 0; t < kTile; ++t) {
        const float p = t < n ? expf(s_s[r * kTile + t] - m_new) : 0.f;
        s_s[r * kTile + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < g * hd_v; i += nt) {
      const int r = i / hd_v;
      const int d = i % hd_v;
      float acc = acc_s[i] * a_s[r];
      for (int t = 0; t < n; ++t) acc += s_s[r * kTile + t] * v_s[t * hd_v + d];
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g) * hd_v;
  for (int i = tid; i < g * hd_v; i += nt) {
    ob[i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / hd_v], 1e-30f));
  }
}

constexpr int kThreads = 128;

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* lens, void* out, int B,
           int H, int K, int hd, int hd_v, int S, long long ks0, long long ks1, long long ks2,
           long long ks3, long long vs0, long long vs1, long long vs2, long long vs3,
           float scale, void* stream) {
  if (B == 0) return 0;
  const int g = H / K;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(g * (hd + 1) + kTile * (hd + 1) + kTile * hd_v +
                                          g * kTile + g * hd_v + 3 * g);
  static size_t granted[kMaxDevices] = {};
  const cudaError_t err = allow_smem(decode_attention_kernel<T>, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<T><<<B * K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const int*>(lens), static_cast<T*>(out), H, K, hd, hd_v, S, ks0, ks1, ks2,
      ks3, vs0, vs1, vs2, vs3, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

#define REPRO_DECODE_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* q, const void* kc, const void* vc, const void* lens,   \
                      void* out, int B, int H, int K, int hd, int hd_v, int S,           \
                      long long ks0, long long ks1, long long ks2, long long ks3,        \
                      long long vs0, long long vs1, long long vs2, long long vs3,        \
                      float scale, void* stream) {                                       \
    return repro_torch::launch<T>(q, kc, vc, lens, out, B, H, K, hd, hd_v, S, ks0, ks1,  \
                                  ks2, ks3, vs0, vs1, vs2, vs3, scale, stream);          \
  }

REPRO_DECODE_ENTRY(decode_attention_f32, float)
REPRO_DECODE_ENTRY(decode_attention_bf16, __nv_bfloat16)

// the split-context body (decode_split.cuh): hd == hd_v in {16, 64, 128},
// inner stride 1, 16-byte rows; splits in {1, 2, 4, 8}; rows, the query
// rows a CTA holds, as _build.decode_group_rows picks them
#define REPRO_DECODE_SPLIT_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* q, const void* kc, const void* vc, const void* lens,   \
                      void* out, int B, int H, int K, int hd, int S, int splits,         \
                      int rows, long long ks0, long long ks1, long long ks2,             \
                      long long vs0, long long vs1, long long vs2, float scale,          \
                      void* stream) {                                                    \
    repro_torch::split::Params p{};                                                      \
    p.q = q;                                                                             \
    p.k = kc;                                                                            \
    p.v = vc;                                                                            \
    p.lens = static_cast<const int*>(lens);                                              \
    p.out = out;                                                                         \
    p.H = H;                                                                             \
    p.K = K;                                                                             \
    p.cap = S;                                                                           \
    p.splits = splits;                                                                   \
    p.ks0 = ks0;                                                                         \
    p.ks1 = ks1;                                                                         \
    p.ks2 = ks2;                                                                         \
    p.vs0 = vs0;                                                                         \
    p.vs1 = vs1;                                                                         \
    p.vs2 = vs2;                                                                         \
    p.scale_log2 = scale * repro_torch::tc::kLog2e;                                   \
    return repro_torch::split::launch<T, T, false>(p, B, hd, rows, stream);              \
  }

REPRO_DECODE_SPLIT_ENTRY(decode_attention_split_f32, float)
REPRO_DECODE_SPLIT_ENTRY(decode_attention_split_bf16, __nv_bfloat16)

