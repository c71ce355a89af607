// GQA decode attention over a dense slot KV cache: one query token per row.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention
// (Pallas, _decode_kernel).
// Bound on the H100: bytes. Each (row, kv head) reads its len x hd K and
// len x hd_v V once and does ~2 flops per element per grouped query head, so
// even at group size 6 the work is a few flops a byte, far under the ~295 a
// byte at which bf16 compute would bind.
// Design:
// - one block per (row b, kv head kh) holds that head's g query rows,
//   pre-scaled, in f32 shared memory, so every cache row is read once for all
//   grouped heads;
// - the block loops over cache rows t < min(lengths[b], S) only, in tiles of
//   kTile rows: rows past the length are never read (the TPU grid skips whole
//   512-row blocks past the length; here nothing past it is touched), and a
//   length of 0 gives zeros, as the TPU kernel's max(l, 1e-30) does;
// - the cache is read through its strides, (B, S_max, K, hd) as the slot
//   engine keeps it, so no call transposes or copies the cache (the JAX
//   wrapper transposes the whole cache per call);
// - K rows are staged as f32 with one float of padding, so the per-score
//   dot products do not collide on one bank;
// - the last tile's slots past the length are *replaced* by -1e30 (never
//   added to), get weight exactly 0 and their V rows are zeroed, so NaN in
//   the unused tail of a slot cannot reach the output (0 * NaN guard);
// - online softmax (running max m, sum l, f32 accumulator) across tiles;
//   the output is acc / max(l, 1e-30).
// hd and hd_v are runtime arguments (MLA decode has hd 192, hd_v 128).
// No tensor cores, TMA or split over the cache yet: one tile at a time.
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
