// Paged GQA decode attention: one query token per row over its paged KV.
//
// Replaces: repro/kernels/paged_attention.py::paged_decode_attention
// (Pallas, _paged_decode_kernel), in both forms: fp pages (the pool in
// q's dtype) and quantized=True (int8 pools plus f32 scale pools
// (P, ps, K), one symmetric scale per token slot and kv head).
// Bound on the H100: bytes. Each (row, kv head) reads its len x hd K and V
// once and does 4 flops per K/V element pair per grouped query head, so even
// at group size 6 the work is ~6 flops a byte, far under the ~295 a byte at
// which bf16 compute would bind. int8 pages halve the bf16 bytes (plus 4
// bytes of scale per token and kv head for K and for V).
// Design:
// - one block per (row b, kv head kh) holds that head's g query rows,
//   pre-scaled, in f32 shared memory, so every K/V page is read once for
//   all grouped heads;
// - the block loops over pages j < ceil(len / ps) only: the block-table
//   entry of a page past the length is never read, and the page id and
//   the page count are range-checked (a bad id, or a length the table
//   cannot cover, traps instead of reading outside the pool or table);
// - the pool is read through its strides, token-major (P, ps, K, hd), so
//   nothing transposes or copies the pool per call; so are the scale pools;
// - each page's K and V (ps x hd) are staged in shared memory as f32; int8
//   rows are dequantized there, float(int8) * scale[token, kv head], the
//   same f32 product as the TPU kernel; the K rows are padded by one float
//   so the per-score dot products do not collide on one bank;
// - scores past the length are *replaced* by -1e30, their weights set to
//   exactly 0 and the V rows past the length zeroed (after dequantizing)
//   before p.V, so NaN or Inf left in a recycled page, or in the scale of
//   an unwritten slot, cannot reach a live row (0 * NaN guard);
// - online softmax (running max m, sum l, f32 accumulator) across pages;
//   the output is acc / max(l, 1e-30), so length 0 gives 0 as on the TPU,
//   rounded once to q's dtype (the TPU's f32 output, then astype).
// No tensor cores, TMA or pipelining yet: one page at a time, synchronous.
#include "common.cuh"

namespace repro_torch {
namespace {

// T: q and out; TP: the pools' element type (T, or int8_t with scale pools)
template <typename T, typename TP>
__global__ void paged_decode_kernel(
    const T* __restrict__ q,       // (B, H, hd) contiguous
    const TP* __restrict__ kp,     // (P, ps, K, hd) via strides
    const TP* __restrict__ vp,     // (P, ps, K, hd) via strides
    const float* __restrict__ ksc, // (P, ps, K) via strides; int8 pools only
    const float* __restrict__ vsc, // (P, ps, K) via strides; int8 pools only
    const int* __restrict__ bt,    // (B, npp)
    const int* __restrict__ lens,  // (B,) valid tokens incl. the current one
    T* __restrict__ out,           // (B, H, hd)
    int H, int K, int hd, int ps, int npp, int P,
    long long ks0, long long ks1, long long ks2, long long ks3,
    long long vs0, long long vs1, long long vs2, long long vs3,
    long long kss0, long long kss1, long long kss2,
    long long vss0, long long vss1, long long vss2,
    float scale) {
  extern __shared__ float smem[];
  const int g = H / K;
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int ld = hd + 1;  // padded row stride of q_s and k_s
  float* q_s = smem;              // [g][ld]
  float* k_s = q_s + g * ld;      // [ps][ld]
  float* v_s = k_s + ps * ld;     // [ps][hd]
  float* s_s = v_s + ps * hd;     // [g][ps]  scores, then weights
  float* acc_s = s_s + g * ps;    // [g][hd]
  float* m_s = acc_s + g * hd;    // [g] running max
  float* l_s = m_s + g;           // [g] running sum
  float* a_s = l_s + g;           // [g] this page's rescale factor
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = lens[b];

  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g) * hd;
  for (int i = tid; i < g * hd; i += nt) {
    q_s[(i / hd) * ld + i % hd] = to_f32(qb[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < g; r += nt) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int n_pages = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_pages > npp) __trap();  // a length past the block table's reach
  for (int j = 0; j < n_pages; ++j) {
    const int page = bt[static_cast<size_t>(b) * npp + j];
    if (page < 0 || page >= P) __trap();
    const int t0 = j * ps;
    const TP* kpage = kp + page * ks0 + kh * ks2;
    const TP* vpage = vp + page * vs0 + kh * vs2;
    for (int i = tid; i < ps * hd; i += nt) {
      const int t = i / hd;
      const int d = i % hd;
      float kv = to_f32(kpage[t * ks1 + d * ks3]);
      float vv = to_f32(vpage[t * vs1 + d * vs3]);
      if constexpr (kQuantized<TP>) {
        kv *= ksc[page * kss0 + t * kss1 + kh * kss2];
        vv *= vsc[page * vss0 + t * vss1 + kh * vss2];
      }
      k_s[t * ld + d] = kv;
      v_s[i] = (t0 + t < len) ? vv : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < g * ps; i += nt) {
      const int r = i / ps;
      const int t = i % ps;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += q_s[r * ld + d] * k_s[t * ld + d];
      s_s[i] = (t0 + t < len) ? dot : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < g; r += nt) {
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, s_s[r * ps + t]);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = (t0 + t < len) ? expf(s_s[r * ps + t] - m_new) : 0.f;
        s_s[r * ps + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < g * hd; i += nt) {
      const int r = i / hd;
      const int d = i % hd;
      float acc = acc_s[i] * a_s[r];
      for (int t = 0; t < ps; ++t) acc += s_s[r * ps + t] * v_s[t * hd + d];
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g) * hd;
  for (int i = tid; i < g * hd; i += nt) {
    ob[i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

constexpr int kThreads = 128;

template <typename T, typename TP>
int launch(const void* q, const void* kp, const void* vp, const void* ksc, const void* vsc,
           const void* bt, const void* lens, void* out, int B, int H, int K, int hd, int ps,
           int npp, int P, long long ks0, long long ks1, long long ks2, long long ks3,
           long long vs0, long long vs1, long long vs2, long long vs3, long long kss0,
           long long kss1, long long kss2, long long vss0, long long vss1, long long vss2,
           float scale, void* stream) {
  if (B == 0) return 0;
  const int g = H / K;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(g * (hd + 1) + ps * (hd + 1) + ps * hd +
                                          g * ps + g * hd + 3 * g);
  static size_t granted[kMaxDevices] = {};
  const cudaError_t err = allow_smem(paged_decode_kernel<T, TP>, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T, TP><<<B * K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp), static_cast<const TP*>(vp),
      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<const int*>(bt), static_cast<const int*>(lens), static_cast<T*>(out), H,
      K, hd, ps, npp, P, ks0, ks1, ks2, ks3, vs0, vs1, vs2, vs3, kss0, kss1, kss2, vss0,
      vss1, vss2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

#define REPRO_PAGED_DECODE_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* q, const void* kp, const void* vp, const void* bt,     \
                      const void* lens, void* out, int B, int H, int K, int hd, int ps,  \
                      int npp, int P, long long ks0, long long ks1, long long ks2,       \
                      long long ks3, long long vs0, long long vs1, long long vs2,        \
                      long long vs3, float scale, void* stream) {                        \
    return repro_torch::launch<T, T>(q, kp, vp, nullptr, nullptr, bt, lens, out, B, H, K, \
                                     hd, ps, npp, P, ks0, ks1, ks2, ks3, vs0, vs1, vs2,  \
                                     vs3, 0, 0, 0, 0, 0, 0, scale, stream);              \
  }

// int8 pools: T names q's and out's dtype; ksc/vsc are the f32 scale pools
#define REPRO_PAGED_DECODE_Q8_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* q, const void* kp, const void* vp, const void* ksc,    \
                      const void* vsc, const void* bt, const void* lens, void* out, int B, \
                      int H, int K, int hd, int ps, int npp, int P, long long ks0,       \
                      long long ks1, long long ks2, long long ks3, long long vs0,        \
                      long long vs1, long long vs2, long long vs3, long long kss0,       \
                      long long kss1, long long kss2, long long vss0, long long vss1,    \
                      long long vss2, float scale, void* stream) {                       \
    return repro_torch::launch<T, int8_t>(q, kp, vp, ksc, vsc, bt, lens, out, B, H, K, hd, \
                                          ps, npp, P, ks0, ks1, ks2, ks3, vs0, vs1, vs2, \
                                          vs3, kss0, kss1, kss2, vss0, vss1, vss2, scale, \
                                          stream);                                       \
  }

REPRO_PAGED_DECODE_ENTRY(paged_decode_f32, float)
REPRO_PAGED_DECODE_ENTRY(paged_decode_bf16, __nv_bfloat16)
REPRO_PAGED_DECODE_Q8_ENTRY(paged_decode_q8_f32, float)
REPRO_PAGED_DECODE_Q8_ENTRY(paged_decode_q8_bf16, __nv_bfloat16)
