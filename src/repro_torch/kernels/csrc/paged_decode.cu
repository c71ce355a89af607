// Paged GQA decode attention: one query token per row over its paged KV.
//
// Replaces: repro/kernels/paged_attention.py::paged_decode_attention
// (Pallas, _paged_decode_kernel), in both forms: fp pages (the pool in
// q's dtype) and quantized=True (int8 pools plus f32 scale pools
// (P, ps, K), one symmetric scale per token slot and kv head).
// Bound on the H100: bytes. Each (row, kv head) reads its len x hd K and V
// once and does 4 flops per K/V element pair per grouped query head, so even
// at group size 8 the work is ~8 flops a byte, far under the ~20 at which
// f32 FMAs would bind. At the timed shape (B = 8, H = K = 32, hd = 64, pages
// of 16, 3160 tokens) the bytes are 25.9 MB, 7.7 us at 3.35 TB/s; int8
// pages halve the payload (plus 4 bytes of scale per token and kv head for
// K and for V): 13.8 MB, 4.1 us.
// Two bodies; the wrapper (paged_attention.py) picks one by shape:
// - f32 or bf16 q over pages of q's dtype or int8 with hd in {16, 64, 128}
//   and 16-byte page rows of inner stride 1: the split-context body of
//   decode_split.cuh, entry points paged_decode{,_q8}_split_{f32,bf16}.
//   Grid (B * K * row groups, splits): the host picks splits (1-8,
//   decode_splits) from B, K, the table's reach (npp * ps) and the SM count,
//   never from the lengths; each split walks an equal run of whole 32-token
//   tiles of the row's visible tokens, its block-table entries staged in
//   shared memory first. A CTA's 8 warps walk the run side by side through
//   per-warp cp.async rings (16-byte copies through each row's page and
//   slot, found once a row); g <= 2 (and f32) computes on CUDA cores, lanes
//   across the head dim; bf16 with g >= 3 on tensor cores (mma.sync; int8
//   rows widened exactly to bf16 in shared memory first); the splits of a
//   row merge in one cluster through distributed shared memory. int8: each
//   live token's k- and v-scale staged once; the score scaled by k_scale
//   after the product, the weight by v_scale in f32, the scaled weight
//   selected. At the timed shape: 256 CTAs, no split (64 CTAs x 1 split at
//   internlm2-20b's K = 8, 16 query rows a CTA);
// - any other shape (hd 256, misaligned or strided page rows): the CUDA-core
//   body below, entry points paged_decode{,_q8}_{f32,bf16}, one block per
//   (row, kv head), one page at a time, synchronous.
// Both visit only pages j < ceil(len / ps): the block-table entry of a page
// past the length is never read, and the page id and the page count are
// range-checked (a bad id, or a length the table cannot cover, traps
// instead of reading outside the pool or table); read the pool and the
// scale pools through their strides, token-major (P, ps, K, hd), so a layer
// view of a stacked pool goes in as it is; *replace* scores past the length
// by -1e30 and give them weight exactly 0 (after dequantizing), so NaN or
// Inf in a recycled page, or in the scale of an unwritten slot, cannot
// reach a live row; and return acc / max(l, 1e-30), so length 0 gives 0 as
// on the TPU, rounded once to q's dtype (the TPU's f32 output, then astype).
// The CUDA-core body:
// - one block per (row b, kv head kh) holds that head's g query rows,
//   pre-scaled, in f32 shared memory;
// - each page's K and V (ps x hd) are staged in shared memory as f32; int8
//   rows are dequantized there, float(int8) * scale[token, kv head]; the K
//   rows are padded by one float against bank conflicts; V rows past the
//   length are zeroed before p.V;
// - online softmax (running max m, sum l, f32 accumulator) across pages.
#include "decode_split.cuh"
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

// the split-context body (decode_split.cuh): hd in {16, 64, 128}, inner
// stride 1, 16-byte page rows; splits in {1, 2, 4, 8}; rows, the query
// rows a CTA holds, as _build.decode_group_rows picks them
namespace {

repro_torch::split::Params split_params(const void* q, const void* kp, const void* vp,
                                        const void* bt, const void* lens, void* out, int H,
                                        int K, int ps, int npp, int P, int splits,
                                        long long ks0, long long ks1, long long ks2,
                                        long long vs0, long long vs1, long long vs2,
                                        float scale) {
  repro_torch::split::Params p{};
  p.q = q;
  p.k = kp;
  p.v = vp;
  p.bt = static_cast<const int*>(bt);
  p.lens = static_cast<const int*>(lens);
  p.out = out;
  p.H = H;
  p.K = K;
  p.cap = npp * ps;
  p.ps = ps;
  p.npp = npp;
  p.P = P;
  p.splits = splits;
  p.ks0 = ks0;
  p.ks1 = ks1;
  p.ks2 = ks2;
  p.vs0 = vs0;
  p.vs1 = vs1;
  p.vs2 = vs2;
  p.scale_log2 = scale * repro_torch::tc::kLog2e;
  return p;
}

}  // namespace

#define REPRO_PAGED_DECODE_SPLIT_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* q, const void* kp, const void* vp, const void* bt,     \
                      const void* lens, void* out, int B, int H, int K, int hd, int ps,  \
                      int npp, int P, int splits, int rows, long long ks0,               \
                      long long ks1, long long ks2, long long vs0, long long vs1,        \
                      long long vs2, float scale, void* stream) {                        \
    const repro_torch::split::Params p = split_params(                                   \
        q, kp, vp, bt, lens, out, H, K, ps, npp, P, splits, ks0, ks1, ks2, vs0, vs1,     \
        vs2, scale);                                                                     \
    return repro_torch::split::launch<T, T, true>(p, B, hd, rows, stream);               \
  }

#define REPRO_PAGED_DECODE_Q8_SPLIT_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* q, const void* kp, const void* vp, const void* ksc,    \
                      const void* vsc, const void* bt, const void* lens, void* out, int B, \
                      int H, int K, int hd, int ps, int npp, int P, int splits,          \
                      int rows, long long ks0, long long ks1, long long ks2,             \
                      long long vs0, long long vs1, long long vs2, long long kss0,       \
                      long long kss1, long long kss2, long long vss0, long long vss1,    \
                      long long vss2, float scale, void* stream) {                       \
    repro_torch::split::Params p = split_params(                                         \
        q, kp, vp, bt, lens, out, H, K, ps, npp, P, splits, ks0, ks1, ks2, vs0, vs1,     \
        vs2, scale);                                                                     \
    p.ksc = static_cast<const float*>(ksc);                                              \
    p.vsc = static_cast<const float*>(vsc);                                              \
    p.kss0 = kss0;                                                                       \
    p.kss1 = kss1;                                                                       \
    p.kss2 = kss2;                                                                       \
    p.vss0 = vss0;                                                                       \
    p.vss1 = vss1;                                                                       \
    p.vss2 = vss2;                                                                       \
    return repro_torch::split::launch<T, int8_t, true>(p, B, hd, rows, stream);          \
  }

REPRO_PAGED_DECODE_SPLIT_ENTRY(paged_decode_split_f32, float)
REPRO_PAGED_DECODE_SPLIT_ENTRY(paged_decode_split_bf16, __nv_bfloat16)
REPRO_PAGED_DECODE_Q8_SPLIT_ENTRY(paged_decode_q8_split_f32, float)
REPRO_PAGED_DECODE_Q8_SPLIT_ENTRY(paged_decode_q8_split_bf16, __nv_bfloat16)

