// Paged chunked-prefill attention for one request: C chunk queries attend
// causally to the request's paged history plus the chunk itself.
//
// Replaces: repro/kernels/paged_attention.py::paged_prefill_attention
// (Pallas, _paged_prefill_kernel), in both forms: fp pages and
// quantized=True (int8 pools plus f32 scale pools (P, ps, K)).
// Bound on the H100: bytes. At the timed chunk (C = 64 at past = 448, H = K
// = 32, hd = 64, bf16 pages of 16) q, the 512-token context and the output
// are 4.7 MB, 1.41 us at 3.35 TB/s, against 0.25 us of products at the bf16
// tensor-core rate (int8 pages: 2.7 MB, 0.82 us); at internlm2-20b's widths
// (H = 48, K = 8, hd = 128) 3.7 MB, 1.10 us, against 0.76 us of products.
// Two bodies; the wrapper (paged_attention.py) picks one by shape:
// - bf16 q over bf16 or int8 pages of a power-of-two page size with hd in
//   {16, 64, 128}, inner stride 1 and 16-byte page rows: the tensor-core
//   body of attention_tc.cuh (mma.sync m16n8k16, a 3-stage cp.async ring,
//   swizzled ldmatrix, softmax in registers), entry points
//   paged_prefill_tc_bf16 and paged_prefill_q8_tc_bf16. A 64-token key tile
//   is 64 / ps pages: each 16-byte copy reads its token's block-table entry,
//   range-checks it (a bad id traps) and copies through the pool's strides;
//   tokens at or past the block's last visible key are zero-filled, never
//   read. The grid splits the context so that one chunk fills the card:
//   (K, ceil(C*g / 64), splits), the fewest power-of-two splits (at most 8)
//   that give at least one CTA per SM (paged_attention.prefill_splits).
//   It launches the body at hd == hd_v (tc::launch takes both; the
//   <192, 128> form is flash's alone: MLA keeps no paged K/V, so nothing
//   bounds this kernel at 192 / 128).
//   The splits of a row block run as one thread-block cluster and merge
//   their f32 partials through distributed shared memory: one launch a
//   call, no scratch. Timed shape: 8 key tiles, 8 splits of one tile,
//   32 x 1 x 8 = 256 CTAs on 132 SMs; internlm2-20b's: 6 row blocks,
//   4 splits of 2 tiles, 8 x 6 x 4 = 192 CTAs (chip_smoke.py's split sweep
//   measures 1, 2, 4 and 8 splits at both). int8 pages: the int8 bytes are
//   staged as they are, widened to bf16 in shared memory (exact), and the
//   scales are folded in f32: a score column times k_scale[t, kh] after the
//   product, a weight times v_scale[t, kh] before it is rounded for P.V (the
//   row sum takes the unscaled weight);
// - every f32 call, and bf16 at any other head dim (hd = 256), page size or
//   layout: the CUDA-core body below, entry points paged_prefill{,_q8}_{f32,bf16}, in
//   f32 math (the card-vs-CPU float32 checks need exact greedy tokens):
//   - grid (K, ceil(C*g / BM)), BM = 64 rows a block, an f32 accumulator of
//     BM x hd in shared memory; one 16-token page an iteration;
//   - int8 rows are dequantized into the f32 tile as float(int8) *
//     scale[token, kv head], the TPU kernel's product.
// Both visit only the pages a block's last row can see, j <= (past +
// last_row / g) / ps, take `past` as a runtime argument, read the pool (and
// the scale pools) through their strides, token-major (P, ps, K, hd),
// *replace* masked scores by -1e30 and give masked slots weight exactly 0
// after dequantizing, keep V rows at or past ctx = past + C out of p.V
// (zeroed, or never copied), so NaN or Inf in a dead slot's payload or scale
// cannot reach a live row, and return acc / max(l, 1e-30) rounded once to
// q's dtype.
#include "attention_tc.cuh"
#include "common.cuh"

namespace repro_torch {
namespace {

// T: q and out; TP: the pools' element type (T, or int8_t with scale pools)
template <typename T, typename TP>
__global__ void paged_prefill_kernel(
    const T* __restrict__ q,       // (C, H, hd) contiguous
    const TP* __restrict__ kp,     // (P, ps, K, hd) via strides
    const TP* __restrict__ vp,     // (P, ps, K, hd) via strides
    const float* __restrict__ ksc, // (P, ps, K) via strides; int8 pools only
    const float* __restrict__ vsc, // (P, ps, K) via strides; int8 pools only
    const int* __restrict__ bt,    // (npp,)
    T* __restrict__ out,          // (C, H, hd)
    int C, int H, int K, int hd, int ps, int P, int past, int BM,
    long long ks0, long long ks1, long long ks2, long long ks3,
    long long vs0, long long vs1, long long vs2, long long vs3,
    long long kss0, long long kss1, long long kss2,
    long long vss0, long long vss1, long long vss2,
    float scale) {
  extern __shared__ float smem[];
  const int g = H / K;
  const int kh = blockIdx.x;
  const int r0 = blockIdx.y * BM;
  const int rows = min(BM, C * g - r0);
  const int ctx = past + C;
  const int ld = hd + 1;  // padded row stride of q_s and k_s
  float* q_s = smem;              // [BM][ld]
  float* k_s = q_s + BM * ld;     // [ps][ld]
  float* v_s = k_s + ps * ld;     // [ps][hd]
  float* s_s = v_s + ps * hd;     // [BM][ps]  scores, then weights
  float* acc_s = s_s + BM * ps;   // [BM][hd]
  float* m_s = acc_s + BM * hd;   // [BM]
  float* l_s = m_s + BM;          // [BM]
  float* a_s = l_s + BM;          // [BM]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < rows * hd; i += nt) {
    const int r = i / hd;
    const int d = i % hd;
    const int row = r0 + r;
    const size_t head = static_cast<size_t>(kh) * g + row % g;
    q_s[r * ld + d] = to_f32(q[(static_cast<size_t>(row / g) * H + head) * hd + d]) * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += nt) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int last_qpos = past + (r0 + rows - 1) / g;
  const int n_pages = last_qpos / ps + 1;
  for (int j = 0; j < n_pages; ++j) {
    const int page = bt[j];
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
      v_s[i] = (t0 + t < ctx) ? vv : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < rows * ps; i += nt) {
      const int r = i / ps;
      const int t = i % ps;
      const int qpos = past + (r0 + r) / g;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += q_s[r * ld + d] * k_s[t * ld + d];
      s_s[i] = (t0 + t <= qpos) ? dot : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < rows; r += nt) {
      const int qpos = past + (r0 + r) / g;
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, s_s[r * ps + t]);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = (t0 + t <= qpos) ? expf(s_s[r * ps + t] - m_new) : 0.f;
        s_s[r * ps + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < rows * hd; i += nt) {
      const int r = i / hd;
      const int d = i % hd;
      float acc = acc_s[i] * a_s[r];
      for (int t = 0; t < ps; ++t) acc += s_s[r * ps + t] * v_s[t * hd + d];
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * hd; i += nt) {
    const int r = i / hd;
    const int d = i % hd;
    const int row = r0 + r;
    const size_t head = static_cast<size_t>(kh) * g + row % g;
    out[(static_cast<size_t>(row / g) * H + head) * hd + d] =
        from_f32<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

constexpr int kThreads = 256;

template <typename T, typename TP>
int launch(const void* q, const void* kp, const void* vp, const void* ksc, const void* vsc,
           const void* bt, void* out, int C, int H, int K, int hd, int ps, int P, int past,
           int BM, long long ks0, long long ks1, long long ks2, long long ks3, long long vs0,
           long long vs1, long long vs2, long long vs3, long long kss0, long long kss1,
           long long kss2, long long vss0, long long vss1, long long vss2, float scale,
           void* stream) {
  if (C == 0) return 0;
  const int g = H / K;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(BM * (hd + 1) + ps * (hd + 1) + ps * hd +
                                          BM * ps + BM * hd + 3 * BM);
  static size_t granted[kMaxDevices] = {};
  const cudaError_t err = allow_smem(paged_prefill_kernel<T, TP>, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(K, (C * g + BM - 1) / BM);
  paged_prefill_kernel<T, TP><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp), static_cast<const TP*>(vp),
      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<const int*>(bt), static_cast<T*>(out), C, H, K, hd, ps, P, past, BM, ks0,
      ks1, ks2, ks3, vs0, vs1, vs2, vs3, kss0, kss1, kss2, vss0, vss1, vss2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

#define REPRO_PAGED_PREFILL_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* q, const void* kp, const void* vp, const void* bt,     \
                      void* out, int C, int H, int K, int hd, int ps, int P, int past,   \
                      int BM, long long ks0, long long ks1, long long ks2, long long ks3, \
                      long long vs0, long long vs1, long long vs2, long long vs3,        \
                      float scale, void* stream) {                                       \
    return repro_torch::launch<T, T>(q, kp, vp, nullptr, nullptr, bt, out, C, H, K, hd,  \
                                     ps, P, past, BM, ks0, ks1, ks2, ks3, vs0, vs1, vs2, \
                                     vs3, 0, 0, 0, 0, 0, 0, scale, stream);              \
  }

// int8 pools: T names q's and out's dtype; ksc/vsc are the f32 scale pools
#define REPRO_PAGED_PREFILL_Q8_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* q, const void* kp, const void* vp, const void* ksc,    \
                      const void* vsc, const void* bt, void* out, int C, int H, int K,   \
                      int hd, int ps, int P, int past, int BM, long long ks0,            \
                      long long ks1, long long ks2, long long ks3, long long vs0,        \
                      long long vs1, long long vs2, long long vs3, long long kss0,       \
                      long long kss1, long long kss2, long long vss0, long long vss1,    \
                      long long vss2, float scale, void* stream) {                       \
    return repro_torch::launch<T, int8_t>(q, kp, vp, ksc, vsc, bt, out, C, H, K, hd, ps, \
                                          P, past, BM, ks0, ks1, ks2, ks3, vs0, vs1, vs2, \
                                          vs3, kss0, kss1, kss2, vss0, vss1, vss2, scale, \
                                          stream);                                       \
  }

REPRO_PAGED_PREFILL_ENTRY(paged_prefill_f32, float)
REPRO_PAGED_PREFILL_ENTRY(paged_prefill_bf16, __nv_bfloat16)
REPRO_PAGED_PREFILL_Q8_ENTRY(paged_prefill_q8_f32, float)
REPRO_PAGED_PREFILL_Q8_ENTRY(paged_prefill_q8_bf16, __nv_bfloat16)

namespace {

repro_torch::tc::Params paged_params(const void* q, const void* kp, const void* vp,
                                     const void* bt, void* out, int C, int H, int K, int hd,
                                     int ps, int P, int past, int splits,
                                     long long ks0, long long ks1, long long ks2,
                                     long long vs0, long long vs1, long long vs2,
                                     float scale) {
  repro_torch::tc::Params p{};
  p.q = q;
  p.k = kp;
  p.v = vp;
  p.bt = static_cast<const int*>(bt);
  p.out = out;
  p.Sq = C;
  p.Sk = past + C;
  p.H = H;
  p.K = K;
  p.causal = 1;
  p.q_off = past;
  p.ps_shift = 0;
  while ((1 << p.ps_shift) < ps) ++p.ps_shift;  // ps is a power of two here
  p.P = P;
  p.splits = splits;
  p.qs0 = 0;  // q is (C, H, hd) contiguous
  p.qs1 = static_cast<long long>(H) * hd;
  p.qs2 = hd;
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

// the tensor-core body (bf16 q, hd in {16, 64, 128}; see attention_tc.cuh)
extern "C" int paged_prefill_tc_bf16(const void* q, const void* kp, const void* vp,
                                     const void* bt, void* out, int C, int H, int K, int hd,
                                     int ps, int P, int past, int splits,
                                     long long ks0, long long ks1, long long ks2,
                                     long long vs0, long long vs1, long long vs2, float scale,
                                     void* stream) {
  const repro_torch::tc::Params p = paged_params(q, kp, vp, bt, out, C, H, K, hd, ps, P, past,
                                                 splits, ks0, ks1, ks2, vs0, vs1, vs2,
                                                 scale);
  return repro_torch::tc::launch<true, false>(p, K, hd, hd, stream);
}

extern "C" int paged_prefill_q8_tc_bf16(const void* q, const void* kp, const void* vp,
                                        const void* ksc, const void* vsc, const void* bt,
                                        void* out, int C, int H, int K, int hd, int ps, int P,
                                        int past, int splits, long long ks0,
                                        long long ks1, long long ks2,
                                        long long vs0, long long vs1, long long vs2,
                                        long long kss0, long long kss1, long long kss2,
                                        long long vss0, long long vss1, long long vss2,
                                        float scale, void* stream) {
  repro_torch::tc::Params p =
      paged_params(q, kp, vp, bt, out, C, H, K, hd, ps, P, past, splits,
                   ks0, ks1, ks2, vs0, vs1, vs2, scale);
  p.ksc = static_cast<const float*>(ksc);
  p.vsc = static_cast<const float*>(vsc);
  p.kss0 = kss0;
  p.kss1 = kss1;
  p.kss2 = kss2;
  p.vss0 = vss0;
  p.vss1 = vss1;
  p.vss2 = vss2;
  return repro_torch::tc::launch<true, true>(p, K, hd, hd, stream);
}
