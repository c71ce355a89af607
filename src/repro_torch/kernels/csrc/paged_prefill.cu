// Paged chunked-prefill attention for one request: C chunk queries attend
// causally to the request's paged history plus the chunk itself.
//
// Replaces: repro/kernels/paged_attention.py::paged_prefill_attention
// (Pallas, _paged_prefill_kernel), in both forms: fp pages and
// quantized=True (int8 pools plus f32 scale pools (P, ps, K)).
// Bound on the H100: a kv head's C*g query rows do ~C*g flops per bf16 K/V
// byte read, so the card's bf16 rate would bind only above C*g ~ 295 rows;
// at the serving widths (C = 64, g = 1 for stablelm, g = 6 for internlm2)
// the bound is bytes or near the ridge. This kernel does its products on the
// f32 CUDA cores (~67 TFLOP/s), so in practice its operations bind it.
// Design:
// - grid (K, ceil(C*g / BM)): the C*g query rows of one kv head (row r is
//   chunk token r / g, head kh*g + r % g) are cut into blocks of BM rows, so
//   the f32 accumulator of a block is BM x hd (32 KB at BM = 64, hd = 128)
//   instead of C*g x hd for the whole chunk;
// - each block visits only the pages its last row can see, j <= (past +
//   last_row / g) / ps, reading the block table for those pages only and
//   range-checking each page id;
// - `past` is a runtime argument, so one compiled kernel serves every
//   chunk offset;
// - the pool is read through its strides, token-major (P, ps, K, hd), and so
//   are the scale pools; int8 rows are dequantized into the f32 shared-memory
//   tile as float(int8) * scale[token, kv head], the TPU kernel's product;
// - the causal mask kpos <= past + r / g *replaces* scores by -1e30 and
//   sets the weights of masked slots to exactly 0, so a row whose causal
//   window has not started yet (m still -1e30) adds nothing; V rows at or
//   past ctx = past + C are zeroed (after dequantizing) before p.V, so NaN
//   or Inf in a slot's payload or scale cannot reach a live row (0 * NaN
//   guard);
// - online softmax across pages with an f32 accumulator in shared memory,
//   output acc / max(l, 1e-30), rounded once to q's dtype.
// No tensor cores, TMA or pipelining yet.
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
  const cudaError_t err = allow_smem(paged_prefill_kernel<T, TP>, smem);
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
