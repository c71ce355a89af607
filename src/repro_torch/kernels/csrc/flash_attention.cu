// GQA flash attention (prefill / full sequence), causal or bidirectional.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention
// (Pallas, _attn_kernel).
// Bound on the H100: a kv head's Sq*g query rows do ~4*Sq*g flops per K/V
// element pair (halved by the causal mask), so above Sq*g of a few hundred
// rows the bf16 tensor-core rate would bind; at the slot engine's prompt
// lengths it is near the ridge. This kernel does its products on the f32
// CUDA cores (~67 TFLOP/s), so in practice its operations bind it.
// Design:
// - the group is folded into the query rows as on the TPU (row r of kv head
//   kh is token r / g, head kh*g + r % g: token-major, group-minor), but the
//   folded rows are cut into blocks of a fixed BM rows, so a block's f32
//   accumulator is BM x hd_v (32 KB at BM = 64, hd_v = 128) whatever the
//   group size (block_q x g rows would be ~196 KB at g = 6, hd = 128);
// - grid (B * K, ceil(Sq * g / BM)); each block walks K/V in tiles of kTile
//   tokens; with `causal`, only up to its last row's token (tiles past the
//   block's end are skipped, as the TPU kernel skips kv blocks);
// - q, k and v are read through their strides ((B, S, heads, d), as the
//   model produces them), so no call transposes them (the JAX wrapper does);
// - hd and hd_v are runtime arguments up to 256 (MLA: 192 / 128);
// - masked scores (causal, and the ragged tail past Sk) are *replaced* by
//   -1e30, get weight exactly 0, and V rows past the tile's live range are
//   zeroed before p.V (0 * NaN guard);
// - online softmax with an f32 accumulator in shared memory; the output is
//   acc / max(l, 1e-30). Above 48 KB of shared memory the launcher raises
//   the kernel's cap (hd = 256 needs ~205 KB at BM = 64).
// No tensor cores, TMA or pipelining yet.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 32;  // K/V tokens staged per iteration

template <typename T>
__global__ void flash_attention_kernel(
    const T* __restrict__ q,   // (B, Sq, H, hd) via strides
    const T* __restrict__ k,   // (B, Sk, K, hd) via strides
    const T* __restrict__ v,   // (B, Sk, K, hd_v) via strides
    T* __restrict__ out,       // (B, Sq, H, hd_v) contiguous
    int Sq, int Sk, int H, int K, int hd, int hd_v, int causal, int BM,
    long long qs0, long long qs1, long long qs2, long long qs3,
    long long ks0, long long ks1, long long ks2, long long ks3,
    long long vs0, long long vs1, long long vs2, long long vs3,
    float scale) {
  extern __shared__ float smem[];
  const int g = H / K;
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int r0 = blockIdx.y * BM;
  const int rows = min(BM, Sq * g - r0);
  const int ld = hd + 1;  // padded row stride of q_s and k_s
  float* q_s = smem;                  // [BM][ld]
  float* k_s = q_s + BM * ld;         // [kTile][ld]
  float* v_s = k_s + kTile * ld;      // [kTile][hd_v]
  float* s_s = v_s + kTile * hd_v;    // [BM][kTile]  scores, then weights
  float* acc_s = s_s + BM * kTile;    // [BM][hd_v]
  float* m_s = acc_s + BM * hd_v;     // [BM]
  float* l_s = m_s + BM;              // [BM]
  float* a_s = l_s + BM;              // [BM]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const T* qb = q + b * qs0;
  for (int i = tid; i < rows * hd; i += nt) {
    const int r = i / hd;
    const int d = i % hd;
    const int row = r0 + r;
    const long long head = static_cast<long long>(kh) * g + row % g;
    q_s[r * ld + d] = to_f32(qb[(row / g) * qs1 + head * qs2 + d * qs3]) * scale;
  }
  for (int i = tid; i < rows * hd_v; i += nt) acc_s[i] = 0.f;
  for (int r = tid; r < rows; r += nt) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // causal: the block's last row sees tokens 0 .. its own token
  const int n_k = causal ? min(Sk, (r0 + rows - 1) / g + 1) : Sk;
  const T* kb = k + b * ks0 + kh * ks2;
  const T* vb = v + b * vs0 + kh * vs2;
  for (int t0 = 0; t0 < n_k; t0 += kTile) {
    const int n = min(kTile, n_k - t0);  // live tokens of this tile
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

    for (int i = tid; i < rows * kTile; i += nt) {
      const int r = i / kTile;
      const int t = i % kTile;
      const int qpos = (r0 + r) / g;
      const bool live = t < n && (!causal || t0 + t <= qpos);
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += q_s[r * ld + d] * k_s[t * ld + d];
      s_s[i] = live ? dot : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < rows; r += nt) {
      const int qpos = (r0 + r) / g;
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, s_s[r * kTile + t]);
      float sum = 0.f;
      for (int t = 0; t < kTile; ++t) {
        const bool live = t < n && (!causal || t0 + t <= qpos);
        const float p = live ? expf(s_s[r * kTile + t] - m_new) : 0.f;
        s_s[r * kTile + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < rows * hd_v; i += nt) {
      const int r = i / hd_v;
      const int d = i % hd_v;
      float acc = acc_s[i] * a_s[r];
      for (int t = 0; t < n; ++t) acc += s_s[r * kTile + t] * v_s[t * hd_v + d];
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * hd_v; i += nt) {
    const int r = i / hd_v;
    const int d = i % hd_v;
    const int row = r0 + r;
    const size_t head = static_cast<size_t>(kh) * g + row % g;
    const size_t tok = static_cast<size_t>(b) * Sq + row / g;
    out[(tok * H + head) * hd_v + d] = from_f32<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int K, int hd, int hd_v, int causal, int BM, long long qs0, long long qs1,
           long long qs2, long long qs3, long long ks0, long long ks1, long long ks2,
           long long ks3, long long vs0, long long vs1, long long vs2, long long vs3,
           float scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const int g = H / K;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(BM * (hd + 1) + kTile * (hd + 1) + kTile * hd_v +
                                          BM * kTile + BM * hd_v + 3 * BM);
  const cudaError_t err = allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * K, (Sq * g + BM - 1) / BM);
  flash_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, K, hd, hd_v, causal, BM, qs0, qs1, qs2, qs3, ks0, ks1,
      ks2, ks3, vs0, vs1, vs2, vs3, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

#define REPRO_FLASH_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, int B,       \
                      int Sq, int Sk, int H, int K, int hd, int hd_v, int causal, int BM,  \
                      long long qs0, long long qs1, long long qs2, long long qs3,          \
                      long long ks0, long long ks1, long long ks2, long long ks3,          \
                      long long vs0, long long vs1, long long vs2, long long vs3,          \
                      float scale, void* stream) {                                         \
    return repro_torch::launch<T>(q, k, v, out, B, Sq, Sk, H, K, hd, hd_v, causal, BM, qs0, \
                                  qs1, qs2, qs3, ks0, ks1, ks2, ks3, vs0, vs1, vs2, vs3,   \
                                  scale, stream);                                          \
  }

REPRO_FLASH_ENTRY(flash_attention_f32, float)
REPRO_FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
