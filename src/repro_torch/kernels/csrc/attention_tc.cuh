// The tensor-core body of the two prefill attention kernels (bf16).
//
// One CTA of 4 warps owns 64 folded query rows of one kv head (row r is
// token r / g of head kh*g + r % g), 16 rows a warp, and walks the keys in
// tiles of 64 tokens (FlashAttention-2's shape):
// - Q is read once, straight from global memory through its strides, into
//   registers as mma A-fragments (bf16, unscaled);
// - K/V tiles are staged in shared memory by cp.async, 16 bytes a thread, in
//   a ring of kStages = 3 stages, so two tiles load while one is used (the
//   first two are in flight before Q is read); at 192 / 128 a ring of
//   kWideStages = 2, one tile loading while one is used. Each thread's copy
//   addresses are computed once (Copier), so a tile's copies cost a
//   multiply and one cp.async a 16-byte chunk. Rows are stored with their
//   16-byte chunks XOR-swizzled by the row, so ldmatrix (and ldmatrix.trans
//   for V) reads them free of bank conflicts. A token at or past the CTA's
//   last visible key is never read: its copy has a source size of 0, which
//   zero-fills the row, so garbage (even NaN) past Sk / ctx never reaches
//   shared memory;
// - S = Q.K^T on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate), scaled in f32 after the product with log2(e) folded in;
// - on a tile that crosses the diagonal or the tail (one branch a tile),
//   masked scores are *replaced* by -1e30 and masked weights set to exactly
//   0 by select, one compare an element against the row's end of live keys;
// - online softmax in registers: row max and row sum across the 4 lanes
//   that share a row (__shfl_xor_sync), ex2.approx; the weights P are
//   rounded to bf16 A-fragments in registers (the one rounding the f32
//   reference does not make, as SDPA does) and O += P.V runs on the tensor
//   cores into an f32 accumulator held in registers;
// - output acc / max(l, 1e-30), rounded once to bf16.
// int8 pages (Q8): the int8 bytes are staged as they are (cp.async) and
// widened to bf16 in shared memory (exact: |x| <= 127); the scales are never
// rounded: column t's score is multiplied by k_scale[t] in f32 after the
// mma, and the weight by v_scale[t] in f32 before it is rounded for P.V (the
// row sum takes the unscaled weight). Dead slots' scales are zero-filled
// like their payloads and the scaled weight is selected, so a NaN, Inf or
// 1e30 scale of a dead slot meets a select, never a product that survives.
// Splits: grid (B*K, row blocks, splits), splits in {1, 2, 4, 8}. With
// splits > 1, split s walks the s-th of `splits` equal runs of whole tiles
// of the row block's visible keys, and the splits of a row block run as
// one thread-block cluster: each leaves its f32 partials (unnormalized O,
// m and l in the log2 domain) in its shared memory, and they merge them
// through distributed shared memory and round once; no scratch, one launch.
// LSE (flash, for the backward kernel; null otherwise): with p.lse set, the
// CTA that writes a row also writes its natural-log log-sum-exp, f32
// (B, H, Sq): (m + log2(l)) * ln 2 from the log2-domain running max m and
// sum l (the merged M and L with splits); +inf for a row with no live key.
// What bounds it on the H100 (chip_smoke.py, PERF.md): a warp that runs
// alone on its scheduler waits on its own copies, products and exps, so a
// 64-token tile costs ~1 us to a lone CTA; the bytes bound of a call is
// ~1-6 us.
// Head dims: the body is templated on <HD, HDV>, q's and k's width and v's
// (and the output's). The paged prefill and flash at hd == hd_v take HD ==
// HDV in {16, 64, 128}; flash also takes MLA's (192, 128) (DeepSeek-V2-Lite).
// There a K row is 24 16-byte chunks and a V row 16, so a thread copies one
// chunk lane of 8 (three chunks of a K row, two of a V row; Copier), K and V
// keep their own swizzled tiles (24 + 16 KB a stage), S = Q.K^T takes 12
// k-steps over the 48 registers of Q's fragments, and O is 16 column blocks
// of 8. What bounds it at 192 / 128 (DeepSeek-V2-Lite's prefill, B = 1,
// Sq = Sk = 512, H = K = 16): its bytes, 0.0031 ms, against 0.0014 ms of
// products; 8 row blocks x 16 heads are 128 CTAs, one a SM, so a lone CTA's
// latency sets the time (~16 us: 8 key tiles of 64 for the longest row
// block). The ring keeps kWideStages = 2 stages of 40 KB (80 KB, 245
// registers, no spill: two CTAs a SM where 3 stages' 120 KB left one): the
// same time there, and 28 % less at the training shape's 1024 CTAs (B = 4,
// S = 1024; tools/flash_mla_variants.py).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace tc {
namespace {  // each source instantiates its own copy

namespace cg = cooperative_groups;

constexpr int kRows = 64;     // folded query rows per CTA, 16 per warp
constexpr int kTok = 64;      // K/V tokens per tile
constexpr int kThreads = 128; // 4 warps
constexpr int kStages = 3;    // K/V tiles in flight at hd == hd_v: the ring's depth
constexpr int kWideStages = 2;  // ... at MLA's 192 / 128 (40 KB a stage; see above)
constexpr int kMaxSplits = 8; // context splits of a row block: one cluster
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;        // (B, Sq, H, hd) through (qs0, qs1, qs2), inner stride 1
  const void* k;        // flash: (B, Sk, K, hd); paged: (P, ps, K, hd) pool
  const void* v;
  const float* ksc;     // Q8: (P, ps, K) scale pools through their strides
  const float* vsc;
  const int* bt;        // paged: the request's block table
  void* out;            // (B, Sq, H, hd_v) contiguous bf16
  float* lse;           // flash: (B, H, Sq) f32 row log-sum-exp, or null
  int Sq, Sk, H, K, causal, q_off, ps_shift, P, splits;  // page size 1 << ps_shift
  long long qs0, qs1, qs2;
  long long ks0, ks1, ks2;  // flash: (batch, token, head); paged: (page, slot, head)
  long long vs0, vs1, vs2;
  long long kss0, kss1, kss2, vss0, vss1, vss2;
  float scale_log2;         // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a source size of 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(live ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (x <= 0 here; -1e30 gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += a.b: one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// natural-log LSE of a row from its log2-domain max and sum
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : __int_as_float(0x7f800000);
}

// Element offset of 16-byte chunk c of row t in a swizzled bf16 tile
// [kTok][HD]: the chunk index is XORed with the row's low bits, so the 8
// rows an ldmatrix phase reads fall on 8 different bank groups.
template <int HD>
__device__ __forceinline__ int swz(int t, int c) {
  constexpr int kChunks = HD / 8;
  constexpr int kMask = (kChunks < 8 ? kChunks : 8) - 1;
  return t * HD + ((c ^ (t & kMask)) << 3);
}

template <int HD, int HDV, bool Q8>
struct Smem {
  static_assert(!Q8 || HD == HDV, "int8 pages: one head dim");
  static constexpr int kTileK = kTok * HD;   // elements of a K tile
  static constexpr int kTileV = kTok * HDV;  // ... of a V tile
  static constexpr int kRing = HD == HDV ? kStages : kWideStages;  // stages of the ring
  // bf16 pages: the ring holds bf16 K and V tiles, read by ldmatrix in place.
  // int8 pages: the ring holds the raw int8 tiles and the tiles' scales; one
  // bf16 K/V tile and one copy of the scales serve the products.
  static constexpr size_t kStage = Q8 ? kTileK + kTileV + 2 * kTok * sizeof(float)
                                      : (kTileK + kTileV) * sizeof(__nv_bfloat16);
  static constexpr size_t kWide = Q8 ? (kTileK + kTileV) * sizeof(__nv_bfloat16)
                                         + 2 * kTok * sizeof(float)
                                     : 0;
  static constexpr size_t kBytes = kRing * kStage + kWide;
};

// 16-byte chunks of a row that one thread of a copy plan handles side by
// side with its neighbours: the largest power of two (at most 16) dividing
// both rows' chunk counts, so K's and V's rows share one plan (8 at 192 /
// 128: 24 and 16 chunks)
__host__ __device__ constexpr int chunk_lanes(int a, int b) {
  int l = 16;
  while (a % l || b % l) l /= 2;
  return l;
}

// One thread's share of a key tile's copies: chunk lane `c` of rows
// t_first, t_first + kRowStep, ... of K and of V (chunks c, c + kLanes, ...
// of each row), whose addresses in the first token (or page slot) are
// computed once, so a tile's copies cost a multiply and one cp.async a chunk.
// Tokens at or past `limit` are zero-filled without a read; paged positions
// map through the block table, whose entries are range-checked (a bad page
// id traps) as they are read.  int8 pages: each thread also copies one scale
// of the tile (K's for the first kTok threads, V's for the others).
template <int HD, int HDV, bool PAGED, bool Q8>
struct Copier {
  using TP = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  static constexpr int kPer = 16 / static_cast<int>(sizeof(TP));  // elements a chunk
  static constexpr int kLanes = chunk_lanes(HD / kPer, HDV / kPer);
  static constexpr int kSegsK = HD / kPer / kLanes;                 // chunks a lane, K
  static constexpr int kSegsV = HDV / kPer / kLanes;                // ... V
  static constexpr int kRowStep = kThreads / kLanes;
  static constexpr int kRowsPer = (kTok + kRowStep - 1) / kRowStep;
  static constexpr uint32_t kTensorK = kTok * HD * sizeof(TP);  // bytes of K a stage
  static constexpr uint32_t kTensor = kTensorK + kTok * HDV * sizeof(TP);
  static_assert(kThreads % kLanes == 0 && kRowStep % 8 == 0, "copy plan");
  // a lane's later chunks keep the swizzle's XOR in the low 3 bits of the chunk
  static_assert((kSegsK == 1 && kSegsV == 1) || kLanes >= 8, "copy plan");
  static_assert(!Q8 || kThreads == 2 * kTok, "one scale a thread");

  const TP* k;
  const TP* v;
  long long k_row, v_row;    // flash: token strides; paged: slot strides
  long long k_page, v_page;  // paged: page strides
  const int* bt;
  int ps_shift, P, t_first;
  uint32_t dst_k, dst_v;     // byte offsets of the first row's chunks in a stage
  const float* sc;           // int8 pages: this thread's scale pool at head kh
  long long sc_page, sc_row;
  uint32_t sc_dst;

  __device__ __forceinline__ Copier(const Params& p, int b, int kh) {
    const int c = threadIdx.x % kLanes;
    t_first = threadIdx.x / kLanes;
    k = static_cast<const TP*>(p.k) + kh * p.ks2 + c * kPer + (PAGED ? 0 : b * p.ks0);
    v = static_cast<const TP*>(p.v) + kh * p.vs2 + c * kPer + (PAGED ? 0 : b * p.vs0);
    k_row = p.ks1;
    v_row = p.vs1;
    k_page = p.ks0;
    v_page = p.vs0;
    bt = p.bt;
    ps_shift = p.ps_shift;
    P = p.P;
    dst_k = Q8 ? t_first * HD + c * kPer : 2 * swz<HD>(t_first, c);
    dst_v = kTensorK + (Q8 ? t_first * HDV + c * kPer : 2 * swz<HDV>(t_first, c));
    if constexpr (Q8) {
      const bool is_v = threadIdx.x >= kTok;
      sc = is_v ? p.vsc + kh * p.vss2 : p.ksc + kh * p.kss2;
      sc_page = is_v ? p.vss0 : p.kss0;
      sc_row = is_v ? p.vss1 : p.kss1;
      sc_dst = kTensor + threadIdx.x * sizeof(float);
    }
  }

  // token `pos` (live) -> offsets of its row: flash (token), paged (page, slot)
  __device__ __forceinline__ void where(int pos, long long& ko, long long& vo) const {
    if constexpr (PAGED) {
      const int page = bt[pos >> ps_shift];
      if (page < 0 || page >= P) __trap();
      const int slot = pos & ((1 << ps_shift) - 1);
      ko = page * k_page + slot * k_row;
      vo = page * v_page + slot * v_row;
    } else {
      ko = pos * k_row;
      vo = pos * v_row;
    }
  }

  __device__ __forceinline__ void issue(uint32_t stage, int tile, int limit) const {
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j) {
      const int t = t_first + j * kRowStep;
      if (kRowsPer * kRowStep > kTok && t >= kTok) break;
      const int pos = tile * kTok + t;
      const bool live = pos < limit;
      long long ko = 0, vo = 0;
      if (live) where(pos, ko, vo);
      const uint32_t dk = stage + dst_k + j * kRowStep * HD * sizeof(TP);
      const uint32_t dv = stage + dst_v + j * kRowStep * HDV * sizeof(TP);
#pragma unroll
      for (int s = 0; s < kSegsK; ++s)
        cp_async16(dk + s * kLanes * 16, k + ko + s * kLanes * kPer, live);
#pragma unroll
      for (int s = 0; s < kSegsV; ++s)
        cp_async16(dv + s * kLanes * 16, v + vo + s * kLanes * kPer, live);
    }
    if constexpr (Q8) {
      const int pos = tile * kTok + threadIdx.x % kTok;
      const bool live = pos < limit;
      long long off = 0;
      if (live) {
        const int page = bt[pos >> ps_shift];
        if (page < 0 || page >= P) __trap();
        off = page * sc_page + (pos & ((1 << ps_shift) - 1)) * sc_row;
      }
      cp_async4(stage + sc_dst, sc + off, live);
    }
  }
};

// int8 pages: widen the staged int8 tiles to the swizzled bf16 tiles and
// copy the scales beside them (so the next copies into the ring may start).
template <int HD>
__device__ __forceinline__ void widen_tile(const unsigned char* stage, unsigned char* wide) {
  const int8_t* src = reinterpret_cast<const int8_t*>(stage);
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(wide);
  constexpr int kChunks = HD / 8;                    // 8-element chunks a row
  constexpr int kIters = 2 * kTok * kChunks / kThreads;
  static_assert(2 * kTok * kChunks % kThreads == 0, "widen plan");
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int which = i / (kTok * kChunks);  // 0: K, 1: V
    const int r = i - which * kTok * kChunks;
    const int t = r / kChunks;
    const int c = r - t * kChunks;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + which * kTok * HD + t * HD + c * 8);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint4 packed;
    packed.x = pack_bf16(static_cast<float>(x[0]), static_cast<float>(x[1]));
    packed.y = pack_bf16(static_cast<float>(x[2]), static_cast<float>(x[3]));
    packed.z = pack_bf16(static_cast<float>(x[4]), static_cast<float>(x[5]));
    packed.w = pack_bf16(static_cast<float>(x[6]), static_cast<float>(x[7]));
    *reinterpret_cast<uint4*>(dst + which * kTok * HD + swz<HD>(t, c)) = packed;
  }
  const float* sc = reinterpret_cast<const float*>(src + 2 * kTok * HD);
  float* wsc = reinterpret_cast<float*>(dst + 2 * kTok * HD);
  wsc[threadIdx.x] = sc[threadIdx.x];  // 2 * kTok scales, one a thread
}

template <int HD, int HDV, bool PAGED, bool Q8>
__global__ void __launch_bounds__(kThreads) attention_tc_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  using S = Smem<HD, HDV, Q8>;
  constexpr int kStages = S::kRing;
  constexpr int kKSteps = HD / 16;  // k-steps of S = Q.K^T
  constexpr int kNB = kTok / 8;     // 8-token column blocks of S
  constexpr int kDB = HDV / 8;      // 8-wide column blocks of O
  // ldmatrix runs one k-step ahead of the products at hd 128 (its longer
  // product chains leave latency to hide); at 64 and 16 the extra registers
  // cost more than they hide (chip_smoke.py timings, PERF.md)
  constexpr int kAhead = HD >= 128 ? 1 : 0;

  const int g = p.H / p.K;
  const int causal = p.causal;
  const float scale_log2 = p.scale_log2;
  const int bk = blockIdx.x;
  const int b = bk / p.K;
  const int kh = bk - b * p.K;
  const int rb = gridDim.y - 1 - blockIdx.y;  // the longest causal blocks launch first
  const int n_rows = p.Sq * g;
  const int r0 = rb * kRows;
  const int rows = min(kRows, n_rows - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;

  // keys the CTA's last row sees, and this split's tiles of them
  const int last_tok = (r0 + rows - 1) / g;
  const int limit = causal ? min(p.Sk, p.q_off + last_tok + 1) : p.Sk;
  const int n_tiles = (limit + kTok - 1) / kTok;
  const int tps = (n_tiles + p.splits - 1) / p.splits;
  const int tb = blockIdx.z * tps;
  const int te = min(n_tiles, tb + tps);

  // this thread's two rows (A: lane / 4, B: lane / 4 + 8 of the warp's 16)
  const int rA = r0 + warp * 16 + (lane >> 2);
  const int rB = rA + 8;
  // key pos is live for row A iff pos < endA (causal window and tail)
  const int endA = causal ? min(limit, p.q_off + rA / g + 1) : limit;
  const int endB = causal ? min(limit, p.q_off + rB / g + 1) : limit;
  // a tile that ends at or before the warp's first row's end needs no mask
  const int end_warp = causal ? min(limit, p.q_off + (r0 + warp * 16) / g + 1) : limit;

  float o[kDB][4];
#pragma unroll
  for (int j = 0; j < kDB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;

  // the first kStages - 1 tiles go in flight before Q is read
  const Copier<HD, HDV, PAGED, Q8> copier(p, b, kh);
  const uint32_t ring = smem_addr(tc_smem);
  unsigned char* wide = tc_smem + kStages * S::kStage;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (tb + i < te) copier.issue(ring + i * S::kStage, tb + i, limit);
    cp_async_commit();
  }

  uint32_t qf[kKSteps][4];
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    const __nv_bfloat16* qa = nullptr;
    const __nv_bfloat16* qb = nullptr;
    if (rA < n_rows)
      qa = q + b * p.qs0 + static_cast<long long>(rA / g) * p.qs1 +
           static_cast<long long>(kh * g + rA % g) * p.qs2;
    if (rB < n_rows)
      qb = q + b * p.qs0 + static_cast<long long>(rB / g) * p.qs1 +
           static_cast<long long>(kh * g + rB % g) * p.qs2;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const int col = kk * 16 + quad * 2;
      qf[kk][0] = qa ? *reinterpret_cast<const uint32_t*>(qa + col) : 0u;
      qf[kk][1] = qb ? *reinterpret_cast<const uint32_t*>(qb + col) : 0u;
      qf[kk][2] = qa ? *reinterpret_cast<const uint32_t*>(qa + col + 8) : 0u;
      qf[kk][3] = qb ? *reinterpret_cast<const uint32_t*>(qb + col + 8) : 0u;
    }
  }

  // ldmatrix lane roles: matrix m = lane / 8, its row lane % 8
  const int lm = lane >> 3;
  const int lr = lane & 7;

  for (int tile = tb; tile < te; ++tile) {
    const int st = (tile - tb) % kStages;
    unsigned char* stage = tc_smem + st * S::kStage;
    if (tile + kStages - 1 < te)
      copier.issue(ring + (st == 0 ? kStages - 1 : st - 1) * S::kStage, tile + kStages - 1, limit);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this tile's copies have landed
    __syncthreads();
    const __nv_bfloat16* kt;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (Q8) {
      widen_tile<HD>(stage, wide);
      __syncthreads();
      kt = reinterpret_cast<const __nv_bfloat16*>(wide);
      ksc = reinterpret_cast<const float*>(kt + S::kTileK + S::kTileV);
      vsc = ksc + kTok;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(stage);
    }
    const __nv_bfloat16* vt = kt + S::kTileK;
    const int t0 = tile * kTok;

    // S = Q.K^T (16 x 64 per warp).  Each k-step's K fragments are loaded
    // together, kAhead k-steps before their products.
    float s[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t k_base = smem_addr(kt);
    uint32_t kf[2][kNB / 2][4];
#pragma unroll
    for (int kk = -kAhead; kk < kKSteps; ++kk) {
      if (kk + kAhead < kKSteps) {
#pragma unroll
        for (int n2 = 0; n2 < kNB / 2; ++n2) {
          uint32_t(&f)[4] = kf[(kk + kAhead) & 1][n2];
          ldsm_x4(k_base + 2 * swz<HD>(n2 * 16 + (lm >> 1) * 8 + lr, 2 * (kk + kAhead) + (lm & 1)),
                  f[0], f[1], f[2], f[3]);
        }
      }
      if (kk < 0) continue;
#pragma unroll
      for (int n2 = 0; n2 < kNB / 2; ++n2) {
        const uint32_t(&f)[4] = kf[kk & 1][n2];
        mma_bf16(s[2 * n2], qf[kk], f[0], f[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], f[2], f[3]);
      }
    }

    // scale (and dequantize) in f32; on a tile that crosses the diagonal or
    // the tail, masked scores are replaced by -1e30 (select, not add)
    const bool masked = t0 + kTok > end_warp;
    const int col = t0 + quad * 2;  // this thread's first key column
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      float2 f = make_float2(scale_log2, scale_log2);
      if constexpr (Q8) {
        f = *reinterpret_cast<const float2*>(ksc + j * 8 + quad * 2);
        f.x *= scale_log2;
        f.y *= scale_log2;
      }
      s[j][0] *= f.x;
      s[j][1] *= f.y;
      s[j][2] *= f.x;
      s[j][3] *= f.y;
    }
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = col + j * 8 + (e & 1) < (e < 2 ? endA : endB) ? s[j][e] : kNegInf;
      }
    }
    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      mxA = fmaxf(mxA, fmaxf(s[j][0], s[j][1]));
      mxB = fmaxf(mxB, fmaxf(s[j][2], s[j][3]));
    }
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
    const float mA_new = fmaxf(mA, mxA);
    const float mB_new = fmaxf(mB, mxB);
    const float alphaA = exp2_approx(mA - mA_new);
    const float alphaB = exp2_approx(mB - mB_new);
    mA = mA_new;
    mB = mB_new;

    // weights: masked ones exactly 0 (select); int8 pages scale them by
    // v_scale in f32 (the row sum takes the unscaled weight) and select the
    // scaled weight too; P rounded once to bf16 A-fragments
    float w[kNB][4];
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] = exp2_approx(s[j][e] - (e < 2 ? mA_new : mB_new));
    }
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[j][e] = col + j * 8 + (e & 1) < (e < 2 ? endA : endB) ? w[j][e] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      sumA += w[j][0] + w[j][1];
      sumB += w[j][2] + w[j][3];
    }
    if constexpr (Q8) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float2 f = *reinterpret_cast<const float2*>(vsc + j * 8 + quad * 2);
        w[j][0] *= f.x;
        w[j][1] *= f.y;
        w[j][2] *= f.x;
        w[j][3] *= f.y;
      }
      if (masked) {
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[j][e] = col + j * 8 + (e & 1) < (e < 2 ? endA : endB) ? w[j][e] : 0.f;
        }
      }
    }
    uint32_t pa[kTok / 16][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      pa[j >> 1][(j & 1) * 2] = pack_bf16(w[j][0], w[j][1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(w[j][2], w[j][3]);
    }
    lA = lA * alphaA + sumA;
    lB = lB * alphaB + sumB;
#pragma unroll
    for (int j = 0; j < kDB; ++j) {
      o[j][0] *= alphaA;
      o[j][1] *= alphaA;
      o[j][2] *= alphaB;
      o[j][3] *= alphaB;
    }

    // O += P.V (V through ldmatrix.trans: k = tokens, n = head dims), the
    // V fragments of each 16-token step loaded kAhead steps early
    const uint32_t v_base = smem_addr(vt);
    uint32_t vf[2][kDB / 2][4];
#pragma unroll
    for (int kk = -kAhead; kk < kTok / 16; ++kk) {
      if (kk + kAhead < kTok / 16) {
#pragma unroll
        for (int d2 = 0; d2 < kDB / 2; ++d2) {
          uint32_t(&f)[4] = vf[(kk + kAhead) & 1][d2];
          ldsm_x4_t(v_base + 2 * swz<HDV>((kk + kAhead) * 16 + (lm & 1) * 8 + lr,
                                          2 * d2 + (lm >> 1)),
                    f[0], f[1], f[2], f[3]);
        }
      }
      if (kk < 0) continue;
#pragma unroll
      for (int d2 = 0; d2 < kDB / 2; ++d2) {
        const uint32_t(&f)[4] = vf[kk & 1][d2];
        mma_bf16(o[2 * d2], pa[kk], f[0], f[1]);
        mma_bf16(o[2 * d2 + 1], pa[kk], f[2], f[3]);
      }
    }
    if constexpr (!Q8) __syncthreads();  // the next tile's copies reuse this stage
  }

  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);

  if (p.splits == 1) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    const float dA = fmaxf(lA, 1e-30f);
    const float dB = fmaxf(lB, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rB : rA;
      if (r >= n_rows) continue;
      const float inv = 1.f / (half ? dB : dA);
      const long long tok = static_cast<long long>(b) * p.Sq + r / g;
      __nv_bfloat16* dst = out + (tok * p.H + kh * g + r % g) * HDV + quad * 2;
#pragma unroll
      for (int j = 0; j < kDB; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
      if (p.lse != nullptr && quad == 0)
        p.lse[(static_cast<long long>(b) * p.H + kh * g + r % g) * p.Sq + r / g] =
            row_lse(half ? mB : mA, half ? lB : lA);
    }
  } else {
    // the splits of one row block form a thread-block cluster: each writes
    // its partial rows (unnormalized O, m and l) to its own shared memory,
    // then each merges every split-th row through distributed shared memory
    // and writes it: out = sum_s O_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30)
    static_assert(kRows * HDV * sizeof(float) + 2 * kRows * sizeof(float) <= S::kBytes,
                  "the partials must fit where the ring was");
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    float* part = reinterpret_cast<float*>(tc_smem);  // [kRows][HDV]
    float* pm = part + kRows * HDV;                    // [kRows]
    float* pl = pm + kRows;                            // [kRows]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = warp * 16 + (lane >> 2) + half * 8;
      float* dst = part + lr * HDV + quad * 2;
#pragma unroll
      for (int j = 0; j < kDB; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[j][2 * half], o[j][2 * half + 1]);
      if (quad == 0) {
        pm[lr] = half ? mB : mA;
        pl[lr] = half ? lB : lA;
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = blockIdx.z;  // the cluster spans z: its block rank
    const int n_mine = (rows - rank + p.splits - 1) / p.splits;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    for (int i = threadIdx.x; i < n_mine * (HDV / 4); i += kThreads) {
      const int lr = rank + (i / (HDV / 4)) * p.splits;
      const int d4 = i % (HDV / 4);
      // every split's (m, l, 4 dims of O) in flight at once, then merged
      float m[kMaxSplits], l[kMaxSplits];
      float4 x[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < p.splits) {
          m[s] = *cluster.map_shared_rank(pm + lr, s);
          l[s] = *cluster.map_shared_rank(pl + lr, s);
          x[s] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part + lr * HDV + d4 * 4, s));
        }
      }
      float M = kNegInf;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < p.splits) M = fmaxf(M, m[s]);
      float L = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < p.splits) {
          const float w = exp2_approx(m[s] - M);
          L += l[s] * w;
          acc.x += x[s].x * w;
          acc.y += x[s].y * w;
          acc.z += x[s].z * w;
          acc.w += x[s].w * w;
        }
      }
      const float inv = 1.f / fmaxf(L, 1e-30f);
      const int r = r0 + lr;
      const long long tok = static_cast<long long>(b) * p.Sq + r / g;
      __nv_bfloat16* dst = out + (tok * p.H + kh * g + r % g) * HDV + d4 * 4;
      reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
      reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
      if (p.lse != nullptr && d4 == 0)
        p.lse[(static_cast<long long>(b) * p.H + kh * g + r % g) * p.Sq + r / g] = row_lse(M, L);
    }
    cluster.sync();  // no block leaves while another still reads its partials
  }
}

template <int HD, int HDV, bool PAGED, bool Q8>
int launch_hd(const Params& p, int BK, cudaStream_t stream) {
  using S = Smem<HD, HDV, Q8>;
  static size_t granted[kMaxDevices] = {};
  cudaError_t err = allow_smem(attention_tc_kernel<HD, HDV, PAGED, Q8>, S::kBytes, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = p.Sq * (p.H / p.K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BK, (n_rows + kRows - 1) / kRows, p.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;  // the splits of a row block: one cluster
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_tc_kernel<HD, HDV, PAGED, Q8>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch the body for head dims (hd, hd_v): (16, 16), (64, 64), (128, 128)
// and, flash only, MLA's (192, 128); the wrappers route no other pair here.
// B*K CTAs across, row blocks down, p.splits deep.
template <bool PAGED, bool Q8>
int launch(const Params& p, int BK, int hd, int hd_v, void* stream) {
  if (BK == 0 || p.Sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == hd_v) {
    switch (hd) {
      case 16: return launch_hd<16, 16, PAGED, Q8>(p, BK, s);
      case 64: return launch_hd<64, 64, PAGED, Q8>(p, BK, s);
      case 128: return launch_hd<128, 128, PAGED, Q8>(p, BK, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if constexpr (!PAGED && !Q8) {
    if (hd == 192 && hd_v == 128) return launch_hd<192, 128, false, false>(p, BK, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace tc
}  // namespace repro_torch
