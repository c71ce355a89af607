// The split-context body of the two decode attention kernels
// (flash-decoding on Hopper): one query token per row over a slot cache
// or a paged pool, fp or int8 pages, f32 or bf16 queries, f32 softmax.
//
// Grid (B * K * row groups, splits): CTA (row b, kv head kh, row group rg,
// split s) holds a group of the head's g query rows and walks the s-th of
// `splits` equal runs of whole kTile-token tiles of row b's visible keys, a
// run it computes from lens[b] on the device (the host never reads a
// length). Its kWarps warps walk that run side by side, each in stages of
// key rows that a per-warp cp.async ring keeps in flight (16 bytes a copy,
// rows at or past the length zero-filled and never read); on paged pools
// the run's block-table entries are staged in shared memory first
// (range-checked: a bad page id traps), so no copy waits on a dependent
// global load. Two forms of the products:
// - CUDA cores (f32 queries, and bf16 with g <= 2): up to G = 4 query rows
//   a CTA (larger groups take row groups of 4), pre-scaled by scale *
//   log2(e) in registers; a lane holds 16 bytes of a key row (8 for int8 at
//   G = 4), a score is its partial product plus a __shfl_xor_sync reduction
//   over the row's lanes, and the online softmax (m, l and the f32 output
//   slice) lives in registers, one rescale a stage;
// - tensor cores (bf16 queries with g >= 3): up to 16 query rows a CTA (one
//   m16n8k16 A operand, held in registers for the whole run); a stage of
//   16 keys is S = Q.K^T and O += P.V by mma.sync (bf16 in, f32
//   accumulate) through ldmatrix on rows padded 16 bytes apart (free of
//   bank conflicts); int8 rows are widened exactly to bf16 in shared memory
//   first. S is scaled in f32 after the product; P is rounded once to bf16
//   for P.V, as in the prefill body (attention_tc.cuh).
// At the end the warps merge their f32 partials (unnormalised O, m and l in
// the log2 domain) in shared memory, and with splits > 1 the CTAs of one
// (b, kh, rg) run as one thread-block cluster that merges through
// distributed shared memory: one launch, no scratch.
// Safety, as the bodies it replaces:
// - the caches, pools and scale pools are read through their strides
//   (inner stride 1), so a layer view of a stacked pool goes in as is;
// - a key at or past the length (or past its split's run) is never read:
//   its staged bytes are zero, its score is *replaced* by -1e30 and its
//   weight *selected* to 0, so NaN or Inf in a dead slot or cache tail
//   cannot reach the output; no block-table entry past ceil(len / ps) is
//   read, and a length the table cannot cover traps;
// - int8 pages: the int8 values are widened exactly; each live token's
//   k-scale and v-scale is staged once; the score is scaled by k_scale
//   after the product, the weight by v_scale in f32 (the row sum takes the
//   unscaled weight) and the scaled weight is selected, so NaN, Inf or
//   1e30 scales of dead slots meet a select;
// - length 0 (or an empty split) leaves m = -1e30, l = 0, and the output
//   acc / max(l, 1e-30) is 0, rounded once to q's dtype.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_tc.cuh"
#include "common.cuh"

namespace repro_torch {
namespace split {
namespace {  // each source instantiates its own copy

namespace cg = cooperative_groups;

constexpr int kWarps = 8;      // a CTA's warps, side by side on one run of keys
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;      // tokens: a split walks a run of whole tiles
constexpr int kMaxSplits = 8;  // one cluster (the portable cluster size)
constexpr int kBtChunk = 256;  // block-table entries a CTA stages at a time
constexpr int kTcRows = 16;    // query rows of the tensor-core form (one mma M)

struct Params {
  const void* q;     // (B, H, hd) contiguous
  const void* k;     // slot: (B, S, K, hd) cache; paged: (P, ps, K, hd) pool
  const void* v;     //   both through (s0, s1, s2), inner stride 1
  const float* ksc;  // int8 pages: (P, ps, K) scale pools through their strides
  const float* vsc;
  const int* bt;     // paged: (B, npp) block tables
  const int* lens;   // (B,)
  void* out;         // (B, H, hd) contiguous, q's dtype
  int H, K, cap, ps, npp, P, splits;  // cap: S_max (slot) or npp * ps (paged)
  long long ks0, ks1, ks2, vs0, vs1, vs2;
  long long kss0, kss1, kss2, vss0, vss1, vss2;
  float scale_log2;  // scale * log2(e)
};

// How a warp of the CUDA-core form covers key rows of HD elements of TP
// with G query rows.
template <int HD, int G, typename TP>
struct Plan {
  static constexpr bool kQ8 = std::is_same<TP, int8_t>::value;
  // compute: a lane holds kVec elements of a row (16 bytes; 8 for int8 at
  // G > 2, to bound the registers of q and the accumulator)
  static constexpr int kVec = kQ8 ? (G <= 2 ? 16 : 8) : 16 / static_cast<int>(sizeof(TP));
  static constexpr int kVecBytes = kVec * static_cast<int>(sizeof(TP));
  static constexpr int kLanes = HD / kVec;   // lanes that share a key row
  static constexpr int kRows = 32 / kLanes;  // key rows a warp reads at once
  static constexpr int kU = 4;               // ... of a stage, per lane group
  static constexpr int kStageRows = kU * kRows;
  // copies: 16-byte cp.async chunks, a row's K chunks then its V chunks
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(TP));
  static constexpr int kPitch = 2 * kRowBytes;  // a staged row: K then V
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kScaleOff = kStageRows * kPitch;  // int8: k then v scales
  static constexpr int kStageBytes = kScaleOff + (kQ8 ? 2 * kStageRows * 4 : 0);
  static constexpr int kStages = 2;
  // paged: the (page, slot) of each row of the stage being issued
  static constexpr int kTableBytes = kStageRows * 8;
  static constexpr int kWarpBytes = kStages * kStageBytes + kTableBytes;
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0, "lane plan");
  static_assert(kStageRows * 2 * kChunks % 32 == 0, "copy plan");
};

// The tensor-core form: bf16 queries, bf16 or int8 rows, 16 keys a stage.
template <int HD, bool Q8>
struct TcPlan {
  static constexpr bool kQ8 = Q8;
  static constexpr int kStageRows = 16;
  static constexpr int kRowBytes = Q8 ? HD : 2 * HD;
  static constexpr int kChunks = kRowBytes / 16;
  // rows padded by 16 bytes: ldmatrix's 8 rows fall on 8 bank groups
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kWidePitch = 2 * HD + 16;     // int8: the widened bf16 rows
  static constexpr int kKV = kStageRows * kPitch;    // bytes of K (or V) in a stage
  static constexpr int kScaleOff = 2 * kKV;
  static constexpr int kStageBytes = kScaleOff + (Q8 ? 2 * kStageRows * 4 : 0);
  static constexpr int kStages = 2;
  static constexpr int kWideBytes = Q8 ? 2 * kStageRows * kWidePitch : 0;
  static constexpr int kTableBytes = kStageRows * 8;
  static constexpr int kWarpBytes = kStages * kStageBytes + kWideBytes + kTableBytes;
  static_assert(kStageRows * 2 * kChunks % 32 == 0, "copy plan");
};

template <typename T>
__device__ __forceinline__ float ex2(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return exp2f(x);  // f32 queries: the accurate exp (card-vs-CPU tokens)
  } else {
    return tc::exp2_approx(x);  // bf16 queries: the special-function unit
  }
}

// four int8 (the bytes of w) as f32, exactly: byte ^ 0x80 = x + 128 goes
// under the exponent of 2^23 by a byte permute, and one full-rate add takes
// 2^23 + 128 back off (I2F runs at a quarter of the FMA rate)
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) - 8388736.f;
}

// kVecBytes of staged elements of TP as f32: exact for f32, bf16 and int8
template <typename TP, int NB>
__device__ __forceinline__ void widen(const unsigned char* src, float (&f)[NB / sizeof(TP)]) {
  uint32_t w[NB / 4];
  if constexpr (NB == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  } else {
    static_assert(NB == 8, "8- or 16-byte slices");
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    w[0] = x.x;
    w[1] = x.y;
  }
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) {
    if constexpr (std::is_same<TP, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<TP, __nv_bfloat16>::value) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      int8x4_to_f32(w[i], f + 4 * i);
    }
  }
}

// Where a CTA stands: its row, kv head and first query head, its live query
// rows, and its split's run [t_begin, t_end) of the row's visible keys.
struct Place {
  int b, kh, h0, rows, t_begin, t_end;
};

template <bool PAGED>
__device__ __forceinline__ Place place(const Params& p, int group) {
  Place w;
  const int g = p.H / p.K;
  const int n_rg = (g + group - 1) / group;
  const int rg = blockIdx.x % n_rg;
  const int bk = blockIdx.x / n_rg;
  w.b = bk / p.K;
  w.kh = bk - w.b * p.K;
  w.h0 = w.kh * g + rg * group;
  w.rows = min(group, g - rg * group);
  int len = max(p.lens[w.b], 0);
  if constexpr (PAGED) {
    if (len > p.cap) __trap();  // a length past the block table's reach
  } else {
    len = min(len, p.cap);
  }
  const int n_tiles = (len + kTile - 1) / kTile;
  const int tps = (n_tiles + p.splits - 1) / p.splits;
  w.t_begin = min(len, static_cast<int>(blockIdx.y) * tps * kTile);
  w.t_end = min(len, (static_cast<int>(blockIdx.y) + 1) * tps * kTile);
  return w;
}

// The split's keys in chunks whose block-table entries fit in s_bt: for
// each chunk [ct0, ct1) (pages from pg0 staged in s_bt, range-checked),
// run(ct0, ct1, pg0) by every thread of the CTA.
template <bool PAGED, typename Run>
__device__ __forceinline__ void for_chunks(const Params& p, const Place& w, int* s_bt, Run run) {
  for (int ct0 = w.t_begin; ct0 < w.t_end;) {
    int ct1 = w.t_end, pg0 = 0;
    if constexpr (PAGED) {
      pg0 = ct0 / p.ps;
      const int pg1 = min((w.t_end + p.ps - 1) / p.ps, pg0 + kBtChunk);
      ct1 = min(w.t_end, pg1 * p.ps);
      for (int i = threadIdx.x; i < pg1 - pg0; i += kThreads) {
        const int page = p.bt[static_cast<long long>(w.b) * p.npp + pg0 + i];
        if (page < 0 || page >= p.P) __trap();
        s_bt[i] = page;
      }
      __syncthreads();
    }
    run(ct0, ct1, pg0);
    ct0 = ct1;
    if constexpr (PAGED) __syncthreads();  // s_bt is refilled by the next chunk
  }
}

// Issue the cp.async copies of one stage of rows c + [0, PL::kStageRows):
// row r's K bytes at dst + r * kPitch and its V bytes kKV further (or, with
// kKV = 0, right after its K bytes), int8 scales at kScaleOff (k, then v).
// Rows at or past ct1 are zero-filled, never read.
template <typename PL, bool PAGED, int kKV>
__device__ __forceinline__ void issue_stage(const Params& p, int kh,
                                            const unsigned char* k_base,
                                            const unsigned char* v_base, long long es,
                                            const int* s_bt, int pg0, int2* table, int c,
                                            int ct1, uint32_t dst, int lane) {
  constexpr int kRows = PL::kStageRows, kChunks = PL::kChunks;
  if constexpr (PAGED) {
    // each row's page and slot, found once (the copies of a row share them)
    for (int r = lane; r < kRows; r += 32) {
      const int t = c + r;
      const int j = t / p.ps;
      table[r] = t < ct1 ? make_int2(s_bt[j - pg0], t - j * p.ps) : make_int2(0, 0);
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < kRows * 2 * kChunks / 32; ++j) {
    const int ci = j * 32 + lane;
    const int r = ci / (2 * kChunks);
    const int which = (ci / kChunks) & 1;  // 0: K, 1: V
    const int ch = ci % kChunks;
    const bool live = c + r < ct1;
    const unsigned char* src = which ? v_base : k_base;
    if (live) {
      const long long row = (which ? p.vs1 : p.ks1) * es;
      if constexpr (PAGED) {
        const int2 at = table[r];
        src += at.x * ((which ? p.vs0 : p.ks0) * es) + at.y * row;
      } else {
        src += (c + r) * row;
      }
      src += ch * 16;
    }
    const uint32_t off = kKV ? which * kKV + r * PL::kPitch + ch * 16
                             : r * PL::kPitch + which * PL::kRowBytes + ch * 16;
    tc::cp_async16(dst + off, src, live);
  }
  if constexpr (PL::kQ8) {
    for (int i = lane; i < 2 * kRows; i += 32) {
      const int which = i / kRows;
      const int r = i - which * kRows;
      const bool live = c + r < ct1;
      const float* src = which ? p.vsc + kh * p.vss2 : p.ksc + kh * p.kss2;
      if (live) {
        const int2 at = table[r];
        src += at.x * (which ? p.vss0 : p.kss0) + at.y * (which ? p.vss1 : p.kss1);
      }
      tc::cp_async4(dst + PL::kScaleOff + i * 4, src, live);
    }
  }
  if constexpr (PAGED) __syncwarp();  // the table is refilled by the next issue
}

// Merge the warps' partials (each warp's at ring + w * warp_bytes: [R][HD]
// unnormalised O, [R] m, [R] l) and write the CTA's rows, through the
// cluster's distributed shared memory when the row's keys were split.
template <int HD, int R, typename T>
__device__ __forceinline__ void merge_store(const Params& p, const Place& w,
                                            const unsigned char* ring, int warp_bytes,
                                            float (&c_acc)[R][HD], float (&c_m)[R],
                                            float (&c_l)[R]) {
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(w.b) * p.H + w.h0) * HD;
  for (int i = threadIdx.x; i < w.rows * HD; i += kThreads) {
    const int h = i / HD;
    const int d = i - h * HD;
    float M = kNegInf;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float* wp = reinterpret_cast<const float*>(ring + k * warp_bytes);
      M = fmaxf(M, wp[R * HD + h]);
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float* wp = reinterpret_cast<const float*>(ring + k * warp_bytes);
      const float e = ex2<T>(wp[R * HD + h] - M);
      L += wp[R * HD + R + h] * e;
      A += wp[h * HD + d] * e;
    }
    if (p.splits == 1) {
      out[i] = from_f32<T>(A / fmaxf(L, 1e-30f));
    } else {
      c_acc[h][d] = A;
      if (d == 0) {
        c_m[h] = M;
        c_l[h] = L;
      }
    }
  }
  if (p.splits == 1) return;

  // the splits of (b, kh, rg) form one cluster: each merges every
  // splits-th output element over all of them through distributed shared
  // memory, out = sum_s A_s 2^(m_s - M) / max(sum_s L_s 2^(m_s - M), 1e-30)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int j = threadIdx.x;; j += kThreads) {
    const int i = rank + j * p.splits;
    if (i >= w.rows * HD) break;
    const int h = i / HD;
    const int d = i - h * HD;
    float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < p.splits) {
        ms[s] = *cluster.map_shared_rank(&c_m[h], s);
        ls[s] = *cluster.map_shared_rank(&c_l[h], s);
        as[s] = *cluster.map_shared_rank(&c_acc[h][d], s);
      }
    }
    float M = kNegInf;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < p.splits) M = fmaxf(M, ms[s]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < p.splits) {
        const float e = ex2<T>(ms[s] - M);
        L += ls[s] * e;
        A += as[s] * e;
      }
    }
    out[i] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

// bytes of head kh in the first token (slot: of row b; paged: of page 0)
template <typename TP, bool PAGED>
__device__ __forceinline__ const unsigned char* head_base(const void* x, long long s0,
                                                          long long s2, int b, int kh) {
  return static_cast<const unsigned char*>(x) +
         (kh * s2 + (PAGED ? 0 : b * s0)) * static_cast<long long>(sizeof(TP));
}

// ---------------------------------------------------------------------------
// the CUDA-core form
// ---------------------------------------------------------------------------
template <int HD, int G, typename T, typename TP, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Params p) {
  using PL = Plan<HD, G, TP>;
  constexpr bool Q8 = PL::kQ8;
  constexpr int kVec = PL::kVec, kVecBytes = PL::kVecBytes, kLanes = PL::kLanes;
  constexpr int kRows = PL::kRows, kU = PL::kU, kStageRows = PL::kStageRows;
  constexpr int kRowBytes = PL::kRowBytes, kStages = PL::kStages;
  static_assert((G * HD + 2 * G) * 4 <= PL::kWarpBytes, "partials fit in a warp's ring");

  extern __shared__ __align__(16) unsigned char ring[];  // [kWarps][stages, table]
  __shared__ float c_acc[G][HD];  // the CTA's partials, for the cluster merge
  __shared__ float c_m[G], c_l[G];
  __shared__ int s_bt[PAGED ? kBtChunk : 1];

  const Place w = place<PAGED>(p, G);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;  // which kVec elements of a key row
  const int grp = lane / kLanes;  // which of the warp's kRows key rows

  float q[G][kVec];
  {
    const T* qp = static_cast<const T*>(p.q) +
                  (static_cast<long long>(w.b) * p.H + w.h0) * HD + sub * kVec;
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        q[h][i] = h < w.rows ? to_f32(qp[h * HD + i]) * p.scale_log2 : 0.f;
    }
  }
  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[h][i] = 0.f;
  }

  const unsigned char* k_base = head_base<TP, PAGED>(p.k, p.ks0, p.ks2, w.b, w.kh);
  const unsigned char* v_base = head_base<TP, PAGED>(p.v, p.vs0, p.vs2, w.b, w.kh);
  unsigned char* my_ring = ring + warp * PL::kWarpBytes;
  const uint32_t my_ring_s = tc::smem_addr(my_ring);
  int2* table = reinterpret_cast<int2*>(my_ring + kStages * PL::kStageBytes);

  for_chunks<PAGED>(p, w, s_bt, [&](int ct0, int ct1, int pg0) {
    // the warp's stages of [ct0, ct1): stage i holds rows
    // ct0 + (i * kWarps + warp) * kStageRows + [0, kStageRows)
    const int n_stages = (ct1 - ct0 + kStageRows - 1) / kStageRows;
    const int mine = n_stages > warp ? (n_stages - warp + kWarps - 1) / kWarps : 0;
    auto first_row = [&](int i) { return ct0 + (i * kWarps + warp) * kStageRows; };
    auto issue = [&](int i) {
      issue_stage<PL, PAGED, 0>(p, w.kh, k_base, v_base, sizeof(TP), s_bt, pg0, table,
                                first_row(i), ct1, my_ring_s + (i % kStages) * PL::kStageBytes,
                                lane);
    };
    // fold the stage of rows c.. into the running softmax
    auto consume = [&](int c, const unsigned char* st) {
      float s[G][kU];
      bool live[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = u * kRows + grp;
        live[u] = c + r < ct1;
        float kf[kVec];
        widen<TP, kVecBytes>(st + r * PL::kPitch + sub * kVecBytes, kf);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) a = fmaf(q[h][i], kf[i], a);
          s[h][u] = a;
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off >= 1; off /= 2) {
#pragma unroll
        for (int h = 0; h < G; ++h) {
#pragma unroll
          for (int u = 0; u < kU; ++u) s[h][u] += __shfl_xor_sync(0xffffffffu, s[h][u], off);
        }
      }
      const float* sc = reinterpret_cast<const float*>(st + PL::kScaleOff);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float mx = m[h];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float x = Q8 ? s[h][u] * sc[u * kRows + grp] : s[h][u];
          s[h][u] = live[u] ? x : kNegInf;
          mx = fmaxf(mx, s[h][u]);
        }
        const float alpha = ex2<T>(m[h] - mx);
        m[h] = mx;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float e = live[u] ? ex2<T>(s[h][u] - mx) : 0.f;
          sum += e;
          // the weight for P.V: int8 pages scale it by v_scale and select it
          s[h][u] = Q8 ? (live[u] ? e * sc[kStageRows + u * kRows + grp] : 0.f) : e;
        }
        l[h] = l[h] * alpha + sum;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[h][i] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = u * kRows + grp;
        float vf[kVec];
        widen<TP, kVecBytes>(st + r * PL::kPitch + kRowBytes + sub * kVecBytes, vf);
#pragma unroll
        for (int h = 0; h < G; ++h) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[h][i] = fmaf(s[h][u], vf[i], acc[h][i]);
        }
      }
    };
    // the ring: kStages - 1 stages in flight while one is used
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < mine) issue(i);
      tc::cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
      if (i + kStages - 1 < mine) issue(i + kStages - 1);
      tc::cp_async_commit();
      tc::cp_async_wait<kStages - 1>();  // stage i has landed
      __syncwarp();
      consume(first_row(i), my_ring + (i % kStages) * PL::kStageBytes);
      __syncwarp();                  // read before the ring slot is refilled
    }
  });
  tc::cp_async_wait<0>();

  // merge the warp's lane groups (same output dims, other key rows)
#pragma unroll
  for (int off = kLanes; off < 32; off *= 2) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float mn = fmaxf(m[h], mo);
      const float a = ex2<T>(m[h] - mn);
      const float e = ex2<T>(mo - mn);
      l[h] = l[h] * a + lo * e;
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        acc[h][i] = acc[h][i] * a + __shfl_xor_sync(0xffffffffu, acc[h][i], off) * e;
      m[h] = mn;
    }
  }
  // each warp's partials go to its own ring, which it no longer reads
  __syncwarp();
  float* part = reinterpret_cast<float*>(my_ring);  // [G][HD] acc, [G] m, [G] l
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) part[h * HD + sub * kVec + i] = acc[h][i];
      if (sub == 0) {
        part[G * HD + h] = m[h];
        part[G * HD + G + h] = l[h];
      }
    }
  }
  __syncthreads();
  merge_store<HD, G, T>(p, w, ring, PL::kWarpBytes, c_acc, c_m, c_l);
}

// ---------------------------------------------------------------------------
// the tensor-core form (bf16 queries)
// ---------------------------------------------------------------------------
// int8 pages: widen a landed stage's int8 K and V rows to bf16 rows of the
// warp's wide tile (exact: |x| <= 127)
template <int HD>
__device__ __forceinline__ void widen_stage(const unsigned char* st, unsigned char* wide,
                                            int lane) {
  using PL = TcPlan<HD, true>;
  constexpr int kPer = PL::kStageRows * HD / 8;  // pieces of 8 int8 in K (or V)
#pragma unroll
  for (int j = 0; j < 2 * kPer / 32; ++j) {
    const int i = j * 32 + lane;
    const int which = i / kPer;
    const int rem = i - which * kPer;
    const int r = rem / (HD / 8);
    const int c = rem - r * (HD / 8);
    const uint2 raw =
        *reinterpret_cast<const uint2*>(st + which * PL::kKV + r * PL::kPitch + c * 8);
    float x[8];
    int8x4_to_f32(raw.x, x);
    int8x4_to_f32(raw.y, x + 4);
    uint4 packed;
    packed.x = tc::pack_bf16(x[0], x[1]);
    packed.y = tc::pack_bf16(x[2], x[3]);
    packed.z = tc::pack_bf16(x[4], x[5]);
    packed.w = tc::pack_bf16(x[6], x[7]);
    *reinterpret_cast<uint4*>(wide + (which * PL::kStageRows + r) * PL::kWidePitch + c * 16) =
        packed;
  }
}

template <int HD, bool Q8, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_split_tc_kernel(const Params p) {
  using PL = TcPlan<HD, Q8>;
  using TP = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  constexpr int kKSteps = HD / 16;   // k-steps of S = Q.K^T
  constexpr int kDB = HD / 8;        // 8-wide column blocks of O
  constexpr int kStages = PL::kStages, kStageRows = PL::kStageRows;
  constexpr int kBPitch = Q8 ? PL::kWidePitch : PL::kPitch;  // the bf16 rows' pitch
  static_assert(kStageRows == 16, "one P.V k-step a stage");
  static_assert((kTcRows * HD + 2 * kTcRows) * 4 <= PL::kWarpBytes,
                "partials fit in a warp's ring");

  extern __shared__ __align__(16) unsigned char ring[];  // [kWarps][stages, wide, table]
  __shared__ float c_acc[kTcRows][HD];
  __shared__ float c_m[kTcRows], c_l[kTcRows];
  __shared__ int s_bt[PAGED ? kBtChunk : 1];

  const Place w = place<PAGED>(p, kTcRows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int rA = lane >> 2;  // this thread's rows of the 16: rA and rA + 8
  const int rB = rA + 8;

  // Q as m16n8k16 A fragments (bf16, unscaled); rows past the group are 0
  uint32_t qf[kKSteps][4];
  {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p.q) +
                              (static_cast<long long>(w.b) * p.H + w.h0) * HD;
    auto pair = [&](int r, int col) -> uint32_t {  // two bf16, read one at a time
      if (r >= w.rows) return 0u;
      return static_cast<uint32_t>(q[r * HD + col]) |
             (static_cast<uint32_t>(q[r * HD + col + 1]) << 16);
    };
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const int col = kk * 16 + quad * 2;
      qf[kk][0] = pair(rA, col);
      qf[kk][1] = pair(rB, col);
      qf[kk][2] = pair(rA, col + 8);
      qf[kk][3] = pair(rB, col + 8);
    }
  }
  float o[kDB][4];
#pragma unroll
  for (int j = 0; j < kDB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;

  const unsigned char* k_base = head_base<TP, PAGED>(p.k, p.ks0, p.ks2, w.b, w.kh);
  const unsigned char* v_base = head_base<TP, PAGED>(p.v, p.vs0, p.vs2, w.b, w.kh);
  unsigned char* my_ring = ring + warp * PL::kWarpBytes;
  const uint32_t my_ring_s = tc::smem_addr(my_ring);
  unsigned char* wide = my_ring + kStages * PL::kStageBytes;
  int2* table = reinterpret_cast<int2*>(wide + PL::kWideBytes);
  const int lm = lane >> 3;  // ldmatrix: this lane's matrix and its row there
  const int lr = lane & 7;

  for_chunks<PAGED>(p, w, s_bt, [&](int ct0, int ct1, int pg0) {
    const int n_stages = (ct1 - ct0 + kStageRows - 1) / kStageRows;
    const int mine = n_stages > warp ? (n_stages - warp + kWarps - 1) / kWarps : 0;
    auto first_row = [&](int i) { return ct0 + (i * kWarps + warp) * kStageRows; };
    auto issue = [&](int i) {
      issue_stage<PL, PAGED, PL::kKV>(p, w.kh, k_base, v_base, sizeof(TP), s_bt, pg0, table,
                                      first_row(i), ct1,
                                      my_ring_s + (i % kStages) * PL::kStageBytes, lane);
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < mine) issue(i);
      tc::cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
      if (i + kStages - 1 < mine) issue(i + kStages - 1);
      tc::cp_async_commit();
      tc::cp_async_wait<kStages - 1>();
      __syncwarp();
      const unsigned char* st = my_ring + (i % kStages) * PL::kStageBytes;
      const unsigned char* kt = st;  // bf16 K rows, and V rows kKV on
      const unsigned char* vt = st + PL::kKV;
      if constexpr (Q8) {
        widen_stage<HD>(st, wide, lane);
        __syncwarp();
        kt = wide;
        vt = wide + kStageRows * PL::kWidePitch;
      }
      const int t0 = first_row(i);

      // S = Q.K^T: 16 rows x 16 keys (two 8-key column blocks)
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint32_t k_addr =
          tc::smem_addr(kt) + ((lm >> 1) * 8 + lr) * kBPitch + (lm & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t f0, f1, f2, f3;
        tc::ldsm_x4(k_addr + kk * 32, f0, f1, f2, f3);
        tc::mma_bf16(s[0], qf[kk], f0, f1);
        tc::mma_bf16(s[1], qf[kk], f2, f3);
      }
      // scale (and dequantize) in f32; dead keys replaced by -1e30
      const float* sc = reinterpret_cast<const float*>(st + PL::kScaleOff);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + quad * 2 + (e & 1);
          const float x = s[j][e] * (Q8 ? sc[col] * p.scale_log2 : p.scale_log2);
          s[j][e] = t0 + col < ct1 ? x : kNegInf;
        }
      }
      float mxA = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
      float mxB = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
      const float mA_new = fmaxf(mA, mxA);
      const float mB_new = fmaxf(mB, mxB);
      const float alphaA = ex2<__nv_bfloat16>(mA - mA_new);
      const float alphaB = ex2<__nv_bfloat16>(mB - mB_new);
      mA = mA_new;
      mB = mB_new;
      // weights: dead keys exactly 0 (select); int8 pages scale them by
      // v_scale in f32 (the row sum takes the unscaled weight) and select
      // the scaled weight too; P rounded once to bf16 A fragments
      float pw[2][4];
      float sumA = 0.f, sumB = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + quad * 2 + (e & 1);
          const bool live = t0 + col < ct1;
          const float x = live ? ex2<__nv_bfloat16>(s[j][e] - (e < 2 ? mA_new : mB_new)) : 0.f;
          if (e < 2) {
            sumA += x;
          } else {
            sumB += x;
          }
          pw[j][e] = Q8 ? (live ? x * sc[kStageRows + col] : 0.f) : x;
        }
      }
      lA = lA * alphaA + sumA;
      lB = lB * alphaB + sumB;
      uint32_t pa[4];
      pa[0] = tc::pack_bf16(pw[0][0], pw[0][1]);
      pa[1] = tc::pack_bf16(pw[0][2], pw[0][3]);
      pa[2] = tc::pack_bf16(pw[1][0], pw[1][1]);
      pa[3] = tc::pack_bf16(pw[1][2], pw[1][3]);
#pragma unroll
      for (int j = 0; j < kDB; ++j) {
        o[j][0] *= alphaA;
        o[j][1] *= alphaA;
        o[j][2] *= alphaB;
        o[j][3] *= alphaB;
      }
      // O += P.V (V through ldmatrix.trans: k = keys, n = head dims)
      const uint32_t v_addr =
          tc::smem_addr(vt) + ((lm & 1) * 8 + lr) * kBPitch + (lm >> 1) * 16;
#pragma unroll
      for (int d2 = 0; d2 < kDB / 2; ++d2) {
        uint32_t f0, f1, f2, f3;
        tc::ldsm_x4_t(v_addr + d2 * 32, f0, f1, f2, f3);
        tc::mma_bf16(o[2 * d2], pa, f0, f1);
        tc::mma_bf16(o[2 * d2 + 1], pa, f2, f3);
      }
      __syncwarp();  // read before the ring slot (and the wide tile) is refilled
    }
  });
  tc::cp_async_wait<0>();

  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  // each warp's partials go to its own ring, which it no longer reads
  __syncwarp();
  float* part = reinterpret_cast<float*>(my_ring);  // [16][HD] acc, [16] m, [16] l
#pragma unroll
  for (int j = 0; j < kDB; ++j) {
    *reinterpret_cast<float2*>(part + rA * HD + j * 8 + quad * 2) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(part + rB * HD + j * 8 + quad * 2) = make_float2(o[j][2], o[j][3]);
  }
  if (quad == 0) {
    part[kTcRows * HD + rA] = mA;
    part[kTcRows * HD + rB] = mB;
    part[kTcRows * HD + kTcRows + rA] = lA;
    part[kTcRows * HD + kTcRows + rB] = lB;
  }
  __syncthreads();
  merge_store<HD, kTcRows, __nv_bfloat16>(p, w, ring, PL::kWarpBytes, c_acc, c_m, c_l);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename Kernel>
int launch_kernel(Kernel kernel, const Params& p, int ctas, size_t smem,
                  size_t (&granted)[kMaxDevices], cudaStream_t stream) {
  // the static merge buffers and block-table chunk take up to ~9.3 KB of
  // the default 48 KB
  cudaError_t err = allow_smem(kernel, smem, granted, 38 * 1024);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, p.splits, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = p.splits;  // the splits of one (b, kh, rg)
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int G, typename T, typename TP, bool PAGED>
int launch_g(const Params& p, int ctas, cudaStream_t stream) {
  static size_t granted[kMaxDevices] = {};
  return launch_kernel(decode_split_kernel<HD, G, T, TP, PAGED>, p, ctas,
                       static_cast<size_t>(kWarps) * Plan<HD, G, TP>::kWarpBytes, granted,
                       stream);
}

template <int HD, bool Q8, bool PAGED>
int launch_tc(const Params& p, int ctas, cudaStream_t stream) {
  static size_t granted[kMaxDevices] = {};
  return launch_kernel(decode_split_tc_kernel<HD, Q8, PAGED>, p, ctas,
                       static_cast<size_t>(kWarps) * TcPlan<HD, Q8>::kWarpBytes, granted,
                       stream);
}

// The form for `rows` query rows a CTA (1 or 2: a whole group of that
// size; 4: f32 queries; kTcRows: bf16 queries on tensor cores), each
// group of g taking ceil(g / rows) CTAs. The host picks rows
// (_build.decode_group_rows); a size with no form here is refused.
template <int HD, typename T, typename TP, bool PAGED>
int launch_hd(const Params& p, int B, int rows, cudaStream_t stream) {
  const int ctas = B * p.K * ((p.H / p.K + rows - 1) / rows);
  if (rows == 1) return launch_g<HD, 1, T, TP, PAGED>(p, ctas, stream);
  if (rows == 2) return launch_g<HD, 2, T, TP, PAGED>(p, ctas, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (rows == kTcRows)
      return launch_tc<HD, std::is_same<TP, int8_t>::value, PAGED>(p, ctas, stream);
  } else {
    if (rows == 4) return launch_g<HD, 4, T, TP, PAGED>(p, ctas, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch the body for head dim `hd` (16, 64 or 128: the wrappers route no
// other width here) over B rows, p.splits (1, 2, 4 or 8) CTAs a row group
// of `rows` query rows.
template <typename T, typename TP, bool PAGED>
int launch(const Params& p, int B, int hd, int rows, void* stream) {
  if (B == 0) return 0;
  if (p.K <= 0 || p.H % p.K || p.splits < 1 || p.splits > kMaxSplits ||
      (p.splits & (p.splits - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16, T, TP, PAGED>(p, B, rows, s);
    case 64: return launch_hd<64, T, TP, PAGED>(p, B, rows, s);
    case 128: return launch_hd<128, T, TP, PAGED>(p, B, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace split
}  // namespace repro_torch
