// Paged decode attention: one query token per sequence over that
// sequence's own KV pages, emitting UNNORMALIZED online-softmax state
// (acc, m, l) over a page sub-range [rlo, rhi); the caller normalizes.
// One kernel template on the KV row type, two instances, two entry points:
// pk_paged_decode (bf16 pools) and pk_paged_decode_int8 (int8 pools plus a
// bf16 scale per (row, kv head)).
//
// Replaces: polykey_tpu/ops/paged_attention_kernel.py, _decode_call (body
// _kernel), reached from paged_attention_decode: its bf16 path and its
// quantized=True path (int8 KV).
//
// Bound on this card: bytes. Each step reads every visible K and V row of
// every sequence once and does 4 x Hq x ctx x D flops on them: about G
// flops per bf16 byte and 2G per int8 byte, far below the ~295 flops per
// byte at which bf16 tensor cores would become the limit. With one query per
// sequence the danger is latency, not bandwidth: a CTA that walks a 4096-row
// context one dependent load at a time takes milliseconds. On CUDA cores the
// G FMAs per value for q.k and again for p.v (and, for int8, the
// dequantize) took more issue slots than the bytes allow (on an H100 the
// int8 ring on CUDA cores took 0.0678 ms at chip_smoke.py's main shape, on
// tensor cores 0.0389; PERF.md, section 6). The design:
// - One launch, one CTA per (kv head, sequence, split) serving the G =
//   Hq/Hk query heads of its kv head, so each K/V row crosses from memory
//   once for all of them. A split covers `split_pages` consecutive pages of
//   [rlo, rhi) intersected with the sequence's own pages [lo, hi) (hi from
//   the position, lo from the sliding window): SPLIT_ROWS or
//   SPLIT_ROWS_INT8 rows (ops/paged_attention_kernel.py). The grid depends
//   on the page-table width only, never on positions (no host read, so a
//   CUDA graph can capture it). Each CTA computes from its sequence's
//   position which splits hold rows; a CTA whose split holds none returns
//   before it loads or writes anything. A split's page ids are staged in
//   shared memory first, so a row's address needs no dependent global load.
// - K and V (and int8's scales) stream through a shared-memory ring filled
//   by cp.async: 16 bytes a thread for values (chunks XOR-swizzled by row so
//   the fragment reads below are free of bank conflicts), one 4-byte copy a
//   row for each int8 scale. A stage is 16 rows a warp. int8: 256 rows,
//   68,608 bytes at D = 128, in 2 stages; 4 stages of 35,840 bytes at D =
//   64; 2 of 67,072 (128 rows) at D = 256. bf16 (a row is 2 D bytes, twice
//   int8's): 3 stages of 64 KB, 256 rows at D = 64, 128 at D = 128, 64 at D
//   = 256 (16, 8 and 4 warps); its copies find their page without a
//   division (a multiply-high by a constant of ps: 8-10% off the main
//   shape's time on an H100). Bytes in flight grow with shared memory, not
//   registers. ptxas (sm_90a): see PERF.md, section 6; no spills.
// - q.k and p.v on tensor cores (mma.sync m16n8k16, fp32 sums): S = q K^T
//   with the G query heads as rows (padded to 16), then O^T = V^T P^T,
//   whose B operand is exactly S's accumulator layout, so P never leaves
//   registers. Scale and soft-cap apply to the fp32 logits.
//   int8: fp16 operands (bf16 q is exact in fp16 from 2^-14 to 65504). No
//   int-to-float conversion: a byte permute puts (b ^ 0x80) under the fp16
//   exponent of 1024 and one packed subtract of 1152 leaves b, exact. The
//   K scale multiplies each logit once (s = ks (q . k8) scale); the V scale
//   folds into the probability (p vs) before its one fp16 rounding
//   (relative 2^-11, absolute 2^-25 below 2^-14), where the TPU kernel
//   keeps p v in fp32: the output may differ from the fp32 plain version by
//   2^-11 sum p|v| / l and a little more (ops/paged_attention_kernel.py,
//   decode_error_bound).
//   bf16: bf16 operands, q, K and V exact, K and V through ldmatrix (V
//   transposed) from the swizzled stage. The TPU kernel keeps p v in fp32;
//   a bf16 operand would round p by up to 2^-8 relative, 8x outside
//   decode_error_bound's 2^-11 term. So P goes in two bf16 halves, hi =
//   bf16(p) and lo = bf16(p - hi), two products a d-tile: hi + lo is within
//   2^-16 p of p, and the bound is the int8 instance's. The second product
//   costs no bytes, and at most 8 of the 16 A rows of q.k are real heads.
// - Merge: if one split holds rows it writes (acc, m, l) directly. Else
//   each writes its state to scratch, __threadfence()s, and counts itself
//   in an arrival counter of its (sequence, kv head); the CTA that counts
//   last resets the counter to 0 (for the next call and a later graph
//   replay) and merges the splits that hold rows, in split order, so the
//   result is bit-identical from call to call whichever CTA ends last.
//   Two calls must not share counters at once: the wrapper keeps a buffer
//   per stream, never freed (arrival_counters), and calls on one stream
//   run in order.
// - Stale rows: rows outside [lo, hi) or the window are copied with
//   source size 0 (zeros, int8 scales 0), never read from the pool (an
//   unwritten slot may hold NaN, and 0 x NaN is NaN), and their probability
//   is written as exactly 0. An int8 scale is copied as the aligned 4-byte
//   word that holds it (the scale block of one page, ps x Hk x 2 bytes,
//   need not be a multiple of 16 or even 4 bytes); a selector kept beside
//   it says which half is the row's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kMaxSplitPages = 64;       // bf16: page ids a split stages
constexpr int kMaxSplitPagesInt8 = 256;  // int8
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// Two int8 values of `x` (the word XOR 0x80808080), picked by `sel` from
// its bytes, as an exact fp16 pair without an int-to-float conversion: the
// byte b ^ 0x80 under the high byte 0x64 is the half 1024 + b + 128, and
// one packed subtract of 1152 leaves b.
__device__ __forceinline__ uint32_t i8_pair_f16(uint32_t x, uint32_t sel) {
  const uint32_t h = __byte_perm(x, 0x64646464u, sel);
  uint32_t r;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(0x64806480u));
  return r;
}

__device__ __forceinline__ uint32_t f16_pair(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D = A B + D, m16n8k16, fp16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D = A B + D, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, row addresses from lanes 8i ..
// 8i + 7 for matrix i: lane (g, t) gets row g, columns 2t and 2t + 1 of
// each (with .trans, rows 2t and 2t + 1 of column g).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The bf16 scale held in half `sel` (0 low, 1 high) of a 4-byte word.
__device__ __forceinline__ float scale_of(uint32_t w, uint32_t sel) {
  return __uint_as_float(sel ? (w & 0xFFFF0000u) : (w << 16));
}

// KV row types: int8 values with a bf16 scale per (row, kv head), or bf16.
struct Int8Rows {
  using T = int8_t;
  static constexpr bool INT8 = true;
  static constexpr int MAX_SPLIT_PAGES = kMaxSplitPagesInt8;
};

struct Bf16Rows {
  using T = __nv_bfloat16;
  static constexpr bool INT8 = false;
  static constexpr int MAX_SPLIT_PAGES = kMaxSplitPages;
};

template <int D, int G, class KV>
struct Geo;

template <int D, int G>
struct Geo<D, G, Int8Rows> {
  // 16 warps a CTA, 8 at D = 256 (whose 182 registers a thread would spill
  // under 16 warps' cap of 128).
  static constexpr int WARPS = D == 256 ? 8 : 16, THREADS = 32 * WARPS;
  static constexpr int R = 16 * WARPS;          // rows per ring stage, 16 a warp
  static constexpr int STAGES = D == 64 ? 4 : 2; // 140, 134 and 131 KB of ring
  static constexpr int ROW = D;                 // bytes of one row's values
  static constexpr int CPR = D / 16;            // 16-byte chunks per row
  static constexpr int SWZ = CPR < 8 ? CPR - 1 : 7;   // chunk XOR row bits
  static constexpr int KS = D / 16;             // k-steps of q.k; d-tiles of p.v
  static constexpr int KV_BYTES = R * ROW;
  // K [R][D] int8, V [R][D] int8 (16-byte chunks swizzled), K scale words
  // [R], V scale words [R], scale selectors [R].
  static constexpr int STAGE = 2 * KV_BYTES + 12 * R;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(WARPS * G * D * 4 <= SMEM, "the warp merge reuses the ring");
};

template <int D, int G>
struct Geo<D, G, Bf16Rows> {
  // 64 KB of K and V a stage: 16 warps at D = 64, 8 at 128, 4 at 256.
  static constexpr int WARPS = 1024 / D, THREADS = 32 * WARPS;
  static constexpr int R = 16 * WARPS;          // rows per ring stage, 16 a warp
  static constexpr int STAGES = 3;              // 192 KB of ring
  static constexpr int ROW = 2 * D;
  static constexpr int CPR = D / 8;
  static constexpr int SWZ = 7;
  static constexpr int KS = D / 16;
  static constexpr int KV_BYTES = R * ROW;
  static constexpr int STAGE = 2 * KV_BYTES;    // K [R][D], V [R][D], swizzled
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(WARPS * G * D * 4 <= SMEM, "the warp merge reuses the ring");
};

// Byte offset of (row i, 16-byte chunk c) in a stage's K or V block.
template <class Gm>
__device__ __forceinline__ int swz(int i, int c) {
  return i * Gm::ROW + ((c ^ (i & Gm::SWZ)) << 4);
}

// The grid is (kv head, sequence, split), fixed by the page-table width.
template <int D, int G, class KV>
__global__ void __launch_bounds__(Geo<D, G, KV>::THREADS) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Hq, D]
    const typename KV::T* __restrict__ k_pool,  // [N, ps, Hk, D]
    const typename KV::T* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ ks_pool,  // int8: [N, ps, Hk]
    const __nv_bfloat16* __restrict__ vs_pool,
    const int32_t* __restrict__ page_tables,    // [B, P]
    const int32_t* __restrict__ positions,      // [B]
    float* __restrict__ acc,                    // [B, Hq, D]
    float* __restrict__ m_out,                  // [B, Hq]
    float* __restrict__ l_out,
    float* __restrict__ acc_p,                  // [B, Hq, nsplit, D] scratch
    float* __restrict__ m_p,                    // [B, Hq, nsplit]
    float* __restrict__ l_p,
    int* __restrict__ arrivals,                 // [B, Hk], 0 between calls
    int Hq, int Hk, int ps, int P, float scale, float softcap, int window,
    int rlo, int rhi, int split_pages, int nsplit) {
  using Gm = Geo<D, G, KV>;
  constexpr int R = Gm::R, STAGES = Gm::STAGES, KS = Gm::KS;
  constexpr int WARPS = Gm::WARPS, THREADS = Gm::THREADS;
  constexpr int EPC = 16 / sizeof(typename KV::T);   // values per 16-byte chunk
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int pages_s[KV::MAX_SPLIT_PAGES];
  __shared__ float m_w[WARPS][G], l_w[WARPS][G];
  __shared__ int last_s;

  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z, pos = positions[b];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = lane >> 2, qt = lane & 3;      // mma fragment row and column group
  const int h0 = g * G;
  const int64_t bh0 = (int64_t)b * Hq + h0;

  // Which splits hold rows, from the position alone (every CTA of the
  // sequence computes the same answer).
  const int hi = min(pos / ps + 1, rhi);
  const int lo = max(window > 0 ? max((pos - window + 1) / ps, 0) : 0, rlo);
  if (hi <= lo) {
    if (split == 0) {          // no rows at all: split 0 writes the empty state
      for (int idx = tid; idx < G * D; idx += THREADS) acc[bh0 * D + idx] = 0.f;
      if (tid < G) {
        m_out[bh0 + tid] = kNegInf;
        l_out[bh0 + tid] = 0.f;
      }
    }
    return;
  }
  const int s_lo = (lo - rlo) / split_pages, s_hi = (hi - 1 - rlo) / split_pages;
  if (split < s_lo || split > s_hi) return;    // this split holds no rows
  const int nbusy = s_hi - s_lo + 1;
  const int p0 = max(lo, rlo + split * split_pages);
  const int p1 = min(hi, rlo + (split + 1) * split_pages);
  int rstart = p0 * ps;
  if (window > 0) rstart = max(rstart, pos - window + 1);
  const int rend = min(p1 * ps, pos + 1);
  const int nchunks = rend > rstart ? (rend - rstart + R - 1) / R : 0;
  for (int i = tid; i < p1 - p0; i += THREADS) {
    pages_s[i] = page_tables[(int64_t)b * P + p0 + i];
  }

  // q of head qg as the A operand of q.k (rows qg < G; the rest, and rows
  // 8-15, are 0): qa[s][0] and qa[s][1] are a0 and a2 of k-step s.
  uint32_t qa[KS][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) qa[s][0] = qa[s][1] = 0u;
  if (qg < G) {
    if constexpr (KV::INT8) {
      // Lane column group qt takes the D/4 values from qt D/4: k-step s
      // pairs values 4s, 4s + 1 (a0) and 4s + 2, 4s + 3 (a2), which matches
      // the bytes of K the same lanes take below.
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            q + (bh0 + qg) * D + qt * (D / 4) + c * 8));
        float f[8];
        unpack8(raw, f);
        qa[2 * c][0] = f16_pair(f[0], f[1]);
        qa[2 * c][1] = f16_pair(f[2], f[3]);
        qa[2 * c + 1][0] = f16_pair(f[4], f[5]);
        qa[2 * c + 1][1] = f16_pair(f[6], f[7]);
      }
    } else {
      // The mma's own order: a0 = q[16s + 2qt, + 1], a2 = q[16s + 8 + 2qt, + 1].
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + (bh0 + qg) * D);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        qa[s][0] = __ldg(qw + 8 * s + qt);
        qa[s][1] = __ldg(qw + 8 * s + 4 + qt);
      }
    }
  }
  // Online-softmax state of head qg (m shared by the 4 lanes of the head,
  // l a partial sum per lane), and O^T tiles: o[t][0..1] = O[heads 2qt,
  // 2qt + 1] at d = d_of(t) below, o[t][2..3] at d + d_hi.
  float m = kNegInf, l = 0.f;
  float o[KS][4];
#pragma unroll
  for (int t = 0; t < KS; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  __syncthreads();             // pages_s

  // bf16: r / ps as __umulhi(r, div_mul) >> div_shift (exact for 0 <= r <
  // 2^31, ps > 1; the divisor is invariant, as in CUTLASS's FastDivmod),
  // so a 16-byte copy's address takes no division.
  uint32_t div_mul = 0, div_shift = 0;
  if constexpr (!KV::INT8) {
    if (ps > 1) {
      const int lg = 31 - __clz(ps) + ((ps & (ps - 1)) != 0);   // ceil(log2 ps)
      div_mul = (uint32_t)(((1ull << (31 + lg)) + ps - 1) / ps);
      div_shift = lg - 1;
    }
  }
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  // Fill stage c % STAGES with rows [rstart + c R, + R); rows at or past
  // rend land as zeros (values and scales) without being read.
  auto issue = [&](int c) {
    const int st = c % STAGES;
    const uint32_t kdst = ring_s + st * Gm::STAGE;
    const uint32_t vdst = kdst + Gm::KV_BYTES;
    const int base = rstart + c * R;
    for (int idx = tid; idx < R * Gm::CPR; idx += THREADS) {
      const int i = idx / Gm::CPR, c16 = idx % Gm::CPR, r = base + i;
      const bool ok = r < rend;
      int64_t row = 0;
      if constexpr (KV::INT8) {
        if (ok) row = ((int64_t)pages_s[r / ps - p0] * ps + r % ps) * Hk + g;
      } else if (ok) {
        const int pg = ps == 1 ? r : (int)(__umulhi((uint32_t)r, div_mul) >> div_shift);
        row = ((int64_t)pages_s[pg - p0] * ps + r - pg * ps) * Hk + g;
      }
      const int at = swz<Gm>(i, c16);
      cp_async16(kdst + at, k_pool + row * D + c16 * EPC, ok);
      cp_async16(vdst + at, v_pool + row * D + c16 * EPC, ok);
    }
    if constexpr (KV::INT8) {
      const uint32_t sdst = kdst + 2 * Gm::KV_BYTES;
      uint32_t* sel = reinterpret_cast<uint32_t*>(ring + st * Gm::STAGE + 2 * Gm::KV_BYTES) + 2 * R;
      for (int i = tid; i < R; i += THREADS) {
        const int r = base + i;
        const bool ok = r < rend;
        int64_t e = 0;
        if (ok) e = ((int64_t)pages_s[r / ps - p0] * ps + r % ps) * Hk + g;
        cp_async4(sdst + 4 * i, ks_pool + (e & ~(int64_t)1), ok);
        cp_async4(sdst + 4 * (R + i), vs_pool + (e & ~(int64_t)1), ok);
        sel[i] = (uint32_t)(e & 1);
      }
    }
  };

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();           // stage c landed; stage c - 1 is free
    if (c + STAGES - 1 < nchunks) issue(c + STAGES - 1);
    cp_async_commit();
    const int i0 = warp * 16, base = rstart + c * R;
    if (base + i0 >= rend) continue;             // this warp's 16 rows are all past the end
    const unsigned char* K = ring + (c % STAGES) * Gm::STAGE;
    const unsigned char* V = K + Gm::KV_BYTES;
    const uint32_t* ksw = reinterpret_cast<const uint32_t*>(K + 2 * Gm::KV_BYTES);
    const uint32_t* vsw = ksw + R;
    const uint32_t* sel = ksw + 2 * R;
    const uint32_t Ks = ring_s + (c % STAGES) * Gm::STAGE, Vs = Ks + Gm::KV_BYTES;

    // S = q K^T over the warp's rows i0 + 8j + n: s[j][0..1] = S[head qg]
    // [rows 8j + 2qt, + 1].
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (KV::INT8) {
        // The B operand of lane (qg, qt) is row 8j + qg, bytes qt D/4 + 4s
        // .. + 3 at k-step s.
        const int i = i0 + 8 * j + qg;
#pragma unroll
        for (int cc = 0; cc < KS / 4; ++cc) {
          const uint4 w = *reinterpret_cast<const uint4*>(K + swz<Gm>(i, qt * (KS / 4) + cc));
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t x = words[k] ^ 0x80808080u;
            const int st = 4 * cc + k;
            mma16816(s[j], qa[st][0], 0u, qa[st][1], 0u, i8_pair_f16(x, 0x5140),
                     i8_pair_f16(x, 0x5342));
          }
        }
      } else {
        // Rows 8j .. 8j + 7, chunks 4cc .. 4cc + 3 (lanes 8i .. 8i + 7 name
        // chunk 4cc + i): b0, b1 of k-steps 2cc and 2cc + 1, summed in two
        // chains.
        const int i = i0 + 8 * j + (lane & 7);
        float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int cc = 0; cc < KS / 2; ++cc) {
          uint32_t kb[4];
          ldsm_x4(kb, Ks + swz<Gm>(i, 4 * cc + (lane >> 3)));
          mma16816_bf16(s[j], qa[2 * cc][0], 0u, qa[2 * cc][1], 0u, kb[0], kb[1]);
          mma16816_bf16(s2, qa[2 * cc + 1][0], 0u, qa[2 * cc + 1][1], 0u, kb[2], kb[3]);
        }
        s[j][0] += s2[0];
        s[j][1] += s2[1];
      }
    }
    // Scale, cap and mask the logits; the tile's max per head.
    float mx = m;
    bool ok[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + 8 * j + 2 * qt + k;
        ok[j][k] = base + i < rend;
        float x;
        if constexpr (KV::INT8) x = s[j][k] * (scale_of(ksw[i], sel[i]) * scale);
        else x = s[j][k] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[j][k] = ok[j][k] ? x : kNegInf;
        mx = fmaxf(mx, s[j][k]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    m = mx;
    // P as the B operand of O^T = V^T P^T: b0 = rows 2qt, 2qt + 1 and b1 =
    // rows 8 + 2qt, + 1 of head qg. int8: p times each row's V scale, in
    // fp16 (pb). bf16: p in two halves, pb = bf16(p), pl = bf16(p - pb).
    uint32_t pb[2], pl[2];
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        p[k] = ok[j][k] ? expf(s[j][k] - mx) : 0.f;
        psum += p[k];
        if constexpr (KV::INT8) p[k] *= scale_of(vsw[i0 + 8 * j + 2 * qt + k], sel[i0 + 8 * j + 2 * qt + k]);
      }
      if constexpr (KV::INT8) {
        pb[j] = f16_pair(p[0], p[1]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(p[0], p[1]);
        const float2 hf = __bfloat1622float2(h);
        pb[j] = *reinterpret_cast<const uint32_t*>(&h);
        pl[j] = pack_bf16(p[0] - hf.x, p[1] - hf.y);
      }
    }
    l = l * corr + psum;
    // Rescale O^T: its columns are heads 2qt and 2qt + 1, whose factors
    // the lanes 8qt and 8qt + 4 hold.
    const float c_lo = __shfl_sync(0xffffffffu, corr, 8 * qt);
    const float c_hi = __shfl_sync(0xffffffffu, corr, 8 * qt + 4);
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      o[t][0] *= c_lo;
      o[t][1] *= c_hi;
      o[t][2] *= c_lo;
      o[t][3] *= c_hi;
    }
    if constexpr (KV::INT8) {
      // O^T += V^T P^T. A operand of lane (qg, qt), d-tile t: rows 2qt,
      // 2qt + 1 (a0, a1) and 8 + 2qt, + 1 (a2, a3) at d = 32 (t / 2) + 4 qg
      // + 2 (t % 2) (a0, a2) and d + 1 (a1, a3): one 4-byte word of each row.
#pragma unroll
      for (int cb = 0; cb < D / 32; ++cb) {
        const int c16 = 2 * cb + (qg >> 2), off = 4 * (qg & 3);
        const int ra = i0 + 2 * qt;
        const uint32_t xa = *reinterpret_cast<const uint32_t*>(V + swz<Gm>(ra, c16) + off) ^ 0x80808080u;
        const uint32_t xb = *reinterpret_cast<const uint32_t*>(V + swz<Gm>(ra + 1, c16) + off) ^ 0x80808080u;
        const uint32_t xc = *reinterpret_cast<const uint32_t*>(V + swz<Gm>(ra + 8, c16) + off) ^ 0x80808080u;
        const uint32_t xd = *reinterpret_cast<const uint32_t*>(V + swz<Gm>(ra + 9, c16) + off) ^ 0x80808080u;
        // Interleave rows: [a0 b0 a1 b1] and [a2 b2 a3 b3].
        const uint32_t ab01 = __byte_perm(xa, xb, 0x5140), ab23 = __byte_perm(xa, xb, 0x7362);
        const uint32_t cd01 = __byte_perm(xc, xd, 0x5140), cd23 = __byte_perm(xc, xd, 0x7362);
        mma16816(o[2 * cb], i8_pair_f16(ab01, 0x5140), i8_pair_f16(ab01, 0x5342),
                 i8_pair_f16(cd01, 0x5140), i8_pair_f16(cd01, 0x5342), pb[0], pb[1]);
        mma16816(o[2 * cb + 1], i8_pair_f16(ab23, 0x5140), i8_pair_f16(ab23, 0x5342),
                 i8_pair_f16(cd23, 0x5140), i8_pair_f16(cd23, 0x5342), pb[0], pb[1]);
      }
    } else {
      // O^T += V^T P^T, d-tile t = d 16t .. 16t + 15: ldmatrix.trans of rows
      // 0-7 and 8-15 at chunks 2t and 2t + 1 gives a0 (rows 2qt, 2qt + 1 at
      // d 16t + qg), a1 (d + 8), a2 (rows 8 + 2qt, + 1), a3; then the hi and
      // the lo half of P.
      const int vr = i0 + (lane & 7) + ((lane >> 4) << 3), vc = (lane >> 3) & 1;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        uint32_t va[4];
        ldsm_x4_trans(va, Vs + swz<Gm>(vr, 2 * t + vc));
        mma16816_bf16(o[t], va[0], va[1], va[2], va[3], pb[0], pb[1]);
        mma16816_bf16(o[t], va[0], va[1], va[2], va[3], pl[0], pl[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();             // the ring is reused below

  // This warp's state per head into shared memory.
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* acc_w = reinterpret_cast<float*>(ring);     // [WARPS][G][D]
  if (qt == 0 && qg < G) {
    m_w[warp][qg] = m;
    l_w[warp][qg] = l;
  }
  // int8: o[t][0..1] at d = 32 (t / 2) + 4 qg + 2 (t % 2), o[t][2..3] at d
  // + 1; bf16: at d = 16t + qg and d + 8.
  constexpr int d_hi = KV::INT8 ? 1 : 8;
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    const int d = KV::INT8 ? 32 * (t / 2) + 4 * qg + 2 * (t % 2) : 16 * t + qg;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int h = 2 * qt + k;
      if (h < G) {
        acc_w[(warp * G + h) * D + d] = o[t][k];
        acc_w[(warp * G + h) * D + d + d_hi] = o[t][2 + k];
      }
    }
  }
  __syncthreads();

  // Merge the warps: straight into (acc, m, l) when this is the only split
  // that holds rows, else into this split's scratch.
  const bool direct = nbusy == 1;
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int j = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][j]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += acc_w[(w * G + j) * D + d] * expf(m_w[w][j] - mx);
    if (direct) acc[(bh0 + j) * D + d] = sum;
    else acc_p[((bh0 + j) * nsplit + split) * D + d] = sum;
  }
  if (tid < G) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += l_w[w][tid] * expf(m_w[w][tid] - mx);
    if (direct) {
      m_out[bh0 + tid] = mx;
      l_out[bh0 + tid] = sum;
    } else {
      m_p[(bh0 + tid) * nsplit + split] = mx;
      l_p[(bh0 + tid) * nsplit + split] = sum;
    }
  }
  if (direct) return;

  // The last split of this (sequence, kv head) to arrive merges them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = arrivals + (int64_t)b * Hk + g;
    const bool last = atomicAdd(counter, 1) == nbusy - 1;
    if (last) atomicExch(counter, 0);   // every split has arrived
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int j = idx / D, d = idx % D;
    const int64_t at = (bh0 + j) * nsplit;
    float mx = kNegInf;
    for (int s = s_lo; s <= s_hi; ++s) mx = fmaxf(mx, __ldcg(m_p + at + s));
    float sum = 0.f, lsum = 0.f;
    for (int s = s_lo; s <= s_hi; ++s) {
      const float c = expf(__ldcg(m_p + at + s) - mx);
      sum += __ldcg(acc_p + (at + s) * D + d) * c;
      if (d == 0) lsum += __ldcg(l_p + at + s) * c;
    }
    acc[(bh0 + j) * D + d] = sum;
    if (d == 0) {
      m_out[bh0 + j] = mx;
      l_out[bh0 + j] = lsum;
    }
  }
}

// -- launch -------------------------------------------------------------------

struct Args {
  const void *q, *k_pool, *v_pool, *ks_pool, *vs_pool, *page_tables, *positions;
  void *acc, *m, *l, *acc_p, *m_p, *l_p, *arrivals;
  int B, Hq, Hk, ps, P;
  float scale, softcap;
  int window, rlo, rhi, split_pages, nsplit;
};

template <int D, int G, class KV>
int launch(const Args& a, cudaStream_t stream) {
  using T = typename KV::T;
  auto kernel = paged_decode_kernel<D, G, KV>;
  constexpr int smem = Geo<D, G, KV>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.Hk, a.B, a.nsplit);
  kernel<<<grid, Geo<D, G, KV>::THREADS, smem, stream>>>(
      (const __nv_bfloat16*)a.q, (const T*)a.k_pool, (const T*)a.v_pool,
      (const __nv_bfloat16*)a.ks_pool, (const __nv_bfloat16*)a.vs_pool,
      (const int32_t*)a.page_tables, (const int32_t*)a.positions, (float*)a.acc,
      (float*)a.m, (float*)a.l, (float*)a.acc_p, (float*)a.m_p, (float*)a.l_p,
      (int*)a.arrivals, a.Hq, a.Hk, a.ps, a.P, a.scale, a.softcap, a.window,
      a.rlo, a.rhi, a.split_pages, a.nsplit);
  return (int)cudaGetLastError();
}

// One launch: splits without rows return at once, and the last split of
// each (sequence, kv head) to finish merges (scratch is read only when
// nsplit > 1; `arrivals` [B, Hk] int32 must be 0 before the call and is 0
// again after it, and no other call may use them meanwhile).
template <class KV>
int decode(const Args& a, int D, cudaStream_t s) {
  if (a.Hk <= 0 || a.Hq % a.Hk != 0 || a.ps <= 0 || a.P <= 0 || a.rlo < 0 ||
      a.rhi > a.P || a.split_pages < 1 || a.split_pages > KV::MAX_SPLIT_PAGES ||
      a.nsplit < 1 || (long long)a.nsplit * a.split_pages < a.rhi - a.rlo) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.B == 0) return 0;
  const int G = a.Hq / a.Hk;
#define PK_DECODE_G(DD)                                \
  switch (G) {                                         \
    case 1: return launch<DD, 1, KV>(a, s);            \
    case 2: return launch<DD, 2, KV>(a, s);            \
    case 4: return launch<DD, 4, KV>(a, s);            \
    case 8: return launch<DD, 8, KV>(a, s);            \
    default: return (int)cudaErrorInvalidValue;       \
  }
  switch (D) {
    case 64: PK_DECODE_G(64)
    case 128: PK_DECODE_G(128)
    case 256: PK_DECODE_G(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PK_DECODE_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 pools [N, ps, Hk, D]; `arrivals` [B, Hk] int32, zero between calls
// and used by one call at a time (calls in order on one stream).
extern "C" int pk_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_tables, const void* positions, void* acc, void* m,
    void* l, void* acc_p, void* m_p, void* l_p, void* arrivals, int B, int Hq,
    int Hk, int D, int ps, int P, float scale, float softcap, int window,
    int rlo, int rhi, int split_pages, int nsplit, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, page_tables, positions, acc,
               m, l, acc_p, m_p, l_p, arrivals, B, Hq, Hk, ps, P, scale, softcap,
               window, rlo, rhi, split_pages, nsplit};
  return decode<Bf16Rows>(a, D, (cudaStream_t)stream);
}

// int8 pools [N, ps, Hk, D] with bf16 scales ks_pool / vs_pool [N, ps, Hk];
// `arrivals` as for pk_paged_decode.
extern "C" int pk_paged_decode_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
    const void* vs_pool, const void* page_tables, const void* positions,
    void* acc, void* m, void* l, void* acc_p, void* m_p, void* l_p,
    void* arrivals, int B, int Hq, int Hk, int D, int ps, int P, float scale,
    float softcap, int window, int rlo, int rhi, int split_pages, int nsplit,
    void* stream) {
  const Args a{q, k_pool, v_pool, ks_pool, vs_pool, page_tables, positions,
               acc, m, l, acc_p, m_p, l_p, arrivals, B, Hq, Hk, ps, P, scale,
               softcap, window, rlo, rhi, split_pages, nsplit};
  return decode<Int8Rows>(a, D, (cudaStream_t)stream);
}
