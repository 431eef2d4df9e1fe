// Paged decode attention: one query token per sequence over that
// sequence's own KV pages, emitting UNNORMALIZED online-softmax state
// (acc, m, l) over a page sub-range [rlo, rhi); the caller normalizes.
// Two entry points, two kernels: pk_paged_decode (bf16 pools) and
// pk_paged_decode_int8 (int8 pools plus a bf16 scale per (row, kv head)).
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
// context one dependent load at a time takes milliseconds.
//
// Both kernels split the context (flash-decoding, which the (acc, m, l)
// contract keeps open): the grid is (kv head, sequence, split), a split
// covers `split_pages` consecutive pages of [rlo, rhi) intersected with the
// sequence's own pages [lo, hi) (hi from the position, lo from the sliding
// window), and one CTA serves the G = Hq/Hk query heads of its kv head, so
// each K/V row crosses from memory once for all of them. A split's page ids
// are staged in shared memory first, so a row's address needs no dependent
// global load. Rows past the position or outside the window never reach a
// sum: an unwritten slot may hold NaN, and 0 x NaN is NaN.
//
// bf16 (paged_decode_split_kernel): D/8 lanes cover one row with 16-byte
// loads; each row slot of each warp is an independent online-softmax stream
// (fp32 m, l, acc in registers) that issues the loads of 4 rows before it
// uses any of them. Streams merge by exp(m - m_max): across row slots with
// warp shuffles, across warps through shared memory, across splits in a
// second small kernel. Masked rows are never loaded (they read as 0).
//
// int8 (paged_decode_int8_kernel). A row of one kv head is D int8 values
// plus a bf16 scale, half the bf16 kernel's bytes, so the work per byte
// doubles: on CUDA cores the dequantize and the G FMAs per value for q.k
// and again for p.v took more issue slots than the bytes allow (on an H100
// the same ring on CUDA cores took 0.0678 ms at chip_smoke.py's main shape,
// on tensor cores 0.0389; PERF.md, section 6). Bound: bytes. The design:
// - One launch, one CTA of 16 warps (8 at D = 256) per (kv head, sequence,
//   split), splits of SPLIT_ROWS_INT8 rows (ops/paged_attention_kernel.py);
//   the grid depends on the page-table width only, never on positions (no
//   host read, so a CUDA graph can capture it). Each CTA computes from its
//   sequence's position which splits hold rows; a CTA whose split holds
//   none returns before it loads or writes anything.
// - K, V and their scales stream through a shared-memory ring filled by
//   cp.async: 16 bytes a thread for values (chunks XOR-swizzled by row so
//   the fragment reads below are free of bank conflicts), one 4-byte copy
//   a row for each scale. A stage is 16 rows a warp: 256 rows, 68,608
//   bytes at D = 128, in 2 stages; 4 stages of 35,840 bytes at D = 64; 2
//   of 67,072 (128 rows) at D = 256. Bytes in flight grow with shared
//   memory, not registers: one CTA an SM keeps up to 134 KB in flight.
//   ptxas (sm_90a): see PERF.md, section 6; no spills.
// - q.k and p.v on tensor cores (mma.sync m16n8k16, fp16 operands, fp32
//   sums; bf16 q is exact in fp16 from 2^-14 to 65504): S = q K^T with the
//   G query heads as rows (padded to 16), then
//   O^T = V^T P^T, whose B operand is exactly S's accumulator layout, so P
//   never leaves registers. No int-to-float conversion: a byte permute
//   puts (b ^ 0x80) under the fp16 exponent of 1024 and one packed subtract
//   of 1152 leaves b, exact. The K scale multiplies each logit once (s =
//   ks (q . k8) scale); the V scale folds into the probability (p vs)
//   before its one fp16 rounding (relative 2^-11, absolute 2^-25 below
//   2^-14), where the TPU kernel keeps p v in fp32: the output may differ
//   from the fp32 plain version by 2^-11 sum p|v| / l and a little more
//   (ops/paged_attention_kernel.py, decode_error_bound).
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
//   source size 0 (zeros, scales 0) and their probability is written as 0.
//   A scale is copied as the aligned 4-byte word that holds it (the scale
//   block of one page, ps x Hk x 2 bytes, need not be a multiple of 16 or
//   even 4 bytes); a selector kept beside it says which half is the row's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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

// -- bf16 pools ---------------------------------------------------------------

struct Bf16Rows {
  using T = __nv_bfloat16;
  static constexpr int VEC = 8, UNROLL = 4;
};

template <int D, class KV>
struct Geo {
  static constexpr int VEC = KV::VEC;
  static constexpr int LPR = D / VEC;          // lanes per row (16 B each)
  static constexpr int RPW = 32 / LPR;         // rows per warp instruction
  static constexpr int STREAMS = kWarps * RPW;
};

template <int D, int G, class KV>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Hq, D]
    const typename KV::T* __restrict__ k_pool,  // [N, ps, Hk, D]
    const typename KV::T* __restrict__ v_pool,
    const int32_t* __restrict__ page_tables,    // [B, P]
    const int32_t* __restrict__ positions,      // [B]
    float* __restrict__ acc_out,                // [B, Hq, nsplit, D]
    float* __restrict__ m_out,                  // [B, Hq, nsplit]
    float* __restrict__ l_out,                  // [B, Hq, nsplit]
    int Hq, int Hk, int ps, int P, float scale, float softcap, int window,
    int rlo, int rhi, int split_pages, int nsplit) {
  using Gm = Geo<D, KV>;
  constexpr int VEC = Gm::VEC, UNROLL = KV::UNROLL;
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = lane / Gm::LPR, col = lane % Gm::LPR;
  const int stream = warp * Gm::RPW + slot;
  const int h0 = g * G;

  __shared__ int pages_s[kMaxSplitPages];
  __shared__ float m_w[kWarps][G], l_w[kWarps][G];
  __shared__ float acc_w[kWarps][G][D];

  const int pos = positions[b];
  const int hi = min(pos / ps + 1, rhi);
  int lo = window > 0 ? max((pos - window + 1) / ps, 0) : 0;
  lo = max(lo, rlo);
  const int p0 = max(lo, rlo + split * split_pages);
  const int p1 = min(hi, rlo + (split + 1) * split_pages);
  for (int i = tid; i < p1 - p0; i += kThreads) {
    pages_s[i] = page_tables[(int64_t)b * P + p0 + i];
  }

  float qr[G][VEC];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int c = 0; c < VEC / 8; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          q + ((int64_t)b * Hq + h0 + j) * D + col * VEC + c * 8));
      unpack8(raw, qr[j] + c * 8);
    }
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  }
  __syncthreads();

  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int row0 = p0 * ps, row1 = p1 * ps;
  for (int base = row0; base < row1; base += Gm::STREAMS * UNROLL) {
    uint4 kraw[UNROLL], vraw[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * Gm::STREAMS + stream;
      ok[u] = r < row1 && r <= pos && (window <= 0 || r > pos - window);
      kraw[u] = zero;
      vraw[u] = zero;
      if (ok[u]) {
        const int page = pages_s[r / ps - p0];
        const int64_t row = ((int64_t)page * ps + r % ps) * Hk + g;
        kraw[u] = __ldg(reinterpret_cast<const uint4*>(k_pool + row * D + col * VEC));
        vraw[u] = __ldg(reinterpret_cast<const uint4*>(v_pool + row * D + col * VEC));
      }
    }
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      unpack8(kraw[u], kf);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d += qr[j][e] * kf[e];
#pragma unroll
        for (int o = Gm::LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        float x = d * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u][j] = ok[u] ? x : kNegInf;
      }
    }
    float p[UNROLL][G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mx = fmaxf(mx, s[u][j]);
      const float corr = expf(m[j] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u][j] = ok[u] ? expf(s[u][j] - mx) : 0.f;
        psum += p[u][j];
      }
      l[j] = l[j] * corr + psum;
      m[j] = mx;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[VEC];
      unpack8(vraw[u], vf);
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] += p[u][j] * vf[e];
    }
  }

  // Merge the row-slot streams of this warp (lanes col, col + LPR, ...).
#pragma unroll
  for (int o = Gm::LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[j], o);
      const float mn = fmaxf(m[j], mo);
      const float c1 = expf(m[j] - mn), c2 = expf(mo - mn);
      l[j] = l[j] * c1 + lo_ * c2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], o);
        acc[j][e] = acc[j][e] * c1 + ao * c2;
      }
      m[j] = mn;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_w[warp][j][col * VEC + e] = acc[j][e];
      if (col == 0) {
        m_w[warp][j] = m[j];
        l_w[warp][j] = l[j];
      }
    }
  }
  __syncthreads();

  // Merge the warps; write this split's state.
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][j]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += acc_w[w][j][d] * expf(m_w[w][j] - mx);
    acc_out[(((int64_t)b * Hq + h0 + j) * nsplit + split) * D + d] = a;
  }
  if (tid < G) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += l_w[w][tid] * expf(m_w[w][tid] - mx);
    const int64_t at = ((int64_t)b * Hq + h0 + tid) * nsplit + split;
    m_out[at] = mx;
    l_out[at] = sum;
  }
}

// Merge the splits of each (sequence, query head): one CTA of D threads.
__global__ void paged_decode_merge_kernel(
    const float* __restrict__ acc_p,   // [B * Hq, nsplit, D]
    const float* __restrict__ m_p,     // [B * Hq, nsplit]
    const float* __restrict__ l_p,
    float* __restrict__ acc,           // [B * Hq, D]
    float* __restrict__ m,             // [B * Hq]
    float* __restrict__ l, int nsplit, int D) {
  const int bh = blockIdx.x, d = threadIdx.x;
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m_p[(int64_t)bh * nsplit + s]);
  float a = 0.f, sum = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float c = expf(m_p[(int64_t)bh * nsplit + s] - mx);
    a += acc_p[((int64_t)bh * nsplit + s) * D + d] * c;
    sum += l_p[(int64_t)bh * nsplit + s] * c;
  }
  acc[(int64_t)bh * D + d] = a;
  if (d == 0) {
    m[bh] = mx;
    l[bh] = sum;
  }
}

// -- int8 pools ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// The bf16 scale held in half `sel` (0 low, 1 high) of a 4-byte word.
__device__ __forceinline__ float scale_of(uint32_t w, uint32_t sel) {
  return __uint_as_float(sel ? (w & 0xFFFF0000u) : (w << 16));
}

template <int D, int G>
struct Geo8 {
  // 16 warps a CTA, 8 at D = 256 (whose 182 registers a thread would spill
  // under 16 warps' cap of 128).
  static constexpr int WARPS = D == 256 ? 8 : 16, THREADS = 32 * WARPS;
  static constexpr int R = 16 * WARPS;          // rows per ring stage, 16 a warp
  static constexpr int STAGES = D == 64 ? 4 : 2; // 140, 134 and 131 KB of ring
  static constexpr int CPR = D / 16;            // 16-byte chunks per row
  static constexpr int SWZ = CPR < 8 ? CPR - 1 : 7;   // chunk XOR row bits
  static constexpr int KS = D / 16;             // k-steps of q.k; d-tiles of p.v
  static constexpr int KV_BYTES = R * D;
  // K [R][D] int8, V [R][D] int8 (16-byte chunks swizzled), K scale words
  // [R], V scale words [R], scale selectors [R].
  static constexpr int STAGE = 2 * KV_BYTES + 12 * R;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(WARPS * G * D * 4 <= SMEM, "the warp merge reuses the ring");
};

// Byte offset of (row i, 16-byte chunk c) in a stage's K or V block.
template <int D, int G>
__device__ __forceinline__ int swz(int i, int c) {
  return i * D + ((c ^ (i & Geo8<D, G>::SWZ)) << 4);
}

// The grid is (kv head, sequence, split), fixed by the page-table width.
template <int D, int G>
__global__ void __launch_bounds__(Geo8<D, G>::THREADS) paged_decode_int8_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Hq, D]
    const int8_t* __restrict__ k_pool,          // [N, ps, Hk, D]
    const int8_t* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ ks_pool,  // [N, ps, Hk]
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
  using Gm = Geo8<D, G>;
  constexpr int R = Gm::R, STAGES = Gm::STAGES, KS = Gm::KS;
  constexpr int WARPS = Gm::WARPS, THREADS = Gm::THREADS;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int pages_s[kMaxSplitPagesInt8];
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
  // 8-15, are 0). Lane column group qt takes the D/4 values from qt D/4:
  // k-step s pairs values 4s, 4s + 1 (a0) and 4s + 2, 4s + 3 (a2), which
  // matches the bytes of K the same lanes take below.
  uint32_t qa[KS][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) qa[s][0] = qa[s][1] = 0u;
  if (qg < G) {
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
  }
  // Online-softmax state of head qg (m shared by the 4 lanes of the head,
  // l a partial sum per lane), and O^T tiles: o[t][0..1] = O[heads 2qt,
  // 2qt + 1] at d = 32 (t / 2) + 4 qg + 2 (t % 2), o[t][2..3] at d + 1.
  float m = kNegInf, l = 0.f;
  float o[KS][4];
#pragma unroll
  for (int t = 0; t < KS; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  __syncthreads();             // pages_s

  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  // Fill stage c % STAGES with rows [rstart + c R, + R); rows at or past
  // rend land as zeros (values and scales) without being read.
  auto issue = [&](int c) {
    const int st = c % STAGES;
    const uint32_t kdst = ring_s + st * Gm::STAGE;
    const uint32_t vdst = kdst + Gm::KV_BYTES, sdst = kdst + 2 * Gm::KV_BYTES;
    uint32_t* sel = reinterpret_cast<uint32_t*>(ring + st * Gm::STAGE + 2 * Gm::KV_BYTES) + 2 * R;
    const int base = rstart + c * R;
    for (int idx = tid; idx < R * Gm::CPR; idx += THREADS) {
      const int i = idx / Gm::CPR, c16 = idx % Gm::CPR, r = base + i;
      const bool ok = r < rend;
      int64_t row = 0;
      if (ok) row = ((int64_t)pages_s[r / ps - p0] * ps + r % ps) * Hk + g;
      const int at = swz<D, G>(i, c16);
      cp_async16(kdst + at, k_pool + row * D + c16 * 16, ok);
      cp_async16(vdst + at, v_pool + row * D + c16 * 16, ok);
    }
    for (int i = tid; i < R; i += THREADS) {
      const int r = base + i;
      const bool ok = r < rend;
      int64_t e = 0;
      if (ok) e = ((int64_t)pages_s[r / ps - p0] * ps + r % ps) * Hk + g;
      cp_async4(sdst + 4 * i, ks_pool + (e & ~(int64_t)1), ok);
      cp_async4(sdst + 4 * (R + i), vs_pool + (e & ~(int64_t)1), ok);
      sel[i] = (uint32_t)(e & 1);
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

    // S = q K^T over the warp's rows i0 + 8j + n: s[j][0..1] = S[head qg]
    // [rows 8j + 2qt, + 1]. The B operand of lane (qg, qt) is row 8j + qg,
    // bytes qt D/4 + 4s .. + 3 at k-step s.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const int i = i0 + 8 * j + qg;
#pragma unroll
      for (int cc = 0; cc < KS / 4; ++cc) {
        const uint4 w = *reinterpret_cast<const uint4*>(K + swz<D, G>(i, qt * (KS / 4) + cc));
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t x = words[k] ^ 0x80808080u;
          const int st = 4 * cc + k;
          mma16816(s[j], qa[st][0], 0u, qa[st][1], 0u, i8_pair_f16(x, 0x5140),
                   i8_pair_f16(x, 0x5342));
        }
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
        float x = s[j][k] * (scale_of(ksw[i], sel[i]) * scale);
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[j][k] = ok[j][k] ? x : kNegInf;
        mx = fmaxf(mx, s[j][k]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    m = mx;
    // P scaled by each row's V scale, as the B operand of O^T = V^T P^T:
    // b0 = rows 2qt, 2qt + 1 and b1 = rows 8 + 2qt, + 1 of head qg.
    uint32_t pb[2];
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + 8 * j + 2 * qt + k;
        p[k] = ok[j][k] ? expf(s[j][k] - mx) : 0.f;
        psum += p[k];
        p[k] *= scale_of(vsw[i], sel[i]);
      }
      pb[j] = f16_pair(p[0], p[1]);
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
    // O^T += V^T P^T. A operand of lane (qg, qt), d-tile t: rows 2qt,
    // 2qt + 1 (a0, a1) and 8 + 2qt, + 1 (a2, a3) at d = 32 (t / 2) + 4 qg
    // + 2 (t % 2) (a0, a2) and d + 1 (a1, a3): one 4-byte word of each row.
#pragma unroll
    for (int cb = 0; cb < D / 32; ++cb) {
      const int c16 = 2 * cb + (qg >> 2), off = 4 * (qg & 3);
      const int ra = i0 + 2 * qt;
      const uint32_t xa = *reinterpret_cast<const uint32_t*>(V + swz<D, G>(ra, c16) + off) ^ 0x80808080u;
      const uint32_t xb = *reinterpret_cast<const uint32_t*>(V + swz<D, G>(ra + 1, c16) + off) ^ 0x80808080u;
      const uint32_t xc = *reinterpret_cast<const uint32_t*>(V + swz<D, G>(ra + 8, c16) + off) ^ 0x80808080u;
      const uint32_t xd = *reinterpret_cast<const uint32_t*>(V + swz<D, G>(ra + 9, c16) + off) ^ 0x80808080u;
      // Interleave rows: [a0 b0 a1 b1] and [a2 b2 a3 b3].
      const uint32_t ab01 = __byte_perm(xa, xb, 0x5140), ab23 = __byte_perm(xa, xb, 0x7362);
      const uint32_t cd01 = __byte_perm(xc, xd, 0x5140), cd23 = __byte_perm(xc, xd, 0x7362);
      mma16816(o[2 * cb], i8_pair_f16(ab01, 0x5140), i8_pair_f16(ab01, 0x5342),
               i8_pair_f16(cd01, 0x5140), i8_pair_f16(cd01, 0x5342), pb[0], pb[1]);
      mma16816(o[2 * cb + 1], i8_pair_f16(ab23, 0x5140), i8_pair_f16(ab23, 0x5342),
               i8_pair_f16(cd23, 0x5140), i8_pair_f16(cd23, 0x5342), pb[0], pb[1]);
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
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    const int d = 32 * (t / 2) + 4 * qg + 2 * (t % 2);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int h = 2 * qt + k;
      if (h < G) {
        acc_w[(warp * G + h) * D + d] = o[t][k];
        acc_w[(warp * G + h) * D + d + 1] = o[t][2 + k];
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

template <int D, int G>
int launch_bf16(const Args& a, float* acc, float* m, float* l, cudaStream_t stream) {
  using T = __nv_bfloat16;
  dim3 grid(a.Hk, a.B, a.nsplit);
  paged_decode_split_kernel<D, G, Bf16Rows><<<grid, kThreads, 0, stream>>>(
      (const T*)a.q, (const T*)a.k_pool, (const T*)a.v_pool,
      (const int32_t*)a.page_tables, (const int32_t*)a.positions, acc, m, l,
      a.Hq, a.Hk, a.ps, a.P, a.scale, a.softcap, a.window, a.rlo, a.rhi,
      a.split_pages, a.nsplit);
  return (int)cudaGetLastError();
}

template <int D, int G>
int launch_int8(const Args& a, cudaStream_t stream) {
  auto kernel = paged_decode_int8_kernel<D, G>;
  constexpr int smem = Geo8<D, G>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.Hk, a.B, a.nsplit);
  kernel<<<grid, Geo8<D, G>::THREADS, smem, stream>>>(
      (const __nv_bfloat16*)a.q, (const int8_t*)a.k_pool, (const int8_t*)a.v_pool,
      (const __nv_bfloat16*)a.ks_pool, (const __nv_bfloat16*)a.vs_pool,
      (const int32_t*)a.page_tables, (const int32_t*)a.positions, (float*)a.acc,
      (float*)a.m, (float*)a.l, (float*)a.acc_p, (float*)a.m_p, (float*)a.l_p,
      (int*)a.arrivals, a.Hq, a.Hk, a.ps, a.P, a.scale, a.softcap, a.window,
      a.rlo, a.rhi, a.split_pages, a.nsplit);
  return (int)cudaGetLastError();
}

int check_args(const Args& a, int max_split_pages) {
  if (a.Hk <= 0 || a.Hq % a.Hk != 0 || a.ps <= 0 || a.P <= 0 || a.rlo < 0 ||
      a.rhi > a.P || a.split_pages < 1 || a.split_pages > max_split_pages ||
      a.nsplit < 1 || (long long)a.nsplit * a.split_pages < a.rhi - a.rlo) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// With nsplit == 1 the split kernel writes (acc, m, l) directly; otherwise it
// writes per-split state into the caller's scratch (acc_p [B, Hq, nsplit, D],
// m_p and l_p [B, Hq, nsplit]) and a second launch merges it.
int decode_bf16(const Args& a, int D, cudaStream_t s) {
  if (int err = check_args(a, kMaxSplitPages)) return err;
  if (a.B == 0) return 0;
  const int G = a.Hq / a.Hk;
  float* out_acc = (float*)(a.nsplit == 1 ? a.acc : a.acc_p);
  float* out_m = (float*)(a.nsplit == 1 ? a.m : a.m_p);
  float* out_l = (float*)(a.nsplit == 1 ? a.l : a.l_p);
  int err;
#define PK_BF16_G(DD)                                                  \
  switch (G) {                                                         \
    case 1: err = launch_bf16<DD, 1>(a, out_acc, out_m, out_l, s); break; \
    case 2: err = launch_bf16<DD, 2>(a, out_acc, out_m, out_l, s); break; \
    case 4: err = launch_bf16<DD, 4>(a, out_acc, out_m, out_l, s); break; \
    case 8: err = launch_bf16<DD, 8>(a, out_acc, out_m, out_l, s); break; \
    default: return (int)cudaErrorInvalidValue;                        \
  }
  switch (D) {
    case 64: PK_BF16_G(64) break;
    case 128: PK_BF16_G(128) break;
    case 256: PK_BF16_G(256) break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PK_BF16_G
  if (err != 0 || a.nsplit == 1) return err;
  paged_decode_merge_kernel<<<a.B * a.Hq, D, 0, s>>>(
      (const float*)a.acc_p, (const float*)a.m_p, (const float*)a.l_p, (float*)a.acc,
      (float*)a.m, (float*)a.l, a.nsplit, D);
  return (int)cudaGetLastError();
}

// One launch: splits without rows return at once, and the last split of
// each (sequence, kv head) to finish merges (scratch is read only when
// nsplit > 1; `arrivals` [B, Hk] int32 must be 0 before the call and is 0
// again after it, and no other call may use them meanwhile).
int decode_int8(const Args& a, int D, cudaStream_t s) {
  if (int err = check_args(a, kMaxSplitPagesInt8)) return err;
  if (a.B == 0) return 0;
  const int G = a.Hq / a.Hk;
#define PK_INT8_G(DD)                                  \
  switch (G) {                                         \
    case 1: return launch_int8<DD, 1>(a, s);           \
    case 2: return launch_int8<DD, 2>(a, s);           \
    case 4: return launch_int8<DD, 4>(a, s);           \
    case 8: return launch_int8<DD, 8>(a, s);           \
    default: return (int)cudaErrorInvalidValue;        \
  }
  switch (D) {
    case 64: PK_INT8_G(64)
    case 128: PK_INT8_G(128)
    case 256: PK_INT8_G(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PK_INT8_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pk_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_tables, const void* positions, void* acc, void* m,
    void* l, void* acc_p, void* m_p, void* l_p, int B, int Hq, int Hk, int D,
    int ps, int P, float scale, float softcap, int window, int rlo, int rhi,
    int split_pages, int nsplit, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, page_tables, positions, acc,
               m, l, acc_p, m_p, l_p, nullptr, B, Hq, Hk, ps, P, scale, softcap,
               window, rlo, rhi, split_pages, nsplit};
  return decode_bf16(a, D, (cudaStream_t)stream);
}

// int8 pools [N, ps, Hk, D] with bf16 scales ks_pool / vs_pool [N, ps, Hk];
// `arrivals` [B, Hk] int32, zero between calls and used by one call at a
// time (calls in order on one stream).
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
  return decode_int8(a, D, (cudaStream_t)stream);
}
