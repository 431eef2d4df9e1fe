// Paged decode attention: one query token per sequence over that
// sequence's own KV pages, emitting UNNORMALIZED online-softmax state
// (acc, m, l) over a page sub-range [rlo, rhi); the caller normalizes.
// Two entry points share one kernel template over the KV row type:
// pk_paged_decode (bf16 pools) and pk_paged_decode_int8 (int8 pools plus a
// bf16 scale per (row, kv head)).
//
// Replaces: polykey_tpu/ops/paged_attention_kernel.py, _decode_call (body
// _kernel), reached from paged_attention_decode: its bf16 path and its
// quantized=True path (int8 KV).
//
// Bound on this card: bytes. Each step reads every visible K and V row of
// every sequence once (2 x ctx x Hk x D x 2 bytes) and does 4 x Hq x ctx x D
// flops on them: about 1 flop per byte, far below the ~295 flops per byte at
// which bf16 tensor cores would become the limit. With one query per
// sequence the danger is latency, not bandwidth: a CTA that walks a 4096-row
// context one dependent load at a time takes milliseconds.
//
// Design (split-KV, the flash-decoding form the (acc, m, l) contract keeps
// open): the grid is (kv head, sequence, split). A split covers
// `split_pages` consecutive pages of [rlo, rhi), intersected with the
// sequence's own pages [lo, hi) (hi from the position, lo from the sliding
// window), so the garbage tail of the page table is never read and short
// sequences leave most splits empty. One CTA serves the Hq/Hk query heads
// that share the kv head, so each K/V row crosses from memory once for all
// of them. The split's page ids are staged in shared memory first, so a
// row's address needs no dependent global load. Inside the CTA, D/8 lanes
// cover one row with 16-byte loads, so a warp reads 32/(D/8) rows at once;
// each such row slot of each warp is an independent online-softmax stream
// (fp32 m, l, acc in registers) and issues the loads of 4 rows before it
// uses any of them. Streams merge by exp(m - m_max): across row slots with
// warp shuffles, across warps through shared memory, across splits in a
// second small kernel. Rows past the position or outside the window are
// never loaded (their K and V read as 0) and their probability is exactly
// 0, so stale V (NaN in an unwritten slot) never reaches a sum.
//
// int8 KV: a row is D bytes plus one bf16 scale per kv head, so D/16 lanes
// cover it with 16-byte loads (16 values a lane), and each stream keeps 2
// rows in flight instead of 4 (the same rows per warp, half the registers
// of 16-value rows at 4). Values dequantize in fp32 registers, k8 * ks and
// v8 * vs, the reference kernel's arithmetic. The scales of a row that is
// not loaded read as 0, so a stale scale (0 x NaN) cannot reach a sum
// either. Bound: bytes, half the bf16 kernel's for the same rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplitPages = 64;
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

// 16 int8 values of one 16-byte load, sign-extended, as fp32 (exact).
__device__ __forceinline__ void unpack16_i8(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * i + k] = (float)((int)(w[i] << (24 - 8 * k)) >> 24);
}

// KV row types: the element, values per 16-byte load (VEC), rows in flight
// per stream (UNROLL), and whether a bf16 scale per (row, kv head) rides
// beside the row.
struct Bf16Rows {
  using T = __nv_bfloat16;
  static constexpr int VEC = 8, UNROLL = 4;
  static constexpr bool kScaled = false;
  __device__ static void unpack(const uint4& raw, float* out) { unpack8(raw, out); }
};

struct Int8Rows {
  using T = int8_t;
  static constexpr int VEC = 16, UNROLL = 2;
  static constexpr bool kScaled = true;
  __device__ static void unpack(const uint4& raw, float* out) { unpack16_i8(raw, out); }
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
    const __nv_bfloat16* __restrict__ ks_pool,  // [N, ps, Hk] (int8 rows only)
    const __nv_bfloat16* __restrict__ vs_pool,
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
    float ksc[UNROLL], vsc[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * Gm::STREAMS + stream;
      ok[u] = r < row1 && r <= pos && (window <= 0 || r > pos - window);
      kraw[u] = zero;
      vraw[u] = zero;
      ksc[u] = 0.f;
      vsc[u] = 0.f;
      if (ok[u]) {
        const int page = pages_s[r / ps - p0];
        const int64_t row = ((int64_t)page * ps + r % ps) * Hk + g;
        kraw[u] = __ldg(reinterpret_cast<const uint4*>(k_pool + row * D + col * VEC));
        vraw[u] = __ldg(reinterpret_cast<const uint4*>(v_pool + row * D + col * VEC));
        if constexpr (KV::kScaled) {
          ksc[u] = __bfloat162float(ks_pool[row]);
          vsc[u] = __bfloat162float(vs_pool[row]);
        }
      }
    }
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      KV::unpack(kraw[u], kf);
      if constexpr (KV::kScaled) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] *= ksc[u];
      }
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
      KV::unpack(vraw[u], vf);
      if constexpr (KV::kScaled) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vf[e] *= vsc[u];
      }
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

struct Args {
  const void *q, *k_pool, *v_pool, *ks_pool, *vs_pool, *page_tables, *positions;
  void *acc, *m, *l;
  int B, Hq, Hk, ps, P;
  float scale, softcap;
  int window, rlo, rhi, split_pages, nsplit;
};

template <int D, int G, class KV>
int launch_split(const Args& a, float* acc, float* m, float* l, cudaStream_t stream) {
  using T = typename KV::T;
  dim3 grid(a.Hk, a.B, a.nsplit);
  paged_decode_split_kernel<D, G, KV><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)a.q, (const T*)a.k_pool, (const T*)a.v_pool,
      (const __nv_bfloat16*)a.ks_pool, (const __nv_bfloat16*)a.vs_pool,
      (const int32_t*)a.page_tables, (const int32_t*)a.positions, acc, m, l,
      a.Hq, a.Hk, a.ps, a.P, a.scale, a.softcap, a.window, a.rlo, a.rhi,
      a.split_pages, a.nsplit);
  return (int)cudaGetLastError();
}

template <int D, class KV>
int launch_d(const Args& a, int G, float* acc, float* m, float* l, cudaStream_t s) {
  switch (G) {
    case 1: return launch_split<D, 1, KV>(a, acc, m, l, s);
    case 2: return launch_split<D, 2, KV>(a, acc, m, l, s);
    case 4: return launch_split<D, 4, KV>(a, acc, m, l, s);
    case 8: return launch_split<D, 8, KV>(a, acc, m, l, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// With nsplit == 1 the split kernel writes (acc, m, l) directly; otherwise it
// writes per-split state into the caller's scratch (acc_p [B, Hq, nsplit, D],
// m_p and l_p [B, Hq, nsplit]) and a second launch merges it.
template <class KV>
int decode(const Args& a, int D, void* acc_p, void* m_p, void* l_p, void* stream) {
  if (a.Hk <= 0 || a.Hq % a.Hk != 0 || a.ps <= 0 || a.P <= 0 || a.rlo < 0 ||
      a.rhi > a.P || a.split_pages < 1 || a.split_pages > kMaxSplitPages ||
      a.nsplit < 1 || (long long)a.nsplit * a.split_pages < a.rhi - a.rlo) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.B == 0) return 0;
  const int G = a.Hq / a.Hk;
  cudaStream_t s = (cudaStream_t)stream;
  float* out_acc = (float*)(a.nsplit == 1 ? a.acc : acc_p);
  float* out_m = (float*)(a.nsplit == 1 ? a.m : m_p);
  float* out_l = (float*)(a.nsplit == 1 ? a.l : l_p);
  int err;
  switch (D) {
    case 64: err = launch_d<64, KV>(a, G, out_acc, out_m, out_l, s); break;
    case 128: err = launch_d<128, KV>(a, G, out_acc, out_m, out_l, s); break;
    case 256: err = launch_d<256, KV>(a, G, out_acc, out_m, out_l, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || a.nsplit == 1) return err;
  paged_decode_merge_kernel<<<a.B * a.Hq, D, 0, s>>>(
      (const float*)acc_p, (const float*)m_p, (const float*)l_p, (float*)a.acc,
      (float*)a.m, (float*)a.l, a.nsplit, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pk_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_tables, const void* positions, void* acc, void* m,
    void* l, void* acc_p, void* m_p, void* l_p, int B, int Hq, int Hk, int D,
    int ps, int P, float scale, float softcap, int window, int rlo, int rhi,
    int split_pages, int nsplit, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, page_tables, positions, acc,
               m, l, B, Hq, Hk, ps, P, scale, softcap, window, rlo, rhi,
               split_pages, nsplit};
  return decode<Bf16Rows>(a, D, acc_p, m_p, l_p, stream);
}

// int8 pools [N, ps, Hk, D] with bf16 scales ks_pool / vs_pool [N, ps, Hk].
extern "C" int pk_paged_decode_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
    const void* vs_pool, const void* page_tables, const void* positions,
    void* acc, void* m, void* l, void* acc_p, void* m_p, void* l_p, int B,
    int Hq, int Hk, int D, int ps, int P, float scale, float softcap,
    int window, int rlo, int rhi, int split_pages, int nsplit, void* stream) {
  const Args a{q, k_pool, v_pool, ks_pool, vs_pool, page_tables, positions,
               acc, m, l, B, Hq, Hk, ps, P, scale, softcap, window, rlo, rhi,
               split_pages, nsplit};
  return decode<Int8Rows>(a, D, acc_p, m_p, l_p, stream);
}
