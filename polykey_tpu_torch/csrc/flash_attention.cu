// Blockwise causal attention with an online softmax over a contiguous KV
// window (the prefill path): out[b, t, h] = softmax(q.k^T * scale) v over
// the keys at absolute positions kv_pos <= q_pos (and inside the sliding
// window), with GQA and an optional logit soft-cap.
//
// Replaces: polykey_tpu/ops/flash_attention.py, _flash_bhsd (body _kernel),
// reached from flash_attention through paged_attention on prefill.
//
// Bound on this card: operations. At prefill widths a 64-query tile does
// 4 x 64 x D flops per key against 2 x D x 2 bytes of that key's K and V
// row, 64 flops per byte before reuse across query tiles and heads of a
// group, so only the tensor cores' rate can bound it.
//
// Design: one CTA per (query head, batch row, 64-query tile), one
// warpgroup (128 threads); the score, probability and output tiles never
// touch shared memory.
// - Tiles: 64 queries against BK keys, BK = 64 (32 at D = 256, where the
//   O accumulator alone is 128 registers a thread). Q, K and V sit in
//   shared memory in the 128-byte-swizzled layout that wgmma's descriptors
//   name: rows of 64 bf16 values, 8-row atoms of 1024 bytes, one atom
//   column per 64 of D.
// - Ring: K and V stream through STAGES = 2 stages of BK keys, filled by
//   cp.async 16 bytes a thread; tile j+1 is in flight while the tensor
//   cores work on tile j (cp.async.wait_group, then a proxy fence so that
//   wgmma's reads see the copies).
// - S = Q K^T: wgmma m64nBKk16, Q and K both K-major from shared memory.
// - Softmax on the accumulator registers: each row lives on the 4 lanes of
//   a quad, so its max reduces over two shuffles; exp2 with log2(e) folded
//   into the scale; the running sum stays per lane until the epilogue.
// - O += P V: wgmma m64nDk16 (m64n128k16 per half at D = 256), P packed to
//   bf16 in registers as the A operand (the accumulator layout of S is the
//   A-fragment layout of this product), V from shared memory MN-major (the
//   transpose flag). O stays in fp32 registers and is rescaled there.
// - Epilogue: O / l, rounded to bf16 once, stored from registers.
// Key tiles wholly after the tile's largest position, or wholly before its
// window, are never loaded; the position mask runs only on tiles that
// straddle a boundary. Stale rows: the window is gathered from pages whose
// unwritten slots may hold anything (NaN in a dequantized int8 window),
// and 0 x NaN is NaN, so every row outside [kv_lo, kv_hi) is copied with a
// source size of 0 (cp.async zero-fills it) and masked probabilities are
// exactly 0. Padding rows (position -1) see no key and produce 0. Query
// tiles are issued largest first (the causal triangle puts the most work
// in the last tiles), so the tail of the grid runs on a full card.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per CTA: the M of one wgmma
constexpr int STAGES = 2;      // K/V ring depth
constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Keys per ring stage, and shared memory of one CTA from a 1024-byte
// aligned base: the Q tile (64 rows x D), then the ring's stages, each a K
// tile and a V tile of BK rows x D. At D = 256 the O accumulator alone is
// 128 registers a thread, so the key tile halves there to keep S, P and
// the copies' addresses out of local memory.
template <int D>
struct Layout {
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int Q_TILE = BQ * D * 2;
  static constexpr int KV_TILE = BK * D * 2;
  static constexpr int Q = 0;
  static constexpr int RING = Q_TILE;
  static constexpr int BYTES = RING + STAGES * 2 * KV_TILE;
};

// ROWS rows of D values into a swizzled tile: row r from src + (r0 + r) *
// stride, zero-filled where r0 + r lies outside [lo, hi).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int64_t stride, int r0, int lo, int hi,
                                          int tid) {
  constexpr int C = D / 8;
#pragma unroll
  for (int it = 0; it < ROWS * C / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / C, c = i % C;
    const int s = r0 + r;
    const bool ok = s >= lo && s < hi;
    cp_async16(dst + swizzle<ROWS>(r, c), ok ? src + s * stride + c * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, T, Hq, D]
    const __nv_bfloat16* __restrict__ k,   // [B, S, Hk, D]
    const __nv_bfloat16* __restrict__ v,
    const int32_t* __restrict__ qpos,      // [B, T], -1 marks padding
    __nv_bfloat16* __restrict__ out,       // [B, T, Hq, D]
    int T, int S, int Hq, int Hk, float scale, float softcap, int window) {
  using Lay = Layout<D>;
  constexpr int BK = Lay::BK;
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ unsigned char smem_raw[];
  __shared__ int pos_s[BQ];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + Lay::Q;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;     // largest tiles first
  const int g = h / (Hq / Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * BQ;

  if (tid < BQ) pos_s[tid] = q0 + tid < T ? qpos[(int64_t)b * T + q0 + tid] : -1;
  __syncthreads();
  // Tile-wide largest position, smallest valid one, smallest of all (-1
  // when the tile holds padding); every warp reduces the same 64 values.
  int mx, mn, mn_any;
  {
    const int a = pos_s[lane], c = pos_s[lane + 32];
    mx = max(a, c);
    mn = min(a < 0 ? INT_MAX : a, c < 0 ? INT_MAX : c);
    mn_any = min(a, c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mn_any = min(mn_any, __shfl_xor_sync(0xffffffffu, mn_any, o));
    }
  }
  // Keys any row of this tile can see: [kv_lo, kv_hi).
  const int kv_hi = min(S, mx + 1);
  const int kv_lo = (window > 0 && mn != INT_MAX) ? max(0, mn - window + 1) : 0;
  const int j_lo = kv_lo / BK;
  const int j_hi = kv_hi > 0 ? (kv_hi + BK - 1) / BK : 0;

  // This thread's two rows of every accumulator: quad row r_a and r_a + 8
  // of its warp's 16; columns 2 * (lane % 4) + {0, 1} of each 8.
  const int r_a = warp * 16 + (lane >> 2), r_b = r_a + 8;
  const int p_a = pos_s[r_a], p_b = pos_s[r_b];
  const int col0 = 2 * (lane & 3);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  const int64_t kv_stride = (int64_t)Hk * D;
  const __nv_bfloat16* k_src = k + ((int64_t)b * S * Hk + g) * D;
  const __nv_bfloat16* v_src = v + ((int64_t)b * S * Hk + g) * D;
  const float scale_log2 = scale * kLog2e;
  const float cap_log2 = softcap * kLog2e;
  const float inv_cap = softcap > 0.f ? scale / softcap : 0.f;

  if (j_lo < j_hi) {
    // Prologue: Q with the first STAGES - 1 key tiles, one group each.
    load_tile<D, BQ>(q_s, q + ((int64_t)b * T * Hq + h) * D, (int64_t)Hq * D, q0, 0, T, tid);
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (j_lo + st < j_hi) {
        const uint32_t stage = base + Lay::RING + st * 2 * Lay::KV_TILE;
        load_tile<D, BK>(stage, k_src, kv_stride, (j_lo + st) * BK, kv_lo, kv_hi, tid);
        load_tile<D, BK>(stage + Lay::KV_TILE, v_src, kv_stride, (j_lo + st) * BK, kv_lo,
                     kv_hi, tid);
      }
      cp_async_commit();
    }

    for (int j = j_lo; j < j_hi; ++j) {
      const int it = j - j_lo;
      const int jn = j + STAGES - 1;
      if (jn < j_hi) {
        const uint32_t stage = base + Lay::RING + ((it + STAGES - 1) % STAGES) * 2 * Lay::KV_TILE;
        load_tile<D, BK>(stage, k_src, kv_stride, jn * BK, kv_lo, kv_hi, tid);
        load_tile<D, BK>(stage + Lay::KV_TILE, v_src, kv_stride, jn * BK, kv_lo, kv_hi, tid);
      }
      cp_async_commit();
      cp_async_wait<STAGES - 1>();       // tile j (and Q) has landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();

      const uint32_t k_s = base + Lay::RING + (it % STAGES) * 2 * Lay::KV_TILE;
      const uint32_t v_s = k_s + Lay::KV_TILE;

      // S = Q K^T over D in steps of 16 (32 bytes inside an atom column).
      fence_regs<BK / 2>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_atom = (kk & 3) * 32;
        const uint64_t dq = smem_desc(q_s + (kk >> 2) * (BQ * 128) + in_atom, 16);
        const uint64_t dk = smem_desc(k_s + (kk >> 2) * (BK * 128) + in_atom, 16);
        if constexpr (BK == 64) {
          wgmma_ss_n64(s, dq, dk, kk > 0);
        } else {
          wgmma_ss_n32(s, dq, dk, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<BK / 2>(s);

      // Logits in log2 units; s[4n + e] is row (e < 2 ? r_a : r_b), key
      // k0 + 8n + col0 + (e & 1).
      const int k0 = j * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = softcap > 0.f ? cap_log2 * tanhf(s[i] * inv_cap) : s[i] * scale_log2;
      }
      const bool full = k0 + BK - 1 <= mn_any && k0 + BK <= S &&
                        (window <= 0 || k0 > mx - window);
      if (!full) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kvp = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int p = (i & 2) ? p_b : p_a;
          const bool ok = kvp <= p && kvp < S && (window <= 0 || kvp > p - window);
          s[i] = ok ? s[i] : kNegInf;
        }
      }
      float x_a = kNegInf, x_b = kNegInf;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (i & 2) x_b = fmaxf(x_b, s[i]);
        else x_a = fmaxf(x_a, s[i]);
      }
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        x_a = fmaxf(x_a, __shfl_xor_sync(0xffffffffu, x_a, w));
        x_b = fmaxf(x_b, __shfl_xor_sync(0xffffffffu, x_b, w));
      }
      const float n_a = fmaxf(m_a, x_a), n_b = fmaxf(m_b, x_b);
      // A row that has seen no key yet keeps max -inf; subtract 0 there
      // so that its masked logits give exp2(-inf) = 0, not NaN.
      const float u_a = n_a == kNegInf ? 0.f : n_a;
      const float u_b = n_b == kNegInf ? 0.f : n_b;
      const float c_a = ex2(m_a - u_a), c_b = ex2(m_b - u_b);
      m_a = n_a;
      m_b = n_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = ex2(s[i] - ((i & 2) ? u_b : u_a));
        if (i & 2) sum_b += s[i];
        else sum_a += s[i];
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? c_b : c_a;

      // P as bf16 A fragments: k-step kk takes the 8-key blocks 2kk, 2kk+1.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V over the BK keys in steps of 16 (2048 bytes of V rows);
      // N spans the atom columns of D at a stride of one BK-row column.
      fence_regs<D / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (D == 64) {
          wgmma_rs_n64(o, pa[kk], smem_desc(v_s + kk * 2048, BK * 128));
        } else {
#pragma unroll
          for (int n = 0; n < D / 128; ++n) {
            wgmma_rs_n128(o + 64 * n, pa[kk],
                          smem_desc(v_s + n * 2 * (BK * 128) + kk * 2048, BK * 128));
          }
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<D / 2>(o);
      __syncthreads();                     // every warp is done with this stage
    }
  }

  // Epilogue: each row's sum over its quad, O / l rounded to bf16 once.
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const int t_a = q0 + r_a, t_b = q0 + r_b;
  uint32_t* out_a = reinterpret_cast<uint32_t*>(out + (((int64_t)b * T + t_a) * Hq + h) * D + col0);
  uint32_t* out_b = reinterpret_cast<uint32_t*>(out + (((int64_t)b * T + t_b) * Hq + h) * D + col0);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (t_a < T) out_a[4 * n] = pack_bf16(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    if (t_b < T) out_b[4 * n] = pack_bf16(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           void* out, int B, int T, int S, int Hq, int Hk, float scale,
           float softcap, int window, cudaStream_t stream) {
  const int bytes = Layout<D>::BYTES + 1024;     // room to align the base
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (T + BQ - 1) / BQ);
  flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int32_t*)qpos, (__nv_bfloat16*)out, T,
      S, Hq, Hk, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pk_flash_attention(
    const void* q, const void* k, const void* v, const void* qpos, void* out,
    int B, int T, int S, int Hq, int Hk, int D, float scale, float softcap,
    int window, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || T < 0 || S < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, qpos, out, B, T, S, Hq, Hk, scale, softcap, window, s);
    case 128:
      return launch<128>(q, k, v, qpos, out, B, T, S, Hq, Hk, scale, softcap, window, s);
    case 256:
      return launch<256>(q, k, v, qpos, out, B, T, S, Hq, Hk, scale, softcap, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
