// Blockwise causal attention with an online softmax over a contiguous KV
// window (the prefill path): out[b, t, h] = softmax(q.k^T * scale) v over
// the keys at absolute positions kv_pos <= q_pos (and inside the sliding
// window), with GQA and an optional logit soft-cap.
//
// Replaces: polykey_tpu/ops/flash_attention.py, _flash_bhsd (body _kernel),
// reached from flash_attention through paged_attention on prefill.
//
// Bound on this card: operations. A tile of 64 queries against 64 keys
// does 2 x 64 x 64 x D flops for each of QK^T and PV on 64 x D x 2 x 2 bytes
// of K and V — 64 flops per byte, well into the tensor cores' territory for
// the long windows of prefill (S = 4096 on the default engine geometry).
//
// Design: one CTA of four warps per (batch, query head, 64-row query tile).
// Q stays in shared memory; K and V stream through shared memory 64 rows at
// a time. Each warp owns 16 query rows: it computes its 16 x 64 logits with
// bf16 WMMA tiles (fp32 accumulation), applies scale, soft-cap and the
// position mask, updates its rows' fp32 running max and sum, writes the
// probabilities as bf16 (the reference also rounds them to V's dtype) and
// adds P x V into the fp32 output tile in shared memory with WMMA again.
// Key tiles wholly after the tile's largest query position, or wholly before
// its window, are never loaded — for a 512-token prompt in a 4096-slot window
// that skip is what keeps the cost at the causal triangle instead of 8 x it.
// Rows masked for every query of the tile are zero-filled on load, and
// masked probabilities are exactly 0. Padding rows (position -1) see no key
// and produce 0.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;     // bf16 row stride of Q, K, V tiles
  static constexpr int LDS = BK + 4;    // fp32 row stride of the logits
  static constexpr int LDP = BK + 8;    // bf16 row stride of the probabilities
  static constexpr int LDO = D + 4;     // fp32 row stride of the output tile
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BQ * LDQ * 2);
  static constexpr int V = K + align128(BK * LDQ * 2);
  static constexpr int S = V + align128(BK * LDQ * 2);
  static constexpr int Pb = S + align128(BQ * LDS * 4);
  static constexpr int O = Pb + align128(BQ * LDP * 2);
  static constexpr int POS = O + align128(BQ * LDO * 4);
  static constexpr int M = POS + align128(BQ * 4);
  static constexpr int L = M + align128(BQ * 4);
  static constexpr int BYTES = L + align128(BQ * 4);
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
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
  constexpr int LDQ = Lay::LDQ, LDS = Lay::LDS, LDP = Lay::LDP, LDO = Lay::LDO;
  constexpr int VEC = D / 8;                 // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::Q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::K);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::V);
  float* s_s = reinterpret_cast<float*>(smem + Lay::S);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::Pb);
  float* o_s = reinterpret_cast<float*>(smem + Lay::O);
  int* pos_s = reinterpret_cast<int*>(smem + Lay::POS);
  float* m_s = reinterpret_cast<float*>(smem + Lay::M);
  float* l_s = reinterpret_cast<float*>(smem + Lay::L);
  __shared__ int tile_max, tile_min;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * BQ;

  if (tid < BQ) {
    const int t = q0 + tid;
    pos_s[tid] = t < T ? qpos[(int64_t)b * T + t] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  for (int i = tid; i < BQ * LDO; i += kThreads) o_s[i] = 0.f;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < BQ * VEC; i += kThreads) {
    const int r = i / VEC, c = i % VEC;
    const int t = q0 + r;
    uint4 val = zero;
    if (t < T) {
      val = *reinterpret_cast<const uint4*>(
          q + (((int64_t)b * T + t) * Hq + h) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * LDQ + c * 8) = val;
  }
  __syncthreads();
  if (warp == 0) {
    const int a = pos_s[lane], c = pos_s[lane + 32];
    int mx = max(a, c);
    int mn = min(a < 0 ? INT_MAX : a, c < 0 ? INT_MAX : c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane == 0) {
      tile_max = mx;
      tile_min = mn;
    }
  }
  __syncthreads();

  // Keys any row of this tile can see: [kv_lo, kv_hi).
  const int kv_hi = min(S, tile_max + 1);
  int kv_lo = 0;
  if (window > 0 && tile_min != INT_MAX) kv_lo = max(0, tile_min - window + 1);
  const int j_lo = kv_lo / BK;
  const int j_hi = kv_hi > 0 ? (kv_hi + BK - 1) / BK : 0;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * BK;
    for (int i = tid; i < BK * VEC; i += kThreads) {
      const int r = i / VEC, c = i % VEC;
      const int s = k0 + r;
      uint4 kv = zero, vv = zero;
      if (s >= kv_lo && s < kv_hi) {
        const int64_t off = (((int64_t)b * S + s) * Hk + g) * D + c * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(k_s + r * LDQ + c * 8) = kv;
      *reinterpret_cast<uint4*>(v_s + r * LDQ + c * 8) = vv;
    }
    __syncthreads();

    // Logits for this warp's 16 rows: S = Q K^T.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sf[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, q_s + warp * 16 * LDQ + kk * 16, LDQ);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, k_s + n * 16 * LDQ + kk * 16, LDQ);
          wmma::mma_sync(sf[n], af, bf, sf[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::store_matrix_sync(s_s + warp * 16 * LDS + n * 16, sf[n], LDS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // Online softmax of the warp's rows; lanes cover columns lane, lane+32.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qp = pos_s[r];
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const int kvp = k0 + col;
        float x = s_s[r * LDS + col] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ok[c] = kvp <= qp && kvp < S && (window <= 0 || kvp > qp - window);
        sv[c] = ok[c] ? x : kNegInf;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sv[0], sv[1])));
      const float p0 = ok[0] ? expf(sv[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(sv[1] - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      const float corr = expf(m_prev - m_new);
      p_s[r * LDP + lane] = __float2bfloat16(p0);
      p_s[r * LDP + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < D; d += 32) o_s[r * LDO + d] *= corr;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = corr * l_s[r] + sum;
      }
    }
    __syncwarp();

    // O += P V for the warp's rows.
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::load_matrix_sync(pf[kk], p_s + warp * 16 * LDP + kk * 16, LDP);
      }
#pragma unroll 2
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
        float* optr = o_s + warp * 16 * LDO + n * 16;
        wmma::load_matrix_sync(of, optr, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, v_s + kk * 16 * LDQ + n * 16, LDQ);
          wmma::mma_sync(of, pf[kk], vf, of);
        }
        wmma::store_matrix_sync(optr, of, LDO, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    if (t >= T) continue;
    const float l = fmaxf(l_s[r], 1e-9f);
    out[(((int64_t)b * T + t) * Hq + h) * D + d] = __float2bfloat16(o_s[r * LDO + d] / l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           void* out, int B, int T, int S, int Hq, int Hk, float scale,
           float softcap, int window, cudaStream_t stream) {
  const int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, Hq, B);
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
