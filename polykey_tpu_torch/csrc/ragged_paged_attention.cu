// Ragged paged attention over int8 KV pools: one call attends a flat token
// stream q [T, Hq, D] that mixes decode singles and prefill chunks. Sequence
// s owns the rows [seq_starts[s], seq_starts[s] + seq_lens[s]) and attends
// over its own KV positions [0, kv_lens[s]) through its page-table row; the
// query position of row r is kv_lens[s] - seq_lens[s] + (r - seq_starts[s]).
// Causal masking inside the new tokens, GQA, an optional logit soft-cap and
// sliding window. The output is NORMALIZED fp32 [T, Hq, D]; rows outside
// every sequence are left to the caller, who zero-fills the output. One
// entry point, pk_ragged_attention_int8 (int8 pools plus a bf16 scale per
// (row, kv head)), over a kernel template on the KV row type; the bf16
// pools' kernel is ragged_paged_attention_bf16.cu.
//
// Replaces: polykey_tpu/ops/ragged_paged_attention_kernel.py, _ragged_call
// (body _ragged_kernel), reached from ragged_paged_attention through
// forward_ragged on the engine's ragged dispatch: its quantized=True path
// (int8 KV).
//
// Bound on this card: bytes for the decode singles (one query row per
// sequence against its whole context, about 1 flop per byte), operations for
// the prefill chunks (a 512-token chunk reads each key once for hundreds of
// query rows). At the engine's default stream (16 singles plus 1024 prefill
// tokens) the two are of the same order.
//
// Design. The TPU kernel runs one sequential program per 8-row token tile
// and walks every sequence overlapping the tile through a VMEM double
// buffer; Hopper wants many independent CTAs instead. The host, which builds
// every range of the stream anyway, hands the kernel a WORK LIST: each item is
// (sequence, first stream row, row count, split, split count, partial slot).
// One CTA of four warps serves one item for one kv head: its 64 query-head
// rows are 64 / G tokens times the G = Hq / Hk query heads that share that kv
// head, so each K/V row crosses from memory once for all of them (GQA). A
// decode single is a 1-token item; a prefill range is cut into items of
// 64 / G tokens. Long contexts split (ragged_work says which): each CTA of a
// split item takes an equal share of the tile's visible key range [lo, hi)
// (read on the device from kv_lens, so the host's split count is a work
// estimate, never a correctness input), writes unnormalized (acc, m, l) to
// its partial slot, and a second small kernel merges the slots by exp(m - m_max): the decode
// kernel's split-KV form. Inside a CTA the arithmetic is the flash kernel's:
// K and V stream through shared memory 64 rows at a time (page ids staged
// first), Q K^T and P V run as bf16 WMMA tiles with fp32 accumulation, and an
// fp32 online softmax keeps each row's running max and sum; the probabilities
// are rounded to bf16 for the P V product. Keys past a tile's last query
// position or before its window are never loaded; masked keys get
// probability exactly 0 and rows past the split's end are zero-filled, so
// stale NaN in unwritten pool rows cannot reach a sum. Warps whose 16 rows
// hold no query (the tail of a decode single's tile) skip the arithmetic.
//
// int8 KV, without a second rounding: values up to +-127 are exact in
// bf16, so the int8 K and V rows go into the same bf16 shared-memory tiles
// unchanged (16 values per 16-byte load) and the WMMA products stay exact.
// The scales stage beside the tiles in fp32 (0 for rows not loaded). Each
// logit column is multiplied by its K scale in fp32 before the softmax, and
// each key's V scale is folded into its probability before that is rounded
// to bf16 for the P V product: sum_j p_j (v8_j vs_j) = sum_j (p_j vs_j) v8_j.
// So rounding enters where the bf16 kernel rounds, once per probability,
// and the same per-element tolerance holds over the dequantized V. A masked
// key's folded probability is set to 0, never p x vs, so a stale V scale
// cannot reach a sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // query-head rows per CTA: (64 / G) tokens x G heads
constexpr int BK = 64;          // KV rows per block
constexpr int kThreads = 128;
constexpr int kItemCols = 6;    // seq, row0, nrows, split, nsplit, part
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;     // bf16 row stride of Q, K, V tiles
  static constexpr int LDS = BK + 4;    // fp32 row stride of the logits
  static constexpr int LDP = BK + 8;    // bf16 row stride of the probabilities
  static constexpr int LDO = D + 4;     // fp32 row stride of the output tile
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BM * LDQ * 2);
  static constexpr int V = K + align128(BK * LDQ * 2);
  static constexpr int S = V + align128(BK * LDQ * 2);
  static constexpr int Pb = S + align128(BM * LDS * 4);
  static constexpr int O = Pb + align128(BM * LDP * 2);
  static constexpr int POS = O + align128(BM * LDO * 4);
  static constexpr int M = POS + align128(BM * 4);
  static constexpr int L = M + align128(BM * 4);
  static constexpr int PG = L + align128(BM * 4);
  static constexpr int KS = PG + align128(BK * 4);   // fp32 K / V scales (int8)
  static constexpr int VS = KS + align128(BK * 4);
  static constexpr int BYTES = VS + align128(BK * 4);
};

// KV row type: the element, values per 16-byte load, and whether a bf16
// scale per (row, kv head) rides beside the row.
struct Int8Rows {
  using T = int8_t;
  static constexpr int VEC = 16;
  static constexpr bool kScaled = true;
};

// 16 int8 values of one 16-byte load into 16 bf16 (exact) at dst.
__device__ __forceinline__ void store_i8x16_as_bf16(const uint4& raw, __nv_bfloat16* dst) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint4 out[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      h[2 * i + j] = __floats2bfloat162_rn((float)((int)(w[i] << (24 - 16 * j)) >> 24),
                                           (float)((int)(w[i] << (16 - 16 * j)) >> 24));
  reinterpret_cast<uint4*>(dst)[0] = out[0];
  reinterpret_cast<uint4*>(dst)[1] = out[1];
}

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

// Tokens of an item that belong to its sequence and to the stream: a prefix
// [0, n) of the item's rows, from the device's own range metadata.
__device__ __forceinline__ int item_rows(const int32_t* it, int start, int len,
                                         int T, int tq) {
  const int row0 = it[1];
  if (row0 < start) return 0;
  const int end = min(min(row0 + it[2], start + len), T);
  return max(0, min(end - row0, tq));
}

struct Params {
  const __nv_bfloat16* q;        // [T, Hq, D]
  const void* k_pool;            // [N, ps, Hk, D] bf16 or int8
  const void* v_pool;
  const __nv_bfloat16* ks_pool;  // [N, ps, Hk] (int8 pools only)
  const __nv_bfloat16* vs_pool;
  const int32_t* page_tables;    // [S, P]
  const int32_t* seq_starts;     // [S]
  const int32_t* seq_lens;
  const int32_t* kv_lens;
  const int32_t* items;          // [n_items, 6]
  const int32_t* merges;         // [n_merges, 6]
  float* out;                    // [T, Hq, D]
  float* part_acc;               // [n_part, Hk, BM, D]
  float* part_ml;                // [n_part, Hk, BM, 2]
  int T, Hq, Hk, G, ps, P;
  float scale, softcap;
  int window;
};

template <int D, class KV>
__global__ void __launch_bounds__(kThreads) ragged_tile_kernel(const Params a) {
  using Lay = Layout<D>;
  using T = typename KV::T;
  constexpr int LDQ = Lay::LDQ, LDS = Lay::LDS, LDP = Lay::LDP, LDO = Lay::LDO;
  constexpr int VEC = D / 8;                 // 16-byte vectors per bf16 row
  constexpr int KVEC = D / KV::VEC;          // 16-byte vectors per pool row
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
  int* pg_s = reinterpret_cast<int*>(smem + Lay::PG);
  float* ks_s = reinterpret_cast<float*>(smem + Lay::KS);
  float* vs_s = reinterpret_cast<float*>(smem + Lay::VS);
  const T* k_pool = reinterpret_cast<const T*>(a.k_pool);
  const T* v_pool = reinterpret_cast<const T*>(a.v_pool);

  const int G = a.G, tq = BM / G;
  const int g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int32_t* it = a.items + (int64_t)blockIdx.x * kItemCols;
  const int s = it[0], row0 = it[1], split = it[3], nsplit = it[4], part = it[5];
  const int start = a.seq_starts[s], len = a.seq_lens[s], kv = a.kv_lens[s];
  const int nrows = item_rows(it, start, len, a.T, tq);
  const int first_pos = kv - len + (row0 - start);   // position of token 0

  // Keys the tile's rows can see, [lo, hi), and this split's share of them
  // in whole blocks of BK.
  const int hi = nrows > 0 ? min(first_pos + nrows, a.P * a.ps) : 0;
  const int lo = a.window > 0 ? max(0, first_pos - a.window + 1) : 0;
  const int span = max(0, hi - lo);
  const int per = ((span + nsplit - 1) / nsplit + BK - 1) / BK * BK;
  const int my_lo = lo + split * per;
  const int my_hi = min(hi, my_lo + per);

  if (tid < BM) {
    const int t = tid / G;
    pos_s[tid] = t < nrows ? first_pos + t : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  for (int i = tid; i < BM * LDO; i += kThreads) o_s[i] = 0.f;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // Q row r is token row0 + r / G, query head g * G + r % G.
  for (int i = tid; i < BM * VEC; i += kThreads) {
    const int r = i / VEC, c = i % VEC;
    const int t = r / G;
    uint4 val = zero;
    if (t < nrows) {
      val = *reinterpret_cast<const uint4*>(
          a.q + ((int64_t)(row0 + t) * a.Hq + g * G + r % G) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * LDQ + c * 8) = val;
  }
  __syncthreads();
  const bool live = warp * 16 < nrows * G;   // this warp owns rows [16w, 16w + 16)

  for (int k0 = my_lo; k0 < my_hi; k0 += BK) {
    if (tid < BK) {
      const int kr = k0 + tid;
      pg_s[tid] = kr < my_hi ? a.page_tables[(int64_t)s * a.P + kr / a.ps] : 0;
    }
    __syncthreads();
    for (int i = tid; i < BK * KVEC; i += kThreads) {
      const int r = i / KVEC, c = i % KVEC;
      const int kr = k0 + r;
      uint4 kv4 = zero, vv4 = zero;
      if (kr < my_hi) {
        const int64_t off =
            (((int64_t)pg_s[r] * a.ps + kr % a.ps) * a.Hk + g) * D + c * KV::VEC;
        kv4 = *reinterpret_cast<const uint4*>(k_pool + off);
        vv4 = *reinterpret_cast<const uint4*>(v_pool + off);
      }
      if constexpr (KV::kScaled) {
        store_i8x16_as_bf16(kv4, k_s + r * LDQ + c * 16);
        store_i8x16_as_bf16(vv4, v_s + r * LDQ + c * 16);
      } else {
        *reinterpret_cast<uint4*>(k_s + r * LDQ + c * 8) = kv4;
        *reinterpret_cast<uint4*>(v_s + r * LDQ + c * 8) = vv4;
      }
    }
    if constexpr (KV::kScaled) {
      if (tid < BK) {
        const int kr = k0 + tid;
        float ks = 0.f, vs = 0.f;
        if (kr < my_hi) {
          const int64_t row = ((int64_t)pg_s[tid] * a.ps + kr % a.ps) * a.Hk + g;
          ks = __bfloat162float(a.ks_pool[row]);
          vs = __bfloat162float(a.vs_pool[row]);
        }
        ks_s[tid] = ks;
        vs_s[tid] = vs;
      }
    }
    __syncthreads();

    if (live) {
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
          float x = s_s[r * LDS + col];
          if constexpr (KV::kScaled) x *= ks_s[col];
          x *= a.scale;
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          ok[c] = kvp < my_hi && kvp <= qp && (a.window <= 0 || kvp > qp - a.window);
          sv[c] = ok[c] ? x : kNegInf;
        }
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(fmaxf(sv[0], sv[1])));
        const float p0 = ok[0] ? expf(sv[0] - m_new) : 0.f;
        const float p1 = ok[1] ? expf(sv[1] - m_new) : 0.f;
        const float sum = warp_sum(p0 + p1);
        const float corr = expf(m_prev - m_new);
        if constexpr (KV::kScaled) {
          p_s[r * LDP + lane] = __float2bfloat16(ok[0] ? p0 * vs_s[lane] : 0.f);
          p_s[r * LDP + lane + 32] = __float2bfloat16(ok[1] ? p1 * vs_s[lane + 32] : 0.f);
        } else {
          p_s[r * LDP + lane] = __float2bfloat16(p0);
          p_s[r * LDP + lane + 32] = __float2bfloat16(p1);
        }
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
    }
    __syncthreads();
  }

  // Rows with no visible key keep l = 0 and o = 0, and write 0.
  const int rows = nrows * G;
  if (nsplit == 1) {
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int64_t at = ((int64_t)(row0 + r / G) * a.Hq + g * G + r % G) * D + d;
      a.out[at] = o_s[r * LDO + d] / fmaxf(l_s[r], 1e-9f);
    }
  } else {
    const int64_t slot = ((int64_t)(part + split) * a.Hk + g) * BM;
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i % D;
      a.part_acc[(slot + r) * D + d] = o_s[r * LDO + d];
    }
    for (int r = tid; r < rows; r += kThreads) {
      a.part_ml[(slot + r) * 2] = m_s[r];
      a.part_ml[(slot + r) * 2 + 1] = l_s[r];
    }
  }
}

// Merge the splits of one multi-split item for one kv head: out = sum_j
// acc_j e^(m_j - m) / sum_j l_j e^(m_j - m).
__global__ void __launch_bounds__(kThreads) ragged_merge_kernel(const Params a, int D) {
  const int G = a.G, g = blockIdx.y;
  const int32_t* it = a.merges + (int64_t)blockIdx.x * kItemCols;
  const int s = it[0], row0 = it[1], nsplit = it[4], part = it[5];
  const int nrows = item_rows(it, a.seq_starts[s], a.seq_lens[s], a.T, BM / G);
  for (int i = threadIdx.x; i < nrows * G * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
    for (int j = 0; j < nsplit; ++j) {
      const int64_t slot = ((int64_t)(part + j) * a.Hk + g) * BM + r;
      mx = fmaxf(mx, a.part_ml[slot * 2]);
    }
    float acc = 0.f, l = 0.f;
    for (int j = 0; j < nsplit; ++j) {
      const int64_t slot = ((int64_t)(part + j) * a.Hk + g) * BM + r;
      const float c = expf(a.part_ml[slot * 2] - mx);
      acc += a.part_acc[slot * D + d] * c;
      l += a.part_ml[slot * 2 + 1] * c;
    }
    const int64_t at = ((int64_t)(row0 + r / G) * a.Hq + g * G + r % G) * D + d;
    a.out[at] = acc / fmaxf(l, 1e-9f);
  }
}

template <int D, class KV>
int launch(const Params& a, int n_items, int n_merges, cudaStream_t stream) {
  const int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_tile_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ragged_tile_kernel<D, KV><<<dim3(n_items, a.Hk), kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_merges == 0) return (int)err;
  ragged_merge_kernel<<<dim3(n_merges, a.Hk), kThreads, 0, stream>>>(a, D);
  return (int)cudaGetLastError();
}

template <class KV>
int ragged(const Params& a, int D, int n_items, int n_merges, void* stream) {
  if (a.Hk <= 0 || a.Hq < a.Hk || a.Hq % a.Hk != 0 || BM % (a.Hq / a.Hk) != 0 || a.ps <= 0 ||
      a.P <= 0 || a.T < 0 || n_items < 0 || n_merges < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items == 0 || a.T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch<64, KV>(a, n_items, n_merges, s);
    case 128: return launch<128, KV>(a, n_items, n_merges, s);
    case 256: return launch<256, KV>(a, n_items, n_merges, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `items` and `merges` are [n, 6] int32 rows (sequence, first stream row,
// row count, split, split count, partial slot), built on the host
// (polykey_tpu_torch/ops/ragged_paged_attention_kernel.py, ragged_work);
// part_acc [n_part, Hk, 64, D] and part_ml [n_part, Hk, 64, 2] are the
// caller's fp32 scratch for the multi-split items; int8 pools [N, ps, Hk,
// D] with bf16 scales ks_pool / vs_pool [N, ps, Hk].
extern "C" int pk_ragged_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
    const void* vs_pool, const void* page_tables, const void* seq_starts,
    const void* seq_lens, const void* kv_lens, const void* items,
    const void* merges, void* out, void* part_acc, void* part_ml, int n_items,
    int n_merges, int T, int Hq, int Hk, int D, int ps, int P, float scale,
    float softcap, int window, void* stream) {
  const Params a{(const __nv_bfloat16*)q, k_pool, v_pool,
                 (const __nv_bfloat16*)ks_pool, (const __nv_bfloat16*)vs_pool,
                 (const int32_t*)page_tables, (const int32_t*)seq_starts,
                 (const int32_t*)seq_lens, (const int32_t*)kv_lens,
                 (const int32_t*)items, (const int32_t*)merges, (float*)out,
                 (float*)part_acc, (float*)part_ml, T, Hq, Hk,
                 Hk > 0 ? Hq / Hk : 0, ps, P, scale, softcap, window};
  return ragged<Int8Rows>(a, D, n_items, n_merges, stream);
}
