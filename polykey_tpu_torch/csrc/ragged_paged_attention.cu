// Ragged paged attention: one call attends a flat token stream q [T, Hq, D]
// that mixes decode singles and prefill chunks. Sequence s owns the rows
// [seq_starts[s], seq_starts[s] + seq_lens[s]) and attends over its own KV
// positions [0, kv_lens[s]) through its page-table row; the query position
// of row r is kv_lens[s] - seq_lens[s] + (r - seq_starts[s]). Causal
// masking inside the new tokens, GQA, an optional logit soft-cap and
// sliding window. The output is NORMALIZED fp32 [T, Hq, D]; rows outside
// every sequence are left to the caller, who zero-fills them. One kernel
// template on the KV row type, two entry points: pk_ragged_attention (bf16
// pools) and pk_ragged_attention_int8 (int8 pools plus a bf16 scale per
// (row, kv head)).
//
// Replaces: polykey_tpu/ops/ragged_paged_attention_kernel.py, _ragged_call
// (body _ragged_kernel), reached from ragged_paged_attention through
// forward_ragged on the engine's ragged dispatch: its bf16 path and its
// quantized=True path (int8 KV).
//
// Bound on this card: bytes for the decode singles (one query row per
// sequence against its whole context, about 1 flop per byte; 2 per int8
// byte), operations for the prefill chunks (a 512-token chunk reads each
// key once for hundreds of query rows). At the engine's default stream (16
// singles plus 1024 prefill tokens) the two are of the same order in bf16;
// over int8 pools the chunks' operations bound it.
//
// Design. The host, which builds every range of the stream anyway, hands the
// kernel a WORK LIST (ops/ragged_paged_attention_kernel.py, ragged_work):
// each item is (sequence, first stream row, row count, split, split count,
// partial slot), ordered by visible keys per CTA, longest first, so the
// causal triangle's long tiles do not run last on an emptying card. One CTA,
// one warpgroup, serves one item for one kv head: its 64 query-head rows are
// 64 / G tokens times the G = Hq / Hk query heads that share the kv head, so
// each K/V row crosses from memory once for all of them (GQA). The grid is
// (kv head, item), so the order of the list is the order of launch.
// - Splits: a decode single (a 1-token item) over many keys is cut into
//   splits of SPLIT_ROWS keys; a prefill tile is cut only when the stream
//   would leave most SMs idle without it. A split's share of the tile's
//   visible keys [lo, hi) is read on the device from kv_lens, so the host's
//   split count is a work estimate, never a correctness input.
// - Ring: keys stream through STAGES = 3 stages of BK = 32 keys. The pools
//   are [N, ps, Hk, D], so one kv head's row is D contiguous values: each
//   key row is gathered with 16-byte cp.async copies from its page, whose
//   id was staged in shared memory by a 4-byte cp.async two stages
//   earlier. bf16 rows land directly in wgmma's 128-byte swizzle, as in
//   flash_attention.cu; stages j+1 and j+2 are in flight while the tensor
//   cores work on stage j. At D = 128 a CTA takes 140 registers and 65 KB,
//   so three CTAs share an SM and a byte-bound single runs beside a
//   compute-bound tile; 64-key stages (184 registers, two CTAs an SM) took
//   18% longer at chip_smoke.py's main case with the same splits.
// - S = Q K^T as wgmma m64n32k16, Q and K K-major from shared memory; the
//   softmax on the accumulator registers (a row's max over its quad's
//   shuffles, exp2 with log2(e) folded into the scale); O += P V with P
//   rounded to bf16 once and packed in registers as the A operand, V
//   MN-major from shared memory; O stays in fp32 registers and is rescaled
//   there. Nothing round-trips through shared memory.
// - Merge in the launch: an unsplit item writes O / l. A split writes its
//   unnormalized (acc, m, l) to its partial slot, __threadfence()s and
//   counts itself in an arrival counter of its (item, kv head); the CTA
//   that counts last resets the counter to 0 and merges the splits in split
//   order, so the result is bit-identical from call to call. Counters come
//   from the wrapper (arrival_counters: a buffer per stream, never freed);
//   calls on one stream run in order.
// - Stale rows: keys at or past the split's end are copied with source size
//   0 (cp.async zero-fills them), keys past a tile's last query position or
//   before its window are never loaded, and masked probabilities are exactly
//   0, so stale NaN in unwritten pool rows cannot reach a sum. Rows past the
//   item's tokens read zeros for Q and are never written.
//
// int8 rows, exactly, behind the tensor cores. wgmma reads its B operand
// (K, then V) from shared memory in 16-bit form, so the int8 ring (K and V
// rows, D bytes each, and the aligned 4-byte words that hold their bf16
// scales, with a word of selectors saying which half is the row's: the
// scale block of a page, ps x Hk x 2 bytes, need not be 4-byte aligned per
// row) feeds two bf16 tile pairs in the 128-byte swizzle. Values up to +-127
// are exact in bf16, so the conversion changes no number, and it stays off
// the quarter-rate int-to-float pipe: a byte permute puts (b ^ 0x80) under
// the fp32 exponent of 2^23, one subtract of 2^23 + 128 leaves b, and a
// packed cvt.rn.bf16x2.f32 rounds two values at once (exactly). Block j+1's
// K converts while the tensor cores run block j's S, its V while they run
// block j's P V, so the conversion overlaps the products; each block's
// writes are fenced to the async proxy before the barrier that precedes its
// products (the K rows and scales are read from the int8 stage before S
// starts, the V rows before P V, so those reads' latency hides too). The
// K scale multiplies each logit column in fp32 on the accumulator
// registers, before the soft-cap; each key's V scale folds into its
// probability before the probability's one bf16 rounding: sum_j p_j
// (v8_j vs_j) = sum_j (p_j vs_j) v8_j. So rounding enters where the bf16
// instance rounds, and the same per-element tolerance holds over the
// dequantized V (the TPU kernel keeps p v in fp32). A masked key's folded
// probability is written as exactly 0, never p x vs, so a stale scale
// cannot reach a sum. At D = 128 a CTA takes 75 KB and 165 registers
// (bounded at 168), so three still share an SM. On an H100 the conversion
// costs about 15% of the int8 instance's time at chip_smoke.py's main case,
// which the int8 rows' halved bytes do not win back: the chain of each
// CTA's blocks, not the bytes, bounds both instances (PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int BM = 64;          // query-head rows per CTA: (64 / G) tokens x G heads
constexpr int BK = 32;          // keys per ring stage
constexpr int STAGES = 3;       // ring depth
constexpr int kThreads = 128;   // one warpgroup
constexpr int kItemCols = 6;    // seq, row0, nrows, split, nsplit, part
constexpr float kLog2e = 1.4426950408889634f;

// KV row types: bf16 rows go straight into the bf16 tiles wgmma reads;
// int8 rows, with their scales, into an int8 ring, converted one block
// ahead into two bf16 tile pairs.
struct Bf16Rows {
  static constexpr bool kInt8 = false;
};
struct Int8Rows {
  static constexpr bool kInt8 = true;
};

// Shared memory of one CTA from a 1024-byte aligned base: the Q tile (64
// rows x D), then the bf16 K/V tile pairs (bf16: one a ring stage; int8:
// two), then, for int8, the ring's stages (K rows, V rows, K and V scale
// words, a selector word) and the fp32 scales of the two converted blocks
// ([tile pair][K, V][BK]).
template <int D, class KV>
struct Layout {
  static constexpr int Q_TILE = BM * D * 2;
  static constexpr int KV_TILE = BK * D * 2;
  static constexpr int RING = Q_TILE;
  static constexpr int PAIRS = KV::kInt8 ? 2 : STAGES;
  static constexpr int ROWS8 = BK * D;                   // int8 K (or V) rows of a stage
  static constexpr int WORDS8 = 2 * ROWS8;               // K then V scale words
  static constexpr int SEL8 = WORDS8 + 2 * BK * 4;       // selector word
  static constexpr int STAGE8 = SEL8 + 16;
  static constexpr int RING8 = RING + PAIRS * 2 * KV_TILE;
  static constexpr int SCALES = RING8 + (KV::kInt8 ? STAGES * STAGE8 : 0);
  static constexpr int BYTES = SCALES + (KV::kInt8 ? 2 * 2 * BK * 4 : 0);
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 lds64f(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
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
  float* out;                    // [T, Hq, D]
  float* part_acc;               // [n_part, Hk, BM, D]
  float* part_ml;                // [n_part, Hk, BM, 2]
  int* arrivals;                 // [n_part * Hk], 0 between calls
  int T, Hq, Hk, G, ps, P;
  float scale, softcap;
  int window;
};

// The page ids of keys [k0, k0 + BK) below hi into a stage's table.
__device__ __forceinline__ void load_pages(uint32_t dst, const Params& a, int s, int k0,
                                           int hi, int tid) {
  if (tid < BK) {
    const int kr = k0 + tid;
    const bool ok = kr < hi;
    cp_async4(dst + tid * 4, ok ? a.page_tables + (int64_t)s * a.P + kr / a.ps : a.page_tables,
              ok);
  }
}

// Keys [k0, k0 + BK) of kv head g into a stage's swizzled bf16 K and V
// tiles, each row from its page in `pages`; rows at or past hi zero-filled.
template <int D>
__device__ __forceinline__ void load_kv(uint32_t k_dst, uint32_t v_dst, const Params& a,
                                        const int32_t* pages, int g, int k0, int hi,
                                        int tid) {
  constexpr int C = D / 8;
  const __nv_bfloat16* k_pool = static_cast<const __nv_bfloat16*>(a.k_pool);
  const __nv_bfloat16* v_pool = static_cast<const __nv_bfloat16*>(a.v_pool);
#pragma unroll
  for (int it = 0; it < BK * C / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / C, c = i % C;
    const int kr = k0 + r;
    const bool ok = kr < hi;
    const int64_t off =
        ok ? (((int64_t)pages[r] * a.ps + kr % a.ps) * a.Hk + g) * D + c * 8 : 0;
    cp_async16(k_dst + swizzle<BK>(r, c), k_pool + off, ok);
    cp_async16(v_dst + swizzle<BK>(r, c), v_pool + off, ok);
  }
}

// Keys [k0, k0 + BK) of kv head g into an int8 stage: K and V rows (row r
// at r x D bytes), the aligned 4-byte words holding their scales, and a
// selector word whose bit r says which half of word r is row r's; rows at
// or past hi zero-filled (values and scales 0).
template <int D>
__device__ __forceinline__ void load_kv_int8(uint32_t dst, const Params& a,
                                             const int32_t* pages, int g, int k0, int hi,
                                             int tid) {
  using Lay = Layout<D, Int8Rows>;
  constexpr int C = D / 16;
  const int8_t* k_pool = static_cast<const int8_t*>(a.k_pool);
  const int8_t* v_pool = static_cast<const int8_t*>(a.v_pool);
#pragma unroll
  for (int it = 0; it < BK * C / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / C, c = i % C;
    const int kr = k0 + r;
    const bool ok = kr < hi;
    const int64_t off =
        ok ? (((int64_t)pages[r] * a.ps + kr % a.ps) * a.Hk + g) * D + c * 16 : 0;
    cp_async16(dst + i * 16, k_pool + off, ok);
    cp_async16(dst + Lay::ROWS8 + i * 16, v_pool + off, ok);
  }
  if (tid < BK) {                      // warp 0: one row each
    const int kr = k0 + tid;
    const bool ok = kr < hi;
    const int64_t e = ok ? ((int64_t)pages[tid] * a.ps + kr % a.ps) * a.Hk + g : 0;
    cp_async4(dst + Lay::WORDS8 + tid * 4, a.ks_pool + (e & ~(int64_t)1), ok);
    cp_async4(dst + Lay::WORDS8 + (BK + tid) * 4, a.vs_pool + (e & ~(int64_t)1), ok);
    const uint32_t sel = __ballot_sync(0xffffffffu, (uint32_t)(e & 1));
    if (tid == 0) sts32(dst + Lay::SEL8, sel);
  }
}

// Four int8 values (one word) as two bf16x2 words, exactly: each byte,
// biased by 0x80, goes under the fp32 exponent of 2^23 by a byte permute,
// one subtract of 2^23 + 128 leaves it, and cvt.rn.bf16x2.f32 packs two.
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | i)) - 8388736.f;
  }
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// A thread's share of a stage's int8 rows (K or V): 16-byte chunks i =
// tid + it x kThreads, each chunk i % C of row i / C. Read from the int8
// stage before a product starts, converted and written to the bf16 tile
// while it runs, so the reads' latency hides behind its start.
template <int D>
struct Chunks {
  static constexpr int C = D / 16;
  static constexpr int N = BK * C / kThreads;
  uint4 raw[N];

  __device__ __forceinline__ void read(uint32_t src, int tid) {
#pragma unroll
    for (int it = 0; it < N; ++it) raw[it] = lds128(src + (tid + it * kThreads) * 16);
  }

  // Into a swizzled bf16 tile: a quarter warp holds 8 consecutive chunks;
  // the threads whose bf16 chunks fall in the odd half of an atom column's
  // 16 store their two in the other order, so each store of a quarter warp
  // hits eight distinct bank groups.
  __device__ __forceinline__ void write(uint32_t dst, int tid) const {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / C, c = i % C;
      const uint2 w0 = i8x4_to_bf16(raw[it].x), w1 = i8x4_to_bf16(raw[it].y);
      const uint2 w2 = i8x4_to_bf16(raw[it].z), w3 = i8x4_to_bf16(raw[it].w);
      const uint4 lo = make_uint4(w0.x, w0.y, w1.x, w1.y);
      const uint4 hi = make_uint4(w2.x, w2.y, w3.x, w3.y);
      const uint32_t at_lo = dst + swizzle<BK>(r, 2 * c);
      const uint32_t at_hi = dst + swizzle<BK>(r, 2 * c + 1);
      const bool swap = (c >> 2) & 1;
      sts128(swap ? at_hi : at_lo, swap ? hi : lo);
      sts128(swap ? at_lo : at_hi, swap ? lo : hi);
    }
  }
};

// The bf16 scale held in half `sel` (0 low, 1 high) of a 4-byte word.
__device__ __forceinline__ float scale_of(uint32_t w, uint32_t sel) {
  return __uint_as_float(sel ? (w & 0xFFFF0000u) : (w << 16));
}

// Row tid's K and V scale words of a stage and its selector (warp 0, one
// row a thread), written as fp32 K and V scales ([K, V][BK]).
template <int D>
struct ScaleWords {
  uint32_t sel, k, v;

  __device__ __forceinline__ void read(uint32_t stage, int tid) {
    using Lay = Layout<D, Int8Rows>;
    if (tid < BK) {
      sel = lds32(stage + Lay::SEL8);
      k = lds32(stage + Lay::WORDS8 + tid * 4);
      v = lds32(stage + Lay::WORDS8 + (BK + tid) * 4);
    }
  }

  __device__ __forceinline__ void write(uint32_t dst, int tid) const {
    if (tid < BK) {
      const uint32_t half = (sel >> tid) & 1u;
      sts32(dst + tid * 4, __float_as_uint(scale_of(k, half)));
      sts32(dst + (BK + tid) * 4, __float_as_uint(scale_of(v, half)));
    }
  }
};

// Three CTAs an SM for the int8 instance at D <= 128, whose shared memory
// allows them: at most 168 registers a thread.
template <int D, class KV>
__global__ void __launch_bounds__(kThreads, KV::kInt8 && D <= 128 ? 3 : 1)
    ragged_kernel(const Params a) {
  using Lay = Layout<D, KV>;
  constexpr bool kInt8 = KV::kInt8;
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ unsigned char smem_raw[];
  __shared__ int32_t pg_s[STAGES][BK];
  __shared__ int last_s;
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t pg_base = (uint32_t)__cvta_generic_to_shared(&pg_s[0][0]);

  const int g = blockIdx.x;
  const int32_t* it = a.items + (int64_t)blockIdx.y * kItemCols;
  const int s = it[0], row0 = it[1], split = it[3], nsplit = it[4], part = it[5];
  const int G = a.G, tq = BM / G;
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
  const int nblk = my_hi > my_lo ? (my_hi - my_lo + BK - 1) / BK : 0;

  // This thread's two rows of every accumulator: quad row r_a and r_a + 8
  // of its warp's 16; columns 2 * (lane % 4) + {0, 1} of each 8. Row r is
  // token r / G, query head g * G + r % G; rows past the item's tokens
  // have position -1.
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r_a = warp * 16 + (lane >> 2), r_b = r_a + 8;
  const int t_a = r_a / G, t_b = r_b / G;
  const int p_a = t_a < nrows ? first_pos + t_a : -1;
  const int p_b = t_b < nrows ? first_pos + t_b : -1;
  const int p_max = first_pos + nrows - 1;
  const int col0 = 2 * (lane & 3);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  const float scale_log2 = a.scale * kLog2e;
  const float cap_log2 = a.softcap * kLog2e;
  const float inv_cap = a.softcap > 0.f ? a.scale / a.softcap : 0.f;

  // bf16: the tile pair of ring stage b. int8: tile pair b % 2, ring stage
  // b % STAGES, and the converted scales of tile pair b % 2.
  auto tiles = [&](int b) {
    return base + Lay::RING + (kInt8 ? (b & 1) : b % STAGES) * 2 * Lay::KV_TILE;
  };
  auto stage8 = [&](int b) { return base + Lay::RING8 + (b % STAGES) * Lay::STAGE8; };
  auto scales = [&](int b) { return base + Lay::SCALES + (b & 1) * 2 * BK * 4; };
  Chunks<D> rows;                        // int8: the next block's K, then V
  ScaleWords<D> words;                   // int8: the next block's scales

  if (nblk > 0) {
    // Prologue: Q and the first STAGES - 1 page tables in one group; then
    // each of the first STAGES - 1 key blocks with the page table STAGES - 1
    // blocks after it, one group each. The group that brings block j's
    // keys also brings block j + STAGES - 1's page ids. int8: STAGES page
    // tables and key blocks, and block 0 converted before the loop.
    {
      constexpr int C = D / 8;
#pragma unroll
      for (int i0 = 0; i0 < BM * C / kThreads; ++i0) {
        const int i = tid + i0 * kThreads;
        const int r = i / C, c = i % C;
        const int t = r / G;
        const bool ok = t < nrows;
        cp_async16(q_s + swizzle<BM>(r, c),
                   ok ? a.q + ((int64_t)(row0 + t) * a.Hq + g * G + r % G) * D + c * 8
                      : a.q,
                   ok);
      }
    }
    constexpr int AHEAD = kInt8 ? STAGES : STAGES - 1;   // key blocks before the loop
#pragma unroll
    for (int b = 0; b < AHEAD; ++b) {
      load_pages(pg_base + b * BK * 4, a, s, my_lo + b * BK, my_hi, tid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int b = 0; b < AHEAD; ++b) {
      if (b < nblk) {
        if constexpr (kInt8) {
          load_kv_int8<D>(stage8(b), a, pg_s[b], g, my_lo + b * BK, my_hi, tid);
        } else {
          load_kv<D>(tiles(b), tiles(b) + Lay::KV_TILE, a, pg_s[b], g, my_lo + b * BK,
                     my_hi, tid);
        }
      }
      const int bp = b + STAGES - 1;
      if ((!kInt8 || b > 0) && bp < nblk) {
        load_pages(pg_base + (bp % STAGES) * BK * 4, a, s, my_lo + bp * BK, my_hi, tid);
      }
      cp_async_commit();
      __syncthreads();                   // every thread has read pg_s[b]
    }
    if constexpr (kInt8) {
      cp_async_wait<STAGES - 1>();       // block 0
      __syncthreads();
      rows.read(stage8(0), tid);
      words.read(stage8(0), tid);
      rows.write(tiles(0), tid);
      words.write(scales(0), tid);
      rows.read(stage8(0) + Lay::ROWS8, tid);
      rows.write(tiles(0) + Lay::KV_TILE, tid);
    }

    for (int j = 0; j < nblk; ++j) {
      // bf16: block j's keys and block j + STAGES - 1's page ids. int8:
      // block j + 1's keys (block j's are converted) and block j + STAGES's
      // page ids.
      cp_async_wait<1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const bool next = kInt8 && j + 1 < nblk;
      if constexpr (kInt8) {
        if (next) {
          rows.read(stage8(j + 1), tid);
          words.read(stage8(j + 1), tid);
        }
      }
      const int jn = j + AHEAD;
      if (jn < nblk) {
        if constexpr (kInt8) {
          load_kv_int8<D>(stage8(jn), a, pg_s[jn % STAGES], g, my_lo + jn * BK, my_hi, tid);
        } else {
          load_kv<D>(tiles(jn), tiles(jn) + Lay::KV_TILE, a, pg_s[jn % STAGES], g,
                     my_lo + jn * BK, my_hi, tid);
        }
      }
      const int jp = jn + STAGES - 1;
      if (jp < nblk) {
        load_pages(pg_base + (jp % STAGES) * BK * 4, a, s, my_lo + jp * BK, my_hi, tid);
      }
      cp_async_commit();

      const uint32_t k_s = tiles(j);
      const uint32_t v_s = k_s + Lay::KV_TILE;

      // S = Q K^T over D in steps of 16 (32 bytes inside an atom column).
      fence_regs<BK / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_atom = (kk & 3) * 32;
        const uint64_t dq = smem_desc(q_s + (kk >> 2) * (BM * 128) + in_atom, 16);
        const uint64_t dk = smem_desc(k_s + (kk >> 2) * (BK * 128) + in_atom, 16);
        wgmma_ss_n32(sc, dq, dk, kk > 0);
      }
      wgmma_commit();
      if constexpr (kInt8) {
        if (next) {                      // beside the tensor cores
          rows.write(tiles(j + 1), tid);
          words.write(scales(j + 1), tid);
        }
      }
      wgmma_wait();
      fence_regs<BK / 2>(sc);

      // Logits in log2 units; sc[4n + e] is row (e < 2 ? r_a : r_b), key
      // k0 + 8n + col0 + (e & 1). A block every token sees whole needs no
      // mask (rows past the tokens then attend too, and are never written).
      // int8: each column times its key's K scale first.
      const int k0 = my_lo + j * BK;
      if constexpr (kInt8) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const float2 ks = lds64f(scales(j) + (8 * n + col0) * 4);
          sc[4 * n] *= ks.x;
          sc[4 * n + 1] *= ks.y;
          sc[4 * n + 2] *= ks.x;
          sc[4 * n + 3] *= ks.y;
        }
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sc[i] = a.softcap > 0.f ? cap_log2 * tanhf(sc[i] * inv_cap) : sc[i] * scale_log2;
      }
      const bool full = k0 + BK <= my_hi && k0 + BK - 1 <= first_pos &&
                        (a.window <= 0 || k0 > p_max - a.window);
      if (!full) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kvp = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int p = (i & 2) ? p_b : p_a;
          const bool ok = kvp <= p && kvp < my_hi && (a.window <= 0 || kvp > p - a.window);
          sc[i] = ok ? sc[i] : kNegInf;
        }
      }
      float x_a = kNegInf, x_b = kNegInf;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (i & 2) x_b = fmaxf(x_b, sc[i]);
        else x_a = fmaxf(x_a, sc[i]);
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
        sc[i] = ex2(sc[i] - ((i & 2) ? u_b : u_a));
        if (i & 2) sum_b += sc[i];
        else sum_a += sc[i];
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? c_b : c_a;

      // int8: each probability times its key's V scale, a masked one
      // (probability exactly 0) as exactly 0.
      if constexpr (kInt8) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const float2 vs = lds64f(scales(j) + (BK + 8 * n + col0) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = sc[4 * n + e];
            sc[4 * n + e] = p > 0.f ? p * ((e & 1) ? vs.y : vs.x) : 0.f;
          }
        }
      }

      // P as bf16 A fragments: k-step kk takes the 8-key blocks 2kk, 2kk+1.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      if constexpr (kInt8) {
        if (next) rows.read(stage8(j + 1) + Lay::ROWS8, tid);
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
      if constexpr (kInt8) {
        if (next) rows.write(tiles(j + 1) + Lay::KV_TILE, tid);   // beside the tensor cores
      }
      wgmma_wait();
      fence_regs<D / 2>(o);
    }
  }

  // Epilogue: each row's sum over its quad.
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const bool ok_a = t_a < nrows, ok_b = t_b < nrows;
  if (nsplit == 1) {
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    float* out_a = a.out + ((int64_t)(row0 + t_a) * a.Hq + g * G + r_a % G) * D + col0;
    float* out_b = a.out + ((int64_t)(row0 + t_b) * a.Hq + g * G + r_b % G) * D + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (ok_a) *reinterpret_cast<float2*>(out_a + 8 * n) =
          make_float2(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
      if (ok_b) *reinterpret_cast<float2*>(out_b + 8 * n) =
          make_float2(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
    }
    return;
  }

  // A split: its unnormalized state into its partial slot.
  const int64_t mine = ((int64_t)(part + split) * a.Hk + g) * BM;
  float* acc_a = a.part_acc + (mine + r_a) * D + col0;
  float* acc_b = a.part_acc + (mine + r_b) * D + col0;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (ok_a) *reinterpret_cast<float2*>(acc_a + 8 * n) = make_float2(o[4 * n], o[4 * n + 1]);
    if (ok_b) *reinterpret_cast<float2*>(acc_b + 8 * n) = make_float2(o[4 * n + 2], o[4 * n + 3]);
  }
  if ((lane & 3) == 0) {
    if (ok_a) *reinterpret_cast<float2*>(a.part_ml + (mine + r_a) * 2) = make_float2(m_a, l_a);
    if (ok_b) *reinterpret_cast<float2*>(a.part_ml + (mine + r_b) * 2) = make_float2(m_b, l_b);
  }

  // The last split of this (item, kv head) to arrive merges them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = a.arrivals + (int64_t)part * a.Hk + g;
    const bool last = atomicAdd(counter, 1) == nsplit - 1;
    if (last) atomicExch(counter, 0);   // every split has arrived
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const int64_t first = ((int64_t)part * a.Hk + g) * BM;
  const int64_t step = (int64_t)a.Hk * BM;       // from one split's slot to the next
  for (int i = tid; i < nrows * G * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
    for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, __ldcg(a.part_ml + (first + j * step + r) * 2));
    float acc = 0.f, l = 0.f;
    for (int j = 0; j < nsplit; ++j) {
      const int64_t at = first + j * step + r;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.part_ml + at * 2));
      const float c = ml.x == kNegInf ? 0.f : ex2(ml.x - mx);
      acc += __ldcg(a.part_acc + at * D + d) * c;
      l += ml.y * c;
    }
    a.out[((int64_t)(row0 + r / G) * a.Hq + g * G + r % G) * D + d] = l > 0.f ? acc / l : 0.f;
  }
}

template <int D, class KV>
int launch(const Params& a, int n_items, cudaStream_t stream) {
  const int bytes = Layout<D, KV>::BYTES + 1024;     // room to align the base
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ragged_kernel<D, KV><<<dim3(a.Hk, n_items), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class KV>
int ragged(const Params& a, int n_items, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64, KV>(a, n_items, stream);
    case 128: return launch<128, KV>(a, n_items, stream);
    case 256: return launch<256, KV>(a, n_items, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int n_items, int T, int Hq, int Hk, int ps, int P) {
  return Hk <= 0 || Hq < Hk || Hq % Hk != 0 || BM % (Hq / Hk) != 0 || ps <= 0 || P <= 0 ||
         T < 0 || n_items < 0 || n_items > 65535;
}

}  // namespace

// `items` are [n_items, 6] int32 rows (sequence, first stream row, row
// count, split, split count, partial slot), built on the host
// (polykey_tpu_torch/ops/ragged_paged_attention_kernel.py, ragged_work);
// part_acc [n_part, Hk, 64, D] and part_ml [n_part, Hk, 64, 2] are the
// caller's fp32 scratch for the split items, `arrivals` [n_part * Hk] int32
// their counters, 0 before the call and 0 again after it, used by one call
// at a time (calls in order on one stream).
extern "C" int pk_ragged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_tables, const void* seq_starts, const void* seq_lens,
    const void* kv_lens, const void* items, void* out, void* part_acc,
    void* part_ml, void* arrivals, int n_items, int T, int Hq, int Hk, int D,
    int ps, int P, float scale, float softcap, int window, void* stream) {
  if (bad_shape(n_items, T, Hq, Hk, ps, P)) return (int)cudaErrorInvalidValue;
  if (n_items == 0 || T == 0) return 0;
  const Params a{(const __nv_bfloat16*)q, k_pool, v_pool, nullptr, nullptr,
                 (const int32_t*)page_tables, (const int32_t*)seq_starts,
                 (const int32_t*)seq_lens, (const int32_t*)kv_lens, (const int32_t*)items,
                 (float*)out, (float*)part_acc, (float*)part_ml, (int*)arrivals, T, Hq, Hk,
                 Hq / Hk, ps, P, scale, softcap, window};
  return ragged<Bf16Rows>(a, n_items, D, (cudaStream_t)stream);
}

// The same over int8 pools [N, ps, Hk, D] with bf16 scales ks_pool /
// vs_pool [N, ps, Hk] (4-byte aligned: each scale is copied as the aligned
// word that holds it).
extern "C" int pk_ragged_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
    const void* vs_pool, const void* page_tables, const void* seq_starts,
    const void* seq_lens, const void* kv_lens, const void* items, void* out,
    void* part_acc, void* part_ml, void* arrivals, int n_items, int T, int Hq, int Hk,
    int D, int ps, int P, float scale, float softcap, int window, void* stream) {
  if (bad_shape(n_items, T, Hq, Hk, ps, P)) return (int)cudaErrorInvalidValue;
  if (n_items == 0 || T == 0) return 0;
  const Params a{(const __nv_bfloat16*)q, k_pool, v_pool, (const __nv_bfloat16*)ks_pool,
                 (const __nv_bfloat16*)vs_pool, (const int32_t*)page_tables,
                 (const int32_t*)seq_starts, (const int32_t*)seq_lens,
                 (const int32_t*)kv_lens, (const int32_t*)items, (float*)out,
                 (float*)part_acc, (float*)part_ml, (int*)arrivals, T, Hq, Hk, Hq / Hk,
                 ps, P, scale, softcap, window};
  return ragged<Int8Rows>(a, n_items, D, (cudaStream_t)stream);
}
