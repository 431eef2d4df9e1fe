// Paged KV row writes: each row's new K and V land at
// pool[page_tables[b, pos / ps], pos % ps], in place. One kernel template,
// two instances, two entry points: pk_paged_write copies the rows as raw
// bytes (bf16 or any pool dtype), pk_paged_write_int8 quantizes each
// (row, kv head) to D int8 values plus one bf16 scale and stores both, in
// k, v, ks and vs at once. A row is a decode lane or one token of a ragged
// stream ([T, 1] rows); inactive lanes and padding rows carry all-zero
// table rows and write the reserved garbage page 0, whose races are
// harmless because page 0 is never read unmasked (the reference kernel
// makes the same choice).
//
// Replaces: polykey_tpu/ops/paged_write_kernel.py, paged_write_rows_kernel
// (dispatched from polykey_tpu/ops/paged_attention.py, _write_decode_kernel):
// its k/v data-pool path, and its four-pool path (int8 k and v, bf16 ks and
// vs) fed by quantize_kv_rows (polykey_tpu/ops/paged_attention.py).
//
// Bound on this card: bytes, and at the main path's sizes the launch. Each
// call reads every new row once and writes it once: 64 KB (copy) or 66 KB
// (int8) for the 16 lanes of a Llama-3-8B decode step, 8.5 MB or 4.3 MB for
// a 1040-row ragged stream. The TPU kernel read and wrote back whole pages
// because its DMA could not address a row at an arbitrary sublane offset of
// an (8, 128) tiled page; Hopper memory has no such tiling, so each row is
// stored straight to its slot, and what is left to cut is the latency of one
// launch. The design:
// - The slot hangs on two dependent loads (positions[b], then
//   page_tables[b, pos / ps]). Every lane issues its row loads first, so the
//   row is in flight beside that chain, and the quantizer's reduction runs
//   while the page id arrives: a row waits for two memory round trips (the
//   row with positions[b], then the page id), not three.
// - Copy: one thread per 16-byte vector of k or v, each holding its vector
//   in a register between its load and its store; k and v rows get their
//   own threads. Blocks of 256 threads: a row's k and v vectors across x
//   (further blocks take the rest of a longer row), as many rows across y
//   as fit, so a block carries several rows when a row has few vectors; the
//   1040-row stream of Llama-3-8B rows is 1040 blocks, one wave on the
//   card. Any pool dtype whose row is a whole number of 16-byte vectors.
// - int8: one warp per (row, k|v, kv head) job, all 2 x Hk jobs of a row in
//   flight at once (blocks of 8 warps, two a row at Hk = 8: one block of 16
//   warps a row took longer over the 1040-row stream). One pass from
//   registers: each lane loads its D / 32 values as one vector (V values:
//   8 bytes at D = 128, 4 at D = 64, 16 at D = 256), the warp takes the
//   absmax in one reduction (redux.sync over the values' bits), each lane
//   divides and rounds the values it holds and stores them as one packed
//   word, and lane 0 stores the bf16 scale. V is the widest of 8, 4, 2
//   values that divides D, fills 32 lanes and keeps the rows' and pools'
//   addresses aligned; any other D (48, say) takes single values, 8 a lane,
//   and a D that one round does not hold loads its earlier rounds twice
//   (once for the absmax, once to quantize). Every Hk and D is taken.
// - The quantizer is the reference's, bit for bit: absmax over D in fp32,
//   max(absmax, 1e-8) / 127 rounded to bf16 (nearest even), then each value
//   divided by the ROUNDED scale, rounded half to even and clipped to
//   +-127. Both divisions are __fdiv_rn, IEEE round-to-nearest whatever
//   the compiler's flags (a reciprocal multiply is not exact); they are
//   most of the quantizer's cost. The maxima keep NaN, as jnp.max and
//   torch.amax do: a head holding a NaN gets a NaN scale.
// - Semantics: floor division and modulo for a negative position, the page
//   index clamped to the table like a gather; in place, on the caller's
//   stream, no allocation; cudaGetLastError() returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // copy: threads a block
constexpr int kMaxWarps = 8;   // int8: warps a block (at most 2 x Hk)

struct Args {
  void* k_pool;                 // copy: [N, ps, units] 16-byte vectors;
  void* v_pool;                 //   int8: [N, ps, Hk, D]
  void* ks_pool;                // int8: bf16 [N, ps, Hk]
  void* vs_pool;
  const void* k_new;            // copy: [B, units] vectors; int8: bf16 [B, Hk, D]
  const void* v_new;
  const int32_t* page_tables;   // [B, P]
  const int32_t* positions;     // [B]
  int B, P, ps;
  int units;                    // copy: 16-byte vectors a row; int8: Hk
  int D;                        // int8: head dim
  uint32_t ps_mul;              // pos / ps = (umulhi(pos, ps_mul) + pos) >> ps_shift
  int ps_shift;
};

// Row b's slot (page id x ps + offset). The position's floor division by
// ps is a multiply-high (exact for 0 <= pos < 2^31, as CUTLASS's
// FastDivmod) rather than a division on the chain to the page id; a
// negative position's page index clamps to 0 and its offset is the floor
// modulo, as the plain version's pos // ps and pos % ps.
__device__ __forceinline__ int64_t slot_of(const Args& a, int b) {
  const int pos = __ldg(a.positions + b);
  int pidx = 0, off;
  if (pos >= 0) {
    pidx = (int)((__umulhi((uint32_t)pos, a.ps_mul) + (uint32_t)pos) >> a.ps_shift);
    off = pos - pidx * a.ps;
    pidx = pidx >= a.P ? a.P - 1 : pidx;           // clamp like a gather
  } else {
    off = ((pos % a.ps) + a.ps) % a.ps;
  }
  return (int64_t)__ldg(a.page_tables + (int64_t)b * a.P + pidx) * a.ps + off;
}

// A lane's vector of V bf16 values (In) and of V int8 values (Out).
template <int V> struct Pack;
template <> struct Pack<8> { using In = uint4; using Out = uint2; };
template <> struct Pack<4> { using In = uint2; using Out = unsigned int; };
template <> struct Pack<2> { using In = unsigned int; using Out = unsigned short; };
template <> struct Pack<1> { using In = unsigned short; using Out = unsigned char; };

// Round r of a head row, H vectors of V values a lane: vector
// (r H + j) x 32 + lane into x[j V .. j V + V); vectors past the row read
// as 0.
template <int V, int H>
__device__ __forceinline__ void load_round(const unsigned short* src, int r,
                                           int lane, int nvec, float (&x)[V * H]) {
  using In = typename Pack<V>::In;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const int v = (r * H + j) * 32 + lane;
    const In w = v < nvec ? __ldg(reinterpret_cast<const In*>(src) + v) : In{};
    if constexpr (V == 1) {
      x[j] = __uint_as_float((unsigned)w << 16);
    } else {                                       // two values a 32-bit word
      union { In w; unsigned e[V / 2]; } u{w};
#pragma unroll
      for (int e = 0; e < V / 2; ++e) {
        x[j * V + 2 * e] = __uint_as_float(u.e[e] << 16);
        x[j * V + 2 * e + 1] = __uint_as_float(u.e[e] & 0xffff0000u);
      }
    }
  }
}

// The largest |x| as raw bits. For floats with the sign cleared the
// unsigned order of the bit patterns is the numeric order, with every NaN
// above infinity, so an integer max is exact and keeps NaN.
template <int N>
__device__ __forceinline__ unsigned absmax_bits(const float (&x)[N], unsigned m) {
#pragma unroll
  for (int i = 0; i < N; ++i) m = max(m, __float_as_uint(x[i]) & 0x7fffffffu);
  return m;
}

template <int V, int H>
__device__ __forceinline__ void store_round(int8_t* dst, int r, int lane, int nvec,
                                            const float (&x)[V * H], float sf) {
  using Out = typename Pack<V>::Out;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const int v = (r * H + j) * 32 + lane;
    if (v < nvec) {
      union { Out w; int8_t e[V]; } u;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        // A zero would take the division's slow path: it divides s instead
        // and takes 0 (0 / s is 0), without a branch. The quotient is
        // clipped, then rounded half to even as it converts (the same as
        // rounding first: +-127 are integers).
        const bool zero = x[j * V + e] == 0.f;
        const float q0 = __fdiv_rn(zero ? sf : x[j * V + e], sf);
        const float q = zero ? 0.f : q0;
        u.e[e] = (int8_t)__float2int_rn(fminf(fmaxf(q, -127.f), 127.f));
      }
      reinterpret_cast<Out*>(dst)[v] = u.w;
    }
  }
}

// kQuant = false: the raw copy (V, H unused). Block (x, y) = (vectors of a
// row's k|v, rows); grid (row blocks, vector blocks).
// kQuant = true: the int8 quantizer, H vectors of V bf16 values a lane in
// a round. Block: one warp per (k|v, kv head) job of row blockIdx.x; grid
// (B, job blocks).
template <bool kQuant, int V, int H>
__global__ void __launch_bounds__(kQuant ? 32 * kMaxWarps : kThreads)
paged_write_kernel(const Args a) {
  if constexpr (!kQuant) {
    const int b = blockIdx.x * blockDim.y + threadIdx.y;
    int i = blockIdx.y * blockDim.x + threadIdx.x;
    if (b >= a.B || i >= 2 * a.units) return;
    const bool is_v = i >= a.units;
    i -= is_v ? a.units : 0;
    const uint4 row = __ldg((const uint4*)(is_v ? a.v_new : a.k_new) +
                            (int64_t)b * a.units + i);
    const int64_t slot = slot_of(a, b);            // under the row load
    ((uint4*)(is_v ? a.v_pool : a.k_pool))[slot * a.units + i] = row;
  } else {
    const int Hk = a.units, b = blockIdx.x, lane = threadIdx.x & 31;
    int h = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (h >= 2 * Hk) return;                       // whole warps
    const bool is_v = h >= Hk;
    h -= is_v ? Hk : 0;
    const int64_t head = (int64_t)b * Hk + h;
    const unsigned short* src =
        (const unsigned short*)(is_v ? a.v_new : a.k_new) + head * a.D;
    const int nvec = a.D / V;
    const int rounds = (nvec + 32 * H - 1) / (32 * H);
    float x[V * H];
    load_round<V, H>(src, 0, lane, nvec, x);
    const int64_t slot = slot_of(a, b);            // under the row load
    unsigned amax = absmax_bits(x, 0u);
    for (int r = 1; r < rounds; ++r) {             // D > 32 V H only
      load_round<V, H>(src, r, lane, nvec, x);
      amax = absmax_bits(x, amax);
    }
    amax = __reduce_max_sync(0xffffffffu, amax);   // one warp reduction
    amax = max(amax, __float_as_uint(1e-8f));      // NaN stays NaN
    const __nv_bfloat16 scale = __float2bfloat16_rn(__fdiv_rn(__uint_as_float(amax), 127.0f));
    const float sf = __bfloat162float(scale);
    const int64_t cell = slot * Hk + h;
    int8_t* dst = (int8_t*)(is_v ? a.v_pool : a.k_pool) + cell * a.D;
    for (int r = rounds - 1; r >= 0; --r) {        // the last round is still held
      if (r != rounds - 1) load_round<V, H>(src, r, lane, nvec, x);
      store_round<V, H>(dst, r, lane, nvec, x, sf);
    }
    if (lane == 0) ((__nv_bfloat16*)(is_v ? a.vs_pool : a.ks_pool))[cell] = scale;
  }
}

// The slot arithmetic's divisor constants, and the launch.
template <bool kQuant, int V = 1, int H = 1>
int launch(Args a, dim3 grid, dim3 block, void* stream) {
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  a.ps_shift = 0;
  while (((uint64_t)1 << a.ps_shift) < (uint64_t)a.ps) ++a.ps_shift;
  a.ps_mul = (uint32_t)((((uint64_t)1 << 32) * (((uint64_t)1 << a.ps_shift) - a.ps)) / a.ps + 1);
  paged_write_kernel<kQuant, V, H><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned(int bytes, const void* p, const void* q) {
  return ((uintptr_t)p % bytes) == 0 && ((uintptr_t)q % bytes) == 0;
}

}  // namespace

// Pools k_pool / v_pool [N, ps, row_bytes] of any dtype, rows k_new / v_new
// [B, row_bytes], all on a 16-byte boundary; page_tables [B, P] and
// positions [B] int32.
extern "C" int pk_paged_write(
    void* k_pool, void* v_pool, const void* k_new, const void* v_new,
    const void* page_tables, const void* positions,
    int B, int P, int ps, int row_bytes, void* stream) {
  if (B < 0 || row_bytes <= 0 || row_bytes % 16 != 0 || ps <= 0 || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (!aligned(16, k_pool, v_pool) || !aligned(16, k_new, v_new)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (B == 0) return 0;
  const Args a{k_pool, v_pool, nullptr, nullptr, k_new, v_new,
               (const int32_t*)page_tables, (const int32_t*)positions,
               B, P, ps, row_bytes / 16, 0, 0, 0};
  const int vecs = 2 * a.units;                    // k's and v's
  const int x = vecs >= kThreads ? kThreads : (vecs + 31) / 32 * 32;
  const int y = kThreads / x;
  return launch<false>(a, dim3((B + y - 1) / y, (vecs + x - 1) / x), dim3(x, y), stream);
}

// Pools: int8 k_pool / v_pool [N, ps, Hk, D], bf16 ks_pool / vs_pool
// [N, ps, Hk]; rows k_new / v_new [B, Hk, D] bf16; page_tables [B, P] and
// positions [B] int32.
extern "C" int pk_paged_write_int8(
    void* k_pool, void* v_pool, void* ks_pool, void* vs_pool, const void* k_new,
    const void* v_new, const void* page_tables, const void* positions, int B,
    int P, int ps, int Hk, int D, void* stream) {
  if (B < 0 || P <= 0 || ps <= 0 || Hk <= 0 || D <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const Args a{k_pool, v_pool, ks_pool, vs_pool, k_new, v_new,
               (const int32_t*)page_tables, (const int32_t*)positions,
               B, P, ps, Hk, D, 0, 0};
  // A lane's vector: the widest of 8, 4, 2 values that divides D, fills 32
  // lanes and keeps rows and pools aligned, one vector a lane a round;
  // else single values, 8 a lane a round.
  int V = 8;
  while (V > 1 && (D % V != 0 || 32 * V > D || !aligned(2 * V, k_new, v_new) ||
                   !aligned(V, k_pool, v_pool))) {
    V >>= 1;
  }
  const int jobs = 2 * Hk;                          // k|v x kv head, a warp each
  const int warps = jobs < kMaxWarps ? jobs : kMaxWarps;
  const dim3 grid(B, (jobs + warps - 1) / warps), block(32 * warps);
  switch (V) {
    case 8: return launch<true, 8, 1>(a, grid, block, stream);
    case 4: return launch<true, 4, 1>(a, grid, block, stream);
    case 2: return launch<true, 2, 1>(a, grid, block, stream);
    default: return launch<true, 1, 8>(a, grid, block, stream);
  }
}

extern "C" const char* pk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
