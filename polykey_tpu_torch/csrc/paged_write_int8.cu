// Quantizing paged KV row write for int8 KV: each lane's new bf16 K and V
// row is quantized per kv head and stored, in place, as D int8 values at
// pool[page_tables[b, pos / ps], pos % ps] plus one bf16 scale at the same
// slot of the scale pool; k, v, ks and vs in one launch.
//
// Replaces: polykey_tpu/ops/paged_write_kernel.py, paged_write_rows_kernel
// over its four pools (int8 k and v, bf16 ks and vs), fed by
// quantize_kv_rows (polykey_tpu/ops/paged_attention.py), as dispatched from
// paged_write's T == 1 path for int8 pools.
//
// The quantizer is the reference's, bit for bit: absmax over D in fp32,
// max(absmax, 1e-8) / 127 rounded to bf16 (nearest even), then each value
// divided by the ROUNDED scale, rounded half to even (rintf) and clipped to
// +-127. Both divisions are __fdiv_rn, IEEE round-to-nearest whatever the
// compiler's flags, so the kernel matches the plain version exactly.
// (For NaN inputs it differs: fmaxf drops a NaN where the reference's
// maximum keeps it.)
//
// Bound on this card: bytes, and at 16 to 1040 rows a launch. A lane reads
// 2 x Hk x D x 2 bytes and writes 2 x Hk x (D + 2): about 66 KB per layer
// for the 16 lanes of a Llama-3-8B decode step, 4.3 MB for a 1040-row ragged
// stream.
//
// Design: one block per row (lane or stream token); one warp per (k or v,
// kv head) job, so the absmax is a warp reduction and the scale a register.
// Each lane handles the elements d = lane, lane + 32, ...: bf16 loads and
// int8 stores coalesce over the warp, and a row needs no whole number of
// 16-byte vectors, so every Hk and D is taken (the bf16 write's rule that a
// row is a whole number of 16-byte vectors does not fit a scale row of
// Hk x 2 bytes). The page id and offset come from the page table and the
// position on the device, as in the bf16 write; inactive lanes and padding
// rows all write the reserved garbage page 0, whose races are harmless
// because page 0 is never read unmasked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void paged_write_int8_kernel(
    int8_t* __restrict__ k_pool,              // [N, ps, Hk, D]
    int8_t* __restrict__ v_pool,
    __nv_bfloat16* __restrict__ ks_pool,      // [N, ps, Hk]
    __nv_bfloat16* __restrict__ vs_pool,
    const __nv_bfloat16* __restrict__ k_new,  // [B, Hk, D]
    const __nv_bfloat16* __restrict__ v_new,
    const int32_t* __restrict__ page_tables,  // [B, P]
    const int32_t* __restrict__ positions,    // [B]
    int P, int ps, int Hk, int D) {
  const int b = blockIdx.x;
  const int pos = positions[b];
  // Floor division and modulo, as the plain version's pos // ps and
  // pos % ps: a negative position keeps its offset inside the page.
  const int off = ((pos % ps) + ps) % ps;
  int pidx = (pos - off) / ps;
  pidx = pidx < 0 ? 0 : (pidx >= P ? P - 1 : pidx);   // clamp like a gather
  const int64_t slot = (int64_t)page_tables[(int64_t)b * P + pidx] * ps + off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int job = warp; job < 2 * Hk; job += nwarps) {
    const bool is_v = job >= Hk;
    const int h = is_v ? job - Hk : job;
    const __nv_bfloat16* src = (is_v ? v_new : k_new) + ((int64_t)b * Hk + h) * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(__bfloat162float(src[d])));
    amax = warp_max(amax);
    const __nv_bfloat16 scale = __float2bfloat16_rn(__fdiv_rn(fmaxf(amax, 1e-8f), 127.0f));
    const float sf = __bfloat162float(scale);
    int8_t* dst = (is_v ? v_pool : k_pool) + (slot * Hk + h) * D;
    for (int d = lane; d < D; d += 32) {
      const float r = rintf(__fdiv_rn(__bfloat162float(src[d]), sf));
      dst[d] = (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
    }
    if (lane == 0) (is_v ? vs_pool : ks_pool)[slot * Hk + h] = scale;
  }
}

}  // namespace

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
  const int warps = 2 * Hk < 8 ? 2 * Hk : 8;
  paged_write_int8_kernel<<<B, 32 * warps, 0, (cudaStream_t)stream>>>(
      (int8_t*)k_pool, (int8_t*)v_pool, (__nv_bfloat16*)ks_pool,
      (__nv_bfloat16*)vs_pool, (const __nv_bfloat16*)k_new,
      (const __nv_bfloat16*)v_new, (const int32_t*)page_tables,
      (const int32_t*)positions, P, ps, Hk, D);
  return (int)cudaGetLastError();
}
