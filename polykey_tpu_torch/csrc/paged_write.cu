// Paged KV row write for a decode step: each lane's new K and V row goes
// to pool[page_tables[b, pos / ps], pos % ps], in place.
//
// Replaces: polykey_tpu/ops/paged_write_kernel.py, paged_write_rows_kernel
// (dispatched from polykey_tpu/ops/paged_attention.py, _write_decode_kernel)
// on its k/v data-pool path.
//
// Bound on this card: bytes. The work is a copy of B x Hk x D x 2 (k, v)
// elements plus B page-table reads — about 64 KB per layer for 16 lanes of
// Llama-3-8B — so the launch itself, not the memory system, is the cost.
//
// Design: the TPU kernel read and wrote back whole pages because its DMA
// could not address a row at an arbitrary sublane offset of an (8, 128)
// tiled page. Hopper memory has no such tiling, so each lane's row is
// stored straight to its slot: one block per lane, 16-byte vector loads and
// stores, k and v in the same launch, the page id and offset computed on the
// device from the page table and the position (no host round trip). Rows
// are copied as raw bytes, so any pool dtype works when a row is a whole
// number of 16-byte vectors. Inactive lanes all write the reserved garbage
// page 0; their races there are harmless because page 0 is never read
// unmasked (the reference kernel makes the same choice).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void paged_write_kernel(
    uint4* __restrict__ k_pool,             // [N, ps, row] raw rows
    uint4* __restrict__ v_pool,
    const uint4* __restrict__ k_new,        // [B, row]
    const uint4* __restrict__ v_new,
    const int32_t* __restrict__ page_tables,  // [B, P]
    const int32_t* __restrict__ positions,    // [B]
    int P, int ps, int row_vecs) {
  const int b = blockIdx.x;
  const int pos = positions[b];
  // Floor division and modulo, as the plain version's pos // ps and
  // pos % ps: a negative position keeps its offset inside the page.
  const int off = ((pos % ps) + ps) % ps;
  int pidx = (pos - off) / ps;
  pidx = pidx < 0 ? 0 : (pidx >= P ? P - 1 : pidx);   // clamp like a gather
  const int page = page_tables[(int64_t)b * P + pidx];
  const int64_t dst = ((int64_t)page * ps + off) * row_vecs;
  const int64_t src = (int64_t)b * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    k_pool[dst + i] = k_new[src + i];
    v_pool[dst + i] = v_new[src + i];
  }
}

}  // namespace

extern "C" int pk_paged_write(
    void* k_pool, void* v_pool, const void* k_new, const void* v_new,
    const void* page_tables, const void* positions,
    int B, int P, int ps, int row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || ps <= 0 || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const int row_vecs = row_bytes / 16;
  int threads = ((row_vecs + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  paged_write_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (uint4*)k_pool, (uint4*)v_pool, (const uint4*)k_new,
      (const uint4*)v_new, (const int32_t*)page_tables,
      (const int32_t*)positions, P, ps, row_vecs);
  return (int)cudaGetLastError();
}

extern "C" const char* pk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
