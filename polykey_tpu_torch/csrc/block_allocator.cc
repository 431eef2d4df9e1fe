// Paged-KV block allocator: the host-side bookkeeping of the serving
// engine's page pools (engine/kv_cache.py binds it through ctypes; with
// prefer_native=False the engine takes the pure-Python allocator of the
// same behaviour). The port keeps its own copy of the reference's
// native/block_allocator.cc so that it stands alone.
//
// Pages are fixed-size KV slabs; sequences own ordered page lists;
// refcounts support prefix sharing (the prefix cache, speculative forks).
// Page 0 is reserved as the garbage page: inactive decode lanes point
// their page tables at it so masked-out lanes have a safe write target.
//
// Built on first use by ops/_build.py (load_allocator) with the host C++
// compiler into build/allocator/libblock_allocator.so.

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

// The engine thread owns alloc/release, but gauge reads (pk_num_free via the
// engine_stats tool) arrive from gRPC handler threads — every entry point
// locks.
struct Allocator {
  int32_t num_pages = 0;
  std::vector<int32_t> free_list;   // LIFO of free page ids
  std::vector<int32_t> refcount;    // per page; 0 = free
  std::mutex mu;
};

}  // namespace

extern "C" {

// Create an allocator over `num_pages` pages. Page 0 is reserved (never
// handed out). Returns an opaque handle.
void* pk_allocator_new(int32_t num_pages) {
  auto* a = new Allocator();
  a->num_pages = num_pages;
  a->refcount.assign(num_pages, 0);
  a->free_list.reserve(num_pages);
  // LIFO: push descending so low page ids are handed out first (stable
  // layouts help debugging and keep hot pages dense).
  for (int32_t p = num_pages - 1; p >= 1; --p) a->free_list.push_back(p);
  if (num_pages > 0) a->refcount[0] = 1;  // garbage page, permanently held
  return a;
}

void pk_allocator_free(void* handle) { delete static_cast<Allocator*>(handle); }

int32_t pk_num_free(void* handle) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  return static_cast<int32_t>(a->free_list.size());
}

// Allocate `count` pages into `out`. All-or-nothing: returns 1 on success,
// 0 (no pages written) if fewer than `count` are free.
int32_t pk_alloc(void* handle, int32_t count, int32_t* out) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  if (static_cast<int32_t>(a->free_list.size()) < count) return 0;
  for (int32_t i = 0; i < count; ++i) {
    int32_t page = a->free_list.back();
    a->free_list.pop_back();
    a->refcount[page] = 1;
    out[i] = page;
  }
  return 1;
}

// Increment refcount (prefix sharing). Returns new refcount, or -1 on a free
// or out-of-range page.
int32_t pk_retain(void* handle, int32_t page) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  if (page <= 0 || page >= a->num_pages || a->refcount[page] == 0) return -1;
  return ++a->refcount[page];
}

// Decrement refcount; page returns to the free list at zero. Returns the new
// refcount, or -1 on a double-free / out-of-range / garbage page.
int32_t pk_release(void* handle, int32_t page) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  if (page <= 0 || page >= a->num_pages || a->refcount[page] == 0) return -1;
  int32_t rc = --a->refcount[page];
  if (rc == 0) a->free_list.push_back(page);
  return rc;
}

}  // extern "C"
