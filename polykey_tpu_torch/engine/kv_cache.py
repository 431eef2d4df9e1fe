"""Paged KV cache: device-side page pools + host-side block allocator
(the reference's engine/kv_cache.py, full-precision pools).

Layout (per K and V): [num_layers, num_pages, page_size, num_kv_heads,
head_dim]. Page 0 is reserved as the garbage page — inactive decode lanes
point their tables at it so masked lanes always have a safe write target.

The allocator is the reference's pure-Python one (the native ctypes
allocator is a later slice). int8 KV pools are a later slice too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ModelConfig


class AllocationError(RuntimeError):
    """Not enough free pages for the request (admission should back off)."""


class BlockAllocator:
    """Refcounted free-list page allocator; page 0 is reserved."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self._refcount = [0] * num_pages
        self._refcount[0] = 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, count: int) -> list[int]:
        """Allocate `count` pages; all-or-nothing."""
        if len(self._free) < count:
            raise AllocationError(
                f"requested {count} pages, {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(count)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def retain(self, page: int) -> None:
        if page <= 0 or page >= self.num_pages or self._refcount[page] == 0:
            raise ValueError(f"retain of unallocated page {page}")
        self._refcount[page] += 1

    def release(self, page: int) -> None:
        if page <= 0 or page >= self.num_pages or self._refcount[page] == 0:
            raise ValueError(f"release of unallocated page {page}")
        self._refcount[page] -= 1
        if self._refcount[page] == 0:
            self._free.append(page)

    def release_all(self, pages: list[int]) -> None:
        for p in pages:
            self.release(p)


@dataclass
class PagedKV:
    """Device page pools: k/v [L, num_pages, page_size, Hk, D]. Updated in
    place by ops/paged_attention.paged_write."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


def init_paged_kv(
    cfg: ModelConfig, num_pages: int, page_size: int,
    dtype: torch.dtype = torch.bfloat16, device="cpu",
) -> PagedKV:
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return PagedKV(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def kv_pool_bytes(
    cfg: ModelConfig, num_pages: int, page_size: int,
    dtype: torch.dtype = torch.bfloat16,
) -> int:
    per_slot = cfg.num_kv_heads * cfg.head_dim * torch.finfo(dtype).bits // 8
    return 2 * cfg.num_layers * num_pages * page_size * per_slot
