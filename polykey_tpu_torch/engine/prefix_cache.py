"""Automatic prefix caching: KV pages shared across requests, tiered across
device memory and host RAM (the reference's engine/prefix_cache.py).

Requests that share a prompt prefix (system prompts, few-shot headers,
multi-turn histories) would recompute identical KV. This cache maps
page-aligned prompt prefixes to resident pages, so a new request reuses
the cached pages and prefills only its unmatched suffix.

An entry lives in one of two tiers:

- ``TIER_DEVICE``: a refcounted page in the device pool
  (kv_cache.BlockAllocator);
- ``TIER_HOST``: a page in the host pool (kv_cache.HostKVPool), where cold
  entries land when the engine spills them under device pressure. A lookup
  that reaches a host entry reports it as a PAGE FAULT, which the engine
  resolves by allocating a device page, copying the host contents back in
  place, and promoting the entry.

Without a host pool no entry is ever host-tier and every method is the
single-tier cache.

Correctness rests on three facts:
- KV at a position depends only on the token prefix up to it (causal
  attention, absolute RoPE), so equal page-aligned prefixes give equal
  page contents; the rolling hash keys on the full prefix, not the page
  alone.
- Shared pages are read-only for every consumer: a slot's own writes start
  at its first unmatched position, strictly beyond the matched pages
  (lookup never matches the whole prompt: at least one token always
  prefills), and garbage-lane writes land on the reserved page 0 or at a
  slot's own frontier. Read-only content is also what keeps the host copy
  coherent: a spilled page's bytes can never be stale.
- Lifetime is refcounts for device pages (the cache holds one reference
  per cached page, each slot using it its own) and single ownership for
  host pages (only the cache points at them).

`PrefixStateStore` makes the host tier durable across restarts: spill
batches are also written to a state directory in the KV wire format
(kv_cache.serialize_kv_state: CRC-framed raw array bytes) beside a JSON
sidecar of page keys, and a fresh engine reloads matching files into its
host tier at construction. The files are byte-compatible with the
reference's, so a state directory written by either package warms the
other when both serve the same weights.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .kv_cache import (
    BlockAllocator,
    HostKVPool,
    KVHandoffState,
    KVWireError,
    deserialize_kv_state,
    serialize_kv_state,
)

TIER_DEVICE = "device"
TIER_HOST = "host"


def _page_keys(ids: np.ndarray, page_size: int, n_pages: int) -> list[bytes]:
    """Rolling page-granular prefix keys over int32 token bytes: key_i
    commits to ALL tokens of pages 0..i, so a page is only shared between
    prompts whose whole prefix up to it matches."""
    keys = []
    key = b""
    for i in range(n_pages):
        chunk = ids[i * page_size:(i + 1) * page_size].tobytes()
        key = hashlib.blake2b(key + chunk, digest_size=16).digest()
        keys.append(key)
    return keys


class PrefixCache:
    """LRU map of page-aligned prompt-prefix hashes -> (page id, tier)."""

    def __init__(
        self, allocator: BlockAllocator, page_size: int, capacity_pages: int,
        host_pool: Optional[HostKVPool] = None,
    ):
        self._alloc = allocator
        self._page_size = page_size
        self._capacity = max(0, capacity_pages)
        # value = [page_id, tier], mutated in place on spill and promote so
        # the entry keeps its LRU position across tier moves.
        self._map: OrderedDict[bytes, list] = OrderedDict()
        self._host = host_pool
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.host_hit_tokens = 0

    def __len__(self) -> int:
        return len(self._map)

    def device_entries(self) -> int:
        return sum(e[1] == TIER_DEVICE for e in self._map.values())

    def host_entries(self) -> int:
        return sum(e[1] == TIER_HOST for e in self._map.values())

    def lookup(self, ids: np.ndarray) -> list[int]:
        """Longest cached DEVICE-resident page-aligned proper prefix of
        `ids`; RETAINS each matched page for the caller (who releases them
        like any other slot page). Never matches the whole prompt. Stops at
        the first host-tier entry (host-aware callers use lookup_chain)."""
        matched, _ = self.lookup_chain(ids, include_host=False)
        return [page for _, _, page in matched]

    def lookup_chain(self, ids: np.ndarray, include_host: bool = True) -> tuple[list, list]:
        """The tier-aware lookup: walk the rolling key chain and return
        ``(matched, faults)``. `matched` is the ordered chain
        ``[(key, tier, page)]`` (device pages RETAINED for the caller, host
        pages still cache-owned); `faults` are the indices into `matched`
        of host-tier entries, the page faults the engine restores before
        the suffix prefills. With ``include_host=False`` the walk stops at
        the first host entry."""
        n_full = max(0, (len(ids) - 1) // self._page_size)
        matched: list = []
        faults: list[int] = []
        for key in _page_keys(ids, self._page_size, n_full):
            entry = self._map.get(key)
            if entry is None:
                break
            if entry[1] == TIER_HOST and not include_host:
                break
            self._map.move_to_end(key)
            if entry[1] == TIER_DEVICE:
                self._alloc.retain(entry[0])
            else:
                faults.append(len(matched))
            matched.append((key, entry[1], entry[0]))
        self.lookup_tokens += len(ids)
        self.hit_tokens += (len(matched) - len(faults)) * self._page_size
        self.host_hit_tokens += len(faults) * self._page_size
        return matched, faults

    def release_chain(self, matched: list) -> None:
        """Undo lookup_chain's device retains: the caller could not use the
        match after all."""
        for _, tier, page in matched:
            if tier == TIER_DEVICE:
                self._alloc.release(page)

    def probe_tiered(self, ids: np.ndarray) -> tuple[int, int]:
        """(device_tokens, host_tokens) of `ids` covered by cached pages, the
        tier-aware warmth signal for routing. Read-only: retains nothing,
        refreshes no LRU position, charges no hit accounting."""
        n_full = max(0, (len(ids) - 1) // self._page_size)
        dev = host = 0
        for key in _page_keys(ids, self._page_size, n_full):
            entry = self._map.get(key)
            if entry is None:
                break
            if entry[1] == TIER_DEVICE:
                dev += self._page_size
            else:
                host += self._page_size
        return dev, host

    def probe(self, ids: np.ndarray) -> int:
        """Covered tokens whatever the tier."""
        dev, host = self.probe_tiered(ids)
        return dev + host

    def insert(self, ids: np.ndarray, table_pages: list[int]) -> None:
        """Register a fully prefilled prompt's page-aligned pages
        (table_pages[i] holds positions [i*ps, (i+1)*ps)). The cache retains
        each newly inserted page; known keys refresh their LRU position.
        Inserting over a HOST entry promotes it back to the device for free:
        the prompt just recomputed (or restored) those pages."""
        n_full = min(max(0, (len(ids) - 1) // self._page_size), len(table_pages))
        for i, key in enumerate(_page_keys(ids, self._page_size, n_full)):
            entry = self._map.get(key)
            if entry is not None:
                if entry[1] == TIER_HOST:
                    self._free_host(entry[0])
                    self._alloc.retain(table_pages[i])
                    entry[0], entry[1] = table_pages[i], TIER_DEVICE
                self._map.move_to_end(key)
                continue
            if self._capacity and len(self._map) >= self._capacity:
                self._evict_one()
            self._alloc.retain(table_pages[i])
            self._map[key] = [table_pages[i], TIER_DEVICE]

    # -- tier moves (engine-driven) ---------------------------------------------

    def spill_candidates(self, max_n: int) -> list[tuple[bytes, int]]:
        """Up to `max_n` LRU device-tier entries as (key, device page): what
        the engine gathers to the host. Read-only; the engine calls
        mark_host or drop per entry afterwards."""
        out = []
        for key, entry in self._map.items():
            if entry[1] == TIER_DEVICE:
                out.append((key, entry[0]))
                if len(out) >= max_n:
                    break
        return out

    def mark_host(self, key: bytes, host_page: int) -> None:
        """The entry's contents now live in the host pool: release the
        cache's device reference and point the entry at the host page. The
        LRU position stays (a tier move is not a use)."""
        entry = self._map[key]
        assert entry[1] == TIER_DEVICE
        self._alloc.release(entry[0])
        entry[0], entry[1] = host_page, TIER_HOST

    def detach_host(self, key: bytes) -> int:
        """Hand a HOST entry's page to the caller: the entry leaves the map
        and the caller owns the host page (to release or re-adopt). The
        engine detaches at admission, so a faulting slot's pending restore
        never reads a page the cache's own LRU pressure freed."""
        entry = self._map.pop(key)
        assert entry[1] == TIER_HOST
        return entry[0]

    def reinsert_device(self, key: bytes, device_page: int) -> bool:
        """Re-register a restored prefix under its (slot-owned) device page,
        after the restore was issued. The cache takes its own reference; a
        key inserted meanwhile (another request recomputed the prefix) wins
        and this returns False."""
        if key in self._map:
            return False
        if self._capacity and len(self._map) >= self._capacity:
            self._evict_one()
        self._alloc.retain(device_page)
        self._map[key] = [device_page, TIER_DEVICE]
        return True

    def drop(self, key: bytes) -> None:
        """Remove one entry outright (host pool full: the cold page is
        forgotten)."""
        entry = self._map.pop(key)
        if entry[1] == TIER_DEVICE:
            self._alloc.release(entry[0])
        else:
            self._free_host(entry[0])

    def pop_lru_host(self) -> Optional[tuple[bytes, int]]:
        """Drop the least recently used HOST entry and return (key, host
        page), the page already freed: the host tier's LRU valve."""
        for key, entry in self._map.items():
            if entry[1] == TIER_HOST:
                del self._map[key]
                self._free_host(entry[0])
                return key, entry[0]
        return None

    def adopt_host(self, key: bytes, host_page: int, coldest: bool = False) -> bool:
        """Register a caller-owned host page as a host-tier entry. Returns
        False (the caller keeps the page) when the key is already cached.
        `coldest=True` parks it at the LRU end, right for durable reloads
        at construction; re-adoption after a requeued or dead faulting slot
        keeps the warm position, since its session is about to retry."""
        if key in self._map:
            return False
        if self._capacity and len(self._map) >= self._capacity:
            self._evict_one()
        self._map[key] = [host_page, TIER_HOST]
        if coldest:
            self._map.move_to_end(key, last=False)
        return True

    def _free_host(self, page: int) -> None:
        if self._host is not None:
            self._host.release(page)

    def _evict_one(self) -> bool:
        if not self._map:
            return False
        self.drop(next(iter(self._map)))       # LRU
        return True

    def evict_for(self, pages_needed: int) -> int:
        """Allocation-pressure eviction: drop LRU DEVICE-tier entries until
        the free list could satisfy `pages_needed` or none remain. A
        released page frees only if no slot still holds it, hence the loop.
        Host-tier entries are never touched: dropping one frees no device
        page."""
        evicted = 0
        while self._alloc.num_free < pages_needed:
            key = next((k for k, e in self._map.items() if e[1] == TIER_DEVICE), None)
            if key is None:
                break
            self.drop(key)
            evicted += 1
        return evicted

    def clear(self) -> None:
        while self._evict_one():
            pass

    def stats(self) -> dict:
        host = self.host_entries()
        return {
            "prefix_cache_pages": len(self._map) - host,
            "prefix_host_pages": host,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_host_hit_tokens": self.host_hit_tokens,
            "prefix_lookup_tokens": self.lookup_tokens,
        }


# -- restart-durable spill store ---------------------------------------------------


class PrefixStateStore:
    """Write-through persistence for spilled prefix pages.

    Every spill batch becomes two files in the state dir:

    - ``prefix-<seq>-<pid>-<run>.pkkv``: the pages' contents as ONE wire
      blob (kv_cache.serialize_kv_state): k/v (+ks/vs) restricted to the
      batch's pages, CRC-framed raw bytes;
    - ``prefix-<seq>-<pid>-<run>.keys.json``: the rolling prefix key (hex)
      of each page, and a ``params_key`` fingerprint of everything that
      decides KV content (model, weights source, dtypes), so a reload
      under other weights never resurrects another model's KV.

    `load_into` scans the dir newest first, CRC-checks each blob (a
    truncated or flipped file is skipped and deleted: warmth lost, never
    liveness), checks its geometry against the live pool, and adopts the
    pages into the HOST tier. `gc` keeps the dir near the host tier's
    capacity."""

    def __init__(self, state_dir: str, model: str, page_size: int,
                 params_key: str, quantized: bool, logger=None):
        self.dir = state_dir
        self.model = model
        self.page_size = page_size
        self.params_key = params_key
        self.quantized = quantized
        self.logger = logger
        self._seq = 0
        # A restarted engine in the same process starts _seq at 0 again:
        # the run id keeps it from overwriting the previous run's batches.
        self._run_id = uuid.uuid4().hex[:8]
        os.makedirs(state_dir, exist_ok=True)

    def _warn(self, msg: str, **fields) -> None:
        if self.logger is not None:
            self.logger.warn(msg, **fields)

    def save_batch(self, keys: list[bytes], k: torch.Tensor, v: torch.Tensor,
                   ks: Optional[torch.Tensor], vs: Optional[torch.Tensor]) -> None:
        """Persist one spill batch (CPU tensors [L, n, ps, Hk, D], page for
        page with `keys`). Best effort: a full disk costs durability, never
        serving."""
        state = KVHandoffState(
            model=self.model, page_size=self.page_size,
            prompt_len=len(keys) * self.page_size, first_token=0, seed=0,
            prompt_ids=torch.zeros((0,), dtype=torch.int32),
            k=k, v=v, ks=ks, vs=vs,
        )
        self._seq += 1
        stem = os.path.join(self.dir, f"prefix-{self._seq:06d}-{os.getpid()}-{self._run_id}")
        try:
            blob = serialize_kv_state(state)
            with open(stem + ".pkkv.tmp", "wb") as f:
                f.write(blob)
            with open(stem + ".keys.json.tmp", "w") as f:
                json.dump({
                    "keys": [key.hex() for key in keys],
                    "params_key": self.params_key,
                    "quantized": self.quantized,
                }, f)
            # Keys last and atomically: a blob without its sidecar is
            # invisible to reload; a sidecar without its blob is skipped.
            os.replace(stem + ".pkkv.tmp", stem + ".pkkv")
            os.replace(stem + ".keys.json.tmp", stem + ".keys.json")
        except OSError as e:
            self._warn("prefix state write failed", error=str(e))

    def _batches(self) -> list[str]:
        """Sidecar stems, oldest first (mtime)."""
        try:
            names = [n for n in os.listdir(self.dir) if n.endswith(".keys.json")]
        except OSError:
            return []
        stems = [os.path.join(self.dir, n[:-len(".keys.json")]) for n in names]
        return sorted(stems, key=lambda s: os.path.getmtime(s + ".keys.json")
                      if os.path.exists(s + ".keys.json") else 0.0)

    def _discard(self, stem: str) -> None:
        for suffix in (".pkkv", ".keys.json"):
            try:
                os.remove(stem + suffix)
            except OSError:
                pass

    def gc(self, max_pages: int) -> None:
        """Drop the oldest batches beyond ~max_pages persisted pages (the
        host tier could never hold more)."""
        total = 0
        for stem in reversed(self._batches()):        # newest first
            try:
                with open(stem + ".keys.json") as f:
                    n = len(json.load(f).get("keys", []))
            except (OSError, ValueError):
                self._discard(stem)
                continue
            if total + n > max_pages:
                self._discard(stem)
                continue
            total += n

    def load_into(self, cache: PrefixCache, host: HostKVPool, expect_shape: tuple,
                  write=None) -> int:
        """Adopt persisted pages into the host tier, newest batches first.
        Returns the pages adopted. Every rejection is a clean skip: another
        params_key, a CRC or truncation error, a geometry mismatch, or a
        full host pool. `write(page, k, v, ks, vs)` places a whole page in
        host row `page` (default `host.write`; a mesh leader's host pool
        holds its shard, and its engine cuts the page)."""
        write = host.write if write is None else write
        adopted = 0
        for stem in reversed(self._batches()):
            try:
                with open(stem + ".keys.json") as f:
                    side = json.load(f)
            except (OSError, ValueError) as e:
                self._warn("prefix state sidecar unreadable; discarding",
                           file=stem, error=str(e))
                self._discard(stem)
                continue
            if side.get("params_key") != self.params_key or \
                    bool(side.get("quantized")) != self.quantized:
                continue                    # other weights or KV dtype: not ours
            try:
                with open(stem + ".pkkv", "rb") as f:
                    state = deserialize_kv_state(f.read())
            except (OSError, KVWireError) as e:
                self._warn("prefix state blob rejected; discarding", file=stem, error=str(e))
                self._discard(stem)
                continue
            keys = [bytes.fromhex(k) for k in side.get("keys", [])]
            if (state.model != self.model
                    or state.page_size != self.page_size
                    or state.k.shape[0] != expect_shape[0]
                    or tuple(state.k.shape[2:]) != tuple(expect_shape[2:])
                    or state.k.dtype != host.k.dtype
                    or state.num_pages != len(keys)):
                self._warn("prefix state geometry mismatch; discarding", file=stem)
                self._discard(stem)
                continue
            for i, key in enumerate(keys):
                try:
                    page = host.alloc()
                except Exception:
                    return adopted                    # host tier full
                write(
                    page, state.k[:, i], state.v[:, i],
                    state.ks[:, i] if state.ks is not None else None,
                    state.vs[:, i] if state.vs is not None else None,
                )
                if cache.adopt_host(key, page, coldest=True):
                    adopted += 1
                else:
                    host.release(page)                # already cached
        return adopted
