"""Paged KV cache: device-side page pools + host-side block allocator
(the reference's engine/kv_cache.py).

Layout (per K and V): [num_layers, num_pages, page_size, num_kv_heads,
head_dim]. Page 0 is reserved as the garbage page — inactive decode lanes
point their tables at it so masked lanes always have a safe write target.
int8 KV adds bf16 scale pools [num_layers, num_pages, page_size,
num_kv_heads] beside int8 value pools.

The allocator is the native one (csrc/block_allocator.cc through ctypes,
as the reference loads native/block_allocator.cc), with the pure-Python
allocator of the same behaviour as its plain version.

The host tier (`HostKVPool`: cold prefix-cache pages in pinned host
memory) and the KV wire format (`serialize_kv_state`, the byte layout the
reference's durable prefix store and disaggregated handoff write) follow
the pools. Blobs are byte-identical to the reference's: bf16 arrays go out
as their raw 16-bit words under the dtype name "bfloat16", the name numpy
prints for an ml_dtypes array, and come back through a uint16 view.
"""

from __future__ import annotations

import ctypes
import json
import struct as _struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.config import ModelConfig


class AllocationError(RuntimeError):
    """Not enough free pages for the request (admission should back off)."""


class BlockAllocator:
    """Refcounted free-list page allocator; page 0 is reserved.

    With `prefer_native` (the default) the bookkeeping lives in the native
    library (csrc/block_allocator.cc, built on first use by
    ops._build.load_allocator; a build that fails raises here), whose
    every entry point takes its own mutex. `prefer_native=False` is the
    plain version: the same free list and refcounts in Python. Both hand
    out the lowest free page first and reuse released pages last in,
    first out, so a sequence of calls gives the same pages either way."""

    def __init__(self, num_pages: int, prefer_native: bool = True):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._lib = None
        if prefer_native:
            from ..ops._build import load_allocator

            self._lib = load_allocator()
            self._handle = self._lib.pk_allocator_new(num_pages)
        else:
            self._free = list(range(num_pages - 1, 0, -1))
            self._refcount = [0] * num_pages
            self._refcount[0] = 1
        self.is_native = self._lib is not None

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.pk_allocator_free(self._handle)
            self._lib = None

    @property
    def num_free(self) -> int:
        if self._lib is not None:
            return self._lib.pk_num_free(self._handle)
        return len(self._free)

    def alloc(self, count: int) -> list[int]:
        """Allocate `count` pages; all-or-nothing."""
        if count == 0:
            return []
        if self._lib is not None:
            out = (ctypes.c_int32 * count)()
            if not self._lib.pk_alloc(self._handle, count, out):
                raise AllocationError(
                    f"requested {count} pages, {self.num_free} free"
                )
            return list(out)
        if len(self._free) < count:
            raise AllocationError(
                f"requested {count} pages, {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(count)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def retain(self, page: int) -> None:
        if self._lib is not None:
            if self._lib.pk_retain(self._handle, page) < 0:
                raise ValueError(f"retain of unallocated page {page}")
            return
        if page <= 0 or page >= self.num_pages or self._refcount[page] == 0:
            raise ValueError(f"retain of unallocated page {page}")
        self._refcount[page] += 1

    def release(self, page: int) -> None:
        if self._lib is not None:
            if self._lib.pk_release(self._handle, page) < 0:
                raise ValueError(f"release of unallocated page {page}")
            return
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
    place by ops/paged_attention.paged_write.

    With int8 KV (EngineConfig.kv_dtype="int8") k/v hold int8 values and
    ks/vs the per-(token, head) bf16 scales [L, num_pages, page_size, Hk]:
    symmetric absmax over head_dim, quantized at write time and
    dequantized at read time. ks/vs are None for full-precision pools."""

    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    def layer(self, i: int):
        """Layer i's (k, v) cache operands: pools, or (values, scales)
        pairs when quantized (the ops dispatch on the pair form)."""
        if self.quantized:
            return (self.k[i], self.ks[i]), (self.v[i], self.vs[i])
        return self.k[i], self.v[i]

    @property
    def pools(self) -> list:
        """k, v (and ks, vs when quantized): every tensor a page spans."""
        return [t for t in (self.k, self.v, self.ks, self.vs) if t is not None]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.pools)

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


def init_paged_kv(
    cfg: ModelConfig, num_pages: int, page_size: int,
    dtype: torch.dtype = torch.bfloat16, device="cpu",
    kv_dtype: Optional[torch.dtype] = None, tp: int = 1, pp: int = 1,
) -> PagedKV:
    """`kv_dtype=torch.int8` builds quantized pools (+ bf16 scale pools);
    None keeps the full-precision layout in `dtype`. Over a serving mesh
    the pools are one rank's shard (parallel/sharding.paged_kv_spec and
    paged_kv_scale_spec): its pp stage's num_layers / `pp` layers and its
    num_kv_heads / `tp` heads, the scale pools split on their last
    dimension; they are replicated over dp and sp."""
    layers, heads = _shard_layers_heads(cfg, tp, pp)
    shape = (layers, num_pages, page_size, heads, cfg.head_dim)
    if kv_dtype == torch.int8:
        return PagedKV(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            ks=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            vs=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        )
    return PagedKV(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def _shard_layers_heads(cfg: ModelConfig, tp: int, pp: int) -> tuple[int, int]:
    """(layers, kv heads) of one rank's shard of a pool over tp and pp."""
    if cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads}")
    if cfg.num_layers % pp:
        raise ValueError(f"pp={pp} must divide num_layers={cfg.num_layers}")
    return cfg.num_layers // pp, cfg.num_kv_heads // tp


def kv_pool_bytes(
    cfg: ModelConfig, num_pages: int, page_size: int,
    dtype: torch.dtype = torch.bfloat16, kv_dtype: Optional[torch.dtype] = None,
) -> int:
    if kv_dtype == torch.int8:
        per_slot = cfg.num_kv_heads * (cfg.head_dim + 2)   # values + bf16 scale
    else:
        per_slot = cfg.num_kv_heads * cfg.head_dim * dtype.itemsize
    return 2 * cfg.num_layers * num_pages * page_size * per_slot


def host_kv_page_bytes(
    cfg: ModelConfig, page_size: int, dtype: torch.dtype = torch.bfloat16,
    kv_dtype: Optional[torch.dtype] = None,
) -> int:
    """Bytes ONE page occupies in the host tier (K + V over every layer,
    plus the bf16 scale rows for int8 pools): the unit POLYKEY_HOST_KV_BYTES
    divides into a page capacity."""
    return kv_pool_bytes(cfg, 1, page_size, dtype, kv_dtype)


class HostKVPool:
    """The second KV tier, in host memory: pools laid out as the device's
    per page, k/v [L, capacity, page_size, Hk, D] (+ bf16 ks/vs [L,
    capacity, page_size, Hk] for int8), holding COLD pages the prefix cache
    spilled. They are never computed against, only copied back into the
    device pools when a lookup hits a spilled entry, so cold capacity is
    bounded by host RAM instead of device memory.

    Over a serving mesh each rank's pool holds its shard of every page
    (its pp stage's layers, its tp heads: `tp`, `pp`), at the capacity the
    whole model's page bytes give, so the leader's spill and restore
    decisions are the single-card engine's.

    Preallocated once, pinned (`pin`) when the engine serves on the card.
    No copy to the card ever reads this storage directly: a restore copies
    its pages into a fresh pinned staging buffer first, because the pages
    are released as soon as the restore is issued and a later spill may
    overwrite them before a non-blocking copy has run. Engine thread only.
    """

    def __init__(self, cfg: ModelConfig, capacity_pages: int, page_size: int,
                 dtype: torch.dtype, quantized: bool, pin: bool = False,
                 tp: int = 1, pp: int = 1):
        if capacity_pages < 1:
            raise ValueError("HostKVPool needs capacity_pages >= 1")
        self.capacity = capacity_pages
        layers, heads = _shard_layers_heads(cfg, tp, pp)
        shape = (layers, capacity_pages, page_size, heads, cfg.head_dim)

        def pool(shape, dt):
            return torch.zeros(shape, dtype=dt, pin_memory=pin)

        if quantized:
            self.k, self.v = pool(shape, torch.int8), pool(shape, torch.int8)
            self.ks = pool(shape[:-1], torch.bfloat16)
            self.vs = pool(shape[:-1], torch.bfloat16)
        else:
            self.k, self.v = pool(shape, dtype), pool(shape, dtype)
            self.ks = self.vs = None
        self._free = list(range(capacity_pages - 1, -1, -1))

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def pools(self) -> list:
        """k, v (and ks, vs when quantized), in `PagedKV.pools` order."""
        return [t for t in (self.k, self.v, self.ks, self.vs) if t is not None]

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        """One host page; AllocationError when the tier is full (the
        caller's LRU policy decides what to drop)."""
        if not self._free:
            raise AllocationError(f"host KV tier full ({self.capacity} pages)")
        return self._free.pop()

    def release(self, page: int) -> None:
        if page < 0 or page >= self.capacity:
            raise ValueError(f"release of invalid host page {page}")
        self._free.append(page)

    def write(self, page: int, k: torch.Tensor, v: torch.Tensor,
              ks: Optional[torch.Tensor] = None,
              vs: Optional[torch.Tensor] = None) -> None:
        """Copy one page's contents ([L, page_size, Hk, D] slices of a
        gather) into the host pools: raw bytes, no dtype conversion, so a
        later restore is bit-identical."""
        self.k[:, page].copy_(k)
        self.v[:, page].copy_(v)
        if self.quantized:
            self.ks[:, page].copy_(ks)
            self.vs[:, page].copy_(vs)


# -- KV wire format -------------------------------------------------------------
# One self-describing blob of gathered page contents (k/v, plus the int8
# scale pools), in table order, with the prompt metadata a target needs
# to resume decode. Raw array bytes throughout, so every pool type
# round-trips bit for bit.
#
# Layout:  MAGIC(4) | version u16 | header_len u32 | header JSON |
#          payload bytes | crc32(payload) u32
# The header's `arrays` table gives each array's dtype, shape and offset
# in the payload. A truncated or corrupt blob raises KVWireError before
# anything is applied.

KV_WIRE_MAGIC = b"PKKV"
KV_WIRE_VERSION = 1

# Wire dtype names (numpy's, which the header carries) and the numpy dtype
# a payload is read as; bfloat16 travels as its 16-bit words.
_WIRE_NUMPY = {"bfloat16": np.int16}
_WIRE_TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32,
               "int8": torch.int8, "int32": torch.int32}


class KVWireError(RuntimeError):
    """The blob cannot be (safely) applied: bad magic or version, a
    geometry mismatch with the target pool, or a truncated or corrupt
    payload. Always raised before any pool is written."""


@dataclass
class KVHandoffState:
    """One prompt's prefill-complete KV state on the host.

    Tensors (CPU) in the pool layout with the page axis restricted to the
    prompt's pages in table order: k/v [L, n_pages, page_size, Hk, D],
    ks/vs (int8 pools only) [L, n_pages, page_size, Hk]. `prompt_ids`
    (int32) are the positions 0..prompt_len-1 the pages hold KV for;
    `first_token` was sampled at position key prompt_len with `seed`."""

    model: str
    page_size: int
    prompt_len: int
    first_token: int
    seed: int
    prompt_ids: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None
    # Host wall of the exporting engine's gather, ms (not on the wire).
    gather_ms: float = 0.0

    @property
    def num_pages(self) -> int:
        return int(self.k.shape[1])

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def pools(self) -> list:
        """The page arrays in the pools' order: k, v (and ks, vs)."""
        return [self.k, self.v] + ([self.ks, self.vs] if self.quantized else [])

    def validate_for(self, cfg: ModelConfig, page_size: int, quantized: bool) -> None:
        """Raise KVWireError unless this state fits the target pool's
        geometry exactly."""
        expect = (cfg.num_layers, self.num_pages, page_size,
                  cfg.num_kv_heads, cfg.head_dim)
        if self.model != cfg.name:
            raise KVWireError(
                f"kv-handoff model mismatch: blob for {self.model!r}, "
                f"target serves {cfg.name!r}")
        if self.page_size != page_size:
            raise KVWireError(
                f"kv-handoff page_size mismatch: blob {self.page_size}, "
                f"target pool {page_size}")
        if tuple(self.k.shape) != expect or tuple(self.v.shape) != expect:
            raise KVWireError(
                f"kv-handoff geometry mismatch: pages {tuple(self.k.shape)} vs "
                f"target {expect}")
        if quantized != self.quantized:
            raise KVWireError(
                "kv-handoff dtype mismatch: blob is "
                f"{'int8' if self.quantized else 'full-precision'}, target "
                f"pool is {'int8' if quantized else 'full-precision'}")
        needed = -(-self.prompt_len // page_size)
        if self.num_pages != needed:
            raise KVWireError(
                f"kv-handoff page count {self.num_pages} does not cover "
                f"prompt_len {self.prompt_len} (need {needed})")


def _raw(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes in C order (bf16 as its 16-bit words)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def serialize_kv_state(state: KVHandoffState) -> bytes:
    """Render a KVHandoffState as one wire blob (see the comment above)."""
    entries = [("prompt_ids", state.prompt_ids.to(torch.int32)),
               ("k", state.k), ("v", state.v)]
    if state.ks is not None:
        entries += [("ks", state.ks), ("vs", state.vs)]
    arrays, parts, offset = [], [], 0
    for name, t in entries:
        raw = _raw(t)
        arrays.append({
            "name": name,
            "dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape),
            "offset": offset,
            "nbytes": len(raw),
        })
        parts.append(raw)
        offset += len(raw)
    payload = b"".join(parts)
    header = json.dumps({
        "model": state.model,
        "page_size": state.page_size,
        "prompt_len": state.prompt_len,
        "first_token": int(state.first_token),
        "seed": int(state.seed),
        "quantized": state.quantized,
        "arrays": arrays,
        "payload_bytes": len(payload),
    }).encode()
    return b"".join([
        KV_WIRE_MAGIC,
        _struct.pack("!HI", KV_WIRE_VERSION, len(header)),
        header,
        payload,
        _struct.pack("!I", zlib.crc32(payload) & 0xFFFFFFFF),
    ])


def _parse_header(buf: bytes) -> tuple[dict, int]:
    """(header dict, payload start); KVWireError on a blob too short or
    malformed to carry a header."""
    head = len(KV_WIRE_MAGIC) + 6
    if len(buf) < head:
        raise KVWireError(
            f"kv-handoff blob truncated: {len(buf)} bytes is shorter than "
            "the fixed header")
    if buf[:4] != KV_WIRE_MAGIC:
        raise KVWireError(
            f"kv-handoff bad magic {buf[:4]!r} (expected {KV_WIRE_MAGIC!r})")
    version, header_len = _struct.unpack("!HI", buf[4:head])
    if version != KV_WIRE_VERSION:
        raise KVWireError(
            f"kv-handoff version {version} unsupported (this build speaks "
            f"{KV_WIRE_VERSION})")
    if len(buf) < head + header_len:
        raise KVWireError("kv-handoff blob truncated inside the header")
    try:
        header = json.loads(buf[head:head + header_len])
    except ValueError as e:
        raise KVWireError(f"kv-handoff header unparsable: {e}") from e
    return header, head + header_len


def validate_kv_blob(buf: bytes) -> dict:
    """Framing and CRC check without building tensors; returns the header,
    raises KVWireError on any truncation or corruption."""
    header, start = _parse_header(buf)
    payload_bytes = int(header.get("payload_bytes", -1))
    expected = start + payload_bytes + 4
    if payload_bytes < 0 or len(buf) < expected:
        raise KVWireError(
            f"kv-handoff blob truncated: have {len(buf)} bytes, framing "
            f"declares {expected} (partial write?)")
    payload = buf[start:start + payload_bytes]
    (crc,) = _struct.unpack("!I", buf[start + payload_bytes:expected])
    if crc != (zlib.crc32(payload) & 0xFFFFFFFF):
        raise KVWireError("kv-handoff payload CRC mismatch (corrupt blob)")
    return header


def deserialize_kv_state(buf: bytes) -> KVHandoffState:
    """Parse a wire blob back into a KVHandoffState bit for bit (CPU
    tensors). Raises KVWireError on bad magic or version, truncation, a CRC
    mismatch or an unknown dtype; never returns part of a blob."""
    header = validate_kv_blob(buf)
    _, start = _parse_header(buf)
    payload = buf[start:start + int(header["payload_bytes"])]
    arrays: dict[str, torch.Tensor] = {}
    for entry in header["arrays"]:
        raw = payload[entry["offset"]:entry["offset"] + entry["nbytes"]]
        if len(raw) != entry["nbytes"]:
            raise KVWireError(f"kv-handoff array {entry['name']!r} truncated")
        name = entry["dtype"]
        if name not in _WIRE_TORCH:
            raise KVWireError(f"kv-handoff array {entry['name']!r}: dtype {name!r}")
        try:
            arr = np.frombuffer(raw, dtype=_WIRE_NUMPY.get(name, name)).reshape(
                entry["shape"])
        except ValueError as e:
            raise KVWireError(f"kv-handoff array {entry['name']!r}: {e}") from e
        arrays[entry["name"]] = torch.from_numpy(arr.copy()).view(_WIRE_TORCH[name])
    for required in ("prompt_ids", "k", "v"):
        if required not in arrays:
            raise KVWireError(f"kv-handoff blob missing array {required!r}")
    if bool(header.get("quantized")) != ("ks" in arrays):
        raise KVWireError(
            "kv-handoff header/payload mismatch: quantized="
            f"{bool(header.get('quantized'))} but scale pools are "
            f"{'present' if 'ks' in arrays else 'absent'}")
    return KVHandoffState(
        model=header["model"],
        page_size=int(header["page_size"]),
        prompt_len=int(header["prompt_len"]),
        first_token=int(header["first_token"]),
        seed=int(header["seed"]),
        prompt_ids=arrays["prompt_ids"],
        k=arrays["k"],
        v=arrays["v"],
        ks=arrays.get("ks"),
        vs=arrays.get("vs"),
    )
