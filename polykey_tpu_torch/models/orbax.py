"""The reference's checkpoint format (orbax's StandardCheckpointer over
OCDBT + zarr v2 + zstd), read and written without orbax, tensorstore or a
zstd package: plain Python over numpy and the port's own codec
(csrc/checkpoint_codec.cc, ops/_build.load_codec).

What is on disk, as the reference's `save_checkpoint` writes it (worked out
from the files it writes; the integers are little-endian and a "varint" is
LEB128):

- JSON: `_METADATA` ({"tree_metadata": {"('layers', 'attn', 'wq')":
  {"key_metadata": [{"key": ..., "key_type": 2}, ...], "value_metadata":
  {"value_type": "jax.Array", "skip_deserialize": false, "write_shape":
  [...]}}, ...}, "use_ocdbt": true, "use_zarr3": false, ...}),
  `_CHECKPOINT_METADATA` (written last: the commit), `_sharding` (the
  base64 of each leaf's name -> its sharding as JSON) and
  `array_metadatas/process_0` (each leaf's write and chunk shapes).
- Two OCDBT key-value stores: `ocdbt.process_0/` (the writing process's)
  and the root store, whose tree holds the same keys with its data files
  named from the root (`ocdbt.process_0/d/<hex>`). Each has a
  `manifest.ocdbt`; data files live under `d/`. Reading takes the root.
- Every manifest and B+tree node is framed: magic (big-endian u32,
  0x0cdb3a2a for a manifest, 0x0cdb20de for a node), the frame's whole
  length (u64), version (varint 0), compression (varint: 0 none, 1 zstd),
  the body (a zstd frame when compressed), then the CRC-32C of everything
  before it (u32). A node may sit at any offset of a data file, beside
  values.
- A data file table (manifest and node): count; each path's prefix shared
  with the previous one (count - 1 varints); each path's suffix length;
  each path's base-path length; the suffixes. A path is relative to the
  store's root.
- Manifest body: the config (16-byte uuid; manifest kind 0; max inline
  value bytes 1024; max decoded node bytes 100000000; version tree arity
  log2 as one byte, 4; compression 1 (zstd) with its level and three more
  varints, all 0), the data file table, the newest versions (count; then
  per version arrays of generation, root height, root data file, offset,
  length, keys, tree bytes, indirect value bytes, and commit time as u64
  nanoseconds), then the version tree nodes' count (0 here). The last
  version is the newest; an offset of 2^64 - 1 is an empty tree.
- Node body: height (one byte, 0 for a leaf), the data file table, the
  entry count, each key's prefix shared with the previous key, each
  key's suffix length, (interior nodes: each child's key prefix common
  to its whole subtree), the suffixes. A leaf then has each value's
  length, each value's kind (0 inline, 1 in a data file), the data file
  and offset of each indirect value, then the inline values in order. An
  interior node has each child's data file, offset, length, keys, tree
  bytes and indirect value bytes. A child's keys are relative to its
  parent's prefix plus the subtree's common prefix.
- The keys are zarr v2: `<name>/.zarray` (the array's JSON: shape, chunks,
  dtype "bfloat16", "<f4", "<f2", ..., zstd compressor, fill value, C
  order, "." as the chunk key separator) and `<name>/<i>.<j>...` per
  chunk (a whole zstd frame of the chunk's C-order bytes; edge chunks are
  stored at full chunk size). `<name>` is the leaf's keys joined by ".".
  A chunk that is absent reads as the fill value.

`read_tree` decodes each leaf straight into one buffer of its own, its
chunks in parallel threads (the codec runs without the GIL).
`write_tree` writes the same layout. Its chunks are zstd frames of raw
blocks (128 KiB each), which every zstd reader takes, so the port needs no
encoder: a deliberate divergence from the reference, whose frames are
compressed at level 1, so the port's files are larger on disk. Manifests
and nodes are written uncompressed (compression 0). Stacked leaves are
chunked a layer (or a part of one) at a time, so a writer streams them
and a reader of one pp stage skips the rest (`read_tree(rows=)`).
"""

from __future__ import annotations

import base64
import ctypes
import json
import os
import struct
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
PROCESS_STORE = "ocdbt.process_0"
NULL_OFFSET = (1 << 64) - 1
MAX_DECODED_NODE = 100_000_000
# The config bytes after the uuid that the reference's stores carry: kind
# 0, max inline value bytes, max decoded node bytes, arity log2 4, zstd
# (level 0), three zero varints.
_CONFIG_TAIL = bytes([0, 0x80, 0x08, 0x80, 0xC2, 0xD7, 0x2F, 4, 1, 0, 0, 0, 0])
RAW_BLOCK = 128 * 1024
# A chunk's bytes at most (chunk_shape): the pinned buffer a writer streams
# through.
CHUNK_BYTES = 64 << 20
# The zarr dtypes of the reference's trees, and their item sizes.
ITEMSIZE = {"bfloat16": 2, "<f4": 4, "<f2": 2}
ZSTD_ZARRAY = {"id": "zstd", "level": 1}
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")


class FormatError(ValueError):
    """The directory is not an orbax checkpoint this module reads."""


def is_checkpoint(path: str) -> bool:
    """Whether `path` is an orbax directory (its `_METADATA` or root
    OCDBT manifest is there)."""
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f)) for f in ("_METADATA", MANIFEST))


# -- the codec ---------------------------------------------------------------

def _codec():
    from ..ops._build import load_codec

    return load_codec()


def zstd_decode_into(src_addr: int, src_len: int, dst_addr: int, cap: int) -> int:
    """Decode the zstd frames at `src_addr` into `dst_addr` (capacity
    `cap`); returns the bytes written or raises FormatError."""
    lib = _codec()
    n = lib.pk_zstd_decompress(src_addr, src_len, dst_addr, cap)
    if n < 0:
        raise FormatError(f"zstd: {lib.pk_codec_error(n).decode()}")
    return n


def zstd_decode(data: bytes, size: Optional[int] = None) -> bytes:
    """`data`'s zstd frames decoded; `size` the exact output size when
    known, else the frame's content size or a growing guess."""
    src = np.frombuffer(data, np.uint8)
    cap = size if size is not None else _content_size(data)
    guess = cap is None
    cap = cap if cap is not None else max(1 << 16, 4 * len(data))
    lib = _codec()
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = lib.pk_zstd_decompress(src.ctypes.data, len(data), out.ctypes.data, cap)
        if n == -4 and guess and cap < MAX_DECODED_NODE:      # too small a guess
            cap *= 4
            continue
        if n < 0:
            raise FormatError(f"zstd: {lib.pk_codec_error(n).decode()}")
        if size is not None and n != size:
            raise FormatError(f"zstd: {n} bytes decoded, {size} expected")
        return out[:n].tobytes()


def _content_size(frame: bytes) -> Optional[int]:
    """The first frame's content size from its header, None if absent."""
    if len(frame) < 6 or struct.unpack_from("<I", frame)[0] != 0xFD2FB528:
        return None
    fhd = frame[4]
    single, fcs_flag = (fhd >> 5) & 1, fhd >> 6
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
    n = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if n == 0 or pos + n > len(frame):
        return None
    value = int.from_bytes(frame[pos:pos + n], "little")
    return value + 256 if n == 2 else value


def crc32c(data: bytes) -> int:
    buf = np.frombuffer(data, np.uint8)
    return _codec().pk_crc32c(buf.ctypes.data, len(data), 0)


def raw_frame_header(size: int) -> bytes:
    """A zstd frame header for `size` bytes of raw blocks: the content size
    (8 bytes), a 128 KiB window, no checksum, no dictionary."""
    return struct.pack("<IBBQ", 0xFD2FB528, 0xC0, 0x38, size)


def _raw_frame_parts(data: memoryview) -> Iterator:
    """`data` as one zstd frame of raw blocks, in parts: the frame header,
    then each block's 3-byte header and its slice of `data`."""
    yield raw_frame_header(len(data))
    starts = range(0, max(len(data), 1), RAW_BLOCK)
    for a in starts:
        part = data[a:a + RAW_BLOCK]
        yield ((len(part) << 3) | int(a == starts[-1])).to_bytes(3, "little")
        yield part


def raw_frame(data: bytes) -> bytes:
    """`data` as one zstd frame of raw blocks (write_tree's chunk frames)."""
    return b"".join(bytes(p) for p in _raw_frame_parts(memoryview(data)))


def _write_frame(fd: int, data: memoryview) -> int:
    """Write `data` as one raw-block zstd frame to `fd` (os.writev, 512
    parts a call); returns its bytes."""
    total, iov = 0, []
    for part in _raw_frame_parts(data):
        iov.append(part)
        if len(iov) == 512:
            total += _writev(fd, iov)
            iov = []
    return total + _writev(fd, iov)


def _writev(fd: int, iov: list) -> int:
    want = sum(len(b) for b in iov)
    done = os.writev(fd, iov) if iov else 0
    if done != want:                       # a short write: finish it plainly
        flat = b"".join(bytes(b) for b in iov)
        while done < want:
            done += os.write(fd, flat[done:])
    return want


# -- OCDBT ------------------------------------------------------------------

class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise FormatError(f"{self.what}: truncated")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self.need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self.need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        self.need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _put_varint(out: bytearray, value: int) -> None:
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node frame, its CRC checked."""
    if len(data) < 18:
        raise FormatError(f"{what}: truncated")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise FormatError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise FormatError(f"{what}: frame says {length} bytes, has {len(data)}")
    if struct.unpack_from("<I", data, len(data) - 4)[0] != crc32c(data[:-4]):
        raise FormatError(f"{what}: CRC-32C mismatch")
    c = _Cursor(data[:-4], what)
    c.pos = 12
    if c.varint() != 0:
        raise FormatError(f"{what}: unknown version")
    compression = c.varint()
    body = data[c.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decode(body)
    raise FormatError(f"{what}: unknown compression {compression}")


def _frame(magic: int, body: bytes) -> bytes:
    head = struct.pack(">I", magic) + struct.pack("<Q", 14 + len(body) + 4) + b"\0\0"
    data = head + body
    return data + struct.pack("<I", crc32c(data))


def _read_file_table(c: _Cursor) -> list:
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    c.varints(n)                               # base path lengths
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise FormatError(f"{c.what}: bad data file table")
        prev = prev[:p] + c.take(s)
        paths.append(prev.decode())
    return paths


def _common(a: bytes, b: bytes) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _file_table(paths: list, base: str) -> bytes:
    out = bytearray()
    raw = [p.encode() for p in paths]
    _put_varint(out, len(raw))
    for i in range(1, len(raw)):
        _put_varint(out, _common(raw[i - 1], raw[i]))
    prefixes = [0] + [_common(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    for r, p in zip(raw, prefixes):
        _put_varint(out, len(r) - p)
    for _ in raw:
        _put_varint(out, len(base))
    for r, p in zip(raw, prefixes):
        out += r[p:]
    return bytes(out)


@dataclass(frozen=True)
class Ref:
    """A value or node in a data file of the store rooted at `root`."""

    root: str
    path: str
    offset: int
    length: int

    def read(self) -> bytes:
        with open(os.path.join(self.root, self.path), "rb") as f:
            f.seek(self.offset)
            data = f.read(self.length)
        if len(data) != self.length:
            raise FormatError(f"{self.path}: {len(data)} bytes at {self.offset}, "
                              f"{self.length} expected")
        return data


def _read_keys(c: _Cursor, n: int, interior: bool) -> tuple:
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    common = c.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise FormatError(f"{c.what}: bad key prefix")
        prev = prev[:p] + c.take(s)
        keys.append(prev)
    return keys, common


def _read_node(ref: Ref, prefix: bytes, out: dict, depth: int = 0) -> None:
    """Every key of the subtree at `ref` (its keys relative to `prefix`)
    into `out`: key -> inline bytes or a Ref."""
    if depth > 64:
        raise FormatError("B+tree deeper than 64 levels")
    what = f"node {ref.path}@{ref.offset}"
    c = _Cursor(_unframe(ref.read(), NODE_MAGIC, what), what)
    height = c.byte()
    files = _read_file_table(c)
    n = c.varint()

    def file_ref(i: int, offset: int, length: int) -> Ref:
        if i >= len(files):
            raise FormatError(f"{what}: data file {i} of {len(files)}")
        return Ref(ref.root, files[i], offset, length)

    keys, common = _read_keys(c, n, interior=height > 0)
    if height > 0:
        ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)                        # keys, tree bytes, indirect bytes
        for key, k, i, off, ln in zip(keys, common, ids, offsets, lengths):
            _read_node(file_ref(i, off, ln), prefix + key[:k], out, depth + 1)
        return
    lengths, kinds = c.varints(n), c.varints(n)
    indirect = [j for j, kind in enumerate(kinds) if kind == 1]
    if any(kind not in (0, 1) for kind in kinds):
        raise FormatError(f"{what}: unknown value kind")
    ids, offsets = c.varints(len(indirect)), c.varints(len(indirect))
    where = {j: file_ref(i, off, lengths[j]) for j, i, off in zip(indirect, ids, offsets)}
    for j, key in enumerate(keys):
        out[prefix + key] = where[j] if j in where else c.take(lengths[j])


def read_store(root: str) -> dict:
    """Every key of the OCDBT store at `root` (its newest version): key
    (bytes) -> its inline bytes or a Ref into a data file."""
    path = os.path.join(root, MANIFEST)
    if not os.path.exists(path):
        raise FormatError(f"{root}: no {MANIFEST}")
    with open(path, "rb") as f:
        c = _Cursor(_unframe(f.read(), MANIFEST_MAGIC, path), path)
    c.take(16)                                  # uuid
    if c.varint() != 0:
        raise FormatError(f"{path}: only the single-file manifest kind is read")
    c.varint(), c.varint()                      # max inline, max decoded node
    c.byte()                                    # version tree arity log2
    if c.varint() == 1:                         # zstd, with its level
        c.varint()
    for _ in range(3):                          # three strings (empty here)
        c.take(c.varint())
    files = _read_file_table(c)
    n = c.varint()
    if n == 0:
        raise FormatError(f"{path}: no version inline (version tree nodes are not read)")
    gens, heights, ids, offsets, lengths = (c.varints(n) for _ in range(5))
    newest = max(range(n), key=lambda i: gens[i])
    out: dict = {}
    if offsets[newest] == NULL_OFFSET:
        return out
    if ids[newest] >= len(files):
        raise FormatError(f"{path}: bad root data file")
    _read_node(Ref(root, files[ids[newest]], offsets[newest], lengths[newest]), b"", out)
    return out


def _leaf_node(entries: list, files: list, base: str) -> tuple:
    """A leaf node's frame over sorted `entries` ((key, bytes or
    (file index, offset, length))), with its key and indirect byte
    counts."""
    body = bytearray([0]) + _file_table(files, base)
    _put_varint(body, len(entries))
    keys = [k for k, _ in entries]
    prefixes = [0] + [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    for p in prefixes[1:]:
        _put_varint(body, p)
    for k, p in zip(keys, prefixes):
        _put_varint(body, len(k) - p)
    for k, p in zip(keys, prefixes):
        body += k[p:]
    for _, v in entries:
        _put_varint(body, v[2] if isinstance(v, tuple) else len(v))
    for _, v in entries:
        _put_varint(body, int(isinstance(v, tuple)))
    indirect = [v for _, v in entries if isinstance(v, tuple)]
    for v in indirect:
        _put_varint(body, v[0])
    for v in indirect:
        _put_varint(body, v[1])
    for _, v in entries:
        if not isinstance(v, tuple):
            body += v
    return _frame(NODE_MAGIC, bytes(body)), sum(v[2] for v in indirect)


def _manifest(node_file: str, node: tuple, stats: tuple) -> bytes:
    """A single-file manifest whose one version's root is the leaf node
    `node` (offset, length) of `node_file`; `stats` (keys, tree bytes,
    indirect bytes)."""
    body = bytearray(uuid.uuid4().bytes) + _CONFIG_TAIL + _file_table([node_file], "")
    _put_varint(body, 1)
    for v in (1, 0, 0, *node, *stats):            # generation 1, height 0, file 0
        _put_varint(body, v)
    body += struct.pack("<Q", time.time_ns())
    _put_varint(body, 0)                          # no version tree nodes
    return _frame(MANIFEST_MAGIC, bytes(body))


def _write_store(root: str, entries: list, files: list, base: str) -> None:
    """The node and manifest of one store at `root` over `entries` (sorted;
    indirect values name `files` by index, paths relative to `root`)."""
    node, indirect = _leaf_node(entries, files, base)
    name = "d/" + uuid.uuid4().hex
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, name), "wb") as f:
        f.write(node)
    manifest = _manifest(name, (0, len(node)), (len(entries), len(node), indirect))
    with open(os.path.join(root, MANIFEST), "wb") as f:
        f.write(manifest)


# -- zarr v2 over the store -------------------------------------------------

@dataclass
class Leaf:
    """One array of a checkpoint, decoded: its key path, zarr dtype
    ("bfloat16", "<f4", ...), shape, and the C-order bytes of `rows`, the
    run of its leading axis that was decoded (all of it unless `read_tree`
    was asked for less)."""

    path: tuple
    dtype: str
    shape: tuple
    data: np.ndarray            # uint8, nbytes = len(rows) * prod(shape[1:]) * itemsize
    rows: range


def _tree_paths(directory: str) -> list:
    """The leaves' key paths in `_METADATA`'s order."""
    meta_path = os.path.join(directory, "_METADATA")
    if not os.path.exists(meta_path):
        raise FormatError(f"{directory}: no _METADATA")
    with open(meta_path) as f:
        tree = json.load(f).get("tree_metadata", {})
    paths = []
    for entry in tree.values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        if entry.get("value_metadata", {}).get("skip_deserialize"):
            continue
        paths.append(keys)
    return paths


def _chunk_grid(shape: tuple, chunks: tuple) -> list:
    grid = [-(-s // c) if c else 0 for s, c in zip(shape, chunks)]
    out = [()]
    for g in grid:
        out = [idx + (i,) for idx in out for i in range(g)]
    return out


def _fill(dtype: str, value, itemsize: int, count: int) -> np.ndarray:
    """`count` items of `value` (None: zeros) as bytes."""
    if value is None or value == 0:
        return np.zeros(count * itemsize, np.uint8)
    if dtype == "bfloat16":
        bits = np.array([value], np.float32).view(np.uint32)[0]
        word = (int(bits) + 0x7FFF + ((int(bits) >> 16) & 1)) >> 16
        return np.full(count, word, np.uint16).view(np.uint8)
    return np.full(count, value, np.dtype(dtype)).view(np.uint8)


class _Files:
    """Data files mapped once per read."""

    def __init__(self):
        self.maps: dict = {}

    def address(self, ref: Ref) -> tuple:
        """(address of `ref`'s bytes, the mapping that keeps it alive)."""
        full = os.path.join(ref.root, ref.path)
        m = self.maps.get(full)
        if m is None:
            m = self.maps[full] = np.memmap(full, np.uint8, mode="r")
        if ref.offset + ref.length > m.size:
            raise FormatError(f"{ref.path}: value past the end of the file")
        return m.ctypes.data + ref.offset, m


def read_tree(path: str, threads: int = 8,
              rows: Optional[Callable[[tuple], Optional[range]]] = None) -> Iterator[Leaf]:
    """Each leaf of the orbax checkpoint at `path`, in `_METADATA`'s order,
    decoded into one preallocated buffer of its own: a chunk that covers a
    run of the leaf's bytes is decoded straight into it, others through a
    chunk-sized buffer. A leaf's chunks decode in `threads` threads.

    `rows(keys)`, when given, may name the run of a leaf's leading axis
    that the caller needs (a pp stage's layers). Where the leaf's chunks
    split that axis at the run's ends (the port's writer chunks a layer at
    a time), only those chunks are decoded, into a buffer of those rows;
    otherwise (the reference's one chunk a leaf) the whole leaf is."""
    store = read_store(path)
    files = _Files()
    pool = ThreadPoolExecutor(max(1, threads))
    try:
        for keys in _tree_paths(path):
            yield _read_leaf(store, files, pool, keys, rows(keys) if rows else None)
    finally:
        pool.shutdown(wait=True)


def _read_leaf(store: dict, files: _Files, pool, keys: tuple,
               want: Optional[range]) -> Leaf:
    name = ".".join(keys)
    meta_value = store.get(f"{name}/.zarray".encode())
    if meta_value is None:
        raise FormatError(f"no zarr array {name!r} in the checkpoint")
    meta = json.loads(meta_value if isinstance(meta_value, bytes) else meta_value.read())
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise FormatError(f"{name}: only zarr v2, C order, no filters is read")
    dtype = meta["dtype"]
    if dtype not in ITEMSIZE:
        raise FormatError(f"{name}: dtype {dtype!r} is not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise FormatError(f"{name}: compressor {compressor.get('id')!r} is not read")
    sep = meta.get("dimension_separator", ".")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    itemsize = ITEMSIZE[dtype]
    rows = range(shape[0]) if shape else range(1)
    if (want is not None and shape and chunks[0] and want.start % chunks[0] == 0
            and (want.stop % chunks[0] == 0 or want.stop == shape[0])):
        rows = want
    held = (len(rows),) + shape[1:] if shape else shape
    out = np.empty(int(np.prod(held, dtype=np.int64)) * itemsize, np.uint8)
    view = out.view(np.uint8).reshape(tuple(held) + (itemsize,)) if shape else out
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * itemsize

    def one(idx: tuple) -> None:
        key = (f"{name}/" + (sep.join(map(str, idx)) if idx else "0")).encode()
        starts = [i * c for i, c in zip(idx, chunks)]
        valid = [min(c, s - a) for c, s, a in zip(chunks, shape, starts)]
        if shape:                               # into the held rows' coordinates
            starts[0] -= rows.start
        region = tuple(slice(a, a + v) for a, v in zip(starts, valid))
        value = store.get(key)
        if value is None:
            view[region] = _fill(dtype, meta.get("fill_value"), itemsize,
                                 int(np.prod(valid, dtype=np.int64))).reshape(
                                     tuple(valid) + (itemsize,))
            return
        # Straight into the leaf when the chunk is a whole run of its bytes.
        first = next((d for d, v in enumerate(valid) if v != 1), len(valid))
        direct = valid == list(chunks) and all(
            c == s for c, s in zip(chunks[first + 1:], shape[first + 1:]))
        offset = int(np.ravel_multi_index(starts, held)) * itemsize if shape else 0
        dst = out[offset:offset + chunk_bytes] if direct else np.empty(chunk_bytes, np.uint8)
        if isinstance(value, bytes):
            src = np.frombuffer(value, np.uint8)
            addr, keep = src.ctypes.data, src
        else:
            addr, keep = files.address(value)
        n = len(value) if isinstance(value, bytes) else value.length
        if compressor is None:
            if n != chunk_bytes:
                raise FormatError(f"{key.decode()}: {n} bytes, {chunk_bytes} expected")
            ctypes.memmove(dst.ctypes.data, addr, n)
        else:
            got = zstd_decode_into(addr, n, dst.ctypes.data, chunk_bytes)
            if got != chunk_bytes:
                raise FormatError(f"{key.decode()}: {got} bytes decoded, "
                                  f"{chunk_bytes} expected")
        del keep
        if not direct:
            view[region] = dst.reshape(tuple(chunks) + (itemsize,))[
                tuple(slice(0, v) for v in valid)]

    grid = _chunk_grid(shape, chunks)
    if shape:
        grid = [idx for idx in grid if idx[0] * chunks[0] in rows]
    list(pool.map(one, grid))
    return Leaf(keys, dtype, shape, out, rows)


# -- writing ------------------------------------------------------------------

@dataclass
class WriteLeaf:
    """One array for `write_tree`: its key path, zarr dtype, shape, chunk
    shape, and `chunk(index)`, the C-order bytes of the chunk at that grid
    index (full chunk size: an edge chunk padded), asked for one at a time
    and written before the next is asked for."""

    path: tuple
    dtype: str
    shape: tuple
    chunks: tuple
    chunk: Callable[[tuple], memoryview]


def chunk_shape(shape: tuple, itemsize: int, stacked: bool) -> tuple:
    """A chunk shape for `write_tree`: one layer of a stacked leaf (its
    leading axis), split further along the next axes until a chunk holds
    at most CHUNK_BYTES. Only leading axes are split, so a chunk's valid
    part is a run of the leaf's bytes."""
    chunk = list(shape)
    if stacked and chunk:
        chunk[0] = 1
    for axis in range(len(chunk)):
        nbytes = itemsize * int(np.prod(chunk, dtype=np.int64))
        if nbytes <= CHUNK_BYTES:
            break
        if chunk[axis] == 1:
            continue
        parts = -(-nbytes // CHUNK_BYTES)
        chunk[axis] = max(1, -(-chunk[axis] // parts))
    return tuple(chunk)


def write_tree(path: str, leaves: Iterable[WriteLeaf]) -> int:
    """Write `leaves` as an orbax checkpoint directory at `path`, which
    must not exist (as orbax refuses it). Each leaf's chunks go as raw-block
    zstd frames into one data file of the process store; `_CHECKPOINT_METADATA`
    is written last. Returns the bytes written."""
    path = os.path.abspath(path)
    os.mkdir(path)                              # FileExistsError if it exists
    proc = os.path.join(path, PROCESS_STORE)
    os.makedirs(os.path.join(proc, "d"))
    entries, files, tree, shardings, arrays = [], [], {}, {}, []
    total = 0
    for leaf in leaves:
        name = ".".join(leaf.path)
        zarray = {"chunks": list(leaf.chunks), "compressor": ZSTD_ZARRAY,
                  "dimension_separator": ".", "dtype": leaf.dtype, "fill_value": None,
                  "filters": None, "order": "C", "shape": list(leaf.shape),
                  "zarr_format": 2}
        entries.append((f"{name}/.zarray".encode(),
                        json.dumps(zarray, separators=(",", ":"), sort_keys=True).encode()))
        data_name = "d/" + uuid.uuid4().hex
        fd = os.open(os.path.join(proc, data_name), os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        offset = 0
        try:
            for idx in _chunk_grid(leaf.shape, leaf.chunks):
                data = memoryview(leaf.chunk(idx)).cast("B")
                key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}".encode()
                n = _write_frame(fd, data)
                entries.append((key, (len(files), offset, n)))
                offset += n
        finally:
            os.close(fd)
        files.append(data_name)
        total += offset
        tree[repr(tuple(leaf.path))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in leaf.path],
            "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False,
                               "write_shape": list(leaf.shape)}}
        shardings[base64.b64encode(name.encode()).decode()] = json.dumps(
            {"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
        arrays.append({"array_metadata": {"param_name": name, "write_shape": list(leaf.shape),
                                          "chunk_shape": list(leaf.chunks),
                                          "ext_metadata": None}})
    entries.sort(key=lambda e: e[0])
    _write_store(proc, entries, files, "")
    _write_store(path, entries, [f"{PROCESS_STORE}/{f}" for f in files], PROCESS_STORE + "/")
    t0 = time.time_ns()
    _write_json(os.path.join(path, "_METADATA"), {
        "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(os.path.join(path, "_sharding"), shardings)
    os.makedirs(os.path.join(path, "array_metadatas"))
    _write_json(os.path.join(path, "array_metadatas", "process_0"), {"array_metadatas": arrays})
    _write_json(os.path.join(path, "_CHECKPOINT_METADATA"), {
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}})
    return total


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
