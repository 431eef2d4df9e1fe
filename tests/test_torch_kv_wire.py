"""The port's KV wire format (polykey_tpu_torch/engine/kv_cache.py) against
the JAX package's (polykey_tpu/engine/kv_cache.py), on the CPU.

The port writes no ml_dtypes array: bf16 goes out as its 16-bit words
under the dtype name "bfloat16". Its blobs must be byte-identical to
`serialize_kv_state`'s for the same contents (float32, bf16, and int8
values with bf16 scales), each package must read the other's, and every
damaged blob must raise KVWireError before anything is written.
"""

import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu_torch.engine import kv_cache as tkv
from polykey_tpu_torch.engine import prefix_cache as tpc
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import tensor_from_numpy

CFG = get_config("tiny-llama")
PS = 8


def _arrays(kind: str, pages: int = 3, seed: int = 0) -> dict:
    """numpy pages in the pool layout: float32, bf16 (ml_dtypes) or int8
    values with bf16 scales."""
    rng = np.random.default_rng(seed)
    shape = (CFG.num_layers, pages, PS, CFG.num_kv_heads, CFG.head_dim)
    if kind == "int8":
        out = {n: rng.integers(-127, 128, shape).astype(np.int8) for n in ("k", "v")}
        for n in ("ks", "vs"):
            out[n] = (rng.random(shape[:-1]) * 0.02 + 1e-3).astype(ml_dtypes.bfloat16)
        return out
    dtype = np.float32 if kind == "float32" else ml_dtypes.bfloat16
    return {n: rng.standard_normal(shape).astype(dtype) for n in ("k", "v")}


def _states(kind: str, pages: int = 3):
    """The same state as the JAX package's and as the port's."""
    arrs = _arrays(kind, pages)
    ids = np.arange(PS * pages - 3, dtype=np.int32) + 7
    meta = dict(model=CFG.name, page_size=PS, prompt_len=len(ids), first_token=42,
                seed=2**40 + 3)
    j = jkv.KVHandoffState(prompt_ids=ids, **meta, **arrs)
    t = tkv.KVHandoffState(prompt_ids=torch.from_numpy(ids.copy()), **meta,
                           **{n: tensor_from_numpy(a) for n, a in arrs.items()})
    return j, t


def _same(t: torch.Tensor, a: np.ndarray) -> bool:
    """Bit-equality of a port tensor and a reference array."""
    return (str(t.dtype).removeprefix("torch.") == str(a.dtype)
            and tuple(t.shape) == a.shape
            and tkv._raw(t) == np.ascontiguousarray(a).tobytes())


KINDS = ["float32", "bfloat16", "int8"]


@pytest.mark.parametrize("kind", KINDS)
def test_blobs_are_byte_identical(kind):
    """The same state serializes to the same bytes in both packages:
    header (key order, json.dumps defaults, dtype names), payload, CRC."""
    j, t = _states(kind)
    blob = tkv.serialize_kv_state(t)
    assert blob == jkv.serialize_kv_state(j)
    assert tkv.validate_kv_blob(blob) == jkv.validate_kv_blob(blob)


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_reads_the_others_blobs(kind):
    """A JAX blob read by the port, and a port blob read by the JAX package,
    give the same arrays bit for bit and the same metadata."""
    j, t = _states(kind)
    got = tkv.deserialize_kv_state(jkv.serialize_kv_state(j))
    back = jkv.deserialize_kv_state(tkv.serialize_kv_state(t))
    for name in ("prompt_ids", "k", "v", "ks", "vs"):
        ref = getattr(j, name)
        if ref is None:
            assert getattr(got, name) is None and getattr(back, name) is None
            continue
        assert _same(getattr(got, name), ref), name
        assert str(getattr(back, name).dtype) == str(ref.dtype)
        assert np.ascontiguousarray(getattr(back, name)).tobytes() == ref.tobytes(), name
    for name in ("model", "page_size", "prompt_len", "first_token", "seed", "quantized"):
        assert getattr(got, name) == getattr(j, name) == getattr(back, name)
    got.validate_for(CFG, PS, quantized=kind == "int8")


def _flip(blob: bytes, at: int) -> bytes:
    b = bytearray(blob)
    b[at] ^= 0x01
    return bytes(b)


DAMAGE = {
    "magic": lambda b: b"XKKV" + b[4:],
    "version": lambda b: b[:4] + struct.pack("!H", 2) + b[6:],
    "truncated": lambda b: b[:-9],
    "header-cut": lambda b: b[:20],
    "flipped-bit": lambda b: _flip(b, len(b) - 40),
    "crc": lambda b: b[:-1] + bytes([b[-1] ^ 0xFF]),
}


@pytest.mark.parametrize("damage", list(DAMAGE))
def test_damaged_blobs_raise(damage):
    """Bad magic, a bad version, truncation and a flipped bit each raise
    KVWireError in both packages."""
    j, t = _states("bfloat16", pages=2)
    bad = DAMAGE[damage](tkv.serialize_kv_state(t))
    with pytest.raises(tkv.KVWireError):
        tkv.deserialize_kv_state(bad)
    with pytest.raises(jkv.KVWireError):
        jkv.deserialize_kv_state(bad)


def test_header_and_payload_must_agree():
    """A header that claims int8 over arrays without scales is refused."""
    _, t = _states("float32", pages=1)
    blob = tkv.serialize_kv_state(t)
    header, start = tkv._parse_header(blob)
    header["quantized"] = True
    raw = json.dumps(header).encode()
    forged = blob[:4] + struct.pack("!HI", 1, len(raw)) + raw + blob[start:]
    with pytest.raises(tkv.KVWireError, match="mismatch"):
        tkv.deserialize_kv_state(forged)


def test_geometry_mismatch_is_refused_without_writing_the_pool(tmp_path):
    """`validate_for` refuses another model, page size, page count or pool
    form; a durable batch of another geometry is discarded by `load_into`
    and the host pool is left untouched (every page free, all zeros)."""
    _, t = _states("float32", pages=3)
    for args in ((CFG, 16, False), (CFG, PS, True)):
        with pytest.raises(tkv.KVWireError):
            t.validate_for(*args)
    for field, value, match in (("model", "llama-3-8b", "model"),
                                ("prompt_len", 40, "does not cover")):
        with pytest.raises(tkv.KVWireError, match=match):
            tkv.KVHandoffState(**{**t.__dict__, field: value}).validate_for(CFG, PS, False)

    store = tpc.PrefixStateStore(str(tmp_path), CFG.name, PS, params_key="p",
                                 quantized=False)
    wide = _arrays("float32", pages=2)
    k = tensor_from_numpy(np.concatenate([wide["k"]] * 2, axis=-1))   # head_dim x 2
    store.save_batch([b"\x01" * 16, b"\x02" * 16], k, k, None, None)
    host = tkv.HostKVPool(CFG, 4, PS, torch.float32, False)
    cache = tpc.PrefixCache(tkv.BlockAllocator(16), PS, 8, host_pool=host)
    expect = (CFG.num_layers, 0, PS, CFG.num_kv_heads, CFG.head_dim)
    assert store.load_into(cache, host, expect) == 0
    assert host.num_free == 4 and not host.k.any() and not host.v.any()
    assert len(cache) == 0
    assert not list(tmp_path.iterdir())               # discarded
