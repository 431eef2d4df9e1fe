"""The port's checkpoint codec (csrc/checkpoint_codec.cc, built by
ops/_build.load_codec with the host compiler, as the allocator is) on the
CPU.

- The zstd decoder gives back exactly what the `zstandard` package
  compressed: levels 1, 3 and 19 (and a negative "fast" level); empty,
  1-byte and multi-block inputs; with and without the checksum flag; with
  and without the content size (a streamed frame); two frames in a row; a
  skippable frame first; random bytes, repetitive text, and bf16 arrays of
  normal draws made with numpy from a seed.
- It decodes, byte for byte, the zarr chunk frames and OCDBT node bodies
  that tensorstore wrote for a JAX `save_checkpoint`.
- A frame that asks for a dictionary is refused by name; a bad checksum,
  a short output buffer and a bad magic number give their errors.
- Damaged frames (every truncation of a few frames, and random byte flips
  drawn by hypothesis) return an error or a result within the buffer and
  never crash or write past it: all of these run in one subprocess, so a
  crash fails the test instead of taking down an xdist worker.
- CRC-32C matches the RFC 3720 (B.4) test vectors.
"""

import glob
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from polykey_tpu_torch.models import orbax
from polykey_tpu_torch.ops import _build

zstandard = pytest.importorskip("zstandard")

LEVELS = [1, 3, 19, -5]


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    normal = rng.standard_normal(400_000).astype(np.float32)
    # bf16: the float32 draws rounded to their top 16 bits.
    bits = normal.view(np.uint32)
    bf16 = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    words = b" ".join(rng.choice([b"orbax", b"zarr", b"chunk", b"layer", b"tensor",
                                  b"shard", b"0", b"1"], size=60_000))
    return {
        "empty": b"",
        "one-byte": b"\x5a",
        "random-1k": rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(),
        "random-multi-block": rng.integers(0, 256, 700_000, dtype=np.uint8).tobytes(),
        "zeros-multi-block": bytes(500_000),
        "text-multi-block": words,
        "small-alphabet": rng.integers(0, 5, 300_000, dtype=np.uint8).tobytes(),
        "bf16-normal": bf16.tobytes(),
        "f32-normal": normal[:100_000].tobytes(),
    }


INPUTS = _inputs()


def decode(frame: bytes, cap: int) -> bytes:
    return orbax.zstd_decode(frame, cap)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decoder_equals_zstandard(name, level, checksum):
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert decode(frame, len(data)) == data


@pytest.mark.parametrize("name", ["text-multi-block", "bf16-normal", "one-byte", "empty"])
def test_streamed_frames_without_content_size(name):
    data = INPUTS[name]
    comp = zstandard.ZstdCompressor(level=3, write_content_size=False).compressobj()
    frame = comp.compress(data) + comp.flush()
    assert decode(frame, len(data)) == data


def test_two_frames_and_a_skippable_frame():
    a, b = INPUTS["text-multi-block"][:70_000], INPUTS["bf16-normal"][:90_000]
    fa = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(a)
    fb = zstandard.ZstdCompressor(level=19).compress(b)
    skip = struct.pack("<II", 0x184D2A53, 11) + b"user data!!"
    assert decode(fa + fb, len(a) + len(b)) == a + b
    assert decode(skip + fa + skip + fb, len(a) + len(b)) == a + b
    assert decode(skip, 0) == b""


def test_raw_frames_of_the_writer():
    """write_tree's raw-block frames decode here and in zstandard."""
    for name in ("empty", "one-byte", "random-multi-block"):
        data = INPUTS[name]
        frame = orbax.raw_frame(data)
        assert decode(frame, len(data)) == data
        assert zstandard.ZstdDecompressor().decompress(frame) == data


def test_refusals_and_errors_by_name():
    data = INPUTS["text-multi-block"][:50_000]
    text = INPUTS["text-multi-block"]
    d = zstandard.train_dictionary(2048, [text[i:i + 500] for i in range(0, 200_000, 500)])
    assert d.dict_id() != 0
    with_dict = zstandard.ZstdCompressor(level=3, dict_data=d).compress(data)
    with pytest.raises(orbax.FormatError, match="dictionary"):
        decode(with_dict, len(data))
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    frame[-1] ^= 0xFF
    with pytest.raises(orbax.FormatError, match="checksum"):
        decode(bytes(frame), len(data))
    good = zstandard.ZstdCompressor(level=3).compress(data)
    with pytest.raises(orbax.FormatError, match="capacity"):
        decode(good, len(data) - 1)
    with pytest.raises(orbax.FormatError, match="magic"):
        decode(b"\0\1\2\3" + good, len(data))
    with pytest.raises(orbax.FormatError, match="truncated"):
        decode(good[:-5], len(data))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX save_checkpoint of a small tree with leaves large enough for
    compressed chunk frames."""
    import jax.numpy as jnp

    from polykey_tpu.models.loader import save_checkpoint

    rng = np.random.default_rng(1)
    tree = {"w": jnp.asarray(rng.standard_normal((64, 256)), jnp.bfloat16),
            "b": jnp.asarray(rng.standard_normal((300,)), jnp.float32),
            "n": {"h": jnp.asarray(rng.standard_normal((8, 40)), jnp.float16)}}
    path = tmp_path_factory.mktemp("ts") / "ckpt"
    save_checkpoint(str(path), tree)
    return str(path)


def test_decodes_what_tensorstore_wrote(jax_checkpoint):
    """Every zarr chunk frame and every compressed OCDBT node body that
    tensorstore wrote decodes byte for byte as zstandard decodes it."""
    store = orbax.read_store(jax_checkpoint)
    chunks = 0
    for key, value in store.items():
        if key.endswith(b".zarray"):
            continue
        frame = value if isinstance(value, bytes) else value.read()
        want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
        assert decode(frame, len(want)) == want, key
        chunks += 1
    assert chunks == 3
    nodes = 0
    for path in glob.glob(os.path.join(jax_checkpoint, "**", "d", "*"), recursive=True):
        blob = open(path, "rb").read()
        at = 0
        while True:
            at = blob.find(struct.pack(">I", orbax.NODE_MAGIC), at)
            if at < 0:
                break
            (length,) = struct.unpack_from("<Q", blob, at + 4)
            node = blob[at:at + length]
            if node[13] == 1:               # a zstd-compressed body
                body = node[14:-4]
                want = zstandard.ZstdDecompressor().decompressobj().decompress(body)
                assert decode(body, len(want)) == want
                nodes += 1
            at += 4
    assert nodes >= 2


def test_crc32c_rfc3720_vectors():
    lib = _build.load_codec()

    def crc(data: bytes) -> int:
        buf = np.frombuffer(data, np.uint8)
        return lib.pk_crc32c(buf.ctypes.data, len(data), 0)

    assert crc(bytes(32)) == 0x8A9136AA
    assert crc(b"\xff" * 32) == 0x62A8AB43
    assert crc(bytes(range(32))) == 0x46DD794E
    assert crc(bytes(range(31, -1, -1))) == 0x113FDB5C
    assert crc(b"123456789") == 0xE3069283
    # Continued over two parts, as one.
    data = INPUTS["random-1k"]
    a, b = np.frombuffer(data[:300], np.uint8), np.frombuffer(data[300:], np.uint8)
    assert lib.pk_crc32c(b.ctypes.data, len(b), lib.pk_crc32c(a.ctypes.data, len(a), 0)) \
        == crc(data) == orbax.crc32c(data)


CORRUPTION = textwrap.dedent('''
    import ctypes, sys
    import numpy as np
    from hypothesis import given, settings, HealthCheck, strategies as st

    lib = ctypes.CDLL(sys.argv[1])
    lib.pk_zstd_decompress.restype = ctypes.c_int64
    lib.pk_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_void_p, ctypes.c_uint64]
    frames = [bytes.fromhex(h) for h in sys.argv[2].split(",")]
    sizes = [int(n) for n in sys.argv[3].split(",")]
    GUARD = 4096

    def call(frame, cap):
        # The output sits between guard bytes: a write past `cap` shows.
        buf = np.full(cap + 2 * GUARD, 0xA5, np.uint8)
        src = np.frombuffer(frame, np.uint8) if frame else np.zeros(1, np.uint8)
        n = lib.pk_zstd_decompress(src.ctypes.data, len(frame),
                                   buf.ctypes.data + GUARD, cap)
        assert n <= cap, n
        assert (buf[:GUARD] == 0xA5).all() and (buf[GUARD + cap:] == 0xA5).all()
        return n

    count = 0
    for frame, size in zip(frames, sizes):
        for cut in range(len(frame)):
            assert call(frame[:cut], size) < 0 or cut == 0
            count += 1
        for cap in (0, size // 2):
            if size:
                assert call(frame, cap) < 0
                count += 1

    @settings(max_examples=1500, derandomize=True, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(st.data())
    def flips(data):
        i = data.draw(st.integers(0, len(frames) - 1))
        frame = bytearray(frames[i])
        for _ in range(data.draw(st.integers(1, 8))):
            at = data.draw(st.integers(0, len(frame) - 1))
            frame[at] = data.draw(st.integers(0, 255))
        call(bytes(frame), sizes[i] + data.draw(st.sampled_from([0, 7, 4096])))

    flips()
    print("ok", count)
''')


def test_damaged_frames_error_and_never_crash(tmp_path):
    rng = np.random.default_rng(3)
    sources = [INPUTS["text-multi-block"][:3000], INPUTS["bf16-normal"][:4000],
               INPUTS["small-alphabet"][:5000], INPUTS["random-1k"][:300],
               bytes(rng.integers(0, 3, 2000, dtype=np.uint8))]
    frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=chk).compress(s)
              for s, (lvl, chk) in zip(sources, [(3, True), (1, False), (19, True),
                                                 (3, False), (19, False)])]
    frames.append(orbax.raw_frame(INPUTS["random-1k"][:500]))
    sizes = [len(s) for s in sources] + [500]
    lib = _build.load_codec()._name
    proc = subprocess.run(
        [sys.executable, "-c", CORRUPTION, lib, ",".join(f.hex() for f in frames),
         ",".join(map(str, sizes))],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def _four_stream_frame(regen: int, stream4: bytes) -> bytes:
    """One compressed block of Huffman literals in four streams and no
    sequences, built by hand: a two-symbol table (one bit a symbol),
    streams 1-3 of two symbols each, and `stream4` as the fourth."""
    table = bytes([128, 0x10])          # one weight given (symbol 0: 1), one implied
    streams = b"\x04" * 3 + stream4     # 0x04: the end mark, then two bits
    comp = len(table) + 6 + len(streams)
    head = (2 | 3 << 2 | regen << 4 | comp << 22).to_bytes(5, "little")
    literals = head + table + struct.pack("<3H", 1, 1, 1) + streams
    block = literals + b"\x00"          # no sequences
    frame_header = struct.pack("<I", 0xFD2FB528) + bytes([0x00, 0x38])  # 128 KiB window
    return frame_header + (1 | 2 << 1 | len(block) << 3).to_bytes(3, "little") + block


FOUR_STREAMS = textwrap.dedent('''
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    lib.pk_zstd_decompress.restype = ctypes.c_int64
    lib.pk_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_void_p, ctypes.c_uint64]
    for path in sys.argv[2:]:
        src = np.fromfile(path, np.uint8)
        out = np.zeros(1 << 20, np.uint8)
        n = lib.pk_zstd_decompress(src.ctypes.data, len(src), out.ctypes.data, len(out))
        print(n, out[:max(n, 0)].tobytes().hex())
''')


def test_four_streams_of_too_few_literals_are_refused(tmp_path):
    """Four Huffman streams need six literals. A section that claims five,
    with a long fourth stream, is refused as corrupt (as libzstd refuses
    it) before any stream is decoded: the fourth stream's count would wrap
    below zero and its symbols run far past the literals' buffer. Six
    literals, with an empty fourth stream, decode as zstandard decodes
    them. In a subprocess, so that a write out of bounds fails the test
    instead of taking down an xdist worker."""
    bad = _four_stream_frame(5, b"\xff" * 120_000)
    good = _four_stream_frame(6, b"\x01")
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompressobj().decompress(bad)
    want = zstandard.ZstdDecompressor().decompressobj().decompress(good)
    assert len(want) == 6
    paths = []
    for name, frame in (("bad", bad), ("good", good)):
        (tmp_path / name).write_bytes(frame)
        paths.append(str(tmp_path / name))
    lib = _build.load_codec()
    proc = subprocess.run([sys.executable, "-c", FOUR_STREAMS, lib._name, *paths],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (bad_n, _), (good_n, good_out) = [(int(line.split(" ")[0]), line.partition(" ")[2])
                                      for line in proc.stdout.splitlines()]
    assert lib.pk_codec_error(bad_n).decode() == "corrupt frame"
    assert good_n == 6 and bytes.fromhex(good_out) == want
