"""Host throughput of the port's checkpoint decoder on the reference's own
checkpoint format, against libzstd (the `zstandard` package) on the same
frame.

The JAX package's `save_checkpoint` writes one stacked bf16 leaf of
Llama-3-8B's MLP shape ([layers, 4096, 14336], normal draws x 0.02 made
with numpy from `--seed`), cut to `--layers` layers, as tensorstore writes
it: zarr chunks of zstd level 1. A fresh subprocess then reads it back
three times with `models/orbax.read_tree` (the port's path: the data file
mapped, each chunk frame decoded straight into the leaf's buffer) and
reports the seconds, the rate and the process's peak resident memory
in the first read above what it held before it (the leaf's buffer and
the mapped frames). It also times the codec's
`pk_zstd_decompress` and libzstd on the largest chunk frame alone, one
thread each. Everything runs on the host CPU; no device is used.

    JAX_PLATFORMS=cpu python tests/torch_codec_throughput.py --layers 4

Prints one JSON object as its last line.
"""

import argparse
import json
import os
import platform
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_READ = r"""
import json, sys, time
import numpy as np
import zstandard
from polykey_tpu_torch.models import orbax

path = sys.argv[1]

def status_kib(field):
    # VmHWM, unlike ru_maxrss, starts anew at exec: the parent's size does
    # not count.
    for line in open("/proc/self/status"):
        if line.startswith(field + ":"):
            return int(line.split()[1])

orbax._codec()
base = status_kib("VmRSS")
reads = []
for i in range(3):
    t0 = time.perf_counter()
    nbytes = sum(leaf.data.nbytes for leaf in orbax.read_tree(path))
    reads.append(time.perf_counter() - t0)
    if i == 0:                                  # the first read's peak
        peak = status_kib("VmHWM")
store = orbax.read_store(path)
files = orbax._Files()
frames = [v for k, v in store.items() if not k.endswith(b".zarray")]
ref = max(frames, key=lambda v: v.length if not isinstance(v, bytes) else len(v))
addr, mapping = files.address(ref)
frame = mapping[ref.offset:ref.offset + ref.length].tobytes()
meta = [v for k, v in store.items() if k.endswith(b".zarray")][0]
chunks = json.loads(meta if isinstance(meta, bytes) else meta.read())["chunks"]
size = int(np.prod(chunks)) * 2                 # bf16
out = np.empty(size, np.uint8)
src = np.frombuffer(frame, np.uint8)
ours, theirs = [], []
dctx = zstandard.ZstdDecompressor()
for _ in range(3):
    t0 = time.perf_counter()
    orbax.zstd_decode_into(src.ctypes.data, len(frame), out.ctypes.data, size)
    ours.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = dctx.decompress(frame, max_output_size=size)
    theirs.append(time.perf_counter() - t0)
assert want == out.tobytes()
print(json.dumps({"leaf_bytes": nbytes, "chunk_frames": len(frames), "chunk_shape": chunks,
                  "read_tree_s": reads, "peak_rss_above_base_bytes": (peak - base) * 1024,
                  "frame_bytes": len(frame), "frame_content_bytes": size,
                  "codec_s": ours, "libzstd_s": theirs}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4, help="layers of the stacked leaf")
    ap.add_argument("--seed", type=int, default=0, help="seed of the draws")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    import jax.numpy as jnp
    import numpy as np

    from polykey_tpu.models.loader import save_checkpoint

    shape = (args.layers, 4096, 14336)
    rng = np.random.default_rng(args.seed)
    leaf = jnp.asarray(rng.standard_normal(shape, np.float32) * 0.02, jnp.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        save_checkpoint(path, {"layers": {"mlp": {"up": leaf}}})
        del leaf
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(path) for f in fs)
        proc = subprocess.run([sys.executable, "-c", _READ, path], capture_output=True,
                              text=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    cpu = next((line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo")
                if line.startswith("model name")), platform.processor())
    best = min(got["read_tree_s"])
    got.update({
        "shape": list(shape), "checkpoint_disk_bytes": disk, "host_cpu": cpu,
        "host_cores": os.cpu_count(),
        "read_tree_gb_s": got["leaf_bytes"] / best / 1e9,
        "codec_gb_s": got["frame_content_bytes"] / min(got["codec_s"]) / 1e9,
        "libzstd_gb_s": got["frame_content_bytes"] / min(got["libzstd_s"]) / 1e9,
    })
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
