"""Build and bind the hand-written CUDA kernels (csrc/*.cu), the native
block allocator (csrc/block_allocator.cc, `load_allocator`) and the
checkpoint codec (csrc/checkpoint_codec.cc, `load_codec`).

Route: `nvcc` for `sm_90a` into ONE shared library with a plain C
interface, loaded with `ctypes` — seconds to build, against minutes for a
source that includes PyTorch's headers. Each source compiles in its own
`nvcc` process, all started together, then one link step joins them.

The build happens on first use, never at import (the CPU tests import
every module and have no `nvcc`), into `build/kernels/` at the repository
root, and is redone whenever a source's content hash or the flags change.
Several processes may start at once (the disaggregated pool's workers on a
fresh tree): the freshness check, the build and the stamp all run under an
exclusive `flock` on `build/kernels/.lock`, and the check is made again
once the lock is held, so the first process builds and the others load
what it built. Objects are compiled to per-process names and the library
is renamed into place before the stamp is written, in the same locked
section.

Every kernel is a `Kernel`: its C symbol and argument types, and a
`launches` count that goes up by one at each launch and nowhere else, so
a run can show which kernels its main path went through. A CUDA graph
replays its kernels without a call: `uncounted` takes a capture's launches
back out of the counts and records them, and `count_replay` adds them
again for each replay, so the counts stay the launches the card ran.

The allocator and the codec are host code: the host C++ compiler builds
each into its own directory (`build/allocator/`, `build/codec/`) with its
own library and stamp, under the same flock scheme, so engines and worker
processes starting together build it once.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch

_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _ROOT / "build" / "kernels"
LIB_NAME = "libpolykey_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[RuntimeError] = None   # a failed build, raised again, not redone
build_log: str = ""          # ptxas register/spill report of the last build
build_seconds: float = 0.0   # 0.0 when the library came from the cache
loads: int = 0               # the library built or loaded in this process (0 or 1)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "polykey_tpu_torch are built from csrc/ on first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(sources: list[Path], out: Path) -> str:
    """Compile every source in parallel, link into `out`; returns the
    compilers' combined stderr (the -Xptxas -v report)."""
    nvcc = _nvcc()
    objs = [out.parent / f"{src.stem}.{os.getpid()}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    logs = []
    failed = []
    for src, proc in zip(sources, procs):
        stdout, stderr = proc.communicate()
        logs.append(f"== {src.name}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(logs)
        )
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *map(str, objs), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return "\n".join(logs)


@contextlib.contextmanager
def _build_lock(directory: Path):
    """An exclusive advisory lock on `directory`/.lock, across processes
    (the thread lock `_lock` covers the threads of one)."""
    with open(directory / ".lock", "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _fresh_library(build_dir: Path, lib_name: str, digest: str, build) -> tuple:
    """`build_dir`/`lib_name` loaded with ctypes, built first by
    `build(path)` unless the stamp beside it (`digest`) matches: the check,
    the build, the stamp and the load all under the directory's flock.
    Returns (library, seconds the build took, 0.0 when it was fresh)."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / lib_name
    stamp = build_dir / "digest"
    seconds = 0.0
    with _build_lock(build_dir):
        fresh = (
            lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest
        )
        if not fresh:
            t0 = time.monotonic()
            build(lib_path)
            seconds = time.monotonic() - t0
            stamp.write_text(digest + "\n")
        return ctypes.CDLL(str(lib_path)), seconds


def _build_kernels(lib_path: Path) -> None:
    global build_log
    build_log = _build(_sources(), lib_path)


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale. A build
    that fails is not tried again in this process: every later call raises
    its error at once."""
    global _lib, _failed, build_seconds, loads
    with _lock:
        if _lib is not None:
            return _lib
        if _failed is not None:
            raise _failed
        try:
            _lib, seconds = _fresh_library(BUILD_DIR, LIB_NAME, _digest(_sources()),
                                           _build_kernels)
        except RuntimeError as e:
            _failed = e
            raise
        if seconds:
            build_seconds = seconds
        loads += 1
        return _lib


# -- the native block allocator (host C++, engine/kv_cache.py) --------------

ALLOCATOR_DIR = _ROOT / "build" / "allocator"
ALLOCATOR_SOURCE = CSRC / "block_allocator.cc"
ALLOCATOR_LIB = "libblock_allocator.so"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")

_allocator: Optional[ctypes.CDLL] = None
_allocator_failed: Optional[RuntimeError] = None


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler (g++ or c++ on PATH): the native block "
        "allocator and the checkpoint codec are built from csrc/*.cc on "
        "first use"
    )


def _host_build(source: Path, flags: tuple, out: Path) -> None:
    """Compile the host C++ `source` with `flags` into the shared library
    `out`."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_cxx(), *flags, str(source), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {source.name} failed:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)


def _bind_host(directory: Path, lib_name: str, source: Path, flags: tuple,
               build: Callable[[Path], None], signatures: tuple) -> ctypes.CDLL:
    """The host library `lib_name` in `directory`, built by `build` first
    if it is missing or its source or flags changed, with `signatures`
    ((symbol, restype, argtypes), ...) bound. Call under `_lock`."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    lib, _ = _fresh_library(directory, lib_name, h.hexdigest()[:16], build)
    for symbol, restype, argtypes in signatures:
        fn = getattr(lib, symbol)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _build_allocator(out: Path) -> None:
    _host_build(ALLOCATOR_SOURCE, CXX_FLAGS, out)


def load_allocator() -> ctypes.CDLL:
    """The native block allocator's library (`pk_*` entry points), built
    with the host C++ compiler into `build/allocator/` on first use and
    whenever its source or flags change, under the same kind of flock as
    the kernels. A failed build raises, now and on every later call."""
    global _allocator, _allocator_failed
    i32, ptr = ctypes.c_int32, ctypes.c_void_p
    with _lock:
        if _allocator is not None:
            return _allocator
        if _allocator_failed is not None:
            raise _allocator_failed
        try:
            _allocator = _bind_host(ALLOCATOR_DIR, ALLOCATOR_LIB, ALLOCATOR_SOURCE,
                                    CXX_FLAGS, _build_allocator, (
                ("pk_allocator_new", ptr, [i32]),
                ("pk_allocator_free", None, [ptr]),
                ("pk_num_free", i32, [ptr]),
                ("pk_alloc", i32, [ptr, i32, ctypes.POINTER(i32)]),
                ("pk_retain", i32, [ptr, i32]),
                ("pk_release", i32, [ptr, i32]),
            ))
        except RuntimeError as e:
            _allocator_failed = e
            raise
        return _allocator


# -- the checkpoint codec (host C++, models/orbax.py) ------------------------

CODEC_DIR = _ROOT / "build" / "codec"
CODEC_SOURCE = CSRC / "checkpoint_codec.cc"
CODEC_LIB = "libcheckpoint_codec.so"
CODEC_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared")

_codec: Optional[ctypes.CDLL] = None
_codec_failed: Optional[RuntimeError] = None


def _build_codec(out: Path) -> None:
    _host_build(CODEC_SOURCE, CODEC_FLAGS, out)


def load_codec() -> ctypes.CDLL:
    """The checkpoint codec's library (the zstd frame decoder
    `pk_zstd_decompress`, `pk_crc32c`, `pk_codec_error`), built
    with the host C++ compiler into `build/codec/` on first use and
    whenever its source or flags change, as the allocator is. Nothing
    falls back to Python: a failed build raises, now and on every later
    call."""
    global _codec, _codec_failed
    u8p, u64, i64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
    with _lock:
        if _codec is not None:
            return _codec
        if _codec_failed is not None:
            raise _codec_failed
        try:
            _codec = _bind_host(CODEC_DIR, CODEC_LIB, CODEC_SOURCE, CODEC_FLAGS,
                                _build_codec, (
                ("pk_zstd_decompress", i64, [u8p, u64, u8p, u64]),
                ("pk_crc32c", ctypes.c_uint32, [u8p, u64, ctypes.c_uint32]),
                ("pk_codec_error", ctypes.c_char_p, [i64]),
            ))
        except RuntimeError as e:
            _codec_failed = e
            raise
        return _codec


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


_KERNELS: list = []   # every Kernel made, for `uncounted`


class Kernel:
    """One C entry point of the library plus its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        _KERNELS.append(self)

    def __call__(self, *args) -> None:
        """Launch on the current stream. Pointer arguments are passed as
        tensors (their data_ptr is taken here); the stream goes last. On
        `meta` tensors nothing launches and nothing counts: a wrapper called
        on them runs its checks and allocations alone, the abstract
        evaluation that graphlint's GL005 holds output contracts with
        (analysis/graph.py)."""
        if any(isinstance(a, torch.Tensor) and a.is_meta for a in args):
            return
        if self._fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes = self.argtypes + [P]
            fn.restype = I
            self._fn = fn
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*conv, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} failed to launch: error {err} "
                f"({_error_name(err)})"
            )
        self.launches += 1


@contextlib.contextmanager
def uncounted():
    """Run a block whose launches are not the card's work: a warm-up, or a
    CUDA graph capture, whose launches run only when it is replayed. Yields
    a dict that, once the block ends, maps each kernel launched in it to
    its launches there; those are taken back out of the kernels' counts."""
    before = [(k, k.launches) for k in _KERNELS]
    made: dict = {}
    try:
        yield made
    finally:
        for k, n in before:
            if k.launches != n:
                made[k] = k.launches - n
                k.launches = n


def count_replay(made: dict) -> None:
    """Count one replay of a graph whose capture made `made` launches."""
    for k, n in made.items():
        k.launches += n


def _error_name(err: int) -> str:
    fn = load_library().pk_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [I]
    return fn(err).decode()


def check_cuda_tensor(name: str, t: torch.Tensor, dtype=None, ndim=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype/rank
    (or a `meta` one, for an abstract evaluation: `Kernel.__call__`)."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
