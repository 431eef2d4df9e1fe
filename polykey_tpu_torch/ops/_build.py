"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Route: `nvcc` for `sm_90a` into ONE shared library with a plain C
interface, loaded with `ctypes` — seconds to build, against minutes for a
source that includes PyTorch's headers. Each source compiles in its own
`nvcc` process, all started together, then one link step joins them.

The build happens on first use, never at import (the CPU tests import
every module and have no `nvcc`), into `build/kernels/` at the repository
root, and is redone whenever a source's content hash or the flags change.

Every kernel is a `Kernel`: its C symbol and argument types, and a
`launches` count that goes up by one at each launch and nowhere else, so
a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

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
build_log: str = ""          # ptxas register/spill report of the last build
build_seconds: float = 0.0   # 0.0 when the library came from the cache


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
    objs = [out.parent / (src.stem + ".o") for src in sources]
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
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return "\n".join(logs)


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        digest = _digest(sources)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / "digest"
        fresh = (
            lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest
        )
        if not fresh:
            t0 = time.monotonic()
            build_log = _build(sources, lib_path)
            build_seconds = time.monotonic() - t0
            stamp.write_text(digest + "\n")
        _lib = ctypes.CDLL(str(lib_path))
        return _lib


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class Kernel:
    """One C entry point of the library plus its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        """Launch on the current stream. Pointer arguments are passed as
        tensors (their data_ptr is taken here); the stream goes last."""
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


def _error_name(err: int) -> str:
    fn = load_library().pk_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [I]
    return fn(err).decode()


def check_cuda_tensor(name: str, t: torch.Tensor, dtype=None, ndim=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype/rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
