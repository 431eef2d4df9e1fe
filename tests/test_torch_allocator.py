"""The port's native block allocator (csrc/block_allocator.cc, built by
ops/_build.load_allocator and bound in engine/kv_cache.BlockAllocator)
against its plain Python version and the JAX package's allocator.

Seeded sequences of alloc (all-or-nothing, failing when too few pages are
free), retain and release (of live, free, garbage and out-of-range pages)
must give identical pages, free counts and errors on all three. The host
compiler is on the CPU machine, so the native library is built and run
here for real.
"""

import threading

import numpy as np
import pytest

from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu_torch.engine import kv_cache as tkv
from polykey_tpu_torch.ops import _build

NUM_PAGES = 24


def _apply(alloc, op, arg):
    """One call's observable outcome: its result or its error's type."""
    try:
        if op == "alloc":
            out = alloc.alloc(arg)
        elif op == "retain":
            out = alloc.retain(arg)
        else:
            out = alloc.release(arg)
    except (jkv.AllocationError, tkv.AllocationError):
        out = "AllocationError"
    except ValueError:
        out = "ValueError"
    return out, alloc.num_free


def _script(seed: int, n: int = 400):
    rs = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        op = rs.choice(["alloc", "alloc", "retain", "release", "release"])
        if op == "alloc":
            arg = int(rs.randint(0, 9))
        else:
            arg = int(rs.randint(-1, NUM_PAGES + 2))     # includes 0, -1 and past the end
        ops.append((op, arg))
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sequences_agree_with_python_and_reference(seed):
    native = tkv.BlockAllocator(NUM_PAGES)
    plain = tkv.BlockAllocator(NUM_PAGES, prefer_native=False)
    ref = jkv.BlockAllocator(NUM_PAGES, prefer_native=False)
    assert native.is_native and not plain.is_native and not ref.is_native
    outcomes = {"AllocationError": 0, "ValueError": 0, "pages": 0}
    for op, arg in _script(seed):
        got = _apply(native, op, arg)
        assert got == _apply(plain, op, arg) == _apply(ref, op, arg), (op, arg)
        outcomes[got[0] if isinstance(got[0], str) else "pages"] += 1
    assert all(outcomes.values()), outcomes       # the script reached every branch


def test_alloc_is_all_or_nothing_and_lowest_first():
    a = tkv.BlockAllocator(6)
    assert a.alloc(3) == [1, 2, 3] and a.num_free == 2
    with pytest.raises(tkv.AllocationError, match="requested 3 pages, 2 free"):
        a.alloc(3)
    assert a.num_free == 2 and a.alloc(0) == []
    a.release(2)
    assert a.alloc(1) == [2]                       # released pages come back first


def test_garbage_page_is_never_handed_out_or_released():
    a = tkv.BlockAllocator(4)
    assert 0 not in a.alloc(3)
    for bad in (0, -1, 4):
        with pytest.raises(ValueError):
            a.release(bad)
        with pytest.raises(ValueError):
            a.retain(bad)
    with pytest.raises(ValueError, match="at least 2 pages"):
        tkv.BlockAllocator(1)


def test_concurrent_alloc_release_keeps_the_books():
    """Threads allocating and releasing while others read the free count:
    the native library locks every entry point, so no page is lost or
    handed out twice."""
    import sys

    a = tkv.BlockAllocator(64)
    held: list = []
    lock = threading.Lock()
    errors = []

    def worker(seed):
        rs = np.random.RandomState(seed)
        try:
            for _ in range(300):
                try:
                    pages = a.alloc(int(rs.randint(1, 4)))
                except tkv.AllocationError:
                    pages = []
                with lock:
                    held.extend(pages)
                    mine = [held.pop() for _ in range(min(len(held), int(rs.randint(0, 4))))]
                for p in mine:
                    a.release(p)
                assert 0 <= a.num_free <= 63
        except BaseException as e:          # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(held)) == len(held) and a.num_free == 63 - len(held)
    a.release_all(held)
    assert a.num_free == 63


def test_library_is_built_under_build_with_its_stamp(tmp_path, monkeypatch):
    """A fresh build directory: the library and its stamp appear there,
    and a second load in a new process state reuses them."""
    monkeypatch.setattr(_build, "ALLOCATOR_DIR", tmp_path / "allocator")
    monkeypatch.setattr(_build, "_allocator", None)
    monkeypatch.setattr(_build, "_allocator_failed", None)
    lib = _build.load_allocator()
    names = sorted(p.name for p in (tmp_path / "allocator").iterdir())
    assert names == sorted([".lock", _build.ALLOCATOR_LIB, "digest"])
    handle = lib.pk_allocator_new(5)
    assert lib.pk_num_free(handle) == 4
    lib.pk_allocator_free(handle)
    stamp = (tmp_path / "allocator" / "digest").stat().st_mtime_ns
    monkeypatch.setattr(_build, "_allocator", None)
    _build.load_allocator()
    assert (tmp_path / "allocator" / "digest").stat().st_mtime_ns == stamp


def test_a_failed_build_raises_and_is_not_redone(tmp_path, monkeypatch):
    """The native allocator is never quietly replaced by the Python one: a
    build that fails raises from the constructor, every time, without
    running the compiler again."""
    calls = []

    def failing(out):
        calls.append(out)
        raise RuntimeError("building block_allocator.cc failed")

    monkeypatch.setattr(_build, "_build_allocator", failing)
    monkeypatch.setattr(_build, "ALLOCATOR_DIR", tmp_path / "allocator")
    monkeypatch.setattr(_build, "_allocator", None)
    monkeypatch.setattr(_build, "_allocator_failed", None)
    for _ in range(3):
        with pytest.raises(RuntimeError, match="block_allocator.cc failed"):
            tkv.BlockAllocator(8)
    assert len(calls) == 1
    assert not tkv.BlockAllocator(8, prefer_native=False).is_native
