"""The host-sync guard: the port's counterpart of the reference's
``jax.transfer_guard("disallow")`` around the serving loop (graphlint's
GL004, analysis/graph.py).

`HostSyncGuard` is a TorchDispatchMode. Entered on the thread that
dispatches (the engine thread, through `InferenceEngine.loop_guard`), it
raises `HostSyncTrip`, and records the trip, on every op that reads a
tensor's value on the host or moves bytes between devices, unless the op
runs inside a sanctioned crossing (`engine._host_crossing(site)`, which
calls `sanctioned` here):

- `aten._local_scalar_dense` and `aten.item` (`.item()`, `int(t)`,
  `float(t)`), `aten.is_nonzero` (`bool(t)`), `aten.equal`, `aten.nonzero`,
  `aten.masked_select` and an index by a bool mask (a nonzero inside it):
  each reads the device's data before the host can go on;
- a copy between devices (`aten.copy_`, `aten._to_copy` or `aten.to` to
  another device), and an op on CUDA tensors given a CPU tensor that is
  not a 0-dim scalar (the op copies it up).

What each half sees. Dispatch modes are per thread: a mode entered on one
thread sees nothing of another's ops, so the guard is entered where the
loop runs. On the CPU there is one device, so only the host reads above
can trip; `.numpy()` and `.tolist()` of a CPU tensor reach no dispatch at
all. On the card the guard also sets `torch.cuda.set_sync_debug_mode
("error")`, process-wide, which raises on the synchronizing copies and
stream waits below dispatch; a sanctioned scope lifts it and puts it
back, so a card run sweeps one engine at a time. Neither half sees
`Event.synchronize()` or `torch.cuda.synchronize()`: the engine's
resolve points wait on events, and the crossing census
(`engine.CROSSING_CENSUS`), not the guard, counts those sites.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# Guards entered and not yet left, on any thread. While it is empty a
# crossing scope costs its census count and this one test
# (engine._host_crossing).
OPEN: set = set()
_THREAD = threading.local()       # .guard: the guard entered on this thread
_NULL = contextlib.nullcontext()

# Under inference mode (the engine thread's) composite ops reach the mode
# whole (`aten.item`, `aten.to`), elsewhere decomposed (`_local_scalar_dense`,
# `_to_copy`): both spellings count.
_HOST_READS = frozenset({
    aten._local_scalar_dense, aten.item, aten.is_nonzero, aten.equal, aten.nonzero,
    aten.masked_select,
})
_INDEXING = frozenset({aten.index, aten.index_put, aten.index_put_})


def _destination(packet, args, kwargs):
    """The device a `_to_copy` or `to` call copies to, or None."""
    if packet is aten._to_copy:
        return kwargs.get("device")
    if packet is aten.to:
        if kwargs.get("device") is not None:
            return kwargs["device"]
        for a in args[1:2]:
            if isinstance(a, torch.Tensor):
                return a.device
            if isinstance(a, (str, torch.device)):
                return a
    return None


class HostSyncTrip(RuntimeError):
    """A host read or a device crossing outside a sanctioned crossing."""


def crossing(func, args, kwargs) -> Optional[str]:
    """Why the op `func(*args, **kwargs)` waits for the device or moves
    bytes between devices, or None."""
    packet = func.overloadpacket
    if packet in _HOST_READS:
        return "reads a tensor's value on the host"
    tensors = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    if packet in _INDEXING and any(t.dtype == torch.bool for t in tensors[1:]):
        return "indexes by a bool mask (a nonzero on the host)"
    dst = _destination(packet, args, kwargs)
    if dst is not None and torch.device(dst).type != args[0].device.type:
        return f"copies {args[0].device.type} -> {torch.device(dst).type}"
    devices = {t.device.type for t in tensors} - {"meta"}
    if len(devices) < 2:
        return None
    if packet is aten.copy_:
        return f"copies {args[1].device.type} -> {args[0].device.type}"
    if any(t.device.type == "cpu" and t.dim() > 0 for t in tensors):
        return "takes a CPU tensor beside device tensors (the op copies it)"
    return None


class HostSyncGuard(TorchDispatchMode):
    """Refuse unsanctioned host syncs on this thread while entered. Trips
    are appended to `trips` (one line each) before the op raises, so a
    caller that swallows the raise still sees them. `sync_debug` (CUDA
    only) also sets the process's sync debug mode to "error" while
    entered."""

    def __init__(self, trips: Optional[list] = None, sync_debug: bool = False):
        super().__init__()
        self.trips = trips if trips is not None else []
        self.sync_debug = sync_debug
        self._lifted = 0
        self._saved_mode = 0

    def __enter__(self):
        if getattr(_THREAD, "guard", None) is not None:
            raise RuntimeError("a host-sync guard is already entered on this thread")
        _THREAD.guard = self
        OPEN.add(self)
        if self.sync_debug:
            self._saved_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self.sync_debug:
                torch.cuda.set_sync_debug_mode(self._saved_mode)
            OPEN.discard(self)
            _THREAD.guard = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._lifted:
            why = crossing(func, args, kwargs)
            if why is not None:
                self.trips.append(f"{func}: {why}")
                raise HostSyncTrip(
                    f"host sync outside a sanctioned crossing: {func} {why}")
        return func(*args, **kwargs)

    @contextlib.contextmanager
    def lifted(self):
        """A sanctioned crossing: nothing trips inside it."""
        self._lifted += 1
        if self.sync_debug and self._lifted == 1:
            torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            self._lifted -= 1
            if self.sync_debug and self._lifted == 0:
                torch.cuda.set_sync_debug_mode("error")


def sanctioned():
    """The scope of a sanctioned crossing on this thread: its guard lifted
    (a no-op context on a thread with none)."""
    guard = getattr(_THREAD, "guard", None)
    return _NULL if guard is None else guard.lifted()
