"""Fault injection: named failure points, armed only via POLYKEY_FAULTS
(the reference's polykey_tpu/faults.py, the same grammar and points).

The resilience layer (deadline drops, load shedding, watchdog trip,
supervised restart) is unreachable by well-behaved tests — a tiny
model never hangs, never exhausts its allocator, never misses a
deadline. This module makes those paths deterministically reachable:
the engine asks for a module-shared `FaultInjector` at construction and
consults it at a handful of *named injection points*; the injector is
None unless `POLYKEY_FAULTS` is set (or a test calls `install()`), so
every call site reduces to one attribute load plus an `is None` check —
no parsing, no dict lookups, no clock reads on the hot path.

Spec grammar (comma- or semicolon-separated entries)::

    POLYKEY_FAULTS="step-stall=1.5@1,slow-step=0.01"
    POLYKEY_FAULTS="step-stall=1.0@1:replica=2"     # target one replica
    POLYKEY_FAULTS="worker-exit=0@1:tier=prefill"   # target one tier

    entry   := name [ "=" value ] [ "@" count ] qualifier*
    qualifier := ":replica=" index | ":tier=" tier
    value   := float    seconds for sleep points; ignored by raise points
                        (default 1.0)
    count   := int      how many times the point fires before going
                        inert (default: unlimited)
    index   := int      fire only for the engine replica with this index
                        (a single engine is replica 0).
                        Without the suffix the fault fires on every
                        replica — chaos tests that kill ONE replica
                        while the others serve need the targeting.
    tier    := prefill | decode
                        fire only inside a disaggregated worker of that
                        tier (untiered engines pass None). A tier-targeted fault is
                        NEVER consumed by an untiered caller, so a
                        single-process engine can't accidentally eat a
                        fault aimed at one worker tier. Qualifiers
                        compose: ":replica=1:tier=decode" targets the
                        second decode-tier worker.

Points (consumed by engine/engine.py unless noted):

- ``step-stall``   — sleep `value` s inside the decode dispatch (a wedged
                     device call; trips the watchdog when it exceeds
                     `watchdog_timeout_s`). After the sleep the engine
                     checks `dead` and its stop flag before it touches
                     the device: a dead engine's thread launches and
                     allocates nothing (a fresh engine may be capturing
                     its CUDA graphs in the same process by then).
- ``slow-step``    — same site, meant small and recurring (degraded
                     device / contended tunnel).
- ``alloc-fail``   — raise AllocationError at page allocation
                     (pool exhaustion → admission backpressure).
- ``prefill-error``— raise RuntimeError inside the prefill dispatch
                     (device-side compile/execute failure).
- ``tokenizer-error`` — raise RuntimeError at prompt tokenization
                     (malformed-input handling at admission).
The three worker points below parse here; their sites come with the
replica and disaggregated pools (ROADMAP.md A.10):

- ``kv-handoff-drop`` — the disaggregated worker: corrupt the serialized KV
                     handoff payload at ship time (truncate to half),
                     exercising the coordinator's partial-write →
                     clean-re-route path.
- ``handoff-delay``— the disaggregated worker: sleep `value` s before shipping a
                     KV handoff payload (a slow/congested transfer link;
                     widens the mid-handoff kill window).
- ``worker-exit``  — the disaggregated worker: the process dies
                     (os._exit). The VALUE selects the death site, so a
                     drill can target one handoff phase exactly:
                     ``0`` → op intake (queued/mid-prefill death),
                     ``1`` → payload fetch (mid-handoff death),
                     ``>= 2`` → after forwarding `value` tokens of a
                     decode stream (mid-decode death).

The injector is intentionally module-shared: a supervised restart builds
a *fresh* engine, and a one-shot fault (``@1``) must stay spent across
that restart or the chaos tests could never observe recovery.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

POINTS = frozenset(
    {"step-stall", "slow-step", "alloc-fail", "prefill-error",
     "tokenizer-error", "kv-handoff-drop", "handoff-delay", "worker-exit"}
)

# Valid ":tier=" targets (the disaggregated worker tiers).
TIERS = ("prefill", "decode")

ENV_VAR = "POLYKEY_FAULTS"


@dataclass
class _Fault:
    value: float = 1.0
    remaining: Optional[int] = None  # None → unlimited
    fired: int = 0
    replica: Optional[int] = None    # None → fires on every replica
    tier: Optional[str] = None       # None → fires on every tier


class FaultInjector:
    """Parsed POLYKEY_FAULTS spec with thread-safe fire accounting
    (points are consumed from the engine thread AND gRPC handler
    threads)."""

    def __init__(self, spec: str):
        self._lock = threading.Lock()
        # One point can carry SEVERAL entries (e.g. the same fault
        # targeted at two different replicas) — keyed by name alone they
        # would silently overwrite and a two-replica chaos spec would
        # only ever kill one.
        self._faults: dict[str, list[_Fault]] = {}
        for raw in spec.replace(";", ",").split(","):
            entry = raw.strip()
            if not entry:
                continue
            replica: Optional[int] = None
            tier: Optional[str] = None
            while ":" in entry:
                # Trailing qualifiers, rightmost first: ":replica=N"
                # targets one pool replica, ":tier=prefill|decode" one
                # disaggregated worker tier; they compose in any order.
                entry, target = entry.rsplit(":", 1)
                key, _, value_s = target.partition("=")
                key = key.strip()
                if key == "replica":
                    replica = int(value_s)
                elif key == "tier":
                    tier = value_s.strip()
                    if tier not in TIERS:
                        raise ValueError(
                            f"unknown fault tier {tier!r}; valid tiers: "
                            f"{', '.join(TIERS)}"
                        )
                else:
                    raise ValueError(
                        f"unknown fault qualifier {target!r}; only "
                        "':replica=N' and ':tier=prefill|decode' are "
                        "supported"
                    )
            count: Optional[int] = None
            if "@" in entry:
                entry, count_s = entry.rsplit("@", 1)
                count = int(count_s)
            value = 1.0
            if "=" in entry:
                entry, value_s = entry.split("=", 1)
                value = float(value_s)
            name = entry.strip()
            if name not in POINTS:
                raise ValueError(
                    f"unknown fault point {name!r}; valid points: "
                    f"{', '.join(sorted(POINTS))}"
                )
            self._faults.setdefault(name, []).append(_Fault(
                value=value, remaining=count, replica=replica, tier=tier
            ))

    def _take(self, point: str, replica: Optional[int] = None,
              tier: Optional[str] = None) -> Optional[float]:
        """Consume one firing of `point` — the first armed entry whose
        replica AND tier targets match; returns its value, or None when
        the point is unarmed, exhausted, or targeted elsewhere (`replica`
        / `tier` are the caller's identity; callers that pass None only
        consume faults untargeted on that axis)."""
        with self._lock:
            for fault in self._faults.get(point, ()):
                if fault.remaining == 0:
                    continue
                if fault.replica is not None and replica != fault.replica:
                    continue
                if fault.tier is not None and tier != fault.tier:
                    continue
                if fault.remaining is not None:
                    fault.remaining -= 1
                fault.fired += 1
                return fault.value
            return None

    def take_if(self, point: str, pred, replica: Optional[int] = None,
                tier: Optional[str] = None) -> Optional[float]:
        """Like `_take`, but only consumes an armed entry whose VALUE
        satisfies `pred` — the worker-exit site selector (a fetch-site
        kill must not be eaten by the intake site it passes first)."""
        with self._lock:
            for fault in self._faults.get(point, ()):
                if fault.remaining == 0:
                    continue
                if fault.replica is not None and replica != fault.replica:
                    continue
                if fault.tier is not None and tier != fault.tier:
                    continue
                if not pred(fault.value):
                    continue
                if fault.remaining is not None:
                    fault.remaining -= 1
                fault.fired += 1
                return fault.value
            return None

    def maybe_sleep(self, point: str, replica: Optional[int] = None,
                    tier: Optional[str] = None) -> None:
        """Sleep the point's value (seconds) if it fires. Sleeping stands
        in for a wedged/slow device call, so it deliberately blocks the
        calling thread exactly where the real stall would."""
        value = self._take(point, replica, tier)
        if value is not None and value > 0:
            time.sleep(value)

    def maybe_raise(self, point: str, exc_type: type = RuntimeError,
                    replica: Optional[int] = None,
                    tier: Optional[str] = None) -> None:
        if self._take(point, replica, tier) is not None:
            raise exc_type(f"injected fault: {point}")

    def fired(self, point: str) -> int:
        with self._lock:
            return sum(f.fired for f in self._faults.get(point, ()))


_injector: Optional[FaultInjector] = None
_initialized = False
_guard = threading.Lock()


def get_injector() -> Optional[FaultInjector]:
    """The shared injector, lazily built from POLYKEY_FAULTS on first
    call. Returns None (and caches the None) when the env var is unset —
    the zero-overhead guarantee call sites rely on."""
    global _injector, _initialized
    with _guard:
        if not _initialized:
            _initialized = True
            spec = os.environ.get(ENV_VAR, "")
            if spec:
                _injector = FaultInjector(spec)
        return _injector


def install(spec: str) -> FaultInjector:
    """Programmatic arm (tests): replaces the shared injector."""
    global _injector, _initialized
    with _guard:
        _injector = FaultInjector(spec)
        _initialized = True
        return _injector


def clear() -> None:
    """Disarm and forget: the next get_injector() re-reads the env."""
    global _injector, _initialized
    with _guard:
        _injector = None
        _initialized = False
