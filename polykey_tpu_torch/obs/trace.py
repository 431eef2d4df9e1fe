"""Request tracing: monotonic-clock spans, trace-id propagation, and a
bounded flight recorder of recent span trees (the reference's
polykey_tpu/obs/trace.py).

The questions this answers — "where did THIS slow request spend its
time", "what was in flight when the watchdog tripped" — need more than
counters: per-request trees whose phases partition wall-clock time. The
design keeps the hot path nearly free:

- A `Span` is a plain object stamped with `time.monotonic()`; creating
  one costs an allocation and a clock read. The engine only creates
  spans for requests that arrived with a trace attached (gateway
  traffic), so bench/embedder paths pay nothing.
- Trace ids ride gRPC metadata (``x-trace-id``) so a caller's id is
  honored end to end and echoed back in trailing metadata; absent one,
  the interceptor mints 16 hex bytes from `os.urandom`.
- The `FlightRecorder` is a fixed-capacity deque of FINISHED trees plus
  a separate event ring (watchdog trips, engine deaths). Old entries
  fall off; memory is bounded by capacity × tree size, never by uptime.

Cross-thread contract: the gateway handler thread owns the root span;
the engine thread appends children to it. Child-list appends take the
root's lock (shared down the tree), which is uncontended in practice —
the two threads touch the tree at different phases of the request.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

_local = threading.local()


def new_trace_id() -> str:
    return os.urandom(8).hex()


def current_span() -> Optional["Span"]:
    """The thread's active root span (set by the gateway interceptor for
    the duration of the RPC it is handling). Reads are only meaningful at
    handler start — synchronously after the interceptor set it."""
    return getattr(_local, "span", None)


def set_current_span(span: Optional["Span"]) -> None:
    _local.span = span


class Span:
    """One timed phase. `start`/`end` are monotonic seconds; `finish` is
    idempotent. Children nest arbitrarily deep; the tree renders via
    `to_dict` with durations in ms."""

    __slots__ = (
        "name", "trace_id", "start", "end", "attrs", "children", "_lock",
    )

    def __init__(
        self,
        name: str,
        trace_id: Optional[str] = None,
        start: Optional[float] = None,
        _lock: Optional[threading.Lock] = None,
    ):
        self.name = name
        self.trace_id = trace_id or new_trace_id()
        self.start = time.monotonic() if start is None else start
        self.end: Optional[float] = None
        self.attrs: dict = {}
        self.children: list[Span] = []
        # One lock per TREE (children share the root's): appends from the
        # engine thread and the handler thread serialize on it.
        self._lock = _lock if _lock is not None else threading.Lock()

    def child(
        self,
        name: str,
        start: Optional[float] = None,
        end: Optional[float] = None,
        **attrs,
    ) -> "Span":
        """Open (or, when `end` is given, record a completed) child span.
        Explicit timestamps let the engine convert transition timestamps
        it already tracks (RequestTimings) into spans after the fact."""
        span = Span(name, trace_id=self.trace_id, start=start,
                    _lock=self._lock)
        with self._lock:
            if end is not None:
                span.end = end
            if attrs:
                span.attrs.update(attrs)
            self.children.append(span)
        return span

    def finish(self, end: Optional[float] = None) -> None:
        with self._lock:
            if self.end is None:
                self.end = time.monotonic() if end is None else end

    @property
    def duration_ms(self) -> float:
        end = self.end if self.end is not None else time.monotonic()
        return max(0.0, (end - self.start) * 1e3)

    def set(self, **attrs) -> None:
        with self._lock:
            self.attrs.update(attrs)

    def to_dict(self) -> dict:
        with self._lock:
            children = list(self.children)
            attrs = dict(self.attrs)
        out = {
            "name": self.name,
            "trace_id": self.trace_id,
            "duration_ms": round(self.duration_ms, 3),
        }
        if attrs:
            out["attrs"] = attrs
        if children:
            out["children"] = [c.to_dict() for c in children]
        return out

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class Tracer:
    """Root-span factory bound to a recorder: `finish_and_record` closes
    a root and files its tree in the flight recorder."""

    def __init__(self, recorder: Optional["FlightRecorder"] = None):
        self.recorder = recorder

    def start(self, name: str, trace_id: Optional[str] = None) -> Span:
        return Span(name, trace_id=trace_id)

    def finish_and_record(self, span: Span) -> None:
        span.finish()
        if self.recorder is not None:
            self.recorder.record(span)


class FlightRecorder:
    """Bounded ring of recent finished span trees + an event ring.

    Postmortem tool: when a request stalls or the watchdog trips, the
    recorder holds the last `capacity` request trees and the events
    around them without any external collector running."""

    def __init__(self, capacity: int = 64, event_capacity: int = 256):
        # Memory discipline: a 0-capacity ring is DISABLED —
        # no deque allocated, every append a no-op — so an obs-less
        # deployment pays neither the rings nor the to_dict renders
        # record() would otherwise do per request.
        self._traces: Optional[deque] = (
            deque(maxlen=capacity) if capacity > 0 else None
        )
        self._events: Optional[deque] = (
            deque(maxlen=event_capacity) if event_capacity > 0 else None
        )
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        if self._traces is None:
            return
        # Store the rendered dict, not the live Span: entries are frozen
        # at record time and safe to hand out without locking the tree.
        with self._lock:
            self._traces.append(span.to_dict())

    def event(self, kind: str, **attrs) -> None:
        if self._events is None:
            return
        entry = {"kind": kind, "monotonic": time.monotonic(),
                 "time": time.time(), **attrs}
        with self._lock:
            self._events.append(entry)

    def last(
        self, pred: Optional[Callable[[dict], bool]] = None
    ) -> Optional[dict]:
        for trace in reversed(self.traces()):
            if pred is None or pred(trace):
                return trace
        return None

    def traces(self) -> list[dict]:
        with self._lock:
            return list(self._traces) if self._traces is not None else []

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events) if self._events is not None else []
