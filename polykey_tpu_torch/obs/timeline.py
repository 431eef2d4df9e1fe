"""Engine timeline: a typed, bounded flight-deck ring + Perfetto export
(the reference's polykey_tpu/obs/timeline.py, for a bare engine).

- `TimelineRecorder` — the always-on ring. Every event is a compact tuple
  ``(kind, t_monotonic, *fields)`` with a fixed per-kind schema
  (`EVENT_FIELDS`), appended from the engine thread (plus rare notes from
  the supervisor thread — deque appends are atomic). Memory is bounded by
  `capacity`, never by uptime; an engine constructed with
  ``timeline_capacity=0`` holds **no recorder at all** (``engine.timeline
  is None``) and every emission site is a single ``is None`` branch.
- `to_perfetto` — renders the ring as Chrome-trace/Perfetto JSON (load at
  https://ui.perfetto.dev): a *dispatch frontier* track (one slice per
  block, ending at the next dispatch), a *processed frontier* track (one
  slice per readback), a *host stall* track (slices only where the
  processed frontier actually blocked), an engine-events row (expiries,
  supervisor restarts) and one row per decode slot showing each
  request's residency with its trace id.

The events are host-side stamps of the engine loop: on the GPU a
"dispatch" is the host's enqueue of a graph replay, and its slice spans
the host's time to the next enqueue, not the kernels' time on the card
(the torch profiler shows those, obs/profiler.py).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Iterable, Optional

# Event schema: tuple layout is (kind, t, *fields) with `fields` named
# here, in order. Documented in COMPONENTS.md §13; the exporter and the
# structure tests both key off this table, so a new event kind is one
# entry + one emission site.
EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    # One decode block (or spec round) dispatched. `gap_ms` is the host
    # gap since the previous dispatch (the attribution window).
    "dispatch": ("seq", "block_kind", "lanes", "steps", "gap_ms"),
    # One in-flight block processed. `t` is the sync start, `end` the
    # post-emit wall time; `stall_ms` is None for dead blocks whose
    # readback was skipped; `busy_ms` is the device-busy attribution
    # charged to this block (gap − stall, clamped ≥ 0).
    "process": ("seq", "end", "stall_ms", "lookahead", "queued_after",
                "busy_ms"),
    # A request admitted into a slot (tokenized, pages allocated).
    "admit": ("slot", "trace_id", "prompt_tokens"),
    # One prefill dispatch touching a slot (bucket group member or a
    # long-prompt chunk); `final` marks the activating dispatch.
    "prefill": ("slot", "tokens", "final"),
    # First token resolved — the slot's decode phase began.
    "slot_start": ("slot", "trace_id"),
    # Slot retired (done / error / cancelled), with tokens generated.
    "slot_end": ("slot", "reason", "tokens"),
    # Deadline expiry outside a slot (queued) — slot-holding expiries
    # surface as slot_end with a deadline reason.
    "expire": ("phase", "trace_id"),
    # Generic instant marker: supervisor restarts, pool re-routes,
    # profiler captures. `attrs` is a small dict.
    "note": ("note_kind", "attrs"),
}


class TimelineRecorder:
    """Bounded ring of typed engine events (monotonic-stamped).

    Appends are lock-free (CPython deque appends are atomic) and cost a
    tuple allocation + a clock read — cheap enough to stay always-on at
    per-block granularity. Readers snapshot with ``events()``/``raw()``.
    """

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(
                "TimelineRecorder needs capacity >= 1; a disabled "
                "timeline is `None`, not an empty recorder (the engine "
                "must not allocate a ring it will never fill)"
            )
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)

    # -- emission (engine thread; notes may come from other threads) ---------

    def _append(self, entry: tuple) -> None:
        self._ring.append(entry)

    def dispatch(self, seq: int, block_kind: str, lanes: int, steps: int,
                 gap_ms: float) -> None:
        self._append(
            ("dispatch", time.monotonic(), seq, block_kind, lanes, steps,
             gap_ms)
        )

    def process(self, seq: int, start: float, end: float,
                stall_ms: Optional[float], lookahead: int,
                queued_after: int, busy_ms: float) -> None:
        self._append(
            ("process", start, seq, end, stall_ms, lookahead, queued_after,
             busy_ms)
        )

    def admit(self, slot: int, trace_id: Optional[str],
              prompt_tokens: int) -> None:
        self._append(
            ("admit", time.monotonic(), slot, trace_id, prompt_tokens)
        )

    def prefill(self, slot: int, tokens: int, final: bool) -> None:
        self._append(
            ("prefill", time.monotonic(), slot, tokens, final)
        )

    def slot_start(self, slot: int, trace_id: Optional[str]) -> None:
        self._append(("slot_start", time.monotonic(), slot, trace_id))

    def slot_end(self, slot: int, reason: str, tokens: int) -> None:
        self._append(("slot_end", time.monotonic(), slot, reason, tokens))

    def expire(self, phase: str, trace_id: Optional[str]) -> None:
        self._append(("expire", time.monotonic(), phase, trace_id))

    def note(self, note_kind: str, **attrs) -> None:
        self._append(("note", time.monotonic(), note_kind, attrs))

    # -- read side -----------------------------------------------------------

    def raw(self) -> list[tuple]:
        return list(self._ring)

    def events(self) -> list[dict]:
        """Schema-expanded view: one dict per event with ``kind``, ``t``
        and the kind's named fields (EVENT_FIELDS)."""
        out = []
        for entry in list(self._ring):
            kind, t = entry[0], entry[1]
            fields = EVENT_FIELDS.get(kind, ())
            event = {"kind": kind, "t": t}
            event.update(zip(fields, entry[2:]))
            out.append(event)
        return out


def engine_timelines(engine) -> list[tuple[int, str, list[dict]]]:
    """Exporter input for one engine: ``[(0, "engine", events)]``. An
    engine with the timeline disabled contributes an empty event list (the
    export stays valid, just blank)."""
    timeline = getattr(engine, "timeline", None)
    return [(0, "engine",
             timeline.events() if timeline is not None else [])]


# Track (Perfetto tid) layout within one engine's process. Slot rows
# start at _TID_SLOT0 so slot counts up to ~hundreds never collide.
_TID_DISPATCH = 1
_TID_PROCESS = 2
_TID_STALL = 3
_TID_ENGINE = 4
_TID_SLOT0 = 10


def _thread_meta(pid: int, tid: int, name: str) -> dict:
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}


def _slice(pid: int, tid: int, name: str, ts_us: int, dur_us: int,
           args: Optional[dict] = None) -> dict:
    event = {"ph": "X", "pid": pid, "tid": tid, "name": name,
             "ts": ts_us, "dur": max(1, dur_us), "cat": "polykey"}
    if args:
        event["args"] = args
    return event


def _instant(pid: int, tid: int, name: str, ts_us: int,
             args: Optional[dict] = None) -> dict:
    event = {"ph": "i", "s": "t", "pid": pid, "tid": tid, "name": name,
             "ts": ts_us, "cat": "polykey"}
    if args:
        event["args"] = args
    return event


def to_perfetto(
    named_timelines: Iterable[tuple[int, str, list[dict]]],
    meta: Optional[dict] = None,
) -> dict:
    """Render recorder events as a Chrome-trace JSON object.

    Tracks per engine process: dispatch frontier (block slices tiling
    the row — each ends where the next dispatch begins, so a row with no
    gaps IS steady-state dispatch), processed frontier (sync start →
    post-emit), host stalls (only blocking readbacks), one row per
    decode slot (request residency, admit → retire, named by trace id),
    and an engine-events row for expiries/notes (restarts, re-routes,
    profiler captures). Timestamps are µs relative to the earliest
    event across all replicas, so a pool export lines replicas up on
    one clock (they share the process's monotonic clock).
    """
    named = [(pid, label, events) for pid, label, events in named_timelines]
    t0 = min(
        (event["t"] for _, _, events in named for event in events),
        default=0.0,
    )

    def us(t: float) -> int:
        return int(round((t - t0) * 1e6))

    trace_events: list[dict] = []
    for pid, label, events in named:
        if not events:
            continue        # disabled/empty timeline: no tracks to draw
        trace_events.append({
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": f"polykey {label}"},
        })
        trace_events.append(_thread_meta(pid, _TID_DISPATCH,
                                         "dispatch frontier"))
        trace_events.append(_thread_meta(pid, _TID_PROCESS,
                                         "processed frontier"))
        trace_events.append(_thread_meta(pid, _TID_STALL, "host stalls"))
        trace_events.append(_thread_meta(pid, _TID_ENGINE, "engine events"))

        dispatches = [e for e in events if e["kind"] == "dispatch"]
        processes = {e["seq"]: e for e in events if e["kind"] == "process"}
        max_t = max((e.get("end", e["t"]) for e in events), default=0.0)

        # Dispatch frontier: block N's slice runs to block N+1's
        # dispatch (device work serializes through the donation chain,
        # so consecutive dispatches tile the device's schedule); the
        # final block falls back to its own readback end, then max_t.
        for i, event in enumerate(dispatches):
            if i + 1 < len(dispatches):
                end_t = dispatches[i + 1]["t"]
            else:
                proc = processes.get(event["seq"])
                end_t = proc["end"] if proc is not None else max_t
            trace_events.append(_slice(
                pid, _TID_DISPATCH, f"block {event['seq']}",
                us(event["t"]), us(max(end_t, event["t"])) - us(event["t"]),
                args={"seq": event["seq"], "kind": event["block_kind"],
                      "lanes": event["lanes"], "steps": event["steps"],
                      "gap_ms": round(event["gap_ms"], 3)},
            ))

        slot_tids = set()
        open_slots: dict[int, dict] = {}
        for event in events:
            kind = event["kind"]
            if kind == "process":
                stall = event["stall_ms"]
                trace_events.append(_slice(
                    pid, _TID_PROCESS, f"block {event['seq']}",
                    us(event["t"]), us(event["end"]) - us(event["t"]),
                    args={"seq": event["seq"],
                          "lookahead": event["lookahead"],
                          "queued_after": event["queued_after"],
                          "stall_ms": (round(stall, 3)
                                       if stall is not None else None),
                          "busy_ms": round(event["busy_ms"], 3)},
                ))
                if stall is not None and stall > 0.05:
                    trace_events.append(_slice(
                        pid, _TID_STALL, f"stall block {event['seq']}",
                        us(event["t"]), int(stall * 1e3),
                        args={"seq": event["seq"],
                              "stall_ms": round(stall, 3)},
                    ))
            elif kind == "admit":
                open_slots[event["slot"]] = event
            elif kind == "prefill":
                tid = _TID_SLOT0 + event["slot"]
                slot_tids.add(event["slot"])
                trace_events.append(_instant(
                    pid, tid,
                    "prefill final" if event["final"] else "prefill chunk",
                    us(event["t"]), args={"tokens": event["tokens"]},
                ))
            elif kind == "slot_start":
                tid = _TID_SLOT0 + event["slot"]
                slot_tids.add(event["slot"])
                trace_events.append(_instant(
                    pid, tid, "first token", us(event["t"]),
                ))
            elif kind == "slot_end":
                slot = event["slot"]
                admit = open_slots.pop(slot, None)
                start_t = admit["t"] if admit is not None else event["t"]
                trace_id = (admit or {}).get("trace_id")
                slot_tids.add(slot)
                trace_events.append(_slice(
                    pid, _TID_SLOT0 + slot,
                    trace_id or f"request@slot{slot}",
                    us(start_t), us(event["t"]) - us(start_t),
                    args={"slot": slot, "reason": event["reason"],
                          "tokens": event["tokens"],
                          "prompt_tokens": (admit or {}).get("prompt_tokens"),
                          "trace_id": trace_id},
                ))
            elif kind == "expire":
                trace_events.append(_instant(
                    pid, _TID_ENGINE, f"deadline expired ({event['phase']})",
                    us(event["t"]), args={"trace_id": event["trace_id"]},
                ))
            elif kind == "note":
                trace_events.append(_instant(
                    pid, _TID_ENGINE, event["note_kind"], us(event["t"]),
                    args=dict(event["attrs"]),
                ))
        # Requests still resident when the ring was exported: open tail
        # slices to the export horizon, marked open (frontier state is
        # data, not an error).
        for slot, admit in open_slots.items():
            slot_tids.add(slot)
            trace_events.append(_slice(
                pid, _TID_SLOT0 + slot,
                (admit.get("trace_id") or f"request@slot{slot}") + " (open)",
                us(admit["t"]), us(max_t) - us(admit["t"]),
                args={"slot": slot, "open": True,
                      "trace_id": admit.get("trace_id")},
            ))
        for slot in sorted(slot_tids):
            trace_events.append(_thread_meta(
                pid, _TID_SLOT0 + slot, f"slot {slot}"
            ))

    out = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = meta
    return out
