"""Crash-durable black boxes and the postmortem CLI (the reference's
polykey_tpu/obs/postmortem.py).

The chaos soaks kill workers with ``os._exit(1)`` — by design nothing
flushes, so before this module a SIGKILL'd worker took its timeline and
flight-recorder rings to the grave and the run's most interesting
seconds were unrecoverable. A `BlackBox` is the flight-deck counterpart
of the host-KV tier's restart-durable index: each member
checkpoints its rings to its per-member state dir with the same
atomic tmp→``os.replace`` idiom, amortized every K timeline appends and
forced on the supervisor's trip path and at control-plane op intake —
the moments that matter are exactly the ones right before a death, and
op intake happens-after the fatal request's trace id was recorded.

``python -m polykey_tpu_torch.obs.postmortem <state-dir>`` reads every
surviving box, maps worker rings onto the coordinator clock using the
offsets the coordinator's own box carries
(`obs.clocks.ClockSync`, re-estimated each heartbeat), and emits

- a human triage report: who went silent first, each member's final
  events, and the trace ids still in flight when the ring froze;
- ONE merged Perfetto file in which the death is an ordinary — if
  truncated — set of process rows, handoff arcs included.

File format (JSON, one object per member, ``blackbox-<role>.json``):
``version``/``role``/``pid``/``wrote_mono``/``wrote_unix``/``meta``/
``timeline`` (schema-expanded events)/``traces``/``events`` (flight
recorder rings). The coordinator's ``meta.clock_offsets`` maps role →
`ClockSync.snapshot()`. When a member is reincarnated (process respawn
or in-process engine restart), the dead incarnation's final box is
rotated to ``blackbox-<role>.prev.json`` so the replacement's boot
baseline can't clobber the death evidence; the reader loads both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Optional

from .timeline import TimelineRecorder, merge_timelines, to_perfetto
from .trace import FlightRecorder

BLACKBOX_VERSION = 1
BLACKBOX_PREFIX = "blackbox-"
COORDINATOR_ROLE = "coordinator"


def blackbox_path(state_dir: str, role: str) -> str:
    return os.path.join(state_dir, f"{BLACKBOX_PREFIX}{role}.json")


class BlackBox:
    """Amortized, atomic checkpoint of one member's observability rings.

    ``tick()`` is the cheap call sprinkled on hot-ish paths: it compares
    the timeline's lifetime append counter against the last flushed mark
    and only serializes every ``every`` appends (or when forced). A
    flush is tmp-write + ``os.replace``, so readers never observe a torn
    box and a crash mid-flush leaves the previous complete checkpoint.
    """

    def __init__(
        self,
        state_dir: str,
        role: str,
        timeline: Optional[TimelineRecorder] = None,
        recorder: Optional[FlightRecorder] = None,
        every: int = 64,
        meta: Optional[dict] = None,
    ):
        self.path = blackbox_path(state_dir, role)
        self.role = role
        self.every = max(1, int(every))
        self.meta: dict = dict(meta or {})
        self._timeline = timeline
        self._recorder = recorder
        # Appended count at last flush; None forces the first tick to
        # write a baseline box (a member that dies before its first
        # amortized window must still leave evidence it booted).
        self._mark: Optional[int] = None
        self.flushes = 0
        # Serializes concurrent flushes: a forced shutdown flush racing
        # an amortized heartbeat tick would both write the SAME tmp
        # path, and whichever os.replace loses finds it already gone.
        self._flush_lock = threading.Lock()
        os.makedirs(state_dir, exist_ok=True)
        self._rotate()

    def _rotate(self) -> None:
        """Preserve the PREVIOUS incarnation's final checkpoint as
        ``blackbox-<role>.prev.json``. A respawned worker (same role,
        same path) would otherwise clobber the death evidence with its
        boot baseline — exactly the box the postmortem needs. One level
        deep: only the most recent death per role is kept."""
        if os.path.exists(self.path):
            try:
                os.replace(self.path,
                           self.path[:-len(".json")] + ".prev.json")
            except OSError:
                pass     # unreadable squatter; flush() will overwrite it

    def rebind(self, timeline: Optional[TimelineRecorder] = None,
               recorder: Optional[FlightRecorder] = None) -> None:
        """Point at a fresh engine's rings after a supervisor restart
        (the replacement engine allocates new recorders). The tripped
        engine's final flush is rotated aside first — same clobber
        hazard as a process respawn, in-process."""
        self._rotate()
        self._timeline = timeline
        self._recorder = recorder
        with self._flush_lock:
            self._mark = None

    def tick(self, force: bool = False) -> bool:
        appended = (self._timeline.appended
                    if self._timeline is not None else 0)
        with self._flush_lock:
            if (not force and self._mark is not None
                    and 0 <= appended - self._mark < self.every):
                return False
            self._mark = appended
        self.flush()
        return True

    def flush(self) -> str:
        payload = {
            "version": BLACKBOX_VERSION,
            "role": self.role,
            "pid": os.getpid(),
            "wrote_mono": time.monotonic(),
            "wrote_unix": time.time(),
            "meta": dict(self.meta),
            "timeline": (self._timeline.events()
                         if self._timeline is not None else []),
            "traces": (self._recorder.traces()
                       if self._recorder is not None else []),
            "events": (self._recorder.events()
                       if self._recorder is not None else []),
        }
        tmp = self.path + ".tmp"
        with self._flush_lock:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
            self.flushes += 1
        return self.path


# -- reader / reconstruction --------------------------------------------------


def load_blackboxes(state_dir: str) -> list[dict]:
    """Every parseable box under ``state_dir``, sorted coordinator-first
    then by role. Unparseable files (a crash can't tear one, but a
    foreign file can squat the prefix) are skipped, not fatal."""
    boxes = []
    try:
        names = sorted(os.listdir(state_dir))
    except FileNotFoundError:
        return []
    for name in names:
        if not (name.startswith(BLACKBOX_PREFIX)
                and name.endswith(".json")):
            continue
        path = os.path.join(state_dir, name)
        try:
            with open(path) as f:
                box = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(box, dict) or "timeline" not in box:
            continue
        box["_path"] = path
        boxes.append(box)
    boxes.sort(key=lambda b: (b.get("role") != COORDINATOR_ROLE,
                              str(b.get("role"))))
    return boxes


def _clock_offsets(boxes: list[dict]) -> dict[str, float]:
    for box in boxes:
        if box.get("role") == COORDINATOR_ROLE:
            offsets = box.get("meta", {}).get("clock_offsets", {})
            return {
                role: snap["offset_s"]
                for role, snap in offsets.items()
                if isinstance(snap, dict)
                and isinstance(snap.get("offset_s"), (int, float))
            }
    return {}


def merged_perfetto(boxes: list[dict]) -> dict:
    """ONE Perfetto trace from the surviving boxes: coordinator is pid 0
    on its own clock; each worker row rides the coordinator clock via
    the offset the coordinator's box recorded for it (identity when the
    offset didn't survive — unaligned beats absent)."""
    offsets = _clock_offsets(boxes)
    groups = []
    next_pid = 1
    for box in boxes:
        role = str(box.get("role", "?"))
        if role == COORDINATOR_ROLE:
            pid, offset = 0, 0.0
        else:
            pid, next_pid = next_pid, next_pid + 1
            offset = offsets.get(role, 0.0)
        groups.append((pid, role, box.get("timeline", []), offset))
    named = merge_timelines(groups)
    return to_perfetto(named, meta={
        "source": "postmortem",
        "clock_offsets": offsets,
        "boxes": [
            {"role": b.get("role"), "pid_os": b.get("pid"),
             "wrote_unix": b.get("wrote_unix")}
            for b in boxes
        ],
    })


def _inflight_traces(events: list[dict]) -> list[str]:
    """Trace ids admitted into a slot and never retired — the requests
    the process was holding when its ring froze."""
    open_slots: dict[int, Optional[str]] = {}
    for event in events:
        kind = event.get("kind")
        if kind == "admit":
            open_slots[event.get("slot")] = event.get("trace_id")
        elif kind == "slot_end":
            open_slots.pop(event.get("slot"), None)
    return sorted({t for t in open_slots.values() if t})


def _fmt_event(event: dict) -> str:
    kind = event.get("kind", "?")
    rest = {k: v for k, v in event.items() if k not in ("kind", "t")}
    if kind == "note":
        attrs = rest.pop("attrs", {}) or {}
        detail = " ".join(f"{k}={v}" for k, v in attrs.items())
        return f"t={event.get('t', 0):.6f} note {rest.get('note_kind')} " \
               f"{detail}".rstrip()
    detail = " ".join(f"{k}={v}" for k, v in rest.items())
    return f"t={event.get('t', 0):.6f} {kind} {detail}".rstrip()


def triage_report(boxes: list[dict], last: int = 12) -> str:
    """Human triage: members ordered by how long they'd been silent
    (stalest checkpoint first — amortized flushing means the process
    that stopped writing earliest is the likely first casualty)."""
    if not boxes:
        return "postmortem: no black boxes found\n"
    by_staleness = sorted(boxes, key=lambda b: b.get("wrote_unix", 0.0))
    newest = max(b.get("wrote_unix", 0.0) for b in boxes)
    lines = [f"postmortem: {len(boxes)} black box(es)"]
    first = by_staleness[0]
    if len(boxes) > 1:
        silent_s = newest - first.get("wrote_unix", 0.0)
        lines.append(
            f"likely first casualty: {first.get('role')} "
            f"(last checkpoint {silent_s:.3f}s before the newest box)"
        )
    for box in by_staleness:
        events = box.get("timeline", [])
        inflight = _inflight_traces(events)
        lines.append("")
        lines.append(
            f"-- {box.get('role')} (os pid {box.get('pid')}, "
            f"{len(events)} events, {len(box.get('traces', []))} span "
            f"trees) [{box.get('_path', '?')}]"
        )
        if inflight:
            lines.append(f"   in-flight traces: {', '.join(inflight)}")
        for event in events[-last:]:
            lines.append(f"   {_fmt_event(event)}")
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m polykey_tpu_torch.obs.postmortem",
        description="Reconstruct the last seconds before a death from "
                    "the black boxes in a disagg state dir.",
    )
    parser.add_argument("state_dir", help="per-run state dir holding "
                        f"{BLACKBOX_PREFIX}*.json checkpoints")
    parser.add_argument("--out", default=None,
                        help="merged Perfetto path (default "
                             "<state_dir>/postmortem.perfetto.json)")
    parser.add_argument("--last", type=int, default=12,
                        help="final events to print per member")
    args = parser.parse_args(argv)

    boxes = load_blackboxes(args.state_dir)
    sys.stdout.write(triage_report(boxes, last=args.last))
    if not boxes:
        return 2
    out = args.out or os.path.join(args.state_dir,
                                   "postmortem.perfetto.json")
    with open(out, "w") as f:
        json.dump(merged_perfetto(boxes), f)
    sys.stdout.write(f"merged perfetto: {out}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
