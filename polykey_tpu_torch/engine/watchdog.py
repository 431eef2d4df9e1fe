"""Engine watchdog: a hung device step must fail fast and visibly (the
reference's polykey_tpu/engine/watchdog.py).

Container healthchecks see a process, not its step loop; a GPU engine adds
a failure mode the platform can't see — the process is alive but the step
loop is wedged (a device hang, a deadlocked copy). The watchdog notices missing progress while work
is pending, flips gRPC health to NOT_SERVING (so orchestration stops routing
and restarts per policy), and fails in-flight requests cleanly rather than
letting clients hit their deadlines.

The watchdog is RE-ARMABLE: a trip latches `tripped` and goes
quiet, but the thread keeps running, so the supervisor
(engine/supervisor.py) can hand it the restarted engine via `rearm()` —
trip state resets, health resumes SERVING, and the fresh engine is
watched from its first step. Without a supervisor the old one-shot
behavior is unchanged: tripped stays latched and the platform restarts
the NOT_SERVING process.
"""

from __future__ import annotations

import threading
import time


class Watchdog:
    def __init__(self, engine, health=None, logger=None,
                 check_interval_s: float = 5.0,
                 recorder=None, stall_counter=None):
        self.engine = engine
        self.health = health
        self.logger = logger
        self.check_interval_s = check_interval_s
        # Observability hooks (both optional): `recorder` is an
        # obs.trace.FlightRecorder that gets a "watchdog_stall" event with
        # the engine state frozen at trip time — the postmortem record the
        # restarted process would otherwise take to its grave;
        # `stall_counter` is the Prometheus watchdog_stalls_total counter.
        self.recorder = recorder
        self.stall_counter = stall_counter
        self.tripped = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="polykey-watchdog", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def rearm(self, engine=None) -> None:
        """Point the watchdog at a (restarted) engine and resume
        watching. Resumes health to SERVING — the supervisor calls this
        as the last step of a successful restart, when the fresh engine
        is ready for traffic."""
        if engine is not None:
            self.engine = engine
        self.tripped = False
        if self.health is not None:
            self.health.resume_serving()

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            # Read the reference once per tick: rearm() swaps it from the
            # supervisor thread.
            engine = self.engine
            if self.tripped or engine.dead is not None:
                continue          # quiet until rearm() hands over a live engine
            if not engine.busy:
                continue
            stalled_for = time.monotonic() - engine.last_progress
            if stalled_for < engine.config.watchdog_timeout_s:
                continue
            self.tripped = True
            message = (
                f"engine made no progress for {stalled_for:.0f}s with work "
                "pending (device hang?)"
            )
            if self.logger is not None:
                self.logger.error("watchdog tripped", error=message)
            if self.stall_counter is not None:
                self.stall_counter.inc()
            if self.recorder is not None:
                # Freeze what the engine looked like at trip time.
                # engine.stats() reads host mirrors and queue sizes only —
                # no device read, no event wait: safe while the device
                # call is wedged.
                try:
                    snap = engine.stats()
                    self.recorder.event(
                        "watchdog_stall",
                        message=message,
                        stalled_for_s=round(stalled_for, 1),
                        slots_busy=snap["slots_busy"],
                        queued=snap["queued"],
                        inflight_blocks=snap["inflight_blocks"],
                    )
                except Exception:
                    pass  # postmortem capture must never mask the trip
            # Only flag and flip health here; slot/allocator state belongs to
            # the engine thread. If that thread ever returns from the wedged
            # device call it sees `dead` and fails in-flight work itself; if
            # it never returns, the supervisor (when armed) fails them and
            # restarts, else clients hit request_timeout_s and the platform
            # restarts the NOT_SERVING process.
            engine.dead = message
            engine._wake.set()
            if self.health is not None:
                self.health.shutdown()
