"""Engine supervision: in-process restart instead of process recycling (the
reference's polykey_tpu/engine/supervisor.py, with the GPU's rules on
device memory).

    watchdog trip / loop crash  →  engine.dead set
    supervisor notices          →  stop + drain the dead engine
                                   (in-flight requests failed cleanly)
                                →  free its device state (thread exited)
                                →  build a fresh engine via the factory
                                →  re-arm the watchdog on it
                                →  health back to SERVING
                                →  flight-recorder "engine_restart" event
                                   + polykey_engine_restarts_total

On the GPU the dead engine's KV pools, graph pool and pinned buffers stay
allocated as long as anything holds them, and a 27B model's card has no
room for a second set. So once the old engine thread has exited, its
device state is released (`InferenceEngine.release_device_state`) BEFORE
the factory builds the fresh engine, explicitly: the cycle collector is
held off while the fresh engine captures its graphs. When the old thread
is wedged past `join_timeout_s`, nothing it could still touch is freed:
the engine is kept as an orphan, and its device state is released once
its thread has exited (it touches the device no more after waking, see
engine/engine.py). The factory serves the same weights (the engine's
`reuse` path: no second copy on the card, no second checkpoint read).
Over a mesh the factory starts the mesh's next life on every rank
(engine/lockstep.restart); each follower rank frees or orphans its own
engine the same way and reaps its orphans itself
(lockstep.follow_lives), with no supervisor of its own.

Restarts are bounded: more than `max_restarts` inside `restart_window_s`
means the failure is not transient (a bad checkpoint, a broken device, a
sticky CUDA error that fails every factory call) — the supervisor gives
up, leaves health NOT_SERVING, and lets the platform recycle the process.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable


class EngineSupervisor:
    """Owns the live engine reference. `engine` is swapped on restart;
    listeners (the TorchService) are told so their own reference
    follows."""

    def __init__(
        self,
        engine,
        factory: Callable[[], object],
        watchdog=None,
        health=None,
        logger=None,
        recorder=None,
        restart_counter=None,
        max_restarts: int = 3,
        restart_window_s: float = 600.0,
        check_interval_s: float = 0.5,
        join_timeout_s: float = 5.0,
    ):
        self.engine = engine
        self._factory = factory
        self.watchdog = watchdog
        self.health = health
        self.logger = logger
        self.recorder = recorder
        self.restart_counter = restart_counter
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.check_interval_s = check_interval_s
        self.join_timeout_s = join_timeout_s
        self.restarts = 0
        self.gave_up = False
        # Replaced engines whose thread was still wedged at the restart:
        # their device state is released once the thread has exited.
        self.orphans: list = []
        self._restart_times: deque[float] = deque()
        self._listeners: list[Callable[[object], None]] = []
        self._giveup_listeners: list[Callable[[str], None]] = []
        self._trip_listeners: list[Callable[[object, str], None]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="polykey-supervisor", daemon=True
        )

    def add_restart_listener(self, callback: Callable[[object], None]) -> None:
        """Called with the fresh engine after every successful restart
        (from the supervisor thread)."""
        self._listeners.append(callback)

    def add_giveup_listener(self, callback: Callable[[str], None]) -> None:
        """Called with the failure reason when the restart budget is spent
        and this supervisor stops trying (from the supervisor thread): the
        replica pool marks that replica DEAD and keeps serving on the
        others."""
        self._giveup_listeners.append(callback)

    def add_trip_listener(self, callback: Callable[[object, str], None]) -> None:
        """Called with (dead engine, reason) as soon as the supervisor sees
        a dead engine, before it restarts or gives up (the autopilot
        pauses here)."""
        self._trip_listeners.append(callback)

    def start(self) -> "EngineSupervisor":
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 5.0) -> None:
        """Signal and (bounded) join: close() must not race a completing
        restart into swapping/reviving an engine on a terminating server.
        If the thread is mid-factory past the timeout, the in-restart
        `_stop` check shuts the fresh engine down itself."""
        self._stop.set()
        if self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout=join_timeout_s)

    # -- supervisor thread ---------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            self._reap()
            engine = self.engine
            if engine.dead is None:
                continue
            for callback in self._trip_listeners:
                try:
                    callback(engine, engine.dead or "engine dead")
                except Exception as e:  # a listener must not stop supervision
                    if self.logger is not None:
                        self.logger.error("supervisor trip listener failed",
                                          error=str(e))
            if not self._budget_ok():
                self._give_up(engine.dead)
                return
            self._restart(engine)

    def _reap(self) -> None:
        """Release the device state of orphans whose thread has exited."""
        for old in [o for o in self.orphans if not o._thread.is_alive()]:
            old.release_device_state()
            self.orphans.remove(old)
            if self.recorder is not None:
                self.recorder.event("engine_released", wedged=True)

    def _budget_ok(self) -> bool:
        now = time.monotonic()
        while self._restart_times and \
                now - self._restart_times[0] > self.restart_window_s:
            self._restart_times.popleft()
        return len(self._restart_times) < self.max_restarts

    def _give_up(self, reason: str) -> None:
        self.gave_up = True
        if self.logger is not None:
            self.logger.error(
                "supervisor giving up: restart budget exhausted",
                error=reason, restarts=self.restarts,
                window_s=self.restart_window_s,
            )
        if self.recorder is not None:
            self.recorder.event(
                "engine_restart_abandoned", reason=reason,
                restarts=self.restarts,
            )
        # Health stays NOT_SERVING (the watchdog/crash path already
        # flipped it); the platform's restart policy takes over.
        for callback in self._giveup_listeners:
            callback(reason)

    def _restart(self, old) -> None:
        reason = old.dead or "engine dead"
        if self.logger is not None:
            self.logger.warn(
                "supervisor restarting engine", error=reason,
                attempt=self.restarts + 1,
            )
        # Drain the corpse: reject racing submits, then give the engine
        # thread a grace window to unwind (a stall that clears lets the
        # thread see `dead`, fail its own in-flight work, and exit).
        old._stop.set()
        old._wake.set()
        old._thread.join(timeout=self.join_timeout_s)
        wedged = old._thread.is_alive()
        if wedged:
            # Wedged in a device call: fail its in-flight work from here
            # (host state only — `dead` is set, so `_finish` retires no
            # lane), and free nothing its thread could still touch.
            old._fail_all(f"engine restarting: {reason}")
            if old not in self.orphans:     # a retry after a failed factory
                self.orphans.append(old)
        else:
            # Its pools and graphs go back before the fresh engine
            # allocates: a second set may not fit on the card.
            old.release_device_state()
        self._restart_times.append(time.monotonic())
        try:
            fresh = self._factory()
        except Exception as e:
            if self.logger is not None:
                self.logger.error(
                    "engine restart failed; will retry", error=str(e),
                )
            if self.recorder is not None:
                self.recorder.event(
                    "engine_restart_failed", reason=reason, error=str(e),
                )
            return  # budget was charged; next tick retries if any remains
        if self._stop.is_set():
            # Shutdown raced the restart: a terminating server must not
            # resurrect — re-advertising SERVING with a live engine thread.
            fresh.shutdown()
            return
        if not wedged:
            # Metric continuity: counters must not reset on a supervised
            # restart. Skipped when the old thread is still wedged: if its
            # device call ever returns it would count its own failures
            # into the live engine's counters.
            fresh.metrics = old.metrics
        # The signal plane rides the adopted metrics, so its windows and
        # budget state survive; its timeline is the dead engine's ring, so
        # breach notes go to the fresh one from now on.
        signals = getattr(fresh.metrics, "signals", None)
        if signals is not None:
            signals.timeline = getattr(fresh, "timeline", None)
            if signals.recorder is None:
                signals.recorder = self.recorder
        self.restarts += 1
        self.engine = fresh
        for callback in self._listeners:
            callback(fresh)
        if self.watchdog is not None:
            self.watchdog.rearm(fresh)   # also resumes health SERVING
        elif self.health is not None:
            self.health.resume_serving()
        if self.restart_counter is not None:
            self.restart_counter.inc()
        if self.recorder is not None:
            self.recorder.event(
                "engine_restart", reason=reason, restarts=self.restarts,
                wedged=wedged,
            )
        # The fresh engine's timeline opens with the restart marker, so an
        # export of the post-restart schedule shows why it starts there.
        timeline = getattr(fresh, "timeline", None)
        if timeline is not None:
            timeline.note("engine_restart", reason=reason,
                          restarts=self.restarts,
                          kv_reloaded=getattr(fresh, "_kv_reloaded_pages", 0))
        if self.logger is not None:
            self.logger.info("engine restarted", restarts=self.restarts)
