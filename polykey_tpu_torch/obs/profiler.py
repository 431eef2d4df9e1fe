"""On-demand torch.profiler capture with a single-flight guarantee (the
reference's polykey_tpu/obs/profiler.py, on torch.profiler).

Profiling has to be one call away on a live server, not a redeploy. This
wraps a `torch.profiler.profile` start/stop behind a lock so the two
triggers (the ``engine_profile`` gRPC tool and the ``/debug/profile``
HTTP endpoint) can never start two overlapping captures: torch's
profiler, like jax's, is process-global, and a second start either
raises or corrupts the first capture's artifact.

A capture records CPU activity, and CUDA activity (CUPTI) when a card is
present; its artifact is one Chrome-trace JSON file (``trace.json``,
loads in Perfetto or chrome://tracing) in the capture's log directory.
On the CPU the same path runs with CPU activity alone. Every start/stop
lands in the flight recorder, so a postmortem reader can see that a
capture was running when a stall happened.

The profiler's backend (Kineto) registers itself on the thread that
imported torch and initializes on the first thread that profiles; when
those differ it reports "External init callback must run in same thread
as registerClient" and records no CUDA activity. A capture is started
from an HTTP or gRPC handler thread, so `ProfilerCapture` runs one empty
capture on the thread that builds it (the server's main thread) first,
once per process. CUDA activity (CUPTI) is the whole process's,
including the kernels inside CUDA graph replays.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Optional

import torch

# Bounds for the HTTP trigger's blocking capture: long enough for a few
# decode blocks, short enough that a stray request can't pin the profiler
# (and a handler thread) for minutes.
MIN_CAPTURE_S = 0.1
MAX_CAPTURE_S = 60.0

TRACE_FILE = "trace.json"

# Kineto initializes once per process (see the module docstring).
_kineto_lock = threading.Lock()
_kineto_ready = False


def _activities() -> list:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def _init_kineto() -> None:
    """One empty capture on this thread, once per process."""
    global _kineto_ready
    with _kineto_lock:
        if not _kineto_ready:
            with torch.profiler.profile(activities=_activities()):
                pass
            _kineto_ready = True


def default_dir() -> str:
    """POLYKEY_PROFILE_DIR, else ``polykey_profile`` under the temp dir."""
    return (os.environ.get("POLYKEY_PROFILE_DIR")
            or os.path.join(tempfile.gettempdir(), "polykey_profile"))


class ProfilerBusyError(ValueError):
    """A capture is already running (single-flight contract)."""


class ProfilerCapture:
    """Process-wide profiler guard shared by every trigger surface."""

    def __init__(self, base_dir: Optional[str] = None, recorder=None):
        self._base_dir = base_dir
        self.recorder = recorder
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._prof = None
        self._captures = 0
        _init_kineto()

    @property
    def base_dir(self) -> str:
        # Read per capture, not cached: an operator pointing
        # POLYKEY_PROFILE_DIR at a fresh disk mid-incident must win.
        return self._base_dir or default_dir()

    @property
    def active_dir(self) -> Optional[str]:
        return self._dir

    def status(self) -> dict:
        return {
            "profiling": self._dir is not None,
            "log_dir": self._dir or "",
            "captures": self._captures,
        }

    def start(self, log_dir: Optional[str] = None) -> str:
        """Begin a capture. Raises ProfilerBusyError when one is already
        running — the caller decides whether that is a 409 or a tool
        error; nobody ever gets a second concurrent trace."""
        activities = _activities()
        fallback = os.path.join(
            self.base_dir, time.strftime("%Y%m%d-%H%M%S", time.gmtime()),
        )
        with self._lock:
            if self._dir is not None:
                raise ProfilerBusyError(
                    f"profiler already tracing to {self._dir}"
                )
            target = log_dir or f"{fallback}-{self._captures}"
            os.makedirs(target, exist_ok=True)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            self._prof, self._dir = prof, target
            self._captures += 1
        if self.recorder is not None:
            self.recorder.event("profiler_start", log_dir=target)
        return target

    def stop(self) -> str:
        with self._lock:
            if self._dir is None:
                raise ValueError("profiler is not tracing")
            # Free the single-flight slot BEFORE stop/export can raise
            # (disk full while writing the artifact): a failed stop must
            # not wedge profiling until process restart.
            target, self._dir = self._dir, None
            prof, self._prof = self._prof, None
            prof.stop()
            prof.export_chrome_trace(os.path.join(target, TRACE_FILE))
        if self.recorder is not None:
            self.recorder.event(
                "profiler_stop", log_dir=target,
                files=_artifact_count(target),
            )
        return target

    def capture(self, seconds: float,
                log_dir: Optional[str] = None) -> dict:
        """Blocking start→sleep→stop round trip (the HTTP trigger).
        Returns the artifact summary; raises ProfilerBusyError when a
        capture is already in flight."""
        seconds = min(MAX_CAPTURE_S, max(MIN_CAPTURE_S, float(seconds)))
        target = self.start(log_dir)
        try:
            time.sleep(seconds)
        finally:
            # Even an interrupted sleep must release the single-flight
            # slot, or one bad request wedges profiling until restart.
            self.stop()
        return {
            "log_dir": target,
            "seconds": seconds,
            "files": _artifact_count(target),
            "trace": os.path.join(target, TRACE_FILE),
        }


def _artifact_count(log_dir: str) -> int:
    total = 0
    for _root, _dirs, files in os.walk(log_dir):
        total += len(files)
    return total
