"""Structured JSON logging in the style of Go's log/slog JSONHandler.

The reference emits one JSON object per line with keys ``time``, ``level``,
``msg`` plus free-form attributes (e.g. the reference's cmd/polykey/main.go:55,
cmd/dev_client/main.go:108-111). Both beautifiers key on the exact ``msg``
strings, so this module reproduces the format: level names DEBUG/INFO/WARN/
ERROR, RFC3339 timestamps, attributes flattened into the top-level object.
"""

from __future__ import annotations

import datetime
import io
import json
import sys
import threading

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "ERROR": 40}


def _now_rfc3339() -> str:
    return datetime.datetime.now().astimezone().isoformat()


class Logger:
    """Thread-safe line-per-record JSON logger.

    ``stream`` may be any writable text stream; the dev client points it at an
    in-memory buffer so the run can be re-rendered as a Jest-style report
    afterwards (reference: dev_client/main.go:108-111, 128-129).
    """

    def __init__(self, stream=None, level: str = "INFO"):
        self.stream = stream if stream is not None else sys.stdout
        self.level = _LEVELS.get(level.upper(), 20)
        self._lock = threading.Lock()

    def log(self, level: str, msg: str, **attrs) -> None:
        if _LEVELS.get(level, 20) < self.level:
            return
        record = {"time": _now_rfc3339(), "level": level, "msg": msg}
        for k, v in attrs.items():
            record[k] = _jsonable(v)
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._lock:
            self.stream.write(line + "\n")
            try:
                self.stream.flush()
            except (ValueError, io.UnsupportedOperation):
                pass

    def debug(self, msg: str, **attrs) -> None:
        self.log("DEBUG", msg, **attrs)

    def info(self, msg: str, **attrs) -> None:
        self.log("INFO", msg, **attrs)

    def warn(self, msg: str, **attrs) -> None:
        self.log("WARN", msg, **attrs)

    def error(self, msg: str, **attrs) -> None:
        self.log("ERROR", msg, **attrs)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def go_duration(seconds: float) -> str:
    """Render a duration the way Go's time.Duration.String() does (roughly).

    The server's per-RPC log line carries this (main.go:44-46); nothing parses
    it back, so magnitude+unit fidelity is what matters.
    """
    ns = seconds * 1e9
    if ns < 1e3:
        return f"{ns:.0f}ns"
    if ns < 1e6:
        return _trim(ns / 1e3) + "µs"
    if ns < 1e9:
        return _trim(ns / 1e6) + "ms"
    if seconds < 60:
        return _trim(seconds) + "s"
    m, s = divmod(seconds, 60.0)
    if m < 60:
        return f"{int(m)}m" + _trim(s) + "s"
    h, m = divmod(int(m), 60)
    return f"{h}h{m}m" + _trim(s) + "s"


def _trim(x: float) -> str:
    out = f"{x:.3f}".rstrip("0").rstrip(".")
    return out if out else "0"
