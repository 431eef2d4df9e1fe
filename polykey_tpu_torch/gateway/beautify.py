"""Jest-style log report renderers (the reference package's
polykey_tpu/gateway/beautify.py, byte for byte in what they print):

- `print_jest_report` — the in-process reporter the dev client runs over
  its buffered JSON logs: suites SETUP / CONNECTION / EXECUTION / ERROR
  keyed on specific ``msg`` strings, green-check PASS steps, and a final
  PASS/FAIL summary banner; a ``pytest --report-log`` JSONL stream (key
  ``$report_type``) renders as a test suite instead.
- `beautify_server_stream` — the stdin pipe filter for *server* logs,
  tolerant of non-JSON prefixes, tracking in-flight RPCs by method and
  rendering FAIL for any terminal code other than "OK". Run as
  ``python -m polykey_tpu_torch.gateway.log_beautifier``.
"""

from __future__ import annotations

import json
import sys
from typing import Iterable, Optional, TextIO

GREEN = "\033[0;32m"
RED = "\033[0;31m"
GRAY = "\033[0;90m"
CYAN = "\033[0;36m"
BOLD = "\033[1m"
RESET = "\033[0m"
BG_GREEN = "\033[42;30m"
BG_RED = "\033[41;37m"


class _Report:
    def __init__(self, out: TextIO):
        self.out = out
        self.current_suite: Optional[str] = None
        self.passes = 0
        self.failures: list[str] = []

    def suite(self, name: str) -> None:
        if self.current_suite != name:
            sep = "─" * 10
            self.out.write(f"\n{GRAY}{sep} {BOLD}{name} {sep}{RESET}\n")
            self.current_suite = name

    def step(self, ok: bool, message: str, details: str = "") -> None:
        color, symbol = (GREEN, "✓") if ok else (RED, "✗")
        suffix = f" {GRAY}({details}){RESET}" if details else ""
        self.out.write(f"  {color}{symbol}{RESET} {message}{suffix}\n")
        if ok:
            self.passes += 1
        else:
            self.failures.append(message)

    def note(self, text: str) -> None:
        self.out.write(f"    {GRAY}{text}{RESET}\n")

    def summary(self) -> None:
        self.out.write(GRAY + "\n" + "=" * 40 + RESET + "\n")
        if self.failures:
            self.out.write(
                f" {BG_RED} FAIL {RESET} {len(self.failures)} failed,"
                f" {self.passes} passed\n"
            )
        else:
            self.out.write(
                f" {BG_GREEN} PASS {RESET} All {self.passes} checks passed\n"
            )


def _parse(line: str) -> Optional[dict]:
    line = line.strip()
    if not line:
        return None
    try:
        entry = json.loads(line)
    except ValueError:
        return None
    return entry if isinstance(entry, dict) else None


def print_jest_report(log_lines: Iterable[str], out: TextIO = sys.stdout) -> bool:
    """Render buffered client/test logs; returns True when nothing failed."""
    report = _Report(out)
    mode = None
    out.write("\n")
    for line in log_lines:
        entry = _parse(line)
        if entry is None:
            continue
        if mode is None:
            if "$report_type" in entry:
                mode = "pytest"
                out.write(f"{BOLD}{CYAN} RUNS Pytest Suite{RESET}\n")
            elif "msg" in entry:
                mode = "app"
                out.write(f"{BOLD}{CYAN} RUNS Polykey Dev Client{RESET}\n")
            else:
                continue
        if mode == "app":
            _app_entry(entry, report)
        else:
            _pytest_entry(entry, report)
    report.summary()
    return not report.failures


def _app_entry(entry: dict, report: _Report) -> None:
    msg = entry.get("msg", "")
    if entry.get("level") == "DEBUG":
        report.suite("CONNECTION")
        report.note(f"{msg}...state={entry.get('state')}")
        return
    if msg == "Configuration loaded":
        report.suite("SETUP")
        report.step(True, "Configuration", f"server={entry.get('server')}")
    elif msg == "Network connectivity test passed":
        report.suite("CONNECTION")
        report.step(True, "Network Connectivity")
    elif msg == "gRPC connection established successfully":
        report.suite("CONNECTION")
        report.step(True, "gRPC Connection")
    elif msg == "Executing tool":
        report.suite("EXECUTION")
        report.step(True, "Tool Execution", f"tool={entry.get('tool_name')}")
    elif msg == "Tool execution completed":
        report.suite("EXECUTION")
        report.note(f"└─ Status: '{entry.get('status_message')}'")
    elif msg == "Received struct output":
        report.suite("EXECUTION")
        report.note(f"└─ Received Output (fields={entry.get('field_count')})")
    elif msg == "Streaming completed":
        report.suite("EXECUTION")
        report.note(
            f"└─ Streamed {entry.get('completion_tokens')} tokens"
            f" (ttft={entry.get('ttft_ms')}ms)"
        )
    elif msg == "Application failed":
        report.suite("ERROR")
        details = str(entry.get("error"))
        report.step(False, "Application Run", details)


def _pytest_entry(entry: dict, report: _Report) -> None:
    # pytest --report-log emits TestReport records; count the `call` phase.
    if entry.get("$report_type") != "TestReport" or entry.get("when") != "call":
        return
    nodeid = entry.get("nodeid", "?")
    suite = nodeid.split("::", 1)[0]
    report.suite(suite)
    duration_ms = round(float(entry.get("duration", 0.0)) * 1000)
    report.step(entry.get("outcome") == "passed", nodeid, f"{duration_ms}ms")


def beautify_server_stream(
    stdin: TextIO = sys.stdin, out: TextIO = sys.stdout
) -> None:
    """Pipe filter for server JSON logs (reference: cmd/utils/log-beautifier).

    Non-JSON lines (and compose prefixes before the first '{') pass through
    untouched; recognized server lifecycle and per-RPC lines render as steps.
    """
    report = _Report(out)
    pending: dict[str, int] = {}  # method → in-flight count
    for raw in stdin:
        raw = raw.rstrip("\n")
        start = raw.find("{")
        if start == -1:
            out.write(raw + "\n")
            continue
        entry = _parse(raw[start:])
        if entry is None:
            out.write(raw + "\n")
            continue
        msg = entry.get("msg", "")
        method = str(entry.get("method", ""))
        if msg == "server starting":
            report.suite("SETUP")
            report.step(True, "Server Listening", f"addr={entry.get('address')}")
        elif msg == "gRPC call received":
            report.suite("CONNECTION")
            report.step(True, "gRPC Connection", method)
            report.suite("EXECUTION")
            pending[method] = pending.get(method, 0) + 1
            out.write(f"  ○ {GRAY}{method}{RESET}\n")
        elif msg == "gRPC call finished":
            if pending.get(method, 0) <= 0:
                # No matched "received" (e.g. attached mid-stream): pass the
                # raw line through rather than dropping the RPC's outcome.
                out.write(raw + "\n")
                continue
            pending[method] -= 1
            code = entry.get("code", "OK")
            report.step(code == "OK", method, str(entry.get("duration", "")))
        elif msg in ("server shutting down", "server stopped"):
            report.suite("SHUTDOWN")
            report.step(True, msg)
