"""The parts of the reference's analysis core (polykey_tpu/analysis/core.py
and baseline.py) that the graph tier uses: `Finding`, the usage errors of
the CLI, and the grandfathering baseline.

A baseline entry is keyed by a content fingerprint, sha1 over (rule | path
| snippet | occurrence index), not by a line number; a graph finding's
snippet is its stable key (`graph.graph_finding`). The committed baseline
should trend toward empty: findings are fixed, or carry their reason and
their ROADMAP.md item; stale entries are reported so the file shrinks as
debt is paid.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional

BASELINE_VERSION = 1


@dataclass(frozen=True)
class Finding:
    rule: str             # "GL003"
    path: str             # "graph:<label>"
    line: int             # 0: a graph finding has no source line
    message: str
    snippet: str = ""     # the stable key (feeds the baseline hash)
    suppressed: bool = False
    reason: str = ""      # suppression reason when suppressed
    baselined: bool = False

    @property
    def blocking(self) -> bool:
        return not (self.suppressed or self.baselined)

    def render(self) -> str:
        tag = ""
        if self.suppressed:
            tag = f"  [suppressed: {self.reason}]"
        elif self.baselined:
            tag = "  [baselined]"
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tag}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "suppressed": self.suppressed,
            "baselined": self.baselined,
        }


class UsageError(Exception):
    """CLI usage error (exit code 2)."""


def parse_only(raw: Optional[str], known: set, noun: str = "rule") -> Optional[set]:
    """Parse a --only value against the known ids. Returns the selected id
    set (None: a full run); raises UsageError on a typo'd id, which must not
    silently run nothing."""
    if not raw:
        return None
    only = {t.strip().upper() for t in raw.split(",") if t.strip()}
    unknown = only - set(known)
    if unknown:
        raise UsageError(
            f"unknown {noun} id(s) for --only: {', '.join(sorted(unknown))} "
            f"(known: {', '.join(sorted(known))})"
        )
    return only


def require_full_run(*, partial: bool, prune: bool, write_baseline: bool) -> None:
    """Refuse baseline changes on a partial run: it would drop every other
    check's live entries."""
    if (prune or write_baseline) and partial:
        flag = "--prune" if prune else "--write-baseline"
        raise UsageError(f"{flag} requires a full run (drop --only)")


# -- baseline --------------------------------------------------------------


def fingerprint(finding: Finding, occurrence: int) -> str:
    payload = f"{finding.rule}|{finding.path}|{finding.snippet}|{occurrence}"
    return hashlib.sha1(payload.encode("utf-8")).hexdigest()[:16]


def _with_fingerprints(findings: list) -> list:
    seen: dict = {}
    out = []
    for f in findings:
        key = (f.rule, f.path, f.snippet)
        occurrence = seen.get(key, 0)
        seen[key] = occurrence + 1
        out.append((fingerprint(f, occurrence), f))
    return out


def load_baseline(path: Path) -> dict:
    """The baseline dict (empty when the file does not exist)."""
    if not path.is_file():
        return {"version": BASELINE_VERSION, "findings": {}}
    data = json.loads(path.read_text(encoding="utf-8"))
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, "
            f"expected {BASELINE_VERSION}"
        )
    return data


def _write(path: Path, entries: dict) -> None:
    path.write_text(json.dumps({"version": BASELINE_VERSION, "findings": entries},
                               indent=2, sort_keys=True) + "\n", encoding="utf-8")


def write_baseline(path: Path, findings: list) -> int:
    """Grandfather every blocking finding; returns the entry count. The
    fingerprints run over the whole list, suppressed findings included, so
    occurrence indices line up with `apply_baseline`'s."""
    entries = {
        fp: {"rule": f.rule, "path": f.path, "line": f.line, "message": f.message}
        for fp, f in _with_fingerprints(findings) if f.blocking
    }
    _write(path, entries)
    return len(entries)


def apply_baseline(findings: list, baseline: dict) -> tuple:
    """Mark baselined findings; returns (findings, stale fingerprints):
    stale entries are those whose finding no longer exists."""
    entries = baseline.get("findings", {})
    matched: set = set()
    out = []
    for fp, f in _with_fingerprints(findings):
        if f.blocking and fp in entries:
            matched.add(fp)
            out.append(replace(f, baselined=True))
        else:
            out.append(f)
    return out, sorted(set(entries) - matched)


def prune_baseline(path: Path, findings: list) -> tuple:
    """Drop every entry whose finding no longer exists; returns (kept,
    dropped). The file is rewritten only when something dropped, and never
    made when absent."""
    if not path.is_file():
        return 0, 0
    baseline = load_baseline(path)
    _, stale = apply_baseline(findings, baseline)
    entries = baseline.get("findings", {})
    for fp in stale:
        entries.pop(fp, None)
    if stale:
        _write(path, entries)
    return len(entries), len(stale)
