"""SLO signal plane: windowed metrics, error-budget burn rates, breaches
(the reference's polykey_tpu/obs/signals.py, the same names, math and
events).

The engine's counters and histograms are cumulative since boot: a p95 that
has absorbed hours of traffic barely moves when the last minute goes bad.
This module judges what they show over windows, and `signals_snapshot()`
is the read side the autopilot (engine/autopilot.py) consumes:

- `SignalPlane` — a bounded ring of periodic `EngineMetrics` samples (raw
  counter values and raw histogram bucket counts, all host state: no
  device read, no synchronize), sampled from the engine loop at block
  boundaries and on the idle tick, time-gated to `interval_s`; the read
  side (`snapshot()`/`stats_fields()`) samples too, so windows advance
  while the engine thread is wedged. Two ring entries subtract into a
  WINDOWED view: counters become rates, cumulative histograms become
  delta-histograms whose quantiles (`estimate_quantile`) and good
  fractions (`fraction_le`) cover only the window. Disabled
  (``signals_interval_s=0``) means `metrics.signals is None`. The plane
  hangs off `EngineMetrics`, which the supervisor hands to the fresh
  engine on restart, so windows survive supervised restarts.
- `SloPolicy` / `SloObjective` — declarative objectives (env/JSON):
  latency ("P(TTFT <= 2000 ms) >= 0.95"), availability ("1 - (shed +
  failed)/total >= 0.999"), and floor/ceiling bounds on windowed scalars.
  Every objective reduces per window to a bad-event fraction; burn_rate =
  bad_fraction / error_budget (the SRE multi-window burn rate). Threshold
  crossings emit `slo_breach`/`slo_recovered` events to the engine
  timeline and the flight recorder, and count into
  ``polykey_slo_breaches_total{objective}``.
- Prometheus export (obs.exposition `_slo_lines`):
  ``polykey_slo_budget_remaining_ratio{objective}``,
  ``polykey_slo_burn_rate{objective,window}``,
  ``polykey_slo_breaches_total{objective}`` — per-replica labeled under a
  pool.
- ``python -m polykey_tpu_torch.obs.signals --emit-alert-rules`` renders
  Prometheus alert-rule YAML from the same `SloPolicy`.

The knobs: ``POLYKEY_SIGNALS_INTERVAL`` (seconds between ring samples; 0
disables the plane), ``POLYKEY_SIGNALS_WINDOWS`` (comma-separated window
seconds, default "60,300,3600"), ``POLYKEY_SLO`` (inline policy JSON,
``@/path/to/policy.json``, or ``default``). Over a disaggregated pool the
engines live in worker processes: `signals_snapshot` carries the pool's
heartbeat-fed windows (``pool``, ``pool_now``, ``tiers``,
``clock_offsets``) instead of per-replica planes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .histogram import estimate_quantile, fraction_le

DEFAULT_WINDOWS: tuple[float, ...] = (60.0, 300.0, 3600.0)
DEFAULT_INTERVAL_S = 5.0

# EngineMetrics histogram attributes the plane snapshots, keyed by the
# signal name objectives reference (the exported family stem).
HIST_SIGNALS: dict[str, str] = {
    "ttft_ms": "ttft_hist",
    "itl_ms": "itl_hist",
    "host_stall_ms": "host_stall_hist",
    "request_device_ms": "device_ms_hist",
    # Host-KV restore latency: windowed restore tails are
    # the autopilot's evidence for tuning POLYKEY_KV_RESTORE_SLOTS
    # (p95 >> p50 means restores queue behind the per-iteration budget).
    "kv_restore_ms": "kv_restore_hist",
}

# Windowed scalar signals floor/ceiling objectives may bound; values
# come from `summarize_deltas` keys of the same name.
SCALAR_SIGNALS = frozenset({
    "device_busy_fraction", "avg_lanes", "tokens_per_sec",
    "availability", "host_stall_ms_mean", "lookahead_observed_mean",
    "spec_accept_rate",
})

ENV_POLICY = "POLYKEY_SLO"
ENV_WINDOWS = "POLYKEY_SIGNALS_WINDOWS"


def window_label(seconds: float) -> str:
    """Human window label for metric labels and stat-key suffixes:
    60 -> "1m", 300 -> "5m", 3600 -> "1h", 90 -> "90s"."""
    s = int(round(seconds))
    if s >= 3600 and s % 3600 == 0:
        return f"{s // 3600}h"
    if s >= 60 and s % 60 == 0:
        return f"{s // 60}m"
    return f"{seconds:g}s"


def windows_from_spec(spec: str) -> tuple[float, ...]:
    """Comma-separated window seconds -> sorted tuple; "" -> the
    1m/5m/1h defaults. Malformed or non-positive entries RAISE — the
    same fail-fast rule as POLYKEY_SLO (a typo'd window spec silently
    falling back to defaults would alert on windows the operator never
    asked for, with nothing visibly wrong)."""
    if not spec:
        return DEFAULT_WINDOWS
    try:
        windows = tuple(sorted(float(x) for x in spec.split(",") if x.strip()))
    except ValueError as e:
        raise ValueError(
            f"bad signals windows spec {spec!r}: comma-separated "
            "seconds, e.g. '60,300,3600'"
        ) from e
    if not windows or any(w <= 0 for w in windows):
        raise ValueError(
            f"bad signals windows spec {spec!r}: need at least one "
            "window, all > 0 seconds"
        )
    return windows


def windows_from_env() -> tuple[float, ...]:
    # polylint: disable=ML004(fallback when no EngineConfig exists (standalone plane); the engine passes config.signals_windows through)
    return windows_from_spec(os.environ.get(ENV_WINDOWS, ""))


# -- objectives ---------------------------------------------------------------


@dataclass(frozen=True)
class SloObjective:
    """One declarative objective. `kind` selects the bad-fraction rule:

    - ``latency``: `signal` names a histogram (HIST_SIGNALS); good means
      an observation <= `threshold_ms`; `target` is the required good
      fraction (error budget = 1 - target).
    - ``availability``: good = completed, bad = failed + shed +
      deadline-expired; `target` is the required good fraction.
    - ``floor`` / ``ceiling``: `signal` names a windowed scalar
      (SCALAR_SIGNALS); the window is bad (fraction 1.0) when the value
      crosses `target`; `time_budget` is the allowed fraction of time
      in violation (the error budget).

    `burn_threshold` is the breach line on the shortest window's burn
    (default 1.0 = "burning faster than the budget allows");
    `fast_burn` only parameterizes the emitted page-severity alert rule.
    """

    name: str
    kind: str
    signal: str = ""
    threshold_ms: float = 0.0
    target: float = 0.99
    time_budget: float = 0.05
    burn_threshold: float = 1.0
    fast_burn: float = 14.0

    def validate(self) -> None:
        if not self.name or any(c in self.name for c in '{}",\n'):
            raise ValueError(f"bad objective name {self.name!r}")
        if self.kind == "latency":
            if self.signal not in HIST_SIGNALS:
                raise ValueError(
                    f"latency objective {self.name!r} needs signal in "
                    f"{sorted(HIST_SIGNALS)}, got {self.signal!r}"
                )
            if self.threshold_ms <= 0:
                raise ValueError(
                    f"latency objective {self.name!r} needs threshold_ms > 0"
                )
        elif self.kind == "availability":
            pass
        elif self.kind in ("floor", "ceiling"):
            if self.signal not in SCALAR_SIGNALS:
                raise ValueError(
                    f"{self.kind} objective {self.name!r} needs signal in "
                    f"{sorted(SCALAR_SIGNALS)}, got {self.signal!r}"
                )
            if not 0.0 < self.time_budget <= 1.0:
                raise ValueError(
                    f"objective {self.name!r}: time_budget must be in (0, 1]"
                )
        else:
            raise ValueError(
                f"unknown objective kind {self.kind!r}; use latency, "
                "availability, floor, or ceiling"
            )
        if self.kind in ("latency", "availability") \
                and not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1)"
            )
        if self.burn_threshold <= 0:
            raise ValueError(
                f"objective {self.name!r}: burn_threshold must be > 0"
            )

    @property
    def error_budget(self) -> float:
        if self.kind in ("latency", "availability"):
            return 1.0 - self.target
        return self.time_budget


DEFAULT_OBJECTIVES: tuple[SloObjective, ...] = (
    SloObjective(name="interactive_ttft", kind="latency", signal="ttft_ms",
                 threshold_ms=2000.0, target=0.95),
    SloObjective(name="itl_tail", kind="latency", signal="itl_ms",
                 threshold_ms=500.0, target=0.99),
    SloObjective(name="availability", kind="availability", target=0.999),
    SloObjective(name="device_busy", kind="floor",
                 signal="device_busy_fraction", target=0.5,
                 time_budget=0.1),
)


@dataclass(frozen=True)
class SloPolicy:
    objectives: tuple[SloObjective, ...] = ()

    def validate(self) -> None:
        seen = set()
        for objective in self.objectives:
            objective.validate()
            if objective.name in seen:
                raise ValueError(f"duplicate objective {objective.name!r}")
            seen.add(objective.name)

    @classmethod
    def from_json(cls, obj) -> "SloPolicy":
        if isinstance(obj, dict):
            obj = obj.get("objectives", [])
        if not isinstance(obj, list):
            raise ValueError("SLO policy JSON must be a list of objectives "
                             'or {"objectives": [...]}')
        fields = set(SloObjective.__dataclass_fields__)
        objectives = []
        for entry in obj:
            unknown = set(entry) - fields
            if unknown:
                raise ValueError(
                    f"unknown objective fields {sorted(unknown)} "
                    f"(valid: {sorted(fields)})"
                )
            objectives.append(SloObjective(**entry))
        policy = cls(objectives=tuple(objectives))
        policy.validate()
        return policy

    @classmethod
    def from_spec(cls, raw: str) -> Optional["SloPolicy"]:
        """Policy spec string: empty -> None (no objectives, windows
        only); ``default`` -> the built-in objective set; ``@path`` ->
        JSON file; anything else -> inline JSON. Malformed policy raises
        at engine construction — a typo'd SLO must not silently serve
        unwatched."""
        raw = (raw or "").strip()
        if not raw:
            return None
        if raw == "default":
            policy = cls(objectives=DEFAULT_OBJECTIVES)
            policy.validate()
            return policy
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                return cls.from_json(json.load(f))
        return cls.from_json(json.loads(raw))

    @classmethod
    def from_env(cls) -> Optional["SloPolicy"]:
        # polylint: disable=ML004(fallback when no EngineConfig exists (standalone plane); the engine passes config.slo_policy through)
        return cls.from_spec(os.environ.get(ENV_POLICY, ""))


# -- windowed math ------------------------------------------------------------


def summarize_deltas(deltas: dict, bounds: dict) -> dict:
    """Derived stats over one window's counter/histogram deltas (the
    dict `SignalPlane.window_deltas` returns): rates, availability,
    occupancy, pipeline health, and delta-quantiles. `bounds` maps each
    histogram signal name to its bucket bounds. Pure function of the
    deltas so pool aggregation (`merge_deltas`) reuses it verbatim."""
    c = deltas["counters"]
    covered = deltas["covered_s"]
    completed = c.get("requests_completed", 0)
    # Availability denominator: completed + failed + shed. Deadline
    # expiries are NOT added separately — every expiry already counts
    # in requests_failed (engine._expire/_finish call on_finish(
    # failed=True) alongside on_deadline_expired), so adding the phase
    # counters would double-count each expiry and inflate burn ~2x.
    # The expiry breakdown still rides the summary as its own key.
    bad = c.get("requests_failed", 0) + c.get("requests_shed", 0)
    total = completed + bad
    steps = c.get("steps_dispatched", 0)
    gap = c.get("dispatch_gap_ms_total", 0.0)
    synced = c.get("blocks_synced", 0)
    processed = c.get("blocks_processed", 0)
    out = {
        "covered_s": round(covered, 2),
        "requests_completed": completed,
        "requests_failed": c.get("requests_failed", 0),
        "requests_shed": c.get("requests_shed", 0),
        "deadline_expired": (c.get("deadline_expired_queued", 0)
                             + c.get("deadline_expired_prefill", 0)
                             + c.get("deadline_expired_decode", 0)),
        "availability": round(completed / total, 5) if total else None,
        "tokens_per_sec": (
            round(c.get("tokens_generated", 0) / covered, 2)
            if covered > 0 else None
        ),
        "avg_lanes": (
            round(c.get("lane_steps", 0) / steps, 2) if steps else None
        ),
        "device_busy_fraction": (
            round(c.get("device_busy_ms_total", 0.0) / gap, 4)
            if gap > 0 else None
        ),
        "host_stall_ms_mean": (
            round(c.get("host_stall_ms_total", 0.0) / synced, 3)
            if synced else None
        ),
        "lookahead_observed_mean": (
            round(c.get("lookahead_sum", 0) / processed, 2)
            if processed else None
        ),
        # Autopilot contract fields. Explicit None when the
        # window holds no evidence — the controller treats None as
        # "hold", never as zero. arrival_rate_per_s is the interactive-
        # presence signal (prefill-budget actuation); the kv_* rates
        # are the host tier's fault-pressure signals (restore-slot and
        # resident-floor actuations).
        "arrival_rate_per_s": (
            round(c.get("requests_admitted", 0) / covered, 3)
            if covered > 0 else None
        ),
        "kv_page_faults": (
            c.get("kv_page_faults_prefix", 0)
            + c.get("kv_page_faults_ctx", 0)
        ),
        "kv_fault_rate_per_min": (
            round((c.get("kv_page_faults_prefix", 0)
                   + c.get("kv_page_faults_ctx", 0)) * 60.0 / covered, 3)
            if covered > 0 else None
        ),
        "kv_pages_restored": c.get("kv_pages_restored", 0),
        # Windowed draft acceptance: the autopilot's
        # decide_gamma evidence. None when the window proposed nothing
        # (spec off, or an idle/gate-failed stretch) — a null verdict,
        # never a zero.
        "spec_accept_rate": (
            round(
                c.get("drafts_accepted", 0) / c.get("drafts_proposed", 0),
                4,
            )
            if c.get("drafts_proposed", 0) > 0 else None
        ),
    }
    for name, (counts, _sum) in deltas["hists"].items():
        n = sum(counts)
        out[f"{name}_count"] = n
        if n <= 0:
            continue
        b = bounds[name]
        quantiles = (50, 95, 99) if name in ("ttft_ms", "itl_ms") \
            else (50, 95)
        for q in quantiles:
            out[f"{name}_p{q}"] = round(
                estimate_quantile(b, counts, n, q), 2
            )
    return out


def merge_deltas(parts: list[dict]) -> Optional[dict]:
    """Element-wise sum of several replicas' window deltas into one
    pool-aggregate delta (counters add; histogram bucket counts add —
    every ms histogram shares DEFAULT_MS_BUCKETS). covered_s is the max:
    replicas sample on their own clocks and the aggregate window is the
    union span."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    counters: dict = {}
    hists: dict = {}
    for part in parts:
        for key, value in part["counters"].items():
            counters[key] = counters.get(key, 0) + value
        for name, (counts, hsum) in part["hists"].items():
            if name in hists:
                prev_counts, prev_sum = hists[name]
                hists[name] = (
                    tuple(a + b for a, b in zip(prev_counts, counts)),
                    prev_sum + hsum,
                )
            else:
                hists[name] = (tuple(counts), hsum)
    return {
        "covered_s": max(p["covered_s"] for p in parts),
        "counters": counters,
        "hists": hists,
    }


@dataclass
class _SloState:
    breached: bool = False
    breaches: int = 0
    # (t, violated) evaluation history for floor/ceiling time budgets.
    history: deque = field(default_factory=deque)
    last: dict = field(default_factory=dict)


class SignalPlane:
    """Bounded ring of metrics snapshots + SLO evaluation over them.

    Owned by (attached to) an `EngineMetrics`, which the supervisor's
    metrics-adoption path hands to the fresh engine on restart — so the
    ring, the windows, and the breach states all survive supervised
    restarts (the adoption test pins it). The engine rebinds `timeline`
    after a restart (supervisor._restart) since the ring it notes into
    belongs to the engine, not the metrics.
    """

    def __init__(self, metrics, windows: tuple = DEFAULT_WINDOWS,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 capacity: int = 0, policy: Optional[SloPolicy] = None,
                 timeline=None, recorder=None):
        if interval_s <= 0:
            raise ValueError(
                "SignalPlane needs interval_s > 0; a disabled plane is "
                "`metrics.signals is None`, not a zero-interval sampler"
            )
        if not windows:
            raise ValueError("SignalPlane needs at least one window")
        self.metrics = metrics
        self.windows = tuple(sorted(float(w) for w in windows))
        self.interval_s = float(interval_s)
        if capacity <= 0:
            # Cover the longest window at the sampling cadence, plus two
            # samples of slack so the baseline lookup always finds an
            # entry older than the window.
            capacity = min(8192, int(self.windows[-1] / self.interval_s) + 2)
        self.capacity = capacity
        self.timeline = timeline
        self.recorder = recorder
        self._bounds = {
            name: getattr(metrics, attr).bounds
            for name, attr in HIST_SIGNALS.items()
        }
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._eval_lock = threading.Lock()
        self._last_t = 0.0
        self._slo: dict[str, _SloState] = {}
        self.policy: Optional[SloPolicy] = None
        if policy is not None:
            self.set_policy(policy)

    # -- policy ---------------------------------------------------------------

    def set_policy(self, policy: Optional[SloPolicy]) -> None:
        """Install (or clear) the objective set; resets breach state —
        budget accounting against the OLD objectives is meaningless
        against the new ones."""
        if policy is not None:
            policy.validate()
        with self._eval_lock:
            self.policy = policy
            self._slo = {}

    # -- sampling (engine loop + read side) -----------------------------------

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Append a ring sample if `interval_s` elapsed since the last
        one, then evaluate the SLO policy. The fast path — one clock
        read and a float compare, no lock — is what the engine loop pays
        per iteration when no sample is due."""
        if now is None:
            now = time.monotonic()
        if now - self._last_t < self.interval_s:
            return False
        with self._lock:
            if now - self._last_t < self.interval_s:
                return False
            self._last_t = now
            self._ring.append(self._capture(now))
        if self.policy is not None and self.policy.objectives:
            self._evaluate(now)
        return True

    def sample_now(self) -> None:
        """Force a ring sample regardless of the interval gate, then
        evaluate. Harness hook (tests, chip_smoke.py) for pinning a
        measurement boundary exactly — the periodic path may lag a
        finish by up to `interval_s`."""
        now = time.monotonic()
        with self._lock:
            self._last_t = now
            self._ring.append(self._capture(now))
        if self.policy is not None and self.policy.objectives:
            self._evaluate(now)

    def _capture(self, now: float) -> tuple:
        counters = self.metrics.counter_sample()
        hists = {
            name: getattr(self.metrics, attr).counts_snapshot()
            for name, attr in HIST_SIGNALS.items()
        }
        return (now, counters, hists)

    def samples(self) -> int:
        return len(self._ring)

    # -- windowed read side ---------------------------------------------------

    def window_deltas(self, seconds: float) -> Optional[dict]:
        """Counter/histogram deltas between the newest sample and the
        newest sample at least `seconds` older (falling back to the
        oldest in the ring — `covered_s` reports what the window
        actually spans, so a freshly booted plane answers honestly
        instead of refusing). None with fewer than two samples."""
        with self._lock:
            ring = list(self._ring)
        if len(ring) < 2:
            return None
        end_t, end_c, end_h = ring[-1]
        base = ring[0]
        for sample in reversed(ring[:-1]):
            if end_t - sample[0] >= seconds:
                base = sample
                break
        base_t, base_c, base_h = base
        covered = end_t - base_t
        if covered <= 0:
            return None
        counters = {
            key: end_c[key] - base_c.get(key, 0) for key in end_c
        }
        hists = {}
        for name, (counts, hsum) in end_h.items():
            base_counts, base_sum = base_h.get(
                name, ((0,) * len(counts), 0.0)
            )
            hists[name] = (
                tuple(e - b for e, b in zip(counts, base_counts)),
                hsum - base_sum,
            )
        return {"covered_s": covered, "counters": counters, "hists": hists}

    def window_summary(self, seconds: float) -> Optional[dict]:
        deltas = self.window_deltas(seconds)
        if deltas is None:
            return None
        return summarize_deltas(deltas, self._bounds)

    def snapshot(self) -> dict:
        """The stable queryable view over every configured window plus
        the SLO state — the structure `signals_snapshot()` nests
        per-replica and the autopilot consumes."""
        self.maybe_sample()
        return {
            "interval_s": self.interval_s,
            "samples": len(self._ring),
            "windows": {
                window_label(w): self.window_summary(w)
                for w in self.windows
            },
            "slo": self.slo_state(),
        }

    def stats_fields(self) -> dict:
        """Windowed keys for `engine_stats` (the "*_5m" satellite):
        quantiles/rates over the window nearest 300 s, suffixed with its
        label — TTFT/ITL tails that reflect the last minutes instead of
        the whole uptime."""
        self.maybe_sample()
        window = min(self.windows, key=lambda w: abs(w - 300.0))
        summary = self.window_summary(window)
        if not summary:
            return {}
        label = window_label(window)
        keys = (
            "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99",
            "itl_ms_p50", "itl_ms_p95", "itl_ms_p99",
            "host_stall_ms_p50", "host_stall_ms_p95",
            "tokens_per_sec", "device_busy_fraction", "availability",
        )
        return {
            f"{key}_{label}": summary[key]
            for key in keys
            if summary.get(key) is not None
        }

    # -- SLO evaluation -------------------------------------------------------

    def _bad_fraction(self, objective: SloObjective,
                      deltas: Optional[dict],
                      summary: Optional[dict]) -> Optional[float]:
        """The window's bad-event fraction in [0, 1] for one objective,
        or None when the window carries no evidence (no events → no
        verdict, never a synthetic 0 or 1)."""
        if deltas is None or summary is None:
            return None
        if objective.kind == "latency":
            entry = deltas["hists"].get(objective.signal)
            if entry is None:
                return None
            good = fraction_le(
                self._bounds[objective.signal], entry[0],
                objective.threshold_ms,
            )
            return None if good is None else 1.0 - good
        if objective.kind == "availability":
            availability = summary.get("availability")
            return None if availability is None else 1.0 - availability
        value = summary.get(objective.signal)
        if value is None:
            return None
        ok = value >= objective.target if objective.kind == "floor" \
            else value <= objective.target
        return 0.0 if ok else 1.0

    def _time_budget_bad(self, state: _SloState, now: float) -> Optional[float]:
        """Fraction of the budget window (longest window) a
        floor/ceiling objective spent in violation, time-weighted over
        the evaluation history. The denominator is the BUDGET WINDOW,
        not the observed span: seconds of early evidence must not
        extrapolate to "budget exhausted" (a warm-up dip under the
        floor consumes only the seconds it actually lasted; time not
        yet observed is assumed healthy, matching the
        no-evidence-no-verdict rule)."""
        horizon = now - self.windows[-1]
        while state.history and state.history[0][0] < horizon:
            state.history.popleft()
        if len(state.history) < 2:
            return None
        violated = 0.0
        entries = list(state.history)
        for (t0, bad), (t1, _) in zip(entries, entries[1:]):
            if bad:
                violated += t1 - t0
        return violated / self.windows[-1]

    def _evaluate(self, now: float) -> None:
        policy = self.policy
        if policy is None:
            return
        with self._eval_lock:
            if self.policy is not policy:
                return              # set_policy raced; skip this round
            deltas_by_w = {w: self.window_deltas(w) for w in self.windows}
            summaries = {
                w: (None if deltas_by_w[w] is None
                    else summarize_deltas(deltas_by_w[w], self._bounds))
                for w in self.windows
            }
            for objective in policy.objectives:
                state = self._slo.setdefault(objective.name, _SloState())
                burns: dict[str, Optional[float]] = {}
                for w in self.windows:
                    bad = self._bad_fraction(
                        objective, deltas_by_w[w], summaries[w]
                    )
                    burns[window_label(w)] = (
                        None if bad is None
                        else round(bad / objective.error_budget, 4)
                    )
                # Budget accounting over the LONGEST window: event kinds
                # read their bad fraction straight from it; time-bounded
                # kinds integrate the violation history.
                if objective.kind in ("floor", "ceiling"):
                    short_bad = self._bad_fraction(
                        objective, deltas_by_w[self.windows[0]],
                        summaries[self.windows[0]],
                    )
                    if short_bad is not None:
                        state.history.append((now, short_bad > 0.0))
                    budget_bad = self._time_budget_bad(state, now)
                else:
                    budget_bad = self._bad_fraction(
                        objective, deltas_by_w[self.windows[-1]],
                        summaries[self.windows[-1]],
                    )
                remaining = (
                    1.0 if budget_bad is None
                    else max(0.0, min(
                        1.0, 1.0 - budget_bad / objective.error_budget
                    ))
                )
                # Breach detection on the SHORTEST window with evidence:
                # the freshest signal decides, so a cleared fault stops
                # the burn as soon as the short window ages it out.
                breach_burn = next(
                    (burns[window_label(w)] for w in self.windows
                     if burns[window_label(w)] is not None),
                    None,
                )
                if breach_burn is not None:
                    if breach_burn > objective.burn_threshold \
                            and not state.breached:
                        state.breached = True
                        state.breaches += 1
                        self._emit(
                            "slo_breach", objective=objective.name,
                            burn_rate=breach_burn,
                            threshold=objective.burn_threshold,
                            budget_remaining=round(remaining, 4),
                        )
                    elif breach_burn <= objective.burn_threshold \
                            and state.breached:
                        state.breached = False
                        self._emit(
                            "slo_recovered", objective=objective.name,
                            burn_rate=breach_burn,
                            budget_remaining=round(remaining, 4),
                        )
                state.last = {
                    "kind": objective.kind,
                    "burn_rate": burns,
                    "budget_remaining": round(remaining, 4),
                    "breached": state.breached,
                    "breaches": state.breaches,
                }

    def _emit(self, kind: str, **attrs) -> None:
        timeline = self.timeline
        if timeline is not None:
            timeline.note(kind, **attrs)
        recorder = self.recorder
        if recorder is not None:
            recorder.event(kind, **attrs)

    def slo_state(self) -> dict:
        """Last evaluation per objective (cached — the scrape path must
        not recompute window math): {name: {burn_rate: {window: x},
        budget_remaining, breached, breaches, kind}}. Empty without a
        policy."""
        with self._eval_lock:
            return {
                name: dict(state.last)
                for name, state in self._slo.items() if state.last
            }


# -- process-level read side --------------------------------------------------


def _engines_of(engine_or_pool) -> list[tuple[int, object]]:
    if hasattr(engine_or_pool, "workers"):
        # Disaggregated pool: the engines live in worker processes, with
        # no plane here to read or bind. The snapshot carries the pool's
        # own heartbeat-fed windows instead (`signal_windows`); per-worker
        # windowed stats ride the workers' stats replies.
        return []
    if hasattr(engine_or_pool, "replicas"):
        return [(rep.index, rep.engine) for rep in engine_or_pool.replicas]
    return [(getattr(engine_or_pool, "replica_id", 0), engine_or_pool)]


def bind_recorder(engine_or_pool, recorder) -> None:
    """Give every replica's signal plane the shared flight recorder so
    breach/recovery events land next to watchdog trips and restarts
    (the gateway wires this; engines alone have no recorder)."""
    for _, engine in _engines_of(engine_or_pool):
        plane = getattr(engine.metrics, "signals", None)
        if plane is not None and plane.recorder is None:
            plane.recorder = recorder


def signals_snapshot(engine_or_pool, registry=None) -> dict:
    """The queryable signal-plane view over an engine OR a replica pool
    — the `/debug/slo` payload and the autopilot's read API:

    - ``replicas``: per-replica plane snapshots (windows + slo) plus
      live "now" signals (queue-delay estimate, instantaneous load,
      service-time EWMA) the router already scores on;
    - ``aggregate``: the pool-merged windowed view (counter deltas and
      histogram deltas summed across replicas — real pool quantiles,
      not averages of quantiles);
    - ``gateway``: RPC-level availability from the interceptor's
      ``polykey_rpcs_total{method,code}`` counter when a registry is
      provided — the accounting layer above the engine, where sheds and
      aborts that never reached a slot still count against the service.
    """
    members = _engines_of(engine_or_pool)
    replicas: dict = {}
    planes = []
    for index, engine in members:
        plane = getattr(engine.metrics, "signals", None)
        entry: dict = {"enabled": plane is not None}
        if plane is not None:
            planes.append(plane)
            entry.update(plane.snapshot())
        entry["now"] = {
            "queue_delay_s": round(engine.queue_delay_estimate_s(), 4),
            "load_fraction": round(engine.load_fraction(), 4),
            "service_time_ewma_s": round(
                engine.metrics.service_time_ewma_s(), 4
            ),
        }
        replicas[str(index)] = entry
    out: dict = {"replicas": replicas}
    if planes:
        windows = planes[0].windows
        bounds = planes[0]._bounds
        out["aggregate"] = {
            window_label(w): (
                None if (merged := merge_deltas(
                    [plane.window_deltas(w) for plane in planes]
                )) is None else summarize_deltas(merged, bounds)
            )
            for w in windows
        }
    pool_windows = getattr(engine_or_pool, "signal_windows", None)
    if callable(pool_windows):
        # Disaggregated pool: the coordinator keeps its OWN windowed ring
        # of cross-tier handoff signals — wire bandwidth, handoff-latency
        # delta-quantiles, per-tier fault/restore rates — sampled on the
        # heartbeat. The autopilot reads tier pressure here.
        out["pool"] = pool_windows()
        now_fn = getattr(engine_or_pool, "handoff_now", None)
        if callable(now_fn):
            out["pool_now"] = now_fn()
        offsets = getattr(engine_or_pool, "clock_offsets", None)
        if callable(offsets):
            out["clock_offsets"] = offsets()
        tiers_fn = getattr(engine_or_pool, "tier_now", None)
        if callable(tiers_fn):
            # Per-tier live pressure: serving/total counts plus the
            # heartbeat-fed queue-delay and load means — the tier-scaling
            # controller's reading. queue_delay_s is None while no serving
            # worker has answered a ping (no evidence: the controller
            # holds).
            out["tiers"] = tiers_fn()
    autopilot = getattr(engine_or_pool, "autopilot", None)
    if autopilot is not None:
        # Closed-loop controller state: current setpoints,
        # pause state, and the last-N decision ring — /debug/slo is how
        # operators read them.
        out["autopilot"] = autopilot.snapshot()
    if registry is not None:
        out["gateway"] = gateway_availability(registry)
    return out


def signals_available(engine_or_pool) -> bool:
    """Whether `signals_snapshot` over this target yields evidence a
    controller may act on — the autopilot's refuse-to-start gate
    (POLYKEY_SIGNALS_INTERVAL=0 allocates no plane, and a control loop
    reading permanently-absent windows would hold forever while
    claiming to supervise). A disaggregated pool's coordinator ring
    samples on the heartbeat and its workers inherit the config's
    signals_interval_s, so the config gates both."""
    if hasattr(engine_or_pool, "workers"):
        config = getattr(engine_or_pool, "config", None)
        return bool(config is not None
                    and getattr(config, "signals_interval_s", 0) > 0)
    return any(
        getattr(engine.metrics, "signals", None) is not None
        for _index, engine in _engines_of(engine_or_pool)
    )


def gateway_availability(registry) -> Optional[dict]:
    """Cumulative RPC-outcome accounting from the gateway interceptor's
    counter: OK vs non-OK per the LLM-serving methods. Gateway-level
    availability differs from the engine's when requests die before a
    slot (auth, parse, UNAVAILABLE during restart) — the SLO a client
    actually experiences."""
    counter = registry.get("polykey_rpcs_total")
    if counter is None:
        return None
    ok = bad = 0
    with counter._lock:
        items = list(counter._values.items())
    for (method, code), count in items:
        if not method.endswith(("ExecuteTool", "ExecuteToolStream")):
            continue
        if code == "OK":
            ok += count
        else:
            bad += count
    total = ok + bad
    return {
        "rpcs_ok": int(ok),
        "rpcs_failed": int(bad),
        "availability": round(ok / total, 5) if total else None,
    }


# -- alert-rule emission ------------------------------------------------------


def _yaml_quote(value: str) -> str:
    return '"' + value.replace("\\", "\\\\").replace('"', '\\"') + '"'


def alert_rules_yaml(policy: SloPolicy,
                     windows: tuple = DEFAULT_WINDOWS) -> str:
    """Prometheus alert-rule YAML generated from the SAME SloPolicy the
    in-process plane evaluates — one source of truth, so external
    alerting and the `polykey_slo_*` families cannot drift. Two rules
    per objective (the standard multi-window burn-rate pair):

    - page: the short AND mid windows both burn above `fast_burn`
      (a fast leak that exhausts budget in hours, worth waking someone);
    - ticket: the long window burns above `burn_threshold`
      (a slow leak that exhausts budget before the window rolls over).
    """
    windows = tuple(sorted(float(w) for w in windows))
    short = window_label(windows[0])
    mid = window_label(windows[min(1, len(windows) - 1)])
    long_ = window_label(windows[-1])
    lines = [
        "# Generated by: python -m polykey_tpu_torch.obs.signals"
        " --emit-alert-rules",
        "# Source of truth: the same SloPolicy the engine's signal plane",
        "# evaluates in-process (POLYKEY_SLO). Regenerate on any policy",
        "# change; do not edit by hand.",
        "groups:",
        "- name: polykey-slo",
        "  rules:",
    ]
    for objective in policy.objectives:
        sel = f'{{objective="{objective.name}"}}'
        short_sel = f'{{objective="{objective.name}",window="{short}"}}'
        mid_sel = f'{{objective="{objective.name}",window="{mid}"}}'
        long_sel = f'{{objective="{objective.name}",window="{long_}"}}'
        camel = "".join(
            part.capitalize() for part in objective.name.split("_")
        )
        lines += [
            f"  - alert: PolykeySloFastBurn{camel}",
            "    expr: >-",
            f"      polykey_slo_burn_rate{short_sel}"
            f" > {objective.fast_burn:g}",
            f"      and polykey_slo_burn_rate{mid_sel}"
            f" > {objective.fast_burn:g}",
            f"    for: {short}",
            "    labels:",
            "      severity: page",
            "    annotations:",
            "      summary: " + _yaml_quote(
                f"SLO {objective.name}: fast error-budget burn "
                f"(> {objective.fast_burn:g}x over {short} and {mid})"
            ),
            f"  - alert: PolykeySloSlowBurn{camel}",
            "    expr: >-",
            f"      polykey_slo_burn_rate{long_sel}"
            f" > {objective.burn_threshold:g}",
            f"    for: {mid}",
            "    labels:",
            "      severity: ticket",
            "    annotations:",
            "      summary: " + _yaml_quote(
                f"SLO {objective.name}: sustained burn over {long_} "
                "will exhaust the error budget"
            ),
            f"  - alert: PolykeySloBudgetLow{camel}",
            "    expr: >-",
            f"      polykey_slo_budget_remaining_ratio{sel} < 0.1",
            f"    for: {mid}",
            "    labels:",
            "      severity: ticket",
            "    annotations:",
            "      summary: " + _yaml_quote(
                f"SLO {objective.name}: less than 10% of the error "
                "budget remains"
            ),
        ]
    return "\n".join(lines) + "\n"


def main(argv: Optional[list] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m polykey_tpu_torch.obs.signals",
        description="SLO signal-plane tooling (alert-rule emission).",
    )
    parser.add_argument(
        "--emit-alert-rules", action="store_true",
        help="print Prometheus alert-rule YAML derived from the policy",
    )
    parser.add_argument(
        "--policy", default="",
        help="policy source: inline JSON, @/path.json, or 'default' "
             "(default: POLYKEY_SLO, falling back to the built-ins)",
    )
    parser.add_argument(
        "--windows", default="",
        help="comma-separated window seconds (default: "
             "POLYKEY_SIGNALS_WINDOWS or 60,300,3600)",
    )
    args = parser.parse_args(argv)
    if not args.emit_alert_rules:
        parser.error("nothing to do; pass --emit-alert-rules")
    if args.policy:
        os.environ[ENV_POLICY] = args.policy
    policy = SloPolicy.from_env()
    if policy is None:
        policy = SloPolicy(objectives=DEFAULT_OBJECTIVES)
    if args.windows:
        windows = tuple(
            sorted(float(x) for x in args.windows.split(",") if x.strip())
        )
    else:
        windows = windows_from_env()
    print(alert_rules_yaml(policy, windows), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
