"""Autopilot: the closed control loop over the signal plane (the
reference's polykey_tpu/engine/autopilot.py: the same decisions, bounds,
cooldowns and setters).

A supervised thread reads ``signals_snapshot()`` each tick and drives
bounded, hysteretic, cooldown-rate-limited actuations:

- **knobs** — dispatch lookahead from host-stall/device-busy evidence,
  prefill budget from interactive-arrival presence, KV restore slots and
  the host-KV resident floor from the host tier's fault/restore signals,
  the speculative gamma cap from windowed draft acceptance, the router's
  delay weight from per-replica TTFT skew;
- **capacity** — `decide_scale` sizes the disaggregated pool's tiers from
  per-tier queue delay, through `DisaggPool.scale_up` / `scale_down`
  (engine/disagg_pool.py; a scale-down drains before it kills). Over a
  disaggregated pool the knobs go to every worker through the control
  plane (`DisaggPool.apply_knobs`); without ``tiers`` in the snapshot no
  capacity decision is made.

`evaluate()` and the `decide_*` functions are PURE — (snapshot, state,
config, now) in, decisions out, no I/O. The `Autopilot` thread owns the
impure edge: reading the snapshot, applying decisions through the
target's live setters (engine/engine.py, engine/replica_pool.py,
engine/disagg_pool.py), and
recording evidence (timeline ``autopilot_decision`` notes, the decision
ring `/debug/slo` serves, the Prometheus families obs/exposition.py
renders). Every read is host state: nothing here touches the device.

No evidence, no verdict: a reading of None (young window, no host-KV
tier) holds the knob. Every actuation is clamped to explicit bounds, never
fires inside its per-action cooldown, and moves only when the reading
crosses the far side of a hysteresis band.

Supervisor contract: a watchdog trip pauses the loop; the restart
listener re-applies the current setpoints to the FRESH engine (actuations
live on engine attributes, which a restart rebuilds from config), then
re-arms the loop.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..obs.signals import signals_available, signals_snapshot

__all__ = [
    "Autopilot",
    "AutopilotConfig",
    "AutopilotUnavailableError",
    "ControllerState",
    "Decision",
    "apply_engine_knobs",
    "evaluate",
]


class AutopilotUnavailableError(RuntimeError):
    """The autopilot cannot run against this target — typed so the
    boot path fails loudly (POLYKEY_AUTOPILOT=1 with the signal plane
    disabled is a misconfiguration, not a silent no-op)."""


# Actions. Knob actions actuate through engine/pool setters; scale
# actions through the disaggregated pool's tier resize.
LOOKAHEAD = "lookahead"
PREFILL_BUDGET = "prefill_budget"
RESTORE_SLOTS = "restore_slots"
RESIDENT_FLOOR = "resident_floor"
SPEC_GAMMA = "spec_gamma"
ROUTE_DELAY_WEIGHT = "route_delay_weight"
SCALE_PREFILL = "scale_prefill"
SCALE_DECODE = "scale_decode"

UP = "up"
DOWN = "down"

_ENGINE_KNOB_SETTERS = {
    LOOKAHEAD: "set_lookahead",
    PREFILL_BUDGET: "set_prefill_budget",
    RESTORE_SLOTS: "set_kv_restore_slots",
    RESIDENT_FLOOR: "set_resident_floor",
    SPEC_GAMMA: "set_spec_gamma",
}


def apply_engine_knobs(engine, knobs: dict) -> dict:
    """Apply a knob→value dict through an engine's live setters.
    Unknown names and absent setters are skipped (a worker running an
    older engine build must not crash on a newer caller's knob).
    Returns name → value actually applied (post-clamp)."""
    applied: dict = {}
    for name, value in knobs.items():
        attr = _ENGINE_KNOB_SETTERS.get(name)
        setter = getattr(engine, attr, None) if attr else None
        if setter is None:
            continue
        try:
            applied[name] = setter(value)
        except (TypeError, ValueError):
            continue  # a malformed value must never kill the caller
    return applied


@dataclass(frozen=True)
class AutopilotConfig:
    """Controller policy. The env-read knobs (from_env) are the
    operator surface; the remaining thresholds
    are hysteresis-band tuning with safe defaults, overridable
    programmatically (tests, soaks)."""

    interval_s: float = 2.0          # tick cadence
    cooldown_s: float = 20.0         # per-action minimum gap
    target_busy: float = 0.75        # device-busy fraction target
    lookahead_max: int = 6
    tier_min: int = 1
    tier_max: int = 3
    queue_high_s: float = 0.3        # tier queue delay: scale-up edge
    queue_low_s: float = 0.03        # tier queue delay: scale-down edge
    decisions_keep: int = 64         # decision-ring size
    min_evidence_s: float = 10.0     # youngest window worth acting on
    # Hysteresis bands (act only OUTSIDE the band; inside = hold).
    stall_high_ms: float = 1.0       # host-stall p95: deepen lookahead
    stall_low_ms: float = 0.0        # host-stall p95: relax lookahead
    arrival_high_per_s: float = 0.5  # interactive presence: narrow budget
    arrival_low_per_s: float = 0.05  # batch-quiet: widen budget
    fault_high_per_min: float = 30.0  # kv fault pressure: more slots/floor
    fault_low_per_min: float = 0.0    # kv quiet: decay toward baseline
    ttft_skew_high_ms: float = 500.0  # per-replica p95 spread: weight delay
    ttft_skew_low_ms: float = 100.0   # spread healed: decay weight
    # Speculative acceptance band. Mirrors the device-side
    # per-lane dial constants (GAMMA_ACCEPT_FLOOR/CEIL in spec_decode):
    # the host controller moves the engine-wide cap, the device dial
    # moves each lane inside it.
    spec_accept_low: float = 0.35    # acceptance collapsed: cap the rung
    spec_accept_high: float = 0.55   # acceptance healthy: restore boot cap

    @staticmethod
    def enabled_from_env() -> bool:
        """The master switch. Default OFF: with POLYKEY_AUTOPILOT unset
        nothing constructs, nothing attaches, and every existing
        suite/soak is byte-identical."""
        return os.environ.get("POLYKEY_AUTOPILOT", "").lower() in (
            "1", "true"
        )

    @classmethod
    def from_env(cls) -> "AutopilotConfig":
        """Single parse site for every POLYKEY_AUTOPILOT* knob (the
        ML004 discipline, owned here rather than EngineConfig because
        the controller runs beside the engine, not inside it)."""

        def _f(name: str, default: float) -> float:
            raw = os.environ.get(name, "")
            try:
                return float(raw) if raw.strip() else default
            except ValueError:
                return default

        def _i(name: str, default: int) -> int:
            raw = os.environ.get(name, "")
            try:
                return int(raw) if raw.strip() else default
            except ValueError:
                return default

        return cls(
            interval_s=max(0.05, _f("POLYKEY_AUTOPILOT_INTERVAL", 2.0)),
            cooldown_s=max(0.0, _f("POLYKEY_AUTOPILOT_COOLDOWN", 20.0)),
            target_busy=min(1.0, max(
                0.0, _f("POLYKEY_AUTOPILOT_TARGET_BUSY", 0.75))),
            lookahead_max=max(
                1, _i("POLYKEY_AUTOPILOT_LOOKAHEAD_MAX", 6)),
            tier_min=max(1, _i("POLYKEY_AUTOPILOT_TIER_MIN", 1)),
            tier_max=max(1, _i("POLYKEY_AUTOPILOT_TIER_MAX", 3)),
            queue_high_s=_f("POLYKEY_AUTOPILOT_QUEUE_HIGH", 0.3),
            queue_low_s=_f("POLYKEY_AUTOPILOT_QUEUE_LOW", 0.03),
            decisions_keep=max(
                1, _i("POLYKEY_AUTOPILOT_DECISIONS", 64)),
            min_evidence_s=max(
                0.0, _f("POLYKEY_AUTOPILOT_MIN_EVIDENCE", 10.0)),
        )


@dataclass
class Decision:
    """One typed actuation verdict — exactly what the timeline event,
    the decision ring, and the Prometheus counter record."""

    action: str
    direction: str           # "up" | "down"
    reason: str              # human-readable evidence sentence
    reading: Optional[float]  # the measurement that crossed the band
    old: float
    new: float

    def as_dict(self) -> dict:
        return {
            "action": self.action, "direction": self.direction,
            "reason": self.reason, "reading": self.reading,
            "old": self.old, "new": self.new,
        }


@dataclass
class ControllerState:
    """Everything `evaluate` needs beyond the snapshot, kept explicit
    so tests drive the pure core without an Autopilot instance.

    setpoints — current value per action (the gauge family);
    baselines — boot values: decay targets and the operator's floor
    (the autopilot relaxes TOWARD config, never below it);
    bounds — (lo, hi) hard clamp per action;
    steps — increment per decision (ints step, floats scale);
    last_fired — action → monotonic timestamp of its last decision.
    """

    setpoints: dict = field(default_factory=dict)
    baselines: dict = field(default_factory=dict)
    bounds: dict = field(default_factory=dict)
    steps: dict = field(default_factory=dict)
    last_fired: dict = field(default_factory=dict)


def _label_seconds(label: str) -> float:
    """Inverse of obs.signals.window_label ("1m" → 60)."""
    try:
        if label.endswith("h"):
            return float(label[:-1]) * 3600.0
        if label.endswith("m"):
            return float(label[:-1]) * 60.0
        if label.endswith("s"):
            return float(label[:-1])
        return float(label)
    except ValueError:
        return float("inf")


def _freshest(windowed: Optional[dict]) -> Optional[dict]:
    """The shortest window's summary — breach detection acts on the
    freshest evidence (the longest window is the budget's, not the
    controller's). None when every window is still empty."""
    if not windowed:
        return None
    for label in sorted(windowed, key=_label_seconds):
        summary = windowed[label]
        if summary:
            return summary
    return None


def _ready(state: ControllerState, action: str, cfg: AutopilotConfig,
           now: float) -> bool:
    return now - state.last_fired.get(action, -1e18) >= cfg.cooldown_s


def _bounded(state: ControllerState, action: str, value: float) -> float:
    lo, hi = state.bounds.get(action, (float("-inf"), float("inf")))
    return min(hi, max(lo, value))


# ---------------------------------------------------------------------------
# Pure decision functions — one per actuated knob/capacity axis.
# Each returns a Decision or None ("hold"); None ALWAYS means either
# no evidence (null verdict) or the reading sits inside the hysteresis
# band or the action is cooling down / at its bound.
# ---------------------------------------------------------------------------


def decide_lookahead(summary: Optional[dict], state: ControllerState,
                     cfg: AutopilotConfig, now: float) -> Optional[Decision]:
    """Deepen the dispatch pipeline while the host is the bottleneck:
    nonzero host-stall p95 with the device under the busy target means
    readback latency is not hidden. Relax one step back toward the
    boot depth once stalls vanish AND the device runs at target — both
    edges, so a reading between them holds (hysteresis)."""
    if summary is None or not _ready(state, LOOKAHEAD, cfg, now):
        return None
    stall_p95 = summary.get("host_stall_ms_p95")
    busy = summary.get("device_busy_fraction")
    if stall_p95 is None or busy is None:
        return None  # null verdict: young window or idle engine
    old = state.setpoints.get(LOOKAHEAD)
    if old is None:
        return None
    if stall_p95 > cfg.stall_high_ms and busy < cfg.target_busy:
        new = _bounded(state, LOOKAHEAD, old + 1)
        if new != old:
            return Decision(
                LOOKAHEAD, UP,
                f"host_stall p95 {stall_p95:.1f}ms with device_busy "
                f"{busy:.2f} < target {cfg.target_busy:.2f}",
                stall_p95, old, new,
            )
    elif (stall_p95 <= cfg.stall_low_ms and busy >= cfg.target_busy
            and old > state.baselines.get(LOOKAHEAD, old)):
        new = max(state.baselines[LOOKAHEAD], old - 1)
        return Decision(
            LOOKAHEAD, DOWN,
            f"host_stall p95 {stall_p95:.1f}ms at device_busy "
            f"{busy:.2f}; relaxing toward boot depth",
            stall_p95, old, new,
        )
    return None


def decide_prefill_budget(summary: Optional[dict],
                          pool_windows: Optional[dict],
                          state: ControllerState, cfg: AutopilotConfig,
                          now: float) -> Optional[Decision]:
    """Interactive-arrival presence: live arrivals mean in-flight
    decode ITL needs protecting — narrow the interleave budget by one
    chunk. A quiet pool (batch work, no interactive tail to protect)
    widens it back to move prompts faster. Arrival evidence comes from
    the aggregate window (in-process engines) or, for a disagg target
    with no in-process planes, from the pool's windowed handoff rate."""
    if not _ready(state, PREFILL_BUDGET, cfg, now):
        return None
    rate = None
    if summary is not None:
        rate = summary.get("arrival_rate_per_s")
    if rate is None and pool_windows:
        pool = _freshest(pool_windows)
        if pool and pool.get("covered_s", 0) > 0:
            handoffs = pool.get("handoffs") or {}
            rate = round(
                sum(handoffs.values()) / pool["covered_s"], 3
            )
    if rate is None:
        return None  # no arrival evidence anywhere: hold
    old = state.setpoints.get(PREFILL_BUDGET)
    chunk = state.steps.get(PREFILL_BUDGET, 0)
    if old is None or chunk <= 0:
        return None
    if rate >= cfg.arrival_high_per_s:
        new = _bounded(state, PREFILL_BUDGET, old - chunk)
        if new != old:
            return Decision(
                PREFILL_BUDGET, DOWN,
                f"interactive arrivals {rate:.2f}/s >= "
                f"{cfg.arrival_high_per_s:.2f}/s; narrowing interleave "
                "to protect ITL",
                rate, old, new,
            )
    elif rate <= cfg.arrival_low_per_s:
        new = _bounded(state, PREFILL_BUDGET, old + chunk)
        if new != old:
            return Decision(
                PREFILL_BUDGET, UP,
                f"arrivals {rate:.2f}/s <= {cfg.arrival_low_per_s:.2f}/s;"
                " widening interleave for prompt throughput",
                rate, old, new,
            )
    return None


def decide_restore_slots(summary: Optional[dict], state: ControllerState,
                         cfg: AutopilotConfig,
                         now: float) -> Optional[Decision]:
    """KV fault pressure (the host tier's histograms): a sustained page-fault
    rate with restore p95 well above p50 means faulting lanes queue
    behind the per-iteration restore budget — raise it. Zero faults
    decay it back toward the boot value."""
    if summary is None or not _ready(state, RESTORE_SLOTS, cfg, now):
        return None
    old = state.setpoints.get(RESTORE_SLOTS)
    if old is None:
        return None  # no host-KV tier on this target
    rate = summary.get("kv_fault_rate_per_min")
    if rate is None:
        return None
    if rate > cfg.fault_high_per_min:
        new = _bounded(state, RESTORE_SLOTS, old + 1)
        if new != old:
            p50 = summary.get("kv_restore_ms_p50")
            p95 = summary.get("kv_restore_ms_p95")
            tail = (f"; restore p95/p50 {p95:.0f}/{p50:.0f}ms"
                    if p50 and p95 else "")
            return Decision(
                RESTORE_SLOTS, UP,
                f"kv fault rate {rate:.1f}/min > "
                f"{cfg.fault_high_per_min:.1f}/min{tail}",
                rate, old, new,
            )
    elif (rate <= cfg.fault_low_per_min
            and old > state.baselines.get(RESTORE_SLOTS, old)):
        new = max(state.baselines[RESTORE_SLOTS], old - 1)
        return Decision(
            RESTORE_SLOTS, DOWN,
            f"kv fault rate {rate:.1f}/min; relaxing toward boot budget",
            rate, old, new,
        )
    return None


def decide_resident_floor(summary: Optional[dict], state: ControllerState,
                          cfg: AutopilotConfig,
                          now: float) -> Optional[Decision]:
    """Resize the host-KV resident floor under fault pressure
    (PersistentKV shape): sustained faults mean the working set
    thrashes the floor — spill earlier so hot pages stay resident.
    Quiet decay returns the device pool to serving capacity."""
    if summary is None or not _ready(state, RESIDENT_FLOOR, cfg, now):
        return None
    old = state.setpoints.get(RESIDENT_FLOOR)
    step = state.steps.get(RESIDENT_FLOOR, 0)
    if old is None or step <= 0:
        return None
    rate = summary.get("kv_fault_rate_per_min")
    if rate is None:
        return None
    if rate > cfg.fault_high_per_min:
        new = _bounded(state, RESIDENT_FLOOR, old + step)
        if new != old:
            return Decision(
                RESIDENT_FLOOR, UP,
                f"kv fault rate {rate:.1f}/min > "
                f"{cfg.fault_high_per_min:.1f}/min; raising spill floor",
                rate, old, new,
            )
    elif (rate <= cfg.fault_low_per_min
            and old > state.baselines.get(RESIDENT_FLOOR, old)):
        new = max(state.baselines[RESIDENT_FLOOR], old - step)
        return Decision(
            RESIDENT_FLOOR, DOWN,
            f"kv fault rate {rate:.1f}/min; relaxing spill floor",
            rate, old, new,
        )
    return None


def decide_gamma(summary: Optional[dict], state: ControllerState,
                 cfg: AutopilotConfig, now: float) -> Optional[Decision]:
    """Speculation width from windowed acceptance evidence:
    when the fleet-wide accept rate collapses below the band, every
    verify position past the first is wasted target compute — snap the
    engine's gamma cap down to the low ladder rung (set_spec_gamma
    rung-snaps, so any value below gamma_max lands on gamma_low).
    Healthy acceptance above the band restores the boot cap. The
    per-lane device dial handles per-sequence variation INSIDE the cap;
    this knob is the coarse host override for workload-wide collapse.
    The setpoint only exists when the engine booted with a draft model
    (knob_setpoints gates it), so the action is armed iff spec is on."""
    if summary is None or not _ready(state, SPEC_GAMMA, cfg, now):
        return None
    old = state.setpoints.get(SPEC_GAMMA)
    if old is None:
        return None  # no draft model on this target: never arms
    rate = summary.get("spec_accept_rate")
    if rate is None:
        return None  # no drafts proposed in the window: null verdict
    lo, _hi = state.bounds.get(SPEC_GAMMA, (1, old))
    if rate < cfg.spec_accept_low and old > lo:
        return Decision(
            SPEC_GAMMA, DOWN,
            f"spec accept rate {rate:.2f} < {cfg.spec_accept_low:.2f}; "
            "capping speculation at the low rung",
            rate, old, lo,
        )
    if (rate > cfg.spec_accept_high
            and old < state.baselines.get(SPEC_GAMMA, old)):
        new = state.baselines[SPEC_GAMMA]
        return Decision(
            SPEC_GAMMA, UP,
            f"spec accept rate {rate:.2f} > {cfg.spec_accept_high:.2f}; "
            "restoring boot gamma cap",
            rate, old, new,
        )
    return None


def decide_route_weights(replicas: Optional[dict], state: ControllerState,
                         cfg: AutopilotConfig,
                         now: float) -> Optional[Decision]:
    """Per-replica TTFT skew: when one replica's
    windowed p95 runs far ahead of another's, the router is not
    spreading delay — double the delay weight so queue-delay dominates
    warmth. Healed skew decays the weight back toward the configured
    baseline."""
    if not replicas or not _ready(state, ROUTE_DELAY_WEIGHT, cfg, now):
        return None
    old = state.setpoints.get(ROUTE_DELAY_WEIGHT)
    if old is None:
        return None
    p95s = []
    for entry in replicas.values():
        summary = _freshest(entry.get("windows"))
        if summary and summary.get("ttft_ms_p95") is not None:
            p95s.append(summary["ttft_ms_p95"])
    if len(p95s) < 2:
        return None  # skew needs at least two measured replicas
    skew = max(p95s) - min(p95s)
    if skew > cfg.ttft_skew_high_ms:
        new = _bounded(state, ROUTE_DELAY_WEIGHT, old * 2.0)
        if new != old:
            return Decision(
                ROUTE_DELAY_WEIGHT, UP,
                f"replica ttft p95 skew {skew:.0f}ms > "
                f"{cfg.ttft_skew_high_ms:.0f}ms",
                skew, old, new,
            )
    elif (skew < cfg.ttft_skew_low_ms
            and old > state.baselines.get(ROUTE_DELAY_WEIGHT, old)):
        new = max(state.baselines[ROUTE_DELAY_WEIGHT], old / 2.0)
        return Decision(
            ROUTE_DELAY_WEIGHT, DOWN,
            f"replica ttft p95 skew {skew:.0f}ms healed",
            skew, old, new,
        )
    return None


def decide_scale(tier: str, tiers: Optional[dict],
                 state: ControllerState, cfg: AutopilotConfig,
                 now: float) -> Optional[Decision]:
    """Elastic tier sizing from per-tier queue-delay evidence: the
    heartbeat-fed mean queue delay across a tier's serving workers
    (outage waiters' ages join the mean when the pings go dark).
    Above the high edge, grow — but only with NO boot already in
    flight (serving == total): a worker boot pays an import and
    compile storm, and stacking a second one starves the capacity
    the first was supposed to deliver; measure the tier with its
    in-flight capacity landed, then reassess. Below the low edge
    with headroom, shrink (the pool drains before killing). None
    queue delay — empty tier or no ping yet — holds."""
    action = SCALE_PREFILL if tier == "prefill" else SCALE_DECODE
    if not tiers or not _ready(state, action, cfg, now):
        return None
    entry = tiers.get(tier)
    if not entry:
        return None
    delay = entry.get("queue_delay_s")
    serving = entry.get("serving", 0)
    total = entry.get("total", 0)
    if delay is None:
        return None  # no heartbeat evidence: hold
    if (delay > cfg.queue_high_s and total < cfg.tier_max
            and serving == total):
        return Decision(
            action, UP,
            f"{tier} queue delay {delay:.3f}s > {cfg.queue_high_s:.3f}s",
            delay, total, total + 1,
        )
    if (delay < cfg.queue_low_s and serving > cfg.tier_min
            and total > cfg.tier_min):
        return Decision(
            action, DOWN,
            f"{tier} queue delay {delay:.3f}s < {cfg.queue_low_s:.3f}s "
            "with headroom; draining one worker",
            delay, total, total - 1,
        )
    return None


def evaluate(snapshot: dict, state: ControllerState, cfg: AutopilotConfig,
             now: float) -> list[Decision]:
    """The pure controller core: one tick's verdicts over one
    signals_snapshot. Enforces the evidence gate (a youngest window
    covering less than min_evidence_s holds every aggregate-driven
    knob), then runs each decision function. Capacity decisions run
    only when the snapshot carries tier evidence (disagg targets)."""
    decisions: list[Decision] = []
    summary = _freshest(snapshot.get("aggregate"))
    if summary is not None and summary.get(
            "covered_s", 0.0) < cfg.min_evidence_s:
        summary = None  # young engine: explicit hold, not tiny-window noise
    pool_windows = snapshot.get("pool")
    for decision in (
        decide_lookahead(summary, state, cfg, now),
        decide_prefill_budget(summary, pool_windows, state, cfg, now),
        decide_restore_slots(summary, state, cfg, now),
        decide_resident_floor(summary, state, cfg, now),
        decide_gamma(summary, state, cfg, now),
        decide_route_weights(snapshot.get("replicas"), state, cfg, now),
        decide_scale("prefill", snapshot.get("tiers"), state, cfg, now),
        decide_scale("decode", snapshot.get("tiers"), state, cfg, now),
    ):
        if decision is not None:
            decisions.append(decision)
    return decisions


# ---------------------------------------------------------------------------
# The impure edge: the control thread.
# ---------------------------------------------------------------------------


class Autopilot:
    """The control thread over one target (InferenceEngine or
    ReplicaPool). start() refuses (typed) when the signal plane is off;
    stop() detaches. While running, `target.autopilot is self`, so
    /debug/slo and /metrics see the same state."""

    def __init__(self, target, config: Optional[AutopilotConfig] = None,
                 supervisor=None, obs=None, logger=None):
        self.target = target
        self.cfg = config or AutopilotConfig.from_env()
        self.obs = obs
        self.logger = logger
        self._explicit_supervisor = supervisor
        self.state: Optional[ControllerState] = None
        self.decisions: deque = deque(maxlen=self.cfg.decisions_keep)
        self.decisions_total: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self._paused_reasons: set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Autopilot":
        if not signals_available(self.target):
            raise AutopilotUnavailableError(
                "autopilot needs the signal plane: "
                "POLYKEY_SIGNALS_INTERVAL=0 disables it, so there is "
                "nothing to read — unset it (or set POLYKEY_AUTOPILOT=0)"
            )
        self.state = self._build_state()
        self._attach_supervisors()
        self.target.autopilot = self
        self._thread = threading.Thread(
            target=self._run, name="polykey-autopilot", daemon=True
        )
        self._thread.start()
        if self.logger is not None:
            self.logger.info(
                "autopilot armed",
                interval_s=self.cfg.interval_s,
                cooldown_s=self.cfg.cooldown_s,
                setpoints=dict(self.state.setpoints),
            )
        self._note("autopilot_armed", setpoints=dict(self.state.setpoints))
        return self

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)
        if getattr(self.target, "autopilot", None) is self:
            self.target.autopilot = None

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception as e:  # the loop must never die silently
                if self.logger is not None:
                    self.logger.error("autopilot tick failed",
                                      error=str(e))

    # -- target shape --------------------------------------------------------

    def _engines(self) -> list:
        if hasattr(self.target, "workers"):
            return []  # disaggregated: the engines live in worker processes
        replicas = getattr(self.target, "replicas", None)
        if replicas is not None:
            return [rep.engine for rep in replicas]
        return [self.target]

    def _build_state(self) -> ControllerState:
        """Baselines/bounds from the target's boot configuration — the
        autopilot widens from the operator's settings and decays back
        to them, never below."""
        config = self.target.config
        state = ControllerState()
        chunk = config.prefill_chunk or max(config.prefill_buckets)
        engines = self._engines()
        if engines:
            knobs = engines[0].knob_setpoints()
        else:
            # Disaggregated: the coordinator holds no engine; the boot
            # setpoints are the config every worker was spawned with.
            knobs = {
                "lookahead": max(1, config.lookahead_blocks),
                "prefill_budget": max(config.prefill_budget or 2 * chunk, chunk),
            }
            if config.host_kv_bytes > 0:
                knobs["restore_slots"] = config.host_kv_restore_slots
                knobs["resident_floor"] = (
                    config.host_kv_resident_pages or config.num_pages // 8)
        state.setpoints[LOOKAHEAD] = knobs["lookahead"]
        state.baselines[LOOKAHEAD] = knobs["lookahead"]
        state.bounds[LOOKAHEAD] = (
            knobs["lookahead"], max(knobs["lookahead"], self.cfg.lookahead_max)
        )
        budget = knobs["prefill_budget"]
        state.setpoints[PREFILL_BUDGET] = budget
        state.baselines[PREFILL_BUDGET] = budget
        state.steps[PREFILL_BUDGET] = chunk
        state.bounds[PREFILL_BUDGET] = (chunk, max(budget * 2, 4 * chunk))
        if "restore_slots" in knobs:
            slots = knobs["restore_slots"]
            state.setpoints[RESTORE_SLOTS] = slots
            state.baselines[RESTORE_SLOTS] = slots
            state.bounds[RESTORE_SLOTS] = (
                slots, max(slots, config.max_decode_slots)
            )
            floor = knobs["resident_floor"]
            step = max(1, config.num_pages // 16)
            state.setpoints[RESIDENT_FLOOR] = floor
            state.baselines[RESIDENT_FLOOR] = floor
            state.steps[RESIDENT_FLOOR] = step
            state.bounds[RESIDENT_FLOOR] = (
                floor, max(floor, config.num_pages // 2)
            )
        if "spec_gamma" in knobs:
            cap = knobs["spec_gamma"]
            state.setpoints[SPEC_GAMMA] = cap
            state.baselines[SPEC_GAMMA] = cap
            state.bounds[SPEC_GAMMA] = (engines[0]._gamma_low, cap)
        if hasattr(self.target, "set_route_weights"):
            weight = config.route_delay_weight
            state.setpoints[ROUTE_DELAY_WEIGHT] = weight
            state.baselines[ROUTE_DELAY_WEIGHT] = weight
            state.bounds[ROUTE_DELAY_WEIGHT] = (weight, weight * 8.0)
        return state

    def _attach_supervisors(self) -> None:
        supervisors = []
        if self._explicit_supervisor is not None:
            supervisors.append(self._explicit_supervisor)
        for rep in getattr(self.target, "replicas", None) or ():
            if getattr(rep, "supervisor", None) is not None:
                supervisors.append(rep.supervisor)
        for supervisor in supervisors:
            supervisor.add_trip_listener(self._on_trip)
            supervisor.add_restart_listener(self._on_restart)

    # -- supervisor pause / re-arm -------------------------------------------

    def pause(self, reason: str) -> None:
        with self._lock:
            fresh = reason not in self._paused_reasons
            self._paused_reasons.add(reason)
        if fresh:
            self._note("autopilot_paused", reason=reason)
            if self.logger is not None:
                self.logger.info("autopilot paused", reason=reason)

    def resume(self, reason: str) -> None:
        with self._lock:
            was = reason in self._paused_reasons
            self._paused_reasons.discard(reason)
            clear = not self._paused_reasons
        if was and clear:
            self._note("autopilot_rearmed", reason=reason)
            if self.logger is not None:
                self.logger.info("autopilot re-armed", reason=reason)

    @property
    def paused(self) -> bool:
        with self._lock:
            return bool(self._paused_reasons)

    def _on_trip(self, *_args) -> None:
        self.pause("supervisor-restart")

    def _on_restart(self, fresh) -> None:
        """A fresh engine boots with config-default knobs; the current
        setpoints must outlive the restart (adoption carries metrics,
        not engine attributes), so re-apply them BEFORE re-arming."""
        if self.state is not None:
            apply_engine_knobs(fresh, self._knob_setpoints())
        self.resume("supervisor-restart")

    def _knob_setpoints(self) -> dict:
        assert self.state is not None
        return {
            name: self.state.setpoints[name]
            for name in _ENGINE_KNOB_SETTERS
            if name in self.state.setpoints
        }

    # -- the tick ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> list[Decision]:
        """One control iteration; public so tests and soaks can drive
        it synchronously. Returns the decisions applied."""
        if self.state is None:
            return []
        if self.paused:
            return []
        if now is None:
            now = time.monotonic()
        snapshot = signals_snapshot(self.target)
        decisions = evaluate(snapshot, self.state, self.cfg, now)
        for decision in decisions:
            self._apply(decision, now)
        return decisions

    def _apply(self, decision: Decision, now: float) -> None:
        applied = self._actuate(decision)
        if applied is None:
            return  # the actuator refused (a scale action has no target here)
        decision.new = applied
        self.state.last_fired[decision.action] = now
        self.state.setpoints[decision.action] = applied
        key = (decision.action, decision.direction)
        with self._lock:
            # polylint: disable=ML002(keyed by (action, direction): 8 static action names x 2 directions, not per-request data)
            self.decisions_total[key] = self.decisions_total.get(key, 0) + 1
            self.decisions.append(
                {"t": round(now, 3), **decision.as_dict()}
            )
        self._note("autopilot_decision", **decision.as_dict())
        if self.obs is not None and self.obs.recorder is not None:
            self.obs.recorder.event(
                "autopilot_decision", **decision.as_dict()
            )
        if self.logger is not None:
            self.logger.info(
                "autopilot decision", action=decision.action,
                direction=decision.direction, reason=decision.reason,
                old=decision.old, new=decision.new,
            )

    def _actuate(self, decision: Decision):
        """Route one decision to the target's actuation surface.
        Returns the applied value, or None when the actuator refused."""
        target = self.target
        if decision.action in (SCALE_PREFILL, SCALE_DECODE):
            return self._scale(
                "prefill" if decision.action == SCALE_PREFILL else "decode", decision)
        if decision.action == ROUTE_DELAY_WEIGHT:
            setter = getattr(target, "set_route_weights", None)
            if setter is None:
                return None
            _prefix, delay = setter(delay=decision.new)
            return delay
        knobs = {decision.action: decision.new}
        if hasattr(target, "workers"):           # disaggregated: control plane
            applied = target.apply_knobs(knobs)
        elif hasattr(target, "apply_engine_knobs"):  # replica pool
            applied = target.apply_engine_knobs(knobs)
        else:                                    # bare engine
            applied = apply_engine_knobs(target, knobs)
        return applied.get(decision.action)

    def _scale(self, tier: str, decision: Decision):
        """A tier resize: the pool's scale_up / scale_down (None when the
        target has none or refused: one serving worker left, no spawner)."""
        name = "scale_up" if decision.direction == UP else "scale_down"
        scale = getattr(self.target, name, None)
        if scale is None:
            return None
        return decision.new if scale(tier) is not None else None

    # -- observability -------------------------------------------------------

    def _note(self, kind: str, **attrs) -> None:
        timeline = getattr(self.target, "timeline", None)
        if timeline is None:
            replicas = getattr(self.target, "replicas", None)
            if replicas:
                timeline = getattr(replicas[0].engine, "timeline", None)
        if timeline is not None:
            timeline.note(kind, **attrs)

    def snapshot(self) -> dict:
        """JSON-able controller state for /debug/slo ("autopilot" key),
        and the Prometheus families."""
        with self._lock:
            totals = {
                f"{action}:{direction}": count
                for (action, direction), count
                in sorted(self.decisions_total.items())
            }
            recent = list(self.decisions)
        return {
            "enabled": True,
            "paused": self.paused,
            "interval_s": self.cfg.interval_s,
            "cooldown_s": self.cfg.cooldown_s,
            "setpoints": dict(self.state.setpoints) if self.state else {},
            "decisions_total": totals,
            "decisions": recent,
        }


def maybe_start(target, supervisor=None, obs=None, logger=None):
    """Gateway boot hook: construct+start an Autopilot iff
    POLYKEY_AUTOPILOT=1. Returns the running instance or None. A
    start-time refusal (signal plane off) propagates — the typed error
    is the contract, not a log line."""
    if not AutopilotConfig.enabled_from_env():
        return None
    return Autopilot(
        target, config=AutopilotConfig.from_env(),
        supervisor=supervisor, obs=obs, logger=logger,
    ).start()


