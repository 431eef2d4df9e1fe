"""Fixed-bucket latency histograms with Prometheus semantics.

The engine's old percentile gauges sorted a 512-entry ring on every
snapshot and could not be exported to Prometheus (which needs cumulative
bucket counts, not samples). This histogram is the replacement: a fixed
set of log-spaced upper bounds chosen at construction, O(#buckets) per
observation (binary search), O(#buckets) per percentile estimate, and a
snapshot that renders directly as a ``*_bucket{le=...}`` family.

Buckets are CUMULATIVE only at render time — internally each bucket
holds its own count so `observe` touches exactly one slot (plus sum and
count), keeping the step-loop cost flat regardless of traffic.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Optional, Sequence


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> list[float]:
    """Log-spaced upper bounds from `lo` to at least `hi`, `per_decade`
    bounds per factor of 10. Bounds are rounded to 3 significant digits
    so the rendered ``le`` labels stay human-readable."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    bounds: list[float] = []
    step = 10.0 ** (1.0 / per_decade)
    v = lo
    while True:
        r = float(f"{v:.3g}")
        if not bounds or r > bounds[-1]:
            bounds.append(r)
        if r >= hi:
            break
        v *= step
    return bounds


# Default bounds for millisecond latencies: 0.5 ms .. 2 min covers TTFT
# on-chip (sub-ms cache hits) through queue-saturated tails.
DEFAULT_MS_BUCKETS = log_buckets(0.5, 120_000.0, per_decade=4)


def estimate_quantile(bounds, counts, total: int, q: float) -> float:
    """The q-th percentile (q in [0, 100]) of a raw per-bucket count
    vector (`counts` aligned with `bounds`, +Inf bucket last; `total` is
    the observation count). Shared by `Histogram.percentiles` and the
    signal plane's DELTA quantiles (obs.signals): subtracting two ring
    snapshots' counts yields a windowed histogram this estimates over —
    the fix for "p95 since boot" staleness. Returns 0.0 when empty;
    values beyond the largest finite bound clamp to it."""
    if total <= 0:
        return 0.0
    rank = q / 100.0 * total
    running = 0.0
    for i, c in enumerate(counts[:-1]):
        if running + c >= rank and c > 0:
            upper = bounds[i]
            lower = bounds[i - 1] if i > 0 else 0.0
            frac = (rank - running) / c
            return lower + (upper - lower) * min(1.0, max(0.0, frac))
        running += c
    return bounds[-1]


def fraction_le(bounds, counts, threshold: float) -> Optional[float]:
    """Fraction of observations <= `threshold` in a raw count vector
    (+Inf bucket last), interpolating linearly inside the straddling
    bucket — the good-event fraction a latency SLO needs ("P(TTFT <=
    500 ms)") from bucket counts alone. None when empty. Everything in
    the +Inf bucket is above any threshold."""
    total = sum(counts)
    if total <= 0:
        return None
    running = 0.0
    lower = 0.0
    for i, upper in enumerate(bounds):
        c = counts[i]
        if threshold < upper:
            if threshold <= lower:
                frac = 0.0
            else:
                frac = (threshold - lower) / (upper - lower)
            return (running + c * frac) / total
        running += c
        lower = upper
    return running / total          # threshold >= last bound: all finite


class Histogram:
    """Thread-safe fixed-bucket histogram.

    `bounds` are inclusive upper bounds of the finite buckets; one
    implicit +Inf bucket catches the overflow. Percentile estimates
    interpolate linearly inside the winning bucket (Prometheus'
    histogram_quantile rule), so their error is bounded by the bucket
    ratio — with 4 buckets/decade, ~±30% worst case, which is what
    log-spaced operational histograms trade for O(1) memory.
    """

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds: tuple[float, ...] = tuple(
            sorted(bounds if bounds is not None else DEFAULT_MS_BUCKETS)
        )
        if not self.bounds:
            raise ValueError("histogram needs at least one finite bucket")
        self._counts = [0] * (len(self.bounds) + 1)   # [+Inf] is last
        self._sum = 0.0
        self._count = 0
        # OpenMetrics exemplars: the most recent
        # (value, trace_id, unix_ts) observed per bucket, so a p99
        # bucket on a dashboard links to a concrete recorded trace.
        # Lazily allocated on the first traced observation — histograms
        # that never see a trace id (bench, soak) pay no memory.
        self._exemplars: Optional[list] = None
        self._lock = threading.Lock()

    def observe(self, value: float, count: int = 1,
                trace_id: Optional[str] = None) -> None:
        """Record `count` observations of `value` in one locked update
        (the engine amortizes a decode block's inter-token gap over the
        block's tokens this way). A `trace_id` stamps the bucket's
        exemplar — last writer wins, which is exactly the "give me ANY
        recent request in this bucket" exemplar semantics."""
        if count <= 0 or value != value or value in (math.inf, -math.inf):
            return                      # NaN/Inf would poison the sum
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += count
            self._sum += value * count
            self._count += count
            if trace_id is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * (len(self.bounds) + 1)
                self._exemplars[idx] = (value, trace_id, time.time())

    def exemplars(self) -> Optional[list]:
        """Per-bucket exemplars aligned with `bounds` (+Inf last), or
        None when no traced observation was ever recorded."""
        with self._lock:
            return list(self._exemplars) if self._exemplars else None

    def counts_snapshot(self) -> tuple[tuple[int, ...], float]:
        """One locked copy of the RAW per-bucket counts (+Inf last) plus
        the sum — the signal plane's ring stores these and diffs two of
        them into a windowed histogram (estimate_quantile/fraction_le
        over the delta)."""
        with self._lock:
            return tuple(self._counts), self._sum

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> dict:
        """Cumulative Prometheus view: [(le, cumulative_count)...] with a
        trailing ("+Inf", total), plus sum and count."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total = self._sum, self._count
        cumulative = []
        running = 0
        for bound, c in zip(self.bounds, counts[:-1]):
            running += c
            cumulative.append((bound, running))
        return {
            "buckets": cumulative,
            "inf": total,
            "sum": total_sum,
            "count": total,
        }

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]). Returns 0.0 when
        empty. Values beyond the largest finite bound clamp to it (the
        +Inf bucket has no upper edge to interpolate toward)."""
        return self.percentiles(q)[0]

    def percentiles(self, *qs: float) -> tuple[float, ...]:
        """All requested quantiles from ONE locked copy of the counts, so
        a snapshot can never report p99 < p50 because observations landed
        between per-quantile reads."""
        for q in qs:
            if not 0 <= q <= 100:
                raise ValueError(f"percentile must be in [0, 100], got {q}")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        return tuple(self._estimate(q, counts, total) for q in qs)

    def _estimate(self, q: float, counts: list[int], total: int) -> float:
        return estimate_quantile(self.bounds, counts, total, q)
