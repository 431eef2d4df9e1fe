"""Prometheus text-format (version 0.0.4) metric primitives.

No client_prometheus dependency (the container doesn't ship one): this
is the small subset serving needs — counters, gauges, histograms over
`obs.histogram.Histogram`, and callback collectors that snapshot live
engine state at scrape time. Rendering follows the exposition format:
one ``# HELP``/``# TYPE`` header per family, samples with sorted label
sets, cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count`` for
histograms.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

from .histogram import Histogram

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# Negotiated via the Accept header (obs.exposition): the OpenMetrics
# rendering is the classic page plus per-bucket exemplars carrying
# trace_id and a terminating "# EOF" — the subset serving needs to link
# a p99 bucket to its recorded span tree. Scrapers that don't ask for
# it get the byte-stable classic page.
CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

# Render-mode flag (thread-local): set by Registry.render for the
# duration of one page render, read by the histogram sample renderers —
# collectors are plain zero-arg callables, so the mode can't ride an
# argument without breaking every registered collector's signature.
_render_local = threading.local()


def openmetrics_active() -> bool:
    return getattr(_render_local, "openmetrics", False)


@contextlib.contextmanager
def _render_mode(openmetrics: bool):
    previous = getattr(_render_local, "openmetrics", False)
    _render_local.openmetrics = openmetrics
    try:
        yield
    finally:
        _render_local.openmetrics = previous


def render_exemplar_suffix(exemplar: Optional[tuple]) -> str:
    """OpenMetrics exemplar tail for a bucket sample line:
    `` # {trace_id="abc"} value unix_ts``. Empty string outside
    OpenMetrics mode or without an exemplar."""
    if exemplar is None or not openmetrics_active():
        return ""
    value, trace_id, ts = exemplar
    return (f' # {{trace_id="{_escape_label(str(trace_id))}"}} '
            f"{_fmt_value(value)} {ts:.3f}")


def _fmt_value(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v == int(v)
                              and abs(v) < 1e15):
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labels_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_header(name: str, help_text: str, metric_type: str) -> list[str]:
    help_esc = help_text.replace("\\", r"\\").replace("\n", r"\n")
    return [f"# HELP {name} {help_esc}", f"# TYPE {name} {metric_type}"]


def render_sample(name: str, labels: dict, value: float) -> str:
    return f"{name}{_labels_str(labels)} {_fmt_value(value)}"


def render_counter(name: str, help_text: str, value: float,
                   labels: Optional[dict] = None) -> list[str]:
    return render_header(name, help_text, "counter") + [
        render_sample(name, labels or {}, value)
    ]


def render_gauge(name: str, help_text: str, value: float,
                 labels: Optional[dict] = None) -> list[str]:
    return render_header(name, help_text, "gauge") + [
        render_sample(name, labels or {}, value)
    ]


def render_histogram_samples(name: str, labels: dict,
                             hist: Histogram) -> list[str]:
    """One label-set's sample lines for a histogram family (no header —
    the text format forbids repeating it, so multi-label-set callers
    emit it once themselves). In OpenMetrics render mode, bucket lines
    carry trace_id exemplars. The ONE place exemplar bucket rendering
    lives — the /metrics engine collector and Registry-owned histograms
    both come through here."""
    snap = hist.snapshot()
    exemplars = hist.exemplars() if openmetrics_active() else None
    lines = []
    for i, (bound, cumulative) in enumerate(snap["buckets"]):
        lines.append(render_sample(
            f"{name}_bucket", {**labels, "le": f"{bound:g}"}, cumulative
        ) + render_exemplar_suffix(exemplars[i] if exemplars else None))
    lines.append(render_sample(
        f"{name}_bucket", {**labels, "le": "+Inf"}, snap["inf"]
    ) + render_exemplar_suffix(exemplars[-1] if exemplars else None))
    lines.append(render_sample(f"{name}_sum", labels, snap["sum"]))
    lines.append(render_sample(f"{name}_count", labels, snap["count"]))
    return lines


def render_histogram(name: str, help_text: str, hist: Histogram,
                     labels: Optional[dict] = None) -> list[str]:
    return render_header(name, help_text, "histogram") \
        + render_histogram_samples(name, labels or {}, hist)


class Counter:
    """Monotonic counter, optionally labeled. Label children are created
    lazily on first `inc` with that label set."""

    metric_type = "counter"

    def __init__(self, name: str, help_text: str,
                 labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help_text = help_text
        self.labelnames = tuple(labelnames)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            # polylint: disable=ML002(prometheus-client contract: label-set cardinality is a declared operator responsibility, the label vocab is static)
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0)

    def render(self) -> list[str]:
        lines = render_header(self.name, self.help_text, self.metric_type)
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0)]           # unlabeled counters always expose
        for key, value in items:
            lines.append(render_sample(
                self.name, dict(zip(self.labelnames, key)), value
            ))
        return lines


class Gauge(Counter):
    """Settable gauge; `fn` makes it a callback gauge evaluated at scrape
    time (live engine state without a background sampler thread)."""

    metric_type = "gauge"

    def __init__(self, name: str, help_text: str,
                 labelnames: tuple[str, ...] = (),
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help_text, labelnames)
        self._fn = fn

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def render(self) -> list[str]:
        if self._fn is not None:
            return render_header(
                self.name, self.help_text, self.metric_type
            ) + [render_sample(self.name, {}, self._fn())]
        return super().render()


class HistogramMetric:
    """Named wrapper binding a math `Histogram` (possibly owned elsewhere,
    e.g. EngineMetrics) into a registry."""

    def __init__(self, name: str, help_text: str,
                 hist: Optional[Histogram] = None, buckets=None):
        self.name = name
        self.help_text = help_text
        self.hist = hist if hist is not None else Histogram(buckets)

    def observe(self, value: float) -> None:
        self.hist.observe(value)

    def render(self) -> list[str]:
        return render_histogram(self.name, self.help_text, self.hist)


class Registry:
    """Scrape-time composition root. Metrics register once; `render()`
    walks them plus any callback collectors (functions returning raw
    exposition lines) and joins the full page."""

    def __init__(self):
        self._metrics: list = []
        self._collectors: list[Callable[[], list[str]]] = []
        self._names: set[str] = set()
        self._lock = threading.Lock()

    def register(self, metric) -> None:
        with self._lock:
            if metric.name in self._names:
                raise ValueError(f"duplicate metric name {metric.name!r}")
            # polylint: disable=ML002(registration is import/startup-time only: bounded by metric definitions in the codebase)
            self._names.add(metric.name)
            # polylint: disable=ML002(registration is import/startup-time only: bounded by metric definitions in the codebase)
            self._metrics.append(metric)

    def get(self, name: str):
        """The registered metric with this name, or None."""
        with self._lock:
            for metric in self._metrics:
                if metric.name == name:
                    return metric
        return None

    def get_or_create(self, factory, name: str, *args, **kwargs):
        """Atomic get-or-register: returns (metric, created). `factory`
        is the metric class (Counter/Gauge/HistogramMetric), constructed
        with (name, *args, **kwargs) only if the name is free — the
        idempotent registration shared registries need (several servers
        or services over one Observability must not race the check)."""
        with self._lock:
            for metric in self._metrics:
                if metric.name == name:
                    return metric, False
            metric = factory(name, *args, **kwargs)
            self._names.add(name)
            self._metrics.append(metric)
            return metric, True

    def counter(self, name: str, help_text: str,
                labelnames: tuple[str, ...] = ()) -> Counter:
        c = Counter(name, help_text, labelnames)
        self.register(c)
        return c

    def gauge(self, name: str, help_text: str,
              labelnames: tuple[str, ...] = (),
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = Gauge(name, help_text, labelnames, fn=fn)
        self.register(g)
        return g

    def histogram(self, name: str, help_text: str,
                  hist: Optional[Histogram] = None,
                  buckets=None) -> HistogramMetric:
        h = HistogramMetric(name, help_text, hist, buckets)
        self.register(h)
        return h

    def register_collector(self, fn: Callable[[], list[str]]) -> None:
        with self._lock:
            # polylint: disable=ML002(registration is import/startup-time only: bounded by collector definitions in the codebase)
            self._collectors.append(fn)

    def render(self, openmetrics: bool = False) -> str:
        with self._lock:
            metrics = list(self._metrics)
            collectors = list(self._collectors)
        lines: list[str] = []
        with _render_mode(openmetrics):
            for metric in metrics:
                lines.extend(metric.render())
            for fn in collectors:
                lines.extend(fn())
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"
