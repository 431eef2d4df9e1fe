"""Observability (the reference's polykey_tpu/obs): request tracing,
latency histograms, Prometheus export, the engine timeline and the
torch.profiler trigger.

Every serving component reports into one `Observability` bundle —

- `registry` — Prometheus metrics, rendered by the /metrics endpoint
  and the `engine_stats` tool's ``metrics_text`` view;
- `tracer` + `recorder` — per-request span trees (root opened by the
  gRPC interceptor, children recorded by the engine) kept in a bounded
  flight recorder for postmortems.

Everything here is host-side Python and cheap enough to stay on in
production. The disaggregated pool adds cross-process clock alignment
(`ClockSync`), the merged timeline (`merge_timelines`) and crash-durable
black boxes with their postmortem (`BlackBox`, `load_blackboxes`,
`merged_perfetto`; ``python -m polykey_tpu_torch.obs.postmortem``).
"""

from .clocks import ClockSync
from .exposition import DebugSurface, MetricsHTTPServer, engine_collector
from .histogram import DEFAULT_MS_BUCKETS, Histogram, log_buckets
from .postmortem import BlackBox, load_blackboxes, merged_perfetto
from .profiler import ProfilerBusyError, ProfilerCapture
from .prometheus import (
    CONTENT_TYPE,
    CONTENT_TYPE_OPENMETRICS,
    Counter,
    Gauge,
    HistogramMetric,
    Registry,
    render_counter,
    render_gauge,
    render_histogram,
)
from .timeline import (
    TimelineRecorder,
    engine_timelines,
    merge_timelines,
    to_perfetto,
)
from .trace import (
    FlightRecorder,
    Span,
    Tracer,
    current_span,
    new_trace_id,
    set_current_span,
)


class Observability:
    """Composition root shared by the gateway and its backend."""

    def __init__(self, recorder_capacity: int = 64):
        self.registry = Registry()
        self.recorder = FlightRecorder(capacity=recorder_capacity)
        self.tracer = Tracer(self.recorder)


__all__ = [
    "BlackBox",
    "CONTENT_TYPE",
    "CONTENT_TYPE_OPENMETRICS",
    "ClockSync",
    "Counter",
    "DEFAULT_MS_BUCKETS",
    "DebugSurface",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "HistogramMetric",
    "MetricsHTTPServer",
    "Observability",
    "ProfilerBusyError",
    "ProfilerCapture",
    "Registry",
    "Span",
    "TimelineRecorder",
    "Tracer",
    "current_span",
    "engine_collector",
    "engine_timelines",
    "load_blackboxes",
    "log_buckets",
    "merge_timelines",
    "merged_perfetto",
    "new_trace_id",
    "render_counter",
    "render_gauge",
    "render_histogram",
    "set_current_span",
    "to_perfetto",
]
