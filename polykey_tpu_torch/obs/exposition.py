"""Prometheus exposition endpoint + the engine scrape collector (the
reference's polykey_tpu/obs/exposition.py, for a bare engine).

A stdlib ``http.server`` thread on the gateway serving:

- ``GET /metrics`` — the registry's full text page. A scraper sending
  ``Accept: application/openmetrics-text`` gets the OpenMetrics
  rendering: same families plus per-bucket exemplars carrying the
  ``trace_id`` of a recent request in that bucket (TTFT / ITL /
  host-stall / device-ms), so a p99 bucket links straight to its
  recorded span tree in the flight recorder.
- ``GET /healthz`` — 200 "ok" (container-level liveness probes that
  can't speak gRPC health).
- ``GET /debug/*`` — the read-only flight-deck surface, served ONLY
  while ``POLYKEY_DEBUG_ENDPOINTS=1``: engine stats JSON, the Perfetto
  timeline export, the flight recorder, a single trace by id, and the
  single-flight profiler trigger. See `DebugSurface`.

The engine collector snapshots `InferenceEngine` state at scrape time —
no background sampler, no per-step bookkeeping beyond what
`EngineMetrics` already does; `stats()` reads host state only, so a
scrape never waits on the device. The replica-pool, disaggregated-pool,
SLO and autopilot families come with those modules (ROADMAP.md A.9, A.10).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from .prometheus import (
    CONTENT_TYPE,
    CONTENT_TYPE_OPENMETRICS,
    Registry,
    render_counter,
    render_header,
    render_histogram_samples,
    render_sample,
)


# The engine metric families (the reference's names, types and labels),
# rendered from `engine.stats()` snapshots (counters/gauges) and the
# EngineMetrics histograms. kind ∈ {counter, gauge, hist, phases,
# kvfaults}; `key` indexes the stats snapshot, hist entries name the
# EngineMetrics attribute instead.
_ENGINE_FAMILIES: tuple = (
    ("counter", "polykey_requests_admitted_total",
     "Requests accepted into the engine queue.", "requests_admitted"),
    ("counter", "polykey_requests_completed_total",
     "Requests finished successfully.", "requests_completed"),
    ("counter", "polykey_requests_failed_total",
     "Requests finished with an error (includes cancellations: "
     "stop-sequence matches and client disconnects).", "requests_failed"),
    ("counter", "polykey_requests_shed_total",
     "Requests rejected at admission (queue bound or "
     "estimated-delay check) with RESOURCE_EXHAUSTED.", "requests_shed"),
    # One family, one sample per expiry phase: queued (dropped at
    # dequeue, never prefilled), prefill (mid-chunked-prefill),
    # decode (block-boundary drop).
    ("phases", "polykey_deadline_expired_total",
     "Requests dropped because their deadline passed, by phase.", None),
    ("counter", "polykey_decode_tokens_total",
     "Tokens emitted by the decode loop.", "tokens_generated"),
    ("counter", "polykey_decode_steps_total",
     "Decode blocks processed.", "decode_steps"),
    ("gauge", "polykey_active_requests",
     "Requests currently holding a decode slot.", "slots_busy"),
    ("gauge", "polykey_queue_depth",
     "Requests waiting for admission.", "queued"),
    ("gauge", "polykey_pages_free",
     "Free KV pages in the block allocator.", "pages_free"),
    ("gauge", "polykey_pages_total",
     "Total KV pages in the pool.", "pages_total"),
    ("gauge", "polykey_tokens_per_sec",
     "Decode throughput over the last ~1s window.", "tokens_per_sec"),
    # Occupancy tracker: measured live-lane accounting — the
    # counters avg_lanes derives from (lane_steps / steps), the EWMA
    # "now" gauge, and the per-block distribution.
    ("counter", "polykey_dispatched_blocks_total",
     "Decode blocks / spec rounds dispatched.", "blocks_dispatched"),
    ("counter", "polykey_dispatched_steps_total",
     "Device decode steps dispatched (spec rounds weigh gamma+1).",
     "steps_dispatched"),
    ("counter", "polykey_lane_steps_total",
     "Live-lane-steps dispatched (sum of lanes x steps per block); "
     "divided by polykey_dispatched_steps_total gives measured "
     "average occupancy.", "lane_steps"),
    ("gauge", "polykey_live_lanes",
     "EWMA of live decode lanes per dispatched block.", "lanes_ewma"),
    ("gauge", "polykey_decode_slots",
     "Configured decode slots (occupancy denominator).", "slots_total"),
    ("counter", "polykey_prefill_tokens_total",
     "Prefill tokens dispatched (bucket groups + chunks).",
     "prefill_tokens_total"),
    ("gauge", "polykey_prefill_interleave_max_tokens",
     "Worst single-iteration prefill injection while decode lanes "
     "were live (bounded by the prefill budget + one dispatch).",
     "interleave_max_tokens"),
    ("hist", "polykey_live_lanes_per_block",
     "Live decode lanes at block dispatch.", "lanes_hist"),
    # Lookahead dispatch pipeline: how deep the dispatch
    # frontier runs ahead of the processed frontier, and what the host
    # pays when it fails to (DEPLOY.md "diagnosing host-bound decode").
    ("gauge", "polykey_dispatch_inflight",
     "Decode blocks dispatched but not yet processed (the "
     "in-flight lookahead queue).", "inflight_blocks"),
    ("gauge", "polykey_dispatch_lookahead_depth",
     "Configured lookahead depth (POLYKEY_DISPATCH_LOOKAHEAD; "
     "1 = synchronous dispatch-then-read).", "lookahead_depth"),
    ("hist", "polykey_host_stall_ms",
     "Time _process_step blocked waiting for a block's D2H "
     "readback to land, ms (~0 when the lookahead pipeline hides "
     "the roundtrip).", "host_stall_hist"),
    # Device-time attribution: per-block device-busy
    # (dispatch gap minus host stall) apportioned to the lanes live in
    # that block, accumulated per request — wall time split into
    # device vs host from the recorded schedule.
    ("gauge", "polykey_device_busy_fraction",
     "Fraction of inter-dispatch wall time attributed to device "
     "compute (cumulative: device-busy ms / dispatch-gap ms).",
     "device_busy_fraction"),
    ("hist", "polykey_request_device_ms",
     "Per-request device time, ms: each block's device-busy window "
     "(dispatch gap minus host stall) split across its live lanes.",
     "device_ms_hist"),
    ("hist", "polykey_ttft_ms",
     "Time to first token (enqueue to first emit), ms.", "ttft_hist"),
    ("hist", "polykey_itl_ms",
     "Inter-token gap, ms (per decode block, amortized per token).",
     "itl_hist"),
    # Host-memory KV tier: cold-page offload/restore
    # accounting. Families render (at 0) on tier-less engines too, so
    # dashboards exist before the tier is turned on.
    ("kvfaults", "polykey_kv_page_faults_total",
     "Prefix-cache hits on HOST-resident pages, by kind: prefix "
     "(sticky short-prompt session resuming off spilled pages), ctx "
     "(a long-context prompt's middle pages paging back in).", None),
    ("counter", "polykey_kv_pages_evicted_total",
     "Cold pages spilled from the device pool to the host tier.",
     "kv_pages_evicted"),
    ("gauge", "polykey_kv_host_pages",
     "KV pages currently resident in the host tier.", "kv_host_pages"),
    ("gauge", "polykey_kv_device_pages",
     "Device pool pages in use by slots/prefix cache (reserved "
     "garbage page excluded).", "kv_device_pages"),
    ("hist", "polykey_kv_restore_ms",
     "Per-fault restore latency, ms: host gather + upload + scatter "
     "dispatch for one faulting slot's pages.", "kv_restore_hist"),
)

_SPEC_FAMILIES: tuple = (
    ("polykey_spec_drafts_proposed_total",
     "Speculative draft tokens proposed.", "drafts_proposed"),
    ("polykey_spec_drafts_accepted_total",
     "Speculative draft tokens accepted.", "drafts_accepted"),
)


def engine_collector(engine_or_provider):
    """Scrape-time collector over a live InferenceEngine: counters and
    gauges come from `stats()` snapshots (the public surface, so a rename
    of engine internals can't 500 the scrape); the latency families read
    the EngineMetrics histograms directly — part of its public contract.

    Accepts either the engine or a zero-arg provider returning one — a
    supervised restart (engine/supervisor.py) swaps the live engine out
    from under the registry, and the scrape must follow to the fresh
    instance instead of reading the corpse forever."""

    def collect() -> list[str]:
        engine = (
            engine_or_provider()
            if callable(engine_or_provider) else engine_or_provider
        )
        snap = engine.stats()
        lines: list[str] = []
        for kind, name, help_text, key in _ENGINE_FAMILIES:
            if kind == "phases":
                lines += render_header(name, help_text, "counter")
                for phase in ("queued", "prefill", "decode"):
                    lines.append(render_sample(
                        name, {"phase": phase},
                        snap[f"deadline_expired_{phase}"],
                    ))
            elif kind == "kvfaults":
                lines += render_header(name, help_text, "counter")
                for fault_kind in ("prefix", "ctx"):
                    lines.append(render_sample(
                        name, {"kind": fault_kind},
                        snap.get(f"kv_page_faults_{fault_kind}", 0),
                    ))
            elif kind == "hist":
                lines += render_header(name, help_text, "histogram")
                lines += render_histogram_samples(
                    name, {}, getattr(engine.metrics, key)
                )
            else:
                lines += render_header(name, help_text, kind)
                lines.append(render_sample(name, {}, snap[key]))
        if snap.get("drafts_proposed"):
            for name, help_text, key in _SPEC_FAMILIES:
                lines += render_counter(name, help_text, snap[key])
        if snap.get("spec_gamma") is not None:
            # Per-lane dial aggregates: the families carry a `stat` label
            # (mean/min/max over occupied lanes). Present whenever spec is
            # configured — operators watch the dial before traffic
            # proposes anything.
            for name, help_text, prefix in (
                ("polykey_spec_gamma",
                 "Per-lane speculative gamma dial, aggregated over "
                 "occupied lanes (stat: mean/min/max).", "spec_gamma"),
                ("polykey_spec_accept_rate",
                 "Per-lane draft acceptance EWMA, aggregated over "
                 "occupied lanes (stat: mean/min/max).",
                 "spec_accept_ewma"),
            ):
                lines += render_header(name, help_text, "gauge")
                for stat in ("mean", "min", "max"):
                    lines.append(render_sample(
                        name, {"stat": stat}, snap[f"{prefix}_{stat}"],
                    ))
        return lines

    return collect


class DebugSurface:
    """Read-only flight-deck endpoints, mounted on the
    metrics HTTP server and gated by ``POLYKEY_DEBUG_ENDPOINTS=1``:

    - ``/debug/engine``        — engine_stats snapshot as JSON
    - ``/debug/timeline``      — Perfetto/Chrome-trace export of the
      engine timeline
    - ``/debug/flight``        — flight-recorder span trees + events
    - ``/debug/trace/<id>``    — one recorded span tree by trace id
    - ``/debug/profile?seconds=N`` — blocking single-flight
      torch.profiler capture; 409 while another capture runs

    The gate is re-read per request (no enabled override), so an
    operator can flip the env on a live process without a restart being
    required for the "disabled ⇒ 404" contract to hold. Everything here
    is read-only except the profiler trigger, which writes only to its
    own artifact directory.
    """

    def __init__(self, engine_provider=None, obs=None, profiler=None,
                 enabled: Optional[bool] = None):
        self.engine_provider = engine_provider
        self.obs = obs
        self.profiler = profiler
        self.enabled = enabled          # None → read the env per request

    def _enabled_now(self) -> bool:
        if self.enabled is not None:
            return self.enabled
        return os.environ.get("POLYKEY_DEBUG_ENDPOINTS", "") == "1"

    def _engine(self):
        return self.engine_provider() if self.engine_provider else None

    def handle(self, path: str, query: str) -> tuple[int, str, bytes]:
        """Route one /debug request. Returns (status, content_type,
        body); unknown paths and the disabled state are both 404 — a
        gated-off surface must be indistinguishable from an absent one."""
        if not self._enabled_now():
            return 404, "text/plain", b"not found\n"
        try:
            return self._route(path, query)
        except Exception as e:
            # A debug endpoint must never take the metrics server down,
            # and an opaque 500 defeats its whole purpose.
            return 500, "text/plain", f"debug error: {e}\n".encode()

    def _route(self, path: str, query: str) -> tuple[int, str, bytes]:
        if path == "/debug/engine":
            engine = self._engine()
            if engine is None:
                return 404, "text/plain", b"no engine wired\n"
            return 200, "application/json", _json_bytes(engine.stats())
        if path == "/debug/timeline":
            engine = self._engine()
            if engine is None:
                return 404, "text/plain", b"no engine wired\n"
            from .timeline import engine_timelines, to_perfetto

            trace = to_perfetto(
                engine_timelines(engine),
                meta={"source": "polykey /debug/timeline"},
            )
            return 200, "application/json", _json_bytes(trace)
        if path == "/debug/flight":
            if self.obs is None:
                return 404, "text/plain", b"no recorder wired\n"
            return 200, "application/json", _json_bytes({
                "traces": self.obs.recorder.traces(),
                "events": self.obs.recorder.events(),
            })
        if path.startswith("/debug/trace/"):
            if self.obs is None:
                return 404, "text/plain", b"no recorder wired\n"
            trace_id = path[len("/debug/trace/"):]
            for trace in reversed(self.obs.recorder.traces()):
                if trace.get("trace_id") == trace_id:
                    return 200, "application/json", _json_bytes(trace)
            return 404, "text/plain", b"trace not found (ring evicted?)\n"
        if path == "/debug/profile":
            if self.profiler is None:
                return 404, "text/plain", b"no profiler wired\n"
            from .profiler import ProfilerBusyError

            try:
                seconds = float(parse_qs(query).get("seconds", ["2"])[0])
            except ValueError:
                return 400, "text/plain", b"seconds must be a number\n"
            try:
                result = self.profiler.capture(seconds)
            except ProfilerBusyError as e:
                return 409, "text/plain", f"{e}\n".encode()
            return 200, "application/json", _json_bytes(result)
        return 404, "text/plain", b"unknown debug endpoint\n"


def _json_bytes(obj) -> bytes:
    return (json.dumps(obj, indent=1, default=str) + "\n").encode()


class _Handler(BaseHTTPRequestHandler):
    registry: Registry = None  # set by MetricsHTTPServer subclassing
    debug: Optional[DebugSurface] = None

    def do_GET(self):  # noqa: N802 (http.server API)
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            # Content negotiation: only an explicit OpenMetrics Accept
            # gets the exemplar rendering; everyone else keeps the
            # byte-stable classic page.
            openmetrics = "application/openmetrics-text" in (
                self.headers.get("Accept") or ""
            )
            try:
                body = self.registry.render(openmetrics=openmetrics).encode()
            except Exception as e:  # a broken collector must not 500 opaquely
                self.send_response(500)
                self.end_headers()
                self.wfile.write(f"collector error: {e}\n".encode())
                return
            self.send_response(200)
            self.send_header(
                "Content-Type",
                CONTENT_TYPE_OPENMETRICS if openmetrics else CONTENT_TYPE,
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/healthz":
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.end_headers()
            self.wfile.write(b"ok\n")
        elif path.startswith("/debug/") and self.debug is not None:
            status, ctype, body = self.debug.handle(path, query)
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(404)
            self.end_headers()
            self.wfile.write(b"try /metrics\n")

    def log_message(self, *args) -> None:
        pass  # scrapes are high-frequency noise; the JSON log stays clean


class MetricsHTTPServer:
    """Daemon-thread exposition server. `port=0` binds an ephemeral port
    (tests / smoke); `.port` reports the bound one. Passing a
    `DebugSurface` mounts the /debug flight-deck routes (still gated by
    POLYKEY_DEBUG_ENDPOINTS at request time)."""

    def __init__(self, registry: Registry, host: str = "0.0.0.0",
                 port: int = 9464, debug: Optional[DebugSurface] = None):
        handler = type("BoundHandler", (_Handler,),
                       {"registry": registry, "debug": debug})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="polykey-metrics",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
