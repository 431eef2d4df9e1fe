"""Serving metrics: the north-star counters (tok/s, TTFT) plus engine gauges.

Request phase timestamps (enqueue → prefill → first token → finish),
throughput and occupancy counters, padding waste, and the lookahead
pipeline's observed lookahead and host stall per processed block. Snapshots surface through the `engine_stats` tool and
per-request Usage on the streaming RPC.

TTFT and inter-token latency are histogram-backed (obs.histogram): fixed
log-spaced buckets give O(1)-memory p50/p95/p99 over the full history.

The host-KV tier's page faults, spills and restores (with the restore
latency histogram) are always in the snapshot, 0 with the tier off.
Speculative rounds add the drafts accepted and proposed and their ratio,
`spec_acceptance`, once a round has proposed any.

Device-time attribution (the reference's): each processed block's
device-busy window, the host gap before its dispatch minus the host stall
its readback cost, is split across the lanes live at dispatch into each
request's `device_ms`. An EWMA of per-request service time (admission to
finish) sizes the admission's estimated queue delay and the shed's
retry hint. Histogram observations carry the request's trace id as the
bucket's exemplar (obs/histogram.py).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..obs.histogram import Histogram

# Bucket bounds for the live-lanes-per-block histogram: lane counts are
# small integers bounded by max_decode_slots (the reference's ladder).
LANE_BUCKETS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
                384, 512)


@dataclass
class RequestTimings:
    enqueued: float = field(default_factory=time.monotonic)
    prefill_start: float = 0.0
    first_token: float = 0.0
    finished: float = 0.0
    prompt_tokens: int = 0
    completion_tokens: int = 0
    # The request's share of every decode block's device-busy window
    # (engine thread only).
    device_ms: float = 0.0

    @property
    def ttft_ms(self) -> float:
        if self.first_token and self.enqueued:
            return (self.first_token - self.enqueued) * 1e3
        return 0.0

    @property
    def tokens_per_sec(self) -> float:
        if self.finished and self.first_token and self.completion_tokens > 1:
            elapsed = self.finished - self.first_token
            if elapsed > 0:
                return (self.completion_tokens - 1) / elapsed
        return 0.0


class EngineMetrics:
    """Thread-safe counters; cheap enough to update from the step loop."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_admitted = 0
        self.requests_completed = 0
        self.requests_failed = 0
        self.tokens_generated = 0
        self.decode_steps = 0
        self.ttft_ms_sum = 0.0
        self.ttft_ms_count = 0
        # observe() is internally locked; kept outside self._lock so a
        # snapshot reading them never contends the step loop's counter lock.
        self.ttft_hist = Histogram()
        self.itl_hist = Histogram()
        # Overload accounting: sheds at admission, deadline expiries by phase.
        self.requests_shed = 0
        self.deadline_expired = {"queued": 0, "prefill": 0, "decode": 0}
        # EWMA of per-request service time (admission → finish), the input
        # to the estimated-queue-delay admission check: with S slots
        # draining in parallel, one queued request waits roughly
        # qsize × ewma / S. 0.0 until the first finish.
        self._service_ewma_s = 0.0
        self._window_start = time.monotonic()
        self._window_tokens = 0
        self.tokens_per_sec = 0.0
        # Occupancy per dispatched decode block:
        #   blocks_dispatched — decode blocks dispatched
        #   lanes_dispatched  — Σ live lanes at dispatch (block-weighted)
        #   lane_steps        — Σ lanes × steps (step-weighted; what the
        #                       weights' bytes per token amortize over)
        #   steps_dispatched  — Σ steps
        # avg_lanes in snapshots is the step-weighted mean; an EWMA of
        # lanes per block gives the "now" gauge.
        self.blocks_dispatched = 0
        self.lanes_dispatched = 0
        self.lane_steps = 0
        self.steps_dispatched = 0
        self._lanes_ewma = 0.0
        self.lanes_hist = Histogram(bounds=LANE_BUCKETS)
        # Padding waste: token rows the device computed vs rows that were
        # useful work (decode: slots × steps vs lanes × steps; prefill: the
        # padded group width vs the real prompt tokens).
        self.tokens_dispatched_total = 0
        self.tokens_useful_total = 0
        # Interleaved prefill: prefill tokens dispatched in all, and the
        # most in one loop iteration while decode lanes were live (the
        # stall the prefill budget bounds).
        self.prefill_tokens_total = 0
        self.interleave_max_tokens = 0
        # Per processed block: the observed lookahead (0 at depth 1; blocks
        # with 1 or more are `blocks_overlapped`) and the host stall, the
        # ms the host blocked on the block's readback.
        self.blocks_processed = 0
        self.blocks_overlapped = 0
        self.blocks_synced = 0
        self.lookahead_sum = 0
        self.lookahead_max = 0
        self.host_stall_ms_total = 0.0
        self.host_stall_hist = Histogram()
        # Dispatch cadence: host-side gap between consecutive dispatches.
        self.dispatch_gap_ms_total = 0.0
        self.dispatch_gaps = 0
        self._last_dispatch_t = 0.0
        # Device-busy ms charged across blocks (gap − stall, clamped ≥ 0)
        # and the per-request distribution of that charge.
        self.device_busy_ms_total = 0.0
        self.device_ms_hist = Histogram()
        # Host-KV tier: host pages faulted at admission, by kind (a prompt
        # past the largest bucket is "ctx"), pages spilled and restored,
        # and the host wall of each restore.
        self.kv_page_faults = {"prefix": 0, "ctx": 0}
        self.kv_pages_evicted = 0
        self.kv_pages_restored = 0
        self.kv_restore_hist = Histogram()
        # Speculative decoding: drafts accepted and proposed, counted on the
        # device per round (a round cut short by EOS or the cap counts only
        # the drafts that could be emitted).
        self.drafts_accepted = 0
        self.drafts_proposed = 0

    def on_spec(self, accepted: int, proposed: int) -> None:
        """One processed speculative round's accepted and proposed drafts,
        summed over its lanes; their ratio is the speed-up dial."""
        with self._lock:
            self.drafts_accepted += accepted
            self.drafts_proposed += proposed

    def on_kv_fault(self, kind: str, pages: int) -> None:
        """`pages` host-resident pages faulted for one admission (restored
        before its suffix may prefill)."""
        with self._lock:
            self.kv_page_faults[kind] += pages

    def on_kv_evict(self, pages: int) -> None:
        with self._lock:
            self.kv_pages_evicted += pages

    def on_kv_restore(self, pages: int, ms: float,
                      trace_id: Optional[str] = None) -> None:
        with self._lock:
            self.kv_pages_restored += pages
        self.kv_restore_hist.observe(ms, trace_id=trace_id)

    def on_process_block(self, lookahead: int, stall_ms: Optional[float],
                         trace_id: Optional[str] = None) -> None:
        """One block processed with `lookahead` newer blocks already
        dispatched; `stall_ms` is the blocking-readback wall time (None
        for a dead block, whose read was skipped). `trace_id` exemplars
        the stall bucket with a request live in the block."""
        with self._lock:
            self.blocks_processed += 1
            self.blocks_overlapped += lookahead > 0
            self.lookahead_sum += lookahead
            if lookahead > self.lookahead_max:
                self.lookahead_max = lookahead
            if stall_ms is not None:
                self.blocks_synced += 1
                self.host_stall_ms_total += stall_ms
        if stall_ms is not None:
            self.host_stall_hist.observe(stall_ms, trace_id=trace_id)

    def on_device_busy(self, busy_ms: float) -> None:
        """Device-busy ms attributed to one processed block."""
        with self._lock:
            self.device_busy_ms_total += busy_ms

    def on_dispatch_idle(self) -> None:
        """The engine went idle: reset the dispatch-gap clock so the first
        block of the next request is not charged the idle wait."""
        with self._lock:
            self._last_dispatch_t = 0.0

    def on_prefill_interleave(self, tokens: int, decode_live: bool) -> None:
        """Prefill tokens dispatched in one engine-loop iteration;
        `decode_live` marks iterations that had live decode lanes."""
        if tokens <= 0:
            return
        with self._lock:
            self.prefill_tokens_total += tokens
            if decode_live and tokens > self.interleave_max_tokens:
                self.interleave_max_tokens = tokens

    def on_padding_tokens(self, dispatched: int, useful: int) -> None:
        """Token rows computed vs useful for one prefill dispatch."""
        with self._lock:
            self.tokens_dispatched_total += dispatched
            self.tokens_useful_total += useful

    def on_dispatch(self, lanes: int, steps: int, slots: int = 0) -> float:
        """One decode block dispatched with `lanes` live lanes for `steps`
        device steps. Returns the counted dispatch gap in ms (0.0 for the
        first dispatch or an idle-capped gap). `slots` (the static batch
        width) feeds the padding-waste counters."""
        now = time.monotonic()
        counted_gap = 0.0
        with self._lock:
            if slots > 0:
                self.tokens_dispatched_total += slots * steps
                self.tokens_useful_total += lanes * steps
            if self._last_dispatch_t:
                gap_ms = (now - self._last_dispatch_t) * 1e3
                # Idle gaps are load shape, not scheduling cost.
                if gap_ms < 10_000.0:
                    self.dispatch_gap_ms_total += gap_ms
                    self.dispatch_gaps += 1
                    counted_gap = gap_ms
            self._last_dispatch_t = now
            self.blocks_dispatched += 1
            self.lanes_dispatched += lanes
            self.lane_steps += lanes * steps
            self.steps_dispatched += steps
            self._lanes_ewma = (
                float(lanes) if self.blocks_dispatched == 1
                else 0.9 * self._lanes_ewma + 0.1 * lanes
            )
        self.lanes_hist.observe(float(lanes))
        return counted_gap

    def on_admit(self) -> None:
        with self._lock:
            self.requests_admitted += 1

    def on_shed(self) -> None:
        with self._lock:
            self.requests_shed += 1

    def on_deadline_expired(self, phase: str) -> None:
        with self._lock:
            self.deadline_expired[phase] += 1

    def service_time_ewma_s(self) -> float:
        with self._lock:
            return self._service_ewma_s

    def on_step(self, num_tokens: int) -> None:
        with self._lock:
            self.decode_steps += 1
            self.tokens_generated += num_tokens
            self._window_tokens += num_tokens
            now = time.monotonic()
            elapsed = now - self._window_start
            if elapsed >= 1.0:
                self.tokens_per_sec = self._window_tokens / elapsed
                self._window_start = now
                self._window_tokens = 0

    def on_itl(self, gap_ms: float, count: int = 1,
               trace_id: Optional[str] = None) -> None:
        """Record `count` tokens delivered with a per-token gap of `gap_ms`
        (one decode block's inter-emit window amortized over its tokens),
        so a stall between blocks shows in the tail."""
        if gap_ms > 0:
            self.itl_hist.observe(gap_ms, count, trace_id=trace_id)

    def on_finish(self, timings: RequestTimings, failed: bool = False,
                  trace_id: Optional[str] = None) -> None:
        ttft = timings.ttft_ms
        with self._lock:
            if failed:
                self.requests_failed += 1
            else:
                self.requests_completed += 1
                if timings.finished and timings.prefill_start:
                    dur = timings.finished - timings.prefill_start
                    if dur > 0:
                        self._service_ewma_s = (
                            dur if self._service_ewma_s == 0.0
                            else 0.8 * self._service_ewma_s + 0.2 * dur
                        )
            if ttft > 0:
                self.ttft_ms_sum += ttft
                self.ttft_ms_count += 1
        if ttft > 0:
            self.ttft_hist.observe(ttft, trace_id=trace_id)
        if timings.device_ms > 0:
            self.device_ms_hist.observe(timings.device_ms, trace_id=trace_id)

    def snapshot(self) -> dict:
        with self._lock:
            mean_ttft = (
                self.ttft_ms_sum / self.ttft_ms_count
                if self.ttft_ms_count
                else 0.0
            )
            # The throughput window only advances inside on_step: a window
            # start more than 5 s old means the step loop has gone idle, so
            # the last busy window's rate is stale — decay it and restart
            # the window clean.
            if (
                self.tokens_per_sec > 0.0
                and time.monotonic() - self._window_start > 5.0
            ):
                self.tokens_per_sec = 0.0
                self._window_start = time.monotonic()
                self._window_tokens = 0
            snap = {
                "kv_page_faults_prefix": self.kv_page_faults["prefix"],
                "kv_page_faults_ctx": self.kv_page_faults["ctx"],
                "kv_pages_evicted": self.kv_pages_evicted,
                "kv_pages_restored": self.kv_pages_restored,
                "requests_admitted": self.requests_admitted,
                "requests_completed": self.requests_completed,
                "requests_failed": self.requests_failed,
                "requests_shed": self.requests_shed,
                "deadline_expired_queued": self.deadline_expired["queued"],
                "deadline_expired_prefill": self.deadline_expired["prefill"],
                "deadline_expired_decode": self.deadline_expired["decode"],
                "tokens_generated": self.tokens_generated,
                "decode_steps": self.decode_steps,
                "tokens_per_sec": round(self.tokens_per_sec, 2),
                "mean_ttft_ms": round(mean_ttft, 2),
                "blocks_dispatched": self.blocks_dispatched,
                "lane_steps": self.lane_steps,
                "steps_dispatched": self.steps_dispatched,
                "lanes_ewma": round(self._lanes_ewma, 2),
                "prefill_tokens_total": self.prefill_tokens_total,
                "interleave_max_tokens": self.interleave_max_tokens,
                "tokens_dispatched": self.tokens_dispatched_total,
                "tokens_useful": self.tokens_useful_total,
                "tokens_useful_fraction": (
                    round(self.tokens_useful_total
                          / self.tokens_dispatched_total, 4)
                    if self.tokens_dispatched_total else None
                ),
                "blocks_processed": self.blocks_processed,
                "blocks_overlapped": self.blocks_overlapped,
                "lookahead_observed_max": self.lookahead_max,
                "lookahead_observed_mean": (
                    round(self.lookahead_sum / self.blocks_processed, 2)
                    if self.blocks_processed else 0.0
                ),
                "host_stall_ms_total": round(self.host_stall_ms_total, 2),
                "dispatch_gap_ms_total": round(self.dispatch_gap_ms_total, 2),
                "device_busy_ms_total": round(self.device_busy_ms_total, 2),
                # Device-busy share of inter-dispatch wall time (busy = gap
                # − stall): how device-bound the recorded schedule is.
                "device_busy_fraction": (
                    round(self.device_busy_ms_total
                          / self.dispatch_gap_ms_total, 4)
                    if self.dispatch_gap_ms_total else 0.0
                ),
            }
            if self.steps_dispatched:
                snap["avg_lanes"] = round(
                    self.lane_steps / self.steps_dispatched, 2
                )
            if self.drafts_proposed:
                snap["drafts_accepted"] = self.drafts_accepted
                snap["drafts_proposed"] = self.drafts_proposed
                snap["spec_acceptance"] = round(
                    self.drafts_accepted / self.drafts_proposed, 3
                )
        if self.ttft_hist.count:
            p50, p95, p99 = self.ttft_hist.percentiles(50, 95, 99)
            snap["ttft_ms_p50"] = round(p50, 2)
            snap["ttft_ms_p95"] = round(p95, 2)
            snap["ttft_ms_p99"] = round(p99, 2)
        if self.itl_hist.count:
            p50, p95, p99 = self.itl_hist.percentiles(50, 95, 99)
            snap["itl_ms_p50"] = round(p50, 2)
            snap["itl_ms_p95"] = round(p95, 2)
            snap["itl_ms_p99"] = round(p99, 2)
        if self.host_stall_hist.count:
            p50, p95 = self.host_stall_hist.percentiles(50, 95)
            snap["host_stall_ms_p50"] = round(p50, 2)
            snap["host_stall_ms_p95"] = round(p95, 2)
        if self.device_ms_hist.count:
            p50, p95 = self.device_ms_hist.percentiles(50, 95)
            snap["request_device_ms_p50"] = round(p50, 2)
            snap["request_device_ms_p95"] = round(p95, 2)
        if self.kv_restore_hist.count:
            p50, p95 = self.kv_restore_hist.percentiles(50, 95)
            snap["kv_restore_ms_p50"] = round(p50, 2)
            snap["kv_restore_ms_p95"] = round(p95, 2)
        return snap
