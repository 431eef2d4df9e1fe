"""Per-RPC structured logging + tracing interceptor (the JAX package's
gateway/interceptor.py).

Parity with the reference's unary logging interceptor
(cmd/polykey/main.go:25-52): health checks are not logged,
every other RPC gets a "gRPC call received" line on entry and a
"gRPC call finished" line with Go-style duration and status-code name on exit
(ERROR level when the RPC failed). Extended to server-streaming methods, which
the reference does not have.

Beyond the reference: every logged RPC carries a ``trace_id`` —
honored from the client's ``x-trace-id`` request metadata when present,
minted otherwise — which is echoed back in trailing metadata so clients can
quote it in bug reports and correlate their logs with ours. When the
interceptor is built with an `Observability` bundle it also opens the
request's ROOT span, publishes it thread-locally for the service layer to
attach engine child spans to, and files the finished tree in the flight
recorder; per-method, per-code RPC counters feed the /metrics endpoint.
"""

from __future__ import annotations

import re
import time

import grpc

from ..obs import Counter, new_trace_id, set_current_span
from .jsonlog import Logger, go_duration

_TRACE_ID_KEY = "x-trace-id"

_SKIP_METHODS = frozenset({"/grpc.health.v1.Health/Check"})

# gRPC status-code names as Go's codes.Code.String() renders them — the
# log-beautifier treats anything but "OK" as a failure.
_GO_CODE_NAMES = {
    grpc.StatusCode.OK: "OK",
    grpc.StatusCode.CANCELLED: "Canceled",
    grpc.StatusCode.UNKNOWN: "Unknown",
    grpc.StatusCode.INVALID_ARGUMENT: "InvalidArgument",
    grpc.StatusCode.DEADLINE_EXCEEDED: "DeadlineExceeded",
    grpc.StatusCode.NOT_FOUND: "NotFound",
    grpc.StatusCode.ALREADY_EXISTS: "AlreadyExists",
    grpc.StatusCode.PERMISSION_DENIED: "PermissionDenied",
    grpc.StatusCode.RESOURCE_EXHAUSTED: "ResourceExhausted",
    grpc.StatusCode.FAILED_PRECONDITION: "FailedPrecondition",
    grpc.StatusCode.ABORTED: "Aborted",
    grpc.StatusCode.OUT_OF_RANGE: "OutOfRange",
    grpc.StatusCode.UNIMPLEMENTED: "Unimplemented",
    grpc.StatusCode.INTERNAL: "Internal",
    grpc.StatusCode.UNAVAILABLE: "Unavailable",
    grpc.StatusCode.DATA_LOSS: "DataLoss",
    grpc.StatusCode.UNAUTHENTICATED: "Unauthenticated",
}


class _RecordingContext:
    """ServicerContext proxy that remembers the status code the handler
    set, and MERGES trailing metadata across callers: grpc's
    set_trailing_metadata replaces wholesale, so the handler layer
    attaching a retry-after-ms hint must not clobber the interceptor's
    x-trace-id echo (or vice versa). Last value per key wins."""

    def __init__(self, context):
        self._ctx = context
        self.recorded_code = None
        self._trailing: dict[str, str] = {}

    def set_trailing_metadata(self, metadata):
        for key, value in metadata:
            self._trailing[key] = value
        return self._ctx.set_trailing_metadata(tuple(self._trailing.items()))

    def set_code(self, code):
        self.recorded_code = code
        return self._ctx.set_code(code)

    def abort(self, code, details):
        self.recorded_code = code
        return self._ctx.abort(code, details)

    def abort_with_status(self, status):
        self.recorded_code = status.code
        return self._ctx.abort_with_status(status)

    def __getattr__(self, name):
        return getattr(self._ctx, name)


def _code_name(rec: _RecordingContext, error: BaseException | None) -> str:
    if rec.recorded_code is not None:
        return _GO_CODE_NAMES.get(rec.recorded_code, str(rec.recorded_code))
    if error is not None:
        return "Unknown"
    return "OK"


_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def _incoming_trace_id(context) -> str | None:
    """Client-supplied trace id, validated: it fans out to trailers,
    every log line, and every span of the recorded tree, so a hostile or
    buggy client must not get to inject multi-KB blobs or log-breaking
    characters — anything outside 1-64 [A-Za-z0-9_-] chars is ignored
    and a fresh id minted instead."""
    try:
        metadata = context.invocation_metadata() or ()
    except Exception:
        # In-process stubs and test doubles may not implement
        # invocation_metadata; a fresh trace id is minted downstream.
        return None
    for key, value in metadata:
        if key == _TRACE_ID_KEY and isinstance(value, str) \
                and _TRACE_ID_RE.match(value):
            return value
    return None


class LoggingInterceptor(grpc.ServerInterceptor):
    def __init__(self, logger: Logger, obs=None):
        self._logger = logger
        self._obs = obs
        self._rpc_counter: Counter | None = None
        if obs is not None:
            # Shared registries (one obs across several servers in-process,
            # as tests do) reuse the existing family instead of colliding.
            self._rpc_counter, _ = obs.registry.get_or_create(
                Counter,
                "polykey_rpcs_total",
                "RPCs handled, by method and status code.",
                ("method", "code"),
            )

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        method = handler_call_details.method
        if handler is None or method in _SKIP_METHODS:
            return handler

        if handler.unary_unary is not None:
            return grpc.unary_unary_rpc_method_handler(
                self._wrap_unary(handler.unary_unary, method),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.unary_stream is not None:
            return grpc.unary_stream_rpc_method_handler(
                self._wrap_stream(handler.unary_stream, method),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        return handler

    def _begin(self, method: str, context):
        """Common RPC entry: resolve the trace id (client-supplied or
        minted), echo it in trailing metadata, open + publish the root
        span, log the received line. Returns (trace_id, span)."""
        trace_id = _incoming_trace_id(context) or new_trace_id()
        try:
            context.set_trailing_metadata(((_TRACE_ID_KEY, trace_id),))
        except Exception:
            pass  # context may not support trailers (in-process stubs)
        span = None
        if self._obs is not None:
            span = self._obs.tracer.start(method, trace_id=trace_id)
            set_current_span(span)
        self._logger.info(
            "gRPC call received", method=method, trace_id=trace_id
        )
        return trace_id, span

    def _finish(self, method: str, start: float, code: str,
                trace_id: str, span) -> None:
        level = "INFO" if code == "OK" else "ERROR"
        self._logger.log(
            level,
            "gRPC call finished",
            method=method,
            duration=go_duration(time.monotonic() - start),
            code=code,
            trace_id=trace_id,
        )
        if self._rpc_counter is not None:
            self._rpc_counter.inc(method=method, code=code)
        if span is not None:
            span.set(code=code)
            span.finish()
            # Record only traces that carry structure (engine child
            # spans) or a failure: a dashboard polling engine_stats every
            # few seconds would otherwise fill the recorder's ring and
            # evict the llm_generate trees a postmortem needs — the
            # moment the tool is used would be the moment it destroys
            # its own data. Childless OK RPCs still get counters, log
            # lines, and the trailing trace-id echo.
            if span.children or code != "OK":
                self._obs.tracer.finish_and_record(span)
            set_current_span(None)

    def _wrap_unary(self, behavior, method):
        def wrapped(request, context):
            start = time.monotonic()
            # The recording proxy wraps BEFORE _begin so the trace-id
            # trailer lands in its merge map; handler-set trailers
            # (retry-after-ms) then add to it instead of replacing it.
            rec = _RecordingContext(context)
            trace_id, span = self._begin(method, rec)
            try:
                response = behavior(request, rec)
            except BaseException as e:
                self._finish(method, start, _code_name(rec, e), trace_id, span)
                raise
            self._finish(method, start, _code_name(rec, None), trace_id, span)
            return response

        return wrapped

    def _wrap_stream(self, behavior, method):
        def wrapped(request, context):
            start = time.monotonic()
            rec = _RecordingContext(context)
            trace_id, span = self._begin(method, rec)
            try:
                yield from behavior(request, rec)
            except BaseException as e:
                self._finish(method, start, _code_name(rec, e), trace_id, span)
                raise
            self._finish(method, start, _code_name(rec, None), trace_id, span)

        return wrapped
