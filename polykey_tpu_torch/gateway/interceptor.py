"""Per-RPC structured logging interceptor (the logging part of the
reference's gateway/interceptor.py).

Parity with the reference's unary logging interceptor
(cmd/polykey/main.go:25-52): health checks are not logged, every other RPC
gets a "gRPC call received" line on entry and a "gRPC call finished" line
with Go-style duration and status-code name on exit (ERROR level when the
RPC failed). Server-streaming methods are covered too. Every logged RPC
carries a ``trace_id`` — the client's ``x-trace-id`` metadata when valid,
minted otherwise — echoed back in trailing metadata. Span trees, RPC
counters and the flight recorder are a later slice of the port.
"""

from __future__ import annotations

import os
import re
import time

import grpc

from .jsonlog import Logger, go_duration

_TRACE_ID_KEY = "x-trace-id"
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")
_SKIP_METHODS = frozenset({"/grpc.health.v1.Health/Check"})

# gRPC status-code names as Go's codes.Code.String() renders them.
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


def new_trace_id() -> str:
    return os.urandom(8).hex()


class _RecordingContext:
    """ServicerContext proxy that remembers the status code the handler
    set and MERGES trailing metadata across callers (grpc's
    set_trailing_metadata replaces wholesale). Last value per key wins."""

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


def _code_name(rec: _RecordingContext, error) -> str:
    if rec.recorded_code is not None:
        return _GO_CODE_NAMES.get(rec.recorded_code, str(rec.recorded_code))
    return "Unknown" if error is not None else "OK"


def _incoming_trace_id(context):
    """Client-supplied trace id when it is 1-64 [A-Za-z0-9_-] chars."""
    for key, value in context.invocation_metadata() or ():
        if key == _TRACE_ID_KEY and isinstance(value, str) \
                and _TRACE_ID_RE.match(value):
            return value
    return None


class LoggingInterceptor(grpc.ServerInterceptor):
    def __init__(self, logger: Logger):
        self._logger = logger

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

    def _begin(self, method: str, rec: _RecordingContext) -> str:
        trace_id = _incoming_trace_id(rec) or new_trace_id()
        rec.set_trailing_metadata(((_TRACE_ID_KEY, trace_id),))
        self._logger.info("gRPC call received", method=method, trace_id=trace_id)
        return trace_id

    def _finish(self, method: str, start: float, code: str, trace_id: str) -> None:
        self._logger.log(
            "INFO" if code == "OK" else "ERROR",
            "gRPC call finished",
            method=method,
            duration=go_duration(time.monotonic() - start),
            code=code,
            trace_id=trace_id,
        )

    def _wrap_unary(self, behavior, method):
        def wrapped(request, context):
            start = time.monotonic()
            rec = _RecordingContext(context)
            trace_id = self._begin(method, rec)
            try:
                response = behavior(request, rec)
            except BaseException as e:
                self._finish(method, start, _code_name(rec, e), trace_id)
                raise
            self._finish(method, start, _code_name(rec, None), trace_id)
            return response

        return wrapped

    def _wrap_stream(self, behavior, method):
        def wrapped(request, context):
            start = time.monotonic()
            rec = _RecordingContext(context)
            trace_id = self._begin(method, rec)
            try:
                yield from behavior(request, rec)
            except BaseException as e:
                self._finish(method, start, _code_name(rec, e), trace_id)
                raise
            self._finish(method, start, _code_name(rec, None), trace_id)

        return wrapped
