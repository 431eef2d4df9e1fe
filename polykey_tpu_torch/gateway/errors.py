"""Typed RPC failures + per-RPC deadline propagation.

The reference maps every service error to code Unknown (a bare Go error
through the grpc-go machinery). Overload-safe serving needs a richer
contract, and this module is the one place it lives so the handler layer
(server.py), the engine backend (torch_service.py), and the resilient client
(client.py) can't drift apart:

- ``RpcStatusError`` subclasses carry the gRPC status code the handler
  should abort with, plus optional trailing metadata
  (``ResourceExhaustedError`` ships the ``retry-after-ms`` hint that
  tells well-behaved clients when to come back);
- the RPC deadline rides a thread-local from the handler (which owns the
  ``ServicerContext``) down to the backend (which doesn't — the Service
  seam is context-free by reference parity), as ``current_span`` already
  does for tracing.

Retryability contract (client.py honors it): UNAVAILABLE and
RESOURCE_EXHAUSTED are retryable — the work was never started (shed at
admission) or the backend is restarting; DEADLINE_EXCEEDED is never
retryable — the budget is gone by definition.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import grpc

RETRY_AFTER_MS_KEY = "retry-after-ms"

# Replica-tier trailer contract. On successful LLM RPCs the
# backend stamps which replica served (`replica`) and whether the stream
# was resumed on another replica mid-flight (`restarted` — greedy
# resumes are bit-identical; sampled streams on a speculative engine are
# only distributionally equivalent, which is why the flag exists). On a
# mid-stream UNAVAILABLE the backend attaches `resume-supported` +
# `resume-tokens` so a client can re-issue the request with
# `received_tokens` and get only the missing suffix (client.py).
REPLICA_KEY = "replica"
RESTARTED_KEY = "restarted"
# Disaggregated-tier trailer: which prefill/decode worker
# pair served the request ("prefill=P,decode=D"), stamped only when the
# backend is a DisaggPool — the per-request routing breadcrumb the
# worker-death runbook starts from.
TIER_KEY = "tier"
RESUME_SUPPORTED_KEY = "resume-supported"
RESUME_TOKENS_KEY = "resume-tokens"
# Device-time attribution: successful LLM RPCs carry the
# request's accumulated device milliseconds — each decode block's
# device-busy window (dispatch gap minus host stall) split across its
# live lanes — so a client can separate "the model was slow" from "the
# server was busy" without scraping anything.
DEVICE_MS_KEY = "device-ms"


class RpcStatusError(RuntimeError):
    """A service failure with an explicit gRPC status code. server.py
    aborts with `code` (and any `trailing_metadata`) instead of the
    default Unknown mapping."""

    code = grpc.StatusCode.UNKNOWN

    def trailing_metadata(self) -> tuple[tuple[str, str], ...]:
        return ()


class DeadlineExceededError(RpcStatusError):
    """The request's deadline passed before the work finished (or could
    start). Never retryable: the client's budget is spent."""

    code = grpc.StatusCode.DEADLINE_EXCEEDED


class ResourceExhaustedError(RpcStatusError):
    """Admission shed the request (queue bound or estimated-delay check).
    Retryable after `retry_after_ms` — shipped as trailing metadata so
    clients that can't parse details still get the hint."""

    code = grpc.StatusCode.RESOURCE_EXHAUSTED

    def __init__(self, message: str, retry_after_ms: Optional[int] = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms

    def trailing_metadata(self) -> tuple[tuple[str, str], ...]:
        if self.retry_after_ms is None:
            return ()
        return ((RETRY_AFTER_MS_KEY, str(int(self.retry_after_ms))),)


class UnavailableError(RpcStatusError):
    """The backend cannot take work right now (engine dead / restarting /
    shut down). Retryable: a supervised restart usually brings it back.
    `trailers` lets the backend attach the mid-stream resume contract
    (resume-supported / resume-tokens) so a well-behaved client re-issues
    with `received_tokens` instead of replaying the whole stream."""

    code = grpc.StatusCode.UNAVAILABLE

    def __init__(self, message: str,
                 trailers: tuple[tuple[str, str], ...] = ()):
        super().__init__(message)
        self._trailers = tuple(trailers)

    def trailing_metadata(self) -> tuple[tuple[str, str], ...]:
        return self._trailers


# -- RPC deadline propagation (handler thread-local) -------------------------

_local = threading.local()


def deadline_from_context(context) -> Optional[float]:
    """Absolute monotonic deadline from a ServicerContext, or None when
    the client set no deadline (gRPC's time_remaining() is None then)."""
    try:
        remaining = context.time_remaining()
    except Exception:
        return None  # in-process stubs/doubles without time_remaining
    if remaining is None:
        return None
    return time.monotonic() + remaining


def set_rpc_deadline(deadline: Optional[float]) -> None:
    """Publish the current RPC's absolute monotonic deadline for the
    backend (handler entry sets it, handler exit clears it — threads are
    pooled, so a missed clear would leak one RPC's deadline into the
    next; both handlers clear in ``finally``)."""
    _local.deadline = deadline


def rpc_deadline() -> Optional[float]:
    return getattr(_local, "deadline", None)


# -- response trailers (handler thread-local) ---------------------------------
# The Service seam is context-free (reference parity), so a backend that
# wants to attach SUCCESS-path trailing metadata (replica id, restarted
# flag) stashes pairs here; the handler (server.py) flushes them into
# the ServicerContext after the service call and clears in `finally`
# (threads are pooled — a missed clear would leak one RPC's trailers
# into the next).


def add_rpc_trailers(*pairs: tuple[str, str]) -> None:
    stash = getattr(_local, "trailers", None)
    if stash is None:
        stash = []
        _local.trailers = stash
    stash.extend(pairs)


def pop_rpc_trailers() -> tuple[tuple[str, str], ...]:
    stash = getattr(_local, "trailers", None)
    _local.trailers = None
    return tuple(stash) if stash else ()
