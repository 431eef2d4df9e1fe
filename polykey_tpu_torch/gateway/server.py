"""gRPC server wiring (the reference's gateway/server.py).

- listen address from ``LISTEN_ADDR``, default ``:50051``;
- keepalive: MaxConnectionIdle 5m, Time 2h, Timeout 20s;
- unary + streaming logging and tracing interceptor that skips health
  checks (root spans and RPC counters with an `Observability` bundle);
- health service with SERVING for ``polykey.v2.PolykeyService`` and
  ``""``, plus server reflection (v1 and v1alpha);
- the Prometheus sidecar: ``/metrics`` on ``POLYKEY_METRICS_PORT``
  (default 9464; 0 disables it), with the ``/debug/*`` surface beside it
  (a 404 unless ``POLYKEY_DEBUG_ENDPOINTS=1``) following
  ``service.engine`` across supervised restarts;
- graceful drain on SIGINT/SIGTERM: health shutdown first, then stop.

The backend is selected as in the reference: ``POLYKEY_BACKEND=engine``
(or its alias ``tpu``) mounts the GPU inference engine
(gateway/torch_service.py); the default stays the dependency-free mock.
The engine runs on the GPU unless ``POLYKEY_DEVICE=cpu`` asks for the CPU.

Serving over a mesh: every rank starts this entry point with
``POLYKEY_COORDINATOR`` (host:port of rank 0), ``POLYKEY_NUM_PROCESSES``
and ``POLYKEY_PROCESS_ID`` set, and the axes in ``POLYKEY_TP`` /
``POLYKEY_DP`` / ``POLYKEY_EP`` / ``POLYKEY_SP`` / ``POLYKEY_NUM_SLICES``;
each binds ``cuda:<rank % device_count>``. Rank 0 serves gRPC; every other
rank replays rank 0's dispatches (engine/lockstep.py), binds no port and
exits when rank 0 stops.

Run: ``POLYKEY_BACKEND=engine python -m polykey_tpu_torch.gateway.server``
"""

from __future__ import annotations

import os
import signal
import time
from concurrent import futures
from typing import Optional

import grpc

from ..proto import health_v1_pb2 as health_pb
from ..proto import polykey_v2_pb2 as pk
from ..proto.health_v1_grpc import SERVICE_NAME as HEALTH_SERVICE_NAME
from ..proto.health_v1_grpc import add_HealthServicer_to_server
from ..proto.polykey_v2_grpc import (
    SERVICE_NAME,
    PolykeyServiceServicer,
    add_PolykeyServiceServicer_to_server,
)
from ..obs import DebugSurface, MetricsHTTPServer, Observability
from . import errors
from .health import HealthService
from .interceptor import LoggingInterceptor
from .jsonlog import Logger
from .reflection import SERVICE_NAME as REFLECTION_SERVICE_NAME
from .reflection import SERVICE_NAME_V1 as REFLECTION_SERVICE_NAME_V1
from .reflection import ReflectionService, add_reflection_to_server
from .service import Service

_KEEPALIVE_OPTIONS = [
    ("grpc.max_connection_idle_ms", 5 * 60 * 1000),   # MaxConnectionIdle 5m
    ("grpc.keepalive_time_ms", 2 * 60 * 60 * 1000),   # Time 2h
    ("grpc.keepalive_timeout_ms", 20 * 1000),         # Timeout 20s
    # Fail loudly when the port is taken instead of sharing it.
    ("grpc.so_reuseport", 0),
]


class PolykeyServer(PolykeyServiceServicer):
    """RPC handler layer: log the request shape, delegate to the Service
    seam, map typed errors to their status codes (anything else surfaces
    as Unknown, as a bare Go error does in the reference)."""

    def __init__(self, service: Service, logger: Optional[Logger] = None):
        self.service = service
        self.logger = logger or Logger()

    def _log_call(self, rpc: str, request: pk.ExecuteToolRequest) -> None:
        self.logger.info(
            f"{rpc} called",
            tool_name=request.tool_name,
            has_parameters=request.HasField("parameters"),
            has_secret_id=request.HasField("secret_id"),
            has_metadata=request.HasField("metadata"),
        )

    @staticmethod
    def _unpack(request: pk.ExecuteToolRequest):
        return (
            request.tool_name,
            request.parameters if request.HasField("parameters") else None,
            request.secret_id if request.HasField("secret_id") else None,
            request.metadata if request.HasField("metadata") else None,
        )

    def _abort_status(self, rpc: str, context, e: errors.RpcStatusError):
        expected = e.code in (
            grpc.StatusCode.RESOURCE_EXHAUSTED,
            grpc.StatusCode.DEADLINE_EXCEEDED,
        )
        log = self.logger.warn if expected else self.logger.error
        log(f"Service {rpc} failed", error=str(e), code=e.code.name)
        metadata = e.trailing_metadata()
        if metadata:
            context.set_trailing_metadata(metadata)
        context.abort(e.code, str(e))

    @staticmethod
    def _flush_trailers(context) -> None:
        """Success-path trailing metadata the backend stashed through
        errors.add_rpc_trailers (device-ms, replica, restarted), merged by
        the interceptor's recording context with the x-trace-id echo."""
        trailers = errors.pop_rpc_trailers()
        if trailers:
            context.set_trailing_metadata(trailers)

    def ExecuteTool(self, request, context):
        self._log_call("ExecuteTool", request)
        errors.set_rpc_deadline(errors.deadline_from_context(context))
        try:
            response = self.service.execute_tool(*self._unpack(request))
            self._flush_trailers(context)
            return response
        except errors.RpcStatusError as e:
            self._abort_status("ExecuteTool", context, e)
        except Exception as e:
            self.logger.error("Service ExecuteTool failed", error=str(e))
            context.abort(grpc.StatusCode.UNKNOWN, str(e))
        finally:
            errors.set_rpc_deadline(None)       # handler threads are pooled
            errors.pop_rpc_trailers()           # drop a stash an abort left

    def ExecuteToolStream(self, request, context):
        self._log_call("ExecuteToolStream", request)
        errors.set_rpc_deadline(errors.deadline_from_context(context))
        try:
            yield from self.service.execute_tool_stream(*self._unpack(request))
            self._flush_trailers(context)
        except errors.RpcStatusError as e:
            self._abort_status("ExecuteToolStream", context, e)
        except Exception as e:
            self.logger.error("Service ExecuteToolStream failed", error=str(e))
            context.abort(grpc.StatusCode.UNKNOWN, str(e))
        finally:
            errors.set_rpc_deadline(None)
            errors.pop_rpc_trailers()


def normalize_address(addr: str) -> str:
    """Accept Go-style ':50051' (bind all interfaces) as well as host:port."""
    return "[::]" + addr if addr.startswith(":") else addr


def build_server(
    service: Service,
    logger: Optional[Logger] = None,
    address: str = ":50051",
    max_workers: int = 32,
    health: Optional[HealthService] = None,
    obs: Optional[Observability] = None,
):
    """Assemble the gRPC server; returns (server, health, port). A
    HealthService built before the server lets the backend's watchdog and
    supervisor flip serving status. An `Observability` bundle turns on
    request tracing and RPC counters; share it with the backend and the
    /metrics sidecar so all three see one registry and one recorder."""
    logger = logger or Logger()
    server = grpc.server(
        futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="polykey-rpc"
        ),
        interceptors=[LoggingInterceptor(logger, obs=obs)],
        options=_KEEPALIVE_OPTIONS,
    )
    add_PolykeyServiceServicer_to_server(PolykeyServer(service, logger), server)
    if health is None:
        health = HealthService()
    add_HealthServicer_to_server(health, server)
    health.set_serving_status(SERVICE_NAME, health_pb.HealthCheckResponse.SERVING)
    health.set_serving_status("", health_pb.HealthCheckResponse.SERVING)
    add_reflection_to_server(ReflectionService(), server)
    try:
        port = server.add_insecure_port(normalize_address(address))
    except RuntimeError as e:               # grpc raises on bind failure
        raise OSError(f"failed to listen on {address}: {e}") from e
    if port == 0:
        raise OSError(f"failed to listen on {address}")
    return server, health, port


_SERVICE_TABLE = {
    SERVICE_NAME: ["ExecuteTool", "ExecuteToolStream"],
    HEALTH_SERVICE_NAME: ["Check", "Watch"],
    REFLECTION_SERVICE_NAME_V1: ["ServerReflectionInfo"],
    REFLECTION_SERVICE_NAME: ["ServerReflectionInfo"],
}


def _default_service(logger: Logger, health: Optional[HealthService], device=None,
                     obs: Optional[Observability] = None) -> Service:
    """TorchService for POLYKEY_BACKEND=engine|tpu (with its watchdog and
    supervisor), the mock otherwise."""
    backend = os.environ.get("POLYKEY_BACKEND", "mock").lower()
    if backend in ("tpu", "engine"):
        # The multi-process bootstrap before the engine touches the device
        # (POLYKEY_COORDINATOR / NUM_PROCESSES / PROCESS_ID; a no-op
        # without them), as the reference's server does.
        from ..parallel.distributed import initialize_from_env

        initialize_from_env(logger, device)
        from .torch_service import TorchService

        return TorchService.from_env(health=health, logger=logger, obs=obs,
                                     device=device)
    from .mock_service import MockService

    return MockService()


def start_metrics_server(obs: Observability, logger: Logger, service=None,
                         port: Optional[int] = None) -> Optional[MetricsHTTPServer]:
    """The Prometheus sidecar thread. `port` None reads
    POLYKEY_METRICS_PORT (default 9464); 0 there disables it (as an
    argument, 0 binds an ephemeral port). A bind failure degrades to no
    endpoint rather than killing the gateway — the gRPC metrics_text view
    still works. An engine-shaped backend gets the /debug surface beside
    /metrics, following `service.engine` across restarts."""
    if port is None:
        raw = os.environ.get("POLYKEY_METRICS_PORT", "9464")
        try:
            port = int(raw)
        except ValueError:
            logger.warn("invalid POLYKEY_METRICS_PORT; metrics disabled", value=raw)
            return None
        if port <= 0:
            return None
    debug = None
    if service is not None and hasattr(service, "engine"):
        debug = DebugSurface(engine_provider=lambda: service.engine, obs=obs,
                             profiler=getattr(service, "profiler", None))
    try:
        metrics_server = MetricsHTTPServer(obs.registry, port=port, debug=debug).start()
    except OSError as e:
        logger.warn("metrics endpoint failed to bind; continuing without",
                    port=port, error=str(e))
        return None
    logger.info("metrics endpoint listening", port=metrics_server.port, path="/metrics")
    return metrics_server


def follow(service, engine, logger: Logger) -> int:
    """A follower rank's lives (engine/lockstep.py): no gRPC port, no
    metrics endpoint; the engine thread replays the leader's records until
    the leader's shutdown record, or until a signal here. At the leader's
    "rebuild" word (its supervisor restarts the mesh in process, however
    the leader failed) the follower frees its engine's device state, or
    keeps the engine as an orphan while its thread is still inside the old
    life, builds the next one on the same weights over the mesh's next
    life and follows again (lockstep.follow_lives). Returns the process's
    exit code: 1 when the engine failed."""
    from ..engine import lockstep

    stop = {"signal": None}

    def _on_signal(signum, _frame):
        stop["signal"] = signum

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _on_signal)
    if hasattr(engine, "replicas"):
        # A replica pool over meshes: each replica follows on its thread.
        logger.info("mesh follower replaying the leader's dispatches",
                    replicas=len(engine.replicas))
        failure = engine.follow(lambda: stop["signal"] is not None)
        service.close()
        logger.info("mesh follower stopped", error=failure or "")
        return 1 if failure else 0
    logger.info("mesh follower replaying the leader's dispatches",
                **engine.stats()["mesh"])

    def adopt(fresh) -> None:
        logger.info("mesh follower rebuilt at its leader's restart", **fresh.stats()["mesh"])
        service.engine = fresh
        if service.watchdog is not None:
            service.watchdog.rearm(fresh)
        if service.supervisor is not None:
            service.supervisor.engine = fresh

    engine = lockstep.follow_lives(engine, lambda: stop["signal"] is not None, adopt)
    dead = engine.dead
    service.close()
    logger.info("mesh follower stopped", error=dead or "")
    return 1 if dead else 0


def serve(service: Optional[Service] = None, address: Optional[str] = None) -> None:
    """Process entry point: serve until SIGINT/SIGTERM."""
    logger = Logger(level=os.environ.get("POLYKEY_LOG_LEVEL", "info"))
    if address is None:
        address = os.environ.get("LISTEN_ADDR") or ":50051"
    obs = Observability()
    health = HealthService()
    if service is None:
        try:
            service = _default_service(logger, health, obs=obs)
        except Exception as e:
            logger.error("failed to initialize backend", error=str(e))
            raise SystemExit(1)
    engine = getattr(service, "engine", None)
    if getattr(engine, "is_follower", False):
        raise SystemExit(follow(service, engine, logger))
    try:
        server, health, _ = build_server(service, logger, address, health=health,
                                         obs=obs)
    except OSError as e:
        logger.error("failed to listen", error=str(e))
        raise SystemExit(1)
    metrics_server = start_metrics_server(obs, logger, service=service)
    logger.info("Registered services:")
    for name, methods in _SERVICE_TABLE.items():
        logger.info("Service registered", name=name, methods=len(methods))
        for method in methods:
            logger.info("Method available", service=name, method=method)

    # The handler only sets a flag. It runs on the main thread between
    # bytecodes, possibly while that thread is inside a lock (an Event's
    # wait holds its condition's), so it must take none itself: a second
    # signal landing in Event.set() there would deadlock.
    stop = {"signal": None}

    def _on_signal(signum, _frame):
        stop["signal"] = signum

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _on_signal)
    server.start()
    logger.info("server starting", address=address)
    while stop["signal"] is None:
        time.sleep(0.1)
    logger.info("server shutting down")
    health.shutdown()
    server.stop(grace=10).wait()
    close = getattr(service, "close", None)
    if close is not None:
        close()
    if metrics_server is not None:
        metrics_server.stop()
    logger.info("server stopped")


if __name__ == "__main__":
    serve()
