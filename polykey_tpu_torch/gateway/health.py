"""grpc.health.v1 server implementation.

Reproduces the semantics of grpc-go's bundled health server, which the
reference wires in at cmd/polykey/main.go:82-94 and shuts down
on SIGTERM (main.go:118): per-service serving status, NOT_FOUND on Check for
unknown services, streaming Watch with SERVICE_UNKNOWN for unregistered names,
and Shutdown() forcing every current and future status to NOT_SERVING.

The server flips every status to NOT_SERVING on shutdown, the engine
marks the health service down when its loop crashes, and the watchdog
(engine/watchdog.py) when its step loop stalls; the supervisor
(engine/supervisor.py) resumes SERVING once a fresh engine is up — the
serving-tier liveness story the reference delegates to container
healthchecks (compose.yml:17-22).
"""

from __future__ import annotations

import threading

import grpc

from ..proto import health_v1_pb2 as health_pb
from ..proto.health_v1_grpc import HealthServicer

SERVING = health_pb.HealthCheckResponse.SERVING
NOT_SERVING = health_pb.HealthCheckResponse.NOT_SERVING
SERVICE_UNKNOWN = health_pb.HealthCheckResponse.SERVICE_UNKNOWN


class HealthService(HealthServicer):
    def __init__(self):
        self._cond = threading.Condition()
        self._statuses: dict[str, int] = {}
        self._shutdown = False

    def set_serving_status(self, service: str, status: int) -> None:
        with self._cond:
            if self._shutdown:
                return
            # polylint: disable=ML002(keyed by registered service name: a handful of static strings, not per-request data)
            self._statuses[service] = status
            self._cond.notify_all()

    def shutdown(self) -> None:
        """Force every present and future status to NOT_SERVING."""
        with self._cond:
            self._shutdown = True
            for service in self._statuses:
                self._statuses[service] = NOT_SERVING
            self._cond.notify_all()

    def resume(self) -> None:
        with self._cond:
            self._shutdown = False

    def resume_serving(self) -> None:
        """Un-latch shutdown and flip every registered status back to
        SERVING — the supervised-restart recovery path: the
        engine supervisor calls this once a fresh engine is ready, so
        orchestration resumes routing without a process restart. Watch
        streams see the NOT_SERVING → SERVING transition."""
        with self._cond:
            self._shutdown = False
            for service in self._statuses:
                self._statuses[service] = SERVING
            self._cond.notify_all()

    # -- RPC methods --------------------------------------------------------

    def Check(self, request, context):
        with self._cond:
            if request.service not in self._statuses:
                context.abort(grpc.StatusCode.NOT_FOUND, "unknown service")
            return health_pb.HealthCheckResponse(
                status=self._statuses[request.service]
            )

    def Watch(self, request, context):
        last_sent = None
        while context.is_active():
            with self._cond:
                status = self._statuses.get(request.service, SERVICE_UNKNOWN)
                if status == last_sent:
                    # Wake periodically to notice client disconnect.
                    self._cond.wait(timeout=1.0)
                    continue
                last_sent = status
            yield health_pb.HealthCheckResponse(status=status)


def probe(target: str, service: str = "", timeout: float = 5.0) -> int:
    """grpc_health_probe equivalent (the reference ships the Go binary in
    both runtime images, the reference's Dockerfile:30-36; container
    healthchecks exec it, compose.yml:17-22). Returns a process exit code:
    0 SERVING, 1 anything else/unreachable."""
    from ..proto.health_v1_grpc import HealthStub

    try:
        with grpc.insecure_channel(target) as channel:
            resp = HealthStub(channel).Check(
                health_pb.HealthCheckRequest(service=service), timeout=timeout
            )
        return 0 if resp.status == SERVING else 1
    except grpc.RpcError:
        return 1


if __name__ == "__main__":
    import sys

    _target = sys.argv[1] if len(sys.argv) > 1 else "localhost:50051"
    _service = sys.argv[2] if len(sys.argv) > 2 else ""
    sys.exit(probe(_target, _service))
