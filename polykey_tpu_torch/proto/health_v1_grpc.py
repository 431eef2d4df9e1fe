"""gRPC glue for grpc.health.v1.Health (hand-written; see proto/__init__.py).

The reference serves this protocol via grpc-go's bundled health server
(the reference's cmd/polykey/main.go:82-94); grpc_health_probe in the container
healthcheck speaks it (compose.yml:17-22).
"""

import grpc

from . import health_v1_pb2 as health_pb

SERVICE_NAME = "grpc.health.v1.Health"


class HealthStub:
    def __init__(self, channel: grpc.Channel):
        self.Check = channel.unary_unary(
            f"/{SERVICE_NAME}/Check",
            request_serializer=health_pb.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb.HealthCheckResponse.FromString,
        )
        self.Watch = channel.unary_stream(
            f"/{SERVICE_NAME}/Watch",
            request_serializer=health_pb.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb.HealthCheckResponse.FromString,
        )


class HealthServicer:
    def Check(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Method not implemented!")

    def Watch(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Method not implemented!")


def add_HealthServicer_to_server(servicer, server):
    rpc_method_handlers = {
        "Check": grpc.unary_unary_rpc_method_handler(
            servicer.Check,
            request_deserializer=health_pb.HealthCheckRequest.FromString,
            response_serializer=health_pb.HealthCheckResponse.SerializeToString,
        ),
        "Watch": grpc.unary_stream_rpc_method_handler(
            servicer.Watch,
            request_deserializer=health_pb.HealthCheckRequest.FromString,
            response_serializer=health_pb.HealthCheckResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, rpc_method_handlers),)
    )
