"""gRPC client stub + server registration for polykey.v2.PolykeyService.

Hand-written equivalent of grpc_tools protoc output (grpc_tools is not in the
image). Service/method names mirror the reference exactly: the Go server
registers ``polykey.v2.PolykeyService`` with method ``ExecuteTool``
(the reference's cmd/polykey/main.go:89-94, internal/server/server.go:27).
``ExecuteToolStream`` is this framework's streaming extension.
"""

import grpc

from . import polykey_v2_pb2 as pk

SERVICE_NAME = "polykey.v2.PolykeyService"


class PolykeyServiceStub:
    """Client-side stub."""

    def __init__(self, channel: grpc.Channel):
        self.ExecuteTool = channel.unary_unary(
            f"/{SERVICE_NAME}/ExecuteTool",
            request_serializer=pk.ExecuteToolRequest.SerializeToString,
            response_deserializer=pk.ExecuteToolResponse.FromString,
        )
        self.ExecuteToolStream = channel.unary_stream(
            f"/{SERVICE_NAME}/ExecuteToolStream",
            request_serializer=pk.ExecuteToolRequest.SerializeToString,
            response_deserializer=pk.ExecuteToolStreamChunk.FromString,
        )


class PolykeyServiceServicer:
    """Server-side service skeleton; subclass and override."""

    def ExecuteTool(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Method not implemented!")

    def ExecuteToolStream(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Method not implemented!")


def add_PolykeyServiceServicer_to_server(servicer, server):
    rpc_method_handlers = {
        "ExecuteTool": grpc.unary_unary_rpc_method_handler(
            servicer.ExecuteTool,
            request_deserializer=pk.ExecuteToolRequest.FromString,
            response_serializer=pk.ExecuteToolResponse.SerializeToString,
        ),
        "ExecuteToolStream": grpc.unary_stream_rpc_method_handler(
            servicer.ExecuteToolStream,
            request_deserializer=pk.ExecuteToolRequest.FromString,
            response_serializer=pk.ExecuteToolStreamChunk.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, rpc_method_handlers),)
    )
