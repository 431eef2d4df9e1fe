"""gRPC server reflection (v1 + v1alpha), backed by the default descriptor
pool.

Hand-rolled because grpcio-reflection is not in the image; the reference gets
this from grpc-go (cmd/polykey/main.go:80), whose
reflection.Register serves BOTH grpc.reflection.v1.ServerReflection and the
v1alpha name — modern grpcurl tries v1 first. The v1 protocol is a pure
rename of v1alpha (identical message shapes and field numbers), so one
handler serves both service names with the same wire bytes. Supports the
queries grpcurl issues: list_services, file_containing_symbol, and
file_by_filename (each file response includes transitive imports).
"""

from __future__ import annotations

import grpc
from google.protobuf import descriptor_pool

from ..proto import reflection_v1alpha_pb2 as refl_pb
# Imported for its side effect: registering the v1 file in the default
# descriptor pool, so describing the advertised v1 service name resolves
# (grpc-go registers descriptors for both names).
from ..proto import reflection_v1_pb2 as _refl_v1_pb  # noqa: F401

from ..proto.health_v1_grpc import SERVICE_NAME as _HEALTH_SERVICE
from ..proto.polykey_v2_grpc import SERVICE_NAME as _POLYKEY_SERVICE

SERVICE_NAME = "grpc.reflection.v1alpha.ServerReflection"
SERVICE_NAME_V1 = "grpc.reflection.v1.ServerReflection"

# Services this server exposes, as registered in gateway.server.
_EXPOSED_SERVICES = (
    _POLYKEY_SERVICE, _HEALTH_SERVICE, SERVICE_NAME_V1, SERVICE_NAME,
)


def _file_with_deps(pool, file_desc) -> list[bytes]:
    """A file's serialized FileDescriptorProto plus transitive dependencies."""
    out, seen, stack = [], set(), [file_desc]
    while stack:
        fd = stack.pop()
        if fd.name in seen:
            continue
        seen.add(fd.name)
        out.append(fd.serialized_pb)
        stack.extend(fd.dependencies)
    return out


class ReflectionService:
    def __init__(self, services=_EXPOSED_SERVICES, pool=None):
        self._services = list(services)
        self._pool = pool or descriptor_pool.Default()

    def ServerReflectionInfo(self, request_iterator, context):
        for request in request_iterator:
            response = refl_pb.ServerReflectionResponse(
                valid_host=request.host, original_request=request
            )
            which = request.WhichOneof("message_request")
            try:
                if which == "list_services":
                    response.list_services_response.service.extend(
                        refl_pb.ServiceResponse(name=s) for s in self._services
                    )
                elif which == "file_containing_symbol":
                    fd = self._pool.FindFileContainingSymbol(
                        request.file_containing_symbol
                    )
                    response.file_descriptor_response.file_descriptor_proto.extend(
                        _file_with_deps(self._pool, fd)
                    )
                elif which == "file_by_filename":
                    fd = self._pool.FindFileByName(request.file_by_filename)
                    response.file_descriptor_response.file_descriptor_proto.extend(
                        _file_with_deps(self._pool, fd)
                    )
                else:
                    response.error_response.error_code = (
                        grpc.StatusCode.UNIMPLEMENTED.value[0]
                    )
                    response.error_response.error_message = (
                        f"unsupported reflection request: {which}"
                    )
            except KeyError:
                response.error_response.error_code = (
                    grpc.StatusCode.NOT_FOUND.value[0]
                )
                response.error_response.error_message = "not found"
            yield response


def add_reflection_to_server(servicer: ReflectionService, server) -> None:
    handler = grpc.stream_stream_rpc_method_handler(
        servicer.ServerReflectionInfo,
        request_deserializer=refl_pb.ServerReflectionRequest.FromString,
        response_serializer=refl_pb.ServerReflectionResponse.SerializeToString,
    )
    # Same handler under both names: v1 is wire-identical to v1alpha
    # (grpc-go parity — reflection.Register serves both).
    server.add_generic_rpc_handlers(
        tuple(
            grpc.method_handlers_generic_handler(
                name, {"ServerReflectionInfo": handler}
            )
            for name in (SERVICE_NAME_V1, SERVICE_NAME)
        )
    )
