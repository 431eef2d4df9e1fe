"""Generated protobuf messages + hand-written gRPC glue.

``*_pb2.py`` are generated by ``scripts/gen_protos.sh`` (protoc). The
``*_grpc.py`` modules are hand-written equivalents of what grpc_tools'
protoc plugin would emit (that package is not available in this image).
"""

from . import common_v2_pb2, health_v1_pb2, polykey_v2_pb2  # noqa: F401
