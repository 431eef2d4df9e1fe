"""The service seam — the framework's business-logic contract.

Mirrors the reference's one-method `Service` interface
(the reference's internal/service/service.go:12-15):

    ExecuteTool(ctx, toolName, parameters, secretId, metadata) → response

This seam is where backends mount (SURVEY.md §3.2): the reference hard-wires a
mock (cmd/polykey/main.go:85); this framework additionally provides
`gateway.torch_service.TorchService`, which routes LLM tools into the
continuous-batching engine on the GPU. `execute_tool_stream` is the streaming extension;
the default adapter turns a unary response into a single terminal chunk so
non-streaming backends work over the streaming RPC too.
"""

from __future__ import annotations

import abc
from typing import Iterator, Optional

from ..proto import common_v2_pb2 as cmn
from ..proto import polykey_v2_pb2 as pk
from google.protobuf import struct_pb2


class Service(abc.ABC):
    @abc.abstractmethod
    def execute_tool(
        self,
        tool_name: str,
        parameters: Optional[struct_pb2.Struct],
        secret_id: Optional[str],
        metadata: Optional[cmn.Metadata],
    ) -> pk.ExecuteToolResponse:
        """Execute one tool call and return the full response."""

    def execute_tool_stream(
        self,
        tool_name: str,
        parameters: Optional[struct_pb2.Struct],
        secret_id: Optional[str],
        metadata: Optional[cmn.Metadata],
    ) -> Iterator[pk.ExecuteToolStreamChunk]:
        """Streaming variant; default adapts the unary path."""
        resp = self.execute_tool(tool_name, parameters, secret_id, metadata)
        delta = resp.string_output if resp.WhichOneof("output") == "string_output" else ""
        if delta:
            yield pk.ExecuteToolStreamChunk(delta=delta)
        yield pk.ExecuteToolStreamChunk(final=True, status=resp.status)

    def close(self) -> None:
        """Release backend resources (engine shutdown); default no-op."""
