"""Mock backend — behavior parity with the reference's MockService.

Reproduces the reference's internal/service/mock.go:22-66 exactly:

- every response carries Status{code: 200, message: "Tool executed
  successfully"} (mock.go:24-29);
- ``example_tool`` → "Mock execution of <name> at <RFC3339>" (mock.go:33-36);
- ``struct_tool`` → {result, timestamp, data:{processed, count:42}}
  (mock.go:37-51);
- ``file_tool``   → File{example.txt, text/plain, fixed bytes} (mock.go:52-59);
- unknown tools   → "Unknown tool: <name>" as a *successful* string output —
  NOT an error (mock.go:60-63).

This is also the framework's CPU-only test double: the whole gRPC stack runs
against it with zero GPU involvement, the same role the mock plays in the
reference's integration tier (SURVEY.md §4).
"""

from __future__ import annotations

import datetime
import time
from typing import Iterator, Optional

from ..proto import common_v2_pb2 as cmn
from ..proto import polykey_v2_pb2 as pk
from .service import Service
from google.protobuf import struct_pb2


def _rfc3339_now() -> str:
    # Go's time.RFC3339: second precision with numeric zone offset.
    return datetime.datetime.now().astimezone().isoformat(timespec="seconds")


class MockService(Service):
    def execute_tool(
        self,
        tool_name: str,
        parameters: Optional[struct_pb2.Struct],
        secret_id: Optional[str],
        metadata: Optional[cmn.Metadata],
    ) -> pk.ExecuteToolResponse:
        response = pk.ExecuteToolResponse(
            status=cmn.Status(code=200, message="Tool executed successfully")
        )

        if tool_name == "example_tool":
            response.string_output = (
                f"Mock execution of {tool_name} at {_rfc3339_now()}"
            )
        elif tool_name == "struct_tool":
            response.struct_output.update(
                {
                    "result": "success",
                    "timestamp": int(time.time()),
                    "data": {"processed": True, "count": 42},
                }
            )
        elif tool_name == "file_tool":
            response.file_output.CopyFrom(
                cmn.File(
                    file_name="example.txt",
                    mime_type="text/plain",
                    content=b"This is mock file content",
                )
            )
        else:
            response.string_output = f"Unknown tool: {tool_name}"

        return response

    def execute_tool_stream(
        self,
        tool_name: str,
        parameters: Optional[struct_pb2.Struct],
        secret_id: Optional[str],
        metadata: Optional[cmn.Metadata],
    ) -> Iterator[pk.ExecuteToolStreamChunk]:
        """Deterministic word-by-word stream, for exercising the streaming
        path without a GPU (the engine's mock-engine analog of mock.go)."""
        resp = self.execute_tool(tool_name, parameters, secret_id, metadata)
        if resp.WhichOneof("output") == "string_output":
            words = resp.string_output.split(" ")
            for i, word in enumerate(words):
                yield pk.ExecuteToolStreamChunk(
                    delta=word if i == 0 else " " + word
                )
        yield pk.ExecuteToolStreamChunk(final=True, status=resp.status)
