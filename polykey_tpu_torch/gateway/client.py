"""Dev client — end-to-end smoke test of the running gateway (the reference
package's polykey_tpu/gateway/client.py, for the port's server).

    python -m polykey_tpu_torch.gateway.client --server localhost:50051
    python -m polykey_tpu_torch.gateway.client --server localhost:50051 \
        --tool llm_generate --prompt "hi" --stream

Logs to an in-memory buffer, runs config-load → raw TCP probe → gRPC
connect (insecure creds, client keepalive 10s/5s with permit-without-stream,
4 MiB message caps) → one `example_tool` ExecuteTool call (or ``--tool``)
with struct params, secret_id "secret-123" and request metadata, 30s
deadline — then renders the buffered logs as a Jest-style report. Its four
PASS checks (config, TCP, gRPC READY, tool execution) are the acceptance
criterion. ``--stream`` exercises the server-streaming RPC and logs the
replica-tier trailers (`replica`, `restarted`) a replica pool stamps.

Calls retry on UNAVAILABLE (engine restarting under supervision) and
RESOURCE_EXHAUSTED (admission shed) with exponential backoff + full
jitter, honoring the server's ``retry-after-ms`` trailing-metadata hint
when present. DEADLINE_EXCEEDED is never retried, and a stream is never
retried once any chunk has arrived unless the server offered a resume
(``resume-supported`` + ``resume-tokens``).
"""

from __future__ import annotations

import argparse
import io
import random
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import grpc

from .errors import (
    REPLICA_KEY,
    RESTARTED_KEY,
    RESUME_SUPPORTED_KEY,
    RESUME_TOKENS_KEY,
    RETRY_AFTER_MS_KEY,
)

from ..proto import common_v2_pb2 as cmn
from ..proto import polykey_v2_pb2 as pk
from ..proto.polykey_v2_grpc import PolykeyServiceStub
from .beautify import print_jest_report
from .config import Config, ConfigLoader, NetworkTester
from .jsonlog import Logger

_CHANNEL_OPTIONS = [
    ("grpc.keepalive_time_ms", 10_000),
    ("grpc.keepalive_timeout_ms", 5_000),
    ("grpc.keepalive_permit_without_calls", 1),
    ("grpc.max_receive_message_length", 4 * 1024 * 1024),
    ("grpc.max_send_message_length", 4 * 1024 * 1024),
]

RETRYABLE_CODES = frozenset({
    grpc.StatusCode.UNAVAILABLE,        # engine restarting / not up yet
    grpc.StatusCode.RESOURCE_EXHAUSTED,  # admission shed; retry-after hints
})


def trailers_from(obj) -> dict:
    """Trailing metadata of a grpc.Call / RpcError as a dict ({} when
    the object has none — in-process test doubles)."""
    try:
        return dict(obj.trailing_metadata() or ())
    except Exception:
        return {}  # not a grpc.Call (test doubles): no trailers to read


def retry_after_ms_from(err: grpc.RpcError) -> Optional[int]:
    """The server's retry-after-ms trailing-metadata hint, if any."""
    value = trailers_from(err).get(RETRY_AFTER_MS_KEY)
    if value is None:
        return None
    try:
        return int(value)
    except ValueError:
        return None


def resume_tokens_from(err: grpc.RpcError) -> Optional[int]:
    """Mid-stream resume contract: when an UNAVAILABLE stream
    failure carries `resume-supported`, its `resume-tokens` trailer is
    the count of tokens the server already delivered — re-issuing the
    request with `received_tokens` set to it streams only the missing
    suffix. Returns None when the server did not offer a resume."""
    trailers = trailers_from(err)
    if trailers.get(RESUME_SUPPORTED_KEY) != "1":
        return None
    try:
        return int(trailers[RESUME_TOKENS_KEY])
    except (KeyError, ValueError):
        return None


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter over the retryable codes.

    The server's retry-after-ms hint, when present, replaces the
    computed backoff (it knows the queue's drain rate; the client
    doesn't) — scaled by a small random factor so a thundering herd of
    shed clients doesn't return in lockstep. `sleep` is injectable so
    tests assert the schedule without real waiting."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    sleep: Callable[[float], None] = field(default=time.sleep)

    def should_retry(self, code: grpc.StatusCode, attempt: int) -> bool:
        return code in RETRYABLE_CODES and attempt + 1 < self.max_attempts

    def delay_s(self, attempt: int, retry_after_ms: Optional[int]) -> float:
        if retry_after_ms is not None:
            return (retry_after_ms / 1000.0) * (1.0 + 0.25 * random.random())
        cap = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** attempt)
        return cap * (0.5 + 0.5 * random.random())


_DEFAULT_RETRY = RetryPolicy()


class Client:
    def __init__(self, cfg: Config, logger: Logger,
                 retry: Optional[RetryPolicy] = _DEFAULT_RETRY):
        self.logger = logger
        # retry=None disables retries entirely (at-most-once semantics
        # for non-idempotent tools); the default policy retries only
        # codes where the server did not start the work.
        self.retry = retry
        self.channel = self._create_channel(cfg)
        self.stub = PolykeyServiceStub(self.channel)

    def _create_channel(self, cfg: Config) -> grpc.Channel:
        self.logger.info("Creating gRPC connection", server=cfg.server_address)
        channel = grpc.insecure_channel(cfg.server_address, options=_CHANNEL_OPTIONS)
        self._wait_for_ready(channel, cfg.timeout)
        self.logger.info("gRPC connection established successfully")
        return channel

    def _wait_for_ready(self, channel: grpc.Channel, timeout: float) -> None:
        # Explicit connectivity state machine (the Go reference's dev
        # client): log transitions at DEBUG, fail on TRANSIENT_FAILURE /
        # SHUTDOWN.
        done = threading.Event()
        failed: list[grpc.ChannelConnectivity] = []
        first = True

        def on_state(state: grpc.ChannelConnectivity) -> None:
            nonlocal first
            if first:
                self.logger.debug("Initial connection state", state=state.name)
                first = False
            else:
                self.logger.debug("Connection state changed", state=state.name)
            if state == grpc.ChannelConnectivity.READY:
                done.set()
            elif state in (
                grpc.ChannelConnectivity.TRANSIENT_FAILURE,
                grpc.ChannelConnectivity.SHUTDOWN,
            ):
                failed.append(state)
                done.set()

        channel.subscribe(on_state, try_to_connect=True)
        if not done.wait(timeout):
            raise TimeoutError("connection timeout")
        if failed:
            raise ConnectionError(f"connection failed with state: {failed[0].name}")

    def close(self) -> None:
        self.channel.close()

    def _backoff(self, e: grpc.RpcError, attempt: int) -> bool:
        """Decide + perform the retry wait for a failed attempt. Returns
        False when the error is terminal (caller re-raises)."""
        code = e.code()
        if self.retry is None or not self.retry.should_retry(code, attempt):
            return False
        delay = self.retry.delay_s(attempt, retry_after_ms_from(e))
        self.logger.warn(
            "gRPC call retrying", code=code.name, attempt=attempt + 1,
            delay_ms=round(delay * 1e3, 1),
        )
        self.retry.sleep(delay)
        return True

    def execute_tool(self, request: pk.ExecuteToolRequest, timeout: float = 30.0):
        self.logger.info(
            "Executing tool",
            tool_name=request.tool_name,
            secret_id=request.secret_id if request.HasField("secret_id") else None,
            has_metadata=request.HasField("metadata"),
        )
        attempt = 0
        while True:
            try:
                resp = self.stub.ExecuteTool(request, timeout=timeout)
                break
            except grpc.RpcError as e:
                if self._backoff(e, attempt):
                    attempt += 1
                    continue
                self.logger.error(
                    "gRPC call failed", code=e.code().name, message=e.details()
                )
                raise
        self._log_response(resp)
        return resp

    def _resume_request(self, request: pk.ExecuteToolRequest,
                        received_tokens: int) -> pk.ExecuteToolRequest:
        """A copy of `request` carrying received_tokens — the caller's
        proto must not be mutated across resume attempts."""
        resumed = pk.ExecuteToolRequest()
        resumed.CopyFrom(request)
        resumed.parameters.update({"received_tokens": received_tokens})
        return resumed

    def execute_tool_stream(self, request: pk.ExecuteToolRequest, timeout: float = 30.0):
        self.logger.info(
            "Executing tool",
            tool_name=request.tool_name,
            secret_id=request.secret_id if request.HasField("secret_id") else None,
            has_metadata=request.HasField("metadata"),
        )
        attempt = 0
        # Accumulated across RESUME attempts (the server only streams the
        # missing suffix); cleared on plain retries, which only happen
        # before any chunk arrived.
        text: list[str] = []
        usage, status, trailers = None, None, {}
        while True:
            usage, status = None, None
            received = False
            try:
                call = self.stub.ExecuteToolStream(request, timeout=timeout)
                for chunk in call:
                    received = True
                    if chunk.delta:
                        text.append(chunk.delta)
                    if chunk.final:
                        if chunk.HasField("status"):
                            status = chunk.status
                        if chunk.HasField("usage"):
                            usage = chunk.usage
                trailers = trailers_from(call)
                break
            except grpc.RpcError as e:
                # Mid-stream resume: an UNAVAILABLE failure
                # that carries the resume trailers can be re-issued with
                # received_tokens — the server suppresses what we
                # already hold, so nothing replays. Gated on the same
                # retry budget/backoff as ordinary retries.
                resume_at = (
                    resume_tokens_from(e)
                    if e.code() == grpc.StatusCode.UNAVAILABLE else None
                )
                if (
                    resume_at is not None and self.retry is not None
                    and self.retry.should_retry(e.code(), attempt)
                ):
                    delay = self.retry.delay_s(attempt, retry_after_ms_from(e))
                    self.logger.warn(
                        "stream interrupted; resuming",
                        code=e.code().name, received_tokens=resume_at,
                        attempt=attempt + 1, delay_ms=round(delay * 1e3, 1),
                    )
                    self.retry.sleep(delay)
                    request = self._resume_request(request, resume_at)
                    attempt += 1
                    continue
                # Mid-stream failures without a resume offer are
                # terminal: chunks were already observed, so a blind
                # retry would silently replay output.
                # (text needs no reset here: received is False, so this
                # attempt appended nothing, and text from earlier RESUME
                # attempts must survive — the re-issued request still
                # carries their received_tokens.)
                if not received and self._backoff(e, attempt):
                    attempt += 1
                    continue
                self.logger.error(
                    "gRPC call failed", code=e.code().name, message=e.details()
                )
                raise
        if REPLICA_KEY in trailers:
            # Replica-tier trailers: which replica served, and whether
            # the stream was resumed server-side on a replica failure.
            self.logger.info(
                "Served by replica",
                replica=trailers[REPLICA_KEY],
                restarted=trailers.get(RESTARTED_KEY) == "1",
            )
        if status is not None:
            self.logger.info(
                "Tool execution completed",
                status_code=status.code,
                status_message=status.message,
            )
        if usage is not None:
            self.logger.info(
                "Streaming completed",
                completion_tokens=usage.completion_tokens,
                ttft_ms=round(usage.ttft_ms, 1),
                tokens_per_sec=round(usage.tokens_per_sec, 1),
            )
        return "".join(text)

    def _log_response(self, resp: pk.ExecuteToolResponse) -> None:
        if resp.HasField("status"):
            self.logger.info(
                "Tool execution completed",
                status_code=resp.status.code,
                status_message=resp.status.message,
            )
        arm = resp.WhichOneof("output")
        if arm == "string_output":
            preview = resp.string_output[:100] + (
                "..." if len(resp.string_output) > 100 else ""
            )
            self.logger.info(
                "Received string output",
                output_length=len(resp.string_output),
                output_preview=preview,
            )
        elif arm == "struct_output":
            self.logger.info(
                "Received struct output", field_count=len(resp.struct_output.fields)
            )
        elif arm == "file_output":
            self.logger.info(
                "Received file output",
                file_name=resp.file_output.file_name,
                mime_type=resp.file_output.mime_type,
                size_bytes=len(resp.file_output.content),
            )
        else:
            self.logger.warn("No output returned")


def build_test_request(tool_name: str = "example_tool", prompt: Optional[str] = None):
    request = pk.ExecuteToolRequest(tool_name=tool_name, secret_id="secret-123")
    params: dict = {"example_param": "value", "timestamp": int(time.time())}
    if prompt is not None:
        params["prompt"] = prompt
    request.parameters.update(params)
    request.metadata.CopyFrom(
        cmn.Metadata(
            fields={
                "client_version": "1.0.0",
                "request_source": "dev_client",
                "request_id": f"req-{time.time_ns()}",
            }
        )
    )
    return request


def run(logger: Logger, args: argparse.Namespace) -> None:
    logger.info("Starting polykey client...")

    loader = ConfigLoader()
    cfg = loader.load([])
    if args.server:
        cfg.server_address = args.server
    logger.info(
        "Configuration loaded",
        runtime=str(cfg.detected_runtime),
        server=cfg.server_address,
    )

    logger.info("Testing network connectivity...")
    NetworkTester().test_connection(cfg.server_address)
    logger.info("Network connectivity test passed")

    client = Client(cfg, logger)
    try:
        request = build_test_request(args.tool, args.prompt)
        if args.stream:
            client.execute_tool_stream(request)
        else:
            client.execute_tool(request)
    finally:
        client.close()


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="polykey dev client")
    parser.add_argument("-server", "--server", default="", help="server address")
    parser.add_argument("--tool", default="example_tool")
    parser.add_argument("--prompt", default=None)
    parser.add_argument("--stream", action="store_true")
    parser.add_argument(
        "--raw-logs", action="store_true", help="print JSON logs instead of report"
    )
    args = parser.parse_args(argv)

    buffer = io.StringIO()
    logger = Logger(stream=buffer, level="debug")

    try:
        signal.signal(signal.SIGINT, signal.default_int_handler)
    except ValueError:
        pass  # not on the main thread (tests)

    ok = True
    try:
        run(logger, args)
    except KeyboardInterrupt:
        logger.info("Received shutdown signal")
    except Exception as e:
        logger.error("Application failed", error=str(e))
        ok = False

    lines = buffer.getvalue().splitlines()
    if args.raw_logs:
        sys.stdout.write("\n".join(lines) + "\n")
    else:
        ok = print_jest_report(lines) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
