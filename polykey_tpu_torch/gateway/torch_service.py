"""GPU backend for the Service seam: tool calls → the port's inference
engine (the counterpart of the reference's gateway/tpu_service.py).

The gRPC contract stays the reference's (tool_name + Struct parameters in,
oneof output out). Tools:

- ``llm_generate`` (alias ``generate``) — params: prompt (string,
  required), max_tokens, temperature, top_p, top_k, seed, stop (string or
  list of strings: generation cuts BEFORE the earliest match, which is
  never emitted, and the engine request is cancelled). Unary returns the
  completion as string_output; the streaming RPC emits UTF-8-safe deltas
  and a terminal chunk with Usage (tokens, TTFT, tok/s).
- ``engine_stats`` — struct_output snapshot of engine metrics, pool state
  and kernel launch counts.
- the reference's mock tools (example_tool / struct_tool / file_tool)
  through MockService, including the unknown-tool-is-success contract.
"""

from __future__ import annotations

import collections.abc
import math
import queue
from typing import Iterator

from google.protobuf import struct_pb2

from ..engine.config import EngineConfig
from ..engine.engine import (
    DEADLINE_MSG,
    EngineDeadError,
    EngineOverloadedError,
    GenRequest,
    InferenceEngine,
)
from ..engine.tokenizer import ByteTokenizer, IncrementalDetokenizer
from ..proto import common_v2_pb2 as cmn
from ..proto import polykey_v2_pb2 as pk
from . import errors
from .mock_service import MockService
from .service import Service

_LLM_TOOLS = frozenset({"llm_generate", "generate"})


def _ok() -> cmn.Status:
    return cmn.Status(code=200, message="Tool executed successfully")


class TorchService(Service):
    def __init__(self, engine: InferenceEngine, logger=None):
        self.engine = engine
        self.logger = logger
        self._mock = MockService()

    @classmethod
    def from_env(cls, health=None, logger=None, device=None) -> "TorchService":
        config = EngineConfig.from_env()
        engine = InferenceEngine(config, device=device, health=health, logger=logger)
        if logger is not None:
            logger.info(
                "engine initialized", model=config.model,
                device=str(engine.device), slots=config.max_decode_slots,
                pages=config.num_pages, page_size=config.page_size,
            )
        return cls(engine, logger=logger)

    def close(self) -> None:
        self.engine.shutdown()

    # -- request plumbing ---------------------------------------------------

    def _build_request(self, params: dict) -> GenRequest:
        prompt = params.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("llm_generate requires a non-empty string 'prompt'")
        cfg = self.engine.config
        return GenRequest(
            prompt=prompt,
            deadline=errors.rpc_deadline(),
            max_new_tokens=int(params.get("max_tokens", cfg.default_max_new_tokens)),
            temperature=max(0.0, float(params.get("temperature", 0.0))),
            top_p=min(1.0, max(0.0, float(params.get("top_p", 1.0)))),
            top_k=self._parse_top_k(params),
            seed=self._parse_seed(params),
        )

    @staticmethod
    def _parse_top_k(params: dict) -> int:
        kv = params.get("top_k", 0)
        if isinstance(kv, float) and (not math.isfinite(kv) or kv != int(kv)):
            raise ValueError("'top_k' must be a non-negative integer")
        k = int(kv)
        if k < 0:
            raise ValueError("'top_k' must be a non-negative integer")
        return k

    @staticmethod
    def _parse_seed(params: dict):
        if "seed" not in params:
            return None
        sv = params["seed"]
        # Struct numbers are doubles: beyond 2^53 distinct seeds collide.
        if isinstance(sv, float) and (
            not math.isfinite(sv) or sv != int(sv) or abs(sv) > 2 ** 53
        ):
            raise ValueError(
                "'seed' must be an integer with |seed| <= 2**53 (JSON "
                "numbers are doubles; larger seeds would silently collide)"
            )
        return int(sv)

    @staticmethod
    def _parse_stops(params: dict) -> list[str]:
        stop = params.get("stop")
        if stop is None:
            return []
        if isinstance(stop, str):
            return [stop] if stop else []
        if isinstance(stop, (collections.abc.Mapping, struct_pb2.Struct)):
            raise ValueError("'stop' must be a string or a list of strings")
        try:
            stops = list(stop)
        except TypeError:
            raise ValueError("'stop' must be a string or a list of strings") from None
        if not all(isinstance(s, str) and s for s in stops):
            raise ValueError("'stop' entries must be non-empty strings")
        return stops

    def _submit(self, request: GenRequest) -> None:
        try:
            self.engine.submit(request)
        except EngineOverloadedError as e:
            raise errors.ResourceExhaustedError(
                str(e), retry_after_ms=e.retry_after_ms
            ) from e
        except EngineDeadError as e:
            raise errors.UnavailableError(str(e)) from e

    @staticmethod
    def _engine_error(message: str) -> Exception:
        if message.startswith(DEADLINE_MSG):
            return errors.DeadlineExceededError(message)
        if message.startswith("engine"):
            return errors.UnavailableError(message)
        return RuntimeError(message)

    def _drain(self, request: GenRequest):
        """Yield engine events until done/error; raises on timeout."""
        timeout = self.engine.config.request_timeout_s
        while True:
            try:
                kind, value = request.out.get(timeout=timeout)
            except queue.Empty:
                request.cancelled.set()
                raise errors.DeadlineExceededError("generation timed out") from None
            yield kind, value
            if kind in ("done", "error"):
                return

    def _text_events(self, request: GenRequest, stops: list[str]):
        """Decode tokens into text deltas, applying stop sequences: yields
        ("delta", str) then ("done", timings). Up to max(len(stop))-1
        trailing chars are held back so a stop split across deltas is
        still caught; on a match the request is cancelled and the stream
        ends at the text before the match."""
        tokenizer = self.engine.tokenizer
        incremental = isinstance(tokenizer, ByteTokenizer)
        utf8_tail = b""
        detok = None if incremental else IncrementalDetokenizer(tokenizer)
        hold = max((len(s) for s in stops), default=1) - 1
        buf = ""
        stopped = False
        timings = None
        for kind, value in self._drain(request):
            if kind == "token":
                if incremental:
                    delta, utf8_tail = tokenizer.decode_incremental([value], utf8_tail)
                else:
                    delta = detok.push(value)
                if not delta:
                    continue
                if not stops:
                    yield "delta", delta
                    continue
                buf += delta
                cut = min((i for i in (buf.find(s) for s in stops) if i >= 0),
                          default=-1)
                if cut >= 0:
                    if buf[:cut]:
                        yield "delta", buf[:cut]
                    buf = ""
                    stopped = True
                    request.cancelled.set()
                    break
                if hold and len(buf) > hold:
                    yield "delta", buf[:-hold]
                    buf = buf[-hold:]
                elif not hold:
                    yield "delta", buf
                    buf = ""
            elif kind == "error":
                if buf:
                    yield "delta", buf
                raise self._engine_error(value)
            else:
                timings = value
        if stopped:
            # The cancellation's terminal event still arrives; drain it so
            # the request's queue is not abandoned mid-handshake. Timings
            # live on the request, so Usage survives the cancellation.
            try:
                for _kind, _value in self._drain(request):
                    pass
            except errors.DeadlineExceededError:
                pass
            timings = request.timings
        else:
            buf += detok.flush() if detok is not None else ""
            if buf:
                cut = min((i for i in (buf.find(s) for s in stops) if i >= 0),
                          default=-1)
                if cut >= 0:
                    buf = buf[:cut]
                if buf:
                    yield "delta", buf
        yield "done", timings

    # -- Service interface --------------------------------------------------

    def _engine_stats(self) -> pk.ExecuteToolResponse:
        response = pk.ExecuteToolResponse(status=_ok())
        response.struct_output.update(self.engine.stats())
        return response

    def execute_tool(self, tool_name, parameters, secret_id, metadata):
        if tool_name == "engine_stats":
            return self._engine_stats()
        if tool_name not in _LLM_TOOLS:
            return self._mock.execute_tool(tool_name, parameters, secret_id, metadata)
        params = dict(parameters) if parameters is not None else {}
        request = self._build_request(params)
        stops = self._parse_stops(params)
        self._submit(request)
        if not stops:
            token_ids: list[int] = []
            for kind, value in self._drain(request):
                if kind == "token":
                    token_ids.append(value)
                elif kind == "error":
                    raise self._engine_error(value)
            text = self.engine.tokenizer.decode(token_ids)
        else:
            text = "".join(
                v for k, v in self._text_events(request, stops) if k == "delta"
            )
        return pk.ExecuteToolResponse(status=_ok(), string_output=text)

    def execute_tool_stream(
        self, tool_name, parameters, secret_id, metadata
    ) -> Iterator[pk.ExecuteToolStreamChunk]:
        if tool_name not in _LLM_TOOLS:
            yield from self._mock.execute_tool_stream(
                tool_name, parameters, secret_id, metadata
            )
            return
        params = dict(parameters) if parameters is not None else {}
        request = self._build_request(params)
        stops = self._parse_stops(params)
        self._submit(request)
        timings = None
        try:
            for kind, value in self._text_events(request, stops):
                if kind == "delta":
                    yield pk.ExecuteToolStreamChunk(delta=value)
                else:
                    timings = value
        except GeneratorExit:
            request.cancelled.set()          # client went away mid-stream
            raise
        final = pk.ExecuteToolStreamChunk(final=True, status=_ok())
        if timings is not None:
            final.usage.prompt_tokens = timings.prompt_tokens
            final.usage.completion_tokens = timings.completion_tokens
            final.usage.ttft_ms = timings.ttft_ms
            final.usage.tokens_per_sec = timings.tokens_per_sec
        yield final

