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
  and kernel launch counts, the supervisor's restart count and the most
  recent traced request's span tree. ``view: "metrics_text"`` returns
  the Prometheus page as string_output (the bytes of /metrics);
  ``view: "trace"`` the flight recorder's span trees and events.
- ``engine_profile`` — action start | stop | status on the shared
  single-flight torch.profiler capture (obs/profiler.py), the one
  /debug/profile also uses.
- the reference's mock tools (example_tool / struct_tool / file_tool)
  through MockService, including the unknown-tool-is-success contract.

`create` wires the watchdog and, under `supervise` (the default), the
supervisor that restarts a dead engine in the process on the same
weights; a `ReplicaPool` (engine/replica_pool.py, POLYKEY_REPLICAS > 1)
passes through as it is, since it owns a watchdog and a supervisor per
replica, and so does a `DisaggPool` (engine/disagg_pool.py,
POLYKEY_DISAGG="PxD"), whose supervision lives in each worker process and
whose liveness in the coordinator's heartbeat. `from_env` arms the
autopilot (engine/autopilot.py) when POLYKEY_AUTOPILOT=1. Successful RPCs
carry the `device-ms`, `replica` and `restarted` trailers, and behind a
disaggregated pool the `tier` breadcrumb ("prefill=P,decode=D"). `secret_id` resolves through the encrypted store
(gateway/security.py) when POLYKEY_SECRET_KEY is set, and never fails a
request.
"""

from __future__ import annotations

import collections.abc
import math
import os
import queue
import time
from typing import Iterator, Optional

from google.protobuf import struct_pb2

from ..engine import lockstep
from ..engine.config import EngineConfig
from ..engine.engine import (
    DEADLINE_MSG,
    EngineDeadError,
    EngineOverloadedError,
    GenRequest,
    InferenceEngine,
)
from ..engine.disagg_pool import DisaggPool
from ..engine.replica_pool import ReplicaPool
from ..engine.supervisor import EngineSupervisor
from ..engine.tokenizer import ByteTokenizer, IncrementalDetokenizer
from ..engine.watchdog import Watchdog
from ..obs import Counter, Gauge, Observability, current_span, engine_collector
from ..obs.profiler import ProfilerCapture
from ..proto import common_v2_pb2 as cmn
from ..proto import polykey_v2_pb2 as pk
from . import errors
from .mock_service import MockService
from .service import Service

_LLM_TOOLS = frozenset({"llm_generate", "generate"})


def _ok() -> cmn.Status:
    return cmn.Status(code=200, message="Tool executed successfully")


class TorchService(Service):
    def __init__(
        self,
        engine: InferenceEngine,
        watchdog: Optional[Watchdog] = None,
        secrets=None,
        logger=None,
        obs: Optional[Observability] = None,
    ):
        self.engine = engine
        self.watchdog = watchdog
        # Set by create() under supervision; the supervisor swaps
        # `self.engine` to the fresh instance after every restart.
        self.supervisor: Optional[EngineSupervisor] = None
        # Set by from_env() under POLYKEY_AUTOPILOT=1; close() stops it
        # before the engine, so no actuation races the teardown.
        self.autopilot = None
        self.secrets = secrets      # gateway.security.SecretStore or None
        self.logger = logger
        self.obs = obs
        self.stall_counter = None
        self.restart_counter = None
        self._mock = MockService()
        # One single-flight profiler for the engine_profile tool and the
        # /debug/profile trigger: torch.profiler is process-global.
        self.profiler = ProfilerCapture(
            recorder=obs.recorder if obs is not None else None
        )
        if obs is not None:
            # SLO breach events land in the flight recorder beside the
            # watchdog trips: every replica's signal plane gets it.
            from ..obs.signals import bind_recorder

            bind_recorder(engine, obs.recorder)
            # A registry holds ONE engine's families (the names carry no
            # engine label): the first service to register wins. The scrape
            # reads `self.engine`, not the constructor argument, so it
            # follows a supervised restart to the live engine.
            _up, created = obs.registry.get_or_create(
                Gauge, "polykey_engine_up", "1 while the engine thread is alive.",
                fn=lambda: 0.0 if self.engine.dead else 1.0,
            )
            if created:
                obs.registry.register_collector(engine_collector(lambda: self.engine))
            self.stall_counter, _ = obs.registry.get_or_create(
                Counter, "polykey_watchdog_stalls_total",
                "Watchdog trips on a wedged engine step loop.",
            )
            self.restart_counter, _ = obs.registry.get_or_create(
                Counter, "polykey_engine_restarts_total",
                "Supervised in-process engine restarts.",
            )

    @classmethod
    def create(cls, engine: InferenceEngine, health=None, logger=None, secrets=None,
               obs: Optional[Observability] = None, engine_factory=None) -> "TorchService":
        """A service with its watchdog and, when `engine.config.supervise`
        (the default), its supervisor, wired to the shared observability
        bundle (flight-recorder events, stall and restart counters). The
        default factory builds the replacement on the dead engine's own
        weights (`InferenceEngine(..., reuse=dead._ctor_args)`): no second
        copy on the card, no second checkpoint read. `engine_factory`
        overrides it. A `ReplicaPool` passes through as it is: it owns a
        watchdog and a supervisor per replica (one watchdog cannot watch N
        engines); a `DisaggPool` too: its engines are supervised in their
        worker processes and watched by its heartbeat."""
        service = cls(engine, None, secrets=secrets, logger=logger, obs=obs)
        if isinstance(engine, (ReplicaPool, DisaggPool)):
            return service
        config = engine.config
        recorder = obs.recorder if obs is not None else None
        watchdog = Watchdog(
            engine, health=health, logger=logger, recorder=recorder,
            stall_counter=service.stall_counter,
            # The reference's 5 s tick at the default 300 s window; a
            # shorter window is checked four times over.
            check_interval_s=min(5.0, config.watchdog_timeout_s / 4),
        )
        watchdog.start()
        service.watchdog = watchdog
        if config.supervise:
            device = engine.device
            # A mesh leader's failure restarts the whole mesh in process
            # (engine/lockstep.py): its end sends "restart", and the
            # followers rebuild at the word this factory gives.
            engine.mesh_restart = engine.mesh is not None and not engine.is_follower

            def restart():
                dead = service.engine
                if dead.mesh is None:
                    return InferenceEngine(config, device=device, health=health,
                                           logger=logger, reuse=dead._ctor_args)
                if dead.is_follower:
                    raise NotImplementedError(
                        "a follower rank of a mesh is rebuilt at its leader's restart "
                        "only; a follower's own failure ends the mesh")
                return lockstep.restart(dead)

            factory = engine_factory or restart
            supervisor = EngineSupervisor(
                engine, factory, watchdog=watchdog, health=health, logger=logger,
                recorder=recorder, restart_counter=service.restart_counter,
                max_restarts=config.max_engine_restarts,
                restart_window_s=config.restart_window_s,
            )
            supervisor.add_restart_listener(
                lambda fresh: setattr(service, "engine", fresh))
            supervisor.add_giveup_listener(lambda _reason: lockstep.release(service.engine))
            supervisor.start()
            service.supervisor = supervisor
        return service

    @classmethod
    def from_env(cls, health=None, logger=None, obs: Optional[Observability] = None,
                 device=None) -> "TorchService":
        from .security import SecretStore

        config = EngineConfig.from_env()
        if config.disagg:
            # POLYKEY_DISAGG="PxD": prefill and decode worker PROCESSES
            # behind the coordinator; unset, no process and no pool.
            engine = DisaggPool.create(
                config, health=health, logger=logger, obs=obs, device=device,
                state_dir=os.environ.get("POLYKEY_DISAGG_STATE_DIR") or None,
            )
        elif config.replicas > 1:
            # POLYKEY_REPLICAS engines on one set of weights behind the
            # routing pool; 1 (the default) keeps the single engine.
            engine = ReplicaPool.create(config, health=health, logger=logger,
                                        obs=obs, device=device)
        else:
            engine = InferenceEngine(config, device=device, health=health,
                                     logger=logger)
        service = cls.create(engine, health=health, logger=logger,
                             secrets=SecretStore.from_env(logger), obs=obs)
        # POLYKEY_AUTOPILOT=1 arms the controller over whatever this
        # process serves; unset, nothing is constructed. A refusal (the
        # signal plane is off) fails the boot.
        from ..engine.autopilot import maybe_start

        service.autopilot = maybe_start(service.engine, supervisor=service.supervisor,
                                        obs=obs, logger=logger)
        if logger is not None:
            first = engine.replicas[0].engine if config.replicas > 1 else engine
            logger.info(
                "engine initialized", model=config.model,
                device=str(getattr(first, "device", "worker processes")),
                replicas=config.replicas, disagg=config.disagg,
                slots=config.max_decode_slots,
                pages=config.num_pages, page_size=config.page_size,
                supervise=config.supervise,
                mesh=(engine.stats()["mesh"]
                      if getattr(engine, "mesh", None) is not None else None),
            )
        return service

    def _resolve_secret(self, secret_id) -> None:
        """Resolve `secret_id` through the encrypted store. Unknown ids are
        not errors — the reference ignores secret_id entirely, so
        resolution only adds observability, never failure."""
        if not secret_id or self.secrets is None:
            return
        resolved = self.secrets.resolve(secret_id) is not None
        if self.logger is not None:
            self.logger.info("secret resolved" if resolved else "secret unknown",
                             secret_id=secret_id)

    def close(self) -> None:
        # Autopilot, supervisor and watchdog first: no actuation or
        # restart may race the teardown.
        if self.autopilot is not None:
            self.autopilot.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.watchdog is not None:
            self.watchdog.stop()
        self.engine.shutdown()
        lockstep.release(self.engine)

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
            # A pool with no serving replica estimates its recovery: the
            # hint rides the UNAVAILABLE as `retry-after-ms`.
            trailers: tuple = ()
            if e.retry_after_ms is not None:
                trailers = ((errors.RETRY_AFTER_MS_KEY, str(int(e.retry_after_ms))),)
            raise errors.UnavailableError(str(e), trailers=trailers) from e

    @staticmethod
    def _stamp_serving_trailers(request: GenRequest) -> None:
        """Success-path trailers: the request's attributed device time
        (`device-ms`) and, behind a replica pool, which replica served
        (`replica`) and whether the stream resumed on another one
        (`restarted`); behind a disaggregated pool the prefill/decode
        worker pair that served it (`tier`)."""
        trailers = []
        device_ms = request.timings.device_ms
        if device_ms > 0:
            trailers.append((errors.DEVICE_MS_KEY, f"{device_ms:.2f}"))
        replica = getattr(request, "replica", None)
        if replica is not None:
            trailers.append((errors.REPLICA_KEY, str(replica)))
            if getattr(request, "restarted", False):
                trailers.append((errors.RESTARTED_KEY, "1"))
        tier = getattr(request, "tier", None)
        if tier is not None:
            trailers.append((errors.TIER_KEY, str(tier)))
        if trailers:
            errors.add_rpc_trailers(*trailers)

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
        detok_s = 0.0     # cumulative detokenize wall time (trace span)
        for kind, value in self._drain(request):
            if kind == "token":
                t0 = time.monotonic()
                if incremental:
                    delta, utf8_tail = tokenizer.decode_incremental([value], utf8_tail)
                else:
                    delta = detok.push(value)
                detok_s += time.monotonic() - t0
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
            t0 = time.monotonic()
            buf += detok.flush() if detok is not None else ""
            detok_s += time.monotonic() - t0
            if buf:
                cut = min((i for i in (buf.find(s) for s in stops) if i >= 0),
                          default=-1)
                if cut >= 0:
                    buf = buf[:cut]
                if buf:
                    yield "delta", buf
        if request.trace is not None and detok_s > 0:
            # Detokenizing interleaves with decode: one span of its
            # cumulative duration, anchored at the stream's end.
            end = time.monotonic()
            request.trace.child("detokenize", start=end - detok_s, end=end,
                                cumulative=True)
        yield "done", timings

    # -- Service interface --------------------------------------------------

    def _engine_profile(self, parameters) -> pk.ExecuteToolResponse:
        """torch.profiler capture: action = start | stop | status; log_dir
        (start only). A capture started here makes /debug/profile answer
        409 (and vice versa); ProfilerBusyError is a ValueError."""
        params = dict(parameters) if parameters is not None else {}
        action = params.get("action", "status")
        if action == "start":
            log_dir = params.get("log_dir")
            self.profiler.start(str(log_dir) if log_dir else None)
        elif action == "stop":
            self.profiler.stop()
            if self.logger is not None:
                self.logger.info("profiler trace captured")
        elif action != "status":
            raise ValueError(f"unknown profiler action {action!r}; use start/stop/status")
        response = pk.ExecuteToolResponse(status=_ok())
        status = self.profiler.status()
        response.struct_output.update({"profiling": status["profiling"],
                                       "log_dir": status["log_dir"]})
        return response

    def _engine_stats(self, parameters) -> pk.ExecuteToolResponse:
        """Views: `stats` (default: counters, percentiles, the supervisor's
        restarts, the last traced llm request's span tree), `metrics_text`
        (the Prometheus page), `trace` (the flight recorder)."""
        params = dict(parameters) if parameters is not None else {}
        view = params.get("view", "stats")
        response = pk.ExecuteToolResponse(status=_ok())
        if view in ("metrics_text", "prometheus", "trace") and self.obs is None:
            raise ValueError(f"the {view} view needs observability wiring (serve via "
                             "gateway.server or pass obs= to TorchService)")
        if view in ("metrics_text", "prometheus"):
            response.string_output = self.obs.registry.render()
            return response
        if view == "trace":
            response.struct_output.update({"traces": self.obs.recorder.traces(),
                                           "events": self.obs.recorder.events()})
            return response
        if view != "stats":
            raise ValueError(f"unknown engine_stats view {view!r}; "
                             "use stats, metrics_text, or trace")
        stats = self.engine.stats()
        if self.supervisor is not None:
            stats["engine_restarts"] = self.supervisor.restarts
            stats["supervisor_gave_up"] = self.supervisor.gave_up
        if self.obs is not None:
            last = self.obs.recorder.last(
                lambda t: t.get("attrs", {}).get("tool") in _LLM_TOOLS)
            if last is not None:
                stats["last_trace"] = last
        response.struct_output.update(stats)
        return response

    def execute_tool(self, tool_name, parameters, secret_id, metadata):
        self._resolve_secret(secret_id)
        span = current_span()
        if span is not None:
            span.set(tool=tool_name)
        if tool_name == "engine_profile":
            return self._engine_profile(parameters)
        if tool_name == "engine_stats":
            return self._engine_stats(parameters)
        if tool_name not in _LLM_TOOLS:
            return self._mock.execute_tool(tool_name, parameters, secret_id, metadata)
        params = dict(parameters) if parameters is not None else {}
        request = self._build_request(params)
        request.trace = span
        stops = self._parse_stops(params)
        self._submit(request)
        if not stops:
            token_ids: list[int] = []
            for kind, value in self._drain(request):
                if kind == "token":
                    token_ids.append(value)
                elif kind == "error":
                    raise self._engine_error(value)
            t0 = time.monotonic()
            text = self.engine.tokenizer.decode(token_ids)
            if request.trace is not None:
                request.trace.child("detokenize", start=t0, end=time.monotonic(),
                                    tokens=len(token_ids))
        else:
            text = "".join(
                v for k, v in self._text_events(request, stops) if k == "delta"
            )
        self._stamp_serving_trailers(request)
        return pk.ExecuteToolResponse(status=_ok(), string_output=text)

    def execute_tool_stream(
        self, tool_name, parameters, secret_id, metadata
    ) -> Iterator[pk.ExecuteToolStreamChunk]:
        self._resolve_secret(secret_id)
        span = current_span()
        if span is not None:
            span.set(tool=tool_name)
        if tool_name not in _LLM_TOOLS:
            yield from self._mock.execute_tool_stream(
                tool_name, parameters, secret_id, metadata
            )
            return
        params = dict(parameters) if parameters is not None else {}
        request = self._build_request(params)
        request.trace = span
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
            if span is not None:
                # Stamped now: the interceptor freezes the tree the moment
                # this unwinds, before the engine finishes the slot.
                span.set(client_disconnected=True)
            raise
        self._stamp_serving_trailers(request)
        final = pk.ExecuteToolStreamChunk(final=True, status=_ok())
        if timings is not None:
            final.usage.prompt_tokens = timings.prompt_tokens
            final.usage.completion_tokens = timings.completion_tokens
            final.usage.ttft_ms = timings.ttft_ms
            final.usage.tokens_per_sec = timings.tokens_per_sec
        yield final

