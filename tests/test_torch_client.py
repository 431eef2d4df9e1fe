"""The port's dev client (polykey_tpu_torch/gateway/client.py, config.py,
beautify.py, log_beautifier.py) against the JAX package's, on the CPU.

- The client against the port's server over a tiny engine: the four PASS
  checks on the mock tool and on `llm_generate --stream`, whose stream
  logs the serving replica behind a replica pool.
- `RetryPolicy`'s delays equal the JAX client's under the same RNG seed;
  the retry loop honours the server's `retry-after-ms` hint, never
  retries DEADLINE_EXCEEDED, and never replays a stream that delivered a
  chunk; the no-serving-replica UNAVAILABLE carries the pool's hint.
- The report and server-log beautifiers print byte for byte what the JAX
  ones print; the config loader parses flags and env alike.
"""

import contextlib
import io
import json
import random
import types

import grpc
import pytest
import torch

from polykey_tpu.gateway import beautify as jbeautify
from polykey_tpu.gateway import client as jclient
from polykey_tpu.gateway import config as jconfig
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import InferenceEngine
from polykey_tpu_torch.engine.replica_pool import DEAD, ReplicaPool
from polykey_tpu_torch.gateway import beautify, client, config, errors
from polykey_tpu_torch.gateway import server as gateway_server
from polykey_tpu_torch.gateway.jsonlog import Logger
from polykey_tpu_torch.gateway.service import Service
from polykey_tpu_torch.gateway.torch_service import TorchService
from polykey_tpu_torch.proto import common_v2_pb2 as cmn
from polykey_tpu_torch.proto import polykey_v2_pb2 as pk

torch.set_num_threads(2)

FIELDS = dict(model="tiny-llama", tokenizer="byte", dtype="float32",
              max_decode_slots=2, page_size=8, num_pages=64, max_seq_len=64,
              prefill_buckets=(16, 32), max_new_tokens_cap=32,
              default_max_new_tokens=6)


def _run(argv):
    """client.main with --raw-logs: (exit code, JSON log entries, report)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = client.main([*argv, "--raw-logs"])
    lines = out.getvalue().splitlines()
    report = io.StringIO()
    beautify.print_jest_report(lines, out=report)
    return rc, [json.loads(line) for line in lines], report.getvalue()


@contextlib.contextmanager
def _serving(target):
    logger = Logger(stream=io.StringIO())
    service = TorchService.create(target, logger=logger)
    server, _, port = gateway_server.build_server(service, logger, address="127.0.0.1:0")
    server.start()
    try:
        yield f"127.0.0.1:{port}"
    finally:
        server.stop(grace=None)
        service.close()


@pytest.mark.parametrize("replicas", [1, 2])
def test_the_four_checks_and_a_stream_against_the_port_server(replicas):
    if replicas == 1:
        target = InferenceEngine(EngineConfig(**FIELDS), device="cpu")
    else:
        target = ReplicaPool.create(EngineConfig(**FIELDS, replicas=2), device="cpu")
    with _serving(target) as addr:
        rc, logs, report = _run(["--server", addr])
        assert rc == 0 and "All 4 checks passed" in report
        rc, logs, report = _run(["--server", addr, "--tool", "llm_generate",
                                 "--prompt", "hello", "--stream"])
        assert rc == 0 and "All 4 checks passed" in report
        msgs = {e["msg"]: e for e in logs}
        assert msgs["Streaming completed"]["completion_tokens"] == 6
        assert msgs["Tool execution completed"]["status_code"] == 200
        if replicas == 2:
            assert msgs["Served by replica"]["replica"] == "0"
            assert msgs["Served by replica"]["restarted"] is False
        else:
            assert "Served by replica" not in msgs
    rc, _logs, report = _run(["--server", addr])       # the server is gone
    assert rc == 1 and "FAIL" in report


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("hint", [None, 80, 2000])
def test_retry_delays_equal_the_jax_clients(seed, hint):
    policy = client.RetryPolicy(max_attempts=6, base_delay_s=0.05, max_delay_s=2.0)
    jpolicy = jclient.RetryPolicy(max_attempts=6, base_delay_s=0.05, max_delay_s=2.0)
    random.seed(seed)
    ours = [policy.delay_s(a, hint) for a in range(6)]
    random.seed(seed)
    theirs = [jpolicy.delay_s(a, hint) for a in range(6)]
    assert ours == theirs
    codes = [grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.RESOURCE_EXHAUSTED,
             grpc.StatusCode.DEADLINE_EXCEEDED, grpc.StatusCode.INTERNAL]
    assert [policy.should_retry(c, a) for c in codes for a in range(7)] == [
        jpolicy.should_retry(c, a) for c in codes for a in range(7)]


class _Scripted(Service):
    """One action a call: an exception to raise, or None to succeed; a
    stream can deliver a chunk before raising."""

    def __init__(self, script, mid_stream=False):
        self.script, self.mid_stream, self.calls = list(script), mid_stream, 0

    def _next(self):
        self.calls += 1
        return self.script.pop(0) if self.script else None

    def execute_tool(self, tool_name, parameters, secret_id, metadata):
        action = self._next()
        if action is not None:
            raise action
        return pk.ExecuteToolResponse(status=cmn.Status(code=200, message="ok"),
                                      string_output="success")

    def execute_tool_stream(self, tool_name, parameters, secret_id, metadata):
        action = self._next()
        if action is not None and self.mid_stream:
            yield pk.ExecuteToolStreamChunk(delta="partial")
        if action is not None:
            raise action
        yield pk.ExecuteToolStreamChunk(delta="whole")
        yield pk.ExecuteToolStreamChunk(final=True, status=cmn.Status(code=200,
                                                                      message="ok"))


@contextlib.contextmanager
def _scripted(script, mid_stream=False):
    service = _Scripted(script, mid_stream)
    server, _, port = gateway_server.build_server(service, Logger(stream=io.StringIO()),
                                                  address="127.0.0.1:0")
    server.start()
    sleeps: list = []
    policy = client.RetryPolicy(max_attempts=4, base_delay_s=0.01, sleep=sleeps.append)
    cfg = types.SimpleNamespace(server_address=f"127.0.0.1:{port}", timeout=5.0)
    cli = client.Client(cfg, Logger(stream=io.StringIO()), retry=policy)
    try:
        yield cli, service, sleeps
    finally:
        cli.close()
        server.stop(grace=None)


def _request():
    return pk.ExecuteToolRequest(tool_name="example_tool")


def test_retry_after_ms_is_honoured():
    with _scripted([errors.ResourceExhaustedError("queue full", retry_after_ms=80)]) as (
            cli, service, sleeps):
        assert cli.execute_tool(_request(), timeout=5).string_output == "success"
        assert service.calls == 2 and len(sleeps) == 1
        assert 0.08 <= sleeps[0] <= 0.08 * 1.25 + 1e-9


def test_unavailable_retries_and_deadline_does_not():
    with _scripted([errors.UnavailableError("engine restarting")] * 2) as (
            cli, service, sleeps):
        assert cli.execute_tool(_request(), timeout=5).string_output == "success"
        assert service.calls == 3 and len(sleeps) == 2
    with _scripted([errors.DeadlineExceededError("deadline exceeded")]) as (
            cli, service, sleeps):
        with pytest.raises(grpc.RpcError) as info:
            cli.execute_tool(_request(), timeout=5)
        assert info.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        assert service.calls == 1 and sleeps == []


def test_a_stream_is_never_replayed_once_a_chunk_arrived():
    with _scripted([errors.UnavailableError("engine restarting")], mid_stream=True) as (
            cli, service, sleeps):
        with pytest.raises(grpc.RpcError):
            cli.execute_tool_stream(_request(), timeout=5)
        assert service.calls == 1 and sleeps == []
    with _scripted([errors.UnavailableError("engine restarting")]) as (
            cli, service, sleeps):
        assert cli.execute_tool_stream(_request(), timeout=5) == "whole"
        assert service.calls == 2 and len(sleeps) == 1


def test_a_pool_with_no_serving_replica_sends_its_recovery_hint():
    """Every replica DEAD: the pool refuses with a retry hint, and the
    client's helper reads it off the UNAVAILABLE."""
    pool = ReplicaPool.create(EngineConfig(**FIELDS, replicas=2), device="cpu")
    for i in range(2):
        pool._transition(i, DEAD)
    with _serving(pool) as addr:
        with grpc.insecure_channel(addr) as channel:
            from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

            request = pk.ExecuteToolRequest(tool_name="llm_generate")
            request.parameters.update({"prompt": "hi"})
            with pytest.raises(grpc.RpcError) as info:
                PolykeyServiceStub(channel).ExecuteTool(request, timeout=10)
    assert info.value.code() == grpc.StatusCode.UNAVAILABLE
    assert client.retry_after_ms_from(info.value) == 1000


def test_trailer_readers_equal_the_jax_clients():
    cases = [
        (), (("retry-after-ms", "250"),), (("retry-after-ms", "x"),),
        (("resume-supported", "1"), ("resume-tokens", "7")),
        (("resume-supported", "1"),), (("resume-tokens", "7"),),
    ]
    for trailers in cases:
        err = types.SimpleNamespace(trailing_metadata=lambda t=trailers: t)
        assert client.trailers_from(err) == jclient.trailers_from(err)
        assert client.retry_after_ms_from(err) == jclient.retry_after_ms_from(err)
        assert client.resume_tokens_from(err) == jclient.resume_tokens_from(err)
    assert client.trailers_from(object()) == {}


def _log(**kw):
    return json.dumps({"time": "t", "level": "INFO", **kw})


REPORTS = {
    "pass": [
        _log(msg="Starting polykey client..."),
        _log(msg="Configuration loaded", runtime="local", server="localhost:50051"),
        _log(msg="Network connectivity test passed"),
        json.dumps({"time": "t", "level": "DEBUG", "msg": "Connection state changed",
                    "state": "READY"}),
        _log(msg="gRPC connection established successfully"),
        _log(msg="Executing tool", tool_name="llm_generate"),
        _log(msg="Served by replica", replica="1", restarted=True),
        _log(msg="Tool execution completed", status_code=200,
             status_message="Tool executed successfully"),
        _log(msg="Received struct output", field_count=3),
        _log(msg="Streaming completed", completion_tokens=6, ttft_ms=1.5,
             tokens_per_sec=20.0),
    ],
    "fail": ["not json", "", "[1, 2]",
             _log(msg="Configuration loaded", server="x"),
             json.dumps({"level": "ERROR", "msg": "Application failed", "error": "boom"})],
    "pytest": [json.dumps({"$report_type": "SessionStart"}),
               json.dumps({"$report_type": "TestReport", "when": "call",
                           "nodeid": "tests/a.py::t1", "outcome": "passed",
                           "duration": 0.012}),
               json.dumps({"$report_type": "TestReport", "when": "setup",
                           "nodeid": "tests/a.py::t1", "outcome": "passed"}),
               json.dumps({"$report_type": "TestReport", "when": "call",
                           "nodeid": "tests/b.py::t2", "outcome": "failed",
                           "duration": 1.5})],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_the_report_is_byte_identical_to_the_jax_beautifiers(name):
    ours, theirs = io.StringIO(), io.StringIO()
    assert beautify.print_jest_report(REPORTS[name], ours) == \
        jbeautify.print_jest_report(REPORTS[name], theirs)
    assert ours.getvalue() == theirs.getvalue()


def test_the_server_log_filter_is_byte_identical_to_the_jax_one():
    method = "/polykey.v2.PolykeyService/ExecuteTool"
    stream = "\n".join([
        "some non-json noise",
        "compose-prefix | " + json.dumps({"msg": "server starting", "address": ":50051"}),
        json.dumps({"msg": "gRPC call finished", "method": "/m", "code": "OK"}),
        json.dumps({"msg": "gRPC call received", "method": method}),
        json.dumps({"msg": "gRPC call finished", "method": method, "duration": "1ms",
                    "code": "OK"}),
        json.dumps({"msg": "gRPC call received", "method": method + "Stream"}),
        json.dumps({"msg": "gRPC call finished", "method": method + "Stream",
                    "duration": "2ms", "code": "Internal"}),
        "{broken json",
        json.dumps({"msg": "server shutting down"}),
        json.dumps({"msg": "server stopped"}),
    ]) + "\n"
    ours, theirs = io.StringIO(), io.StringIO()
    beautify.beautify_server_stream(io.StringIO(stream), ours)
    jbeautify.beautify_server_stream(io.StringIO(stream), theirs)
    assert ours.getvalue() == theirs.getvalue()


class _Detector:
    def __init__(self, runtime):
        self.runtime = runtime

    def detect_runtime(self):
        return self.runtime


@pytest.mark.parametrize("argv, env, runtime", [
    ([], {}, "LOCAL"),
    (["-server", "h:1", "-timeout", "1m30s", "-log-level", "debug", "-env", "prod"], {},
     "LOCAL"),
    (["--server", "h:1"], {"POLYKEY_SERVER_ADDR": "e:2", "POLYKEY_TIMEOUT": "500ms",
                           "POLYKEY_LOG_LEVEL": "warn", "POLYKEY_ENV": "stage"},
     "DOCKER"),
    ([], {"POLYKEY_TIMEOUT": "bogus"}, "KUBERNETES"),
    (["-timeout", "2"], {}, "PODMAN"),
    (["-timeout", "nonsense"], {}, "LOCAL"),
])
def test_the_config_loader_parses_alike(monkeypatch, argv, env, runtime):
    for key in ("POLYKEY_SERVER_ADDR", "POLYKEY_TIMEOUT", "POLYKEY_LOG_LEVEL",
                "POLYKEY_ENV"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)

    def load(module):
        loader = module.ConfigLoader(_Detector(getattr(module.RuntimeEnvironment, runtime)))
        try:
            cfg = loader.load(argv)
        except SystemExit as e:
            return ("exit", str(e))
        return (cfg.server_address, cfg.timeout, cfg.log_level, cfg.environment,
                str(cfg.detected_runtime))

    assert load(config) == load(jconfig)
    for text in ("5s", "1m30s", "500ms", "2h", "1.5", "10us", "3x", ""):
        def parse(module):
            try:
                return module.parse_duration(text)
            except ValueError as e:
                return str(e)

        assert parse(config) == parse(jconfig)
