"""The port's observability and gateway surfaces against the JAX package's,
on tiny-llama on the CPU: the span tree of one request (names and
nesting, not times), its timeline events in order and their Perfetto
export, the /metrics page's families, types and label sets, the /debug
surface behind POLYKEY_DEBUG_ENDPOINTS, gRPC reflection's responses byte
for byte, the secret store's files across packages, and the
single-flight torch.profiler capture."""

import io
import json
import os
import queue
import time
import urllib.error
import urllib.request

import grpc
import jax
import pytest
import torch
from google.protobuf import struct_pb2

from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.gateway import security as jsecurity
from polykey_tpu.gateway import server as jserver
from polykey_tpu.gateway.mock_service import MockService as JMockService
from polykey_tpu.gateway.tpu_service import TpuService
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu.obs import Observability as JObservability
from polykey_tpu.obs.trace import Span as JSpan
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.gateway import security
from polykey_tpu_torch.gateway import server as gateway_server
from polykey_tpu_torch.gateway.jsonlog import Logger
from polykey_tpu_torch.gateway.mock_service import MockService
from polykey_tpu_torch.gateway.torch_service import TorchService
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.obs import (
    Observability,
    ProfilerBusyError,
    ProfilerCapture,
    engine_timelines,
    to_perfetto,
)
from polykey_tpu_torch.obs.trace import Span
from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
from polykey_tpu_torch.proto import reflection_v1alpha_pb2 as refl_pb
from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

torch.set_num_threads(2)

FIELDS = dict(
    model="tiny-llama",
    tokenizer="byte",
    dtype="float32",
    max_decode_slots=4,
    page_size=8,
    num_pages=64,
    max_seq_len=64,
    prefill_buckets=(16, 32),
    max_new_tokens_cap=32,
    default_max_new_tokens=8,
)
# One prompt per path: a bucket-16 prefill, and one past the largest
# bucket (two chunks of 32).
PROMPTS = ["hello", "a prompt that is longer than the largest bucket"]

# Families of the JAX package's page whose module the port has not yet:
# the SLO signal plane (obs/signals.py) comes with ROADMAP.md A.9's rest,
# beside A.10's autopilot.
UNPORTED_FAMILIES = {
    "polykey_slo_budget_remaining_ratio": "obs/signals.py",
    "polykey_slo_burn_rate": "obs/signals.py",
    "polykey_slo_breaches_total": "obs/signals.py",
}


@pytest.fixture(scope="module")
def engines():
    jparams = jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                             jax.numpy.float32)
    jeng = JInferenceEngine(JEngineConfig(**FIELDS), params=jparams)
    teng = InferenceEngine(EngineConfig(**FIELDS), device="cpu",
                           params=params_from_numpy(jax.device_get(jparams)))
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _drain(request, timeout=60.0):
    tokens, done, error = [], None, None
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            kind, value = request.out.get(timeout=deadline - time.monotonic())
        except queue.Empty:
            break
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            done = value
            break
        else:
            error = value
            break
    return tokens, done, error


def _traced(engine, make, span_cls, prompt):
    """Serve `prompt` with a root span attached; returns (tokens, root
    span, the timeline events recorded from the submit on)."""
    while engine.busy:
        time.sleep(0.01)
    t0 = time.monotonic()
    root = span_cls("/polykey.v2.PolykeyService/ExecuteTool")
    request = make(prompt=prompt, max_new_tokens=8)
    request.trace = root
    engine.submit(request)
    tokens, done, error = _drain(request)
    assert error is None and done is not None
    root.finish()
    while engine.busy:
        time.sleep(0.01)
    time.sleep(0.1)              # the loop's last readbacks land on the ring
    events = [e for e in engine.timeline.events() if e["t"] >= t0]
    return tokens, root, events


def _shape(tree: dict):
    return (tree["name"], sorted(tree.get("attrs", {})),
            [_shape(c) for c in tree.get("children", [])])


@pytest.mark.parametrize("prompt", PROMPTS)
def test_span_tree_and_timeline_match_the_jax_engine(engines, prompt):
    """The same greedy tokens; a span tree of the same names, attribute
    keys and nesting (queue_wait, prefill, decode with a decode_block per
    processed block); the request's timeline events of the same kinds in
    the same order; an export that loads as Perfetto JSON."""
    jeng, teng = engines
    jtokens, jroot, jevents = _traced(jeng, JGenRequest, JSpan, prompt)
    tokens, root, events = _traced(teng, GenRequest, Span, prompt)
    assert tokens == jtokens
    got, want = root.to_dict(), jroot.to_dict()
    assert _shape(got) == _shape(want)
    names = [c["name"] for c in got["children"]]
    assert names[:3] == ["queue_wait", "prefill", "decode"]
    decode = got["children"][2]
    assert sum(c["attrs"]["tokens"] for c in decode["children"]) == 7
    assert decode["attrs"]["tokens"] == 8
    # The request's own events (slot and trace id): admit, its prefill
    # dispatches, first token, retirement.
    mine = [e["kind"] for e in events if e["kind"] in
            ("admit", "prefill", "slot_start", "slot_end", "expire")]
    assert mine == [e["kind"] for e in jevents if e["kind"] in
                    ("admit", "prefill", "slot_start", "slot_end", "expire")]
    assert mine[0] == "admit" and mine[-1] == "slot_end"
    # Engine-wide: every dispatched block is processed, in dispatch order.
    seqs = [e["seq"] for e in events if e["kind"] == "dispatch"]
    assert seqs and seqs == [e["seq"] for e in events if e["kind"] == "process"]
    trace = json.loads(json.dumps(to_perfetto(engine_timelines(teng))))
    slices = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert slices and all(e["dur"] >= 1 for e in slices)
    assert any(e["name"] == "first token" for e in trace["traceEvents"])


def _families(page: str) -> dict:
    """{family: (type, {label-key sets of its samples})}."""
    out: dict = {}
    for line in page.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            out[name] = (kind, set())
        elif line and not line.startswith("#"):
            head = line.split(" ", 1)[0]
            name, _, labels = head.partition("{")
            keys = frozenset(kv.split("=", 1)[0] for kv in labels.rstrip("}").split(",")
                             if kv)
            for family in (name, name.rsplit("_", 1)[0]):
                if family in out:
                    out[family][1].add(keys)
                    break
    return {k: (t, frozenset(ls)) for k, (t, ls) in out.items()}


def test_metrics_page_families_match_the_jax_package(engines):
    """The port's page (TorchService over the engine, plus the RPC counter
    family) has the JAX package's families, types and label sets, but the
    UNPORTED_FAMILIES."""
    jeng, teng = engines
    jobs, obs = JObservability(), Observability()
    TpuService(jeng, obs=jobs)
    TorchService(teng, obs=obs)
    from polykey_tpu.gateway.interceptor import LoggingInterceptor as JInterceptor
    from polykey_tpu_torch.gateway.interceptor import LoggingInterceptor

    JInterceptor(_JLogger(), obs=jobs)
    LoggingInterceptor(Logger(stream=io.StringIO()), obs=obs)
    want, got = _families(jobs.registry.render()), _families(obs.registry.render())
    assert set(UNPORTED_FAMILIES) <= set(want)
    for name in UNPORTED_FAMILIES:
        want.pop(name)
    assert got == want
    assert "polykey_ttft_ms" in got and got["polykey_ttft_ms"][0] == "histogram"


def _JLogger():
    from polykey_tpu.gateway.jsonlog import Logger as JLogger

    return JLogger(stream=io.StringIO())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_grpc_trace_metrics_sidecar_and_debug_surface(engines, monkeypatch, tmp_path):
    """llm_generate over the port's server with an Observability bundle:
    the x-trace-id echo, the recorded tree (queue_wait, prefill, decode,
    detokenize under the RPC's root), engine_stats' metrics_text and trace
    views; the /metrics sidecar's page; /debug/* a 404 until
    POLYKEY_DEBUG_ENDPOINTS=1, then the engine, timeline, flight, trace
    and profile routes (a second capture during one is 409)."""
    _, teng = engines
    obs = Observability()
    logger = Logger(stream=io.StringIO())
    service = TorchService(teng, logger=logger, obs=obs)
    service.profiler = ProfilerCapture(base_dir=str(tmp_path), recorder=obs.recorder)
    server, _health, port = gateway_server.build_server(
        service, logger, address="127.0.0.1:0", obs=obs)
    server.start()
    sidecar = gateway_server.start_metrics_server(obs, logger, service=service, port=0)
    base = f"http://127.0.0.1:{sidecar.port}"
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            stub = PolykeyServiceStub(channel)
            request = pk.ExecuteToolRequest(tool_name="llm_generate")
            request.parameters.update({"prompt": "hello", "max_tokens": 6})
            resp, call = stub.ExecuteTool.with_call(
                request, timeout=60, metadata=(("x-trace-id", "trace-one"),))
            assert resp.status.code == 200
            assert dict(call.trailing_metadata())["x-trace-id"] == "trace-one"
            tree = obs.recorder.last()
            assert tree["trace_id"] == "trace-one" and tree["attrs"]["tool"] == "llm_generate"
            assert [c["name"] for c in tree["children"]] == [
                "queue_wait", "prefill", "decode", "detokenize"]
            text = stub.ExecuteTool(pk.ExecuteToolRequest(
                tool_name="engine_stats", parameters=_struct(view="metrics_text")),
                timeout=30).string_output
            assert "polykey_ttft_ms_count" in text and "polykey_rpcs_total" in text
            dump = stub.ExecuteTool(pk.ExecuteToolRequest(
                tool_name="engine_stats", parameters=_struct(view="trace")), timeout=30)
            assert dump.struct_output["traces"][-1]["trace_id"] == "trace-one"
            stats = stub.ExecuteTool(pk.ExecuteToolRequest(tool_name="engine_stats"),
                                     timeout=30).struct_output
            assert stats["last_trace"]["trace_id"] == "trace-one"
        status, body = _get(base + "/metrics")
        assert status == 200 and b"polykey_engine_up 1" in body
        assert _get(base + "/healthz") == (200, b"ok\n")
        monkeypatch.delenv("POLYKEY_DEBUG_ENDPOINTS", raising=False)
        assert _get(base + "/debug/engine")[0] == 404
        monkeypatch.setenv("POLYKEY_DEBUG_ENDPOINTS", "1")
        status, body = _get(base + "/debug/engine")
        assert status == 200 and json.loads(body)["device"] == "cpu"
        status, body = _get(base + "/debug/timeline")
        assert status == 200 and json.loads(body)["traceEvents"]
        status, body = _get(base + "/debug/flight")
        assert status == 200 and set(json.loads(body)) == {"traces", "events"}
        assert _get(base + "/debug/trace/trace-one")[0] == 200
        assert _get(base + "/debug/trace/absent")[0] == 404
        service.profiler.start()
        assert _get(base + "/debug/profile?seconds=0.1")[0] == 409
        service.profiler.stop()
        status, body = _get(base + "/debug/profile?seconds=0.1")
        assert status == 200 and os.path.exists(json.loads(body)["trace"])
    finally:
        sidecar.stop()
        server.stop(grace=None)


def _struct(**kv):
    s = struct_pb2.Struct()
    s.update(kv)
    return s


REFLECTION = [
    ("grpc.reflection.v1alpha.ServerReflection", "list_services", ""),
    ("grpc.reflection.v1", "list_services", ""),
    ("grpc.reflection.v1alpha.ServerReflection", "file_containing_symbol",
     "polykey.v2.PolykeyService"),
    ("grpc.reflection.v1.ServerReflection", "file_containing_symbol",
     "grpc.health.v1.Health"),
    ("grpc.reflection.v1alpha.ServerReflection", "file_by_filename",
     "polykey_v2.proto"),
    ("grpc.reflection.v1alpha.ServerReflection", "file_containing_symbol",
     "no.such.Symbol"),
]


def _reflect(port: int, service: str, which: str, value: str) -> bytes:
    if not service.endswith("ServerReflection"):
        service += ".ServerReflection"
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        call = channel.stream_stream(
            f"/{service}/ServerReflectionInfo",
            request_serializer=refl_pb.ServerReflectionRequest.SerializeToString,
            response_deserializer=lambda b: b,
        )
        request = refl_pb.ServerReflectionRequest(host="h", **{which: value})
        return b"".join(call(iter([request]), timeout=30))


@pytest.fixture(scope="module")
def servers():
    jsrv, _, jport = jserver.build_server(JMockService(), _JLogger(),
                                          address="127.0.0.1:0")
    tsrv, _, tport = gateway_server.build_server(
        MockService(), Logger(stream=io.StringIO()), address="127.0.0.1:0")
    jsrv.start()
    tsrv.start()
    yield jport, tport
    jsrv.stop(grace=None)
    tsrv.stop(grace=None)


@pytest.mark.parametrize("service, which, value", REFLECTION)
def test_reflection_is_byte_identical_to_the_jax_server(servers, service, which, value):
    jport, tport = servers
    got = _reflect(tport, service, which, value)
    assert got and got == _reflect(jport, service, which, value)
    if which == "list_services":
        response = refl_pb.ServerReflectionResponse.FromString(got)
        assert [s.name for s in response.list_services_response.service] == [
            "polykey.v2.PolykeyService", "grpc.health.v1.Health",
            "grpc.reflection.v1.ServerReflection",
            "grpc.reflection.v1alpha.ServerReflection"]
    assert set(gateway_server._SERVICE_TABLE) == set(jserver._SERVICE_TABLE)


KEY = "11" * 32


@pytest.mark.parametrize("writer, reader", [(jsecurity, security), (security, jsecurity)])
def test_a_secret_store_file_decrypts_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "secrets.json")
    store = writer.SecretStore(writer.SecretCipher.from_hex(KEY))
    store.put("db-password", "hunter2")
    store.put("api", "k-123")
    store.save(path)
    loaded = reader.SecretStore(reader.SecretCipher.from_hex(KEY))
    loaded.load(path)
    assert loaded.resolve("db-password") == "hunter2" and loaded.resolve("api") == "k-123"
    assert loaded.resolve("absent") is None and len(loaded) == 2


def test_the_service_resolves_secret_ids_from_env(engines, tmp_path, monkeypatch):
    """POLYKEY_SECRET_KEY and POLYKEY_SECRETS_FILE mount the store; a known
    id logs "secret resolved", an unknown one "secret unknown", and
    neither fails the request."""
    _, teng = engines
    path = str(tmp_path / "secrets.json")
    store = jsecurity.SecretStore(jsecurity.SecretCipher.from_hex(KEY))
    store.put("known", "value")
    store.save(path)
    monkeypatch.setenv("POLYKEY_SECRET_KEY", KEY)
    monkeypatch.setenv("POLYKEY_SECRETS_FILE", path)
    stream = io.StringIO()
    service = TorchService(teng, logger=Logger(stream=stream),
                           secrets=security.SecretStore.from_env())
    for secret_id in ("known", "unknown"):
        resp = service.execute_tool("example_tool", _struct(x=1), secret_id, None)
        assert resp.status.code == 200
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert [(r["msg"], r["secret_id"]) for r in lines if "secret_id" in r] == [
        ("secret resolved", "known"), ("secret unknown", "unknown")]
    monkeypatch.delenv("POLYKEY_SECRET_KEY")
    assert security.SecretStore.from_env() is None


def test_profiler_capture_is_single_flight_and_writes_a_trace(engines, tmp_path):
    """The engine_profile tool over torch.profiler on the CPU: start,
    a request, stop leaves trace.json; a second start during a capture
    raises ProfilerBusyError (a ValueError) and does not disturb it."""
    _, teng = engines
    service = TorchService(teng)
    service.profiler = ProfilerCapture(base_dir=str(tmp_path))
    log_dir = str(tmp_path / "capture")
    resp = service.execute_tool("engine_profile", _struct(action="start", log_dir=log_dir),
                                None, None)
    assert resp.struct_output["profiling"] is True
    with pytest.raises(ProfilerBusyError):
        service.profiler.start()
    with pytest.raises(ValueError, match="already tracing"):
        service.execute_tool("engine_profile", _struct(action="start"), None, None)
    service.execute_tool("llm_generate", _struct(prompt="hello", max_tokens=4), None, None)
    resp = service.execute_tool("engine_profile", _struct(action="stop"), None, None)
    assert resp.struct_output["profiling"] is False
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(ValueError, match="not tracing"):
        service.profiler.stop()
    assert service.profiler.status()["captures"] == 1
