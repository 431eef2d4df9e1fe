"""The port's gRPC gateway in-process, on the CPU engine.

A tiny-llama variant with a 96-id vocabulary serves here, so every
generated id renders as one byte and the text is dense enough to test
`stop`. The mock tools are held to the JAX package's MockService.
"""

import dataclasses
import io
import threading

import grpc
import pytest
import torch
from google.protobuf import struct_pb2

from polykey_tpu.gateway.mock_service import MockService as JMockService
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import InferenceEngine
from polykey_tpu_torch.gateway import server as gateway_server
from polykey_tpu_torch.gateway.jsonlog import Logger
from polykey_tpu_torch.gateway.torch_service import TorchService
from polykey_tpu_torch.models import config as model_config
from polykey_tpu_torch.proto import health_v1_pb2 as health_pb
from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
from polykey_tpu_torch.proto.health_v1_grpc import HealthStub
from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

torch.set_num_threads(2)

CONFIG = EngineConfig(
    model="tiny-llama-ascii",
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


@pytest.fixture(scope="module")
def stack():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(model_config.MODEL_REGISTRY, "tiny-llama-ascii",
                   dataclasses.replace(model_config.TINY_LLAMA,
                                       name="tiny-llama-ascii", vocab_size=96))
        engine = InferenceEngine(CONFIG, device="cpu")
        service = TorchService(engine)
        logger = Logger(stream=io.StringIO(), level="debug")
        server, _health, port = gateway_server.build_server(
            service, logger, address="127.0.0.1:0"
        )
        server.start()
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        yield PolykeyServiceStub(channel), channel, service
        channel.close()
        server.stop(grace=None)
        service.close()


def _llm(prompt="stop test prompt", stream=False, **params):
    request = pk.ExecuteToolRequest(tool_name="llm_generate")
    request.parameters.update({"prompt": prompt, "max_tokens": 24, **params})
    return request


def _text(stub, stream=False, **kw):
    if stream:
        chunks = list(stub.ExecuteToolStream(_llm(**kw), timeout=60))
        assert chunks[-1].final and chunks[-1].status.code == 200
        return "".join(c.delta for c in chunks[:-1])
    resp = stub.ExecuteTool(_llm(**kw), timeout=60)
    assert resp.status.code == 200
    return resp.string_output


def test_llm_generate_unary(stack):
    stub, _, _ = stack
    resp = stub.ExecuteTool(_llm(prompt="hi there", max_tokens=6), timeout=60)
    assert resp.status.code == 200
    assert resp.WhichOneof("output") == "string_output"
    assert len(resp.string_output) == 6        # one byte per generated id


def test_llm_generate_stream_with_usage(stack):
    stub, _, _ = stack
    chunks = list(stub.ExecuteToolStream(_llm(prompt="hi there", max_tokens=6),
                                         timeout=60))
    final = chunks[-1]
    assert final.final and final.status.code == 200
    assert final.usage.prompt_tokens == len("hi there".encode()) + 1
    assert final.usage.completion_tokens == 6
    assert final.usage.ttft_ms > 0
    text = "".join(c.delta for c in chunks[:-1])
    assert text == _text(stub, prompt="hi there", max_tokens=6)


def test_stop_cuts_before_the_match(stack):
    stub, _, _ = stack
    full = _text(stub)
    assert len(full) >= 6, repr(full)
    stop = full[3:6]
    cut = _text(stub, stop=stop)
    assert cut == full[: full.index(stop)] and stop not in cut
    assert _text(stub, stream=True, stop=stop) == cut
    assert _text(stub, stop=["@@never@@", stop]) == cut
    assert _text(stub, stop="@@never@@") == full


def test_bad_parameters_are_rejected(stack):
    stub, _, _ = stack
    request = pk.ExecuteToolRequest(tool_name="llm_generate")
    request.parameters.update({"max_tokens": 4})
    with pytest.raises(grpc.RpcError) as err:
        stub.ExecuteTool(request, timeout=30)
    assert "prompt" in err.value.details()
    with pytest.raises(grpc.RpcError):
        stub.ExecuteTool(_llm(stop=[""]), timeout=30)


def test_engine_stats(stack):
    stub, _, _ = stack
    resp = stub.ExecuteTool(pk.ExecuteToolRequest(tool_name="engine_stats"), timeout=30)
    assert resp.WhichOneof("output") == "struct_output"
    stats = dict(resp.struct_output)
    assert stats["model"] == "tiny-llama-ascii" and stats["device"] == "cpu"
    assert set(dict(stats["kernel_launches"])) == {
        "flash_attention", "paged_attention_decode", "paged_write",
        "ragged_paged_attention", "paged_attention_decode_int8",
        "paged_write_int8", "ragged_paged_attention_int8"}


@pytest.mark.parametrize("tool", ["example_tool", "struct_tool", "file_tool", "nope"])
def test_mock_tools_match_the_reference(stack, tool):
    """Every mock tool, and an unknown one (still status 200, 'Unknown
    tool: X'), answers as the JAX package's MockService does."""
    stub, _, _ = stack
    params = struct_pb2.Struct()
    params.update({"x": 1})
    got = stub.ExecuteTool(pk.ExecuteToolRequest(tool_name=tool, parameters=params),
                           timeout=30)
    want = JMockService().execute_tool(tool, params, None, None)
    assert got.status.code == want.status.code == 200
    assert got.WhichOneof("output") == want.WhichOneof("output")
    if tool == "example_tool":              # carries a timestamp
        assert got.string_output.startswith("Mock execution of example_tool at ")
    elif tool == "nope":
        assert got.string_output == want.string_output == "Unknown tool: nope"
    else:
        kind = got.WhichOneof("output")
        assert getattr(got, kind) == getattr(want, kind)


def test_concurrent_streams(stack):
    stub, _, _ = stack
    errors = []

    def worker(i):
        try:
            chunks = list(stub.ExecuteToolStream(
                _llm(prompt=f"client {i}", max_tokens=5, temperature=0.8, seed=i),
                timeout=120))
            assert chunks[-1].final and chunks[-1].usage.completion_tokens == 5
        except Exception as e:  # collected for the assertion below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors


def test_health_serving(stack):
    _, channel, _ = stack
    health = HealthStub(channel)
    for name in ("", "polykey.v2.PolykeyService"):
        resp = health.Check(health_pb.HealthCheckRequest(service=name), timeout=10)
        assert resp.status == health_pb.HealthCheckResponse.SERVING


def test_backend_selector(monkeypatch):
    """POLYKEY_BACKEND picks the mock by default and the torch engine for
    'engine' or its alias 'tpu'; without CUDA the engine needs
    POLYKEY_DEVICE=cpu."""
    from polykey_tpu_torch.gateway.health import HealthService
    from polykey_tpu_torch.gateway.mock_service import MockService

    logger = Logger(stream=io.StringIO())
    monkeypatch.delenv("POLYKEY_BACKEND", raising=False)
    assert isinstance(gateway_server._default_service(logger, HealthService()),
                      MockService)
    monkeypatch.setenv("POLYKEY_BACKEND", "tpu")
    monkeypatch.delenv("POLYKEY_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="POLYKEY_DEVICE=cpu"):
        gateway_server._default_service(logger, HealthService())
    monkeypatch.setenv("POLYKEY_DEVICE", "cpu")
    monkeypatch.setenv("POLYKEY_MAX_SEQ_LEN", "64")
    monkeypatch.setenv("POLYKEY_PREFILL_BUCKETS", "16,32")
    monkeypatch.setenv("POLYKEY_NUM_PAGES", "16")
    service = gateway_server._default_service(logger, HealthService())
    try:
        assert isinstance(service, TorchService)
        assert service.engine.device.type == "cpu"
    finally:
        service.close()
