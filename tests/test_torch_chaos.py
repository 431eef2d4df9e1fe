"""Chaos on the port's serving shell, on the CPU (the counterparts of
tests/test_chaos.py): fault injection drives the shedding, deadline,
watchdog and supervisor paths, held to the JAX package where both decide.

- Shedding (the repair): with the same service-time EWMA and the same
  queue, a deadline-bound submit is shed, or not, exactly as the JAX
  engine decides, with its `retry_after_ms`; over gRPC both sheds map to
  RESOURCE_EXHAUSTED with that `retry-after-ms` trailer beside the
  `x-trace-id` echo.
- `step-stall` trips the watchdog; the supervisor restarts the engine on
  the same weights (no copy), health goes NOT_SERVING then SERVING, and
  the restarted engine's greedy streams equal the JAX bucketed engine's.
  A thread still wedged at the restart is failed from the supervisor,
  kept as an orphan and released once it exits.
- A persistent stall exhausts the restart budget (health stays
  NOT_SERVING); `prefill-error` fails its own request; `tokenizer-error`
  and `alloc-fail` degrade as in the reference.

Timeouts are test-scaled (watchdog 0.25 s, check intervals 0.05 s) and
every wait is bounded.
"""

import dataclasses
import io
import queue
import time

import grpc
import jax
import pytest
import torch

from polykey_tpu import faults as jfaults
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import EngineOverloadedError as JOverloaded
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch import faults
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import (
    EngineOverloadedError,
    GenRequest,
    InferenceEngine,
)
from polykey_tpu_torch.engine.supervisor import EngineSupervisor
from polykey_tpu_torch.engine.watchdog import Watchdog
from polykey_tpu_torch.gateway import server as gateway_server
from polykey_tpu_torch.gateway.health import NOT_SERVING, SERVING, HealthService
from polykey_tpu_torch.gateway.jsonlog import Logger
from polykey_tpu_torch.gateway.torch_service import TorchService
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.obs import Observability
from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

torch.set_num_threads(2)

FIELDS = dict(
    model="tiny-llama",
    tokenizer="byte",
    dtype="float32",
    max_decode_slots=1,            # one slot: queueing is deterministic
    page_size=8,
    num_pages=64,
    max_seq_len=64,
    prefill_buckets=(16, 32),
    max_new_tokens_cap=32,
    default_max_new_tokens=8,
    decode_block_steps=1,          # per-token dispatch: slow-step paces finely
    adaptive_block=False,
    lookahead_blocks=1,
    max_queue_depth=1,
)
CHAOS = EngineConfig(**FIELDS, watchdog_timeout_s=0.25)   # test-scaled window
PROMPTS = ["after restart", "hello", "a prompt for the 32 bucket"]


@pytest.fixture(autouse=True)
def _clean_injectors(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def weights():
    """One tiny-llama tree for both packages (JAX init, numpy into torch)."""
    jparams = jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                             jax.numpy.float32)
    return jparams, params_from_numpy(jax.device_get(jparams))


@pytest.fixture(scope="module")
def jax_greedy(weights):
    """The JAX bucketed engine's greedy streams of PROMPTS (the oracle)."""
    jeng = JInferenceEngine(JEngineConfig(**FIELDS), params=weights[0])
    try:
        out = []
        for prompt in PROMPTS:
            request = JGenRequest(prompt=prompt, max_new_tokens=8)
            jeng.submit(request)
            tokens, done, error = _drain(request)
            assert error is None and done is not None
            out.append(tokens)
        return out
    finally:
        jeng.shutdown()


def _drain(request, timeout=30.0):
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


def _await(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _greedy(engine, prompts=PROMPTS):
    out = []
    for prompt in prompts:
        request = GenRequest(prompt=prompt, max_new_tokens=8)
        engine.submit(request)
        tokens, done, error = _drain(request)
        assert error is None and done is not None, error
        out.append(tokens)
    return out


class _HealthLog(HealthService):
    """A HealthService that records its transitions."""

    def __init__(self):
        super().__init__()
        self.transitions = []
        self.set_serving_status("", SERVING)

    def shutdown(self):
        self.transitions.append("NOT_SERVING")
        super().shutdown()

    def resume_serving(self):
        self.transitions.append("SERVING")
        super().resume_serving()


def _held(engine):
    """Hold the engine's submit queue: its loop admits nothing."""
    engine._admit = lambda budget=None: (False, 0)
    return engine


def _shed(engine, request):
    try:
        engine.submit(request)
    except (EngineOverloadedError, JOverloaded) as e:
        return str(e), e.retry_after_ms
    return None


@pytest.mark.parametrize("ewma_s, slots", [(0.0, 1), (2.0, 1), (0.9, 4), (0.01, 2)])
def test_deadline_shed_and_retry_hint_match_the_jax_engine(weights, ewma_s, slots):
    """Both engines with the same service-time EWMA and three queued
    requests: a submit whose deadline the estimated queue delay overruns
    is shed by both with the same message and retry_after_ms; one with
    room is queued by both; the queue bound then sheds both alike."""
    fields = dict(FIELDS, max_decode_slots=slots, max_queue_depth=5)
    jeng = _held(JInferenceEngine(JEngineConfig(**fields), params=weights[0]))
    teng = _held(InferenceEngine(EngineConfig(**fields), params=weights[1], device="cpu"))
    try:
        for eng, make in ((jeng, JGenRequest), (teng, GenRequest)):
            eng.metrics._service_ewma_s = ewma_s
            for i in range(3):
                eng.submit(make(prompt=f"queued {i}", max_new_tokens=4))
        est = 3 * ewma_s / slots
        for budget_s in (0.5 * est, 0.002, 2 * est + 60.0):
            now = time.monotonic()
            want = _shed(jeng, JGenRequest(prompt="d", deadline=now + budget_s))
            got = _shed(teng, GenRequest(prompt="d", deadline=now + budget_s))
            assert got == want, (budget_s, got, want)
        while jeng._submit.qsize() < 5:
            jeng.submit(JGenRequest(prompt="fill"))
            teng.submit(GenRequest(prompt="fill"))
        assert teng._submit.qsize() == 5
        want = _shed(jeng, JGenRequest(prompt="over"))
        got = _shed(teng, GenRequest(prompt="over"))
        assert got is not None and got == want
        assert (teng.metrics.snapshot()["requests_shed"]
                == jeng.metrics.snapshot()["requests_shed"])
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_grpc_sheds_map_to_resource_exhausted_with_the_jax_trailer(weights):
    """Over the port's gRPC stack (TorchService.create, an Observability
    bundle), a queue-full shed and a deadline shed answer
    RESOURCE_EXHAUSTED with the retry-after-ms the JAX engine computes at
    the same EWMA and slots, and the x-trace-id echo survives the merge."""
    fields = dict(FIELDS, max_queue_depth=2)
    jeng = _held(JInferenceEngine(JEngineConfig(**fields), params=weights[0]))
    teng = _held(InferenceEngine(EngineConfig(**fields), params=weights[1], device="cpu"))
    obs = Observability()
    logger = Logger(stream=io.StringIO())
    service = TorchService.create(teng, logger=logger, obs=obs)
    server, _health, port = gateway_server.build_server(
        service, logger, address="127.0.0.1:0", obs=obs)
    server.start()
    try:
        for eng in (jeng, teng):
            eng.metrics._service_ewma_s = 1.5
        teng.submit(GenRequest(prompt="queued"))
        want = jeng._retry_after_ms()
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            grpc.channel_ready_future(channel).result(timeout=5)
            stub = PolykeyServiceStub(channel)
            request = pk.ExecuteToolRequest(tool_name="llm_generate")
            request.parameters.update({"prompt": "shed", "max_tokens": 4})
            # Deadline shed: 1 queued x 1.5 s over 1 slot > a 1 s deadline.
            with pytest.raises(grpc.RpcError) as err:
                stub.ExecuteTool(request, timeout=1.0)
            assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
            trailers = dict(err.value.trailing_metadata() or ())
            assert int(trailers["retry-after-ms"]) == want == 1500
            assert "x-trace-id" in trailers
            assert "exceeds request deadline" in err.value.details()
            # Queue-full shed.
            teng.submit(GenRequest(prompt="queued 2"))
            with pytest.raises(grpc.RpcError) as err:
                stub.ExecuteTool(request, timeout=30)
            assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
            trailers = dict(err.value.trailing_metadata() or ())
            assert int(trailers["retry-after-ms"]) == want
            assert "queue full" in err.value.details()
        page = obs.registry.render()
        assert "polykey_requests_shed_total 2" in page
        assert 'polykey_rpcs_total{code="ResourceExhausted"' in page
    finally:
        server.stop(grace=None)
        service.close()
        jeng.shutdown()


def test_step_stall_trips_the_watchdog_and_the_supervisor_restarts(weights, jax_greedy):
    """The default path (TorchService.create): one 1 s stall wedges the
    dispatch; the watchdog (0.25 s window) trips and flips health; the
    thread wakes inside the supervisor's join window, so the dead engine's
    state is released before the fresh engine is built on the same weight
    tensors (the same fingerprint, the adopted metrics); health resumes;
    the restarted engine's greedy streams equal the JAX engine's."""
    inj = faults.install("step-stall=1.0@1")
    health = _HealthLog()
    obs = Observability()
    engine = InferenceEngine(CHAOS, params=weights[1], device="cpu", health=health)
    service = TorchService.create(engine, health=health,
                                  logger=Logger(stream=io.StringIO()), obs=obs)
    supervisor = service.supervisor
    supervisor.check_interval_s = 0.05
    service.watchdog.check_interval_s = 0.05
    try:
        victim = GenRequest(prompt="stall victim", max_new_tokens=8)
        engine.submit(victim)
        _, done, error = _drain(victim, timeout=10.0)
        assert done is None and error is not None and error.startswith("engine")
        assert _await(lambda: supervisor.restarts == 1, timeout=10.0)
        fresh = service.engine
        assert fresh is supervisor.engine is service.watchdog.engine
        assert fresh is not engine and engine.paged is None    # released
        assert fresh.params is engine.params                   # no copy
        assert fresh._params_fingerprint(0) == engine._params_fingerprint(0)
        assert fresh.metrics is engine.metrics and fresh._faults is inj
        assert health.transitions == ["NOT_SERVING", "SERVING"]
        assert health._statuses[""] == SERVING
        assert inj.fired("step-stall") == 1
        kinds = [e["kind"] for e in obs.recorder.events()]
        assert "watchdog_stall" in kinds and "engine_restart" in kinds
        notes = fresh.timeline.events()
        assert notes[0]["kind"] == "note" and notes[0]["note_kind"] == "engine_restart"
        page = obs.registry.render()
        assert "polykey_watchdog_stalls_total 1" in page
        assert "polykey_engine_restarts_total 1" in page
        assert _greedy(fresh) == jax_greedy
    finally:
        service.close()


def test_a_wedged_thread_is_failed_from_the_supervisor_and_released_on_exit(weights):
    """The stall outlasts the supervisor's join window: the in-flight
    request fails from the supervisor thread, the fresh engine serves
    while the old thread still sleeps, and the old engine's device state
    is released only once its thread has exited (it launches nothing
    after waking)."""
    faults.install("step-stall=3.0@1")
    health = _HealthLog()
    engine = InferenceEngine(CHAOS, params=weights[1], device="cpu", health=health)
    watchdog = Watchdog(engine, health=health, check_interval_s=0.05)
    watchdog.start()
    supervisor = EngineSupervisor(
        engine, lambda: InferenceEngine(CHAOS, device="cpu", health=health,
                                        reuse=engine._ctor_args),
        watchdog=watchdog, health=health, max_restarts=2, restart_window_s=60.0,
        check_interval_s=0.05, join_timeout_s=0.2,
    ).start()
    try:
        victim = GenRequest(prompt="wedged", max_new_tokens=8)
        engine.submit(victim)
        _, done, error = _drain(victim, timeout=10.0)
        assert done is None and error.startswith("engine restarting")
        assert _await(lambda: supervisor.restarts == 1, timeout=10.0)
        assert engine._thread.is_alive() and supervisor.orphans == [engine]
        assert engine.paged is not None           # nothing freed under it
        assert supervisor.engine.metrics is not engine.metrics
        assert _greedy(supervisor.engine, PROMPTS[:1])
        assert _await(lambda: not supervisor.orphans, timeout=10.0)
        assert not engine._thread.is_alive() and engine.paged is None
        assert health.transitions == ["NOT_SERVING", "SERVING"]
    finally:
        supervisor.stop()
        watchdog.stop()
        supervisor.engine.shutdown()


def test_a_dead_engine_dispatches_nothing(weights):
    """A trip that lands while the loop admits (the thread was in a long
    host or device call, not in a fault's sleep): the admitted group is
    failed on the host with the trip's reason, and no prefill, block or
    lane merge reaches the device."""
    engine = InferenceEngine(CHAOS, params=weights[1], device="cpu")
    launched = []
    for name in ("_run_prefill", "_dispatch_step", "_merge_slot"):
        real = getattr(engine, name)
        setattr(engine, name, lambda *a, _n=name, _f=real, **k: (launched.append(_n),
                                                                  _f(*a, **k))[1])
    prepare = engine._prepare_request

    def tripping(slot_idx, request):
        out = prepare(slot_idx, request)
        engine.dead = "engine made no progress (test trip)"
        return out

    engine._prepare_request = tripping
    try:
        request = GenRequest(prompt="hello", max_new_tokens=4)
        engine.submit(request)
        tokens, done, error = _drain(request)
        assert not tokens and done is None
        assert error == "engine made no progress (test trip)"
        assert _await(lambda: not engine._thread.is_alive(), timeout=10.0)
        assert launched == []
        assert engine.allocator.num_free == CHAOS.num_pages - 1
    finally:
        engine.shutdown()


def test_the_supervisor_gives_up_when_the_fault_persists(weights):
    faults.install("step-stall=0.6@4")
    config = dataclasses.replace(CHAOS, watchdog_timeout_s=0.2)
    health = _HealthLog()
    engine = InferenceEngine(config, params=weights[1], device="cpu")
    watchdog = Watchdog(engine, health=health, check_interval_s=0.05)
    watchdog.start()
    supervisor = EngineSupervisor(
        engine, lambda: InferenceEngine(config, device="cpu", reuse=engine._ctor_args),
        watchdog=watchdog, health=health, max_restarts=1, restart_window_s=60.0,
        check_interval_s=0.05, join_timeout_s=5.0,
    ).start()
    try:
        engine.submit(GenRequest(prompt="stall one", max_new_tokens=8))
        assert _await(lambda: supervisor.restarts == 1, timeout=10.0)
        supervisor.engine.submit(GenRequest(prompt="stall two", max_new_tokens=8))
        assert _await(lambda: supervisor.gave_up, timeout=10.0)
        assert supervisor.restarts == 1
        assert health._statuses[""] == NOT_SERVING
        assert health.transitions == ["NOT_SERVING", "SERVING", "NOT_SERVING"]
    finally:
        supervisor.stop()
        watchdog.stop()
        supervisor.engine.shutdown()


def test_prefill_error_fails_only_its_own_request(weights, jax_greedy):
    faults.install("prefill-error@1")
    engine = InferenceEngine(CHAOS, params=weights[1], device="cpu")
    try:
        doomed = GenRequest(prompt="doomed", max_new_tokens=4)
        engine.submit(doomed)
        _, done, error = _drain(doomed)
        assert done is None and error == "prefill failed: injected fault: prefill-error"
        assert _greedy(engine) == jax_greedy
        assert engine.dead is None
        assert engine.allocator.num_free == CHAOS.num_pages - 1
    finally:
        engine.shutdown()


def test_tokenizer_and_alloc_faults_degrade_as_the_reference(weights):
    """tokenizer-error fails its request with the JAX engine's message;
    alloc-fail requeues once, then the request completes with the JAX
    engine's tokens."""
    spec = "tokenizer-error@1,alloc-fail@1"
    faults.install(spec)
    jfaults.install(spec)
    engine = InferenceEngine(CHAOS, params=weights[1], device="cpu")
    jeng = JInferenceEngine(JEngineConfig(**FIELDS), params=weights[0])
    try:
        for make, eng in ((GenRequest, engine), (JGenRequest, jeng)):
            victim = make(prompt="tokenizer victim", max_new_tokens=4)
            eng.submit(victim)
            victim.result = _drain(victim)
            late = make(prompt="alloc victim", max_new_tokens=4)
            eng.submit(late)
            late.result = _drain(late)
            eng.results = (victim.result, late.result)
        (t_victim, t_late), (j_victim, j_late) = engine.results, jeng.results
        assert t_victim[2] == j_victim[2] == "admission failed: injected fault: tokenizer-error"
        assert t_late[2] is None and t_late[0] == j_late[0] and len(t_late[0]) == 4
        assert faults.get_injector().fired("alloc-fail") == 1
    finally:
        engine.shutdown()
        jeng.shutdown()
