"""The port's replica pool against the JAX package's, on tiny-llama on the
CPU (the counterparts of tests/test_replica_pool.py): two replicas share
one params tree (JAX init, carried across through models/interop.py).

- The router: over the same warmth, delay, load, deadline and state the
  port's `_route` picks the JAX router's replica for the JAX reason (both
  routers run over stand-in engines that report those signals).
- The pool's greedy streams equal the JAX single engine's; a `step-stall`
  on the serving replica gives a resumed stream whose token ids equal the
  JAX engine's uninterrupted stream, flagged `restarted`; queued requests
  move losslessly; one replica's give-up leaves health SERVING, and a
  pool whose every replica gave up goes NOT_SERVING.
- `stats()` has the JAX pool's key set, and every key the JAX pool sums
  is in the port engine's `stats()`.
- Over gRPC the `replica` / `restarted` trailers and engine_stats'
  `replicas_total` / `streams_resumed`, held on token ids (a random
  tiny-llama's greedy text decodes to nothing through the gateway).

Timeouts are test-scaled (watchdog 0.3 s, check intervals 0.05 s) and
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

from polykey_tpu.engine import replica_pool as jpool
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch import faults
from polykey_tpu_torch.engine import replica_pool as tpool
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import EngineDeadError, GenRequest
from polykey_tpu_torch.engine.replica_pool import DEAD, SERVING, ReplicaPool
from polykey_tpu_torch.gateway import server as gateway_server
from polykey_tpu_torch.gateway.health import NOT_SERVING
from polykey_tpu_torch.gateway.health import SERVING as H_SERVING
from polykey_tpu_torch.gateway.health import HealthService
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
    max_decode_slots=2,
    page_size=8,
    num_pages=64,
    max_seq_len=64,
    prefill_buckets=(16, 32),
    max_new_tokens_cap=32,
    default_max_new_tokens=8,
    decode_block_steps=1,          # per-token dispatch: slow-step paces finely
    adaptive_block=False,
    lookahead_blocks=1,
)
POOL_CONFIG = EngineConfig(**FIELDS, watchdog_timeout_s=0.3, max_queue_depth=0,
                           replicas=2)
PROMPT = "failover determinism probe"
STALL = "slow-step=0.05:replica=0,step-stall=1.0@1:replica=0"


@pytest.fixture(autouse=True)
def _clean_injector(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def weights():
    jparams = jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                             jax.numpy.float32)
    return jparams, params_from_numpy(jax.device_get(jparams))


@pytest.fixture(scope="module")
def jax_engine(weights):
    engine = JInferenceEngine(JEngineConfig(**FIELDS), params=weights[0])
    yield engine
    engine.shutdown()


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


def _await(predicate, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _jax_stream(engine, prompt, n):
    request = JGenRequest(prompt=prompt, max_new_tokens=n)
    engine.submit(request)
    tokens, done, error = _drain(request)
    assert error is None and done is not None
    return tokens


def _pool(weights, config=POOL_CONFIG, **kwargs):
    kwargs.setdefault("watchdog_interval_s", 0.05)
    kwargs.setdefault("supervisor_interval_s", 0.05)
    return ReplicaPool.create(config, params=weights[1], device="cpu", **kwargs)


def _arm_live(pool, index, spec):
    """Faults on a LIVE replica: the engine reads the injector at
    construction, so the fresh one is handed over; a restarted engine reads
    the installed one, so a spent @1 stays spent."""
    pool.replicas[index].engine._faults = faults.install(spec)


# -- the router --------------------------------------------------------------


class _Signals:
    """A stand-in engine reporting fixed routing signals."""

    def __init__(self, warmth, delay, load):
        self._w, self._d, self._l = warmth, delay, load

    def prefix_warmth(self, ids):
        return self._w

    def queue_delay_estimate_s(self):
        return self._d

    def load_fraction(self):
        return self._l


class _Bytes:
    def encode(self, text):
        return list(text.encode())


# (warmth, delay, load, state) per replica, deadline in seconds from now,
# excluded indices, prefix cache on, route weights.
ROUTES = {
    "tie": ([(0, 0, 0, "SERVING")] * 3, None, set(), False, (1.0, 1.0)),
    "least-delay": ([(0, 0.8, 0, "SERVING"), (0, 0.0, 0, "SERVING")], None,
                    set(), False, (1.0, 1.0)),
    "load-epsilon": ([(0, 0, 0.5, "SERVING"), (0, 0, 0.0, "SERVING")], None,
                     set(), False, (1.0, 1.0)),
    "headroom": ([(0, 0.8, 0, "SERVING"), (0, 0.05, 0, "SERVING")], 0.2, set(),
                 False, (1.0, 1.0)),
    "all-infeasible": ([(0, 0.8, 0, "SERVING"), (0, 0.9, 0, "SERVING")], 0.2,
                       set(), False, (1.0, 1.0)),
    "prefix-hit": ([(0.0, 0.0, 0, "SERVING"), (0.9, 0.1, 0, "SERVING")], None,
                   set(), True, (1.0, 1.0)),
    "warmth-vs-delay": ([(0.0, 0.0, 0, "SERVING"), (0.5, 0.7, 0, "SERVING")], None,
                        set(), True, (1.0, 1.0)),
    "delay-weighted": ([(0.0, 0.0, 0, "SERVING"), (0.5, 0.3, 0, "SERVING")], None,
                       set(), True, (1.0, 4.0)),
    "draining-skipped": ([(0.9, 0, 0, "DRAINING"), (0, 0.5, 0, "SERVING")], None,
                         set(), True, (1.0, 1.0)),
    "excluded": ([(0, 0, 0, "SERVING"), (0, 0.5, 0, "SERVING")], None, {0},
                 False, (1.0, 1.0)),
    "none-serving": ([(0, 0, 0, "DEAD"), (0, 0, 0, "RESTARTING")], None, set(),
                     False, (1.0, 1.0)),
}


def _route(module, scenario, make_request, config_cls):
    replicas, deadline, exclude, prefix, (wp, wd) = scenario
    config = config_cls(**FIELDS, replicas=len(replicas), prefix_cache=prefix,
                        route_prefix_weight=wp, route_delay_weight=wd)
    pool = module.ReplicaPool(config)
    pool.tokenizer = _Bytes()
    for i, (w, d, load, state) in enumerate(replicas):
        pool.replicas.append(module._Replica(index=i, engine=_Signals(w, d, load),
                                             watchdog=None, supervisor=None,
                                             state=state))
    request = make_request(
        prompt="route me", deadline=None if deadline is None
        else time.monotonic() + deadline)
    replica, reason = pool._route(request, set(exclude))
    return (None if replica is None else replica.index), reason


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_router_decides_as_the_jax_router(name):
    want = _route(jpool, ROUTES[name], JGenRequest, JEngineConfig)
    got = _route(tpool, ROUTES[name], GenRequest, EngineConfig)
    assert got == want


# -- streams and failover ----------------------------------------------------


def test_pool_streams_equal_the_jax_engine(weights, jax_engine):
    """The pool's greedy streams (both replicas serving) equal the JAX
    single engine's; the replicas serve one params tree."""
    prompts = ["hello", "a prompt for the 32 bucket", "third", "fourth one"]
    want = [_jax_stream(jax_engine, p, 8) for p in prompts]
    pool = _pool(weights)
    try:
        assert pool.replicas[0].engine.params is pool.replicas[1].engine.params
        requests = [GenRequest(prompt=p, max_new_tokens=8) for p in prompts]
        for request in requests:
            pool.submit(request)
        got = [_drain(r) for r in requests]
        assert [g[0] for g in got] == want
        assert all(g[2] is None for g in got)
        assert {r.replica for r in requests} == {0, 1}
    finally:
        pool.shutdown()


def test_midstream_resume_equals_the_jax_uninterrupted_stream(weights, jax_engine):
    """A step-stall on the serving replica mid-stream: the stream resumes on
    the other replica with the delivered tokens suppressed, and its ids
    equal the JAX engine's uninterrupted stream; the stalled replica
    restarts to SERVING on the same weights."""
    want = _jax_stream(jax_engine, PROMPT, 12)
    pool = _pool(weights)
    try:
        _arm_live(pool, 0, STALL)
        victim = GenRequest(prompt=PROMPT, max_new_tokens=12)
        pool.submit(victim)
        assert victim.replica == 0
        tokens, done, error = _drain(victim)
        assert error is None and done is not None
        assert tokens == want
        assert victim.restarted and victim.replica == 1
        assert done.completion_tokens == 12
        stats = pool.stats()
        assert stats["streams_resumed"] == 1 and stats["requests_rerouted"] == 1
        assert _await(lambda: pool.replicas[0].supervisor.restarts == 1
                      and pool.replicas[0].state == SERVING)
        fresh = pool.replicas[0].engine
        assert fresh.params is pool.replicas[1].engine.params
        assert fresh.replica_id == 0
        # Both idle: the tie breaks to the fresh replica 0, which serves the
        # same stream.
        after = GenRequest(prompt=PROMPT, max_new_tokens=12)
        pool.submit(after)
        assert after.replica == 0
        assert _drain(after)[0] == want
    finally:
        pool.shutdown()


def test_queued_requests_move_losslessly(weights, jax_engine, monkeypatch):
    """Replica 0 holds two streams and two queued requests when it stalls:
    every request finishes on replica 1, token-complete and equal to the
    JAX engine's streams."""
    prompts = [f"victim {i}" for i in range(4)]
    want = [_jax_stream(jax_engine, p, 6) for p in prompts]
    pool = _pool(weights)
    try:
        real_route = pool._route
        monkeypatch.setattr(pool, "_route",
                            lambda request, exclude: real_route(request, exclude | {1}))
        _arm_live(pool, 0, STALL)
        requests = [GenRequest(prompt=p, max_new_tokens=6) for p in prompts]
        for request in requests:
            pool.submit(request)
            assert request.replica == 0
        monkeypatch.setattr(pool, "_route", real_route)
        outcomes = [_drain(r) for r in requests]
        assert [o[2] for o in outcomes] == [None] * 4
        assert [o[0] for o in outcomes] == want
        assert all(r.replica == 1 for r in requests)
        stats = pool.stats()
        assert stats["requests_rerouted"] >= 1
        assert stats["requests_failed"] <= stats["requests_rerouted"]
    finally:
        pool.shutdown()


def test_one_giveup_keeps_health_serving_all_giveups_do_not(weights):
    config = dataclasses.replace(POOL_CONFIG, max_engine_restarts=0)
    health = HealthService()
    health.set_serving_status("", H_SERVING)
    pool = _pool(weights, config, health=health)
    try:
        _arm_live(pool, 0, STALL)
        victim = GenRequest(prompt="giveup victim", max_new_tokens=8)
        pool.submit(victim)
        tokens, done, error = _drain(victim)
        assert error is None and done is not None and len(tokens) == 8
        assert _await(lambda: pool.stats()["replica_states"]["0"] == DEAD)
        assert health._statuses.get("") == H_SERVING
        assert pool.dead is None and pool.stats()["replicas_serving"] == 1
        assert not pool.stats()["supervisor_gave_up"]
        # The last replica gives up too: the process goes NOT_SERVING.
        _arm_live(pool, 1, "step-stall=1.0@1:replica=1")
        last = GenRequest(prompt="last victim", max_new_tokens=8)
        pool.submit(last)
        assert last.replica == 1
        _, done, error = _drain(last)
        assert done is None and error.startswith("engine")
        assert _await(lambda: pool.dead is not None)
        assert health._statuses.get("") == NOT_SERVING
        assert pool.stats()["supervisor_gave_up"]
        with pytest.raises(EngineDeadError):
            pool.submit(GenRequest(prompt="too late", max_new_tokens=2))
    finally:
        pool.shutdown()


def test_stats_have_the_jax_pool_keys(weights):
    """With the prefix cache on (every key the JAX pool sums is then in an
    engine's stats), the port pool's stats() keys equal the JAX pool's over
    a JAX engine of the same config, and every summed key is a port engine
    key (else the aggregate silently drops it)."""
    config = dataclasses.replace(POOL_CONFIG, prefix_cache=True)
    jax_engine = JInferenceEngine(JEngineConfig(**FIELDS, prefix_cache=True),
                                  params=weights[0])
    try:
        _jax_stream(jax_engine, "stats", 4)
        jax_engine_stats = jax_engine.stats()
        jstats_pool = jpool.ReplicaPool(JEngineConfig(**FIELDS, replicas=2,
                                                      prefix_cache=True))
        jstats_pool.replicas.extend(
            jpool._Replica(index=i, engine=jax_engine, watchdog=None,
                           supervisor=None, state="SERVING") for i in range(2))
        jax_pool_stats = jstats_pool.stats()
    finally:
        jax_engine.shutdown()
    pool = _pool(weights, config)
    try:
        for i in range(3):
            request = GenRequest(prompt=f"stats {i}", max_new_tokens=4)
            pool.submit(request)
            assert _drain(request)[2] is None
        stats = pool.stats()
        port_engine_stats = pool.replicas[0].engine.stats()
        assert tpool._ADDITIVE_KEYS == jpool._ADDITIVE_KEYS
        # The draft counters appear once a speculative round proposed.
        summed = jpool._ADDITIVE_KEYS - {"drafts_accepted", "drafts_proposed"}
        assert summed <= set(jax_engine_stats)
        assert summed <= set(port_engine_stats)
        assert set(stats) == set(jax_pool_stats)
        assert stats["requests_completed"] == 3 == sum(
            s["requests_completed"] for s in stats["per_replica"])
        assert [s["replica"] for s in stats["per_replica"]] == [0, 1]
    finally:
        pool.shutdown()


# -- gateway: trailers and engine_stats on token ids -------------------------


class _Tap(queue.Queue):
    """A request's output queue that also keeps the token ids it carried."""

    def __init__(self):
        super().__init__()
        self.ids = []

    def put(self, item, *args, **kwargs):
        if item[0] == "token":
            self.ids.append(item[1])
        super().put(item, *args, **kwargs)


def test_grpc_stream_carries_replica_and_restarted_trailers(weights, jax_engine):
    want = _jax_stream(jax_engine, PROMPT, 12)
    logger = Logger(stream=io.StringIO())
    obs = Observability()
    pool = _pool(weights)
    service = TorchService.create(pool, logger=logger, obs=obs)
    submitted = []
    submit = pool.submit

    def tapped(request):
        request.out = _Tap()
        submitted.append(request)
        submit(request)

    pool.submit = tapped
    server, _, port = gateway_server.build_server(service, logger,
                                                  address="127.0.0.1:0", obs=obs)
    server.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            grpc.channel_ready_future(channel).result(timeout=10)
            stub = PolykeyServiceStub(channel)
            request = pk.ExecuteToolRequest(tool_name="llm_generate")
            request.parameters.update({"prompt": PROMPT, "max_tokens": 12})
            call = stub.ExecuteToolStream(request, timeout=60)
            chunks = list(call)
            assert chunks[-1].final and chunks[-1].usage.completion_tokens == 12
            trailers = dict(call.trailing_metadata() or ())
            assert trailers.get("replica") == "0" and "restarted" not in trailers
            assert submitted[-1].out.ids == want

            _arm_live(pool, 0, STALL)
            call2 = stub.ExecuteToolStream(request, timeout=120)
            chunks2 = list(call2)
            assert chunks2[-1].final and chunks2[-1].usage.completion_tokens == 12
            trailers2 = dict(call2.trailing_metadata() or ())
            assert trailers2.get("replica") == "1"
            assert trailers2.get("restarted") == "1"
            assert submitted[-1].out.ids == want

            unary, ucall = stub.ExecuteTool.with_call(request, timeout=60)
            assert unary.status.code == 200
            assert dict(ucall.trailing_metadata()).get("replica") in ("0", "1")
            stats = dict(stub.ExecuteTool(
                pk.ExecuteToolRequest(tool_name="engine_stats"),
                timeout=30).struct_output)
            assert stats["replicas_total"] == 2
            assert stats["streams_resumed"] == 1
    finally:
        server.stop(grace=None)
        service.close()


def test_from_env_builds_a_pool_and_arms_the_autopilot(monkeypatch):
    """POLYKEY_REPLICAS=2 serves through a pool; POLYKEY_AUTOPILOT=1 arms
    the controller over it, and close() stops both."""
    for key, value in dict(POLYKEY_BACKEND="engine", POLYKEY_MODEL="tiny-llama",
                           POLYKEY_DTYPE="float32", POLYKEY_MAX_DECODE_SLOTS="2",
                           POLYKEY_NUM_PAGES="64", POLYKEY_MAX_SEQ_LEN="64",
                           POLYKEY_PREFILL_BUCKETS="16,32", POLYKEY_REPLICAS="2",
                           POLYKEY_AUTOPILOT="1",
                           POLYKEY_SIGNALS_INTERVAL="0.05").items():
        monkeypatch.setenv(key, value)
    service = TorchService.from_env(device="cpu", obs=Observability())
    try:
        assert isinstance(service.engine, ReplicaPool)
        assert service.watchdog is None and service.supervisor is None
        assert service.autopilot is not None and service.engine.autopilot is service.autopilot
        assert service.autopilot.state.setpoints["route_delay_weight"] == 1.0
        request = GenRequest(prompt="from env", max_new_tokens=4)
        service.engine.submit(request)
        tokens, _done, error = _drain(request)
        assert error is None and len(tokens) == 4
    finally:
        service.close()
    assert service.engine.autopilot is None
