"""The port's disaggregated tiers against the JAX package's, on tiny-llama in
fp32 on the CPU (the counterparts of tests/test_disagg.py): in-thread
`WorkerServer`s with ``exit_mode="simulate"`` over real localhost sockets
(worker-exit then severs the control plane, which the coordinator cannot
tell from death), one params tree (JAX init, carried across through
models/interop.py), the JAX test's configuration.

- Greedy streams through the port's pool equal the JAX engine's token for
  token: uninterrupted, after a decode death (the retained blob re-shipped,
  no second prefill), after a prefill death at intake and mid-handoff,
  after a corrupt blob, for int8 KV. Sampled streams are held within the
  port (the port draws from torch, not jax.random: ROADMAP.md C.4).
- A JAX prefill worker's blob resumes on a port decode worker to the JAX
  engine's stream (fp32 and int8 KV); the frames `send_msg`
  writes are byte-identical between the packages.
- Routing (session-sticky prefill, NetKV decode scoring) decides as the
  JAX pool does; the spec parsing and the refusals are the reference's.
- The gateway, the exposition and the timeline carry the tier labels and
  the handoff families; a real `python -m polykey_tpu_torch.engine.worker`
  process starts with JAX unimportable and answers a ping.
- The engine halves: a prefill_only request's export and a resume_state
  request's import, through the lookahead pipeline at depth 2 beside a
  live lane.
"""

import dataclasses
import json
import os
import select
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from polykey_tpu import faults as jfaults
from polykey_tpu.engine import disagg_pool as jdisagg
from polykey_tpu.engine import worker as jworker
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch import faults
from polykey_tpu_torch.engine import disagg_pool as tdisagg
from polykey_tpu_torch.engine import worker as tworker
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.disagg_pool import DECODE, PREFILL, DisaggPool
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.engine.kv_cache import deserialize_kv_state, serialize_kv_state
from polykey_tpu_torch.engine.replica_pool import DEAD, SERVING
from polykey_tpu_torch.engine.worker import WorkerServer, session_key
from polykey_tpu_torch.models.interop import params_from_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference test's configuration (tests/test_disagg.py `_config`).
FIELDS = dict(
    model="tiny-llama", dtype="float32", max_decode_slots=4,
    page_size=8, num_pages=128, max_seq_len=64,
    prefill_buckets=(16, 32), decode_block_steps=2,
    adaptive_block=False, max_new_tokens_cap=12,
    default_max_new_tokens=12, supervise=False,
    disagg_heartbeat_s=0.1, disagg_recovery_wait_s=10.0,
)
# The last prompt is kept by its tail (64 positions, 10 to generate) and
# prefills in chunks: it passes the 32-token bucket.
LONG = "a much longer prompt that needs more than thirty two byte tokens to prefill"
PROMPTS = ("hello disagg world", "kill test prompt", "sampled stream prompt",
           "int8 handoff prompt", "reship prompt", LONG)


def _config(**overrides) -> EngineConfig:
    return EngineConfig(**{**FIELDS, **overrides})


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def weights():
    jparams = jt.init_params(jax.random.PRNGKey(7), j_get_config("tiny-llama"),
                             jax.numpy.float32)
    return jparams, params_from_numpy(jax.device_get(jparams))


def _run(sub, prompt: str, n: int = 10, make=GenRequest, **kw):
    """Submit + drain one request; returns (tokens, error, request)."""
    request = make(prompt=prompt, max_new_tokens=n, **kw)
    sub.submit(request)
    tokens = []
    while True:
        kind, value = request.out.get(timeout=60)
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens, None, request
        else:
            return tokens, value, request


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX engine's greedy streams (fp32 and int8 KV) at the shared
    configuration: the identity baseline."""
    out = {}
    for kv in ("", "int8"):
        engine = JInferenceEngine(JEngineConfig(**{**FIELDS, "kv_dtype": kv}),
                                  params=weights[0])
        try:
            for prompt in PROMPTS:
                toks, err, _ = _run(engine, prompt, make=JGenRequest)
                assert err is None
                out[(kv, prompt)] = toks
        finally:
            engine.shutdown()
    return out


def _worker(cfg, tier, weights, replica=0, **kw) -> WorkerServer:
    return WorkerServer(cfg, tier=tier, replica=replica, seed=7, params=weights[1],
                        device="cpu", exit_mode="simulate", **kw).start()


class _Stack:
    """Prefill + decode workers and the pool over them, torn down together."""

    def __init__(self, cfg, weights, decode_workers=1, prefill_workers=1, **pool_kw):
        self.workers = [_worker(cfg, PREFILL, weights, replica=i)
                        for i in range(prefill_workers)]
        self.workers += [_worker(cfg, DECODE, weights, replica=i)
                         for i in range(decode_workers)]
        self.pool = DisaggPool.create(
            cfg, workers=[(w.tier, ("127.0.0.1", w.port)) for w in self.workers],
            **pool_kw)

    def close(self):
        self.pool.shutdown()
        for worker in self.workers:
            worker.stop()


@pytest.fixture()
def stacks(weights):
    opened = []

    def make(cfg=None, **kw) -> _Stack:
        stack = _Stack(cfg or _config(), weights, **kw)
        opened.append(stack)
        return stack

    yield make
    for stack in opened:
        stack.close()


# -- end-to-end identity ------------------------------------------------------


def test_greedy_stream_bit_identical_to_single_process(stacks, reference):
    stack = stacks()
    toks, err, req = _run(stack.pool, "hello disagg world")
    assert err is None
    assert toks == reference[("", "hello disagg world")]
    # Routing breadcrumbs for the gateway trailers.
    assert req.replica == 0
    assert req.tier == "prefill=0,decode=0"
    stats = stack.pool.stats()
    assert stats["handoffs"]["ok"] == 1
    assert stats["handoff_bytes"] > 0
    assert stats["tiers"][PREFILL]["serving"] == 1
    assert stats["tiers"][DECODE]["serving"] == 1


@pytest.mark.parametrize("mode", [dict(ragged_dispatch=True), dict(prefix_cache=True),
                                  dict(lookahead_blocks=1)],
                         ids=["ragged", "prefix-cache", "depth-1"])
def test_worker_modes_stream_as_the_jax_engine(stacks, reference, mode):
    """Workers in ragged dispatch (the JAX *bucketed* engine is the oracle,
    as for the single ragged engine), with the prefix cache (the second
    request of a prompt exports cached pages) and at lookahead depth 1: the
    chunked long prompt and a short one, twice each, stream as the JAX
    engine's."""
    stack = stacks(_config(**mode))
    for prompt in ("hello disagg world", LONG) * 2:
        toks, err, _ = _run(stack.pool, prompt)
        assert err is None and toks == reference[("", prompt)], prompt


def test_sampled_stream_identical_with_seed(stacks, weights):
    """Position-keyed draws and the same seed: the handed-off decode
    replays the exact sampled stream a single port engine produces."""
    engine = InferenceEngine(_config(), params=weights[1], device="cpu", seed=7)
    try:
        want, err, _ = _run(engine, "sampled stream prompt", temperature=0.9, seed=1234)
    finally:
        engine.shutdown()
    assert err is None
    stack = stacks()
    toks, err, _ = _run(stack.pool, "sampled stream prompt", temperature=0.9, seed=1234)
    assert err is None
    assert toks == want


def test_int8_kv_handoff_bit_identical(stacks, reference):
    stack = stacks(_config(kv_dtype="int8"))
    toks, err, _ = _run(stack.pool, "int8 handoff prompt")
    assert err is None
    assert toks == reference[("int8", "int8 handoff prompt")]


def test_concurrent_burst_all_complete(stacks):
    stack = stacks(decode_workers=2)
    results = []

    def one(i):
        results.append(_run(stack.pool, f"burst prompt {i}", 6))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(results) == 10
    assert all(err is None and len(toks) == 6 for toks, err, _ in results)


# -- crash safety -------------------------------------------------------------


def test_decode_worker_death_mid_stream_resumes_bit_identical(stacks, reference):
    stack = stacks(decode_workers=2)
    faults.install("worker-exit=3@1:tier=decode:replica=0")
    toks, err, req = _run(stack.pool, "kill test prompt")
    assert err is None
    assert toks == reference[("", "kill test prompt")]
    assert req.restarted is True
    stats = stack.pool.stats()
    assert stats["streams_resumed"] == 1
    assert stats["handoffs"]["retried"] == 1
    assert stats["tier_states"]["decode/0"] == DEAD    # no restart path
    assert stats["tier_states"]["decode/1"] == SERVING


def test_decode_death_reships_retained_blob_without_reprefill(stacks, reference):
    """The two-phase hand-over's payoff: after a decode-side death the
    coordinator re-ships the blob it already fetched — the prefill tier
    admits exactly ONE request for the stream, and the stream is the JAX
    engine's."""
    stack = stacks(decode_workers=2)
    prefill_worker = stack.workers[0]
    faults.install("worker-exit=2@1:tier=decode:replica=0")
    toks, err, _ = _run(stack.pool, "reship prompt")
    assert err is None and toks == reference[("", "reship prompt")]
    assert prefill_worker.engine.stats()["requests_admitted"] == 1
    assert prefill_worker.engine.stats()["handoff_exports"] == 1


@pytest.mark.parametrize("value,site", [(1, "mid-handoff"), (0, "intake")])
def test_prefill_worker_death_reroutes(stacks, reference, value, site):
    """Value 1 selects the fetch site (prefill done, blob retained, the worker
    dies before it ships), value 0 the intake site (death while queued):
    either way the request re-runs on the other prefill worker to the JAX
    engine's stream."""
    stack = stacks(prefill_workers=2)
    faults.install(f"worker-exit={value}@1:tier=prefill")
    toks, err, _ = _run(stack.pool, "kill test prompt")
    assert err is None
    assert toks == reference[("", "kill test prompt")]
    states = stack.pool.stats()["tier_states"]
    assert sorted(states[f"{PREFILL}/{i}"] for i in range(2)) == [DEAD, SERVING]


def test_corrupt_handoff_blob_reroutes_cleanly(stacks, reference):
    # kv-handoff-drop truncates the shipped blob to half (a partial write);
    # validation catches it and the prefill re-runs — the worker itself
    # stays SERVING (a torn transfer is a link event).
    stack = stacks()
    faults.install("kv-handoff-drop=1@1:tier=prefill")
    toks, err, _ = _run(stack.pool, "kill test prompt")
    assert err is None
    assert toks == reference[("", "kill test prompt")]
    stats = stack.pool.stats()
    assert stats["handoffs"]["retried"] == 1
    assert stats["tier_states"]["prefill/0"] == SERVING


def test_handoff_delay_fault_slows_but_completes(stacks):
    stack = stacks()
    faults.install("handoff-delay=0.3@1:tier=prefill")
    t0 = time.monotonic()
    toks, err, _ = _run(stack.pool, "slow handoff prompt", 4)
    assert err is None and len(toks) == 4
    assert time.monotonic() - t0 >= 0.3


def test_reroute_budget_bounds_failures(stacks):
    # Every decode attempt dies at once; max_reroutes bounds the retries and
    # the request fails UNAVAILABLE-shaped ("engine..." prefix).
    stack = stacks(_config(max_reroutes=1, disagg_recovery_wait_s=0.5))
    faults.install("worker-exit=0:tier=decode")     # unlimited budget
    toks, err, _ = _run(stack.pool, "doomed prompt")
    assert err is not None and err.startswith("engine")
    assert stack.pool.stats()["handoffs"]["aborted"] == 1


def test_worker_restart_via_cb_rejoins_serving(weights):
    """The heartbeat detects the death, the restart hook brings a
    replacement up, and the tier returns to SERVING."""
    cfg = _config()
    replacement: dict = {}

    def restart_cb(worker):
        server = _worker(cfg, worker.tier, weights, replica=worker.index)
        replacement["server"] = server
        return ("127.0.0.1", server.port)

    prefill = _worker(cfg, PREFILL, weights)
    decode = _worker(cfg, DECODE, weights)
    pool = DisaggPool.create(
        cfg, workers=[(PREFILL, ("127.0.0.1", prefill.port)),
                      (DECODE, ("127.0.0.1", decode.port))],
        restart_cb=restart_cb)
    try:
        toks, err, _ = _run(pool, "restart test prompt", 4)
        assert err is None and len(toks) == 4
        decode.simulate_death()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            states = {w.name: w.state for w in pool.workers}
            if states["decode/0"] == SERVING and "server" in replacement:
                break
            time.sleep(0.05)
        assert {w.name: w.state for w in pool.workers}["decode/0"] == SERVING
        assert pool.tier_restores[DECODE] == 1 and pool.tier_faults[DECODE] == 1
        toks, err, _ = _run(pool, "restart test prompt", 4)
        assert err is None and len(toks) == 4
    finally:
        pool.shutdown()
        prefill.stop()
        replacement.get("server", decode).stop()


def test_worker_shed_is_flow_control_not_failover(stacks):
    """A worker-side shed (bounded engine queue) retries after the worker's
    retry-after hint without burning the re-route budget or counting as a
    failover."""
    stack = stacks(_config(max_queue_depth=1, max_reroutes=1))
    results = []

    def one(i):
        results.append(_run(stack.pool, f"shed probe {i}", 4))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(results) == 5
    assert all(err is None and len(toks) == 4 for toks, err, _ in results)
    stats = stack.pool.stats()
    assert stats["requests_rerouted"] == 0
    assert stats["handoffs"]["retried"] == 0
    assert stats["handoffs"]["aborted"] == 0


# -- routing ------------------------------------------------------------------


def test_session_sticky_prefill_routing(stacks):
    stack = stacks(prefill_workers=2)
    pool = stack.pool
    head = "conversation head shared across turns "
    _run(pool, head + "turn one", 4)
    ids = np.asarray(pool.tokenizer.encode(head + "turn one"), np.int32)
    key = session_key(ids, pool.config.page_size)
    assert key == jworker.session_key(ids, pool.config.page_size)
    first = pool._sticky[PREFILL][key]
    _run(pool, head + "turn two follows", 4)
    assert pool._sticky[PREFILL][key] == first
    admitted = [w.engine.stats()["requests_admitted"]
                for w in stack.workers if w.tier == PREFILL]
    assert max(admitted) >= 2


def _scored(mod, cases):
    pool = mod.DisaggPool.__new__(mod.DisaggPool)
    pool._lock = threading.Lock()
    pool._sticky = {mod.PREFILL: {}, mod.DECODE: {}}
    out = []
    for skey, payload, specs in cases:
        workers = []
        for index, bw, delay in specs:
            w = mod._Worker(tier=mod.DECODE, index=index)
            w.bw_ewma = bw
            w.ping = {"queue_delay_s": delay, "load": 0.0}
            workers.append(w)
        out.append(pool._score(mod.DECODE, workers, skey, payload_bytes=payload).index)
    return out


def test_netkv_decode_scoring_prefers_fast_low_delay_worker():
    cases = [
        ("s1", 1 << 20, [(0, 1e6, 0.0), (1, 1e9, 0.0)]),    # transfer cost dominates
        ("s2", 1024, [(2, 1e9, 2.0), (1, 1e9, 0.0)]),       # queue delay flips it
        ("s3", 0, [(3, 1e9, 0.0), (1, 1e9, 0.0)]),          # tie: lowest index
        ("s4", 1 << 26, [(0, 0.0, 0.0), (1, 5e8, 0.05)]),   # the prior vs measured
    ]
    assert _scored(tdisagg, cases) == [1, 1, 1, 1]
    assert _scored(tdisagg, cases) == _scored(jdisagg, cases)


# -- config guards ------------------------------------------------------------


@pytest.mark.parametrize("spec", ["2x3", "decode=4,prefill=1", "", "1x1", " 3X2 "])
def test_disagg_spec_parsing(spec):
    assert EngineConfig(disagg=spec).disagg_tiers() == \
        JEngineConfig(disagg=spec).disagg_tiers()
    assert EngineConfig(disagg="2x3").disagg_tiers() == (2, 3)
    for bad, match in (("2x", "malformed POLYKEY_DISAGG"),
                       ("prefill=2", "malformed POLYKEY_DISAGG"),
                       ("0x2", ">= 1 worker")):
        with pytest.raises(ValueError, match=match):
            EngineConfig(disagg=bad).validate()


def test_disagg_excludes_replicas_and_draft():
    with pytest.raises(ValueError, match="mutually exclusive"):
        EngineConfig(disagg="1x1", replicas=2).validate()
    with pytest.raises(ValueError, match="speculative"):
        EngineConfig(disagg="1x1", draft_model="tiny-llama").validate()
    with pytest.raises(ValueError, match="disagg_tier"):
        EngineConfig(disagg_tier="middle").validate()
    EngineConfig(disagg="1x1").validate()       # served now


def test_unset_disagg_builds_no_pool(monkeypatch):
    monkeypatch.delenv("POLYKEY_DISAGG", raising=False)
    assert EngineConfig.from_env().disagg == ""
    monkeypatch.setenv("POLYKEY_DISAGG", "1x2")
    monkeypatch.setenv("POLYKEY_DISAGG_HEARTBEAT", "0.2")
    monkeypatch.setenv("POLYKEY_DISAGG_MISS", "5")
    monkeypatch.setenv("POLYKEY_DISAGG_RECOVERY_WAIT", "7")
    monkeypatch.setenv("POLYKEY_BLACKBOX_EVERY", "9")
    got, want = EngineConfig.from_env(), JEngineConfig.from_env()
    for name in ("disagg", "disagg_heartbeat_s", "disagg_miss",
                 "disagg_recovery_wait_s", "blackbox_every"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.disagg_tiers() == (1, 2)


def test_config_env_round_trips_the_pool_geometry():
    """The spawn-time config channel: a worker's EngineConfig.from_env over
    the pool's rendered env has the pool's geometry; the keys the port
    renders are the JAX pool's, less the knobs the port has no field for."""
    cfg = _config(kv_dtype="int8", prefix_cache=True, blackbox_every=5,
                  lookahead_blocks=3, signals_windows="30,120")
    env = tdisagg._config_env(cfg)
    assert set(env) <= set(jdisagg._config_env(JEngineConfig(**FIELDS)))
    old = dict(os.environ)
    try:
        os.environ.update(env)
        got = EngineConfig.from_env()
    finally:
        os.environ.clear()
        os.environ.update(old)
    for name in ("model", "dtype", "kv_dtype", "max_decode_slots", "page_size",
                 "num_pages", "max_seq_len", "prefill_buckets", "decode_block_steps",
                 "adaptive_block", "lookahead_blocks", "prefix_cache", "blackbox_every",
                 "signals_windows", "supervise", "max_new_tokens_cap"):
        assert getattr(got, name) == getattr(cfg, name), name


# -- the wire: framing and cross-package handoffs -----------------------------


@pytest.mark.parametrize("header,payload", [
    ({"op": "ping"}, b""),
    ({"event": "token", "id": 17}, b""),
    ({"op": "decode", "req": {"prompt": "héllo", "seed": None}}, b"\x00\x01" * 40000),
    ({"ok": True, "bytes": 3}, b"abc"),
])
def test_frames_are_byte_identical_between_packages(header, payload):
    frames = []
    for mod in (tworker, jworker):
        a, b = socket.socketpair()
        try:
            mod.send_msg(a, header, payload)
            a.shutdown(socket.SHUT_WR)
            data = b""
            while chunk := b.recv(1 << 20):
                data += chunk
            frames.append(data)
            # Each package reads the other's frame back.
            c, d = socket.socketpair()
            c.sendall(data)
            other = jworker if mod is tworker else tworker
            got_header, got_payload = other.recv_msg(d)
            c.close()
            d.close()
            assert got_header == header and bytes(got_payload) == payload
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp32", "int8"])
def test_jax_prefill_worker_resumes_on_a_port_decode_worker(weights, reference, kv):
    """A JAX WorkerServer on the prefill tier ships its blob, through the
    port's pool, to a port WorkerServer on the decode tier: the resumed
    greedy stream is the JAX engine's."""
    jcfg = JEngineConfig(**{**FIELDS, "kv_dtype": kv})
    jserver = jworker.WorkerServer(jcfg, tier="prefill", seed=7, params=weights[0],
                                   exit_mode="simulate").start()
    tserver = _worker(_config(kv_dtype=kv), DECODE, weights)
    pool = DisaggPool.create(_config(kv_dtype=kv), workers=[
        (PREFILL, ("127.0.0.1", jserver.port)), (DECODE, ("127.0.0.1", tserver.port))])
    try:
        prompt = "int8 handoff prompt" if kv else "hello disagg world"
        toks, err, _ = _run(pool, prompt)
        assert err is None
        assert toks == reference[(kv, prompt)]
        assert tserver.engine.stats()["handoff_imports"] == 1
        assert jserver.engine.stats()["requests_admitted"] == 1
    finally:
        pool.shutdown()
        jserver.stop()
        tserver.stop()


def test_export_matches_the_jax_engine_and_round_trips(weights):
    """A prefill_only request: the port engine emits ("handoff", state) then
    ("done", ...), its lane never activates, and the state is the JAX
    engine's (metadata and first token equal, pages within fp32 rounding);
    the wire blob round-trips bit for bit."""
    def export(make_engine, make_request):
        engine = make_engine()
        try:
            request = make_request(prompt="hello disagg world", max_new_tokens=10,
                                   seed=99, prefill_only=True)
            engine.submit(request)
            events = [request.out.get(timeout=60) for _ in range(2)]
            return events, engine
        finally:
            engine.shutdown()

    jev, _ = export(lambda: JInferenceEngine(JEngineConfig(**FIELDS), params=weights[0]),
                    JGenRequest)
    tev, teng = export(lambda: InferenceEngine(_config(), params=weights[1],
                                               device="cpu", seed=7), GenRequest)
    assert [k for k, _ in tev] == [k for k, _ in jev] == ["handoff", "done"]
    js, ts = jev[0][1], tev[0][1]
    for name in ("model", "page_size", "prompt_len", "first_token", "seed"):
        assert getattr(ts, name) == getattr(js, name), name
    assert np.array_equal(ts.prompt_ids.numpy(), np.asarray(js.prompt_ids))
    np.testing.assert_allclose(ts.k.numpy(), np.asarray(js.k), atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), atol=1e-5)
    assert not teng._active.any()
    blob = serialize_kv_state(ts)
    assert serialize_kv_state(deserialize_kv_state(blob)) == blob


def test_resume_at_depth_two_beside_a_live_lane(weights, reference):
    """A resume_state request admitted while another lane decodes with a
    block in flight (lookahead depth 2): both streams are the JAX engine's,
    and the import went through the engine's pipeline (the resumed lane's
    first token comes first, its pages freed at the end)."""
    cfg = _config(lookahead_blocks=2, max_new_tokens_cap=12)
    prefill = InferenceEngine(dataclasses.replace(cfg, disagg_tier="prefill"),
                              params=weights[1], device="cpu", seed=7)
    try:
        request = GenRequest(prompt="kill test prompt", max_new_tokens=10, seed=5,
                             prefill_only=True)
        prefill.submit(request)
        state = request.out.get(timeout=60)[1]
        assert request.out.get(timeout=60)[0] == "done"
    finally:
        prefill.shutdown()
    state = deserialize_kv_state(serialize_kv_state(state))
    engine = InferenceEngine(dataclasses.replace(cfg, disagg_tier="decode"),
                             params=weights[1], device="cpu", seed=7)
    try:
        live = GenRequest(prompt="hello disagg world", max_new_tokens=10)
        engine.submit(live)
        assert live.out.get(timeout=60)[0] == "token"     # decoding now
        resumed = GenRequest(prompt="", max_new_tokens=10, resume_state=state)
        engine.submit(resumed)
        got = {}
        for name, req in (("live", live), ("resumed", resumed)):
            toks = []
            while True:
                kind, value = req.out.get(timeout=60)
                assert kind != "error", value
                if kind == "done":
                    break
                toks.append(value)
            got[name] = toks
        free = engine.allocator.num_free
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert got["resumed"] == reference[("", "kill test prompt")]
    assert got["live"] == reference[("", "hello disagg world")][1:]
    assert stats["handoff_imports"] == 1 and stats["prefill_eager"] == 1
    assert free == _config().num_pages - 1


def test_resume_rejects_a_mismatched_state_before_any_write(weights):
    """A state for another geometry fails as "kv-handoff rejected" (the
    coordinator's re-prefill marker) and writes nothing."""
    engine = InferenceEngine(_config(page_size=16, max_seq_len=64), params=weights[1],
                             device="cpu", seed=7)
    other = InferenceEngine(_config(), params=weights[1], device="cpu", seed=7)
    try:
        request = GenRequest(prompt="kill test prompt", max_new_tokens=10,
                             prefill_only=True)
        other.submit(request)
        state = request.out.get(timeout=60)[1]
        before = [t.clone() for t in engine.paged.pools]
        bad = GenRequest(prompt="", resume_state=state)
        engine.submit(bad)
        kind, message = bad.out.get(timeout=60)
    finally:
        engine.shutdown()
        other.shutdown()
    assert kind == "error" and "kv-handoff rejected" in message
    assert all(torch.equal(a, b) for a, b in zip(before, engine.paged.pools))


# -- gateway + observability --------------------------------------------------


def _params(values: dict):
    from google.protobuf import struct_pb2

    params = struct_pb2.Struct()
    params.update(values)
    return params


def test_tpu_service_passthrough_and_trailers(stacks):
    from polykey_tpu_torch.gateway import errors
    from polykey_tpu_torch.gateway.torch_service import TorchService

    stack = stacks()
    service = TorchService.create(stack.pool)
    assert service.watchdog is None          # the pool supervises itself
    assert service.supervisor is None
    response = service.execute_tool(
        "llm_generate", _params({"prompt": "gateway disagg prompt", "max_tokens": 4}),
        None, None)
    assert response.status.code == 200
    trailers = dict(errors.pop_rpc_trailers())
    assert trailers[errors.REPLICA_KEY] == "0"
    assert trailers[errors.TIER_KEY] == "prefill=0,decode=0"


def test_exposition_renders_tier_labels_and_handoff_families(stacks):
    from polykey_tpu_torch.obs import engine_collector

    stack = stacks()
    _run(stack.pool, "exposition prompt", 4)
    page = "\n".join(engine_collector(stack.pool)())
    assert 'polykey_requests_completed_total{replica="0",tier="prefill"}' in page
    assert 'polykey_requests_completed_total{replica="0",tier="decode"}' in page
    assert ('polykey_replica_state{replica="0",state="SERVING",'
            'tier="decode"} 1') in page
    assert 'polykey_replicas_serving{tier="prefill"} 1' in page
    assert 'polykey_handoffs_total{outcome="ok"} 1' in page
    assert "polykey_handoff_bytes_total" in page
    assert 'polykey_handoff_ms_bucket{le="+Inf"} 1' in page
    assert 'polykey_ttft_ms_count{replica="0",tier="decode"}' in page


def test_timeline_records_handoff_lifecycle(stacks):
    from polykey_tpu_torch.obs.timeline import engine_timelines, to_perfetto

    stack = stacks()
    _run(stack.pool, "timeline prompt", 4)
    kinds = [e.get("note_kind") for e in stack.pool.timeline.events()
             if e["kind"] == "note"]
    assert "handoff_start" in kinds and "handoff_ack" in kinds
    trace = to_perfetto(engine_timelines(stack.pool))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "handoff_start" in names and "handoff_ack" in names
    worker_kinds = {e.get("note_kind") for w in stack.workers
                    for e in w.engine.timeline.events() if e["kind"] == "note"}
    assert {"handoff_export", "handoff_restore", "handoff_serialize",
            "handoff_scatter"} <= worker_kinds
    faults.install("kv-handoff-drop=1@1:tier=prefill")
    _run(stack.pool, "timeline prompt two", 4)
    kinds = [e.get("note_kind") for e in stack.pool.timeline.events()
             if e["kind"] == "note"]
    assert "handoff_abort" in kinds


def test_stats_aggregates_additive_counters(stacks):
    stack = stacks()
    _run(stack.pool, "stats prompt", 4)
    stats = stack.pool.stats()
    per = {f"{s['tier']}/{s['replica']}": s for s in stats["per_worker"]}
    assert stats["requests_completed"] == (
        per["prefill/0"]["requests_completed"] + per["decode/0"]["requests_completed"])
    assert stats["workers_total"] == 2
    assert stats["handoff_ms_p50"] >= 0
    for snap in per.values():
        assert snap["kernel_launches"] and snap["pid"] == os.getpid()   # in-thread workers
        assert snap["weights_fingerprint"] == per["prefill/0"]["weights_fingerprint"]


def test_flightwatch_renders_tier_column(stacks):
    """The reference's operator console (scripts/flightwatch.py, stdlib
    only) reads the port's /metrics page: its REPLICAS section derives the
    tier-labelled worker rows from the replica_state gauge."""
    import importlib.util

    from polykey_tpu_torch.obs import engine_collector

    spec = importlib.util.spec_from_file_location(
        "flightwatch", os.path.join(ROOT, "scripts", "flightwatch.py"))
    flightwatch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flightwatch)
    stack = stacks()
    _run(stack.pool, "flightwatch prompt", 4)
    page = "\n".join(engine_collector(stack.pool)())
    families = flightwatch.parse_metrics(page)
    frame = flightwatch.render(families, None, "12:00:00Z", "test:0")
    assert "REPLICAS" in frame and "tier" in frame
    assert "prefill" in frame and "decode" in frame and "SERVING" in frame


def test_signals_and_autopilot_accept_the_pool(stacks):
    """signals_snapshot, bind_recorder and the autopilot take a DisaggPool:
    no in-process planes, the pool's windows and tiers instead; a scale
    decision goes to the pool's scale_up, a knob to every worker through
    the control plane."""
    from polykey_tpu_torch.engine.autopilot import (
        SCALE_DECODE,
        UP,
        Autopilot,
        AutopilotConfig,
        Decision,
    )
    from polykey_tpu_torch.obs import FlightRecorder
    from polykey_tpu_torch.obs.signals import (
        bind_recorder,
        signals_available,
        signals_snapshot,
    )

    stack = stacks(_config(signals_interval_s=0.5))
    _run(stack.pool, "signals prompt", 4)
    bind_recorder(stack.pool, FlightRecorder())
    assert signals_available(stack.pool)
    snap = signals_snapshot(stack.pool)
    assert snap["replicas"] == {} and "pool" in snap and "pool_now" in snap
    assert set(snap["tiers"]) == {PREFILL, DECODE}
    assert snap["tiers"][DECODE]["serving"] == 1
    pilot = Autopilot(stack.pool, config=AutopilotConfig(interval_s=60.0)).start()
    try:
        assert stack.pool.autopilot is pilot
        assert pilot.state.setpoints["lookahead"] == FIELDS.get("lookahead_blocks", 2)
        scaled = []
        stack.pool.scale_up = lambda tier: scaled.append(tier) or f"{tier}/1"
        assert pilot._actuate(Decision(SCALE_DECODE, UP, "test", 0.5, 1, 2)) == 2
        assert scaled == [DECODE]
        assert signals_snapshot(stack.pool)["autopilot"]["enabled"]
        assert pilot._actuate(Decision("lookahead", UP, "test", 0.0, 2, 3)) == 3
        assert all(w.engine.knob_setpoints()["lookahead"] == 3 for w in stack.workers)
    finally:
        pilot.stop()


_COORDINATOR = r"""
import subprocess, sys, time
proc = subprocess.Popen(sys.argv[1:], stdout=subprocess.PIPE, text=True,
                        start_new_session=True)
print(proc.stdout.readline(), end="", flush=True)
time.sleep(600)
"""


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"     # exited, unreaped
    except FileNotFoundError:
        return True


def test_a_real_worker_process_starts_without_jax(tmp_path):
    """`python -m polykey_tpu_torch.engine.worker` on the CPU, with jax, flax
    and the JAX package shadowed by packages that refuse to import, started
    by a stand-in coordinator process: it prints its ready line and answers
    a ping, and once the coordinator is killed (no shutdown) it exits on
    its own. Without a CUDA device and not asked for the CPU it never
    becomes ready."""
    for name in ("jax", "flax", "polykey_tpu"):
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"raise ImportError('the worker must not import {name}')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}",
               POLYKEY_DEVICE="cpu", POLYKEY_MODEL="tiny-llama", POLYKEY_DTYPE="float32",
               POLYKEY_NUM_PAGES="64", POLYKEY_MAX_SEQ_LEN="64", POLYKEY_PAGE_SIZE="8",
               POLYKEY_PREFILL_BUCKETS="16,32", POLYKEY_SUPERVISE="0")
    env.pop("POLYKEY_FAULTS", None)
    cmd = [sys.executable, "-m", "polykey_tpu_torch.engine.worker", "--tier", "decode",
           "--replica", "0", "--port", "0", "--seed", "3"]
    coordinator = subprocess.Popen([sys.executable, "-c", _COORDINATOR, *cmd], cwd=tmp_path,
                                   env=env, stdout=subprocess.PIPE, text=True)
    worker_pid = None
    try:
        assert select.select([coordinator.stdout], [], [], 120)[0], "no ready line in 120 s"
        ready = json.loads(coordinator.stdout.readline())
        worker_pid = ready["pid"]
        assert ready["ready"] and ready["tier"] == "decode" and ready["device"] == "cpu"
        with tworker.WorkerConn(("127.0.0.1", ready["port"]), timeout=30) as conn:
            reply, _ = conn.request({"op": "ping"}, timeout=30)
        assert reply["state"] == "SERVING" and reply["pid"] == worker_pid
        assert isinstance(reply["mono"], float)
        coordinator.kill()
        coordinator.wait(timeout=30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not _gone(worker_pid):
            time.sleep(0.1)
        assert _gone(worker_pid), "the worker outlived its coordinator"
    finally:
        coordinator.kill()
        if worker_pid is not None and not _gone(worker_pid):
            os.kill(worker_pid, 9)
    if not torch.cuda.is_available():
        env.pop("POLYKEY_DEVICE")
        done = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=120)
        assert done.returncode != 0 and '"ready"' not in done.stdout
        assert "CUDA is not available" in done.stderr
