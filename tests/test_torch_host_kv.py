"""The port's host-KV tier on the CPU (tests/test_host_kv.py's engine
cases, on the port): cold prefix pages spilled to host pools, faulted back
through the restore frontier, and a durable state dir that the JAX
package's engine can write and the port's read.

A tight device pool (23 usable pages of 8 rows, 64-token sequences) makes
a few sticky sessions oversubscribe it; the resident floor makes every
retirement spill. Greedy streams with the tier on must equal the port's
all-device engine's and the JAX engine's, float32 and int8 KV, bucketed
and ragged (the ragged mode held to its own all-device stream and to the
JAX bucketed one, never to the JAX ragged engine's).
"""

import json
import os
import queue
import time

import jax
import numpy as np
import pytest
import torch

from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine import engine as engine_mod
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine, _Slot
from polykey_tpu_torch.engine.kv_cache import BlockAllocator, HostKVPool, host_kv_page_bytes
from polykey_tpu_torch.engine.prefix_cache import TIER_HOST, PrefixCache, PrefixStateStore
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy

torch.set_num_threads(2)

FIELDS = dict(
    model="tiny-llama",
    tokenizer="byte",
    dtype="float32",
    max_decode_slots=4,
    page_size=8,
    num_pages=24,
    max_seq_len=64,
    prefill_buckets=(16, 32),
    prefill_chunk=16,
    max_new_tokens_cap=16,
    prefix_cache=True,
    host_kv_bytes=64 << 20,
    host_kv_resident_pages=12,
)
# All-device reference: the same math, a pool nothing spills from.
REF = dict(FIELDS, num_pages=128, host_kv_bytes=0, host_kv_resident_pages=0)
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
SESSIONS = [f"session {s} header padded out to be long enough xx" for s in range(4)]
STICKY = SESSIONS + [SESSIONS[0], SESSIONS[2], SESSIONS[1], SESSIONS[3]]


def _collect(request, timeout=60.0):
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


def _serve(engine, make, prompts, max_new=8):
    outs = []
    for p in prompts:
        r = make(prompt=p, max_new_tokens=max_new)
        engine.submit(r)
        tokens, done, error = _collect(r)
        assert error is None and done is not None, error
        outs.append(tokens)
    return outs


def _idle(engine, timeout=10.0):
    deadline = time.monotonic() + timeout
    while (engine.busy or engine._inflight_q) and time.monotonic() < deadline:
        time.sleep(0.01)


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                          jax.numpy.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.device_get(jax_params))


@pytest.fixture(scope="module")
def jax_state(jax_params, tmp_path_factory):
    """A JAX engine with the host tier on explicit weights, writing a state
    dir: its sticky streams (the JAX bucketed reference) and the dir."""
    state_dir = str(tmp_path_factory.mktemp("jax-state"))
    eng = JInferenceEngine(JEngineConfig(**FIELDS, **JAX_ONLY, kv_state_dir=state_dir),
                           params=jax_params)
    try:
        streams = _serve(eng, JGenRequest, STICKY)
        assert eng.stats()["kv_pages_evicted"] > 0
    finally:
        eng.shutdown()
    return streams, state_dir


@pytest.fixture
def port(torch_params):
    made = []

    def make(engine_cls=InferenceEngine, params="shared", **fields):
        eng = engine_cls(EngineConfig(**{**FIELDS, **fields}),
                         params=torch_params if params == "shared" else params,
                         device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown()


# -- units --------------------------------------------------------------------------

def test_host_pool_alloc_release_balance():
    cfg = get_config("tiny-llama")
    pool = HostKVPool(cfg, capacity_pages=4, page_size=8, dtype=torch.float32,
                      quantized=False)
    pages = [pool.alloc() for _ in range(4)]
    assert sorted(pages) == [0, 1, 2, 3] and pool.used == 4
    with pytest.raises(RuntimeError, match="full"):
        pool.alloc()
    for p in pages:
        pool.release(p)
    assert pool.num_free == 4
    q = HostKVPool(cfg, 2, 8, torch.float32, quantized=True)
    assert q.k.dtype == torch.int8 and q.ks.dtype == torch.bfloat16 and len(q.pools) == 4
    assert host_kv_page_bytes(cfg, 8, torch.float32) == sum(
        t[:, 0].numel() * t.element_size() for t in pool.pools)
    assert host_kv_page_bytes(cfg, 8, torch.float32, torch.int8) == sum(
        t[:, 0].numel() * t.element_size() for t in q.pools)


BAD = {
    "host without cache": dict(prefix_cache=False, host_kv_bytes=1 << 20),
    "negative bytes": dict(host_kv_bytes=-1),
    "floor past the pool": dict(host_kv_bytes=1 << 20, host_kv_resident_pages=23),
    "negative floor": dict(host_kv_resident_pages=-1),
    "no restore slots": dict(host_kv_restore_slots=0),
    "negative cache pages": dict(prefix_cache_pages=-1),
}


@pytest.mark.parametrize("case", list(BAD))
def test_config_validates_as_the_reference(case):
    """The prefix and host-tier knobs validate as the reference's do; the
    valid ones raise nothing unported."""
    fields = {**FIELDS, **BAD[case]}
    with pytest.raises(ValueError) as ours:
        EngineConfig(**fields).validate()
    with pytest.raises(ValueError) as ref:
        JEngineConfig(**fields).validate()
    assert str(ours.value) == str(ref.value)
    EngineConfig(**dict(FIELDS, kv_state_dir="/nonexistent")).validate()


def test_from_env_reads_the_host_knobs(monkeypatch):
    env = {"POLYKEY_HOST_KV_BYTES": str(1 << 30), "POLYKEY_KV_RESIDENT_PAGES": "64",
           "POLYKEY_KV_RESTORE_SLOTS": "3", "POLYKEY_KV_STATE_DIR": "/tmp/kv",
           "POLYKEY_PREFIX_CACHE_PAGES": "100"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, ref = EngineConfig.from_env(), JEngineConfig.from_env()
    for name in ("prefix_cache", "prefix_cache_pages", "host_kv_bytes",
                 "host_kv_resident_pages", "host_kv_restore_slots", "kv_state_dir"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.prefix_cache and ours.host_kv_bytes == 1 << 30


def test_state_store_roundtrip_and_params_gate(tmp_path):
    cfg = get_config("tiny-llama")
    shape = (cfg.num_layers, 2, 8, cfg.num_kv_heads, cfg.head_dim)
    g = torch.Generator().manual_seed(0)
    k, v = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    keys = [b"\x01" * 16, b"\x02" * 16]
    PrefixStateStore(str(tmp_path), "tiny-llama", 8, params_key="abc",
                     quantized=False).save_batch(keys, k, v, None, None)
    host = HostKVPool(cfg, 4, 8, torch.float32, False)
    cache = PrefixCache(BlockAllocator(16), 8, 16, host_pool=host)
    expect = (cfg.num_layers, 0, 8, cfg.num_kv_heads, cfg.head_dim)
    store = PrefixStateStore(str(tmp_path), "tiny-llama", 8, params_key="abc",
                             quantized=False)
    assert store.load_into(cache, host, expect) == 2 and cache.host_entries() == 2
    for i, key in enumerate(keys):
        page, tier = cache._map[key]
        assert tier == TIER_HOST
        assert torch.equal(host.k[:, page], k[:, i]) and torch.equal(host.v[:, page], v[:, i])
    other = PrefixStateStore(str(tmp_path), "tiny-llama", 8, params_key="different",
                             quantized=False)
    cache2 = PrefixCache(BlockAllocator(16), 8, 16, host_pool=host)
    assert other.load_into(cache2, host, expect) == 0
    # A second store in the same process writes beside the first, never
    # over it.
    store.save_batch([b"\x03" * 16], k[:, :1], v[:, :1], None, None)
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".pkkv")]) == 2


def test_restore_budget_and_progress_floor(port):
    """The restore frontier issues at most `host_kv_restore_slots` faulting
    slots an iteration, round-robin (a starved slot goes first next time),
    and always at least one: set_kv_restore_slots(0) applies 1."""
    eng = port(host_kv_restore_slots=2)
    eng.shutdown()
    issued = []
    eng._restore_rr = engine_mod._RRCursor()
    eng._restore_slot_pages = lambda i, slot: (issued.append(i),
                                               setattr(slot, "restore_pages", None))
    table = np.zeros(8, np.int32)

    def fault(i):
        eng._slots[i] = _Slot(request=GenRequest(prompt="x"), pages=[], table=table,
                              seed_row=np.zeros(2, np.int32), prompt_len=1,
                              position_cap=2, restore_pages=[(b"k", 0, 0)])

    for i in range(4):
        fault(i)
    assert eng._issue_restores() == 2 and issued == [0, 1]
    assert eng._issue_restores() == 2 and issued == [0, 1, 2, 3]
    assert eng.set_kv_restore_slots(0) == 1
    for i in (1, 3):
        fault(i)
    assert eng._issue_restores() == 1 and eng._issue_restores() == 1
    assert sorted(issued[4:]) == [1, 3]
    assert eng._issue_restores() == 0
    assert eng.set_kv_restore_slots(99) == FIELDS["max_decode_slots"]
    eng._slots = [None] * 4


# -- the engine -----------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["fp32", "int8"])
def test_sticky_sessions_bit_identical(port, jax_state, kv_dtype):
    """Sessions revisited after their prefixes spilled fault them back; the
    streams equal the all-device engine's (and, float32, the JAX host-tier
    engine's); pages spilled, restored and faulted are all counted."""
    ref = _serve(port(**dict(REF, kv_dtype=kv_dtype)), GenRequest, STICKY)
    eng = port(kv_dtype=kv_dtype)
    assert _serve(eng, GenRequest, STICKY) == ref
    if not kv_dtype:
        assert ref == jax_state[0]
    stats = eng.stats()
    assert stats["host_kv"] is True and stats["kv_pages_evicted"] > 0
    assert stats["kv_pages_restored"] > 0
    assert stats["kv_page_faults_prefix"] + stats["kv_page_faults_ctx"] > 0
    assert stats["kv_restore_ms_p50"] >= 0


def test_ragged_with_host_tier_bit_identical(port, jax_state):
    """Ragged mode: faulting slots join no ragged dispatch until restored;
    the streams equal the ragged all-device engine's and the JAX bucketed
    host-tier engine's."""
    ref = _serve(port(**dict(REF, ragged_dispatch=True)), GenRequest, STICKY)
    eng = port(ragged_dispatch=True)
    assert _serve(eng, GenRequest, STICKY) == ref == jax_state[0]
    assert eng.stats()["kv_pages_restored"] > 0


def test_tiny_host_pool_pressure_never_kills_engine(port):
    """A host tier of 3 pages, smaller than one session's chain, under heavy
    revisits: spills into a full tier drop other host entries, never one a
    pending restore depends on, and every stream is right."""
    page_b = host_kv_page_bytes(get_config("tiny-llama"), 8, torch.float32)
    mix = STICKY * 3
    ref = _serve(port(**REF), GenRequest, mix)
    eng = port(host_kv_bytes=3 * page_b)
    assert _serve(eng, GenRequest, mix) == ref
    assert eng.stats()["kv_host_capacity"] == 3


def test_pages_balance_after_idle_with_tier(port):
    """Every device page is free or cache-held once idle; host pages are
    exactly the cache's host entries."""
    eng = port()
    _serve(eng, GenRequest, STICKY)
    _idle(eng)
    stats = eng.stats()
    assert stats["pages_free"] + stats["prefix_cache_pages"] == FIELDS["num_pages"] - 1
    assert stats["kv_host_pages"] == stats["prefix_host_pages"] > 0


def test_tier_disabled_allocates_nothing(port):
    eng = port(**REF)
    assert eng._host_kv is None
    stats = eng.stats()
    assert (stats["host_kv"], stats["kv_host_pages"], stats["kv_host_capacity"]) == (False, 0, 0)


class _OrderEngine(InferenceEngine):
    """Records lane merges and restores in the order the engine issues them."""

    def _merge_slot(self, slot_idx, *args):
        self.order = getattr(self, "order", []) + [("merge", self._slots[slot_idx].request)]
        super()._merge_slot(slot_idx, *args)

    def _restore_slot_pages(self, slot_idx, slot):
        self.order = getattr(self, "order", []) + [("restore", slot.request)]
        super()._restore_slot_pages(slot_idx, slot)


def test_resident_lane_dispatches_while_faulting_lane_waits(port):
    """Revisits of spilled sessions (faulting) submitted with a fresh prompt
    (resident): the resident lane merges before the first restore, and each
    faulting lane merges only after its own restore."""
    eng = port(engine_cls=_OrderEngine, host_kv_restore_slots=1)
    _serve(eng, GenRequest, SESSIONS)
    _idle(eng)
    spilled = [p for p in SESSIONS if eng._prefix.probe_tiered(
        np.asarray(eng.tokenizer.encode(p), np.int32))[1]]
    assert spilled, "nothing spilled"
    eng.order = []
    eng.shutdown()        # stop the loop; queue the burst, then run it
    eng._stop.clear()
    requests = [GenRequest(prompt=p, max_new_tokens=6)
                for p in spilled + ["fresh resident prompt yy"]]
    for r in requests:
        eng._submit.put(r)
    eng._thread = engine_mod.threading.Thread(target=eng._run, daemon=True)
    eng._thread.start()
    for r in requests:
        _, done, error = _collect(r)
        assert error is None and done is not None, error
    kinds = [(kind, requests.index(r)) for kind, r in eng.order if r in requests]
    restores = [i for i, (kind, _) in enumerate(kinds) if kind == "restore"]
    assert restores, "the revisits never faulted"
    assert kinds.index(("merge", len(spilled))) < restores[0], kinds
    for i in restores:
        assert kinds.index(("merge", kinds[i][1])) > i, kinds


def test_durable_reload_recovers_warm_streams(port, tmp_path):
    """A second engine on the same weights reloads the first one's spills
    and serves its sessions warm, to the same streams; a corrupt file is
    discarded without harm."""
    first = _serve(port(kv_state_dir=str(tmp_path)), GenRequest, SESSIONS)
    blobs = sorted(n for n in os.listdir(tmp_path) if n.endswith(".pkkv"))
    assert blobs
    fresh = port(kv_state_dir=str(tmp_path))
    assert fresh._kv_reloaded_pages > 0
    assert _serve(fresh, GenRequest, SESSIONS) == first
    assert fresh.stats()["kv_pages_restored"] > 0
    path = os.path.join(tmp_path, blobs[0])
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    again = port(kv_state_dir=str(tmp_path))
    assert not os.path.exists(path)
    assert _serve(again, GenRequest, SESSIONS) == first


def test_jax_state_dir_warms_the_port_on_shared_weights(port, jax_state):
    """A state dir the JAX engine wrote on explicit weights: the port engine
    on the same weights has the same params_key, reloads the pages, faults
    them in and serves the JAX engine's streams."""
    streams, state_dir = jax_state
    eng = port(kv_state_dir=state_dir)
    sidecar = next(n for n in os.listdir(state_dir) if n.endswith(".keys.json"))
    with open(os.path.join(state_dir, sidecar)) as f:
        assert json.load(f)["params_key"] == eng._kv_state.params_key
    assert eng._kv_reloaded_pages > 0
    assert _serve(eng, GenRequest, STICKY) == streams
    assert eng.stats()["kv_pages_restored"] > 0


def test_seed_made_jax_state_dir_is_refused(port, tmp_path):
    """Weights made from a seed differ between the packages (jax.random
    against a torch.Generator): a seed-made JAX engine's dir must not warm
    a seed-made port engine."""
    jeng = JInferenceEngine(JEngineConfig(**FIELDS, **JAX_ONLY, kv_state_dir=str(tmp_path)),
                            seed=0)
    try:
        _serve(jeng, JGenRequest, SESSIONS[:3], max_new=2)
        assert jeng.stats()["kv_pages_evicted"] > 0
        jkey = jeng._kv_state.params_key
    finally:
        jeng.shutdown()
    eng = port(params=None, kv_state_dir=str(tmp_path))
    assert eng._kv_state.params_key != jkey
    assert eng._kv_reloaded_pages == 0
    assert eng.stats()["kv_host_pages"] == 0


def test_prefix_warmth_is_tier_aware(port):
    """A spilled prefix probes above cold but below the same prefix on the
    device: host tokens weigh 0.5."""
    eng = port()
    _serve(eng, GenRequest, SESSIONS)
    _idle(eng)
    spilled = 0
    for p in SESSIONS:
        ids = eng.tokenizer.encode(p)
        dev, host = eng._prefix.probe_tiered(np.asarray(ids, np.int32))
        warmth = eng.prefix_warmth(ids)
        assert abs(warmth - (dev + 0.5 * host) / len(ids)) < 1e-9
        if host:
            spilled += 1
            assert 0.0 < warmth < (dev + host) / len(ids)
    assert spilled, "no session was host-resident"

