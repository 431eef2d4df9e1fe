"""The port's prefix cache (polykey_tpu_torch/engine/prefix_cache.py) on
the CPU, against the JAX package's (tests/test_prefix_cache.py's checks,
on the port).

Both packages serve tests/test_torch_pipeline.py's fields (tiny-llama,
float32, page size 8, buckets (16, 32), max_seq_len 64) with the same
weights. The cache's keys must match the reference's byte for byte, its
bookkeeping step for step, and a cached engine's greedy streams must equal
the JAX cached engine's and the port's uncached engine's: bucketed and
ragged (the ragged mode held to the JAX *bucketed* engine), float32 and
int8 KV, lookahead depths 1 and 2. A suffix whose padded window would run
past the page table is checked on the slot's KV pages, not on tokens.
"""

import queue
import time

import jax
import numpy as np
import pytest
import torch

from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu.engine import prefix_cache as jpc
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine import kv_cache as tkv
from polykey_tpu_torch.engine import prefix_cache as tpc
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy

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
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
HEADER = "system: be a helpful fixture. "
BASE = "incremental prompt growth check 0123456789"
# Served in order on one engine: a repeated prompt (a chunked miss, then
# bucket-16 suffixes at offset 32), prompts sharing a header, and prompts
# that are prefixes of each other.
PROMPTS = (["the same long-ish prompt body repeated"] * 3
           + [HEADER + tail for tail in ("alpha", "beta", "gamma delta")]
           + [BASE[:20], BASE[:33], BASE])
MODES = {
    "bucketed-d1": dict(lookahead_blocks=1),
    "bucketed-d2": dict(),
    "ragged-d1": dict(ragged_dispatch=True, lookahead_blocks=1),
    "ragged-d2": dict(ragged_dispatch=True),
    "int8-d1": dict(kv_dtype="int8", lookahead_blocks=1),
    "int8-d2": dict(kv_dtype="int8"),
}


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
    """Each prompt in turn (later ones see the cache); their streams."""
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
def want(jax_params):
    """The JAX cached bucketed engine's streams over float32 and int8 KV."""
    out = {}
    for kv in ("", "int8"):
        eng = JInferenceEngine(JEngineConfig(**FIELDS, **JAX_ONLY, kv_dtype=kv,
                                             prefix_cache=True), params=jax_params)
        try:
            out[kv] = _serve(eng, JGenRequest, PROMPTS)
            assert eng.stats()["prefix_hit_tokens"] > 0
        finally:
            eng.shutdown()
    return out


@pytest.fixture
def port(torch_params):
    """Port engines on the CPU over the JAX weights, shut down after."""
    made = []

    def make(engine_cls=InferenceEngine, **extra):
        eng = engine_cls(EngineConfig(**{**FIELDS, **extra}), params=torch_params,
                         device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown()


# -- the cache structure ------------------------------------------------------------

@pytest.mark.parametrize("page_size", [4, 8, 16])
def test_page_keys_match_the_reference(page_size):
    """The rolling blake2b keys over int32 token bytes, byte for byte."""
    ids = np.random.default_rng(page_size).integers(0, 128256, 100).astype(np.int32)
    n = len(ids) // page_size
    assert tpc._page_keys(ids, page_size, n) == jpc._page_keys(ids, page_size, n)
    assert len(set(tpc._page_keys(ids, page_size, n))) == n


def test_cache_script_matches_the_reference():
    """One scripted sequence of lookups, inserts, spills, faults, adoptions
    and evictions drives both packages' caches (each over its own
    allocator and host pool); every result, the stats, the allocators' and
    host pools' free counts agree at every step."""
    cfg = get_config("tiny-llama")
    port = dict(alloc=tkv.BlockAllocator(24))
    ref = dict(alloc=jkv.BlockAllocator(24, prefer_native=False))
    port["host"] = tkv.HostKVPool(cfg, 3, 4, torch.float32, False)
    ref["host"] = jkv.HostKVPool(j_get_config("tiny-llama"), 3, 4, np.float32, False)
    for side, mod in ((port, tpc), (ref, jpc)):
        side["cache"] = mod.PrefixCache(side["alloc"], 4, 6, host_pool=side["host"])
    a = np.arange(13, dtype=np.int32)
    b = np.concatenate([a[:8], np.full(9, 99, np.int32)])
    c = np.arange(100, 121, dtype=np.int32)

    def insert(side, ids, n):
        pages = side["alloc"].alloc(n)
        side["cache"].insert(ids, pages)
        side["alloc"].release_all(pages)
        return pages

    def spill(side, n):
        out = []
        for key, page in side["cache"].spill_candidates(n):
            try:
                hp = side["host"].alloc()
            except Exception:
                if side["cache"].pop_lru_host() is None:
                    side["cache"].drop(key)
                    out.append(("drop", key))
                    continue
                hp = side["host"].alloc()
            side["cache"].mark_host(key, hp)
            out.append((key, page, hp))
        return out

    def chain(side, ids):
        matched, faults = side["cache"].lookup_chain(ids)
        side["cache"].release_chain(matched)
        return matched, faults

    def detach_adopt(side, ids):
        matched, faults = side["cache"].lookup_chain(ids)
        side["cache"].release_chain(matched)
        out = []
        for i in faults:
            key = matched[i][0]
            hp = side["cache"].detach_host(key)
            out.append((hp, side["cache"].adopt_host(key, hp),
                        side["cache"].adopt_host(key, hp)))
        return out

    def lookup(side, ids):
        pages = side["cache"].lookup(ids)
        side["alloc"].release_all(pages)
        return pages

    def reinsert(side, ids):
        matched, faults = side["cache"].lookup_chain(ids)
        side["cache"].release_chain(matched)
        out = []
        for i in faults:
            key = matched[i][0]
            hp = side["cache"].detach_host(key)
            page = side["alloc"].alloc(1)[0]
            side["host"].release(hp)
            out.append((page, side["cache"].reinsert_device(key, page),
                        side["cache"].reinsert_device(key, page)))
            side["alloc"].release(page)
        return out

    steps = [
        lambda s: insert(s, a, 4),
        lambda s: lookup(s, a),
        lambda s: lookup(s, b),
        lambda s: insert(s, b, 5),
        lambda s: s["cache"].probe_tiered(b),
        lambda s: spill(s, 2),
        lambda s: chain(s, a),
        lambda s: s["cache"].probe_tiered(a),
        lambda s: s["cache"].lookup(a) and None,
        lambda s: detach_adopt(s, a),
        lambda s: spill(s, 4),
        lambda s: insert(s, c, 6),
        lambda s: reinsert(s, a),
        lambda s: s["cache"].evict_for(23),
        lambda s: s["cache"].pop_lru_host(),
        lambda s: insert(s, a, 4),
        lambda s: s["cache"].clear(),
    ]
    for n, step in enumerate(steps):
        got, exp = step(port), step(ref)
        assert got == exp, n
        for side in (port, ref):
            side["state"] = (side["cache"].stats(), len(side["cache"]),
                             side["cache"].device_entries(), side["cache"].host_entries(),
                             side["alloc"].num_free, side["host"].num_free)
        assert port["state"] == ref["state"], n
    assert len(port["cache"]) == 0 and port["alloc"].num_free == 23


# -- the engine -----------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_cached_streams_match_the_reference(port, want, mode):
    """Repeated, shared-header and prefix-of-each-other prompts: the cached
    engine's greedy streams equal the JAX cached engine's and the port's
    uncached engine's, with hits in the cache's accounting."""
    extra = MODES[mode]
    kv = "int8" if mode.startswith("int8") else ""
    cold = _serve(port(**extra), GenRequest, PROMPTS)
    eng = port(prefix_cache=True, **extra)
    got = _serve(eng, GenRequest, PROMPTS)
    assert got == want[kv]
    assert got == cold
    assert got[0] == got[1] == got[2]
    stats = eng.stats()
    assert stats["prefix_hit_tokens"] >= 32 * 2 + 24 * 2 + 16 + 32
    assert stats["prefix_lookup_tokens"] == sum(len(eng.tokenizer.encode(p)) for p in PROMPTS)


def test_pages_balance_after_idle(port):
    """Every page is free or held by the cache once the engine is idle."""
    eng = port(prefix_cache=True)
    _serve(eng, GenRequest, [f"shared head for accounting {i % 2}" for i in range(6)],
           max_new=6)
    _idle(eng)
    stats = eng.stats()
    assert stats["prefix_cache_pages"] > 0
    assert stats["pages_free"] + stats["prefix_cache_pages"] == FIELDS["num_pages"] - 1
    assert stats["kv_device_pages"] == stats["prefix_cache_pages"]


def test_eviction_under_pool_pressure_serves_everything(port):
    """A 20-page pool and a cache allowed to hold more than it: admissions
    evict LRU entries and every prompt is served, to the uncached streams."""
    prompts = [f"pressure prompt number {i} padded out a bit" for i in range(8)]
    cold = _serve(port(), GenRequest, prompts)
    eng = port(prefix_cache=True, num_pages=20, prefix_cache_pages=64)
    assert _serve(eng, GenRequest, prompts) == cold
    _idle(eng)
    assert eng.stats()["pages_free"] + eng.stats()["prefix_cache_pages"] == 19


class _RecordingEngine(InferenceEngine):
    """Keeps each finished slot's page table (its pages' contents stay in
    the pools until they are allocated again)."""

    def _finish(self, slot_idx, error=None):
        slot = self._slots[slot_idx]
        if slot is not None:
            self.finished = getattr(self, "finished", []) + [list(slot.pages)]
        super()._finish(slot_idx, error)


def _prompt_kv(eng, pages, n):
    """Positions 0..n-1 of every pool along the slot's pages, [L, n, ...]."""
    out = []
    for t in eng.paged.pools:
        rows = t[:, pages].reshape(t.shape[0], -1, *t.shape[3:])
        out.append(rows[:, :n].clone())
    return out


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["fp32", "int8"])
def test_suffix_window_past_the_table_keeps_the_slot_pages(port, kv_dtype):
    """A 60-token prompt again, with 7 cached pages (56 tokens): its 4-token
    suffix would go into bucket 16 at position 56, whose padded rows 64..71
    clamp onto the last page, over the suffix's own KV. The match is cut to
    6 pages, so the window [48, 64) fits; the second request's KV at every
    prompt position equals the uncached engine's for the same prompt
    (exactly on the shared pages; on the recomputed suffix to 1e-5, int8
    values to one step)."""
    prompt = "".join(chr(ord("a") + i % 26) for i in range(60))
    cold = port(engine_cls=_RecordingEngine, kv_dtype=kv_dtype)
    want = _serve(cold, GenRequest, [prompt], max_new=4)
    _idle(cold)
    ref = _prompt_kv(cold, cold.finished[0], 60)
    eng = port(engine_cls=_RecordingEngine, kv_dtype=kv_dtype, prefix_cache=True)
    got = _serve(eng, GenRequest, [prompt, prompt], max_new=4)
    _idle(eng)
    assert got == want * 2
    assert eng.stats()["prefix_hit_tokens"] == 48      # cut from 56
    first, second = eng.finished
    assert second[:6] == first[:6] and second[6] != first[6]
    for a, b in zip(_prompt_kv(eng, second, 60), ref):
        assert torch.equal(a[:, :48], b[:, :48])
        if a.dtype == torch.int8:     # one quantization step at most
            assert (a.int() - b.int()).abs().max() <= 1
        else:
            assert torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-5)
