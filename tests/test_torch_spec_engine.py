"""The port's speculative engine on the CPU (tests/test_engine_spec.py's
cases, with the prefix-cache and host-tier ones of tests/test_prefix_cache.py
and tests/test_host_kv.py), against the JAX spec engine and the port's own
plain engine.

Both packages serve tiny-llama (float32, page size 8, buckets 16 and 32)
with a tiny-llama draft of other weights (the JAX engine's own draft
seed), gamma 3, on the same weights. Every greedy stream must equal the
JAX spec engine's and the port's plain engine's, token for token: at
lookahead depths 1 and 2, the adaptive gamma dial on and off, float32 and
int8 KV, with a prefix-cache hit and with the host tier. Sampled streams
are held within the port (ROADMAP.md C.1: the draws' bits differ from
jax.random's): they complete, speculate when they may, and a draft equal
to the target accepts every draft exactly. On the CPU the round runs
eagerly (`spec_eager`); its graphs are tested on the card
(tests/test_torch_cuda.py).
"""

import dataclasses
import queue
import time

import jax
import pytest
import torch

from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine import engine as engine_mod
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine, spec_graph_keys
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
SPEC = dict(draft_model="tiny-llama", spec_gamma=3)
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
# Five prompts on four slots, both buckets, and a 45-byte prompt past the
# largest bucket (chunked prefill).
PROMPTS = ["hello spec", "draft and verify", "q", "the quick brown fox", "x" * 45]
HEADER = "spec shared header for the cache. "          # 4 pages of 8
CACHED = [HEADER + t for t in ("one", "two", "three!")]   # within 64 - 12 - 3


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


def _streams(engine, make, prompts, max_new=12, sequential=False, **extra):
    """Greedy (or `extra`) streams of `prompts`, submitted together or one
    after another."""
    outs = []
    requests = []
    for p in prompts:
        r = make(prompt=p, max_new_tokens=max_new, **extra)
        engine.submit(r)
        requests.append(r)
        if sequential:
            tokens, done, error = _collect(r)
            assert error is None and done is not None, error
            outs.append(tokens)
    for r in ([] if sequential else requests):
        tokens, done, error = _collect(r)
        assert error is None and done is not None, error
        outs.append(tokens)
    return outs


@pytest.fixture(scope="module")
def weights():
    """(JAX target, JAX draft, port target, port draft): the JAX engine's
    weights at seed 0, and the draft it makes itself (seed + 2)."""
    cfg = j_get_config("tiny-llama")
    jp = jt.init_params(jax.random.PRNGKey(0), cfg, jax.numpy.float32)
    jd = jt.init_params(jax.random.PRNGKey(2), cfg, jax.numpy.float32)
    return jp, jd, params_from_numpy(jax.device_get(jp)), params_from_numpy(jax.device_get(jd))


def _jax_streams(weights, prompts, sequential=False, **fields):
    jp, jd = weights[:2]
    eng = JInferenceEngine(JEngineConfig(**{**FIELDS, **SPEC, **JAX_ONLY, **fields}),
                           params=jp, draft_params=jd)
    try:
        return _streams(eng, JGenRequest, prompts, sequential=sequential)
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def want(weights):
    """The JAX spec engine's greedy streams over float32 and int8 KV."""
    return {kv: _jax_streams(weights, PROMPTS, kv_dtype=kv) for kv in ("", "int8")}


@pytest.fixture
def port(weights):
    """Port engines on the CPU over the JAX weights (the draft too, unless
    given), shut down after."""
    made = []

    def make(fields=None, spec=True, draft="jax", params=None):
        cfg = EngineConfig(**{**FIELDS, **(SPEC if spec else {}), **(fields or {})})
        eng = InferenceEngine(cfg, params=params if params is not None else weights[2],
                              draft_params=weights[3] if draft == "jax" else draft,
                              device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown()


@pytest.fixture(scope="module")
def plain(weights):
    """The port's plain engine's greedy streams over float32 and int8 KV."""
    out = {}
    for kv in ("", "int8"):
        eng = InferenceEngine(EngineConfig(**FIELDS, kv_dtype=kv), params=weights[2],
                              device="cpu")
        try:
            out[kv] = _streams(eng, GenRequest, PROMPTS)
        finally:
            eng.shutdown()
    return out


@pytest.mark.parametrize("kv,adaptive,depth", [
    ("", True, 1), ("", True, 2), ("", False, 1), ("", False, 2),
    ("int8", True, 1), ("int8", True, 2),
], ids=["d1", "d2", "fixed-gamma-d1", "fixed-gamma-d2", "int8-d1", "int8-d2"])
def test_spec_greedy_matches_the_jax_spec_engine_and_plain(port, want, plain, monkeypatch,
                                                           kv, adaptive, depth):
    """THE acceptance bar: with a wrong draft (other weights), greedy
    streams are the target's chain, equal to the JAX spec engine's and to
    the port's plain engine's; the rounds really speculated, and a round
    emits several tokens of a batch (fewer processed blocks than tokens)."""
    monkeypatch.setenv("POLYKEY_DISPATCH_LOOKAHEAD", str(depth))
    eng = port(dict(kv_dtype=kv, adaptive_gamma=adaptive))
    got = _streams(eng, GenRequest, PROMPTS)
    assert got == want[kv] == plain[kv]
    stats = eng.stats()
    assert stats["drafts_proposed"] > 0 and stats["spec_eager"] > 0
    assert stats["decode_steps"] < stats["tokens_generated"]
    assert 0.0 <= stats["spec_acceptance"] <= 1.0
    assert stats["drafts_accepted"] <= stats["drafts_proposed"]
    assert stats["spec_graph_captures"] == 0 and stats["lookahead_depth"] == depth
    assert (eng._gamma_low, eng._gamma_max) == ((1, 3) if adaptive else (3, 3))
    if depth == 2:
        assert stats["blocks_overlapped"] > 0


def test_spec_sampled_completes_and_is_reproducible(port):
    """Sampled streams complete through spec rounds, and a seeded request
    gives the same stream again (draws keyed by seed, position and tag)."""
    eng = port()
    a = _streams(eng, GenRequest, PROMPTS[:4], temperature=0.8, seed=17)
    b = _streams(eng, GenRequest, PROMPTS[:4], temperature=0.8, seed=17)
    assert a == b and all(len(t) == 12 for t in a)
    snap = eng.metrics.snapshot()
    assert snap["requests_failed"] == 0 and snap["drafts_proposed"] > 0


def test_spec_top_p_without_the_prefilter_takes_the_plain_block(port):
    """Without the prefilter, a batch with a top_p < 1 sampled row takes
    the plain decode block: no round proposes a draft, and it completes."""
    eng = port()
    outs = _streams(eng, GenRequest, PROMPTS[:4], temperature=0.8, top_p=0.9)
    assert all(len(t) == 12 for t in outs)
    snap = eng.metrics.snapshot()
    assert snap["requests_failed"] == 0 and "drafts_proposed" not in snap


def test_spec_top_p_speculates_with_the_prefilter(port):
    """With top_p_candidates, top_p < 1 batches stay on the spec path, a
    mixed greedy and sampled batch too; the greedy row keeps its chain."""
    eng = port(dict(top_p_candidates=32))
    outs = _streams(eng, GenRequest, PROMPTS[:4], temperature=0.8, top_p=0.9)
    assert all(len(t) == 12 for t in outs)
    assert eng.metrics.snapshot()["drafts_proposed"] > 0
    greedy = GenRequest(prompt=PROMPTS[0], max_new_tokens=12)
    sampled = GenRequest(prompt="sampled row", max_new_tokens=12, temperature=0.9,
                         top_p=0.8, top_k=50)
    for r in (greedy, sampled):
        eng.submit(r)
    (g, *_), (s, *_) = _collect(greedy), _collect(sampled)
    assert len(s) == 12
    ref = port(spec=False)
    assert g == _streams(ref, GenRequest, PROMPTS[:1])[0]


@pytest.fixture(scope="module")
def same_weights():
    """tiny-llama at another seed, as both target and draft (no copy)."""
    return params_from_numpy(jax.device_get(jt.init_params(
        jax.random.PRNGKey(5), j_get_config("tiny-llama"), jax.numpy.float32)))


def test_spec_identity_draft_accepts_every_truncated_draft(port, same_weights):
    """Draft == target: the truncated acceptance ratio p'/q' is exactly 1,
    so top_p < 1 sampled streams (candidates 32) accept every draft; any
    asymmetry between the draft-side and verify-side truncation would show
    as a rejection."""
    eng = port(dict(top_p_candidates=32, max_decode_slots=2), params=same_weights,
               draft=same_weights)
    outs = _streams(eng, GenRequest, ["identical 0", "identical 1"], temperature=1.0,
                    top_p=0.7)
    assert all(len(t) == 12 for t in outs)
    snap = eng.metrics.snapshot()
    assert snap["drafts_proposed"] > 0
    assert snap["spec_acceptance"] == 1.0, snap


def test_spec_perfect_draft_keeps_the_full_gamma(port, same_weights):
    """Draft == target, greedy: acceptance exactly 1.0, the dial never
    leaves gamma 4, and the streams are the plain engine's."""
    eng = port(dict(spec_gamma=4), params=same_weights, draft=same_weights)
    got = _streams(eng, GenRequest, PROMPTS[:4])
    assert eng._gamma == 4 and eng.stats()["spec_gamma_min"] == 4
    assert eng.metrics.snapshot()["spec_acceptance"] == 1.0
    ref = port(spec=False, params=same_weights)
    assert got == _streams(ref, GenRequest, PROMPTS[:4])


def test_spec_budget_cap_mid_window(port, plain):
    """A budget that is no multiple of gamma + 1 truncates the last round
    on the device: exactly the budget, the plain stream's first tokens."""
    eng = port()
    for n in (1, 2, 10):
        (got,) = _streams(eng, GenRequest, PROMPTS[:1], max_new=n)
        assert got == plain[""][0][:n]


def test_adaptive_gamma_dials_every_lane_down_on_a_bad_draft(port, weights):
    """A draft that is always rejected drags every lane's EWMA under the
    floor: each lane's dial and the dispatch rung fall to gamma_low
    mid-stream; the streams stay the target's; a drained engine dispatches
    at full width again (fresh lanes start at gamma_max)."""
    eng = port(dict(spec_gamma=4))
    assert (eng._gamma, eng._gamma_low) == (4, 2)
    reqs = [GenRequest(prompt=p, max_new_tokens=24) for p in PROMPTS[:4]]
    for r in reqs:
        eng.submit(r)
    rung_low = lanes_low = False
    outs = []
    for r in reqs:
        tokens = []
        while True:
            kind, value = r.out.get(timeout=60)
            if kind != "token":
                assert kind == "done", value
                break
            tokens.append(value)
            rung_low |= eng._gamma == eng._gamma_low
            st = eng.stats()
            lanes_low |= st["spec_gamma_max"] == eng._gamma_low and st["slots_busy"] == 4
        outs.append(tokens)
    assert rung_low, "the dispatch rung never followed the lanes down"
    assert lanes_low, "the lane dials never all reached the low rung"
    assert eng._accept_ewma < 0.35
    ref = port(spec=False)
    assert outs == _streams(ref, GenRequest, PROMPTS[:4], max_new=24)
    deadline = time.monotonic() + 10
    while eng._gamma != 4 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng._gamma == 4


def test_set_spec_gamma_snaps_to_a_rung(port):
    eng = port(dict(spec_gamma=4))
    assert eng.set_spec_gamma(3) == 2 and eng._gamma == 2
    assert eng.set_spec_gamma(9) == 4
    assert port(spec=False).set_spec_gamma(4) == 0


def test_spec_heterogeneous_draft_architecture(monkeypatch, weights):
    """A smaller draft of the same vocabulary (other depth, heads and
    widths): the draft's pools size from its own config, and greedy
    streams equal the port's plain engine's and the JAX spec engine's."""
    from polykey_tpu.models import config as jcfg
    from polykey_tpu_torch.models import config as tcfg

    for mod in (jcfg, tcfg):
        monkeypatch.setitem(mod.MODEL_REGISTRY, "tiny-gemma-draft", dataclasses.replace(
            mod.TINY_GEMMA, name="tiny-gemma-draft", num_layers=1, num_heads=2,
            num_kv_heads=1, hidden_size=32, intermediate_size=64,
            query_pre_attn_scalar=16.0))
    jcfg_t, jcfg_d = jcfg.get_config("tiny-gemma"), jcfg.get_config("tiny-gemma-draft")
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg_t, jax.numpy.float32)
    jd = jt.init_params(jax.random.PRNGKey(2), jcfg_d, jax.numpy.float32)
    fields = dict(FIELDS, model="tiny-gemma")
    spec = dict(draft_model="tiny-gemma-draft", spec_gamma=3)
    jeng = JInferenceEngine(JEngineConfig(**fields, **spec, **JAX_ONLY), params=jp,
                            draft_params=jd)
    try:
        ref = _streams(jeng, JGenRequest, PROMPTS[:4])
    finally:
        jeng.shutdown()
    tp, td = params_from_numpy(jax.device_get(jp)), params_from_numpy(jax.device_get(jd))
    engines = [InferenceEngine(EngineConfig(**fields, **spec), params=tp, draft_params=td,
                               device="cpu"),
               InferenceEngine(EngineConfig(**fields), params=tp, device="cpu")]
    try:
        spec_out, plain_out = (_streams(e, GenRequest, PROMPTS[:4]) for e in engines)
        assert spec_out == plain_out == ref
        assert engines[0].d_paged.k.shape[0] == 1
        assert engines[0].metrics.snapshot()["drafts_proposed"] > 0
    finally:
        for e in engines:
            e.shutdown()


def test_spec_top_k_one_is_greedy_end_to_end(port, plain):
    """top_k = 1 on the truncated spec path: draft and verify
    distributions both collapse to the argmax, so the stream is the greedy
    one: the rank mask is applied alike on both sides."""
    eng = port(dict(top_p_candidates=32))
    got = _streams(eng, GenRequest, PROMPTS[:4], sequential=True, temperature=1.0,
                   top_k=1, seed=5)
    assert eng.metrics.snapshot()["drafts_proposed"] > 0
    assert got == plain[""][:4]


@pytest.mark.parametrize("depth", [1, 2])
def test_spec_prefix_cache_matches_uncached_and_jax(port, weights, monkeypatch, depth):
    """Spec and the prefix cache compose: the prefill graphs fill both
    pools, so a hit shares the target's and the draft's pages; the cached
    spec engine's streams equal the uncached one's, the plain engine's and
    the JAX spec engine's."""
    monkeypatch.setenv("POLYKEY_DISPATCH_LOOKAHEAD", str(depth))
    ref = _jax_streams(weights, CACHED, sequential=True)
    cached = port(dict(prefix_cache=True))
    got = _streams(cached, GenRequest, CACHED, sequential=True)
    uncached = _streams(port(), GenRequest, CACHED, sequential=True)
    plain_out = _streams(port(spec=False), GenRequest, CACHED, sequential=True)
    assert got == uncached == plain_out == ref
    stats = cached.stats()
    assert stats["prefix_hit_tokens"] > 0
    # A hit's acceptance: the draft's cached pages are its own KV (the
    # same page ids), so a hit proposes as an uncached admission does.
    assert stats["drafts_proposed"] > 0


def test_spec_prefix_hit_long_suffix_chunks(port, weights):
    """A hit whose suffix is past the largest bucket prefills it in chunks
    from the cached offset through the spec prefill."""
    fields = dict(prefix_cache=True, max_seq_len=256, num_pages=256)
    header = "h" * 24
    prompts = [header + "first tail", header + "x" * 60]
    ref = _jax_streams(weights, prompts, sequential=True, max_seq_len=256, num_pages=256)
    eng = port(fields)
    got = _streams(eng, GenRequest, prompts, sequential=True)
    assert got == ref
    assert eng.stats()["prefix_hit_tokens"] > 0


def test_spec_prefix_hit_near_the_table_end_keeps_its_slack(port):
    """Prompts of 40 tokens with 20 to generate on a 64-position table: with
    gamma 3 of slack the verify windows reach position 62, never past the
    table, and a hit's suffix (8 tokens at offset 32) stays inside it; the
    streams equal the uncached plain engine's."""
    header = "z" * 31                                   # + BOS: 4 pages
    prompts = [header + "a" * 8, header + "b" * 8]
    eng = port(dict(prefix_cache=True))
    got = _streams(eng, GenRequest, prompts, sequential=True, max_new=20)
    ref = _streams(port(spec=False), GenRequest, prompts, sequential=True, max_new=20)
    assert got == ref and all(len(t) == 20 for t in got)
    assert eng.stats()["prefix_hit_tokens"] == 32


def test_spec_host_tier_greedy_exact(port, weights):
    """Spec and the host tier: a restore refills the target's pools only
    (the draft's KV of a restored prefix is stale, as in the reference),
    which costs acceptance, never correctness: the streams equal the
    all-device plain engine's and the JAX spec engine's with the tier."""
    tier = dict(num_pages=24, prefill_chunk=16, max_new_tokens_cap=16, prefix_cache=True,
                host_kv_bytes=64 << 20, host_kv_resident_pages=12, spec_gamma=2)
    sessions = [f"session {s} header padded out to be long enough xx" for s in range(4)]
    sticky = sessions + [sessions[0], sessions[2], sessions[1], sessions[3]]
    eng = port(tier)
    got = _streams(eng, GenRequest, sticky, sequential=True, max_new=8)
    ref = _streams(port(dict(num_pages=128, prefill_chunk=16, max_new_tokens_cap=16),
                        spec=False), GenRequest, sticky, sequential=True, max_new=8)
    jp, jd = weights[:2]
    jeng = JInferenceEngine(JEngineConfig(**{**FIELDS, **SPEC, **JAX_ONLY, **tier}),
                            params=jp, draft_params=jd)
    try:
        jax_ref = _streams(jeng, JGenRequest, sticky, sequential=True, max_new=8)
    finally:
        jeng.shutdown()
    assert got == ref == jax_ref
    stats = eng.stats()
    assert stats["kv_pages_evicted"] > 0 and stats["kv_pages_restored"] > 0
    assert stats["drafts_proposed"] > 0


def test_merge_resets_the_lane_dial():
    """A new occupant's EWMA starts at 1.0 and its dial at gamma_max,
    whatever its slot's previous occupant left there."""
    state = {
        "last_tokens": torch.zeros(2, dtype=torch.int32),
        "seq_lens": torch.zeros(2, dtype=torch.int32),
        "page_tables": torch.zeros((2, 4), dtype=torch.int32),
        "active": torch.zeros(2, dtype=torch.bool),
        "caps": torch.zeros(2, dtype=torch.int32),
        "temperature": torch.zeros(2), "top_p": torch.ones(2),
        "top_k": torch.zeros(2, dtype=torch.int32),
        "seeds": torch.zeros((2, 2), dtype=torch.int32),
        "accept_ewma": torch.tensor([0.1, 0.2]),
        "gamma_lane": torch.tensor([1, 1], dtype=torch.int32),
    }
    engine_mod._merge_lane_fn(state, 1, torch.tensor([7]), 0, 5, 20, 0.0, 1.0, 0,
                              torch.arange(4, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32), eos_id=2, gamma_reset=4)
    assert state["accept_ewma"].tolist() == [pytest.approx(0.1), 1.0]
    assert state["gamma_lane"].tolist() == [1, 4]
    assert bool(state["active"][1]) and int(state["last_tokens"][1]) == 7


def test_spec_graph_keys_cover_the_reachable_variants():
    """(gamma, greedy, candidates): every rung at (greedy, 0) and (sampled,
    0), and (sampled, C) with the prefilter: 4 or 6 keys at the default
    ladder, 2 or 3 with the dial off."""
    assert spec_graph_keys((2, 4), 0) == [(2, True, 0), (2, False, 0),
                                          (4, True, 0), (4, False, 0)]
    assert len(spec_graph_keys((2, 4), 64)) == 6
    assert spec_graph_keys((4, 4), 64) == [(4, True, 0), (4, False, 0), (4, False, 64)]


def test_spec_stats_carry_the_reference_keys(port):
    eng = port(dict(top_p_candidates=16))
    _streams(eng, GenRequest, PROMPTS[:2])
    stats = eng.stats()
    for key in ("spec_gamma", "spec_gamma_cap", "spec_gamma_mean", "spec_gamma_min",
                "spec_gamma_max", "spec_accept_ewma_mean", "spec_accept_ewma_min",
                "spec_accept_ewma_max", "spec_graph_captures", "spec_graph_replays",
                "drafts_accepted", "drafts_proposed", "spec_acceptance",
                "draft_kv_pool_bytes"):
        assert key in stats, key
    assert "spec_gamma" not in port(spec=False).stats()


@pytest.mark.parametrize("fields,error,item", [
    (dict(draft_model="tiny-llama", replicas=2, disagg="1x1"), ValueError,
     "mutually exclusive"),
    (dict(checkpoint_path="/nonexistent"), FileNotFoundError, "/nonexistent"),
    (dict(draft_model="tiny-llama", draft_checkpoint_path="/nonexistent"),
     FileNotFoundError, "/nonexistent"),
    (dict(draft_model="tiny-llama", spec_host_sync=True), None, None),
], ids=["replicas", "checkpoint", "draft-checkpoint", "spec-host-sync"])
def test_config_refuses_what_is_not_ported(fields, error, item):
    """What is not ported is refused at validation, naming its ROADMAP.md
    item; checkpoints are loaded now (tests/test_torch_loader.py), so a
    path that does not exist is refused by name when the engine starts.
    The disaggregated pool is served now: with replicas and a draft it is
    refused as the reference refuses it (both exclusive with it).
    spec_host_sync is served now: it validates and the engine starts."""
    if error is None:
        EngineConfig(**fields).validate()
        InferenceEngine(EngineConfig(**{**FIELDS, **fields}), device="cpu").shutdown()
        return
    if error in (NotImplementedError, ValueError):
        with pytest.raises(error, match=item):
            EngineConfig(**fields).validate()
    else:
        EngineConfig(**fields).validate()
    with pytest.raises(error, match=item):
        InferenceEngine(EngineConfig(**{**FIELDS, **fields}), device="cpu")


@pytest.mark.parametrize("ragged", [False, True], ids=["bucketed", "ragged"])
def test_spec_host_sync_reads_three_times_a_round(port, monkeypatch, ragged):
    """spec_host_sync (the reference's A/B instrumentation): the greedy
    streams are those without it, and each spec round adds three timed
    blocking reads to blocks_synced and the host-stall accounting, on the
    bucketed round and on the ragged stream's. Depth 1 makes the two
    runs' schedules the same."""
    monkeypatch.setenv("POLYKEY_DISPATCH_LOOKAHEAD", "1")
    extra = dict(ragged_dispatch=True, top_p_candidates=32) if ragged else {}
    runs = {}
    for sync in (False, True):
        eng = port(dict(spec_host_sync=sync, **extra))
        outs = _streams(eng, GenRequest, PROMPTS)
        m = eng.metrics
        runs[sync] = outs, dict(m.counter_sample(), hist=m.host_stall_hist.count), eng.stats()
    (off, m_off, s_off), (on, m_on, s_on) = runs[False], runs[True]
    assert on == off
    assert s_on["spec_rounds"] == s_off["spec_rounds"] > 0
    assert m_on["blocks_synced"] - m_off["blocks_synced"] == 3 * s_on["spec_rounds"]
    assert m_on["hist"] - m_off["hist"] == 3 * s_on["spec_rounds"]
    if ragged:
        assert s_on["ragged_spec_dispatches"] == s_off["ragged_spec_dispatches"] > 0


def test_config_takes_spec_and_the_prefilter_and_checks_them(monkeypatch):
    EngineConfig(draft_model="tiny-llama", top_p_candidates=64, spec_gamma=2).validate()
    EngineConfig(ragged_dispatch=True, top_p_candidates=64).validate()
    with pytest.raises(ValueError, match="spec_gamma"):
        EngineConfig(draft_model="tiny-llama", spec_gamma=0).validate()
    with pytest.raises(ValueError, match="top_p_candidates"):
        EngineConfig(top_p_candidates=-1).validate()
    monkeypatch.setenv("POLYKEY_DRAFT_MODEL", "llama-3.2-1b")
    monkeypatch.setenv("POLYKEY_SPEC_GAMMA", "3")
    monkeypatch.setenv("POLYKEY_TOP_P_CANDIDATES", "64")
    monkeypatch.setenv("POLYKEY_ADAPTIVE_GAMMA", "0")
    cfg = EngineConfig.from_env()
    assert (cfg.draft_model, cfg.spec_gamma, cfg.top_p_candidates, cfg.adaptive_gamma) == (
        "llama-3.2-1b", 3, 64, False)
    assert EngineConfig().adaptive_gamma is True


def test_draft_vocab_must_match(monkeypatch):
    from polykey_tpu_torch.models import config as tcfg

    monkeypatch.setitem(tcfg.MODEL_REGISTRY, "tiny-other-vocab", dataclasses.replace(
        tcfg.TINY_LLAMA, name="tiny-other-vocab", vocab_size=300))
    with pytest.raises(ValueError, match="vocab"):
        InferenceEngine(EngineConfig(**{**FIELDS, "draft_model": "tiny-other-vocab"}),
                        device="cpu")


def test_prefilter_serves_plain_engines_in_both_modes(port):
    """top_p_candidates on a plain engine: the prefill, the decode block and
    the ragged dispatch all sample through the prefilter, so a seeded
    sampled stream is the same in the bucketed and the ragged mode; a
    request's top_k clamps to C at admission; greedy streams are the
    plain engine's."""
    fields = dict(top_p_candidates=32)
    bucketed = port(fields, spec=False)
    ragged = port(dict(fields, ragged_dispatch=True), spec=False)
    kw = dict(temperature=0.8, top_p=0.9, top_k=100, seed=21)
    a = _streams(bucketed, GenRequest, PROMPTS, sequential=True, **kw)
    b = _streams(ragged, GenRequest, PROMPTS, sequential=True, **kw)
    assert a == b and all(len(t) == 12 for t in a)
    assert bucketed._eff_top_k(GenRequest(prompt="x", top_k=100)) == 32
    assert bucketed._eff_top_k(GenRequest(prompt="x", top_k=5)) == 5
    assert bucketed._eff_top_k(GenRequest(prompt="x")) == 0
    plain_out = _streams(port(spec=False), GenRequest, PROMPTS[:2])
    assert _streams(bucketed, GenRequest, PROMPTS[:2]) == plain_out
