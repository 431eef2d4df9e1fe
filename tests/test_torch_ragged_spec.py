"""The port's speculative round on the ragged stream (ragged x spec) on the
CPU, against the JAX package.

- `ragged_spec_fn` against the JAX function on the same operands (tiny
  models, fp32, page size 8): three live lanes (one cut at its cap inside
  the window) and an inactive one, beside a chunked prompt's final range.
  The packed matrix, the lane state written back and the first token are
  equal; the verify windows' logits agree within LOGIT_TOL and both
  models' pools within TOL; the inactive lane's window writes nothing
  outside page 0. tiny-gemma adds the soft-caps and its 16-position
  window, which the lanes' histories pass.
- The engine in ragged x spec mode: greedy streams equal the JAX
  *bucketed* spec engine's and the JAX plain engine's (never the JAX
  ragged engine's: ROADMAP.md C.5), at lookahead depths 1 and 2, over
  fp32 and int8 KV, and with the prefix cache. The prompts arrive while
  other lanes speculate, so their ranges ride with verify windows.
- The gate and the switches: a truncated sampled lane without the
  prefilter takes the plain ragged dispatch; POLYKEY_DISABLE_RAGGED=1
  gives the bucketed spec engine.
- The widths: each gamma rung's stream is tile-aligned, and
  `_build_ragged_batch` fills no more than the narrowest rung's width.
- The steps-in-flight estimate behind the kernel's work list counts a
  spec round as gamma + 1 steps.
"""

import dataclasses
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polykey_tpu.engine import engine as jengine
from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu.engine import spec_decode as jsd
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine import engine as tengine
from polykey_tpu_torch.engine import kv_cache as tkv
from polykey_tpu_torch.engine import spec_decode as tsd
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.ops.ragged_paged_attention_kernel import TOKEN_TILE

torch.set_num_threads(2)

TOL = 2e-5          # pools: fp32 on both sides, another summation order
LOGIT_TOL = 1e-4    # window logits (tests/test_torch_ragged.py's)
LANES = ("last_tokens", "seq_lens", "page_tables", "active", "caps", "seeds",
         "temperature", "top_p", "top_k", "accept_ewma", "gamma_lane")


# -- ragged_spec_fn -------------------------------------------------------------


def _round_operands(cfg, rng):
    """4 lanes at gamma 3 over pages of 8, and a 16-row prefill stream:
    lanes 0-2 live (lane 1 two positions from its cap, lane 2 at dial 1),
    lane 3 inactive on the garbage page; slot 3's prompt sends its final
    8-token chunk (positions 8..15, KV 16) at rows 0..7, whose first token
    is sampled."""
    B, P, W = 4, 8, 16
    tables = np.zeros((B, P), np.int32)
    tables[:3] = 1 + np.arange(3 * P).reshape(3, P)          # pages 1..24
    lanes = dict(
        last_tokens=np.array([5, 17, 200, 0], np.int32),
        seq_lens=np.array([9, 20, 30, 0], np.int32),
        page_tables=tables, active=np.array([1, 1, 1, 0], bool),
        caps=np.array([60, 22, 60, 0], np.int32), seeds=np.zeros((B, 2), np.int32),
        temperature=np.zeros(B, np.float32), top_p=np.ones(B, np.float32),
        top_k=np.zeros(B, np.int32), accept_ewma=np.ones(B, np.float32),
        gamma_lane=np.array([3, 3, 1, 3], np.int32),
    )
    pre = list(tengine.ragged_zero_operands(B, W, P))
    pre[0][:8] = rng.integers(3, cfg.vocab_size, 8)
    pre[1][:8] = np.arange(8, 16)
    pre[2][:8] = 3
    pre[3][3, :2] = [25, 26]
    pre[4][0], pre[5][0], pre[6][0], pre[7][0] = 0, 8, 16, 3
    pre[8][3], pre[9][3] = 7, 16
    return lanes, pre


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma"])
def test_ragged_spec_fn_matches_jax(model, monkeypatch):
    jcfg = j_get_config(model)
    tp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    dp = jt.init_params(jax.random.PRNGKey(2), jcfg, jnp.float32)
    cfg = get_config(model)
    rng = np.random.default_rng(11)
    shape = (cfg.num_layers, 32, 8, cfg.num_kv_heads, cfg.head_dim)
    pools = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    lanes, pre = _round_operands(cfg, rng)
    kw = dict(gamma=3, eos_id=2, gamma_low=1, gamma_max=3, greedy=True)

    # Capture each side's verify windows' logits ([B, gamma + 1, V], the
    # one 3-D unembed of the round).
    logits = {}

    def spy(mod, side):
        real = mod.unembed

        def unembed(*a, **k):
            out = real(*a, **k)
            if out.ndim == 3:
                logits[side] = np.asarray(out)
            return out
        monkeypatch.setattr(mod, "unembed", unembed)

    spy(jsd, "jax")
    spy(tsd, "port")
    jpools = [jkv.init_paged_kv(jcfg, 32, 8, jnp.float32).replace(
        k=jnp.asarray(k), v=jnp.asarray(v)) for k, v in (pools[:2], pools[2:])]
    want = jsd.ragged_spec_fn(tp, dp, jcfg, jcfg, *jpools,
                              *(jnp.asarray(lanes[k]) for k in LANES),
                              *(jnp.asarray(a) for a in pre), **kw)
    tpools = [tkv.PagedKV(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
              for k, v in (pools[:2], pools[2:])]
    state = {k: torch.from_numpy(v.copy()) for k, v in lanes.items()}
    packed, first = tsd.ragged_spec_fn(
        params_from_numpy(jax.device_get(tp)), params_from_numpy(jax.device_get(dp)),
        cfg, cfg, *tpools, *state.values(), *(torch.from_numpy(a) for a in pre), **kw)

    np.testing.assert_array_equal(packed.numpy(), np.asarray(want[0]))
    assert (packed.numpy()[1, 2:4] == -1).all()         # lane 1 cut at its cap
    np.testing.assert_array_equal(first.numpy()[3], np.asarray(want[6])[3])
    for name, w in zip(("last_tokens", "seq_lens", "active", "accept_ewma",
                        "gamma_lane"), want[1:6]):
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(logits["port"][:3], logits["jax"][:3], atol=LOGIT_TOL,
                               rtol=0)
    # The pools: every page but the garbage page 0 (both sides write the
    # masked windows there), and pages no table names stay as they were.
    untouched = np.setdiff1d(np.arange(1, 32), np.r_[1:25, 25, 26])
    for got, wp, (k0, v0) in zip(tpools, want[7:], (pools[:2], pools[2:])):
        for g, w, before in ((got.k, wp.k, k0), (got.v, wp.v, v0)):
            np.testing.assert_allclose(g[:, 1:].numpy(), np.asarray(w)[:, 1:], atol=TOL,
                                       rtol=0)
            np.testing.assert_array_equal(g[:, untouched].numpy(), before[:, untouched])


# -- the engine -----------------------------------------------------------------


FIELDS = dict(
    model="tiny-llama", tokenizer="byte", dtype="float32", max_decode_slots=4,
    page_size=8, num_pages=64, max_seq_len=64, prefill_buckets=(16, 32),
    max_new_tokens_cap=32, default_max_new_tokens=8,
)
SPEC = dict(draft_model="tiny-llama", spec_gamma=3)
RAGGED = dict(ragged_dispatch=True)
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
# tests/test_engine_spec.py's mixed prompts: a 48-byte one past the largest
# bucket, prefilled in chunks while the other lanes speculate.
MIXED_PROMPTS = ["hi", "abcdefgh" * 6, "draft and verify", "q"]
HEADER = "spec shared header for the cache. "          # 4 pages of 8
CACHED = [HEADER + t for t in ("one", "two", "three!")]


def _collect(request, timeout=60.0):
    tokens = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            kind, value = request.out.get(timeout=deadline - time.monotonic())
        except queue.Empty:
            break
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens
        else:
            raise AssertionError(f"request failed: {value}")
    raise AssertionError("request timed out")


def _streams(engine, make, prompts, max_new=8, sequential=False, **extra):
    reqs = [make(prompt=p, max_new_tokens=max_new, **extra) for p in prompts]
    if sequential:
        out = []
        for r in reqs:
            engine.submit(r)
            out.append(_collect(r))
        return out
    for r in reqs:
        engine.submit(r)
    return [_collect(r) for r in reqs]


def _staggered(engine, prompts, max_new=8, **extra):
    """`prompts[0]` first; the rest once its first token is out, so their
    prefill ranges ride ragged dispatches beside its verify window."""
    reqs = [GenRequest(prompt=p, max_new_tokens=max_new, **extra) for p in prompts]
    engine.submit(reqs[0])
    kind, first = reqs[0].out.get(timeout=60)
    assert kind == "token", first
    for r in reqs[1:]:
        engine.submit(r)
    return [[first] + _collect(reqs[0])] + [_collect(r) for r in reqs[1:]]


@pytest.fixture(scope="module")
def weights():
    """(JAX target, JAX draft, port target, port draft): the JAX spec
    engine's weights at seed 0 and the draft it makes itself (seed + 2)."""
    cfg = j_get_config("tiny-llama")
    jp = jt.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    jd = jt.init_params(jax.random.PRNGKey(2), cfg, jnp.float32)
    return jp, jd, params_from_numpy(jax.device_get(jp)), params_from_numpy(
        jax.device_get(jd))


def _jax_streams(weights, prompts, spec=True, sequential=False, **fields):
    jp, jd = weights[:2]
    eng = JInferenceEngine(JEngineConfig(**{**FIELDS, **(SPEC if spec else {}),
                                            **JAX_ONLY, **fields}),
                           params=jp, draft_params=jd if spec else None)
    try:
        return _streams(eng, JGenRequest, prompts, sequential=sequential)
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def want(weights):
    """The JAX bucketed spec engine's and the JAX plain engine's greedy
    streams of MIXED_PROMPTS, over fp32 and int8 KV; they must agree."""
    out = {}
    for kv in ("", "int8"):
        out[kv] = _jax_streams(weights, MIXED_PROMPTS, kv_dtype=kv)
        assert out[kv] == _jax_streams(weights, MIXED_PROMPTS, spec=False, kv_dtype=kv)
    return out


@pytest.fixture
def port(weights):
    made = []

    def make(**fields):
        eng = InferenceEngine(EngineConfig(**{**FIELDS, **SPEC, **RAGGED, **fields}),
                              params=weights[2], draft_params=weights[3], device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown()


@pytest.mark.parametrize("kv,depth", [("", 1), ("", 2), ("int8", 1), ("int8", 2)],
                         ids=["fp32-d1", "fp32-d2", "int8-d1", "int8-d2"])
def test_ragged_spec_greedy_matches_jax_bucketed_spec_and_plain(port, want, monkeypatch,
                                                                 kv, depth):
    """THE acceptance bar: prompts admitted while a lane speculates ride
    ragged spec dispatches with its verify window, and every greedy stream
    is the target's chain, the JAX bucketed spec engine's and the JAX plain
    engine's; pure-decode iterations go out as the bucketed round."""
    monkeypatch.setenv("POLYKEY_DISPATCH_LOOKAHEAD", str(depth))
    eng = port(kv_dtype=kv)
    assert eng._ragged and eng._spec
    assert _staggered(eng, MIXED_PROMPTS) == want[kv]
    st = eng.stats()
    assert st["ragged_spec_dispatches"] > 0 and st["ragged_spec_verify_lanes"] > 0
    assert st["ragged_dispatches"] == st["ragged_spec_dispatches"]
    assert st["spec_eager"] > 0 and st["drafts_proposed"] > 0
    assert st["lookahead_depth"] == depth


def test_ragged_spec_prefix_cache_matches_jax(port, weights):
    """With the prefix cache: a hit's suffix rides the ragged spec stream
    from the cached offset beside a live lane; the streams are the JAX
    bucketed spec engine's."""
    ref = _jax_streams(weights, CACHED, sequential=True)
    eng = port(prefix_cache=True)
    got = _streams(eng, GenRequest, CACHED[:1])
    got += _staggered(eng, CACHED[1:])
    assert got == ref
    st = eng.stats()
    assert st["prefix_hit_tokens"] > 0 and st["ragged_spec_verify_lanes"] > 0


def test_ragged_spec_gate_off_takes_the_plain_ragged_dispatch(port):
    """A sampled top_p < 1 lane without the prefilter turns the round's
    gate off: the next prompt's ranges go out on the plain ragged dispatch
    (the draft misses them; acceptance drops, never correctness), and every
    stream completes."""
    eng = port()
    outs = _staggered(eng, ["sampled lane", "late prompt"], max_new=12,
                      temperature=0.8, top_p=0.9, seed=3)
    assert all(len(t) == 12 for t in outs)
    st = eng.stats()
    assert st["ragged_dispatches"] > st["ragged_spec_dispatches"]
    assert st["requests_failed"] == 0


def test_ragged_spec_sampled_is_reproducible(port):
    """Sampled lanes speculate on the ragged stream too (the prefilter keeps
    the gate on): a seeded run gives the same streams again."""
    runs = [_staggered(port(top_p_candidates=32), MIXED_PROMPTS, temperature=0.8,
                       top_p=0.9, seed=17) for _ in range(2)]
    assert runs[0] == runs[1] and all(len(t) == 8 for t in runs[0])


def test_disable_ragged_serves_the_bucketed_spec_engine(port, want, monkeypatch):
    monkeypatch.setenv("POLYKEY_DISABLE_RAGGED", "1")
    eng = port()
    assert eng._spec and not eng._ragged and "ragged_dispatches" not in eng.stats()
    assert _streams(eng, GenRequest, MIXED_PROMPTS) == want[""]
    assert eng.stats()["drafts_proposed"] > 0


def test_ragged_spec_widths_and_the_batch_cap(port):
    """Each rung's stream (B (g + 1) verify rows + W) is a multiple of
    TOKEN_TILE with W at least the budget; `_build_ragged_batch` fills no
    more than the narrowest rung's width, though the plain stream is
    wider."""
    eng = port()
    eng.shutdown()
    B = eng.config.max_decode_slots
    widths = eng._ragged_spec_width
    assert sorted(widths) == [eng._gamma_low, eng._gamma_max] == [1, 3]
    for g, w in widths.items():
        assert (B * (g + 1) + w) % TOKEN_TILE == 0 and w >= eng._prefill_budget
    assert (B + eng._ragged_width) % TOKEN_TILE == 0
    assert min(widths.values()) < eng._ragged_width
    for i in range(3):
        ids = np.arange(3, 33, dtype=np.int32)                     # 30 tokens
        eng._slots[i] = tengine._Slot(
            request=GenRequest(prompt="x"), pages=[], table=np.zeros(8, np.int32),
            seed_row=np.zeros(2, np.int32), prompt_len=30, position_cap=40,
            pending=ids)
    ranges = eng._build_ragged_batch()
    assert sum(take for *_, take in ranges) == min(widths.values())
    assert [take for *_, take in ranges] == [30, 30, min(widths.values()) - 60]


def test_steps_in_flight_count_a_spec_round_as_gamma_plus_one(port, monkeypatch):
    """A decode block counts K, a ragged dispatch 1, a spec round gamma + 1
    (its packed matrix's emit columns); the work list's key counts are the
    host lengths plus those steps, capped at the caps, plus the window."""
    eng = port()
    eng.shutdown()
    B = eng.config.max_decode_slots
    # A round at each rung (gamma 1 and 3): 2 and 4 steps, whatever B is.
    for shape, kind in (((8, B), "decode"), ((1, B), "decode"),
                        ((B, 2 + tsd.SPEC_STAT_COLS), "spec"),
                        ((B, 4 + tsd.SPEC_STAT_COLS), "spec")):
        eng._inflight_q.append(tengine._InflightBlock(
            torch.zeros(shape, dtype=torch.int32), None, [None] * B, 0, kind))
    assert eng._steps_in_flight() == 8 + 1 + 2 + 4
    eng._active[:] = [True, True, False, False]
    eng._seq_lens[:] = [10, 30, 5, 0]
    eng._caps[:] = [40, 35, 9, 0]
    seen = []
    monkeypatch.setattr(tengine, "ragged_work",
                        lambda starts, lens, kvs, *a: seen.append((starts, lens, kvs)))
    ops = tengine.ragged_zero_operands(B, 64, 8)
    eng._ragged_work_lists(ops, 64, 4, (eng.model_cfg, eng.draft_cfg))
    assert len(seen) == 2
    starts, lens, kvs = seen[0]
    assert starts[:B].tolist() == [0, 4, 8, 12] and lens[:B].tolist() == [4] * B
    # min(seq + 15, cap) for live lanes, the host length otherwise, then
    # max(., 1) + gamma.
    assert kvs[:B].tolist() == [25 + 3, 35 + 3, 5 + 3, 1 + 3]
    eng._inflight_q.clear()


def test_config_validates_ragged_with_a_draft():
    EngineConfig(**FIELDS, **SPEC, **RAGGED).validate()
    EngineConfig(**FIELDS, **SPEC, **RAGGED, kv_dtype="int8",
                 top_p_candidates=16).validate()
