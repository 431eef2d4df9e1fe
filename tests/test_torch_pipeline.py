"""The port's lookahead pipeline and adaptive block on the CPU, against the
JAX engine (tests/test_dispatch_pipeline.py's checks, on the port).

Both packages serve tests/test_torch_engine.py's fields (tiny-llama,
float32, page size 8, buckets (16, 32), decode block 8, so a lone stream's
adaptive block is 1 step) with the same weights. Greedy streams must be
token-identical to the JAX bucketed engine's at every depth, with the
adaptive block on and off, in the bucketed and ragged modes and over int8
KV. Where the JAX tests read the engine's timeline ring, these read the
metrics and `stats()`: the observed lookahead of every processed block
(blocks with one or more are `blocks_overlapped`), the depth and its
in-flight target. On the CPU a block runs in the call and its copy has
landed at once, so depth 2 keeps exactly the freshest block in flight.
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
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
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
# Five prompts on four slots (one waits for a slot while blocks are in
# flight), both buckets, and a 45-byte prompt past the largest bucket
# (chunked prefill when bucketed, ranges when ragged).
GREEDY = [
    dict(prompt="hello", max_new_tokens=12),
    dict(prompt="short one", max_new_tokens=9),
    dict(prompt="a prompt for the 32 bucket", max_new_tokens=12),
    dict(prompt="x" * 45, max_new_tokens=6),
    dict(prompt="another longer prompt!", max_new_tokens=14),
]
MODES = {
    "bucketed": dict(),
    "ragged": dict(ragged_dispatch=True),
    "int8": dict(kv_dtype="int8"),
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


def _streams(engine, make, specs):
    requests = [make(**s) for s in specs]
    for r in requests:
        engine.submit(r)
    outs = []
    for r in requests:
        tokens, done, error = _collect(r)
        assert error is None and done is not None, error
        outs.append(tokens)
    return outs


def _drained(engine, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not engine._inflight_q and not engine.busy:
            return True
        time.sleep(0.01)
    return False


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                          jax.numpy.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.device_get(jax_params))


@pytest.fixture(scope="module")
def want(jax_params):
    """The JAX bucketed engine's greedy streams over float32 and int8 KV."""
    out = {}
    for kv in ("", "int8"):
        eng = JInferenceEngine(JEngineConfig(**FIELDS, **JAX_ONLY, kv_dtype=kv),
                               params=jax_params)
        try:
            out[kv] = _streams(eng, JGenRequest, GREEDY)
        finally:
            eng.shutdown()
    return out


@pytest.fixture
def port(torch_params):
    """Port engines on the CPU over the JAX weights, shut down after."""
    made = []

    def make(**extra):
        eng = InferenceEngine(EngineConfig(**{**FIELDS, **extra}),
                              params=torch_params, device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown()


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "static"])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_streams_match_jax_at_every_depth(port, want, mode, depth, adaptive):
    """The pipeline and the block size are scheduling, not numerics: the
    JAX bucketed engine's tokens at depths 1, 2 and 4, adaptive block on
    and off (the ragged mode against the JAX bucketed streams)."""
    eng = port(lookahead_blocks=depth, adaptive_block=adaptive, **MODES[mode])
    got = _streams(eng, GenRequest, GREEDY)
    assert got == want["int8" if mode == "int8" else ""]
    assert _drained(eng)
    stats = eng.stats()
    assert stats["lookahead_depth"] == depth and stats["inflight_blocks"] == 0
    assert stats["blocks_processed"] == eng._dispatch_seq
    if depth == 1:
        assert stats["blocks_overlapped"] == 0


def _burst(eng, n=3, max_new=24):
    return _streams(eng, GenRequest, [
        dict(prompt=f"pipeline probe {i}", max_new_tokens=max_new) for i in range(n)])


def test_depth2_dispatch_runs_ahead_of_process(port):
    """Under steady decode at depth 2 block N + 1 is dispatched before
    block N is read: most processed blocks saw one or more newer blocks
    dispatched first; only the drain at the end of a burst reads at 0."""
    eng = port(lookahead_blocks=2)
    _burst(eng)
    assert _drained(eng)
    m = eng.metrics
    assert m.blocks_processed >= 3
    assert m.blocks_overlapped >= 1 and m.lookahead_max >= 1
    assert m.blocks_overlapped >= m.blocks_processed // 2, (
        f"{m.blocks_overlapped} of {m.blocks_processed} blocks overlapped")
    stats = eng.stats()
    assert stats["lookahead_depth"] == 2
    assert stats["lookahead_observed_max"] >= 1
    assert "host_stall_ms_p50" in stats


def test_depth1_is_exactly_synchronous(port):
    """Depth 1 dispatches, then reads: every block at observed lookahead 0."""
    eng = port(lookahead_blocks=1)
    _burst(eng)
    assert _drained(eng)
    m = eng.metrics
    assert m.blocks_processed >= 3
    assert m.blocks_overlapped == 0 and m.lookahead_max == 0
    assert eng.stats()["lookahead_depth"] == 1


def test_env_sets_the_depth_and_the_adaptive_block(port, monkeypatch):
    """POLYKEY_DISPATCH_LOOKAHEAD overrides the config depth however the
    config was built (and wins over POLYKEY_LOOKAHEAD in from_env);
    POLYKEY_ADAPTIVE_BLOCK=0 pins the static block, default on."""
    monkeypatch.setenv("POLYKEY_DISPATCH_LOOKAHEAD", "1")
    eng = port(lookahead_blocks=2)
    assert eng._depth == 1 and eng.stats()["lookahead_depth"] == 1
    _burst(eng, n=2, max_new=12)
    assert _drained(eng)
    assert eng.metrics.blocks_processed > 0 and eng.metrics.blocks_overlapped == 0
    monkeypatch.setenv("POLYKEY_LOOKAHEAD", "3")
    assert EngineConfig.from_env().lookahead_blocks == 1
    monkeypatch.delenv("POLYKEY_DISPATCH_LOOKAHEAD")
    assert EngineConfig.from_env().lookahead_blocks == 3
    monkeypatch.delenv("POLYKEY_LOOKAHEAD")
    assert EngineConfig.from_env().lookahead_blocks == 2
    assert EngineConfig.from_env().adaptive_block is True
    monkeypatch.setenv("POLYKEY_ADAPTIVE_BLOCK", "0")
    assert EngineConfig.from_env().adaptive_block is False
    with pytest.raises(ValueError, match="lookahead_blocks"):
        dataclasses.replace(EngineConfig(**FIELDS), lookahead_blocks=0).validate()


@pytest.mark.parametrize("depth, deepest", [(1, 1), (2, 9)])
def test_depth1_never_deepens_under_adaptive_blocking(port, depth, deepest):
    """A lone stream takes 1-step blocks and the lookahead portion deepens
    by K / steps = 8 (depth 2: a target of 1 + 8 = 9), but depth 1 stays at
    1 through the whole solo run."""
    eng = port(lookahead_blocks=depth)
    targets, steps = [], []
    dispatch = eng._dispatch_step

    def recording_dispatch():
        block = dispatch()
        targets.append(eng._depth_target)
        steps.append(block.host.shape[0])
        return block

    eng._dispatch_step = recording_dispatch
    (tokens,) = _streams(eng, GenRequest, [dict(prompt="solo adaptive", max_new_tokens=24)])
    assert _drained(eng) and len(tokens) == 24
    assert set(steps) == {1}
    assert max(targets) == deepest and eng._depth_target <= deepest


def test_pipeline_drains_idle_and_complete(port):
    """Every dispatched block is processed once the engine goes idle."""
    eng = port(lookahead_blocks=4)
    for _ in range(2):
        _burst(eng, n=2, max_new=8)
        assert _drained(eng)
        assert len(eng._inflight_q) == 0
        assert eng.metrics.blocks_processed == eng._dispatch_seq > 0


class _Hooked(queue.Queue):
    """An out-queue that calls `hook(n)` as the engine delivers the n-th
    token (on the engine thread, where the pipeline's state is exact)."""

    def __init__(self, hook):
        super().__init__()
        self.hook = hook
        self.count = 0

    def put(self, item, *args, **kwargs):
        super().put(item, *args, **kwargs)
        if item[0] == "token":
            self.count += 1
            self.hook(self.count)


def test_cancel_in_flight_never_leaks_to_the_readmitted_slot(port):
    """One slot, depth 4: A is cancelled at its third token while its next
    block is in flight; B, queued behind it, takes the slot at once, with
    A's stale block still in flight. B's stream is its solo stream: the
    stale lane's tokens never reach it."""
    one = dict(max_decode_slots=1, lookahead_blocks=4)
    (want_b,) = _streams(port(**one), GenRequest, [dict(prompt="then me", max_new_tokens=8)])
    eng = port(**one)
    seen = {}

    def cancel_a(n):
        if n == 3:
            seen["a"] = len(eng._inflight_q)
            a.cancelled.set()

    def note_b(n):
        if n == 1:
            seen["b"] = len(eng._inflight_q)

    a = GenRequest(prompt="cancel me", max_new_tokens=30, out=_Hooked(cancel_a))
    b = GenRequest(prompt="then me", max_new_tokens=8, out=_Hooked(note_b))
    eng.submit(a)
    eng.submit(b)
    tokens_a, done_a, error_a = _collect(a)
    tokens_b, done_b, error_b = _collect(b)
    assert error_a == "cancelled" and done_a is None and len(tokens_a) == 3
    assert error_b is None and tokens_b == want_b
    assert seen["a"] >= 1, "A was cancelled with no block in flight"
    assert seen["b"] >= 1, "B was admitted with no stale block in flight"
    assert _drained(eng)
    assert eng.allocator.num_free == FIELDS["num_pages"] - 1


@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_lane_buffers_keep_their_addresses(port, mode):
    """Every writer of the lane state copies into the buffers the decode
    graphs capture: blocks, ragged dispatches, merges and retires."""
    eng = port(**MODES[mode])
    ptrs = {k: t.data_ptr() for k, t in eng._dev.items()}
    _streams(eng, GenRequest, GREEDY)
    assert _drained(eng)
    assert {k: t.data_ptr() for k, t in eng._dev.items()} == ptrs
    assert eng.stats()["blocks_dispatched"] > 0


def test_set_lookahead_clamps_and_governs_the_next_dispatch(port):
    eng = port()
    assert eng.stats()["lookahead_depth"] == 2
    assert eng.set_lookahead(0) == 1 and eng.set_lookahead(100) == 64
    assert eng.set_lookahead(3) == 3 and eng.stats()["lookahead_depth"] == 3
    _burst(eng, n=2)
    assert _drained(eng) and eng.metrics.blocks_overlapped > 0
    # CPU engines capture nothing: the block runs eagerly in the call.
    stats = eng.stats()
    assert stats["decode_graph_captures"] == stats["decode_graph_replays"] == 0
