"""The port's lazy first token and in-flight ragged dispatch on the CPU (the
reference's `_resolve_prefills`, `_resolve_slot` and `_dispatch_ragged`).

The engines are tests/test_torch_pipeline.py's (tiny-llama, float32, page
size 8, buckets (16, 32), 4 slots). On the CPU a prefill runs in the call
and there is no CUDA event, so a first token is ready at once; to stand
for a card whose copies land late, some tests give each copy a
`_LateEvent` that reports "not landed" to its first queries, which holds
first tokens and blocks back until a block's processing or an idle
iteration waits for them. Greedy streams are compared with the same
prompts served alone on a plain engine, whose streams
tests/test_torch_pipeline.py holds to the JAX engine's.
"""

import queue
import time

import pytest
import torch

from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.transformer import init_params

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


def _drained(engine, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not engine._inflight_q and not engine.busy:
            return True
        time.sleep(0.01)
    return False


class _LateEvent:
    """A copy's event that reports "not landed" to its first `late`
    queries; `synchronize` (a blocking read) always succeeds, and is noted
    in `log` as ("sync", what) when a log is given."""

    def __init__(self, late: int, what: str, log):
        self.late, self.what, self.log = late, what, log

    def query(self) -> bool:
        self.late -= 1
        return self.late < 0

    def synchronize(self) -> None:
        self.late = 0
        if self.log is not None:
            self.log.append(("sync", self.what))


def _late_copies(engine, late: int = 3, log=None) -> None:
    """Give every copy to host memory an event that lands late: a decode
    block's [K, B] tokens ("block") and first-token vectors ("first"; a
    ragged dispatch copies both as one)."""
    engine._copy_to_host = lambda t: (
        t.clone(), _LateEvent(late, "block" if t.dim() == 2 else "first", log))


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(0)
    return init_params(get_config("tiny-llama"), torch.float32, "cpu", gen)


@pytest.fixture
def port(params):
    made = []

    def make(**extra):
        eng = InferenceEngine(EngineConfig(**{**FIELDS, **extra}), params=params,
                              device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown()


@pytest.fixture(scope="module")
def solo(params):
    """Each prompt's greedy stream served alone, synchronously."""
    eng = InferenceEngine(EngineConfig(**FIELDS, lookahead_blocks=1), params=params,
                          device="cpu")
    cache = {}

    def stream(prompt, max_new):
        if (prompt, max_new) not in cache:
            r = GenRequest(prompt=prompt, max_new_tokens=max_new)
            eng.submit(r)
            tokens, done, error = _collect(r)
            assert error is None and done is not None, error
            cache[(prompt, max_new)] = tokens
        return cache[(prompt, max_new)]

    yield stream
    eng.shutdown()


def _trace(engine, log: list) -> None:
    """Record, on the engine thread, each prefill group dispatch, each block
    dispatch and each first-token delivery in `log`."""
    group, step, resolve = (engine._dispatch_prefill_group, engine._dispatch_step,
                            engine._resolve_slot)

    def traced_group(bucket, slots):
        log.append(("prefill", tuple(slots)))
        group(bucket, slots)

    def traced_step():
        block = step()
        if block is not None:
            log.append(("dispatch", block.seq))
        return block

    def traced_resolve(i):
        log.append(("resolve", i))
        resolve(i)

    engine._dispatch_prefill_group = traced_group
    engine._dispatch_step = traced_step
    engine._resolve_slot = traced_resolve


@pytest.mark.parametrize("depth", [1, 2])
def test_first_token_is_read_after_the_next_dispatch_at_depth_2(port, depth):
    """Depth 2 reads an admission's first token only after the next block's
    dispatch (its prefill overlaps that block); depth 1 reads it at once,
    before any other dispatch."""
    eng = port(lookahead_blocks=depth)
    log: list = []
    _trace(eng, log)
    first = GenRequest(prompt="an earlier stream", max_new_tokens=20)
    eng.submit(first)
    first.out.get(timeout=30)         # its lane decodes from here on
    second = GenRequest(prompt="hello", max_new_tokens=6)
    eng.submit(second)
    assert _collect(second)[2] is None and _collect(first)[2] is None
    assert _drained(eng)
    for i, (kind, slots) in enumerate(log):
        if kind != "prefill":
            continue
        slot = slots[0]
        after = log[i + 1:]
        read = after.index(("resolve", slot))
        dispatches = [e for e in after[:read] if e[0] == "dispatch"]
        if depth == 2:
            assert dispatches, f"read before the next dispatch: {log}"
        else:
            assert not dispatches, f"depth 1 deferred the read: {log}"
    assert sum(e[0] == "prefill" for e in log) == 2


def test_first_token_precedes_the_slots_block_tokens(port, solo):
    """With copies that never report landing, the loop's own resolve never
    sees a first token land: the processing of the first block dispatched
    after the merge delivers it, before it waits for that block, and so
    before that block's tokens. Every stream is its solo stream."""
    eng = port(lookahead_blocks=2)
    log: list = []
    _late_copies(eng, late=10**9, log=log)
    _trace(eng, log)
    process = eng._process_step

    def traced_process(block):
        log.append(("process", block.seq))
        process(block)
        log.append(("processed", block.seq))

    eng._process_step = traced_process
    specs = [("hello", 10), ("a prompt for the 32 bucket", 9), ("short one", 12)]
    reqs = [GenRequest(prompt=p, max_new_tokens=n) for p, n in specs]
    for r in reqs:
        eng.submit(r)
    for r, (p, n) in zip(reqs, specs):
        tokens, done, error = _collect(r)
        assert error is None and tokens == solo(p, n)
        assert done.completion_tokens == n
        assert done.first_token > 0
    assert _drained(eng)
    resolves = [i for i, e in enumerate(log) if e[0] == "resolve"]
    assert len(resolves) == len(specs)
    for i in resolves:            # inside a block's processing, before its wait
        opened = max(j for j in range(i) if log[j][0] in ("process", "processed"))
        assert log[opened][0] == "process", log
        assert ("sync", "block") not in log[opened:i], log


def test_eos_first_token_finishes_at_resolve(port, solo):
    """A first token that is EOS finishes its request at the resolve: one
    token, done, and no block token after it."""
    eng = port(lookahead_blocks=2)
    _late_copies(eng)
    (eos,) = solo("hello", 1)
    eng.tokenizer.eos_id = eos
    r = GenRequest(prompt="hello", max_new_tokens=10)
    eng.submit(r)
    tokens, done, error = _collect(r)
    assert error is None and tokens == [eos] and done.completion_tokens == 1
    assert _drained(eng)
    assert eng.allocator.num_free == FIELDS["num_pages"] - 1


@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_one_token_budget_finishes_at_resolve(port, solo, mode):
    """max_new_tokens=1: the lane is born stopped on the device, and the
    request finishes where its first token is delivered."""
    eng = port(lookahead_blocks=2, ragged_dispatch=mode == "ragged")
    _late_copies(eng)
    finished_at = []
    resolve = eng._resolve_slot

    def traced_resolve(i):
        resolve(i)
        finished_at.append(eng._slots[i] is None)

    eng._resolve_slot = traced_resolve
    r = GenRequest(prompt="short one", max_new_tokens=1)
    eng.submit(r)
    tokens, done, error = _collect(r)
    assert error is None and tokens == solo("short one", 1)
    assert done.completion_tokens == 1 and finished_at == [True]
    assert _drained(eng)


def test_cancel_before_the_first_token_never_leaks_to_the_readmitted_slot(port, solo):
    """One slot, copies landing late: A is cancelled right after its lane
    merged, with its first token undelivered; B, queued behind it, takes
    the slot. A gets no token and the error; B's stream is its solo
    stream, its first token B's own; no page leaks."""
    eng = port(max_decode_slots=1, lookahead_blocks=4)
    _late_copies(eng, late=5)
    a = GenRequest(prompt="cancel me", max_new_tokens=30)
    b = GenRequest(prompt="then me", max_new_tokens=8)
    merge = eng._merge_slot
    merged = []

    def cancelling_merge(i, *args):
        merge(i, *args)
        merged.append(eng._slots[i].request)
        if merged[-1] is a:
            a.cancelled.set()

    eng._merge_slot = cancelling_merge
    eng.submit(a)
    eng.submit(b)
    tokens_a, done_a, error_a = _collect(a)
    tokens_b, done_b, error_b = _collect(b)
    assert error_a == "cancelled" and done_a is None and tokens_a == []
    assert merged == [a, b]
    assert error_b is None and tokens_b == solo("then me", 8)
    assert _drained(eng)
    assert eng.allocator.num_free == FIELDS["num_pages"] - 1
    assert eng.stats()["first_tokens_pending"] == 0


def test_ragged_dispatch_leaves_the_block_ahead_in_flight(port, solo):
    """Ragged mode at depth 2: a prompt admitted while another stream
    decodes goes out as a ragged dispatch with that stream's block still in
    flight (nothing is drained first), and returns as an in-flight block
    itself. Both streams are their solo streams."""
    eng = port(lookahead_blocks=2, ragged_dispatch=True)
    inflight_at_ragged = []
    dispatch = eng._dispatch_ragged

    def traced(ranges):
        inflight_at_ragged.append(len(eng._inflight_q))
        block = dispatch(ranges)
        assert block is not None and block.host.shape == (1, FIELDS["max_decode_slots"])
        return block

    eng._dispatch_ragged = traced
    first = GenRequest(prompt="an earlier stream", max_new_tokens=20)
    eng.submit(first)
    first.out.get(timeout=30)
    second = GenRequest(prompt="x" * 45, max_new_tokens=6)   # two ranges
    eng.submit(second)
    tokens_1, _, error_1 = _collect(first)
    tokens_2, _, error_2 = _collect(second)
    assert error_1 is None and error_2 is None
    assert tokens_2 == solo("x" * 45, 6)
    assert tokens_1 == solo("an earlier stream", 20)[1:]
    assert _drained(eng)
    stats = eng.stats()
    assert len(inflight_at_ragged) >= 3
    assert all(n >= 1 for n in inflight_at_ragged[1:]), inflight_at_ragged
    assert stats["ragged_behind_inflight"] == len(inflight_at_ragged) - 1
    assert stats["ragged_dispatches"] == len(inflight_at_ragged)
    assert stats["blocks_processed"] == eng._dispatch_seq


def test_same_shape_groups_back_to_back_get_their_own_tokens(port, solo):
    """Two bucket-32 prompts admitted one per iteration (the budget is one
    chunk while a stream decodes), so two (32, 1) prefills go out back to
    back, the second while the first's first token is still on its way:
    each request gets its own tokens."""
    eng = port(lookahead_blocks=2, prefill_budget=32)
    _late_copies(eng, late=10**9)
    pending_at_second = []
    group = eng._dispatch_prefill_group

    def traced(bucket, slots):
        pending_at_second.append(eng.stats()["first_tokens_pending"])
        group(bucket, slots)

    eng._dispatch_prefill_group = traced
    first = GenRequest(prompt="an earlier stream", max_new_tokens=24)
    eng.submit(first)
    first.out.get(timeout=30)
    specs = [("a prompt for the 32 bucket", 7), ("another longer prompt!", 9)]
    reqs = [GenRequest(prompt=p, max_new_tokens=n) for p, n in specs]
    for r in reqs:
        eng.submit(r)
    for r, (p, n) in zip(reqs, specs):
        tokens, _, error = _collect(r)
        assert error is None and tokens == solo(p, n)
    assert _collect(first)[2] is None
    assert _drained(eng)
    assert len(pending_at_second) == 3 and pending_at_second[2] >= 1, pending_at_second
