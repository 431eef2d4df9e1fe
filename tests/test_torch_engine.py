"""The port's InferenceEngine on the CPU against the JAX package's.

Both engines serve the fields of tests/test_engine.py's TEST_CONFIG
(tiny-llama, float32, page size 8, buckets (16, 32)), copied here so this
module does not import another test module, with the same weights: the JAX
init_params tree, carried into the port by params_from_numpy. Greedy
streams must be token-identical, whatever the batch they ride in.
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
TEST_CONFIG = EngineConfig(**FIELDS)

# Two prompts per bucket: <= 15 bytes land in bucket 16, the rest in 32.
PROMPTS = ["hello", "short one", "a prompt for the 32 bucket", "another longer prompt!"]


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                          jax.numpy.float32)


@pytest.fixture(scope="module")
def engines(jax_params):
    jeng = JInferenceEngine(JEngineConfig(**FIELDS), params=jax_params)
    teng = InferenceEngine(TEST_CONFIG, params=params_from_numpy(
        jax.device_get(jax_params)), device="cpu")
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


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


def _run(engine, make, prompts, **kw):
    reqs = [make(prompt=p, **kw) for p in prompts]
    for r in reqs:
        engine.submit(r)
    return [_collect(r) for r in reqs]


def test_greedy_streams_match_the_reference(engines):
    """Four concurrent prompts over both buckets: the same tokens."""
    jeng, teng = engines
    want = _run(jeng, JGenRequest, PROMPTS, max_new_tokens=12)
    got = _run(teng, GenRequest, PROMPTS, max_new_tokens=12)
    for (jt_, jd, je), (tt_, td, te) in zip(want, got):
        assert je is None and te is None
        assert tt_ == jt_ and len(tt_) == 12
        assert td.prompt_tokens == jd.prompt_tokens
        assert td.completion_tokens == 12 and td.ttft_ms > 0


def test_batched_greedy_matches_solo(engines):
    _, teng = engines
    solo = [_run(teng, GenRequest, [p], max_new_tokens=6)[0][0] for p in PROMPTS[:2]]
    crowded = _run(teng, GenRequest, PROMPTS, max_new_tokens=6)
    assert [c[0] for c in crowded[:2]] == solo


def test_max_new_tokens_and_pages_return(engines):
    _, teng = engines
    (tokens, done, error), = _run(teng, GenRequest, ["hello"], max_new_tokens=5)
    assert error is None and len(tokens) == done.completion_tokens == 5
    assert teng.allocator.num_free == TEST_CONFIG.num_pages - 1


def test_seeded_sampling_reproducible(engines):
    _, teng = engines
    kw = dict(max_new_tokens=8, temperature=0.9, top_p=0.9, top_k=20, seed=1234)
    a = _run(teng, GenRequest, ["hello"], **kw)[0][0]
    b = _run(teng, GenRequest, ["hello", "short one", "third"], **kw)[0][0]
    assert a == b


class _CancelAtFirstToken(queue.Queue):
    """An out-queue that cancels its request as the engine delivers the
    first token, so the cancel lands at a known point of the stream."""

    request = None

    def put(self, item, *args, **kwargs):
        super().put(item, *args, **kwargs)
        if item[0] == "token":
            self.request.cancelled.set()


def test_cancel_frees_the_slot(engines):
    _, teng = engines
    out = _CancelAtFirstToken()
    request = GenRequest(prompt="cancel me", max_new_tokens=30, out=out)
    out.request = request
    teng.submit(request)
    tokens, done, error = _collect(request)
    assert error == "cancelled" and done is None and len(tokens) == 1
    deadline = time.monotonic() + 10
    while teng.busy and time.monotonic() < deadline:
        time.sleep(0.01)
    assert teng.allocator.num_free == TEST_CONFIG.num_pages - 1


def test_prompt_longer_than_the_largest_bucket_errors(engines):
    """A 45-byte prompt, past the largest bucket (32), no longer errors:
    it is served through chunked prefill with the JAX engine's tokens."""
    jeng, teng = engines
    want = _run(jeng, JGenRequest, ["x" * 45], max_new_tokens=4)
    (tokens, done, error), = _run(teng, GenRequest, ["x" * 45], max_new_tokens=4)
    assert error is None and done is not None
    assert tokens == want[0][0] and len(tokens) == 4
    assert done.prompt_tokens == want[0][1].prompt_tokens


def test_stats_report_kernel_launches(engines):
    _, teng = engines
    stats = teng.stats()
    assert stats["device"] == "cpu" and stats["slots_total"] == 4
    assert set(stats["kernel_launches"]) == {
        "flash_attention", "paged_attention_decode", "paged_write",
        "ragged_paged_attention", "paged_attention_decode_int8",
        "paged_write_int8", "ragged_paged_attention_int8"}
    assert stats["kv_dtype"] == "float32"
    assert stats["requests_completed"] >= 1


def test_unported_knobs_refuse_to_start():
    for knob in (dict(pp=2), dict(spec_host_sync=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            dataclasses.replace(TEST_CONFIG, **knob).validate()
    # Serving over a mesh is ported (engine/lockstep.py); the engine checks
    # its geometry against the process group.
    dataclasses.replace(TEST_CONFIG, tp=2, dp=2, sp=2).validate()
    # The disaggregated pool is served now (engine/disagg_pool.py).
    dataclasses.replace(TEST_CONFIG, disagg="1x1").validate()
    # The replica pool is served now (engine/replica_pool.py).
    dataclasses.replace(TEST_CONFIG, replicas=2).validate()
    # Speculation rides the ragged stream now (engine/spec_decode.py,
    # ragged_spec_fn).
    dataclasses.replace(TEST_CONFIG, draft_model="tiny-llama",
                        ragged_dispatch=True).validate()
    # Checkpoints are loaded now (models/loader.py), the target's and the
    # draft's.
    dataclasses.replace(TEST_CONFIG, checkpoint_path="ckpt").validate()
    dataclasses.replace(TEST_CONFIG, draft_model="tiny-llama",
                        draft_checkpoint_path="ckpt").validate()
    # Weight-only int8/int4 is served now, and validates its bit width as
    # the reference's does.
    dataclasses.replace(TEST_CONFIG, quantize=True, quantize_bits=4).validate()
    with pytest.raises(ValueError, match="quantize_bits"):
        dataclasses.replace(TEST_CONFIG, quantize=True, quantize_bits=3).validate()
    # Speculative decoding and the top-p prefilter are served now
    # (bucketed; ragged rounds are still refused, above).
    dataclasses.replace(TEST_CONFIG, draft_model="tiny-llama", top_p_candidates=32).validate()
    # The prefix cache and the host tier are served now, and validate as
    # the reference's: the tier needs the cache.
    dataclasses.replace(TEST_CONFIG, prefix_cache=True, host_kv_bytes=1 << 20,
                        kv_state_dir="state").validate()
    with pytest.raises(ValueError, match="requires prefix_cache"):
        dataclasses.replace(TEST_CONFIG, host_kv_bytes=1 << 20).validate()


def test_pipeline_knobs_validate_with_the_reference_defaults():
    """The lookahead pipeline and the adaptive block are served: both
    validate, and the defaults are the JAX EngineConfig's."""
    dataclasses.replace(TEST_CONFIG, lookahead_blocks=2, adaptive_block=True).validate()
    with pytest.raises(ValueError, match="lookahead_blocks"):
        dataclasses.replace(TEST_CONFIG, lookahead_blocks=0).validate()
    port, ref = EngineConfig(), JEngineConfig()
    for name in ("decode_block_steps", "adaptive_block", "lookahead_blocks"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.lookahead_blocks == 2 and port.adaptive_block is True


def test_default_device_is_the_gpu(monkeypatch):
    """Without CUDA the engine refuses to start unless the CPU is asked
    for; POLYKEY_DEVICE=cpu asks for it."""
    monkeypatch.delenv("POLYKEY_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="POLYKEY_DEVICE=cpu"):
        InferenceEngine(TEST_CONFIG)
    monkeypatch.setenv("POLYKEY_DEVICE", "cpu")
    eng = InferenceEngine(TEST_CONFIG)
    try:
        assert eng.device.type == "cpu"
    finally:
        eng.shutdown()
