"""The port's fault injector (polykey_tpu_torch/faults.py) against the JAX
package's: every spec of the grammar parses to the same entries, fires in
the same order for the same callers and fails the same way; the
module-shared injector keeps a spent budget (`@N`) across an engine
restart."""

import numpy as np
import pytest
import torch

from polykey_tpu import faults as jfaults
from polykey_tpu_torch import faults
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import InferenceEngine

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_injectors(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


SPECS = [
    "step-stall",
    "step-stall=2.5@1",
    "slow-step=0.01@3",
    "step-stall=2.5@1; slow-step=0.1, prefill-error@4",
    "step-stall=1.0@1:replica=2",
    "worker-exit=0@1:tier=prefill",
    "kv-handoff-drop@2:replica=1:tier=decode",
    "handoff-delay=0.5:tier=decode:replica=0",
    "alloc-fail@2,alloc-fail@1:replica=1",
    " ; tokenizer-error ,, step-stall=3 ",
    "worker-exit=2@1:tier=decode,worker-exit=1@1:tier=decode",
]
BAD = [
    "nope",
    "step-stall:tier=middle",
    "step-stall:shard=1",
    "step-stall@x",
    "step-stall=abc",
    "alloc-fail:replica=one",
]


def _entries(injector) -> dict:
    return {name: [(f.value, f.remaining, f.fired, f.replica, f.tier) for f in lst]
            for name, lst in injector._faults.items()}


def test_module_constants_match():
    assert faults.POINTS == jfaults.POINTS
    assert faults.TIERS == jfaults.TIERS
    assert faults.ENV_VAR == jfaults.ENV_VAR


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_and_fires_as_the_reference(spec):
    """The same entries, then 40 takes by seeded (point, replica, tier)
    callers return the same values and leave the same fire counts."""
    ours, ref = faults.FaultInjector(spec), jfaults.FaultInjector(spec)
    assert _entries(ours) == _entries(ref)
    rng = np.random.default_rng(len(spec))
    points = sorted(faults.POINTS)
    for _ in range(40):
        point = points[rng.integers(len(points))]
        replica = [None, 0, 1, 2][rng.integers(4)]
        tier = [None, "prefill", "decode"][rng.integers(3)]
        assert ours._take(point, replica, tier) == ref._take(point, replica, tier)
    assert _entries(ours) == _entries(ref)
    for point in points:
        assert ours.fired(point) == ref.fired(point)
    pred = (lambda v: v >= 2)
    assert (ours.take_if("worker-exit", pred, tier="decode")
            == ref.take_if("worker-exit", pred, tier="decode"))


@pytest.mark.parametrize("spec", BAD)
def test_bad_spec_fails_as_the_reference(spec):
    with pytest.raises(ValueError) as ours:
        faults.FaultInjector(spec)
    with pytest.raises(ValueError) as ref:
        jfaults.FaultInjector(spec)
    assert str(ours.value) == str(ref.value)


def test_env_arms_the_shared_injector_and_raise_types(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "alloc-fail@1,prefill-error")
    faults.clear()
    inj = faults.get_injector()
    assert inj is faults.get_injector()
    with pytest.raises(KeyError, match="injected fault: alloc-fail"):
        inj.maybe_raise("alloc-fail", KeyError)
    inj.maybe_raise("alloc-fail", KeyError)          # spent: no raise
    with pytest.raises(RuntimeError, match="injected fault: prefill-error"):
        inj.maybe_raise("prefill-error")
    faults.clear()
    monkeypatch.delenv(faults.ENV_VAR)
    assert faults.get_injector() is None


def test_budget_survives_an_engine_restart():
    """A fresh engine reads the same module-shared injector, so a spent
    `@1` fault stays spent across the restart."""
    config = EngineConfig(model="tiny-llama", tokenizer="byte", dtype="float32",
                          max_decode_slots=1, page_size=8, num_pages=16, max_seq_len=64,
                          prefill_buckets=(16, 32), max_new_tokens_cap=8)
    inj = faults.install("prefill-error@1")
    first = InferenceEngine(config, device="cpu")
    try:
        assert first._faults is inj
        with pytest.raises(RuntimeError):
            inj.maybe_raise("prefill-error")
    finally:
        first.shutdown()
    fresh = InferenceEngine(config, device="cpu", reuse=first._ctor_args)
    try:
        assert fresh._faults is inj and inj.fired("prefill-error") == 1
        fresh._faults.maybe_raise("prefill-error")   # spent: no raise
    finally:
        fresh.shutdown()
