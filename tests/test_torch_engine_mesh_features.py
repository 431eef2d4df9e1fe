"""The engine's own features over a serving mesh (engine/lockstep.py)
against the JAX package's engine on the CPU: pp above 1, the ragged
dispatch on tp meshes, a draft model, the prefix cache and the host tier.

One 8-rank gloo group for the module (tests/torch_ranks.py) serves each
case on ranks of its own, the leader on the first, with
tests/test_engine_mesh.py's BASE_CONFIG, prompts and 8 greedy tokens on
tiny-llama (2 layers: pp=2 puts one on each stage). Meanwhile the test
process runs the JAX engines on the same weights (the JAX init_params
trees, carried over by params_from_numpy): the bucketed engine (the ragged
cases are held to it, as ROADMAP.md C.5 asks), its int8-KV, chunked and
4-kv-head variants, the spec engine with tests/test_engine_spec.py's draft
(tiny-llama at PRNGKey(2), gamma 3), the prefix-cached and host-tier
engines, and the JAX pp=2 mesh engine on two of its simulated devices;
and the port's single-card engine for the prefix cases' page counts.

Checks: the leader's greedy streams equal the JAX engine's token for
token; every follower hashes the same decode blocks, spec rounds and
ragged dispatches as its leader, and replays the records the case must
send (ragged, spec, spill, restore); pp2 also equals the JAX pp=2 mesh
engine; ranks that differ only in dp hold the same pools; a pp stage
holds its own layers' pools; the prefix cases' pages matched, spilled
and restored equal the single-card port engine's.
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import MODEL_REGISTRY as J_REGISTRY
from polykey_tpu.models.config import TINY_LLAMA as J_TINY_LLAMA
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.engine.kv_cache import kv_pool_bytes
from polykey_tpu_torch.models.config import TINY_LLAMA, get_config
from polykey_tpu_torch.models.interop import params_from_numpy

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
PROMPTS = ["hello mesh", "sharded decoding", "a", "the quick brown fox"]
CHUNKED = dict(max_seq_len=256, num_pages=128, prefill_chunk=32)
LONG = "".join(chr(c) for c in np.random.default_rng(5).integers(97, 123, 120))
SPEC = dict(draft_model="tiny-llama", spec_gamma=3)
HEADER = "spec shared header for the cache. "          # 4 pages of 8
CACHED = [HEADER + t for t in ("one", "two", "three!")]
# tests/test_torch_host_kv.py's pool, small enough that revisited sessions
# spill and fault back.
HOST = dict(num_pages=24, prefill_chunk=16, max_new_tokens_cap=16, prefix_cache=True,
            host_kv_bytes=64 << 20, host_kv_resident_pages=12)
SESSIONS = [f"session {s} header padded out to be long enough xx" for s in range(4)]
STICKY = SESSIONS + [SESSIONS[0], SESSIONS[2], SESSIONS[1], SESSIONS[3]]
MAX_NEW = 8
JAX_ONLY = dict(compile_warmup=False, supervise=False, signals_interval_s=0)

FOUR_KV = "tiny-llama-4kv"
MODELS = {
    "tiny-llama": get_config("tiny-llama"),
    FOUR_KV: dataclasses.replace(TINY_LLAMA, name=FOUR_KV, num_heads=8, num_kv_heads=4),
}

# reference name -> (EngineConfig fields over FIELDS, prompts, served one at a time)
REFS = {
    "base": ({}, PROMPTS, False),
    "chunked": (CHUNKED, [LONG], False),
    "int8-kv": (dict(kv_dtype="int8"), PROMPTS, False),
    "4kv": (dict(model=FOUR_KV), PROMPTS, False),
    "spec": (SPEC, PROMPTS, False),
    "prefix": (dict(prefix_cache=True), CACHED, True),
    "host": (HOST, STICKY, True),
}
# name -> (mesh axes and mode, ranks, reference), in the order each rank runs them
CASES = {
    "pp2": (dict(pp=2), [0, 1], "base"),
    "pp2xtp2": (dict(pp=2, tp=2), [2, 3, 4, 5], "base"),
    "pp2-chunked": (dict(pp=2), [6, 7], "chunked"),
    "pp2-int8-kv": (dict(pp=2), [0, 1], "int8-kv"),
    "pp2xdp2": (dict(pp=2, dp=2), [4, 5, 6, 7], "base"),
    "tp2-ragged": (dict(tp=2, ragged_dispatch=True), [2, 3], "base"),
    "tp2-ragged-int8-kv": (dict(tp=2, ragged_dispatch=True), [0, 1], "int8-kv"),
    "tp4-ragged": (dict(tp=4, ragged_dispatch=True), [4, 5, 6, 7], "4kv"),
    "one-rank-ragged": (dict(ragged_dispatch=True), [3], "base"),
    "tp2-draft": (dict(tp=2), [0, 1], "spec"),
    "dp2-draft": (dict(dp=2), [2, 3], "spec"),
    "tp2-draft-ragged": (dict(tp=2, ragged_dispatch=True), [4, 5], "spec"),
    "tp2-prefix-cache": (dict(tp=2), [6, 7], "prefix"),
    "tp2-host-tier": (dict(tp=2), [0, 1], "host"),
}
# Records each case's followers must have replayed.
MUST_REPLAY = {
    "tp2-ragged": ("ragged",), "tp2-ragged-int8-kv": ("ragged",), "tp4-ragged": ("ragged",),
    "tp2-draft": ("spec",), "dp2-draft": ("spec",), "tp2-draft-ragged": ("ragged", "spec"),
    "tp2-host-tier": ("spill", "restore"),
}
PREFIX_CASES = ("tp2-prefix-cache", "tp2-host-tier")


def _collect(request, timeout=120.0):
    tokens = []
    deadline = time.monotonic() + timeout
    while True:
        kind, value = request.out.get(timeout=max(0.0, deadline - time.monotonic()))
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens
        else:
            raise AssertionError(f"the engine failed: {value}")


def _serve(engine, make, prompts, sequential) -> list:
    requests = [make(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    if sequential:
        out = []
        for r in requests:
            engine.submit(r)
            out.append(_collect(r))
        return out
    for r in requests:
        engine.submit(r)
    return [_collect(r) for r in requests]


def _fields(ref: str, axes: dict = None) -> dict:
    return {**FIELDS, **REFS[ref][0], **(axes or {})}


def _jax_streams(fields: dict, params, draft, prompts, sequential) -> list:
    # No warm-up compiles, supervisor or signal plane: only the streams count.
    engine = JInferenceEngine(
        JEngineConfig(**fields, **JAX_ONLY),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        draft_params=(jax.tree_util.tree_map(jnp.asarray, draft)
                      if "draft_model" in fields else None))
    try:
        return _serve(engine, JGenRequest, prompts, sequential)
    finally:
        engine.shutdown()


def _port_counts(fields: dict, params, prompts) -> dict:
    """The single-card port engine's prefix and host-tier page counts."""
    engine = InferenceEngine(EngineConfig(**fields), params=params_from_numpy(params),
                             device="cpu")
    try:
        _serve(engine, GenRequest, prompts, True)
        snap = engine.stats()
        return {k: int(snap.get(k, 0)) for k in torch_ranks.PAGE_COUNTS}
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, JAX streams by reference, the JAX pp=2 mesh engine's
    streams, the single-card port's page counts by prefix case)."""
    tmp = tmp_path_factory.mktemp("engine_mesh_features")
    J_REGISTRY[FOUR_KV] = dataclasses.replace(J_TINY_LLAMA, name=FOUR_KV, num_heads=8,
                                              num_kv_heads=4)
    try:
        yield _runs(tmp)
    finally:
        J_REGISTRY.pop(FOUR_KV, None)


def _runs(tmp):
    params = {}
    for name in MODELS:
        params[name] = jax.device_get(
            jt.init_params(jax.random.PRNGKey(0), j_get_config(name), jnp.float32))
        torch_ranks.save_tree(tmp / f"{name}.npz", params[name])
    draft = jax.device_get(
        jt.init_params(jax.random.PRNGKey(2), j_get_config("tiny-llama"), jnp.float32))
    torch_ranks.save_tree(tmp / "draft.npz", draft)
    model_fields = {n: torch_ranks.config_fields(c) for n, c in MODELS.items()}
    jobs = []
    for name, (axes, ranks, ref) in CASES.items():
        fields = _fields(ref, axes)
        jobs.append({"kind": "engine", "name": name, "devices": ranks, "config": fields,
                     "model": model_fields[fields["model"]],
                     "params": str(tmp / f"{fields['model']}.npz"),
                     "draft_params": str(tmp / "draft.npz") if ref == "spec" else "",
                     "prompts": REFS[ref][1], "sequential": REFS[ref][2],
                     "max_new": MAX_NEW})
    box = {}

    def ranks():
        try:
            # Niced: the ranks mostly wait on each other, and their start-up
            # burst (eight processes) must not starve the other tests.
            box["results"] = torch_ranks.run(8, jobs, tmp / "ranks", timeout=240, nice=10)
        except BaseException as e:          # re-raised below, on the test's thread
            box["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        refs = {}
        for ref, (fields, prompts, sequential) in REFS.items():
            model = fields.get("model", "tiny-llama")
            refs[ref] = _jax_streams(_fields(ref), params[model], draft, prompts,
                                     sequential)
        jax_pp2 = _jax_streams(_fields("base", dict(pp=2)), params["tiny-llama"], draft,
                               PROMPTS, False)
        counts = {name: _port_counts(_fields(CASES[name][2]), params["tiny-llama"],
                                     REFS[CASES[name][2]][1])
                  for name in PREFIX_CASES}
    finally:
        thread.join(300)
    assert not thread.is_alive(), "rank runner did not return"
    if "error" in box:
        raise box["error"]
    return box["results"], refs, jax_pp2, counts


def _leader(results, name) -> dict:
    r = CASES[name][1][0]
    return {k[len(name) + 1:]: v for k, v in results[r].items() if k.startswith(name + "/")}


@pytest.mark.parametrize("name", list(CASES))
def test_leader_streams_match_the_jax_engine(runs, name):
    results, refs, _, _ = runs
    got = _leader(results, name)
    assert list(got["errors"]) == [""] * len(got["errors"])
    assert got["tokens"].tolist() == refs[CASES[name][2]], torch_ranks.describe(results)


@pytest.mark.parametrize("name", list(CASES))
def test_followers_replay_the_leaders_dispatches(runs, name):
    """Every rank hashes the same decode blocks, spec rounds and ragged
    dispatches, in dispatch order, and replays the records its case
    sends."""
    results, _, _, _ = runs
    ranks = CASES[name][1]
    lead = results[ranks[0]]
    assert str(lead[f"{name}/role"]) == "leader"
    sent = json.loads(str(lead[f"{name}/records"]))
    for kind in MUST_REPLAY.get(name, ()):
        assert sent.get(kind, 0) > 0, sent
    if len(ranks) > 1:
        assert int(lead[f"{name}/blocks"]) > 0
    for r in ranks[1:]:
        assert str(results[r][f"{name}/role"]) == "follower"
        assert str(results[r][f"{name}/error"]) == ""
        assert int(results[r][f"{name}/blocks"]) == int(lead[f"{name}/blocks"])
        assert str(results[r][f"{name}/digest"]) == str(lead[f"{name}/digest"])
        replayed = json.loads(str(results[r][f"{name}/records"]))
        for kind in MUST_REPLAY.get(name, ()):
            assert replayed.get(kind, 0) == sent[kind], (kind, replayed, sent)


def test_pp2_matches_the_jax_pp2_mesh_engine(runs):
    results, _, jax_pp2, _ = runs
    assert _leader(results, "pp2")["tokens"].tolist() == jax_pp2


@pytest.mark.parametrize("name", ["pp2xdp2", "dp2-draft"])
def test_pools_are_replicated_over_dp(runs, name):
    """Ranks that differ only in their dp coordinate hold the same pages bit
    for bit: a dp rank writes every lane's rows, gathered (the verify
    window's too), and the stages of a pp line differ."""
    results, _, _, _ = runs
    axes, ranks, _ = CASES[name]
    per_dp = len(ranks) // axes["dp"]       # ranks laid out dp outermost
    pools = [str(results[r][f"{name}/pools"]) for r in ranks]
    for i in range(per_dp):
        assert len(set(pools[i::per_dp])) == 1, pools
    assert len(set(pools[:per_dp])) == per_dp, pools


def test_pp_stages_hold_their_layers_pools(runs):
    """A pp=2 stage's pools hold one of tiny-llama's two layers."""
    results, _, _, _ = runs
    whole = kv_pool_bytes(get_config("tiny-llama"), FIELDS["num_pages"], FIELDS["page_size"],
                          torch.float32)
    for r in CASES["pp2"][1]:
        assert 2 * int(results[r]["pp2/kv_pool_bytes"]) == whole


@pytest.mark.parametrize("name", PREFIX_CASES)
def test_prefix_pages_match_the_single_card_engine(runs, name):
    """Pages matched, spilled and restored, counted by the leader alone,
    equal the single-card port engine's on the same prompts; the host-tier
    case spills and restores."""
    results, _, _, counts = runs
    got = _leader(results, name)
    assert {k: int(got[k]) for k in torch_ranks.PAGE_COUNTS} == counts[name]
    assert counts[name]["prefix_hit_tokens"] + counts[name]["prefix_host_hit_tokens"] > 0
    if name == "tp2-host-tier":
        assert counts[name]["kv_pages_evicted"] > 0 and counts[name]["kv_pages_restored"] > 0
