"""The rest of serving over a mesh (engine/lockstep.py) against the JAX
package's engine on the CPU: checkpoints read as rank shards, the
capacity-bucketed MoE under dp and sp, the host tier's durable state dir
and the in-process restart of a mesh engine.

One 8-rank gloo group for the module (tests/torch_ranks.py) serves each
case on ranks of its own, the leader on the first, with
tests/test_engine_mesh.py's BASE_CONFIG, prompts and 8 greedy tokens.
Meanwhile the test process runs the JAX single-device engines on the same
weights (the JAX init_params trees, carried over by params_from_numpy or
written as an HF checkpoint by chip_smoke.py's writer), and the port's
single-card engine that writes the state dir the mesh's is held to.

- **MoE**: a capacity-bucketed tiny-mixtral (`moe_dispatch=True`,
  registered in both packages' registries for the module) at dp=2, sp=2
  and ep2 x dp2: the leader's greedy streams equal the JAX single-device
  engine's. The layer alone (`moe_mlp_sharded`) on a batch built to drop
  tokens, each rank's share (dp rows, sp columns, ep experts), equals the
  JAX `moe_mlp_dispatch` over the whole batch, where the rank-local
  capacity would drop other tokens.
- **Checkpoints**: tp=2 in int8 weights and ep2 x tp2 engines reading
  their shards of a checkpoint serve the JAX engine's streams on the
  weights written.
- **State dir**: tp=2 (fp32 and int8 KV) and dp=2 meshes with the prefix
  cache and host tier write state dirs whose sidecars and blob headers
  are byte-identical to the single-card port engine's for the same
  requests (dp=2's blobs whole; tp=2's pages as `_same_pages` holds
  them); a second tp=2 mesh, the JAX engine and the single-card port
  engine each reload one, hit it and serve the JAX engine's streams.
- **Restart**: a tp=2 mesh whose leader's engine loop crashed before a
  record of its dispatch went out, and one whose leader failed inside a
  prefill's dispatch (its record replayed, the follower blocked in its
  collectives), are restarted in process on every rank (the supervisor's
  factory, a new life's groups, the "rebuild" word through the store);
  the fresh mesh serves the JAX engine's streams, the followers' decode
  digests equal the leader's, and health is SERVING. The other restart
  kinds are in tests/test_torch_mesh_lives.py.
- **Handoffs**: the prefill_only export's wire blob (whole pages) against
  the single-card engine's at tp=2 (fp32 and int8 KV) and dp=2, resumed
  on the same mesh to the JAX stream.
- **Replicas**: two replicas of tp=2 meshes through a failover.
"""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_ranks
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import MODEL_REGISTRY as J_REGISTRY
from polykey_tpu.models.config import TINY_MIXTRAL as J_TINY_MIXTRAL
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu.ops.moe import moe_mlp_dispatch as j_moe_dispatch
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.engine.kv_cache import deserialize_kv_state, serialize_kv_state
from polykey_tpu_torch.gateway.health import SERVING
from polykey_tpu_torch.models.config import MODEL_REGISTRY, TINY_MIXTRAL, get_config
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.ops.moe import _dispatch_slots, _router_weights

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
MAX_NEW = 8
JAX_ONLY = dict(compile_warmup=False, supervise=False, signals_interval_s=0)
# tests/test_torch_host_kv.py's pool: revisited sessions spill and fault back.
HOST = dict(num_pages=24, prefill_chunk=16, max_new_tokens_cap=16, prefix_cache=True,
            host_kv_bytes=64 << 20, host_kv_resident_pages=12)
SESSIONS = [f"session {s} header padded out to be long enough xx" for s in range(4)]
STICKY = SESSIONS + [SESSIONS[0], SESSIONS[2], SESSIONS[1], SESSIONS[3]]
HANDOFF_PROMPT = "hello disagg world"

MOE = "tiny-mixtral-dispatch"
MODELS = {"tiny-llama": get_config("tiny-llama"), "tiny-mixtral": TINY_MIXTRAL,
          MOE: dataclasses.replace(TINY_MIXTRAL, name=MOE, moe_dispatch=True)}

# reference name -> (EngineConfig fields over FIELDS, prompts, one at a time)
REFS = {
    "base": ({}, PROMPTS, False),
    "int8-weights": (dict(quantize=True), PROMPTS, False),
    "moe": (dict(model="tiny-mixtral"), PROMPTS, False),
    "moe-dispatch": (dict(model=MOE), PROMPTS, False),
    "host": (HOST, STICKY, True),
    "host-int8": (dict(HOST, kv_dtype="int8"), STICKY, True),
    "handoff": ({}, [HANDOFF_PROMPT], False),
    "handoff-int8": (dict(kv_dtype="int8"), [HANDOFF_PROMPT], False),
}
# name -> (kind, mesh axes and fields, ranks, reference), in each rank's order
CASES = {
    "moe-dp2": ("engine", dict(dp=2), [0, 1], "moe-dispatch"),
    "moe-sp2": ("engine", dict(sp=2), [2, 3], "moe-dispatch"),
    "moe-ep2xdp2": ("engine", dict(ep=2, dp=2), [4, 5, 6, 7], "moe-dispatch"),
    "ckpt-tp2-int8": ("engine", dict(tp=2), [0, 1], "int8-weights"),
    "state-tp2": ("engine", dict(tp=2), [2, 3], "host"),
    "ckpt-ep2xtp2": ("engine", dict(ep=2, tp=2), [4, 5, 6, 7], "moe"),
    "restart-tp2": ("supervise", dict(tp=2, max_engine_restarts=1), [0, 1], "base"),
    "state-reload-tp2": ("engine", dict(tp=2), [2, 3], "host"),
    "state-dp2": ("engine", dict(dp=2), [6, 7], "host"),
    "replicas-tp2": ("replicas", dict(tp=2, replicas=2), [4, 5], "base"),
    "handoff-tp2": ("handoff", dict(tp=2), [6, 7], "handoff"),
    "handoff-dp2": ("handoff", dict(dp=2), [0, 1], "handoff"),
    "restart-inside-tp2": ("supervise", dict(tp=2, max_engine_restarts=1), [2, 3], "base"),
    "state-tp2-int8": ("engine", dict(tp=2), [4, 5], "host-int8"),
    "handoff-tp2-int8": ("handoff", dict(tp=2), [6, 7], "handoff-int8"),
}
VICTIM, VICTIM_NEW = "a stream that fails over", 12
CHECKPOINTS = {"ckpt-tp2-int8": "tiny-llama", "ckpt-ep2xtp2": "tiny-mixtral"}
STATE = {"state-tp2": "mesh", "state-reload-tp2": "mesh", "state-dp2": "mesh-dp2",
         "state-tp2-int8": "mesh-int8"}
# The state dirs' and handoff blobs' single-card references, by KV type.
SINGLE = {"state-tp2": "single", "state-dp2": "single", "state-tp2-int8": "single-int8",
          "handoff-tp2": "handoff", "handoff-dp2": "handoff",
          "handoff-tp2-int8": "handoff-int8"}
# Where the supervise jobs' leaders fail: before a record of the dispatch
# went out, or inside a dispatch whose record was replayed; the latter's
# follower orphan wakes at its gloo groups' timeout (GROUP_TIMEOUT_S), the
# idle leader's heartbeats well inside it.
CRASH = {"restart-tp2": "before", "restart-inside-tp2": "inside"}
GROUP_TIMEOUT_S = {"restart-inside-tp2": 8.0}
# The layer alone: name -> (mesh axes, ranks, which of the batch's axes split)
OPS = {
    "op-dp2": (dict(dp=2), [0, 1], dict(dp=True)),
    "op-sp2": (dict(sp=2), [2, 3], dict(sp=True)),
    "op-ep2xdp2": (dict(ep=2, dp=2), [4, 5, 6, 7], dict(dp=True)),
}


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


def _fields(ref: str, extra: dict = None) -> dict:
    return {**FIELDS, **REFS[ref][0], **(extra or {})}


def _jax_engine(fields: dict, params):
    return JInferenceEngine(JEngineConfig(**fields, **JAX_ONLY),
                            params=jax.tree_util.tree_map(jnp.asarray, params))


def _jax_streams(fields: dict, params, prompts, sequential) -> list:
    engine = _jax_engine(fields, params)
    try:
        return _serve(engine, JGenRequest, prompts, sequential)
    finally:
        engine.shutdown()


def _moe_batch(cfg):
    """Hidden states [4, 8, H] made of three vectors, so the router sends
    most tokens to the same experts and the whole batch drops some."""
    rng = np.random.default_rng(11)
    basis = rng.standard_normal((3, cfg.hidden_size)).astype(np.float32)
    pick = rng.integers(0, 3, size=(4, 8))
    return basis[pick] + 0.01 * rng.standard_normal((4, 8, cfg.hidden_size)).astype(
        np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serving")
    J_REGISTRY[MOE] = dataclasses.replace(J_TINY_MIXTRAL, name=MOE, moe_dispatch=True)
    MODEL_REGISTRY[MOE] = MODELS[MOE]
    try:
        yield _runs(tmp)
    finally:
        J_REGISTRY.pop(MOE, None)
        MODEL_REGISTRY.pop(MOE, None)


def _runs(tmp):
    params = {}
    for name in MODELS:
        params[name] = jax.device_get(
            jt.init_params(jax.random.PRNGKey(0), j_get_config(name), jnp.float32))
        torch_ranks.save_tree(tmp / f"{name}.npz", params[name])
    ckpt = {}
    for model in set(CHECKPOINTS.values()):
        ckpt[model] = tmp / f"{model}-ckpt"
        ckpt[model].mkdir()
        chip_smoke.write_hf_checkpoint(params_from_numpy(params[model]), MODELS[model],
                                       str(ckpt[model]))
    state = {k: str(tmp / f"{k}-state")
             for k in ("mesh", "mesh-dp2", "mesh-int8", "single", "single-int8")}
    h = _moe_batch(MODELS[MOE])
    np.savez(tmp / "moe-batch.npz", h=h)
    model_fields = {n: torch_ranks.config_fields(c) for n, c in MODELS.items()}
    jobs = []
    for name, (kind, axes, ranks, ref) in CASES.items():
        extra = dict(axes)
        if name in CHECKPOINTS:
            extra["checkpoint_path"] = str(ckpt[CHECKPOINTS[name]])
        if name in STATE:
            extra["kv_state_dir"] = state[STATE[name]]
        fields = _fields(ref, extra)
        jobs.append({"kind": kind, "name": name, "devices": ranks, "config": fields,
                     "model": model_fields[fields["model"]],
                     "params": "" if name in CHECKPOINTS else str(tmp / f"{fields['model']}.npz"),
                     "prompts": REFS[ref][1], "sequential": REFS[ref][2],
                     "max_new": MAX_NEW, "victim": VICTIM, "victim_new": VICTIM_NEW,
                     "prompt": HANDOFF_PROMPT, "crash": CRASH.get(name, "before")})
        if name in GROUP_TIMEOUT_S:
            jobs[-1].update(group_timeout_s=GROUP_TIMEOUT_S[name], heartbeat_s=1.0)
    for name, (axes, ranks, split) in OPS.items():
        jobs.append({"kind": "moe", "name": name, "devices": ranks, "mesh": axes,
                     "cfg": model_fields[MOE], "params": str(tmp / f"{MOE}.npz"),
                     "inputs": str(tmp / "moe-batch.npz"), "split": split})
    box = {}

    def ranks():
        try:
            box["results"] = torch_ranks.run(8, jobs, tmp / "ranks", timeout=300, nice=10)
        except BaseException as e:          # re-raised below, on the test's thread
            box["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        refs = {}
        for ref, (fields, prompts, sequential) in REFS.items():
            model = fields.get("model", "tiny-llama")
            refs[ref] = _jax_streams(_fields(ref), params[model], prompts, sequential)
        engine = _jax_engine(_fields("base"), params["tiny-llama"])
        try:
            victim = JGenRequest(prompt=VICTIM, max_new_tokens=VICTIM_NEW)
            engine.submit(victim)
            refs["victim"] = _collect(victim)
        finally:
            engine.shutdown()
        # The single-card port engine on the same requests, writing its dir
        # (bf16-sized fp32 KV and int8 KV).
        single_streams = {}
        for ref, key in (("host", "single"), ("host-int8", "single-int8")):
            single = InferenceEngine(EngineConfig(**_fields(ref, dict(
                kv_state_dir=state[key]))), params=params_from_numpy(params["tiny-llama"]),
                device="cpu")
            try:
                single_streams[key] = _serve(single, GenRequest, STICKY, True)
            finally:
                single.shutdown()
        # The single-card port engine's handoff blob of the same prefill.
        single_blob = {}
        for ref in ("handoff", "handoff-int8"):
            single = InferenceEngine(EngineConfig(**_fields(ref)), device="cpu",
                                     params=params_from_numpy(params["tiny-llama"]))
            try:
                request = GenRequest(prompt=HANDOFF_PROMPT, max_new_tokens=MAX_NEW, seed=99,
                                     prefill_only=True)
                single.submit(request)
                single_blob[ref] = serialize_kv_state(request.out.get(timeout=60)[1])
            finally:
                single.shutdown()
        layer = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), params[MOE]["layers"])
        jmoe = np.asarray(j_moe_dispatch(layer, jnp.asarray(h), j_get_config(MOE)))
    finally:
        thread.join(360)
    assert not thread.is_alive(), "rank runner did not return"
    if "error" in box:
        raise box["error"]
    return {"results": box["results"], "refs": refs, "single": single_streams,
            "single_blob": single_blob,
            "state": state, "params": params, "h": h, "jmoe": jmoe}


def _leader(results, name) -> dict:
    ranks = CASES[name][2] if name in CASES else OPS[name][1]
    return {k[len(name) + 1:]: v for k, v in results[ranks[0]].items()
            if k.startswith(name + "/")}


ENGINE_CASES = [n for n, c in CASES.items() if c[0] == "engine"]


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_leader_streams_match_the_jax_engine(runs, name):
    got = _leader(runs["results"], name)
    assert list(got["errors"]) == [""] * len(got["errors"])
    assert got["tokens"].tolist() == runs["refs"][CASES[name][3]], \
        torch_ranks.describe(runs["results"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[0] != "replicas"])
def test_followers_decode_the_leaders_tokens(runs, name):
    results = runs["results"]
    ranks = CASES[name][2]
    lead = results[ranks[0]]
    assert str(lead[f"{name}/role"]) == "leader" and int(lead[f"{name}/blocks"]) > 0
    for r in ranks[1:]:
        assert str(results[r][f"{name}/role"]) == "follower"
        assert str(results[r][f"{name}/error"]) == ""
        assert int(results[r][f"{name}/blocks"]) == int(lead[f"{name}/blocks"])
        assert str(results[r][f"{name}/digest"]) == str(lead[f"{name}/digest"])


def test_restarted_mesh_serves_the_jax_streams(runs):
    """The leader's first request fails with the injected crash; the
    supervisor rebuilds the mesh once (each follower builds a second
    engine), health is SERVING again and the fresh mesh serves the JAX
    engine's greedy streams."""
    results = runs["results"]
    got = _leader(results, "restart-tp2")
    assert "injected dispatch failure" in str(got["error"])
    assert int(got["restarts"]) == 1 and not bool(got["gave_up"])
    assert int(got["status"]) == SERVING
    assert list(got["errors"]) == [""] * len(PROMPTS)
    assert got["tokens"].tolist() == runs["refs"]["base"]
    assert int(results[1]["restart-tp2/lives"]) == 2


def test_mesh_engine_failed_inside_a_dispatch_restarts(runs):
    """The leader serves the JAX streams, then the prefill-error point
    fires inside a prefill's dispatch whose record the follower replayed
    (the follower blocked in its collectives): the supervisor restarts the
    mesh once, the follower starts its second life beside its orphan,
    health is NOT_SERVING and then SERVING again, the flight recorder and
    the restart counter hold the restart, and the fresh mesh serves the
    JAX engine's streams."""
    results = runs["results"]
    name = "restart-inside-tp2"
    got = _leader(results, name)
    assert "injected fault: prefill-error" in str(got["error"]), str(got["error"])
    assert int(got["restarts"]) == 1 and not bool(got["gave_up"])
    assert int(got["status"]) == SERVING and int(got["life"]) == 1
    assert json.loads(str(got["transitions"])) == ["NOT_SERVING", "SERVING"]
    assert "engine_restart" in json.loads(str(got["events"]))
    assert str(got["restarts_total"]).endswith(" 1")
    assert list(got["errors"]) == [""] * len(PROMPTS)
    assert got["tokens"].tolist() == runs["refs"]["base"]
    follower = results[CASES[name][2][1]]
    assert int(follower[f"{name}/lives"]) == 2
    assert str(follower[f"{name}/error"]) == ""


@pytest.mark.parametrize("name", list(OPS))
def test_moe_layer_shares_equal_the_whole_batch_dispatch(runs, name):
    """Each rank's share of the capacity-bucketed layer equals the JAX
    layer over the whole batch (1e-5), on a batch that drops tokens where
    a rank's own capacity would drop others."""
    axes, ranks, split = OPS[name]
    results, h = runs["results"], runs["h"]
    got = np.zeros_like(h)
    for r in ranks:
        y = results[r][f"{name}/y"]
        dp, sp = int(results[r][f"{name}/dp"]), int(results[r][f"{name}/sp"])
        rows = slice(dp * y.shape[0], (dp + 1) * y.shape[0]) if split.get("dp") else slice(None)
        cols = slice(sp * y.shape[1], (sp + 1) * y.shape[1]) if split.get("sp") else slice(None)
        got[rows, cols] = y
    np.testing.assert_allclose(got, runs["jmoe"], atol=1e-5, rtol=1e-5)
    # The whole batch drops pairs, and the rank-local capacity keeps others.
    cfg = MODELS[MOE]
    layer = params_from_numpy(runs["params"][MOE])["layers"][0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok

    def keep_of(hs):
        _, idx = _router_weights(layer, torch.from_numpy(hs).reshape(-1, hs.shape[-1]), cfg)
        cap = max(1, int(idx.shape[0] * k / E * 1.25))
        return _dispatch_slots(idx, E, cap)[1].reshape(*hs.shape[:2], k)

    whole = keep_of(h)
    assert not bool(whole.all()), "the batch drops no token"
    dim, n = (0, axes["dp"]) if split.get("dp") else (1, axes["sp"])
    local = torch.cat([keep_of(part) for part in np.split(h, n, axis=dim)], dim=dim)
    assert not torch.equal(local, whole), "the rank-local capacity keeps the same pairs"


def _first_run(directory: str) -> dict:
    """The batches of the engine that wrote to `directory` first."""
    runs = _run_files(directory)
    stamp = {}
    for name in os.listdir(directory):
        if name.startswith("prefix-000001-") and name.endswith(".keys.json"):
            stamp[name[:-len(".keys.json")].split("-")[3]] = os.path.getmtime(
                os.path.join(directory, name))
    return runs[min(stamp, key=stamp.get)]


def _run_files(directory: str) -> dict:
    """{run id: {seq: (blob bytes, sidecar json)}} of a state dir."""
    runs = {}
    for name in os.listdir(directory):
        if not name.endswith(".pkkv"):
            continue
        stem = name[:-len(".pkkv")]
        _, seq, _pid, run = stem.split("-")
        with open(os.path.join(directory, name), "rb") as f:
            blob = f.read()
        with open(os.path.join(directory, stem + ".keys.json")) as f:
            side = json.load(f)
        runs.setdefault(run, {})[int(seq)] = (blob, side)
    return runs


@pytest.mark.parametrize("name", ["state-tp2", "state-dp2", "state-tp2-int8"])
def test_mesh_state_dir_holds_the_single_card_engines_pages(runs, name):
    """The mesh's spills, whole pages assembled from the ranks' shards, are
    the single-card engine's batches in the same order: each sidecar (keys,
    params_key) and each blob byte for byte at dp=2, and at tp=2 (in the
    KV's dtype and with int8 KV, its scales beside it) as `_same_pages`
    holds them."""
    results = runs["results"]
    single = SINGLE[name]
    assert _leader(results, name)["tokens"].tolist() == runs["single"][single]
    (want,) = _run_files(runs["state"][single]).values()
    got = _first_run(runs["state"][STATE[name]])
    assert sorted(got) == sorted(want) and want
    for seq in sorted(want):
        (blob, side), (wblob, wside) = got[seq], want[seq]
        assert side == wside, seq
        _same_pages(blob, wblob, name == "state-dp2")


def test_a_mesh_reloads_its_state_dir_and_hits(runs):
    """A second tp=2 mesh on the same weights reloads the first one's
    pages into every rank's host tier (its shard of each), faults them in
    and serves the JAX engine's streams."""
    got = _leader(runs["results"], "state-reload-tp2")
    assert int(got["reloaded"]) > 0
    assert int(got["prefix_host_hit_tokens"]) > 0 and int(got["kv_pages_restored"]) > 0


@pytest.mark.parametrize("name", ["state-tp2", "state-tp2-int8"])
@pytest.mark.parametrize("package", ["jax", "port"])
def test_the_mesh_state_dir_warms_a_single_card_engine(runs, package, name, tmp_path):
    """The JAX engine and the single-card port engine on the same weights
    (and KV type) reload a tp=2 mesh's state dir (a copy of it), hit it and
    serve the JAX engine's streams."""
    import shutil

    directory = str(tmp_path / "state")
    shutil.copytree(runs["state"][STATE[name]], directory)
    ref = CASES[name][3]
    fields = _fields(ref, dict(kv_state_dir=directory))
    if package == "jax":
        engine = _jax_engine(fields, runs["params"]["tiny-llama"])
        make = JGenRequest
    else:
        engine = InferenceEngine(EngineConfig(**fields), device="cpu",
                                 params=params_from_numpy(runs["params"]["tiny-llama"]))
        make = GenRequest
    try:
        assert engine.stats()["kv_reloaded_pages"] > 0
        assert _serve(engine, make, STICKY, True) == runs["refs"][ref]
        assert engine.stats()["prefix_host_hit_tokens"] > 0
    finally:
        engine.shutdown()


def test_replicas_of_meshes_fail_over_and_restart(runs):
    """Two replicas, each over its own tp=2 mesh of the same two ranks (its
    own groups), on one set of weight shards: the pool's greedy streams
    equal the JAX engine's; replica 0's engine loop fails under a stream,
    which resumes on replica 1 to the JAX engine's uninterrupted stream;
    replica 0 is rebuilt on both ranks, serves that stream again, and the
    pool's health stays SERVING."""
    got = _leader(runs["results"], "replicas-tp2")
    assert list(got["errors"]) == [""] * len(PROMPTS)
    assert got["tokens"].tolist() == runs["refs"]["base"]
    assert str(got["resumed_error"]) == "" and bool(got["restarted"])
    assert got["resumed"].tolist() == runs["refs"]["victim"]
    assert got["routed"].tolist() == [0, 1, 0]
    assert int(got["restarts"]) == 1 and str(got["state"]) == "SERVING"
    assert int(got["status"]) == SERVING
    assert str(got["after_error"]) == "" and got["after"].tolist() == runs["refs"]["victim"]


@pytest.mark.parametrize("replica", [0, 1])
def test_replica_followers_decode_their_leaders_tokens(runs, replica):
    """Each replica's follower hashes its leader's decode blocks (replica 0
    after its rebuild on both ranks, replica 1 through the failover)."""
    results = runs["results"]
    lead, follower = (results[r] for r in CASES["replicas-tp2"][2])
    name = "replicas-tp2"
    assert str(follower[f"{name}/role"]) == "follower" and str(follower[f"{name}/error"]) == ""
    assert int(lead[f"{name}/blocks{replica}"]) > 0
    for key in ("digest", "blocks", "fresh"):
        assert str(follower[f"{name}/{key}{replica}"]) == str(lead[f"{name}/{key}{replica}"])
    assert bool(lead[f"{name}/fresh0"]) and not bool(lead[f"{name}/fresh1"])


def _same_pages(blob: bytes, want: bytes, exact: bool) -> None:
    """A blob of whole pages against the single-card engine's: the header
    byte for byte, and the pages byte for byte (`exact`: dp=2, where every
    rank computes what one card does) or, at tp=2, the first layer's bit
    for bit (values, and with int8 KV their scales) and the rest within
    1e-5, an int8 value within one step: tp sums the row-parallel
    products (wo, down) of two halves, which reorders fp32 additions from
    the first layer's output on (as the JAX mesh engine does against its
    single-device engine), and a quantized value on a rounding edge may
    land on either side."""
    hlen = int.from_bytes(want[6:10], "big")       # MAGIC, !H version, !I length
    assert blob[:10 + hlen] == want[:10 + hlen] and len(blob) == len(want)
    if exact:
        assert blob == want
        return
    a, b = deserialize_kv_state(blob), deserialize_kv_state(want)
    assert (a.ks is None) == (b.ks is None)
    pairs = [(a.k, b.k), (a.v, b.v)] + ([(a.ks, b.ks), (a.vs, b.vs)] if a.ks is not None else [])
    for x, y in pairs:
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x[0], y[0])
        if x.dtype == torch.int8:
            assert int((x.int() - y.int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["handoff-tp2", "handoff-dp2", "handoff-tp2-int8"])
def test_mesh_handoff_blob_holds_the_single_card_pages(runs, name):
    """A prefill_only request on the mesh ships the single-card engine's
    wire blob (whole pages gathered from the ranks' shards: byte-identical
    at dp=2; at tp=2 its header and first layer byte for byte), and the
    same mesh resumes it (the pages cut back to each rank's shard) to the
    JAX engine's stream; the followers replay the export and the import."""
    results = runs["results"]
    got = _leader(results, name)
    _same_pages(got["blob"].tobytes(), runs["single_blob"][SINGLE[name]],
                name == "handoff-dp2")
    assert str(got["resume_error"]) == "" and int(got["imports"]) == 1
    assert got["tokens"].tolist() == runs["refs"][CASES[name][3]][0]
    sent = json.loads(str(got["records"]))
    assert sent.get("export") == 1 and sent.get("import") == 1
    follower = results[CASES[name][2][1]]
    assert json.loads(str(follower[f"{name}/records"])).get("import") == 1
