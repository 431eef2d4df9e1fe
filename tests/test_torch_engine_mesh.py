"""The port's engine over a mesh of processes (engine/lockstep.py) against
the JAX package's engine on the CPU.

One 8-rank gloo group for the module (tests/torch_ranks.py) serves every
configuration of tests/test_engine_mesh.py (its BASE_CONFIG, prompts and
8 greedy tokens) on ranks of its own, the leader on the first: tp=2,
dp=2, tp2 x dp2, sp=2 (and on the 120-character chunked prompt), tp=2
with int8 and int4 weights and with int8 KV, sp=2 with int8 KV, ep=2 and
ep2 x tp2 on tiny-mixtral, tp=4 on a 4-kv-head tiny-llama, and tp2 x dp2
x num_slices=2 over all eight. Meanwhile the test process runs the JAX
single-device engine on the same weights (the JAX init_params tree,
carried over by params_from_numpy) and, for tp=2 and sp=2, the JAX mesh
engine on its simulated devices. Checks: the leader's greedy streams
equal the JAX engine's token for token (fp32: the tp partial sums and the
sp merge reorder additions, far from flipping an argmax here, as the JAX
mesh tests rely on too); every follower's decode tokens hash to the
leader's; the refusals (the reference's geometry ValueErrors,
NotImplementedError naming A.17); the supervisor refuses to restart a
mesh engine. A second, 2-rank group loses a follower mid-stream: the
leader's requests must end with an error, not hang.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import MODEL_REGISTRY as J_REGISTRY
from polykey_tpu.models.config import TINY_LLAMA as J_TINY_LLAMA
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.models.config import TINY_LLAMA, get_config

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
MAX_NEW = 8

FOUR_KV = "tiny-llama-4kv"
MODELS = {
    "tiny-llama": get_config("tiny-llama"),
    "tiny-mixtral": get_config("tiny-mixtral"),
    FOUR_KV: dataclasses.replace(TINY_LLAMA, name=FOUR_KV, num_heads=8, num_kv_heads=4),
}

# name -> (mesh axes, ranks, reference: other EngineConfig fields, prompts)
REFS = {
    "base": ({}, PROMPTS),
    "chunked": (CHUNKED, [LONG]),
    "int8-weights": (dict(quantize=True), PROMPTS),
    "int4-weights": (dict(quantize=True, quantize_bits=4), PROMPTS),
    "int8-kv": (dict(kv_dtype="int8"), PROMPTS),
    "moe": (dict(model="tiny-mixtral"), PROMPTS),
    "4kv": (dict(model=FOUR_KV), PROMPTS),
}
CASES = {    # in the order each rank runs them
    "tp2": (dict(tp=2), [0, 1], "base"),
    "dp2": (dict(dp=2), [2, 3], "base"),
    "tp2xdp2": (dict(tp=2, dp=2), [4, 5, 6, 7], "base"),
    "sp2": (dict(sp=2), [0, 1], "base"),
    "sp2-chunked": (dict(sp=2), [2, 3], "chunked"),
    "tp2-int8-weights": (dict(tp=2), [4, 5], "int8-weights"),
    "tp2-int4-weights": (dict(tp=2), [6, 7], "int4-weights"),
    "tp2-int8-kv": (dict(tp=2), [0, 1], "int8-kv"),
    "sp2-int8-kv": (dict(sp=2), [2, 3], "int8-kv"),
    "ep2": (dict(ep=2), [4, 5], "moe"),
    "tp4": (dict(tp=4), [0, 1, 2, 3], "4kv"),
    "ep2xtp2": (dict(ep=2, tp=2), [4, 5, 6, 7], "moe"),
    "tp2xdp2xslices2": (dict(tp=2, dp=2, num_slices=2), list(range(8)), "base"),
}
JAX_MESH = ("tp2", "sp2")    # also held to the JAX mesh engine
IDLE = dict(heartbeat_s=0.2, idle_s=1.5)    # dp2's leader idles before it stops

GEOMETRY = {    # tests/test_engine_mesh.py::test_bad_geometry_rejected's cases
    "dp3-slots": (dict(dp=3), "must divide max_decode_slots"),
    "tp4-kv-heads": (dict(tp=4), "must divide num_kv_heads"),
    "ep2-dense": (dict(ep=2), "requires an MoE model"),
    "sp3-buckets": (dict(sp=3), "must divide every prefill bucket"),
    "sp0": (dict(sp=0), "must be >= 1"),
}
A17 = {
    "pp2": dict(pp=2),
    "tp2-ragged": dict(tp=2, ragged_dispatch=True),
    "tp2-draft": dict(tp=2, draft_model="tiny-llama"),
    "tp2-prefix-cache": dict(tp=2, prefix_cache=True),
    "tp2-host-tier": dict(tp=2, prefix_cache=True, host_kv_bytes=1 << 20),
    "tp2-disagg": dict(tp=2, disagg="1x1"),
    "tp2-replicas": dict(tp=2, replicas=2),
    "one-rank-ragged": dict(ragged_dispatch=True),   # the group alone makes a mesh
    "dp2-moe-dispatch": dict(model="mixtral-8x7b", dp=2),
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
            raise AssertionError(f"the JAX engine failed: {value}")


def _jax_streams(fields: dict, params, prompts) -> list:
    # jax arrays: the JAX engine's quantize_params leaves numpy leaves alone.
    # No warm-up compiles, supervisor or signal plane: only the streams count.
    engine = JInferenceEngine(JEngineConfig(**fields, compile_warmup=False, supervise=False,
                                            signals_interval_s=0),
                              params=jax.tree_util.tree_map(jnp.asarray, params))
    try:
        requests = [JGenRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
        for r in requests:
            engine.submit(r)
        return [_collect(r) for r in requests]
    finally:
        engine.shutdown()


def _fields(ref: str, axes: dict) -> dict:
    return {**FIELDS, **REFS[ref][0], **axes}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(rank results, JAX single-device streams by reference, JAX mesh
    streams by case)."""
    tmp = tmp_path_factory.mktemp("engine_mesh")
    J_REGISTRY[FOUR_KV] = dataclasses.replace(J_TINY_LLAMA, name=FOUR_KV, num_heads=8,
                                              num_kv_heads=4)
    try:
        yield _mesh_runs(tmp)
    finally:
        J_REGISTRY.pop(FOUR_KV, None)


def _mesh_runs(tmp):
    params = {}
    for name in MODELS:
        params[name] = jax.device_get(
            jt.init_params(jax.random.PRNGKey(0), j_get_config(name), jnp.float32))
        torch_ranks.save_tree(tmp / f"{name}.npz", params[name])
    model_fields = {n: torch_ranks.config_fields(c) for n, c in MODELS.items()}
    jobs = [{"kind": "refusals", "name": "refusals", "models": [model_fields[FOUR_KV]],
             "cases": {**{k: {**FIELDS, **v[0]} for k, v in GEOMETRY.items()},
                       **{k: {**FIELDS, **v} for k, v in A17.items()}}}]
    for name, (axes, ranks, ref) in CASES.items():
        fields = _fields(ref, axes)
        jobs.append({"kind": "engine", "name": name, "devices": ranks, "config": fields,
                     "model": model_fields[fields["model"]],
                     "params": str(tmp / f"{fields['model']}.npz"),
                     "prompts": REFS[ref][1], "max_new": MAX_NEW,
                     **(IDLE if name == "dp2" else {})})
        if name == "ep2":
            jobs.append({"kind": "supervise", "name": "supervise", "devices": [6],
                         "config": dict(FIELDS, max_engine_restarts=1),
                         "model": model_fields["tiny-llama"],
                         "params": str(tmp / "tiny-llama.npz")})
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
        for ref, (fields, prompts) in REFS.items():
            model = fields.get("model", "tiny-llama")
            refs[ref] = _jax_streams({**FIELDS, **fields}, params[model], prompts)
        jax_mesh = {name: _jax_streams(_fields(CASES[name][2], CASES[name][0]),
                                       params["tiny-llama"], PROMPTS)
                    for name in JAX_MESH}
    finally:
        thread.join(300)
    assert not thread.is_alive(), "rank runner did not return"
    if "error" in box:
        raise box["error"]
    return box["results"], refs, jax_mesh


def _leader(results, name) -> dict:
    r = CASES[name][1][0]
    return {k[len(name) + 1:]: v for k, v in results[r].items() if k.startswith(name + "/")}


@pytest.mark.parametrize("name", list(CASES))
def test_leader_streams_match_the_jax_engine(mesh_runs, name):
    results, refs, _ = mesh_runs
    got = _leader(results, name)
    assert list(got["errors"]) == [""] * len(got["errors"])
    assert got["tokens"].tolist() == refs[CASES[name][2]], torch_ranks.describe(results)


@pytest.mark.parametrize("name", list(CASES))
def test_followers_decode_the_leaders_tokens(mesh_runs, name):
    """Every rank's decode blocks, in dispatch order, hash the same."""
    results, _, _ = mesh_runs
    ranks = CASES[name][1]
    lead = results[ranks[0]]
    assert str(lead[f"{name}/role"]) == "leader" and int(lead[f"{name}/blocks"]) > 0
    for r in ranks[1:]:
        assert str(results[r][f"{name}/role"]) == "follower"
        assert str(results[r][f"{name}/error"]) == ""
        assert int(results[r][f"{name}/blocks"]) == int(lead[f"{name}/blocks"])
        assert str(results[r][f"{name}/digest"]) == str(lead[f"{name}/digest"])


@pytest.mark.parametrize("name", list(CASES))
def test_pools_are_replicated_over_dp_and_sp(mesh_runs, name):
    """Ranks that differ only in their dp or sp coordinate hold the same
    pages bit for bit: a dp rank writes every lane's rows, gathered, and
    sp ranks write the same rows."""
    results, _, _ = mesh_runs
    axes, ranks, _ = CASES[name]
    tp, ep = axes.get("tp", 1), axes.get("ep", 1)
    replicas = {}
    for i, r in enumerate(ranks):       # ranks laid out with tp innermost, then ep
        replicas.setdefault((i // tp % ep, i % tp), set()).add(
            str(results[r][f"{name}/pools"]))
    assert all(len(digests) == 1 for digests in replicas.values()), replicas


@pytest.mark.parametrize("name", JAX_MESH)
def test_leader_streams_match_the_jax_mesh_engine(mesh_runs, name):
    results, _, jax_mesh = mesh_runs
    assert _leader(results, name)["tokens"].tolist() == jax_mesh[name]


def test_idle_leader_sends_heartbeats(mesh_runs):
    """dp2's leader idles 1.5 s at a 0.2 s heartbeat before it stops: the
    follower receives the heartbeats and ends on the shutdown record."""
    results, _, _ = mesh_runs
    assert int(results[2]["dp2/heartbeats"]) >= 3
    assert str(results[3]["dp2/error"]) == ""


def test_pools_hold_each_ranks_tp_shard(mesh_runs):
    """A tp=2 rank's pools are half the dp=2 rank's (replicated over dp)."""
    results, _, _ = mesh_runs
    tp2, dp2 = int(results[1]["tp2/kv_pool_bytes"]), int(results[3]["dp2/kv_pool_bytes"])
    assert 2 * tp2 == dp2 > 0


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_bad_geometry_rejected(mesh_runs, name):
    results, _, _ = mesh_runs
    got = str(results[0][f"refusals/{name}"])
    assert got.startswith("ValueError: ") and GEOMETRY[name][1] in got, got


@pytest.mark.parametrize("name", list(A17))
def test_unported_mesh_knobs_name_a17(mesh_runs, name):
    results, _, _ = mesh_runs
    got = str(results[0][f"refusals/{name}"])
    assert got.startswith("NotImplementedError: ") and "A.17" in got, got


def test_mesh_engine_is_not_restarted_in_process(mesh_runs):
    """The supervisor's factory refuses a mesh engine (A.17); after the
    engine loop crashes the supervisor gives up and health stays
    NOT_SERVING."""
    from polykey_tpu_torch.gateway.health import NOT_SERVING

    results, _, _ = mesh_runs
    got = {k[10:]: v for k, v in results[6].items() if k.startswith("supervise/")}
    assert "A.17" in str(got["refusal"])
    assert "injected dispatch failure" in str(got["error"])
    assert bool(got["gave_up"]) and int(got["restarts"]) == 0
    assert int(got["status"]) == NOT_SERVING


def test_lost_follower_fails_the_leaders_requests(tmp_path):
    """A tp=2 follower exits at its second decode record: the leader's
    requests end with an error within the test's timeout."""
    params = jax.device_get(jt.init_params(jax.random.PRNGKey(0),
                                           j_get_config("tiny-llama"), jnp.float32))
    torch_ranks.save_tree(tmp_path / "params.npz", params)
    job = {"kind": "engine", "name": "lost", "devices": [0, 1],
           "config": dict(FIELDS, tp=2), "model": torch_ranks.config_fields(TINY_LLAMA),
           "params": str(tmp_path / "params.npz"), "prompts": PROMPTS, "max_new": 24,
           "kill_after": [1, 2], "timeout": 60}
    t0 = time.monotonic()
    results = torch_ranks.run(2, [job], tmp_path / "ranks", timeout=120, may_exit={1},
                              nice=10)
    assert 1 not in results, "the follower was to exit before it wrote results"
    errors = [str(e) for e in results[0]["lost/errors"]]
    assert all(errors), errors
    assert "timed out" not in errors and str(results[0]["lost/dead"]), errors
    assert time.monotonic() - t0 < 90


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_split_decode_states_merge_to_the_jax_kernel(int8):
    """sp=2 decode on one process: the plain version over each half of the
    page table (sp_page_range), merged (merge_split_states), against the
    JAX decode kernel (interpret mode) over the whole table, within 1e-5;
    two lanes end inside the first half, leaving the second empty."""
    import torch

    from polykey_tpu.ops.paged_attention import quantize_kv_rows as j_quantize
    from polykey_tpu.ops.paged_attention_kernel import paged_attention_decode as j_decode
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    rng = np.random.default_rng(3)
    B, Hq, Hk, D, ps, P, N = 4, 4, 2, 16, 8, 8, 40
    k = rng.standard_normal((N, ps, Hk, D)).astype(np.float32)
    v = rng.standard_normal((N, ps, Hk, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    tables = (1 + np.arange(B * P).reshape(B, P) % (N - 1)).astype(np.int32)
    pos = np.array([[3], [20], [40], [63]], np.int32)
    if int8:
        jk, jv = j_quantize(jnp.asarray(k)), j_quantize(jnp.asarray(v))
        tk = tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in jk)
        tv = tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in jv)
        tk = (tk[0].to(torch.int8), tk[1].to(torch.bfloat16))
        tv = (tv[0].to(torch.int8), tv[1].to(torch.bfloat16))
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    want = np.asarray(j_decode(jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(pos),
                               scale=D ** -0.5, interpret=True), np.float32)[:, 0]
    args = (torch.from_numpy(q[:, 0]), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(pos[:, 0]))
    halves = [pak.sp_page_range(P, 2, s) for s in (0, 1)]
    parts = [pak.paged_decode_plain(*args, scale=D ** -0.5, page_range=r) for r in halves]
    assert halves == [(0, 4), (4, 8)] and (parts[1][2][:2] == 0).all()
    acc, _, l = pak.merge_split_states(parts)
    got = (acc / torch.clamp(l, min=1e-9)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_two_server_processes_serve_over_a_mesh():
    """The deployment: two `python -m polykey_tpu_torch.gateway.server`
    processes on the CPU with the bootstrap variables and POLYKEY_TP=2.
    Rank 0 serves a streamed llm_generate of 8 tokens over gRPC, rank 1
    binds no port and follows; a SIGTERM to rank 0 stops both, rank 1 on
    the shutdown record, each with exit code 0."""
    import os
    import queue
    import signal
    import socket
    import subprocess
    import sys

    import grpc
    from google.protobuf import struct_pb2

    from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
    from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = dict(os.environ, PYTHONPATH=root, POLYKEY_BACKEND="engine",
                POLYKEY_DEVICE="cpu", POLYKEY_MODEL="tiny-llama", POLYKEY_DTYPE="float32",
                POLYKEY_MAX_DECODE_SLOTS="4", POLYKEY_NUM_PAGES="64",
                POLYKEY_MAX_SEQ_LEN="64", POLYKEY_PREFILL_BUCKETS="16,32", POLYKEY_TP="2",
                POLYKEY_METRICS_PORT="0", POLYKEY_COORDINATOR=f"127.0.0.1:{ports[0]}",
                POLYKEY_NUM_PROCESSES="2", LISTEN_ADDR=f"127.0.0.1:{ports[1]}",
                OMP_NUM_THREADS="1")
    procs, lines = [], []
    for rank in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "polykey_tpu_torch.gateway.server"],
            env=dict(base, POLYKEY_PROCESS_ID=str(rank)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        lines.append(queue.Queue())
        threading.Thread(target=lambda p=procs[-1], q=lines[-1]: [q.put(x) for x in p.stdout],
                         daemon=True).start()
    seen = [[], []]

    def wait_for(rank, text, timeout=90):
        deadline = time.monotonic() + timeout
        while not any(text in line for line in seen[rank]):
            seen[rank].append(lines[rank].get(timeout=max(0.1, deadline - time.monotonic())))

    try:
        wait_for(0, "server starting")
        wait_for(1, "mesh follower replaying")
        params = struct_pb2.Struct()
        params.update({"prompt": "hello mesh", "max_tokens": 8})
        with grpc.insecure_channel(f"127.0.0.1:{ports[1]}") as channel:
            chunks = list(PolykeyServiceStub(channel).ExecuteToolStream(
                pk.ExecuteToolRequest(tool_name="llm_generate", parameters=params),
                timeout=60))
        final = chunks[-1]
        assert final.final and final.status.code == 200
        assert final.usage.completion_tokens == 8
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=30) == 0
        assert procs[1].wait(timeout=30) == 0
        wait_for(1, "mesh follower stopped", timeout=5)
    finally:
        for p in procs:
            p.kill()
            p.wait(10)
    assert not any("50051" in line or "server starting" in line for line in seen[1])
