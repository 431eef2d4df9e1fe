"""The in-process restart of a mesh engine however it failed
(engine/lockstep.py: a new life of groups on every rank, the leader's word
through the store) against the JAX package's engine on the CPU.

One 8-rank gloo group for the module (tests/torch_ranks.py), with
tests/test_torch_mesh_serving.py's fields, prompts and 8 greedy tokens; the
test process meanwhile runs the JAX single-device (bucketed) engines on the
same weights. The meshes' gloo groups time out after GROUP_TIMEOUT_S, so
an orphan blocked in one wakes within the test; every wait is bounded.

- **Groups**: a serving mesh of dp=8 over all eight ranks makes its own
  groups (none is the default group), a training mesh of the same axes
  keeps the default group, and the serving mesh's next life has the same
  geometry on groups of its own.
- **Wedges**: the step-stall point armed on one follower (of tp=2, and of
  dp=2 x tp=2) holds the leader in a decode's collectives; its watchdog
  trips, the supervisor orphans it and restarts the mesh: every rank
  starts a second life, the fresh mesh serves the JAX engine's streams,
  and the leader's orphan, reaped once its collective times out, changes
  nothing of the fresh engine.
- **Replicas**: two replicas on meshes of their own ranks ([0, 1] and
  [0, 2]): replica 0 fails inside a prefill's dispatch and restarts while
  replica 1 serves throughout, and rank 2 makes no group meanwhile.
- **State dir**: a tp=2 mesh with the host tier fails inside a dispatch,
  reloads its state dir over its next life's pages group and hits it as a
  single-card engine does on the same files.
- **Lost follower**: a tp=2 follower exits mid-stream; the next life's
  groups cannot form, the factory raises within REMAKE_TIMEOUT_S, the
  supervisor gives up and health stays NOT_SERVING.
"""

import json
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.gateway.health import NOT_SERVING, SERVING
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy

from test_torch_mesh_serving import FIELDS, HOST, JAX_ONLY, MAX_NEW, PROMPTS, STICKY, _serve

GROUP_TIMEOUT_S = 15.0   # each gloo collective of the cases' meshes: past the stall's trip
WATCHDOG_S = 5.0         # the wedge cases' watchdog window (eight busy ranks stay inside it)
JOIN_S = 1.0             # their supervisor's join window
STALL_S = 12.0           # a follower's step-stall: past the window and the join
REMAKE_S = 3.0           # the lost-follower case's wait for its ranks
WEDGE = dict(max_engine_restarts=1, watchdog_timeout_s=WATCHDOG_S)
TIMEOUTS = dict(group_timeout_s=GROUP_TIMEOUT_S, heartbeat_s=1.0)

# name -> (job kind, fields over FIELDS, ranks, reference, job fields)
CASES = {
    "stall-tp2": ("supervise", dict(WEDGE, tp=2), [0, 1], "base",
                  dict(crash="stall", stall=[[1], STALL_S], join_timeout_s=JOIN_S)),
    "lost-tp2": ("supervise", dict(tp=2, max_engine_restarts=1), [2, 3], "base",
                 dict(crash="lost", kill_after=[3, 1], remake_timeout_s=REMAKE_S)),
    "stall-dp2xtp2": ("supervise", dict(WEDGE, dp=2, tp=2), [4, 5, 6, 7], "base",
                      dict(crash="stall", stall=[[7], STALL_S], join_timeout_s=JOIN_S)),
    "replicas": ("replica_restart", dict(tp=2, replicas=2), [0, 1, 2], "base",
                 dict(replica_ranks=[[0, 1], [0, 2]])),
    "state-tp2": ("supervise", dict(HOST, tp=2, max_engine_restarts=1), [6, 7], "host",
                  dict(crash="inside", sequential=True)),
}
REFS = {"base": ({}, PROMPTS, False), "host": (HOST, STICKY, True)}
STALLS = ["stall-tp2", "stall-dp2xtp2"]
RESTARTED = STALLS + ["state-tp2"]


def _jax_streams(fields: dict, params, prompts, sequential) -> list:
    engine = JInferenceEngine(JEngineConfig(**fields, **JAX_ONLY),
                              params=jax.tree_util.tree_map(jnp.asarray, params))
    try:
        return _serve(engine, JGenRequest, prompts, sequential)
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def lives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_lives")
    params = jax.device_get(jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                                           jnp.float32))
    torch_ranks.save_tree(tmp / "params.npz", params)
    model = torch_ranks.config_fields(get_config("tiny-llama"))
    state, snapshot = tmp / "state", tmp / "snapshot"
    jobs = [{"kind": "mesh_groups", "name": "groups", "devices": list(range(8)),
             "mesh": dict(dp=8)}]
    for name, (kind, fields, ranks, ref, extra) in CASES.items():
        config = {**FIELDS, **fields}
        if name == "state-tp2":
            config["kv_state_dir"] = str(state)
            extra = dict(extra, snapshot=str(snapshot))
        jobs.append({"kind": kind, "name": name, "devices": ranks, "config": config,
                     "model": model, "params": str(tmp / "params.npz"),
                     "prompts": REFS[ref][1], "max_new": MAX_NEW, **TIMEOUTS, **extra})
    box = {}

    def ranks():
        try:
            box["results"] = torch_ranks.run(8, jobs, tmp / "ranks", timeout=240,
                                             may_exit=(3,), nice=10)
        except BaseException as e:          # re-raised below, on the test's thread
            box["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        refs = {ref: _jax_streams({**FIELDS, **fields}, params, prompts, sequential)
                for ref, (fields, prompts, sequential) in REFS.items()}
    finally:
        thread.join(300)
    assert not thread.is_alive(), "rank runner did not return"
    if "error" in box:
        raise box["error"]
    return {"results": box["results"], "refs": refs, "params": params,
            "snapshot": str(snapshot)}


def _of(results, name, rank) -> dict:
    return {k[len(name) + 1:]: v for k, v in results[rank].items() if k.startswith(name + "/")}


def _leader(results, name) -> dict:
    return _of(results, name, CASES[name][2][0])


def test_a_serving_mesh_makes_its_own_groups_and_the_training_mesh_keeps_world(lives):
    """dp=8 over all eight ranks: the serving mesh's groups (its dp line,
    its own rank's group, control, pages) are none of them the default
    group, which carries the store and every later group; the training
    mesh of the same axes still takes the default group for the dp line."""
    for rank, got in lives["results"].items():
        groups = _of(lives["results"], "groups", rank)
        assert int(groups["serving/world_groups"]) == 0, rank
        assert int(groups["fresh/world_groups"]) == 0, rank
        assert int(groups["training/world_groups"]) == 1, rank


def test_a_remade_mesh_keeps_its_geometry_on_new_groups(lives):
    """lockstep.remake: the same device array, rank, device and key, the
    next life, no group shared with the old life, and each axis's group
    of the new life sums over its ranks (dp: 0 + ... + 7)."""
    for rank in lives["results"]:
        groups = _of(lives["results"], "groups", rank)
        assert np.array_equal(groups["fresh/devices"], groups["serving/devices"])
        assert np.array_equal(groups["serving/devices"].reshape(-1), np.arange(8))
        assert groups["same"].tolist() == [True] * 5, rank
        assert int(groups["shared_groups"]) == 0, rank
        assert groups["sums"].tolist() == [28.0, rank, rank, rank, rank]


@pytest.mark.parametrize("name", STALLS)
def test_a_wedged_mesh_restarts_into_its_next_life(lives, name):
    """A follower's step-stall holds the leader in a decode's collectives:
    the watchdog trips (health NOT_SERVING, watchdog_stall), the supervisor
    orphans the wedged engine and restarts the mesh once (engine_restart,
    polykey_engine_restarts_total 1, health SERVING), and the next life
    serves the JAX bucketed engine's greedy streams."""
    got = _leader(lives["results"], name)
    assert str(got["error"]).startswith("engine"), str(got["error"])
    assert int(got["restarts"]) == 1 and not bool(got["gave_up"])
    assert int(got["status"]) == SERVING and int(got["life"]) == 1
    assert json.loads(str(got["transitions"])) == ["NOT_SERVING", "SERVING"]
    events = json.loads(str(got["events"]))
    assert "watchdog_stall" in events and "engine_restart" in events
    assert str(got["restarts_total"]).endswith(" 1")
    assert list(got["errors"]) == [""] * len(PROMPTS)
    assert got["tokens"].tolist() == lives["refs"]["base"]


@pytest.mark.parametrize("name", STALLS)
def test_a_woken_orphan_changes_nothing_of_the_fresh_engine(lives, name):
    """The leader's orphan wakes when its collective on the old life's
    groups times out, raises and is reaped: the fresh engine's records,
    health and streams stay as they were."""
    got = _leader(lives["results"], name)
    assert bool(got["reaped"])
    before, after = got["records"].tolist()
    assert before == after > 0
    assert int(got["status_after_reap"]) == SERVING
    assert list(got["again_errors"]) == [""] * len(PROMPTS)
    assert got["again"].tolist() == lives["refs"]["base"]


@pytest.mark.parametrize("name", RESTARTED)
def test_every_rank_starts_the_next_life(lives, name):
    """Each follower takes its second life at the leader's word (orphaning
    its engine when it was still inside the old life) and hashes the same
    decode tokens as the leader's fresh engine."""
    results = lives["results"]
    ranks = CASES[name][2]
    lead = _of(results, name, ranks[0])
    assert str(lead["role"]) == "leader" and int(lead["blocks"]) > 0
    for r in ranks[1:]:
        got = _of(results, name, r)
        assert str(got["role"]) == "follower" and str(got["error"]) == ""
        assert int(got["lives"]) == 2, r
        assert str(got["digest"]) == str(lead["digest"]), r
        assert int(got["blocks"]) == int(lead["blocks"]), r


def test_one_replicas_mesh_restarts_while_the_other_serves(lives):
    """Replica 0's mesh ([0, 1]) fails inside a prefill's dispatch and
    starts its next life; replica 1 ([0, 2]) serves the JAX streams
    meanwhile and stays SERVING with no restart, and the pool's health
    never leaves SERVING; the pool serves the JAX streams before, during
    and after."""
    results = lives["results"]
    got = _leader(results, "replicas")
    assert "injected fault: prefill-error" in str(got["error"])
    assert list(got["errors"]) == [""] * (3 * len(PROMPTS))
    for key in ("first", "during", "after"):
        assert got[key].tolist() == lives["refs"]["base"], key
    assert got["restarts"].tolist() == [1, 0]
    assert got["states"].tolist() == ["SERVING", "SERVING"] and str(got["state0"]) == "SERVING"
    assert got["life"].tolist() == [1, 0]
    assert json.loads(str(got["transitions"])) == []
    assert int(_of(results, "replicas", 1)["lives"]) == 2
    assert int(_of(results, "replicas", 2)["lives"]) == 1


def test_the_other_replicas_ranks_make_no_group(lives):
    """Local synchronization: the restart's groups are made by replica 0's
    ranks alone. Rank 2 (replica 1's follower) makes none during the job;
    rank 1 makes its next life's."""
    results = lives["results"]
    assert int(_of(results, "replicas", 2)["groups_made"]) == 0
    assert int(_of(results, "replicas", 1)["groups_made"]) > 0
    assert int(_of(results, "replicas", 0)["groups_made"]) > 0


def test_a_state_dir_mesh_reloads_over_its_next_life(lives, tmp_path):
    """The host-tier mesh fails inside a prefill's dispatch after serving
    the sessions; its next life reloads the state dir (the whole pages cut
    to each rank over the new pages group), serves the JAX engine's
    streams, and reloads and hits as many pages and tokens as the
    single-card engine does on a copy of the same files."""
    got = _leader(lives["results"], "state-tp2")
    assert "injected fault: prefill-error" in str(got["error"])
    assert int(got["restarts"]) == 1 and int(got["status"]) == SERVING
    assert list(got["errors"]) == [""] * len(STICKY)
    assert got["tokens"].tolist() == lives["refs"]["host"]
    directory = str(tmp_path / "state")
    shutil.copytree(lives["snapshot"], directory)
    single = InferenceEngine(EngineConfig(**{**FIELDS, **HOST, "kv_state_dir": directory}),
                             params=params_from_numpy(lives["params"]), device="cpu")
    try:
        reloaded = single.stats()["kv_reloaded_pages"]
        assert _serve(single, GenRequest, STICKY, True) == lives["refs"]["host"]
        hits = single.stats()["prefix_host_hit_tokens"]
    finally:
        single.shutdown()
    assert int(got["reloaded"]) == reloaded > 0
    assert int(got["prefix_host_hit_tokens"]) == hits > 0


def test_a_lost_follower_ends_the_mesh_within_the_bound(lives):
    """The follower exits at its first decode record: the leader's engine
    fails, the factory cannot form the next life's groups and raises
    within REMAKE_TIMEOUT_S, the supervisor spends its one restart and
    gives up, and health stays NOT_SERVING; the leader's rank goes on to
    its next job."""
    got = _leader(lives["results"], "lost-tp2")
    assert str(got["error"]) != ""
    assert bool(got["gave_up"]) and int(got["restarts"]) == 0
    assert int(got["status"]) == NOT_SERVING
    failures = json.loads(str(got["failures"]))
    assert len(failures) == 1 and "did not all reach life 1" in failures[0], failures
    assert float(got["ended_s"]) < REMAKE_S + 10.0
    assert 3 not in lives["results"]
