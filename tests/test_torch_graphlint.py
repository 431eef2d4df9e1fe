"""The port's graphlint (polykey_tpu_torch/analysis/graph.py): a firing and
a clean fixture for every GL check, the suppression, baseline and CLI
machinery, and the real CPU engines under the checks, held to the JAX
package's tier where the two meet (the crossing census, GL001's executable
census). Case for case the counterpart of tests/test_graphlint.py; the
fixtures are injected here, never in the port's source."""

import contextlib
import json
import threading
from collections import Counter

import pytest
import torch
from polykey_tpu.analysis import graph as jax_graph

from polykey_tpu_torch.analysis import graph
from polykey_tpu_torch.analysis.core import (
    apply_baseline,
    load_baseline,
    write_baseline,
)
from polykey_tpu_torch.analysis.graph import (
    DtypeWalk,
    GraphEnv,
    PoolWatch,
    abstract_contract,
    apply_check_suppressions,
    crossing_census_findings,
    dtype_findings,
    gate_consistency_findings,
    graph_finding,
    instantiated_geometry,
    recompile_findings,
    refusal_findings,
    sharding_divisibility,
)
from polykey_tpu_torch.engine import engine as engine_mod
from polykey_tpu_torch.engine import host_guard
from polykey_tpu_torch.engine.graphs import CudaGraphs
from polykey_tpu_torch.engine.host_guard import HostSyncGuard, HostSyncTrip


# -- GL001: capture stability -------------------------------------------------


def _graphs(keys=((1,), (2,))):
    return CudaGraphs(torch.device("cpu"), {"b": (lambda k: torch.full((2,), k), keys)})


def test_undeclared_key_raises_on_the_cpu_as_on_the_card():
    graphs = _graphs()
    assert graphs.run("b", 1).tolist() == [1, 1]
    with pytest.raises(RuntimeError, match=r"no b graph for \(3,\)"):
        graphs.run("b", 3)
    assert graphs.eager == Counter({("b", (1,)): 1})
    assert graphs.refused == Counter({("b", (3,)): 1}) and graphs.eager_calls("b") == 1


@pytest.mark.parametrize("fault, key", [
    ("undeclared", ":b:undeclared"),
    ("capture", ":b:grew"),
    ("build", ":kernel-built"),
])
def test_gl001_fires_on_an_unstable_sweep(fault, key):
    from polykey_tpu_torch.ops import _build

    graphs = _graphs()

    def drive():
        graphs.run("b", 1)
        if fault == "undeclared":
            with contextlib.suppress(RuntimeError):
                graphs.run("b", 7)          # a shape the warm-up never covered
        elif fault == "capture":
            graphs.captures["b"] += 1       # a capture at serving time
        else:
            _build.loads += 1               # the library loaded mid-sweep
        return []

    loads = _build.loads
    try:
        findings, _ = recompile_findings("fixture", graphs, drive)
    finally:
        _build.loads = loads
    assert [f.snippet for f in findings] == ["fixture" + key]
    assert findings[0].rule == "GL001"


def test_gl001_clean_on_declared_keys():
    graphs = _graphs()

    def drive():
        for k in (1, 2, 1):
            graphs.run("b", k)
        return []

    findings, sizes = recompile_findings("fixture", graphs, drive)
    assert findings == []
    assert sizes["b"][0][0] == 2 and sizes["b"][1][3] == 3     # 2 keys, 3 calls


def test_gl001_fires_on_warmup_gap():
    findings, _ = recompile_findings("fixture", _graphs(keys=()), lambda: [])
    assert [f.snippet for f in findings] == ["fixture:b:cold"]


def test_gl001_surfaces_drive_errors_as_gl000():
    findings, _ = recompile_findings("fixture", _graphs(), lambda: ["engine wedged"])
    assert any(f.rule == "GL000" and "engine wedged" in f.message for f in findings)


# -- GL002: pools in place ----------------------------------------------------


def _watched(fn, pool):
    seen = Counter()
    with PoolWatch(pool.numel(), tuple(pool.shape[-3:]), seen):
        fn()
    return seen


def test_gl002_fires_on_a_pool_copy():
    pool = torch.zeros((2, 8, 4, 2, 16))
    seen = _watched(lambda: torch.cat([pool[:, :4], pool[:, 4:]], dim=1), pool)
    assert list(seen) == ["aten.cat.default(2, 8, 4, 2, 16)"]


def test_gl002_in_place_writes_and_activations_are_clean():
    pool = torch.zeros((2, 8, 4, 2, 16))
    idx = torch.tensor([1, 3])
    seen = _watched(lambda: (pool.index_copy_(1, idx, torch.ones((2, 2, 4, 2, 16))),
                             torch.zeros((64, 64)).exp(), pool[:, 1:3].clone()), pool)
    assert seen == Counter()


def test_gl002_fires_on_a_moved_buffer(monkeypatch):
    """A dispatch that rebuilds the decode lanes' buffer instead of writing
    it in place: the captured address goes stale."""
    env = GraphEnv(profile="smoke")
    try:
        engine = env.engine("engine.plain")
        original = engine_mod._retire_lane_fn

        def rebuild(state, slot):
            original(state, slot)
            state["seq_lens"] = state["seq_lens"].clone()

        monkeypatch.setattr(engine_mod, "_retire_lane_fn", rebuild)
        findings = graph._GRAPH_REGISTRY["GL002"].run(env)
    finally:
        env.close()
    assert [f.snippet for f in findings] == ["engine.plain:moved:lanes.seq_lens"]


def test_gl002_sweep_errors_are_blocking_gl000(monkeypatch):
    env = GraphEnv(profile="smoke")
    monkeypatch.setattr(env, "sweep", lambda engine, waves, guard=None: ["no such handle"])
    try:
        findings = graph._GRAPH_REGISTRY["GL002"].run(env)
    finally:
        env.close()
    assert [f.rule for f in findings] == ["GL000"]


# -- GL003: dtype policy ------------------------------------------------------

_W = (32, 64)


def _walk(fn, *args):
    walk = DtypeWalk()
    with walk:
        fn(*args)
    return walk.ops


def test_gl003_fires_on_weight_upcast_in_bf16_path():
    ops = _walk(lambda w, x: x @ w.float(),
                torch.zeros(_W, dtype=torch.bfloat16), torch.zeros((4, 32)))
    findings = dtype_findings("fixture", ops, {_W}, bf16_path=True)
    assert [f.snippet for f in findings] == [f"fixture:upcast:{_W}"]


def test_gl003_activation_upcast_does_not_fire():
    def fn(w, x):
        h = (x.float() ** 2).to(torch.bfloat16)      # fp32 norm-style work
        return h @ w

    ops = _walk(fn, torch.zeros(_W, dtype=torch.bfloat16),
                torch.zeros((4, 32), dtype=torch.bfloat16))
    assert dtype_findings("fixture", ops, {_W}, bf16_path=True) == []


def test_gl003_fires_on_f64_anywhere():
    ops = _walk(lambda x: x.double() * 2.0, torch.zeros(8))
    findings = dtype_findings("fixture", ops, set(), bf16_path=False)
    assert [f.snippet for f in findings] == ["fixture:f64:aten._to_copy.default"]


def test_gl003_walks_nested_bodies():
    """The f64 hides inside a graph body that the CPU runs through
    `CudaGraphs.run` and a loop of it: the walk sees every op."""
    def body(n):
        acc = torch.zeros(())
        for _ in range(n):
            acc = acc + torch.ones(3).to(torch.float64).sum().float()
        return acc

    graphs = CudaGraphs(torch.device("cpu"), {"scan": (body, [(3,)])})
    ops = _walk(lambda: graphs.run("scan", 3))
    assert any(":f64:" in f.snippet for f in dtype_findings("fixture", ops, set(), False))


def test_gl003_real_steps_hold_the_policy_but_the_baselined_sampler():
    """One dispatch of each step at the smoke geometry: the only findings
    are the sampler's float64 uniforms, baselined with their reason."""
    env = GraphEnv(profile="smoke")
    findings = graph._GRAPH_REGISTRY["GL003"].run(env)
    assert findings and all(f.snippet.endswith(":f64:aten.to.dtype") for f in findings)
    assert {f.path.split(".")[-1] for f in findings} == {
        "_prefill_fn", "_decode_fn", "_ragged_fn", "spec_decode_fn", "ragged_spec_fn"}


# -- GL004: host-sync guard ---------------------------------------------------


def test_gl004_fires_on_a_debug_read_in_a_step():
    trips = []

    def step(x):
        print("x =", x.sum().item())            # a debug print of a value
        return x + 1

    with pytest.raises(HostSyncTrip), HostSyncGuard(trips):
        step(torch.ones(4))
    assert len(trips) == 1 and "_local_scalar_dense" in trips[0]


@pytest.mark.parametrize("read", [
    lambda x: bool(x[0] > 0), lambda x: torch.equal(x, x), lambda x: x[x > 0],
    lambda x: torch.nonzero(x),
])
def test_gl004_guard_refuses_every_host_read(read):
    with pytest.raises(HostSyncTrip), HostSyncGuard():
        read(torch.ones(4))


def test_gl004_clean_on_pure_step_and_sanctioned_scope():
    trips = []
    with HostSyncGuard(trips):
        y = torch.ones(4) * 2 + 1
        with engine_mod._host_crossing("fixture-site"):
            assert int(y[0]) == 3               # sanctioned: no trip
    assert trips == [] and not host_guard.OPEN


def test_host_crossing_fast_path_until_a_guard_opens():
    """With no guard open the scope is the shared no-op context (one test);
    with one open on another thread it is still a no-op here, and on the
    guard's own thread it lifts the guard."""
    assert engine_mod._host_crossing("x") is engine_mod._NO_GUARD
    opened, release = threading.Event(), threading.Event()

    def hold():
        with HostSyncGuard():
            opened.set()
            release.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    opened.wait(10)
    try:
        assert host_guard.OPEN
        with engine_mod._host_crossing("x"):
            assert int(torch.ones(1)[0]) == 1   # no guard on this thread
    finally:
        release.set()
        t.join()
    with HostSyncGuard():
        assert engine_mod._host_crossing("x") is not engine_mod._NO_GUARD


def test_gl004_one_guard_a_thread():
    """A second guard on a thread that holds one is refused, and the first
    stays in force."""
    with HostSyncGuard():
        with pytest.raises(RuntimeError, match="already entered"):
            with HostSyncGuard():
                pass
        with pytest.raises(HostSyncTrip):
            int(torch.ones(1)[0])
    assert getattr(host_guard._THREAD, "guard", None) is None and not host_guard.OPEN


def test_gl004_census_fires_on_new_and_missing_sites():
    expected = frozenset({"a", "b"})
    findings, deltas = crossing_census_findings(
        "fixture", {"a": 1}, {"a": 3, "c": 1}, expected)
    assert deltas == {"a": 2, "c": 1}
    assert sorted((f.rule, f.snippet) for f in findings) == [
        ("GL000", "fixture:census-not-exercised:b"), ("GL004", "fixture:census:c")]
    assert crossing_census_findings("fixture", {}, {"a": 1, "b": 1}, expected)[0] == []


def test_gl004_trips_without_host_crossing_annotations(monkeypatch):
    """Take the engine's scopes away: the guarded sweep must trip (the first
    token's read on the host is a `_local_scalar_dense`); a sacrificial
    engine."""
    monkeypatch.setattr(engine_mod, "_host_crossing",
                        lambda site="unlabeled": contextlib.nullcontext())
    env = GraphEnv(profile="smoke")
    try:
        findings = graph._GRAPH_REGISTRY["GL004"].run(env)
    finally:
        env.close()
    assert any(f.rule == "GL004" and ":trip:" in f.snippet for f in findings)
    assert env.trips and not host_guard.OPEN


# -- GL005: shape/layout contracts --------------------------------------------


def test_gl005_fires_on_indivisible_sharded_dim():
    findings = sharding_divisibility("fixture", (4, 3), (None, "tp"), {"tp": 2})
    assert len(findings) == 1 and findings[0].rule == "GL005"
    assert "3 % 2" in findings[0].message


def test_gl005_clean_on_divisible_sharded_dim():
    assert sharding_divisibility("fixture", (4, 6), (None, ("dp", "tp")),
                                 {"tp": 2, "dp": 3}) == []


def test_gl005_abstract_contract_fires_on_mismatch():
    findings = abstract_contract("fixture", lambda x: x[:2],
                                 (torch.empty((4, 4), device="meta"),), [((4, 4), "float32")])
    assert [f.snippet for f in findings] == ["fixture:out-contract"]


def test_gl005_abstract_contract_fires_on_trace_error():
    def broken(x):
        raise ValueError("block shape does not divide grid")

    findings = abstract_contract("fixture", broken, (torch.empty(4, device="meta"),),
                                 [((4,), "float32")])
    assert [f.snippet for f in findings] == ["fixture:abstract-eval"]


def test_gl005_abstract_contract_clean_and_no_launch():
    from polykey_tpu_torch.ops import flash_attention as fa

    meta = dict(device="meta", dtype=torch.bfloat16)
    before = fa.KERNEL.launches
    q = torch.empty((1, 128, 8, 128), **meta)
    kv = torch.empty((1, 256, 2, 128), **meta)
    pos = torch.empty((1, 128), device="meta", dtype=torch.int32)
    assert abstract_contract("fixture", lambda *a: fa.flash_attention_cuda(*a, scale=0.1),
                             (q, kv, kv, pos), [((1, 128, 8, 128), "bfloat16")]) == []
    assert fa.KERNEL.launches == before
    # A geometry the template lacks is refused, not launched.
    q16 = torch.empty((1, 128, 8, 16), **meta)
    kv16 = torch.empty((1, 256, 2, 16), **meta)
    assert refusal_findings("fixture", lambda *a: fa.flash_attention_cuda(*a, scale=0.1),
                            (q16, kv16, kv16, pos)) == []


def test_gl005_gate_consistency_firing_and_clean(monkeypatch):
    from dataclasses import replace

    from polykey_tpu_torch.models.config import TINY_LLAMA
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    geo = instantiated_geometry()
    assert geo["decode_dims"] == pak.DECODE_HEAD_DIMS == frozenset({64, 128, 256})
    assert gate_consistency_findings([TINY_LLAMA]) == []
    # A gate that admits head_dim 16, which no template instantiates.
    monkeypatch.setattr(pak, "DECODE_HEAD_DIMS", frozenset({16, 64, 128, 256}))
    findings = gate_consistency_findings([replace(TINY_LLAMA, name="bad-geom")])
    assert {f.snippet for f in findings} >= {
        "constant:DECODE_HEAD_DIMS", "paged-gate:bad-geom", "paged-int8-gate:bad-geom"}


def test_gl005_real_contracts_hold():
    env = GraphEnv(profile="smoke")
    assert graph._GRAPH_REGISTRY["GL005"].run(env) == []


# -- suppressions + baseline --------------------------------------------------


def test_check_suppression_marks_finding(monkeypatch):
    finding = graph_finding("GL003", "graph:x", "x:upcast:(1, 2)", "msg")
    monkeypatch.setattr(graph._GRAPH_REGISTRY["GL003"], "SUPPRESSIONS",
                        {"x:upcast:(1, 2)": "reviewed: deliberate f32 residual"})
    out = apply_check_suppressions([finding])
    assert out[0].suppressed and "reviewed" in out[0].reason and not out[0].blocking


def test_unsuppressed_finding_stays_blocking():
    out = apply_check_suppressions([graph_finding("GL001", "graph:x", "x:key", "msg")])
    assert not out[0].suppressed and out[0].blocking


def test_graph_findings_roundtrip_the_baseline(tmp_path):
    findings = [graph_finding("GL001", "graph:engine.plain", "k1", "grew"),
                graph_finding("GL002", "graph:engine.plain", "k2", "moved")]
    path = tmp_path / "torch-graphlint-baseline.json"
    assert write_baseline(path, findings) == 2
    marked, stale = apply_baseline(findings, load_baseline(path))
    assert all(f.baselined for f in marked) and stale == []
    marked, stale = apply_baseline(findings[:1], load_baseline(path))
    assert len(stale) == 1


def test_committed_baseline_entries_carry_a_reason_and_a_roadmap_item():
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    entries = load_baseline(root / graph.GRAPH_BASELINE)["findings"]
    roadmap = (root / "ROADMAP.md").read_text()
    for entry in entries.values():
        assert entry["reason"] and entry["roadmap"] in roadmap
        assert "torch-graphlint-baseline" in roadmap


def _cli(monkeypatch, findings):
    monkeypatch.setattr(graph, "run_graph_checks", lambda env, only=None: (findings, env))


def test_cli_list_checks(capsys):
    assert graph.main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    assert all(f"GL00{i}" in out for i in range(1, 6))


@pytest.mark.parametrize("argv, exit_code, said", [
    (["--only", "GL01,GL004"], 2, "unknown check id"),
    (["--only", "GL003", "--prune"], 2, "full run"),
    (["--only", "GL003", "--write-baseline"], 2, "full run"),
    (["--profile", "tiny"], 2, "invalid choice"),
])
def test_cli_usage_errors(capsys, argv, exit_code, said):
    assert graph.main(argv) == exit_code
    assert said in capsys.readouterr().err


def test_module_entry_refuses_other_tiers(capsys):
    from polykey_tpu_torch.analysis.__main__ import main

    assert main(["race"]) == 2 and "graph" in capsys.readouterr().err


@pytest.mark.parametrize("flag, refusal", [("--write-baseline", "refusing to write"),
                                           ("--prune", "refusing to prune")])
def test_cli_baseline_changes_refuse_gl000(tmp_path, monkeypatch, capsys, flag, refusal):
    path = tmp_path / graph.GRAPH_BASELINE
    write_baseline(path, [graph_finding("GL001", "graph:engine.plain", "k1", "grew")])
    _cli(monkeypatch, [graph_finding("GL000", "graph:GL001", "GL001:crashed", "probe gone"),
                       graph_finding("GL005", "graph:flash", "k5", "bad block")])
    assert graph.main(["--root", str(tmp_path), flag]) == 1
    assert refusal in capsys.readouterr().err
    entries = load_baseline(path)["findings"]
    assert [e["rule"] for e in entries.values()] == ["GL001"]      # untouched


def test_cli_only_does_not_report_unrun_checks_stale(tmp_path, monkeypatch, capsys):
    write_baseline(tmp_path / graph.GRAPH_BASELINE,
                   [graph_finding("GL001", "graph:engine.plain", "k1", "grew")])
    _cli(monkeypatch, [])
    assert graph.main(["--root", str(tmp_path), "--only", "GL003", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["summary"]["stale_baseline_entries"] == []


def test_cli_prune_drops_stale_graph_entries(tmp_path, monkeypatch, capsys):
    findings = [graph_finding("GL001", "graph:engine.plain", "k1", "grew"),
                graph_finding("GL002", "graph:engine.plain", "k2", "moved")]
    path = tmp_path / graph.GRAPH_BASELINE
    assert write_baseline(path, findings) == 2
    _cli(monkeypatch, findings[:1])
    assert graph.main(["--root", str(tmp_path), "--prune"]) == 0
    assert "pruned 1 stale" in capsys.readouterr().out
    assert len(load_baseline(path)["findings"]) == 1


def test_cli_exit_codes_follow_blocking_findings(tmp_path, monkeypatch, capsys):
    _cli(monkeypatch, [graph_finding("GL004", "graph:x", "k", "trip")])
    assert graph.main(["--root", str(tmp_path), "--no-baseline"]) == 1
    _cli(monkeypatch, [])
    assert graph.main(["--root", str(tmp_path)]) == 0
    assert "0 blocking" in capsys.readouterr().out


# -- integration: the real checks on the smoke engine -------------------------


@pytest.fixture(scope="module")
def smoke_env():
    env = GraphEnv(profile="smoke")
    yield env
    env.close()


def test_gl001_real_engine_is_capture_stable(smoke_env):
    findings = graph._GRAPH_REGISTRY["GL001"].run(smoke_env)
    assert findings == [], [f.render() for f in findings]


def test_gl002_real_pools_stay_in_place(smoke_env):
    findings = graph._GRAPH_REGISTRY["GL002"].run(smoke_env)
    assert findings == [], [f.render() for f in findings]


def test_gl004_guard_smoke_clean_and_guard_restored(smoke_env):
    findings = graph._GRAPH_REGISTRY["GL004"].run(smoke_env)
    assert findings == [], [f.render() for f in findings]
    engine = smoke_env.engine("engine.plain")
    assert engine.loop_guard is None and not host_guard.OPEN
    assert getattr(host_guard._THREAD, "guard", None) is None
    assert engine._depth == engine.config.lookahead_blocks


def test_gl001_census_beside_the_jax_executables(smoke_env):
    """On the smoke config the JAX executables are exactly the port keys
    the JAX warm-up reaches: greedy variants only
    (warm_sampled_variants=False), group pads the 2 slots reach (1, 2);
    merge and retire have no port graph (eager writes)."""
    jax_graph._ensure_cpu_backend()
    jax_env = jax_graph.GraphEnv(profile="smoke")
    try:
        assert jax_graph._GRAPH_REGISTRY["GL001"].run(jax_env) == []
        handles = jax_env.jit_handles(jax_env.plain_engine())
        executables = {name: h._cache_size() for name, h in handles.items()}
    finally:
        jax_env.close()
    graphs = smoke_env.engine("engine.plain")._graphs
    slots = smoke_env.config("engine.plain").max_decode_slots
    reached = {"decode": [k for k in graphs.keys("decode") if k[0]],
               "prefill": [k for k in graphs.keys("prefill")
                           if k[2] and k[1] <= max(2, slots)]}
    for body, keys in reached.items():
        assert len(keys) == executables[graph.JAX_HANDLES[body]], (body, executables)
    assert len(graphs.keys("decode")) == 2 * executables["_jit_decode"]
    assert set(executables) - set(graph.JAX_HANDLES.values()) == {"_jit_merge", "_jit_retire"}
    # GL001 writes the bodies' census; on a worker where its own test ran
    # elsewhere, run it here (GL004 alone leaves only the crossings).
    if "decode" not in smoke_env.census.get("engine.plain", {}):
        assert graph._GRAPH_REGISTRY["GL001"].run(smoke_env) == []
    census = smoke_env.census["engine.plain"]
    assert {b: c["reference"] for b, c in census.items() if b != "crossings"} == {
        "decode": "_jit_decode", "prefill": "_jit_prefill"}


# -- the full profile: the gate, and the census against the JAX package -------


def test_full_graphlint_self_run_clean_and_census_held_to_the_jax_tier():
    """What `make port-lint` gates on: every check, the full profile, no
    blocking finding past the committed baseline; every engine mode's
    fired crossing sites are the JAX package's SANCTIONED_CROSSINGS entry
    plus the port's stated differences."""
    import pathlib

    assert graph.REFERENCE_CROSSINGS == jax_graph.SANCTIONED_CROSSINGS
    findings, env = graph.run_graph_checks(GraphEnv())
    try:
        root = pathlib.Path(__file__).resolve().parents[1]
        findings, _ = apply_baseline(findings, load_baseline(root / graph.GRAPH_BASELINE))
        blocking = [f.render() for f in findings if f.blocking]
        assert blocking == []
        for mode, sites in jax_graph.SANCTIONED_CROSSINGS.items():
            fired = set(env.census[mode]["crossings"])
            assert fired == set(sites) | set(graph.CROSSING_DIFFERENCES.get(mode, {})), mode
        assert env.trips == []
    finally:
        env.close()
