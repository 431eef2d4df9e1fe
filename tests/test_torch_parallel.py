"""The port's parallel layer (polykey_tpu_torch.parallel, ops/ring_attention,
ops/ulysses_attention) against the JAX package on the CPU.

One 8-rank gloo group runs every multi-rank case once for the module
(tests/torch_ranks.py, no JAX in the ranks); the JAX references are
computed here on the 8 simulated CPU devices while the ranks run, and each
test reads its own part of the results. Inputs are made from seeds with
numpy / jax.random and handed over as .npz files; parameters and
gradients go through models/interop.params_from_numpy.

Tolerances (fp32 throughout): sharded logits within 2e-4 of the
single-device JAX forward (3e-4 for MoE), as the reference's own sharding
tests; ring / Ulysses outputs and q/k/v gradients within 2e-5 of the JAX
spmd functions' (the reference's ring tests' TOL); the pipeline's hidden
states and gradients within 2e-5 / 1e-4 of the unsharded JAX stack's.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from polykey_tpu.models import quant as jquant
from polykey_tpu.models import transformer as jtf
from polykey_tpu.models.config import TINY_GEMMA, TINY_LLAMA, TINY_MIXTRAL
from polykey_tpu.ops.ring_attention import ring_attention_spmd as j_ring
from polykey_tpu.ops.ulysses_attention import ulysses_attention_spmd as j_ulysses
from polykey_tpu.parallel import sharding as jsharding
from polykey_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh as j_create_mesh
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.parallel import sharding as tsharding
from polykey_tpu_torch.parallel.distributed import initialize_from_env
from polykey_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh, MeshConfig, create_mesh

CFG = dataclasses.replace(TINY_LLAMA, hidden_size=128, intermediate_size=256, num_heads=8,
                          num_kv_heads=4, head_dim=16)
MOE_CFG = dataclasses.replace(TINY_MIXTRAL, hidden_size=128, intermediate_size=256, num_heads=8,
                              num_kv_heads=4, head_dim=16)
MOE_DISPATCH_CFG = dataclasses.replace(MOE_CFG, moe_dispatch=True)
PIPE_CFG = TINY_GEMMA        # 2 layers: stage 1's only layer is global layer 1

FORWARDS = {                        # mesh, ranks, config, params and batch (.npz), reference
    "tp4": (dict(tp=4), range(0, 4), CFG, "dense", "batch", "dense"),
    "dp2xtp2": (dict(dp=2, tp=2), range(4, 8), CFG, "dense", "batch", "dense"),
    "pp2xtp2": (dict(pp=2, tp=2), range(0, 4), CFG, "dense", "batch", "dense"),
    # Tied embeddings split over tp at both ends, soft-caps, post-norms,
    # windowed layers past the window.
    "gemma-dp2xtp2": (dict(dp=2, tp=2), range(4, 8), PIPE_CFG, "pipe", "pipe_batch", "gemma"),
    "moe-dispatch-ep2xtp2": (dict(ep=2, tp=2), range(0, 4), MOE_DISPATCH_CFG, "moe", "batch",
                             "moe-dispatch"),
    "moe-dp2xep2xtp2": (dict(dp=2, ep=2, tp=2), range(0, 8), MOE_CFG, "moe", "batch", "moe"),
}
DP2SP2, SP4 = dict(dp=2, sp=2), dict(sp=4)
ATTENTION = {                       # (impl, soft-cap, window, mesh) on 4 ranks
    "ring": ("ring", None, None, DP2SP2),
    "ring-softcap-window": ("ring", 5.0, 12, DP2SP2),
    "ulysses": ("ulysses", None, None, DP2SP2),
    "ulysses-softcap-window": ("ulysses", 5.0, 12, DP2SP2),
    # Four ranks around the ring: a gradient rotated the wrong way shows.
    "ring-sp4-softcap-window": ("ring", 5.0, 12, SP4),
}
PIPELINES = {"pp2": (dict(pp=2), range(0, 2)), "pp2xtp2": (dict(pp=2, tp=2), range(4, 8))}
B, T = 4, 16
ATT_SHAPE = (2, 32, 4, 2, 16)       # B, T, Hq, Hk, D
PIPE_T = 32                         # past tiny-gemma's window of 16


def _layout_mesh(shape: dict, rank: int = 0) -> Mesh:
    """A mesh that places shards but cannot communicate."""
    dims = tuple(shape.get(a, 1) for a in AXIS_NAMES)
    return Mesh(np.arange(int(np.prod(dims))).reshape(dims), rank)


def _logits(cfg, params, tokens, positions):
    return jtf.unembed(params, cfg, jtf.forward(params, cfg, tokens, positions, None)[0])


def _write_inputs(tmp) -> dict:
    """Every rank input as .npz: the JAX package's initial parameters and
    the seeded batches. Returns what the references need."""
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, T), 0, CFG.vocab_size),
                        np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    np.savez(tmp / "batch.npz", tokens=tokens, positions=positions)
    ctx = {"tokens": tokens, "positions": positions}
    for name, cfg, seed in (("dense", CFG, 0), ("moe", MOE_CFG, 2), ("pipe", PIPE_CFG, 3)):
        ctx[name] = jtf.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
        torch_ranks.save_tree(tmp / f"{name}.npz", jax.device_get(ctx[name]))

    rs = np.random.RandomState(7)
    Bq, Tq, Hq, Hk, D = ATT_SHAPE
    att = dict(q=rs.randn(Bq, Tq, Hq, D), k=rs.randn(Bq, Tq, Hk, D), v=rs.randn(Bq, Tq, Hk, D),
               ct=rs.randn(Bq, Tq, Hq, D))
    att = {k: v.astype(np.float32) for k, v in att.items()}
    att["pos"] = np.broadcast_to(np.arange(Tq, dtype=np.int32), (Bq, Tq)).copy()
    np.savez(tmp / "attention.npz", **att)
    ctx["att"] = att

    ptok = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (B, PIPE_T), 0,
                                         PIPE_CFG.vocab_size), np.int32)
    ppos = np.broadcast_to(np.arange(PIPE_T, dtype=np.int32), (B, PIPE_T)).copy()
    ct = np.random.RandomState(5).randn(B, PIPE_T, PIPE_CFG.hidden_size).astype(np.float32)
    np.savez(tmp / "pipe_batch.npz", tokens=ptok, positions=ppos, ct=ct)
    ctx["pipe_batch"] = (ptok, ppos, ct)
    return ctx


def _jax_refs(ctx) -> dict:
    refs = {}
    tokens, positions = ctx["tokens"], ctx["positions"]
    for name, cfg, key in (("dense", CFG, "dense"), ("moe", MOE_CFG, "moe"),
                           ("moe-dispatch", MOE_DISPATCH_CFG, "moe")):
        refs[f"logits/{name}"] = np.asarray(jax.jit(
            lambda p, t, pos, c=cfg: _logits(c, p, t, pos))(ctx[key], tokens, positions))
    ptok, ppos, _ = ctx["pipe_batch"]
    refs["logits/gemma"] = np.asarray(jax.jit(
        lambda p, t, pos: _logits(PIPE_CFG, p, t, pos))(ctx["pipe"], ptok, ppos))

    att = ctx["att"]
    for name, (impl, softcap, window, shape) in ATTENTION.items():
        fn = j_ring if impl == "ring" else j_ulysses
        mesh = j_create_mesh(JMeshConfig(**shape), jax.devices()[:4])

        def f(q, k, v, fn=fn, softcap=softcap, window=window, mesh=mesh):
            return fn(q, k, v, att["pos"], att["pos"], mesh, scale=0.25, logit_softcap=softcap,
                      window=None if window is None else jnp.int32(window))

        out, vjp = jax.vjp(jax.jit(f), att["q"], att["k"], att["v"])
        dq, dk, dv = vjp(jnp.asarray(att["ct"]))
        refs.update({f"{name}/out": out, f"{name}/dq": dq, f"{name}/dk": dk, f"{name}/dv": dv})

    ptok, ppos, ct = ctx["pipe_batch"]

    def hidden(p):
        return jtf.forward(p, PIPE_CFG, ptok, ppos, None)[0]

    refs["pipe/hidden"] = np.asarray(jax.jit(hidden)(ctx["pipe"]))
    grads = jax.jit(jax.grad(lambda p: jnp.sum(hidden(p) * ct)))(ctx["pipe"])
    refs["pipe/grads"] = torch_ranks.flat_params(params_from_numpy(jax.device_get(grads)))
    return {k: np.asarray(v) if not isinstance(v, dict) else v for k, v in refs.items()}


def _jobs(tmp):
    jobs = [{"kind": "bootstrap", "name": "bootstrap", "devices": None}]
    for name, (mesh, devices, cfg, params, batch, _) in FORWARDS.items():
        jobs.append({"kind": "forward", "name": name, "mesh": mesh, "devices": list(devices),
                     "cfg": torch_ranks.config_fields(cfg), "micro": 2,
                     "params": str(tmp / f"{params}.npz"), "batch": str(tmp / f"{batch}.npz")})
    for i, (name, (impl, softcap, window, shape)) in enumerate(ATTENTION.items()):
        jobs.append({"kind": "attention", "name": name, "mesh": shape,
                     "devices": list(range(4 * (i % 2), 4 * (i % 2) + 4)), "impl": impl,
                     "softcap": softcap, "window": window, "scale": 0.25,
                     "inputs": str(tmp / "attention.npz")})
    for name, (mesh, devices) in PIPELINES.items():
        jobs.append({"kind": "pipeline", "name": name, "mesh": mesh, "devices": list(devices),
                     "cfg": torch_ranks.config_fields(PIPE_CFG), "micro": 2,
                     "params": str(tmp / "pipe.npz"), "batch": str(tmp / "pipe_batch.npz")})
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, JAX references): the inputs are written first, then
    the ranks run while the JAX references are computed here."""
    tmp = tmp_path_factory.mktemp("parallel")
    ctx = _write_inputs(tmp)
    box = {}

    def ranks():
        try:
            box["results"] = torch_ranks.run(8, _jobs(tmp), tmp / "ranks", timeout=240)
        except BaseException as e:          # re-raised below, on the test's thread
            box["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        refs = _jax_refs(ctx)
    finally:
        thread.join(300)
    assert not thread.is_alive(), "rank runner did not return"
    if "error" in box:
        raise box["error"]
    return box["results"], refs


# -- specs -------------------------------------------------------------------


def _jax_tree(cfg, bits):
    params = jtf.init_params(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    return params if bits is None else jquant.quantize_params(params, cfg, bits)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("cfg", [TINY_LLAMA, TINY_MIXTRAL, TINY_GEMMA], ids=lambda c: c.name)
def test_spec_of_every_leaf_matches_reference(cfg, bits):
    jtree = _jax_tree(cfg, bits)
    jmesh = j_create_mesh(JMeshConfig(tp=2), jax.devices()[:2])
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = jsharding._path_keys(path)
        want[keys] = tuple(jsharding._spec_for_path(keys, leaf, jmesh))
    ttree = params_from_numpy(jax.device_get(jtree))
    specs = tsharding.param_shardings(cfg, _layout_mesh({"tp": 2}), ttree)
    got = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            walk(node[0], path)
        elif isinstance(node, tuple):
            got[path] = tuple(node)
        else:                                # a QuantizedTensor's specs
            got[path + ("q",)], got[path + ("s",)] = tuple(node.q), tuple(node.s)

    walk(specs, ())
    assert got == want


def test_cache_and_batch_specs_match_reference():
    jmesh = j_create_mesh(JMeshConfig(tp=2), jax.devices()[:2])
    pairs = [
        (jsharding.paged_kv_sharding(jmesh), tsharding.paged_kv_spec()),
        (jsharding.paged_kv_scale_sharding(jmesh), tsharding.paged_kv_scale_spec()),
        (jsharding.contiguous_kv_sharding(jmesh), tsharding.contiguous_kv_spec()),
        (jsharding.batch_sharding(jmesh, 2), tsharding.batch_spec(2)),
        (jsharding.batch_sharding(jmesh, 3, seq_axis=1), tsharding.batch_spec(3, seq_axis=1)),
    ]
    for named, spec in pairs:
        assert tuple(named.spec) == tuple(spec)


def test_shards_are_local_slices_and_whole_leaves_are_shared():
    """tp=4 splits wq's columns four ways; on a one-rank mesh every shard
    is the caller's own tensor (no copy)."""
    params = params_from_numpy(jax.device_get(jtf.init_params(jax.random.PRNGKey(0), CFG,
                                                              jnp.float32)))
    wq = params["layers"][0]["attn"]["wq"]
    for r in range(4):
        local = tsharding.shard_params(params, CFG, _layout_mesh({"tp": 4}, r))
        got = local["layers"][0]["attn"]["wq"]
        assert got.shape == (wq.shape[0], wq.shape[1] // 4)
        torch.testing.assert_close(got, wq[:, r * 32:(r + 1) * 32], rtol=0, atol=0)
        assert local["embed"].shape[0] == CFG.vocab_size // 4
    whole = tsharding.shard_params(params, CFG, _layout_mesh({}))
    assert whole["layers"][1]["mlp"]["down"] is params["layers"][1]["mlp"]["down"]
    assert whole["embed"] is params["embed"]


def test_pp_takes_a_run_of_layers():
    params = params_from_numpy(jax.device_get(jtf.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(CFG, num_layers=4), jnp.float32)))
    cfg4 = dataclasses.replace(CFG, num_layers=4)
    for stage in range(2):
        local = tsharding.shard_params(params, cfg4, _layout_mesh({"pp": 2}, stage))
        assert [id(layer["ln1"]) for layer in local["layers"]] == [
            id(layer["ln1"]) for layer in params["layers"][2 * stage:2 * stage + 2]]
    with pytest.raises(ValueError, match="must divide num_layers"):
        tsharding.shard_params(params, cfg4, _layout_mesh({"pp": 3}))


def test_mesh_validation():
    with pytest.raises(ValueError, match="needs 3 devices, have 8"):
        create_mesh(MeshConfig(tp=3), devices=range(8))


# -- bootstrap ----------------------------------------------------------------


_BOOT_KEYS = ("POLYKEY_COORDINATOR", "POLYKEY_NUM_PROCESSES", "POLYKEY_PROCESS_ID")


def test_initialize_from_env_is_noop_without_config(monkeypatch):
    for k in _BOOT_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert initialize_from_env() is False


@pytest.mark.parametrize("env", [
    {"POLYKEY_PROCESS_ID": "0"},
    {"POLYKEY_COORDINATOR": "localhost:9999"},
    {"POLYKEY_COORDINATOR": "localhost:9999", "POLYKEY_NUM_PROCESSES": "2",
     "POLYKEY_PROCESS_ID": ""},
    {"POLYKEY_COORDINATOR": "localhost:9999", "POLYKEY_NUM_PROCESSES": "two",
     "POLYKEY_PROCESS_ID": "0"},
], ids=["lone-rank", "lone-coordinator", "empty-rank", "non-integer-count"])
def test_initialize_from_env_partial_config_raises(monkeypatch, env):
    for k in _BOOT_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="partial distributed config"):
        initialize_from_env()


_ONE_RANK = r"""
import os, socket
import torch
import torch.distributed as dist
from polykey_tpu_torch.parallel.collectives import all_reduce
from polykey_tpu_torch.parallel.distributed import initialize_from_env, mesh_from_env
from polykey_tpu_torch.parallel.mesh import AXIS_NAMES, single_device_mesh
one = single_device_mesh(device="cpu")           # brings up its own in-process group
print(one.devices.shape, float(all_reduce(torch.ones(()), one, AXIS_NAMES)), flush=True)
dist.destroy_process_group()
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
os.environ.update(POLYKEY_COORDINATOR=f"127.0.0.1:{port}", POLYKEY_NUM_PROCESSES="1",
                  POLYKEY_PROCESS_ID="0")
first, again = initialize_from_env(device="cpu"), initialize_from_env(device="cpu")
mesh = mesh_from_env(device="cpu")
print(first, again, dist.get_backend(), dist.get_world_size(), mesh.devices.shape, flush=True)
dist.destroy_process_group()
"""


def test_one_rank_bring_up():
    """In a fresh process: single_device_mesh over its own in-process
    group (a collective over every axis is one over a group of one), then
    the explicit env path for real: a one-rank gloo group over TCP at the
    coordinator, a second call a no-op, and the mesh from the env."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in _BOOT_KEYS}
    out = subprocess.run([sys.executable, "-c", _ONE_RANK], env=dict(env, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["(1, 1, 1, 1, 1) 1.0",
                                       "True True gloo 1 (1, 1, 1, 1, 1)"]


def test_hybrid_mesh_folds_slices_into_dp(runs):
    results, _ = runs
    devices = results[0]["bootstrap/hybrid_devices"]
    assert dict(zip(AXIS_NAMES, devices.shape)) == {"dp": 4, "pp": 1, "sp": 1, "ep": 1, "tp": 2}
    # Slice s holds ranks 4s..4s+3, dp outermost: the reference's layout.
    np.testing.assert_array_equal(devices.reshape(4, 2), np.arange(8).reshape(4, 2))
    assert all(float(r["bootstrap/hybrid_sum"]) == sum(range(8)) for r in results.values())


def test_hybrid_mesh_single_slice_is_plain_mesh(runs):
    results, _ = runs
    single = results[0]["bootstrap/single_devices"]
    assert single.shape == (2, 1, 1, 1, 2)
    assert int(results[5]["bootstrap/single_devices"]) == -1      # outside it


def test_hybrid_mesh_device_count_validation(runs):
    results, _ = runs
    assert "hybrid mesh needs" in str(results[0]["bootstrap/validation"])


def test_mesh_from_env(runs):
    """POLYKEY_TP=2, POLYKEY_NUM_SLICES=2 over 8 ranks: dp absorbs the rest
    (8 / (tp 2 x slices 2) = 2 a slice -> dp 4)."""
    results, _ = runs
    devices = results[3]["bootstrap/env_devices"]
    assert devices.shape[0] == 4 and devices.shape[-1] == 2


# -- sharded forwards ----------------------------------------------------------


@pytest.mark.parametrize("name", list(FORWARDS))
def test_sharded_forward_matches_single_device(runs, name):
    results, refs = runs
    mesh, devices, cfg, _, _, ref_name = FORWARDS[name]
    ref = refs[f"logits/{ref_name}"]
    tol = 3e-4 if cfg.is_moe else 2e-4
    rows = B // mesh.get("dp", 1)
    for r in devices:
        got = results[r][f"{name}/logits"]
        d = int(results[r][f"{name}/dp"])
        np.testing.assert_allclose(got, ref[d * rows:(d + 1) * rows], rtol=tol, atol=tol,
                                   err_msg=f"rank {r}")


# -- ring and Ulysses ---------------------------------------------------------


@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
@pytest.mark.parametrize("name", list(ATTENTION))
def test_sequence_parallel_attention_matches_reference(runs, name, what):
    results, refs = runs
    i = list(ATTENTION).index(name)
    shape = ATTENTION[name][3]
    Bq, Tq = ATT_SHAPE[:2]
    got = np.zeros_like(refs[f"{name}/{what}"])
    for r in range(4 * (i % 2), 4 * (i % 2) + 4):
        d, s = int(results[r][f"{name}/dp"]), int(results[r][f"{name}/sp"])
        b, t = Bq // shape.get("dp", 1), Tq // shape["sp"]
        got[d * b:(d + 1) * b, s * t:(s + 1) * t] = results[r][f"{name}/{what}"]
    np.testing.assert_allclose(got, refs[f"{name}/{what}"], rtol=0, atol=2e-5)


def test_ulysses_refuses_indivisible_heads():
    from polykey_tpu_torch.ops.ulysses_attention import ulysses_attention

    q = torch.zeros(1, 4, 6, 8)
    k = torch.zeros(1, 4, 3, 8)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible by the sp axis"):
        ulysses_attention(q, k, k, pos, pos, mesh=types.SimpleNamespace(shape={"sp": 4}),
                          scale=1.0)


# -- pipeline ----------------------------------------------------------------


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_hidden_matches_unsharded_stack(runs, name):
    results, refs = runs
    for r in PIPELINES[name][1]:
        np.testing.assert_allclose(results[r][f"{name}/hidden"], refs["pipe/hidden"],
                                   rtol=0, atol=2e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_gradients_match_unsharded_stack(runs, name):
    """Each stage's layer gradients (at their global indices, so the
    window interleave is checked) and the replicated leaves' summed
    gradients match jax.grad of the unsharded forward; with tp, each
    rank's slice of them."""
    results, refs = runs
    mesh_shape, devices = PIPELINES[name]
    seen = set()
    for i, r in enumerate(devices):
        mesh = _layout_mesh(mesh_shape, i)
        got = {k[len(name) + 6:]: v for k, v in results[r].items()
               if k.startswith(f"{name}/grad.")}
        for key, value in got.items():
            want = refs["pipe/grads"][key]
            path = tuple(p for p in key.split(".") if not p.isdigit())
            spec = tsharding._spec_for_path(path)
            if path[0] == "layers":
                spec = spec[1:]
            want = tsharding.local_slice(torch.from_numpy(want), spec, mesh).numpy()
            np.testing.assert_allclose(value, want, rtol=0, atol=1e-4,
                                       err_msg=f"{key} on rank {r}")
            seen.add(key)
    assert seen == set(refs["pipe/grads"])


def test_pipeline_refuses_indivisible_layouts():
    from polykey_tpu_torch.parallel.pipeline import pipeline_forward

    tokens = torch.zeros(4, 8, dtype=torch.long)
    pos = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="must divide num_layers"):
        pipeline_forward({"layers": []}, CFG, tokens, pos, _layout_mesh({"pp": 3}), 2)
    with pytest.raises(ValueError, match="microbatches=3 must divide batch=4"):
        pipeline_forward({"layers": []}, CFG, tokens, pos, _layout_mesh({"pp": 2}), 3)
