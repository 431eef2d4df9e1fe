"""Rank processes for the port's multi-rank CPU tests (not collected:
no test_ prefix). Imports torch and the port only, never JAX.

`run(world, jobs, workdir)` spawns `world` processes that join one gloo
group (a file:// rendezvous in `workdir`, so concurrent test workers never
share a port), build every job's mesh in the same order (making a group is
collective), then each run the jobs whose ranks they are in: jobs on
disjoint ranks run side by side. Every rank writes its results to
`workdir/rank<r>.npz`; a failure writes its traceback beside it. Each join
has a timeout, so a hung rank fails the test, not the run.

Inputs come as .npz files written by the test (the JAX package's
parameters and references, flattened by `save_tree`); the parameters go
through models/interop.params_from_numpy, as everywhere in the port's
tests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

import numpy as np


def save_tree(path, tree) -> None:
    """A nested dict of arrays as one .npz keyed "a/b/c"."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path) -> dict:
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = data[key]
    return tree


def flat_params(params: dict, first_layer: int = 0) -> dict:
    """Port parameters (or gradients in their shape) as {"layers.<global
    index>.attn.wq": array, "embed": array, ...}."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + [k])
        else:
            out[".".join(prefix)] = node.detach().cpu().numpy() if hasattr(node, "detach") else node

    for k, v in params.items():
        if k == "layers":
            for i, layer in enumerate(v):
                walk(layer, ["layers", str(first_layer + i)])
        else:
            walk(v, [k])
    return out


def model_config(fields: dict):
    from polykey_tpu_torch.models.config import ModelConfig

    return ModelConfig(**fields)


def config_fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


# -- jobs --------------------------------------------------------------------


def _mesh_for(job):
    from polykey_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    if job["kind"] in ("engine", "supervise", "replicas", "handoff"):
        from polykey_tpu_torch.engine.config import EngineConfig
        from polykey_tpu_torch.engine.lockstep import serving_mesh

        config = EngineConfig(**job["config"])
        if job["kind"] == "replicas":        # a mesh of its own for each replica
            meshes = [serving_mesh(config, job["devices"]) for _ in range(config.replicas)]
            return None if meshes[0] is None else meshes
        return serving_mesh(config, job["devices"])
    return create_mesh(MeshConfig(**job["mesh"]), job["devices"])


def _rows(mesh, n):
    b = n // mesh.shape["dp"]
    return slice(mesh.coord("dp") * b, (mesh.coord("dp") + 1) * b)


def job_bootstrap(job, mesh):
    """The reference's tests/test_distributed.py layouts, on all 8 ranks."""
    import torch
    import torch.distributed as dist

    from polykey_tpu_torch.parallel.collectives import all_reduce
    from polykey_tpu_torch.parallel.distributed import create_hybrid_mesh, mesh_from_env
    from polykey_tpu_torch.parallel.mesh import MeshConfig
    from polykey_tpu_torch.parallel.sharding import P, local_slice

    out = {}
    hybrid = create_hybrid_mesh(MeshConfig(dp=2, tp=2), num_slices=2, devices=range(8))
    out["hybrid_devices"] = hybrid.devices
    # A dp x tp sharded sum over all eight ranks.
    x = torch.arange(8.0).reshape(4, 2)
    local = local_slice(x, P("dp", "tp"), hybrid)
    out["hybrid_sum"] = np.asarray(float(all_reduce(local.sum(), hybrid, ("dp", "tp"))))
    single = create_hybrid_mesh(MeshConfig(dp=2, tp=2), num_slices=1, devices=range(4))
    out["single_devices"] = np.asarray(single.devices if single is not None else -1)
    try:
        create_hybrid_mesh(MeshConfig(dp=2), num_slices=3, devices=range(4))
        out["validation"] = np.asarray("")
    except ValueError as e:
        out["validation"] = np.asarray(str(e))
    saved = {k: os.environ.get(k) for k in ("POLYKEY_TP", "POLYKEY_NUM_SLICES", "POLYKEY_DP")}
    os.environ.update(POLYKEY_TP="2", POLYKEY_NUM_SLICES="2")
    os.environ.pop("POLYKEY_DP", None)
    try:
        from_env = mesh_from_env()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["env_devices"] = from_env.devices
    out["rank"] = np.asarray(dist.get_rank())
    return out


def job_forward(job, mesh):
    """Logits of this rank's batch rows through the sharded forward (the
    pipeline when pp > 1)."""
    import torch

    from polykey_tpu_torch.models.interop import params_from_numpy
    from polykey_tpu_torch.models.transformer import forward, unembed
    from polykey_tpu_torch.parallel.pipeline import pipeline_forward
    from polykey_tpu_torch.parallel.sharding import shard_params

    cfg = model_config(job["cfg"])
    params = shard_params(params_from_numpy(load_tree(job["params"])), cfg, mesh)
    data = np.load(job["batch"])
    rows = _rows(mesh, data["tokens"].shape[0])
    tokens = torch.from_numpy(data["tokens"][rows]).long()
    positions = torch.from_numpy(data["positions"][rows])
    with torch.no_grad():
        if mesh.shape["pp"] > 1:
            hidden = pipeline_forward(params, cfg, tokens, positions, mesh, job["micro"])
        else:
            hidden = forward(params, cfg, tokens, positions, mesh=mesh)[0]
        logits = unembed(params, cfg, hidden, mesh)
    return {"logits": logits.numpy(), "dp": np.asarray(mesh.coord("dp"))}


def job_attention(job, mesh):
    """Ring or Ulysses attention on this rank's (dp rows, sp columns) of
    q/k/v, its output and q/k/v gradients under the cotangent's shard."""
    import torch

    from polykey_tpu_torch.ops.ring_attention import ring_attention_spmd
    from polykey_tpu_torch.ops.ulysses_attention import ulysses_attention_spmd

    data = np.load(job["inputs"])
    rows = _rows(mesh, data["q"].shape[0])
    T = data["q"].shape[1] // mesh.shape["sp"]
    cols = slice(mesh.coord("sp") * T, (mesh.coord("sp") + 1) * T)
    q, k, v = (torch.from_numpy(data[n][rows, cols]).requires_grad_(True) for n in "qkv")
    pos = torch.from_numpy(data["pos"][rows, cols])
    op = ring_attention_spmd if job["impl"] == "ring" else ulysses_attention_spmd
    out = op(q, k, v, pos, pos, mesh, scale=job["scale"], logit_softcap=job["softcap"],
             window=job["window"])
    out.backward(torch.from_numpy(data["ct"][rows, cols]))
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy(), "dp": np.asarray(mesh.coord("dp")),
            "sp": np.asarray(mesh.coord("sp"))}


def job_pipeline(job, mesh):
    """The pp pipeline's hidden states and the gradients of sum(hidden *
    ct), seeded on the last stage and summed as the train step sums them
    (train.sync_grads)."""
    import torch

    from polykey_tpu_torch.models.interop import params_from_numpy
    from polykey_tpu_torch.parallel.pipeline import pipeline_forward
    from polykey_tpu_torch.parallel.sharding import shard_params
    from polykey_tpu_torch.train.train import sync_grads

    cfg = model_config(job["cfg"])
    params = shard_params(params_from_numpy(load_tree(job["params"])), cfg, mesh)
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    data = np.load(job["batch"])
    tokens = torch.from_numpy(data["tokens"]).long()
    positions = torch.from_numpy(data["positions"])
    hidden = pipeline_forward(params, cfg, tokens, positions, mesh, job["micro"])
    last = mesh.coord("pp") == mesh.shape["pp"] - 1
    loss = (hidden * torch.from_numpy(data["ct"])).sum()
    (loss if last else loss * 0).backward()
    sync_grads(params, mesh)
    first = mesh.coord("pp") * (cfg.num_layers // mesh.shape["pp"])
    grads = _grad_tree(params)
    out = {"hidden": hidden.detach().numpy()}
    out.update({f"grad.{k}": v for k, v in flat_params(grads, first).items()})
    return out


def job_train(job, mesh):
    """`steps` train steps through make_train_step: the loss of each, and
    this rank's final parameters."""
    import torch

    from polykey_tpu_torch.models.interop import params_from_numpy
    from polykey_tpu_torch.train import make_train_step

    cfg = model_config(job["cfg"])
    init_state, train_step, shard_batch = make_train_step(
        cfg, mesh, sp_impl=job.get("sp_impl", "ring"),
        pp_microbatches=job.get("micro", 4))
    state = init_state(params_from_numpy(load_tree(job["params"])))
    data = np.load(job["batch"])
    batch = shard_batch(*(torch.from_numpy(data[n]) for n in ("tokens", "targets", "positions")))
    losses = []
    for _ in range(job["steps"]):
        state, loss = train_step(state, *batch)
        losses.append(float(loss))
    first = mesh.coord("pp") * (cfg.num_layers // mesh.shape["pp"])
    out = {"losses": np.asarray(losses), "step": np.asarray(state.step)}
    out.update({f"param.{k}": v for k, v in flat_params(state.params, first).items()})
    return out


def _engine(job, mesh, **kw):
    """The port's InferenceEngine of `job` over `mesh` on the CPU, its
    model registered from the job's fields first (a test model need not be
    in the registry), on the whole model's parameters."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import InferenceEngine
    from polykey_tpu_torch.models.config import MODEL_REGISTRY
    from polykey_tpu_torch.models.interop import params_from_numpy

    cfg = model_config(job["model"])
    MODEL_REGISTRY[cfg.name] = cfg
    config = EngineConfig(**job["config"])
    # No params with a checkpoint_path: each rank reads its shard of it.
    params = params_from_numpy(load_tree(job["params"])) if job.get("params") else None
    if job.get("draft_params"):
        kw["draft_params"] = params_from_numpy(load_tree(job["draft_params"]))
    return InferenceEngine(config, params=params, device="cpu", mesh=mesh, **kw)


def _collect(request, timeout):
    tokens, error = [], ""
    deadline = time.monotonic() + timeout
    while True:
        kind, value = request.out.get(timeout=max(0.0, deadline - time.monotonic()))
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens, ""
        else:
            return tokens, str(value)


# The leader's prefix cache and host tier counts a job_engine returns.
PAGE_COUNTS = ("prefix_hit_tokens", "prefix_host_hit_tokens", "kv_pages_evicted",
               "kv_pages_restored")


def job_engine(job, mesh):
    """Serve `prompts` (greedy, `max_new` tokens each, submitted at once,
    or one after another with `sequential`) on the mesh's leader, with the
    draft weights of `draft_params` when given; followers replay until the
    leader shuts down.
    `kill_after` (a follower's rank and a count of decode records) makes
    that follower exit at once on its Nth decode record, mid-stream;
    `heartbeat_s` sets the idle leader's heartbeat interval and `idle_s`
    idles the leader that long before it shuts down.
    Every rank returns its decode tokens' digest and its pools' (the draft's too; every
    page but the garbage page); the leader also each stream (-1 padded)
    and its error, its prefix cache's and host tier's page counts and its
    records by kind; a follower its records replayed by kind."""
    import hashlib
    import queue

    import torch

    from polykey_tpu_torch.engine import lockstep
    from polykey_tpu_torch.engine.engine import GenRequest

    if job.get("heartbeat_s"):
        lockstep.HEARTBEAT_S = job["heartbeat_s"]
    engine = _engine(job, mesh)
    if engine.is_follower:
        kill = job.get("kill_after")
        if kill is not None and kill[0] == mesh.rank:
            replay, seen = engine._replay, [0]

            def dying(record):
                seen[0] += record.kind == "decode"
                if seen[0] >= kill[1]:
                    os._exit(3)
                replay(record)

            engine._replay = dying
        if not engine.join(job.get("timeout", 120)):
            raise RuntimeError("the follower was not shut down by its leader")
        out = {"error": np.asarray(engine.dead or "")}
    else:
        requests = [GenRequest(prompt=p, max_new_tokens=job["max_new"])
                    for p in job["prompts"]]
        for r in requests:
            if not job.get("sequential"):
                engine.submit(r)
        streams, errors = [], []
        for r in requests:
            if job.get("sequential"):
                engine.submit(r)
            try:
                tokens, error = _collect(r, job.get("timeout", 120))
            except queue.Empty:
                tokens, error = [], "timed out"
            streams.append(tokens + [-1] * (job["max_new"] - len(tokens)))
            errors.append(error)
        time.sleep(job.get("idle_s", 0.0))      # heartbeats while idle
        engine.shutdown()
        snap = engine.stats()
        out = {"tokens": np.asarray(streams), "errors": np.asarray(errors),
               "dead": np.asarray(engine.dead or ""),
               "reloaded": np.asarray(snap.get("kv_reloaded_pages", 0)),
               **{k: np.asarray(snap.get(k, 0)) for k in PAGE_COUNTS}}
    stats = engine.stats()["mesh"]
    out["records"] = np.asarray(json.dumps(
        stats.get("records_by_kind", stats.get("records_replayed", {}))))
    pools = hashlib.blake2b(digest_size=16)       # every page but the garbage page 0
    for pool in engine.paged.pools + (engine.d_paged.pools if engine._spec else []):
        pools.update(pool[:, 1:].contiguous().view(torch.uint8).numpy().tobytes())
    out.update(pools=np.asarray(pools.hexdigest()),
               heartbeats=np.asarray(stats.get("heartbeats", -1)),
               digest=np.asarray(stats.get("tokens_digest", "")),
               blocks=np.asarray(stats.get("decode_blocks_hashed", 0)),
               role=np.asarray(stats["role"]), kv_pool_bytes=np.asarray(
                   engine.stats()["kv_pool_bytes"]))
    return out


def _serve_prompts(engine, prompts, max_new, timeout=120):
    from polykey_tpu_torch.engine.engine import GenRequest

    requests = [GenRequest(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in requests:
        engine.submit(r)
    streams, errors = [], []
    for r in requests:
        tokens, error = _collect(r, timeout)
        streams.append(tokens + [-1] * (max_new - len(tokens)))
        errors.append(error)
    return streams, errors


def job_supervise(job, mesh):
    """A mesh engine behind TorchService.create, its leader's engine loop
    crashed by an injected failure. With `crash` "before" (the default)
    the failure comes before any record of its dispatch went out: the
    supervisor restarts the mesh in process, and the leader returns the
    crashed request's error, the restarts, the health after them and the
    streams of `prompts` served by the fresh engine. With "inside" the
    leader first serves `prompts`, then fails inside a prefill's dispatch
    (its record sent and replayed): the factory refuses the restart, and
    the leader returns the refusals it logged and the health after the
    supervisor gave up. Every rank returns its last engine's decode
    tokens' digest; a follower follows its lives (lockstep.follow_lives)
    and returns how many it had and the record that ended the last."""
    import io
    import json

    from polykey_tpu_torch.engine import lockstep
    from polykey_tpu_torch.engine.engine import GenRequest
    from polykey_tpu_torch.gateway import health as hs
    from polykey_tpu_torch.gateway.jsonlog import Logger
    from polykey_tpu_torch.gateway.torch_service import TorchService

    health = hs.HealthService()
    health.set_serving_status("", hs.SERVING)
    engine = _engine(job, mesh, health=health)
    inside = job.get("crash", "before") == "inside"
    if engine.is_follower:
        lives = [1]
        deadline = time.monotonic() + job.get("timeout", 120)

        def fresh(_engine):
            lives[0] += 1

        engine = lockstep.follow_lives(engine, lambda: time.monotonic() > deadline, fresh)
        if not engine.join(0):
            raise RuntimeError("the follower was not shut down by its leader")
        out = {"lives": np.asarray(lives[0]), "error": np.asarray(engine.dead or ""),
               "ended_with": np.asarray("restart" if engine.restart_requested
                                        else "shutdown")}
    else:
        log = io.StringIO()
        service = TorchService.create(engine, health=health, logger=Logger(log))
        streams, errors = [], []
        try:
            if inside:
                streams, errors = _serve_prompts(engine, job["prompts"], job["max_new"])
                dispatch = engine._prefill_dispatch

                def crash(*args):
                    dispatch(*args)             # the followers replay it whole
                    raise RuntimeError("injected failure inside a dispatch")

                engine._prefill_dispatch = crash
            else:
                def crash():
                    raise RuntimeError("injected dispatch failure")

                engine._dispatch_step = crash
            request = GenRequest(prompt="crash", max_new_tokens=4)
            engine.submit(request)
            _, error = _collect(request, 30)
            deadline = time.monotonic() + 60
            while service.supervisor.restarts < 1 and not service.supervisor.gave_up \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            restarted = service.engine is not engine
            if restarted:
                streams, errors = _serve_prompts(service.engine, job["prompts"],
                                                 job["max_new"])
            status = health._statuses[""]
        finally:
            service.close()
        refusals = [r.get("error", "") for r in map(json.loads, log.getvalue().splitlines())
                    if r.get("msg") == "engine restart failed; will retry"]
        engine = service.engine
        out = {"error": np.asarray(error), "gave_up": np.asarray(service.supervisor.gave_up),
               "restarts": np.asarray(service.supervisor.restarts),
               "status": np.asarray(status), "tokens": np.asarray(streams),
               "errors": np.asarray(errors), "refusals": np.asarray(json.dumps(refusals)),
               "closed_with": np.asarray(str(getattr(engine, "closed_with", "")))}
    stats = engine.stats()["mesh"]
    out.update(digest=np.asarray(stats.get("tokens_digest", "")),
               blocks=np.asarray(stats.get("decode_blocks_hashed", 0)),
               role=np.asarray(stats["role"]))
    return out


def job_replicas(job, meshes):
    """A ReplicaPool of `config["replicas"]` replicas, each over its own
    mesh of the job's ranks. The leader serves `prompts` at once, then a
    failover: replica 0's engine loop fails after three decode dispatches
    under `victim`'s stream, which resumes on replica 1; once replica 0 is
    rebuilt (on every rank) `victim` is served again. Returns the streams,
    the victim's replicas and the restarts; every rank each replica's
    decode digest and engines built. Followers follow until the leader's
    pool shuts down."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import GenRequest
    from polykey_tpu_torch.engine.replica_pool import SERVING, ReplicaPool
    from polykey_tpu_torch.gateway import health as hs
    from polykey_tpu_torch.models.config import MODEL_REGISTRY
    from polykey_tpu_torch.models.interop import params_from_numpy

    cfg = model_config(job["model"])
    MODEL_REGISTRY[cfg.name] = cfg
    health = hs.HealthService()
    health.set_serving_status("", hs.SERVING)
    pool = ReplicaPool.create(EngineConfig(**job["config"]), health=health, device="cpu",
                              params=params_from_numpy(load_tree(job["params"])),
                              meshes=meshes)
    engines = {rep.index: [rep.engine] for rep in pool.replicas}
    out = {}
    if pool.is_follower:
        out["error"] = np.asarray(pool.follow() or "")
    else:
        try:
            streams, errors = _serve_prompts(pool, job["prompts"], job["max_new"])
            first = pool.replicas[0].engine
            dispatch, calls = first._dispatch_step, [0]

            def dying():
                calls[0] += 1
                if calls[0] > 3:
                    raise RuntimeError("injected dispatch failure")
                return dispatch()

            first._dispatch_step = dying
            victim = GenRequest(prompt=job["victim"], max_new_tokens=job["victim_new"])
            pool.submit(victim)
            routed = victim.replica
            resumed, error = _collect(victim, 60)
            deadline = time.monotonic() + 60
            rep0 = pool.replicas[0]
            while (rep0.supervisor.restarts < 1 or rep0.state != SERVING) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            again = GenRequest(prompt=job["victim"], max_new_tokens=job["victim_new"])
            pool.submit(again)
            after, after_error = _collect(again, 60)
            out.update(tokens=np.asarray(streams), errors=np.asarray(errors),
                       resumed=np.asarray(resumed), resumed_error=np.asarray(error),
                       routed=np.asarray([routed, victim.replica, again.replica]),
                       restarted=np.asarray(victim.restarted),
                       after=np.asarray(after), after_error=np.asarray(after_error),
                       restarts=np.asarray(rep0.supervisor.restarts),
                       state=np.asarray(rep0.state), status=np.asarray(health._statuses[""]))
        finally:
            pool.shutdown()
    for rep in pool.replicas:
        stats = rep.engine.stats()["mesh"]
        out[f"digest{rep.index}"] = np.asarray(stats.get("tokens_digest", ""))
        out[f"blocks{rep.index}"] = np.asarray(stats.get("decode_blocks_hashed", 0))
        out[f"fresh{rep.index}"] = np.asarray(rep.engine is not engines[rep.index][0])
    out["role"] = np.asarray("follower" if pool.is_follower else "leader")
    return out


def job_handoff(job, mesh):
    """The disaggregated handoff's halves on a mesh engine: the leader
    prefills `prompt` as a prefill_only request (the whole pages gathered
    from every rank's shard) and returns the serialized wire blob; then it
    resumes that state as a resume_state request (the whole pages cut to
    every rank's shard) and returns the stream. Followers replay both."""
    from polykey_tpu_torch.engine.engine import GenRequest
    from polykey_tpu_torch.engine.kv_cache import deserialize_kv_state, serialize_kv_state

    engine = _engine(job, mesh)
    if engine.is_follower:
        if not engine.join(job.get("timeout", 120)):
            raise RuntimeError("the follower was not shut down by its leader")
        out = {"error": np.asarray(engine.dead or "")}
    else:
        try:
            request = GenRequest(prompt=job["prompt"], max_new_tokens=job["max_new"],
                                 seed=99, prefill_only=True)
            engine.submit(request)
            kind, state = request.out.get(timeout=60)
            if kind != "handoff":
                raise RuntimeError(f"the export failed: {kind} {state}")
            blob = serialize_kv_state(state)
            resumed = GenRequest(prompt="", max_new_tokens=job["max_new"],
                                 resume_state=deserialize_kv_state(blob))
            engine.submit(resumed)
            tokens, error = _collect(resumed, 60)
        finally:
            engine.shutdown()
        out = {"blob": np.frombuffer(blob, np.uint8), "tokens": np.asarray(tokens),
               "resume_error": np.asarray(error),
               "imports": np.asarray(engine._handoff_imported),
               "exports": np.asarray(engine._handoff_exports)}
    mesh_stats = engine.stats()["mesh"]
    out.update(digest=np.asarray(mesh_stats.get("tokens_digest", "")),
               blocks=np.asarray(mesh_stats.get("decode_blocks_hashed", 0)),
               records=np.asarray(json.dumps(mesh_stats.get(
                   "records_by_kind", mesh_stats.get("records_replayed", {})))),
               role=np.asarray(mesh_stats["role"]))
    return out


def job_moe(job, mesh):
    """ops/moe.moe_mlp_sharded on this rank's share of one batch of hidden
    states [B, T, H]: its dp block of rows under dp (its lanes), its sp
    block of columns under sp (a prefill), and its experts under ep."""
    import torch

    from polykey_tpu_torch.models.interop import params_from_numpy
    from polykey_tpu_torch.ops.moe import moe_mlp_sharded
    from polykey_tpu_torch.parallel.sharding import shard_params

    cfg = model_config(job["cfg"])
    params = shard_params(params_from_numpy(load_tree(job["params"])), cfg, mesh)
    h = torch.from_numpy(np.load(job["inputs"])["h"])
    split = []
    for axis, dim in (("dp", 0), ("sp", 1)):
        if job["split"].get(axis):
            n = h.shape[dim] // mesh.shape[axis]
            h = h.narrow(dim, mesh.coord(axis) * n, n)
            split.append((axis, dim))
    with torch.no_grad():
        y = moe_mlp_sharded(params["layers"][0], h, cfg, mesh, tuple(split))
    return {"y": y.numpy(), "dp": np.asarray(mesh.coord("dp")),
            "sp": np.asarray(mesh.coord("sp"))}


def job_refusals(job, mesh):
    """Construct an engine of each of `cases` ({name: EngineConfig fields})
    and report the error each raised: "<type>: <message>", or "" when one
    started (it is shut down at once)."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import InferenceEngine
    from polykey_tpu_torch.models.config import MODEL_REGISTRY

    for fields in job.get("models", []):
        cfg = model_config(fields)
        MODEL_REGISTRY[cfg.name] = cfg
    out = {}
    for name, fields in job["cases"].items():
        try:
            InferenceEngine(EngineConfig(**fields), device="cpu").shutdown()
            out[name] = np.asarray("")
        except Exception as e:
            out[name] = np.asarray(f"{type(e).__name__}: {e}")
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def _grad_tree(node):
    if isinstance(node, dict):
        return {k: _grad_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_grad_tree(v) for v in node]
    return node.grad


JOBS = {"bootstrap": job_bootstrap, "forward": job_forward, "attention": job_attention,
        "pipeline": job_pipeline, "train": job_train, "engine": job_engine,
        "supervise": job_supervise, "refusals": job_refusals, "moe": job_moe,
        "replicas": job_replicas, "handoff": job_handoff}


# -- processes ---------------------------------------------------------------


def _main(rank: int, world: int, workdir: str, jobs: list, nice: int = 0) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if nice:
        os.nice(nice)
    workdir = Path(workdir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                                rank=rank, world_size=world)
        meshes = [_mesh_for(job) if job.get("devices") is not None else None for job in jobs]
        results = {}
        for job, mesh in zip(jobs, meshes):
            if job.get("devices") is not None and mesh is None:
                continue                       # not one of this job's ranks
            t0 = time.monotonic()
            for key, value in JOBS[job["kind"]](job, mesh).items():
                results[f"{job['name']}/{key}"] = np.asarray(value)
            results[f"{job['name']}/seconds"] = np.asarray(time.monotonic() - t0)
        np.savez(workdir / f"rank{rank}.npz", **results)
        dist.destroy_process_group()
    except BaseException:
        (workdir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run(world: int, jobs: list, workdir, timeout: float = 240.0, may_exit=(),
        nice: int = 0) -> dict:
    """Run `jobs` on `world` gloo ranks; returns {rank: {key: array}} with
    keys "<job name>/<result>". Raises with the ranks' tracebacks when a
    rank fails or does not finish within `timeout` seconds; the ranks in
    `may_exit` may end early with any exit code, leaving no results.
    `nice` lowers the ranks' scheduling priority (os.nice), for light jobs
    whose eight processes should not starve a busy machine's other tests."""
    import multiprocessing

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(r, world, str(workdir), jobs, nice), daemon=True)
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    errors = {r: (workdir / f"rank{r}.err").read_text()
              for r in range(world) if (workdir / f"rank{r}.err").exists()}
    failed = [r for r, proc in enumerate(procs) if proc.exitcode != 0 and r not in may_exit]
    if hung or failed or errors:
        raise RuntimeError(
            f"ranks hung {hung}, failed {failed} (exit codes "
            f"{[p.exitcode for p in procs]}):\n" + "\n".join(
                f"-- rank {r}\n{tb}" for r, tb in sorted(errors.items()))
        )
    out = {}
    for r in range(world):
        if r in may_exit and not (workdir / f"rank{r}.npz").exists():
            continue
        with np.load(workdir / f"rank{r}.npz") as data:
            out[r] = {k: data[k] for k in data.files}
    return out


def describe(results: dict) -> str:
    """Each job's seconds on its ranks, for a failing test's message."""
    seconds = {}
    for per_rank in results.values():
        for k, v in per_rank.items():
            if k.endswith("/seconds"):
                seconds.setdefault(k[:-8], []).append(round(float(v), 2))
    return json.dumps(seconds)
