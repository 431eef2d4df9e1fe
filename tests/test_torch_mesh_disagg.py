"""Disaggregated workers built of meshes, as real processes on the CPU
(engine/worker.py's launcher, engine/disagg_pool.py's spawner), against
the JAX package's engine.

The pool's config asks for tp=2: each worker process starts its second
rank as the gateway's ranks start (the bootstrap variables over a free
localhost port), both ranks join a gloo group and read their shards of one
checkpoint (the JAX init_params tree written by chip_smoke.py's writer),
and the worker's first rank binds the worker's port while the other
follows it. The handoff's wire blob carries whole pages (gathered from the
prefill worker's ranks, cut back to the decode worker's); the
engine-level halves and the blob's bytes are held in
tests/test_torch_mesh_serving.py.

- A 1x1 pool of tp=2 workers serves the JAX engine's greedy streams, each
  worker a mesh of two ranks; a prefill worker killed mid-handoff (its
  leader's `os._exit` after the prefill, before the blob ships) is
  respawned with its ranks and the request re-runs to the JAX stream.
- A JAX prefill worker (in-thread) feeds a port decode worker of two rank
  processes: the resumed stream is the JAX engine's.
- Every worker process is gone once the pool shuts down.
"""

import json
import os
import subprocess
import sys
import time

import jax
import pytest

import chip_smoke
from polykey_tpu.engine import worker as jworker
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine import disagg_pool as tdisagg
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.disagg_pool import DECODE, PREFILL, DisaggPool
from polykey_tpu_torch.engine.engine import GenRequest
from polykey_tpu_torch.engine.worker import WorkerConn
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_disagg.py's configuration.
FIELDS = dict(
    model="tiny-llama", dtype="float32", max_decode_slots=4,
    page_size=8, num_pages=128, max_seq_len=64,
    prefill_buckets=(16, 32), decode_block_steps=2,
    adaptive_block=False, max_new_tokens_cap=12,
    default_max_new_tokens=12, supervise=False,
    disagg_heartbeat_s=0.1, disagg_recovery_wait_s=30.0,
)
PROMPTS = ("hello disagg world", "kill test prompt")


def _run(sub, prompt: str, n: int = 10, make=GenRequest):
    request = make(prompt=prompt, max_new_tokens=n)
    sub.submit(request)
    tokens = []
    while True:
        kind, value = request.out.get(timeout=120)
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens, None
        else:
            return tokens, value


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX params, checkpoint dir of the same weights, the JAX engine's
    greedy streams of PROMPTS)."""
    jparams = jax.device_get(jt.init_params(jax.random.PRNGKey(7),
                                            j_get_config("tiny-llama"), jax.numpy.float32))
    ckpt = tmp_path_factory.mktemp("ckpt")
    chip_smoke.write_hf_checkpoint(params_from_numpy(jparams), get_config("tiny-llama"),
                                   str(ckpt))
    engine = JInferenceEngine(JEngineConfig(**FIELDS), params=jparams)
    try:
        want = {}
        for p in PROMPTS:
            toks, err = _run(engine, p, make=JGenRequest)
            assert err is None
            want[p] = toks
    finally:
        engine.shutdown()
    return jparams, str(ckpt), want


def _config(ckpt: str, **kw) -> EngineConfig:
    return EngineConfig(**FIELDS, tp=2, checkpoint_path=ckpt, **kw)


def _stats(addr) -> dict:
    with WorkerConn(addr, timeout=30) as conn:
        reply, _ = conn.request({"op": "stats"}, timeout=30)
    return reply["stats"]


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"     # exited, unreaped
    except FileNotFoundError:
        return True


def _worker_pids(pid: int) -> list:
    """A worker's process and the rank processes it started."""
    out = subprocess.run(["pgrep", "-P", str(pid)], capture_output=True, text=True)
    return [pid] + [int(p) for p in out.stdout.split()]


@pytest.fixture(autouse=True)
def _one_thread_a_process(monkeypatch):
    """The worker processes (four of them and their respawns) take one CPU
    thread each, beside the other test files' workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("POLYKEY_FAULTS", raising=False)


def test_pool_of_mesh_workers_streams_and_survives_a_mid_handoff_kill(setup, tmp_path):
    _, ckpt, want = setup
    pool = DisaggPool.create(_config(ckpt, disagg="1x1"), device="cpu",
                             state_dir=str(tmp_path / "state"))
    pids = []
    try:
        for w in pool.workers:
            stats = _stats(w.addr)
            assert stats["mesh"]["world"] == 2 and stats["mesh"]["role"] == "leader", stats
            pids += _worker_pids(w.proc.pid)
        assert len(pids) == 4
        for p in PROMPTS:
            toks, err = _run(pool, p)
            assert err is None and toks == want[p], p
        prefill = next(w for w in pool.workers if w.tier == PREFILL)
        decode = next(w for w in pool.workers if w.tier == DECODE)
        assert _stats(decode.addr)["handoff_imports"] == len(PROMPTS)
        # The prefill worker dies once its prefill is done, before it ships.
        with WorkerConn(prefill.addr, timeout=30) as conn:
            conn.request({"op": "arm_faults", "spec": "worker-exit=1@1:tier=prefill"},
                         timeout=30)
        toks, err = _run(pool, PROMPTS[1])
        assert err is None and toks == want[PROMPTS[1]]
        assert len(prefill.boot_s) == 2           # respawned, with its ranks
        assert _stats(prefill.addr)["mesh"]["world"] == 2
        pids += _worker_pids(prefill.proc.pid)
    finally:
        pool.shutdown()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not all(_gone(p) for p in pids):
        time.sleep(0.1)
    assert all(_gone(p) for p in pids), [p for p in pids if not _gone(p)]


def test_jax_prefill_worker_feeds_a_port_decode_mesh(setup):
    jparams, ckpt, want = setup
    config = _config(ckpt)
    jserver = jworker.WorkerServer(JEngineConfig(**FIELDS), tier="prefill", seed=7,
                                   params=jparams, exit_mode="simulate").start()
    env = dict(os.environ, **tdisagg._config_env(config), POLYKEY_DEVICE="cpu",
               PYTHONPATH=ROOT, POLYKEY_DISAGG="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "polykey_tpu_torch.engine.worker", "--tier", "decode",
         "--port", "0", "--seed", "7"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        text=True, start_new_session=True)
    pool = ready = None
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["ranks"] == 2
        addr = ("127.0.0.1", ready["port"])
        pool = DisaggPool.create(config, workers=[
            (PREFILL, ("127.0.0.1", jserver.port)), (DECODE, addr)])
        toks, err = _run(pool, PROMPTS[0])
        assert err is None and toks == want[PROMPTS[0]]
        stats = _stats(addr)
        assert stats["handoff_imports"] == 1 and stats["mesh"]["world"] == 2
    finally:
        if pool is not None:
            pool.shutdown()
        jserver.stop()
        if ready is not None:
            try:        # the pool's shutdown may have stopped it already
                with WorkerConn(("127.0.0.1", ready["port"]), timeout=10) as conn:
                    conn.request({"op": "exit"}, timeout=10)
            except (ConnectionError, OSError):
                pass
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait(10)
    assert proc.returncode == 0


def _until(cond, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def test_mesh_workers_keep_cards_of_their_own_through_scaling(monkeypatch):
    """The spawner's command lines for tp=2 workers on a host of six cards,
    through DisaggPool.create, scale_down and scale_up (the process start
    stubbed, each worker's port closed): every worker its own run of two
    cards in order; a worker that leaves frees its run and the next one
    takes it (at the list position where cards by position would give it
    the decode worker's); a respawn keeps its run; a worker
    with no free run fails its spawn and leaves the pool; a worker of one
    rank, or on the CPU, is given no cards, and `mesh_workers` asks for a
    mesh of one."""
    import socket

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        closed = ("127.0.0.1", sock.getsockname()[1])
    commands = []

    def spawner(pool, worker):
        def spawn():
            commands.append((worker.name, pool._worker_command(worker)[0]))
            return closed, None
        return spawn

    def cards(name):
        cmd = [c for n, c in commands if n == name][-1]
        return cmd[cmd.index("--cards") + 1] if "--cards" in cmd else None

    monkeypatch.setattr(DisaggPool, "_spawner", spawner)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
    config = EngineConfig(**FIELDS, tp=2, disagg="2x1")
    pool = DisaggPool.create(config, device="cuda", heartbeat=False)
    try:
        assert [cards(w.name) for w in pool.workers] == ["0,1", "2,3", "4,5"]
        gone = pool.scale_down(PREFILL)
        _until(lambda: all(w.name != gone for w in pool.workers))
        grown = pool.scale_up(PREFILL)
        _until(lambda: any(w.name == grown and w.state == "SERVING" for w in pool.workers))
        assert [cards(w.name) for w in pool.workers] == ["0,1", "4,5", "2,3"]
        decode = next(w for w in pool.workers if w.tier == DECODE)
        assert pool._worker_command(decode)[0][-2:] == ["--cards", "4,5"]     # a respawn's
        extra = pool.scale_up(DECODE)                 # no run of two is left
        _until(lambda: all(w.name != extra for w in pool.workers))
        assert all(n != extra for n, _ in commands)
        with pytest.raises(RuntimeError, match="needs 2 cards of its own"):
            pool._take_cards(tdisagg._Worker(tier=DECODE, index=5))
    finally:
        pool.shutdown()
    for kw, device in ((dict(tp=1), "cuda"), (dict(tp=2), "cpu")):
        commands.clear()
        pool = DisaggPool.create(EngineConfig(**FIELDS, disagg="1x1", **kw), device=device,
                                 heartbeat=False, mesh_workers=True)
        try:
            assert [cards(w.name) for w in pool.workers] == [None, None]
            assert all("--mesh" in cmd for _, cmd in commands)
        finally:
            pool.shutdown()
