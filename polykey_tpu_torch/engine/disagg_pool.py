"""Disaggregated prefill/decode tiers: cross-process workers with a
crash-safe KV handoff (the reference's polykey_tpu/engine/disagg_pool.py,
the same coordinator).

The replica pool (engine/replica_pool.py) scales the engine inside one
process: a prefill burst still shares the card's time with decode, and a
sticky CUDA error poisons the process's whole context, taking every
replica down at once. This coordinator takes the same contracts across
process boundaries:

- **Tiers.** ``POLYKEY_DISAGG="PxD"`` runs P prefill-tier and D
  decode-tier worker processes (engine/worker.py) on localhost, each an
  independently supervised engine behind a socket control plane. Prefill
  never shares a process with decode, so tier capacity scales
  independently and a worker's death is its own. On one card the
  workers' contexts share it by time-slicing (no MPS here), so a prefill
  burst can still lengthen a decode step (PERF.md).
- **KV handoff.** A finished prefill ships as one versioned wire blob
  (kv_cache.serialize_kv_state: pages in block-table order + prompt/seed
  metadata, raw bytes — bf16, fp32 and int8 pair-form pools round-trip
  bit for bit). The hand-over is two-phase: the prefill worker RETAINS
  the serialized state until the coordinator releases it after decode
  completes, so a decode-side death re-ships the same blob instead of
  prefilling again.
- **NetKV routing**: the decode worker is chosen by estimated KV-transfer
  cost (blob bytes over a measured per-worker bandwidth EWMA) plus the
  queue-delay estimate its heartbeat reports. Prefill routing is
  session-sticky: prompts hash to a session key (their first page-aligned
  token window) and return to the worker holding their warm prefix; a
  restarted worker re-advertises its persisted prefix index.
- **Crash safety.** Worker death at ANY phase — queued, mid-prefill,
  mid-handoff, mid-decode — re-routes: the request replays from the
  earliest surviving artifact (the retained blob if the coordinator still
  holds it, a fresh prefill otherwise) with the delivered token prefix
  suppressed, bounded by ``max_reroutes``. Greedy streams equal a
  single-process run's (same weights, seed and positions). Heartbeat
  liveness (and process exit) feeds the replica pool's state machine:
  NEW → SERVING → DRAINING → RESTARTING → DEAD, with aggregate health
  flipping only when a TIER loses its last serving worker. A spawned
  worker that dies is started again (the spawner), within the restart
  budget.

``POLYKEY_DISAGG`` unset builds no process and no pool. The pool quacks
like an engine where the gateway needs it to (config, tokenizer, submit,
stats, dead, shutdown), as the replica pool does.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DEVICE_ENV
from ..obs.clocks import ClockSync
from ..obs.histogram import Histogram, estimate_quantile
from ..obs.postmortem import BlackBox, blackbox_path
from ..obs.signals import window_label, windows_from_spec
from ..obs.timeline import TimelineRecorder, merge_timelines, to_perfetto
from .config import EngineConfig
from .engine import EngineDeadError, EngineOverloadedError, GenRequest
from .kv_cache import KVWireError, validate_kv_blob
from .replica_pool import _ADDITIVE_KEYS  # shared aggregation contract
from .replica_pool import DEAD, DRAINING, NEW, RESTARTING, SERVING
from .tokenizer import load_tokenizer
from .worker import WorkerConn, mesh_ranks, session_key

PREFILL = "prefill"
DECODE = "decode"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Handoff outcome labels (polykey_handoffs_total{outcome}).
_OUTCOMES = ("ok", "retried", "aborted")

# Bandwidth prior before the first measured ship (bytes/s). Localhost
# sockets measure orders of magnitude above this; the prior only has to
# make the transfer term non-zero so routing is defined on a cold pool.
_BW_PRIOR = 200e6


class _HandoffRetry(Exception):
    """One attempt failed at a recoverable phase. `restart_prefill`
    says whether the retained blob is gone/bad (re-run prefill) or
    still shippable (re-route decode only); `mark_down` distinguishes
    worker death (heartbeat will confirm; re-route now) from flow
    control like a shed (the worker is fine, just busy)."""

    def __init__(self, cause: str, phase: str, restart_prefill: bool,
                 mark_down: bool = True, flow_control: bool = False,
                 retry_after_s: float = 0.0):
        super().__init__(cause)
        self.phase = phase
        self.restart_prefill = restart_prefill
        self.mark_down = mark_down
        # Flow control (a worker SHED, not a worker death): the retry
        # waits out the worker's retry-after hint, never burns the
        # re-route budget, and never counts as a failover metric —
        # mirroring how a shed at the gateway is RESOURCE_EXHAUSTED,
        # not a failure.
        self.flow_control = flow_control
        self.retry_after_s = retry_after_s
        self.delivered = 0


@dataclass
class _Worker:
    tier: str
    index: int
    addr: Optional[tuple] = None
    proc: Optional[subprocess.Popen] = None
    spawn: Optional[Callable[[], tuple]] = None   # () -> (addr, proc)
    state: str = NEW
    misses: int = 0
    restarts: int = 0
    # Elastic scale-down: marks a worker the autopilot is
    # deliberately draining out of the pool — its eventual death is
    # the PLAN, so _on_worker_down must retire it instead of spending
    # restart budget respawning it.
    retiring: bool = False
    restart_times: list = field(default_factory=list)
    ping: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    bw_ewma: float = 0.0          # measured ship bandwidth, bytes/s
    # Seconds from each spawn of this slot's process to its readiness
    # line: the first start, then every restart.
    boot_s: list = field(default_factory=list)
    # A mesh worker's cards, one a rank (`DisaggPool._take_cards`): its
    # own run, kept through respawns and freed when it leaves the pool.
    cards: Optional[tuple] = None
    # Clock alignment: maps this worker's monotonic clock
    # onto the coordinator's; fed by the heartbeat's ping samples and
    # reset when the worker's pid changes (new process = new epoch).
    clock: ClockSync = field(default_factory=ClockSync)
    last_pid: Optional[int] = None

    @property
    def name(self) -> str:
        return f"{self.tier}/{self.index}"

    @property
    def role(self) -> str:
        """Black-box / clock-offset key: matches the worker-side
        blackbox-<tier>-<replica>.json file name."""
        return f"{self.tier}-{self.index}"


class DisaggPool:
    """Engine-shaped coordinator over the prefill and decode worker
    tiers. One orchestration thread per in-flight request drives the
    prefill → handoff → decode pipeline over the workers' control
    planes and forwards tokens into the request's out queue."""

    def __init__(self, config: EngineConfig, health=None, logger=None,
                 recorder=None):
        config.validate()
        self.config = config
        self.health = health
        self.logger = logger
        self.recorder = recorder
        self.tokenizer = load_tokenizer(config.tokenizer)
        self.workers: list[_Worker] = []
        self._lock = threading.Lock()
        self._device: Optional[str] = None
        self._mesh_workers = False
        self._closing = False
        self._serving_advertised = True
        self._inflight = 0
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._stop_heartbeat = threading.Event()
        # Handoff observability: counters +
        # latency histogram owned HERE (the coordinator is the only
        # process that sees a handoff end to end), plus a pool-level
        # timeline ring for handoff_start/ack/abort events
        # (obs.timeline.to_perfetto renders notes on the engine-events
        # track; /debug/timeline reaches it through engine_timelines).
        self.handoffs = {outcome: 0 for outcome in _OUTCOMES}
        self.handoff_bytes = 0
        self.handoff_ms = Histogram()
        self.timeline = (
            TimelineRecorder(config.timeline_capacity)
            if config.timeline_capacity > 0 else None
        )
        self.requests_rerouted = 0
        self.streams_resumed = 0
        # Cross-tier signal windows: a bounded ring of
        # heartbeat-cadence samples of the pool's handoff counters, so
        # signals_snapshot() can answer with WINDOWED wire bandwidth,
        # handoff-latency delta-quantiles, and per-tier fault/restore
        # rates — the autopilot's read API for tier scaling, and the
        # observable counterpart of the NetKV bandwidth EWMA.
        self.tier_faults = {PREFILL: 0, DECODE: 0}
        self.tier_restores = {PREFILL: 0, DECODE: 0}
        self._signal_windows = windows_from_spec(config.signals_windows)
        interval = max(0.05, config.disagg_heartbeat_s)
        self._signal_ring: deque = deque(maxlen=min(
            8192, int(self._signal_windows[-1] / interval) + 2
        ))
        # Boot baseline: handoffs that land before the heartbeat's first
        # cadence sample must still show up as window deltas.
        self._sample_signals()
        # Coordinator black box (obs/postmortem.py): created by
        # create() when the pool has a state dir; carries the clock
        # offsets a postmortem needs to merge the workers' rings.
        self.blackbox: Optional[BlackBox] = None
        # Session stickiness: session key → worker index,
        # per tier. Prefill stickiness lands multi-turn users on their
        # warm prefix; decode stickiness amortizes the router's
        # transfer-cost learning per session.
        self._sticky: dict[str, dict[str, int]] = {PREFILL: {}, DECODE: {}}
        self._seed_rng = np.random.default_rng()
        self._stats_cache: dict = {}
        self._stats_cache_t = 0.0
        # Autopilot attachment point: the running controller
        # publishes itself here so /debug/slo and /metrics see it; the
        # knob setpoints it pushed are remembered so a respawned worker
        # (fresh process, config-default knobs) gets them re-applied.
        self.autopilot = None
        self._knob_setpoints: dict = {}
        # Requests currently parked in _wait_for_worker because their
        # tier has no SERVING member: token -> wait start. The age of
        # the oldest waiter is tier_now's queue-delay evidence DURING
        # an outage, when the dead tier's pings can say nothing — it
        # lets the controller scale up in parallel with the respawn
        # instead of discovering the backlog only after it.
        self._tier_waiters: dict = {PREFILL: {}, DECODE: {}}
        self._waiter_seq = 0

    # -- construction ---------------------------------------------------------

    @classmethod
    def create(
        cls,
        config: EngineConfig,
        health=None,
        logger=None,
        obs=None,
        seed: int = 0,
        workers: Optional[list] = None,
        restart_cb: Optional[Callable] = None,
        state_dir: Optional[str] = None,
        ready_timeout_s: float = 300.0,
        heartbeat: bool = True,
        device=None,
        mesh_workers: bool = False,
    ) -> "DisaggPool":
        """Build and start a wired pool.

        Default mode spawns ``config.disagg_tiers()`` worker PROCESSES
        (``python -m polykey_tpu_torch.engine.worker``, weights from
        `seed`) and learns their ports from the readiness handshake; a
        worker runs on the card unless `device` (or POLYKEY_DEVICE) says
        "cpu". A worker whose config has mesh axes above 1 (or, with
        `mesh_workers`, every worker, a mesh of one rank included) is a
        mesh of processes, one a rank (engine/worker.py); on the card each
        takes a run of cards of its own. Tests pass ``workers`` as
        ``[(tier, (host, port)), ...]``
        for pre-started in-process servers, plus ``restart_cb(worker) ->
        addr | None`` to stand in for process respawn."""
        tiers = config.disagg_tiers()
        if tiers is None and workers is None:
            raise ValueError("DisaggPool needs a POLYKEY_DISAGG spec or "
                             "an explicit worker list")
        recorder = obs.recorder if obs is not None else None
        pool = cls(config, health=health, logger=logger, recorder=recorder)
        pool._seed = seed
        pool._device = None if device is None else str(device)
        pool._mesh_workers = mesh_workers
        pool._state_dir = state_dir
        pool._ready_timeout_s = ready_timeout_s
        pool._restart_cb = restart_cb
        if state_dir and config.blackbox_every > 0:
            pool.blackbox = BlackBox(
                state_dir, "coordinator",
                timeline=pool.timeline, recorder=recorder,
                every=config.blackbox_every,
                meta={"tier": "coordinator"},
            )
        if workers is not None:
            counts: dict[str, int] = {}
            for tier, addr in workers:
                index = counts.get(tier, 0)
                counts[tier] = index + 1
                pool.workers.append(_Worker(
                    tier=tier, index=index, addr=tuple(addr), state=SERVING,
                ))
        else:
            n_prefill, n_decode = tiers
            for tier, count in ((PREFILL, n_prefill), (DECODE, n_decode)):
                for i in range(count):
                    worker = _Worker(tier=tier, index=i)
                    worker.spawn = pool._spawner(worker)
                    pool.workers.append(worker)
            for worker in pool.workers:      # in order, before any spawn
                pool._take_cards(worker)
            # Spawn concurrently: each worker pays its imports, its weights
            # and its graph capture before its readiness line, and the
            # spawns are independent — serial boot would cost N × that.
            spawn_errors: list = []

            def _boot(worker: _Worker) -> None:
                try:
                    worker.addr, worker.proc = worker.spawn()
                    worker.state = SERVING
                except Exception as e:
                    spawn_errors.append((worker.name, e))

            boot_threads = [
                threading.Thread(target=_boot, args=(w,), daemon=True)
                for w in pool.workers
            ]
            for thread in boot_threads:
                thread.start()
            for thread in boot_threads:
                thread.join(timeout=ready_timeout_s + 10)
            if spawn_errors:
                pool.shutdown()
                name, error = spawn_errors[0]
                raise RuntimeError(
                    f"disagg worker {name} failed to start: {error}"
                )
        # Seed stickiness from the workers' persisted prefix indexes
        # (warm rejoin: a restarted tier comes back knowing its users).
        for worker in pool.workers:
            pool._absorb_warm_sessions(worker)
        if heartbeat:
            pool._heartbeat_thread = threading.Thread(
                target=pool._heartbeat_loop, name="polykey-disagg-heartbeat",
                daemon=True,
            )
            pool._heartbeat_thread.start()
        if recorder is not None:
            recorder.event(
                "disagg_pool_started",
                prefill=sum(w.tier == PREFILL for w in pool.workers),
                decode=sum(w.tier == DECODE for w in pool.workers),
            )
        if logger is not None:
            logger.info(
                "disagg pool started",
                prefill=sum(w.tier == PREFILL for w in pool.workers),
                decode=sum(w.tier == DECODE for w in pool.workers),
                model=config.model,
            )
        return pool

    def _take_cards(self, worker: _Worker) -> Optional[tuple]:
        """The cards a worker of an n-rank mesh takes on the card, one a
        rank: the first run of n (cards 0..n-1, n..2n-1, ...) that no other
        worker of the pool holds, kept through the worker's respawns and
        freed when it leaves the pool (scale-down, a failed spawn). None
        for a worker of one rank or on the CPU. Raises when no run is
        free: two ranks on one card are refused by NCCL."""
        n = mesh_ranks(self.config)
        if n == 1 or not (self._device or "cuda").startswith("cuda"):
            return None
        with self._lock:
            if worker.cards is None:
                taken = {w.cards for w in self.workers if w is not worker}
                count = torch.cuda.device_count()
                runs = [tuple(range(first, first + n)) for first in range(0, count - n + 1, n)]
                free = [run for run in runs if run not in taken]
                if not free:
                    raise RuntimeError(
                        f"worker {worker.name} needs {n} cards of its own (a rank a "
                        f"card) and the host's {count} are taken by "
                        f"{len(taken - {None})} mesh workers")
                worker.cards = free[0]
            return worker.cards

    def _worker_command(self, worker: _Worker) -> tuple:
        """(argv, env) of one tier slot's worker process."""
        env = dict(os.environ)
        # Ship THIS pool's config: workers rebuild EngineConfig from
        # env, and a programmatically built pool would otherwise spawn
        # default-geometry engines.
        env.update(_config_env(self.config))
        env["POLYKEY_DISAGG"] = ""          # workers never recurse
        env["POLYKEY_REPLICAS"] = "1"
        # Workers never run their own control loop: the coordinator's
        # autopilot actuates them through the knobs op.
        env["POLYKEY_AUTOPILOT"] = "0"
        env["POLYKEY_METRICS_PORT"] = "0"   # the gateway's port only
        if self._device is not None:
            env[DEVICE_ENV] = self._device
        env["PYTHONPATH"] = (
            _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        ).rstrip(os.pathsep)
        cmd = [
            sys.executable, "-m", "polykey_tpu_torch.engine.worker",
            "--tier", worker.tier, "--replica", str(worker.index),
            "--port", "0", "--seed", str(self._seed),
        ]
        if self._mesh_workers:
            cmd.append("--mesh")
        cards = self._take_cards(worker)
        if cards is not None:
            cmd += ["--cards", ",".join(str(c) for c in cards)]
        return cmd, env

    def _spawner(self, worker: _Worker) -> Callable[[], tuple]:
        """Process factory for one tier slot: spawn, wait for the
        readiness handshake, return (addr, proc)."""

        def spawn() -> tuple:
            cmd, env = self._worker_command(worker)
            stderr = subprocess.DEVNULL
            if self._state_dir:
                cmd += ["--state-dir", self._state_dir]
                os.makedirs(self._state_dir, exist_ok=True)
                stderr = open(os.path.join(
                    self._state_dir, f"worker-{worker.role}.log"), "ab")
            t0 = time.monotonic()
            try:
                proc = subprocess.Popen(
                    cmd, cwd=_REPO_ROOT, env=env, stdout=subprocess.PIPE,
                    stderr=stderr, start_new_session=True,
                )
            finally:
                if stderr is not subprocess.DEVNULL:
                    stderr.close()          # the child holds its own copy
            line_q: queue.Queue = queue.Queue()

            def read_stdout() -> None:
                # The readiness line, then drain: a full pipe would block
                # the worker on its next write.
                line_q.put(proc.stdout.readline())
                for _ in proc.stdout:
                    pass

            threading.Thread(target=read_stdout, daemon=True).start()
            try:
                line = line_q.get(timeout=self._ready_timeout_s)
                ready = json.loads(line)
                assert ready.get("ready")
            except Exception:
                _kill(proc)
                raise RuntimeError(
                    f"worker {worker.name} never became ready "
                    f"(within {self._ready_timeout_s}s, exit code "
                    f"{proc.poll()})"
                ) from None
            worker.boot_s.append(time.monotonic() - t0)
            if self.logger is not None:
                self.logger.info("disagg worker ready", worker=worker.name,
                                 port=ready["port"], pid=ready.get("pid"),
                                 seconds=round(worker.boot_s[-1], 3))
            return ("127.0.0.1", int(ready["port"])), proc

        return spawn

    def _absorb_warm_sessions(self, worker: _Worker) -> None:
        """Fold the worker's advertised warm-session keys into the
        sticky map (first claim wins — a session already stuck
        elsewhere stays there)."""
        try:
            with WorkerConn(worker.addr, timeout=5.0) as conn:
                t_send = time.monotonic()
                reply, _ = conn.request({"op": "ping"}, timeout=5.0)
                t_recv = time.monotonic()
        except (OSError, ConnectionError, ValueError):
            return
        worker.ping = reply
        self._sync_clock(worker, reply, t_send, t_recv)
        sticky = self._sticky[worker.tier]
        with self._lock:
            for key in reply.get("warm_sessions", ()):
                sticky.setdefault(key, worker.index)

    # -- state machine / liveness --------------------------------------------

    def _transition(self, worker: _Worker, state: str,
                    only_from: Optional[tuple] = None) -> None:
        flip_down = flip_up = False
        with self._lock:
            if worker.state == state or worker.state == DEAD:
                return
            if only_from is not None and worker.state not in only_from:
                return
            previous = worker.state
            worker.state = state
            serving = self._tiers_serving_locked()
            if self._serving_advertised and not serving:
                self._serving_advertised = False
                flip_down = True
            elif not self._serving_advertised and serving:
                self._serving_advertised = True
                flip_up = True
        if self.timeline is not None:
            self.timeline.note(
                "worker_state", worker=worker.name, state=state,
                previous=previous,
            )
        if self.recorder is not None:
            self.recorder.event(
                "disagg_worker_state", worker=worker.name, state=state,
                previous=previous,
            )
        if self.logger is not None:
            self.logger.info("disagg worker state change",
                             worker=worker.name, state=state,
                             previous=previous)
        if self.health is not None and not self._closing:
            # Aggregate health flips on the "every tier has >= 1
            # SERVING worker" boundary — one worker's death is the
            # pool's problem, a whole tier's death is the balancer's.
            if flip_down:
                self.health.shutdown()
            elif flip_up:
                self.health.resume_serving()

    def _tiers_serving_locked(self) -> bool:
        return all(
            any(w.tier == tier and w.state == SERVING for w in self.workers)
            for tier in (PREFILL, DECODE)
        )

    def _on_worker_down(self, worker: _Worker, cause: str) -> None:
        if worker.retiring:
            # A draining scale-down target dying IS the plan (or close
            # enough): retire it instead of burning restart budget
            # respawning capacity the controller just decided to shed.
            self._transition(worker, DEAD)
            self._remove_worker(worker)
            return
        self._transition(worker, DRAINING, only_from=(NEW, SERVING))
        with self._lock:
            if worker.state != DRAINING:
                return
            self.tier_faults[worker.tier] = (
                self.tier_faults.get(worker.tier, 0) + 1
            )
            now = time.monotonic()
            worker.restart_times = [
                t for t in worker.restart_times
                if now - t < self.config.restart_window_s
            ]
            budget_left = (
                len(worker.restart_times) < self.config.max_engine_restarts
            )
            can_restart = (
                worker.spawn is not None or self._restart_cb is not None
            )
            if budget_left and can_restart and not self._closing:
                worker.state = RESTARTING
                worker.restart_times.append(now)
            else:
                worker.state = DEAD
        if worker.state == DEAD:
            self._transition(worker, DEAD)   # re-aggregate health + log
            return
        if self.logger is not None:
            self.logger.warn("disagg worker down; restarting",
                             worker=worker.name, cause=cause)
        threading.Thread(
            target=self._restart_worker, args=(worker,), daemon=True,
        ).start()

    def _restart_worker(self, worker: _Worker) -> None:
        if worker.proc is not None:
            _kill(worker.proc)
        if self._closing:
            self._transition(worker, DEAD)
            return
        try:
            if worker.spawn is not None:
                worker.addr, worker.proc = worker.spawn()
            else:
                addr = self._restart_cb(worker)
                if addr is None:
                    self._transition(worker, DEAD)
                    return
                worker.addr = tuple(addr)
        except Exception as e:
            if self.logger is not None:
                self.logger.error("disagg worker restart failed",
                                  worker=worker.name, error=str(e))
            self._transition(worker, DEAD)
            return
        if self._closing:
            # shutdown() raced the seconds-long spawn: its worker pass
            # already ran, so the FRESH process is ours to reap — left
            # alone it would outlive the pool with its port bound.
            if worker.proc is not None:
                _kill(worker.proc)
            self._transition(worker, DEAD)
            return
        worker.misses = 0
        worker.restarts += 1
        with self._lock:
            self.tier_restores[worker.tier] = (
                self.tier_restores.get(worker.tier, 0) + 1
            )
        self._absorb_warm_sessions(worker)   # rejoin warm (persisted index)
        self._push_knobs(worker)             # actuations outlive the respawn
        self._transition(worker, SERVING, only_from=(RESTARTING,))

    def _heartbeat_loop(self) -> None:
        interval = self.config.disagg_heartbeat_s
        while not self._stop_heartbeat.wait(interval):
            for worker in list(self.workers):
                if worker.state in (RESTARTING, DEAD) or self._closing:
                    continue
                if worker.proc is not None and worker.proc.poll() is not None:
                    self._on_worker_down(worker, "process exited")
                    continue
                try:
                    with WorkerConn(worker.addr, timeout=interval) as conn:
                        t_send = time.monotonic()
                        reply, _ = conn.request({"op": "ping"},
                                                timeout=interval)
                        t_recv = time.monotonic()
                    worker.ping = reply
                    worker.misses = 0
                    # Clock re-estimation rides every heartbeat: the
                    # drift-aged best-sample filter in ClockSync keeps
                    # the offset's uncertainty near RTT/2 forever.
                    self._sync_clock(worker, reply, t_send, t_recv)
                    if reply.get("state") == "DEAD":
                        self._transition(worker, DEAD)
                    elif reply.get("state") == "SERVING" and \
                            not worker.retiring:
                        # A retiring worker pings healthy all the way
                        # through its drain — never re-promote it.
                        self._transition(worker, SERVING,
                                         only_from=(NEW, DRAINING))
                except (OSError, ConnectionError, ValueError):
                    worker.misses += 1
                    if worker.misses >= self.config.disagg_miss:
                        self._on_worker_down(worker, "heartbeat missed")
            self._sample_signals()
            if self.blackbox is not None:
                # The coordinator's box carries the clock offsets a
                # postmortem needs to merge worker rings — refresh them
                # right before the checkpoint.
                self.blackbox.meta["clock_offsets"] = self.clock_offsets()
                self.blackbox.tick(force=True)

    def _sync_clock(self, worker: _Worker, reply: dict,
                    t_send: float, t_recv: float) -> None:
        pid = reply.get("pid")
        if pid is not None and pid != worker.last_pid:
            if worker.last_pid is not None:
                # New process, new monotonic epoch: the old offset is
                # meaningless and must not age gracefully.
                worker.clock.reset()
            worker.last_pid = pid
        mono = reply.get("mono")
        if isinstance(mono, (int, float)):
            worker.clock.update(t_send, t_recv, float(mono))

    # -- elastic capacity (the autopilot's actuation surface) ----------------

    def tier_now(self) -> dict:
        """Instantaneous per-tier capacity + pressure: the autopilot's
        scaling evidence. queue_delay_s is the mean across the tier's
        serving workers' last heartbeat pings; during an outage, when
        the dead tier's pings can say nothing, the ages of the requests
        parked in _wait_for_worker join the mean instead. None (never
        zero) when neither exists: no evidence, no verdict."""
        out: dict = {}
        now = time.monotonic()
        with self._lock:
            members = {
                tier: [w for w in self.workers if w.tier == tier]
                for tier in (PREFILL, DECODE)
            }
            waiting = {
                tier: [now - t0 for t0 in self._tier_waiters[tier].values()]
                for tier in (PREFILL, DECODE)
            }
        for tier, workers in members.items():
            serving = [w for w in workers if w.state == SERVING]
            delays = [
                float(w.ping["queue_delay_s"])
                for w in serving
                if w.ping.get("queue_delay_s") is not None
            ]
            delays += waiting.get(tier, [])
            loads = [
                float(w.ping["load"]) for w in serving
                if w.ping.get("load") is not None
            ]
            out[tier] = {
                "serving": len(serving),
                "total": sum(w.state != DEAD for w in workers),
                "queue_delay_s": (
                    round(sum(delays) / len(delays), 4) if delays else None
                ),
                "load": (
                    round(sum(loads) / len(loads), 4) if loads else None
                ),
            }
        return out

    def scale_up(self, tier: str) -> Optional[str]:
        """Grow `tier` by one worker. The new member enters in
        RESTARTING (the heartbeat skips it until its addr exists) and
        the seconds-long spawn runs on a background thread — the
        controller tick must never block on a worker's start. Returns the
        new worker's name, or None when the pool can't spawn."""
        if self._closing or not hasattr(self, "_seed"):
            return None   # test-constructed pool: no process factory
        with self._lock:
            indices = [w.index for w in self.workers if w.tier == tier]
            worker = _Worker(
                tier=tier, index=(max(indices) + 1 if indices else 0),
                state=RESTARTING,
            )
            self.workers.append(worker)
        # Closure construction only (the actual Popen + ready-wait run
        # on the _boot thread) — but it lives outside the lock so the
        # critical section provably never reaches a blocking call.
        worker.spawn = self._spawner(worker)
        if self.timeline is not None:
            self.timeline.note("tier_scale_up", tier=tier,
                               worker=worker.name)

        def _boot() -> None:
            try:
                worker.addr, worker.proc = worker.spawn()
            except Exception as e:
                if self.logger is not None:
                    self.logger.error("tier scale-up spawn failed",
                                      worker=worker.name, error=str(e))
                self._remove_worker(worker)
                return
            if self._closing:
                _kill(worker.proc)
                self._remove_worker(worker)
                return
            self._absorb_warm_sessions(worker)
            self._push_knobs(worker)
            self._transition(worker, SERVING, only_from=(RESTARTING,))

        threading.Thread(target=_boot, daemon=True).start()
        return worker.name

    def scale_down(self, tier: str) -> Optional[str]:
        """Shrink `tier` by one worker — drain before kill. The
        highest-index SERVING worker flips to DRAINING (instantly out
        of routing), then a background thread waits for its in-flight
        work to finish before the exit op + kill. Refuses (None) when
        the tier has no second serving worker to leave behind."""
        with self._lock:
            serving = sorted(
                (w for w in self.workers
                 if w.tier == tier and w.state == SERVING),
                key=lambda w: w.index,
            )
            if len(serving) < 2:
                return None
            worker = serving[-1]
            worker.retiring = True
        self._transition(worker, DRAINING, only_from=(SERVING,))
        if self.timeline is not None:
            self.timeline.note("tier_scale_down", tier=tier,
                               worker=worker.name)
        threading.Thread(
            target=self._drain_and_retire, args=(worker,), daemon=True,
        ).start()
        return worker.name

    def _drain_and_retire(self, worker: _Worker) -> None:
        deadline = time.monotonic() + max(
            5.0, 2.0 * self.config.disagg_recovery_wait_s
        )
        poll = min(0.2, self.config.disagg_heartbeat_s)
        while time.monotonic() < deadline and not self._closing:
            try:
                with WorkerConn(worker.addr, timeout=2.0) as conn:
                    reply, _ = conn.request({"op": "ping"}, timeout=2.0)
                if (reply.get("slots_busy", 0) == 0
                        and reply.get("queued", 0) == 0
                        and reply.get("retained_handoffs", 0) == 0):
                    break
            except (OSError, ConnectionError, ValueError):
                break   # already gone; retirement proceeds
            time.sleep(poll)
        try:
            with WorkerConn(worker.addr, timeout=2.0) as conn:
                conn.request({"op": "exit"}, timeout=2.0)
        except (OSError, ConnectionError, ValueError):
            pass
        if worker.proc is not None:
            _stop(worker.proc, 5.0)
        self._transition(worker, DEAD)
        self._remove_worker(worker)

    def _remove_worker(self, worker: _Worker) -> None:
        """Drop a retired/never-booted worker from the pool. Sticky
        entries pointing at the removed index are left alone: routing
        treats a sticky miss as a plain re-score (the removed-index
        safety the sticky map already guarantees)."""
        with self._lock:
            try:
                self.workers.remove(worker)
            except ValueError:
                pass

    def apply_knobs(self, knobs: dict) -> dict:
        """Broadcast live-knob setpoints to every SERVING worker (the
        autopilot's cross-process actuation path) and remember them so
        respawns and future scale-ups boot onto the same setpoints.
        Returns the last worker's post-clamp applied dict (tiers run
        identical configs, so any worker's clamp is THE clamp)."""
        with self._lock:
            # polylint: disable=ML002(keyed by knob name: 4 static engine-knob names from _ENGINE_KNOB_SETTERS, not per-request data)
            self._knob_setpoints.update(knobs)
            targets = [w for w in self.workers if w.state == SERVING]
        applied: dict = dict(knobs)
        for worker in targets:
            got = self._push_knobs(worker)
            if got:
                applied = got
        return applied

    def _push_knobs(self, worker: _Worker) -> Optional[dict]:
        with self._lock:
            knobs = dict(self._knob_setpoints)
        if not knobs or worker.addr is None:
            return None
        try:
            with WorkerConn(worker.addr, timeout=2.0) as conn:
                reply, _ = conn.request(
                    {"op": "knobs", "knobs": knobs}, timeout=2.0
                )
            return reply.get("applied") or None
        except (OSError, ConnectionError, ValueError):
            return None   # heartbeat owns liveness; a miss here is fine

    # -- engine-shaped surface ------------------------------------------------

    @property
    def dead(self) -> Optional[str]:
        if self._closing:
            return "engine is shut down"
        with self._lock:
            for tier in (PREFILL, DECODE):
                members = [w for w in self.workers if w.tier == tier]
                if members and all(w.state == DEAD for w in members):
                    return (f"all {tier}-tier workers dead "
                            "(restart budgets exhausted)")
        return None

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight > 0

    def submit(self, request: GenRequest) -> None:
        """Tier-aware admission + one orchestration thread per request.
        Sheds (RESOURCE_EXHAUSTED + retry-after) when the in-flight set
        already oversubscribes the decode tier's slot capacity by the
        configured queue bound — the coordinator's O(1) mirror of the
        engine's bounded-queue discipline."""
        dead = self.dead
        if dead is not None:
            raise EngineDeadError(
                dead, retry_after_ms=int(
                    1000 * self.config.disagg_heartbeat_s * 2
                ),
            )
        limit = self.config.max_queue_depth
        if limit > 0:
            decode_slots = sum(
                self.config.max_decode_slots
                for w in self.workers if w.tier == DECODE
            )
            with self._lock:
                over = self._inflight >= decode_slots + limit
            if over:
                raise EngineOverloadedError(
                    f"disagg pool saturated ({self._inflight} in flight)",
                    retry_after_ms=100,
                )
        if request.seed is None and request.temperature > 0.0:
            # Fix the sampling root NOW: a re-routed attempt must replay
            # the same stream (the replica_pool contract).
            request.seed = int(self._seed_rng.integers(0, 1 << 63))
        with self._lock:
            self._inflight += 1
        threading.Thread(
            target=self._serve_request, args=(request,), daemon=True,
        ).start()

    def shutdown(self, timeout: float = 10.0) -> None:
        self._closing = True
        self._stop_heartbeat.set()
        if self.autopilot is not None:
            self.autopilot.stop()
        if self.blackbox is not None:
            # Final checkpoint with fresh offsets: a postmortem over a
            # cleanly-stopped pool should still merge.
            self.blackbox.meta["clock_offsets"] = self.clock_offsets()
            self.blackbox.tick(force=True)
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=2.0)
        for worker in list(self.workers):
            if worker.addr is not None:
                try:
                    with WorkerConn(worker.addr, timeout=2.0) as conn:
                        conn.request({"op": "exit"}, timeout=2.0)
                except (OSError, ConnectionError, ValueError):
                    pass
            if worker.proc is not None:
                _stop(worker.proc, timeout)

    # -- routing --------------------------------------------------------------

    def _serving(self, tier: str) -> list[_Worker]:
        with self._lock:
            return [
                w for w in self.workers
                if w.tier == tier and w.state == SERVING
            ]

    def _wait_for_worker(self, tier: str, skey: str,
                         payload_bytes: int = 0) -> Optional[_Worker]:
        """Pick the best SERVING worker of `tier`; when the tier is
        momentarily empty (a restart in flight), wait up to the
        recovery budget — the zero-loss contract rides on re-routes
        outlasting a supervised worker restart. Failed workers need no
        explicit exclusion: a death already moved them out of SERVING
        via the state machine."""
        deadline = time.monotonic() + self.config.disagg_recovery_wait_s
        token = None
        try:
            while True:
                candidates = self._serving(tier)
                if candidates:
                    return self._score(tier, candidates, skey,
                                       payload_bytes)
                if token is None:
                    with self._lock:
                        self._waiter_seq += 1
                        token = self._waiter_seq
                        self._tier_waiters[tier][token] = time.monotonic()
                if time.monotonic() >= deadline or self._closing:
                    return None
                time.sleep(min(0.05, self.config.disagg_heartbeat_s))
        finally:
            if token is not None:
                with self._lock:
                    self._tier_waiters[tier].pop(token, None)

    def _score(self, tier: str, candidates: list[_Worker], skey: str,
               payload_bytes: int) -> _Worker:
        """NetKV-style selection. Decode: minimize estimated transfer
        cost (bytes / measured bandwidth EWMA) + queue-delay EWMA, with
        a small session-sticky bonus. Prefill: session-sticky first
        (warm prefix beats any queue-delay difference at these scales),
        then least delay. Ties break on the lowest index —
        deterministic given equal state."""
        sticky = self._sticky[tier].get(skey)
        if tier == PREFILL and sticky is not None:
            for worker in candidates:
                if worker.index == sticky:
                    return worker
        scored = []
        for worker in candidates:
            delay = float(worker.ping.get("queue_delay_s", 0.0) or 0.0)
            load = float(worker.ping.get("load", 0.0) or 0.0)
            transfer = 0.0
            if tier == DECODE and payload_bytes:
                bw = worker.bw_ewma or _BW_PRIOR
                transfer = payload_bytes / bw
            bonus = 0.001 if sticky == worker.index else 0.0
            score = transfer + delay + 1e-3 * load - bonus
            scored.append((score, worker.index, worker))
        scored.sort(key=lambda entry: (entry[0], entry[1]))
        chosen = scored[0][2]
        with self._lock:
            self._sticky[tier][skey] = chosen.index
        return chosen

    # -- per-request orchestration --------------------------------------------

    def _serve_request(self, request: GenRequest) -> None:
        try:
            self._orchestrate(request)
        except _Terminal:
            pass   # the request already received its terminal event
        except Exception as e:  # the thread must never die silently
            request.out.put(("error", f"engine: disagg orchestration "
                                      f"crashed: {e}"))
            if self.logger is not None:
                import traceback

                self.logger.error("disagg orchestration crashed",
                                  error=str(e),
                                  traceback=traceback.format_exc())
        finally:
            with self._lock:
                self._inflight -= 1

    def _orchestrate(self, request: GenRequest) -> None:
        ids = np.asarray(self.tokenizer.encode(request.prompt), np.int32)
        skey = session_key(ids, self.config.page_size)
        handoff_id = uuid.uuid4().hex
        blob: Optional[bytes] = None
        meta: dict = {}
        source: Optional[_Worker] = None
        delivered = 0
        reroutes = 0
        # Flow-control retries (worker sheds) wait out the worker's
        # retry-after hint instead of burning the re-route budget; this
        # cap only backstops a tier that sheds for minutes on end.
        flow_retries = 0
        while True:
            if request.cancelled.is_set():
                request.out.put(("error", "cancelled"))
                return
            if (request.deadline is not None
                    and time.monotonic() >= request.deadline):
                request.out.put((
                    "error", "deadline exceeded while re-routing",
                ))
                return
            t_handoff = time.monotonic()
            try:
                if blob is None:
                    prefill_worker = self._wait_for_worker(PREFILL, skey)
                    if prefill_worker is None:
                        self._count("aborted")
                        request.out.put((
                            "error",
                            "engine: no serving prefill-tier worker",
                        ))
                        return
                    blob, meta, source = self._run_prefill(
                        prefill_worker, request, handoff_id, skey
                    )
                decode_worker = self._wait_for_worker(
                    DECODE, skey, payload_bytes=len(blob)
                )
                if decode_worker is None:
                    self._count("aborted")
                    request.out.put((
                        "error", "engine: no serving decode-tier worker",
                    ))
                    return
                delivered = self._run_decode(
                    decode_worker, request, blob, meta, delivered, source,
                    t_handoff,
                )
                self._release(source, handoff_id)
                return
            except _HandoffRetry as e:
                delivered = max(delivered, getattr(e, "delivered", delivered))
                if e.restart_prefill:
                    blob = None
                    source = None
                if e.flow_control:
                    # A shed, not a death: honor the worker's
                    # retry-after hint; no budget burn, no failover
                    # metrics (the gateway-level shed already carries
                    # the client-facing RESOURCE_EXHAUSTED contract).
                    flow_retries += 1
                    if flow_retries > 100:
                        self._count("aborted")
                        request.out.put((
                            "error",
                            f"engine: tier kept shedding ({e.phase}: {e})",
                        ))
                        return
                    time.sleep(max(0.02, e.retry_after_s))
                    continue
                reroutes += 1
                if self.timeline is not None:
                    self.timeline.note(
                        "handoff_abort", phase=e.phase, cause=str(e),
                        reroutes=reroutes, handoff_id=handoff_id,
                        trace=self._trace_id(request),
                    )
                if self.recorder is not None:
                    self.recorder.event(
                        "disagg_handoff_abort", phase=e.phase,
                        cause=str(e), reroutes=reroutes,
                    )
                if reroutes > self.config.max_reroutes:
                    self._count("aborted")
                    request.out.put((
                        "error",
                        f"engine: handoff failed after {reroutes - 1} "
                        f"re-routes ({e.phase}: {e})",
                    ))
                    return
                self._count("retried")
                with self._lock:
                    self.requests_rerouted += 1
                    if delivered > 0:
                        self.streams_resumed += 1
                if delivered > 0:
                    request.restarted = True
                if not e.mark_down:
                    time.sleep(0.05)   # link event, not death: brief pause

    def _count(self, outcome: str) -> None:
        with self._lock:
            self.handoffs[outcome] += 1

    def _release(self, source: Optional[_Worker], handoff_id: str) -> None:
        """Phase 2 of the hand-over: decode is done, the source may drop
        its retained copy. Best-effort — a dead source already lost it."""
        if source is None or source.addr is None:
            return
        try:
            with WorkerConn(source.addr, timeout=2.0) as conn:
                conn.request({"op": "release", "handoff_id": handoff_id},
                             timeout=2.0)
        except (OSError, ConnectionError, ValueError):
            pass

    def _deadline_in_s(self, request: GenRequest) -> Optional[float]:
        if request.deadline is None:
            return None
        return max(0.0, request.deadline - time.monotonic())

    @staticmethod
    def _trace_id(request: GenRequest) -> Optional[str]:
        return request.trace.trace_id if request.trace is not None else None

    def _req_dict(self, request: GenRequest) -> dict:
        return {
            "prompt": request.prompt,
            "max_new_tokens": request.max_new_tokens,
            "temperature": request.temperature,
            "top_p": request.top_p,
            "top_k": request.top_k,
            "seed": request.seed,
            "deadline_in_s": self._deadline_in_s(request),
            # Trace propagation: the gateway's x-trace-id
            # rides every control-plane op so worker-side spans and
            # timeline notes join the same distributed trace.
            "trace_id": self._trace_id(request),
        }

    def _graft_worker_trace(self, request: GenRequest, worker: _Worker,
                            wire: Optional[dict]) -> None:
        """Attach a worker's shipped span tree (absolute monotonic
        start/end on ITS clock) under the gateway root, re-timed onto
        the coordinator clock via the worker's heartbeat offset. Skipped
        when no offset has landed yet — an unaligned subtree would
        mis-order the root's children."""
        if wire is None or request.trace is None:
            return
        offset = worker.clock.offset
        if offset is None:
            return
        self._graft_node(request.trace, wire, offset, worker=worker.name)

    def _graft_node(self, parent, wire: dict, offset: float,
                    **extra) -> None:
        start = wire.get("start")
        end = wire.get("end")
        child = parent.child(
            str(wire.get("name", "span")),
            start=(start + offset
                   if isinstance(start, (int, float)) else None),
            end=(end + offset if isinstance(end, (int, float)) else None),
            **{**(wire.get("attrs") or {}), **extra},
        )
        for sub in wire.get("children") or ():
            if isinstance(sub, dict):
                self._graft_node(child, sub, offset)

    def _run_prefill(self, worker: _Worker, request: GenRequest,
                     handoff_id: str, skey: str) -> tuple:
        """Prefill + fetch: returns (blob, meta, worker). Any failure —
        socket death, worker error, corrupt blob — marks the worker and
        raises a retryable _HandoffRetry (the blob never half-applies:
        validation precedes any ship)."""
        if self.timeline is not None:
            self.timeline.note(
                "handoff_start", worker=worker.name,
                handoff_id=handoff_id, session=skey,
                trace=self._trace_id(request),
            )
        try:
            with WorkerConn(worker.addr, timeout=30.0) as conn:
                req = self._req_dict(request)
                req["handoff_id"] = handoff_id
                conn.send({"op": "prefill", "req": req})
                meta: dict = {}
                timeout = self.config.request_timeout_s
                while True:
                    event, _ = conn.recv(timeout=timeout)
                    kind = event.get("event")
                    if kind == "handoff_ready":
                        meta = event
                        request.timings.prompt_tokens = int(
                            event.get("prompt_tokens", 0)
                        )
                    elif kind == "done":
                        self._graft_worker_trace(request, worker,
                                                 event.get("trace"))
                        break
                    elif kind == "error":
                        if event.get("shed"):
                            raise _HandoffRetry(
                                event.get("message", "shed"),
                                "prefill", restart_prefill=True,
                                mark_down=False, flow_control=True,
                                retry_after_s=(
                                    event.get("retry_after_ms") or 100
                                ) / 1000.0,
                            )
                        message = event.get("message", "prefill failed")
                        if message.startswith("engine"):
                            raise _HandoffRetry(message, "prefill",
                                                restart_prefill=True)
                        # Request-outcome failure (deadline, bad input):
                        # not the worker's fault, never re-routed.
                        request.out.put(("error", message))
                        raise _Terminal()
                    else:
                        raise _HandoffRetry(
                            f"unexpected prefill event {kind!r}",
                            "prefill", restart_prefill=True,
                        )
                if not meta:
                    raise _HandoffRetry("prefill produced no handoff",
                                        "prefill", restart_prefill=True)
                t_fetch = time.monotonic()
                reply, blob = conn.request(
                    {"op": "fetch", "handoff_id": handoff_id},
                    timeout=timeout,
                )
                if request.trace is not None and reply.get("ok"):
                    # Wire hop 1 of the handoff: prefill → coordinator.
                    request.trace.child(
                        "handoff_fetch", start=t_fetch,
                        end=time.monotonic(), bytes=len(blob),
                        worker=worker.name, handoff_id=handoff_id,
                    )
                if not reply.get("ok"):
                    raise _HandoffRetry(
                        reply.get("error", "fetch failed"), "handoff",
                        restart_prefill=True,
                    )
        except _Terminal:
            raise
        except _HandoffRetry as e:
            if e.mark_down:
                self._on_worker_down(worker, "prefill attempt failed")
            raise
        except (OSError, ConnectionError, ValueError) as e:
            self._on_worker_down(worker, f"prefill/handoff failed: {e}")
            raise _HandoffRetry(str(e) or "connection lost", "handoff",
                                restart_prefill=True) from e
        try:
            validate_kv_blob(blob)
        except KVWireError as e:
            # Partial write / corrupt ship: clean re-route (re-run the
            # prefill), never a half-applied pool — the decode tier
            # never sees this blob. The worker itself stays SERVING: a
            # torn transfer is a link event, and killing the source
            # would turn one bad ship into lost tier capacity.
            raise _HandoffRetry(str(e), "handoff", restart_prefill=True,
                                mark_down=False) from e
        with self._lock:
            self.handoff_bytes += len(blob)
        return blob, meta, worker

    def _run_decode(self, worker: _Worker, request: GenRequest,
                    blob: bytes, meta: dict, delivered: int,
                    source: Optional[_Worker],
                    t_handoff: float) -> int:
        """Ship the blob, stream the decode, forward the suffix the
        client is missing. Returns the total delivered count; raises
        _HandoffRetry carrying it on a recoverable failure."""
        seen = 0
        try:
            with WorkerConn(worker.addr, timeout=30.0) as conn:
                req = self._req_dict(request)
                req["handoff_id"] = meta.get("handoff_id")
                t_ship = time.monotonic()
                conn.send({"op": "decode", "req": req}, blob)
                timeout = self.config.request_timeout_s
                event, _ = conn.recv(timeout=timeout)
                if event.get("event") != "accepted":
                    message = event.get("message", "decode rejected")
                    if event.get("shed"):
                        raise _HandoffRetry(
                            message, "decode", restart_prefill=False,
                            mark_down=False, flow_control=True,
                            retry_after_s=(
                                event.get("retry_after_ms") or 100
                            ) / 1000.0,
                        )
                    if "kv-handoff" in message:
                        # The blob itself was rejected (the engine wraps
                        # the typed marker as "admission failed:
                        # kv-handoff rejected: …"): re-run prefill —
                        # re-shipping the same bytes cannot succeed.
                        raise _HandoffRetry(message, "decode",
                                            restart_prefill=True,
                                            mark_down=False)
                    if message.startswith("engine"):
                        raise _HandoffRetry(message, "decode",
                                            restart_prefill=False)
                    request.out.put(("error", message))
                    raise _Terminal()
                t_accepted = time.monotonic()
                ship_s = max(1e-6, t_accepted - t_ship)
                measured = len(blob) / ship_s
                worker.bw_ewma = (
                    measured if worker.bw_ewma == 0.0
                    else 0.7 * worker.bw_ewma + 0.3 * measured
                )
                # Exemplar: the handoff-latency
                # bucket this observation lands in links back to the
                # request's span tree on an OpenMetrics scrape.
                self.handoff_ms.observe(
                    (t_accepted - t_handoff) * 1e3,
                    trace_id=self._trace_id(request),
                )
                if request.trace is not None:
                    # Wire hop 2: coordinator → decode worker, ending
                    # when the worker accepted (deserialize included —
                    # its split ships back in the accepted frame and the
                    # worker's own tree carries the exact child).
                    request.trace.child(
                        "handoff_ship", start=t_ship, end=t_accepted,
                        bytes=len(blob), worker=worker.name,
                        deserialize_ms=event.get("deserialize_ms"),
                    )
                if self.timeline is not None:
                    self.timeline.note(
                        "handoff_ack", worker=worker.name,
                        bytes=len(blob),
                        ship_ms=round(ship_s * 1e3, 3),
                        handoff_id=meta.get("handoff_id"),
                        trace=self._trace_id(request),
                    )
                request.replica = worker.index
                request.tier = (
                    f"prefill={source.index if source else '?'},"
                    f"decode={worker.index}"
                )
                while True:
                    event, _ = conn.recv(timeout=timeout)
                    kind = event.get("event")
                    if kind == "token":
                        seen += 1
                        if seen <= delivered:
                            continue     # client already holds it
                        delivered += 1
                        timings = request.timings
                        if timings.first_token == 0.0:
                            timings.first_token = time.monotonic()
                            if timings.prefill_start == 0.0:
                                timings.prefill_start = timings.enqueued
                        request.out.put(("token", int(event["id"])))
                        if request.cancelled.is_set():
                            request.out.put(("error", "cancelled"))
                            raise _Terminal()
                    elif kind == "done":
                        timings = request.timings
                        timings.finished = time.monotonic()
                        timings.completion_tokens = delivered
                        remote = event.get("timings") or {}
                        timings.device_ms += float(
                            remote.get("device_ms", 0.0) or 0.0
                        )
                        self._graft_worker_trace(request, worker,
                                                 event.get("trace"))
                        # Count BEFORE delivering the terminal event: a
                        # client that consumes "done" and immediately
                        # reads stats() must see this handoff as ok.
                        self._count("ok")
                        request.out.put(("done", timings))
                        return delivered
                    elif kind == "error":
                        message = event.get("message", "decode failed")
                        if "kv-handoff" in message:
                            raise _HandoffRetry(message, "decode",
                                                restart_prefill=True,
                                                mark_down=False)
                        if message.startswith("engine"):
                            raise _HandoffRetry(message, "decode",
                                                restart_prefill=False)
                        request.out.put(("error", message))
                        raise _Terminal()
                    else:
                        raise _HandoffRetry(
                            f"unexpected decode event {kind!r}", "decode",
                            restart_prefill=False,
                        )
        except (_Terminal, _HandoffRetry) as e:
            if isinstance(e, _HandoffRetry):
                e.delivered = delivered
                if e.mark_down:
                    self._on_worker_down(worker,
                                         f"decode attempt failed: {e}")
            raise
        except (OSError, ConnectionError, ValueError) as e:
            self._on_worker_down(worker, f"decode stream died: {e}")
            retry = _HandoffRetry(str(e) or "connection lost", "decode",
                                  restart_prefill=False)
            retry.delivered = delivered
            raise retry from e

    # -- stats / exposition ---------------------------------------------------

    def _worker_stats(self, worker: _Worker) -> dict:
        try:
            with WorkerConn(worker.addr, timeout=3.0) as conn:
                reply, _ = conn.request({"op": "stats"}, timeout=3.0)
            if reply.get("ok"):
                worker.stats = reply["stats"]
        except (OSError, ConnectionError, ValueError):
            pass  # keep the cached snapshot; liveness is heartbeat's job
        snap = dict(worker.stats)
        snap["tier"] = worker.tier
        snap["replica"] = worker.index
        snap["state"] = worker.state
        snap["worker_restarts"] = worker.restarts
        return snap

    def stats(self) -> dict:
        """Aggregate pool stats, replica_pool-shaped: additive engine
        counters summed across workers, per-worker snapshots under
        `per_worker`, tier/handoff extras on top. Snapshots refresh at
        most every 0.5 s so scrape storms never amplify into control-
        plane storms."""
        now = time.monotonic()
        with self._lock:
            cached = self._stats_cache if (
                self._stats_cache and now - self._stats_cache_t < 0.5
            ) else None
        if cached is not None:
            return cached
        per = [self._worker_stats(w) for w in list(self.workers)]
        agg: dict = {}
        for snap in per:
            for key, value in snap.items():
                if key in _ADDITIVE_KEYS and isinstance(value, (int, float)):
                    agg[key] = agg.get(key, 0) + value
        agg["model"] = self.config.model
        with self._lock:
            agg["workers_total"] = len(self.workers)
            agg["workers_serving"] = sum(
                w.state == SERVING for w in self.workers
            )
            agg["tier_states"] = {
                w.name: w.state for w in self.workers
            }
            agg["tiers"] = {
                tier: {
                    "total": sum(w.tier == tier for w in self.workers),
                    "serving": sum(
                        w.tier == tier and w.state == SERVING
                        for w in self.workers
                    ),
                }
                for tier in (PREFILL, DECODE)
            }
            agg["requests_rerouted"] = self.requests_rerouted
            agg["streams_resumed"] = self.streams_resumed
            agg["handoffs"] = dict(self.handoffs)
            agg["handoff_bytes"] = self.handoff_bytes
            agg["inflight_requests"] = self._inflight
        agg["handoff_ms_p50"] = round(self.handoff_ms.percentile(50), 2)
        agg["handoff_ms_p95"] = round(self.handoff_ms.percentile(95), 2)
        agg["per_worker"] = per
        agg["tier_faults"] = dict(self.tier_faults)
        agg["tier_restores"] = dict(self.tier_restores)
        agg["clock_offsets"] = self.clock_offsets()
        with self._lock:
            self._stats_cache = agg
            self._stats_cache_t = now
        return agg

    # -- cross-process flight deck ---------------------------------------------

    def clock_offsets(self) -> dict:
        """Per-worker ClockSync snapshots, keyed by black-box role —
        the merge key shared by live merged_timelines() and the
        postmortem's offline merge."""
        return {w.role: w.clock.snapshot() for w in list(self.workers)}

    def handoff_now(self) -> dict:
        """Instantaneous handoff signals: the per-decode-worker ship
        bandwidth EWMA the NetKV router scores on, beside the windowed
        deltas of `signal_windows` (/debug/slo's pool_now)."""
        return {
            "wire_bw_ewma_bytes_per_s": {
                w.role: round(w.bw_ewma, 1)
                for w in list(self.workers)
                if w.tier == DECODE and w.bw_ewma > 0.0
            },
        }

    def _sample_signals(self) -> None:
        """One heartbeat-cadence sample of the pool's handoff counters.
        The ring stores ABSOLUTE counters; signal_windows() diffs two
        samples into per-window deltas — same discipline as the
        engine-side SignalPlane, so quantiles are over the window, not
        since boot."""
        counts, hsum = self.handoff_ms.counts_snapshot()
        with self._lock:
            self._signal_ring.append((
                time.monotonic(), counts, hsum, self.handoff_bytes,
                dict(self.handoffs), dict(self.tier_faults),
                dict(self.tier_restores),
            ))

    def signal_windows(self) -> dict:
        """Windowed cross-tier handoff signals — the autopilot read API
        for tier scaling. Per configured window: handoff outcome deltas,
        wire bandwidth (handoff bytes over covered wall time), handoff
        latency delta-quantiles, and per-tier fault/restore rates."""
        with self._lock:
            ring = list(self._signal_ring)
        if len(ring) < 2:
            return {}
        now_t, now_counts, _, now_bytes, now_outcomes, now_faults, \
            now_restores = ring[-1]
        out: dict = {}
        for window in self._signal_windows:
            base = ring[0]
            # Oldest-first fallback: a young pool reports what it has,
            # with covered_s telling the truth about how much that is.
            for sample in reversed(ring[:-1]):
                if now_t - sample[0] >= window:
                    base = sample
                    break
            (base_t, base_counts, _, base_bytes, base_outcomes,
             base_faults, base_restores) = base
            covered = now_t - base_t
            if covered <= 0:
                continue
            delta_counts = [
                max(0, n - b) for n, b in zip(now_counts, base_counts)
            ]
            n = sum(delta_counts)
            bytes_delta = max(0, now_bytes - base_bytes)
            faults = {
                tier: max(0, now_faults.get(tier, 0)
                          - base_faults.get(tier, 0))
                for tier in (PREFILL, DECODE)
            }
            out[window_label(window)] = {
                "covered_s": round(covered, 3),
                "handoffs": {
                    outcome: max(0, now_outcomes.get(outcome, 0)
                                 - base_outcomes.get(outcome, 0))
                    for outcome in _OUTCOMES
                },
                "handoff_bytes": bytes_delta,
                "wire_bandwidth_bytes_per_s": round(
                    bytes_delta / covered, 1),
                "handoff_ms_count": n,
                "handoff_ms_p50": round(estimate_quantile(
                    self.handoff_ms.bounds, delta_counts, n, 50), 2),
                "handoff_ms_p95": round(estimate_quantile(
                    self.handoff_ms.bounds, delta_counts, n, 95), 2),
                "tier_faults": faults,
                "tier_restores": {
                    tier: max(0, now_restores.get(tier, 0)
                              - base_restores.get(tier, 0))
                    for tier in (PREFILL, DECODE)
                },
                "fault_rate_per_min": round(
                    sum(faults.values()) * 60.0 / covered, 3),
            }
        return out

    def worker_timeline(self, worker: _Worker) -> Optional[list]:
        """Fetch one worker's live timeline ring over the control
        plane; None when the worker is unreachable (the caller falls
        back to its black-box file)."""
        if worker.addr is None:
            return None
        try:
            with WorkerConn(worker.addr, timeout=3.0) as conn:
                reply, _ = conn.request({"op": "timeline"}, timeout=3.0)
        except (OSError, ConnectionError, ValueError):
            return None
        if not reply.get("ok"):
            return None
        return reply.get("events") or []

    def merged_timelines(self) -> list:
        """The clock-aligned merged timeline: one (pid, label, events)
        group per process — the coordinator's own ring at offset 0 plus
        every worker's ring mapped onto the coordinator's clock by its
        ClockSync offset. Dead workers contribute their last black-box
        checkpoint, so a merge after a crash still shows the victim's
        final seconds."""
        groups: list = []
        if self.timeline is not None:
            groups.append((0, "coordinator",
                           self.timeline.events() or [], 0.0))
        state_dir = getattr(self, "_state_dir", None)
        for pid, worker in enumerate(list(self.workers), start=1):
            events = self.worker_timeline(worker)
            if events is None and state_dir:
                events = _blackbox_timeline(state_dir, worker.role)
            if not events:
                continue
            groups.append((pid, worker.role, events,
                           worker.clock.offset or 0.0))
        return merge_timelines(groups)

    def merged_perfetto(self) -> dict:
        """ONE Perfetto trace for the whole pool: one process row per
        worker plus the coordinator, all on the coordinator's clock, so
        a handoff renders as a single causally-ordered arc from the
        prefill worker's serialize end to the decode worker's scatter
        start."""
        return to_perfetto(
            self.merged_timelines(),
            meta={"clock_offsets": self.clock_offsets()},
        )


def _blackbox_timeline(state_dir: str, role: str) -> Optional[list]:
    """Last-checkpoint fallback for a dead worker's timeline."""
    try:
        with open(blackbox_path(state_dir, role), encoding="utf-8") as f:
            return json.load(f).get("timeline") or []
    except (OSError, ValueError):
        return None


class _Terminal(Exception):
    """The request already received its terminal event; unwind only."""


def _kill(proc: subprocess.Popen) -> None:
    """SIGKILL a worker's whole process group (its session: the worker and
    anything it started, such as a kernel build) and reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (OSError, ProcessLookupError):
        pass
    try:
        proc.wait(timeout=10.0)
    except subprocess.TimeoutExpired:
        pass


def _stop(proc: subprocess.Popen, timeout: float) -> None:
    """SIGTERM, then the group's SIGKILL if it outlives `timeout`."""
    try:
        proc.terminate()
        proc.wait(timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        pass
    _kill(proc)


def _config_env(config: EngineConfig) -> dict:
    """Render the engine-geometry knobs as the POLYKEY_* env vars
    `EngineConfig.from_env` reads — the spawn-time config channel.
    Identical geometry on every worker (and any in-process reference) is
    what keeps the disaggregated greedy stream the single engine's."""
    flag = "1"
    return {
        "POLYKEY_MODEL": config.model,
        "POLYKEY_TOKENIZER": config.tokenizer,
        "POLYKEY_DTYPE": config.dtype,
        "POLYKEY_KV_DTYPE": config.kv_dtype,
        "POLYKEY_QUANTIZE": (
            ("int4" if config.quantize_bits == 4 else "int8")
            if config.quantize else "0"
        ),
        "POLYKEY_MAX_DECODE_SLOTS": str(config.max_decode_slots),
        "POLYKEY_PAGE_SIZE": str(config.page_size),
        "POLYKEY_NUM_PAGES": str(config.num_pages),
        "POLYKEY_MAX_SEQ_LEN": str(config.max_seq_len),
        "POLYKEY_PREFILL_BUCKETS": ",".join(
            str(b) for b in config.prefill_buckets
        ),
        "POLYKEY_PREFILL_CHUNK": str(config.prefill_chunk),
        "POLYKEY_PREFILL_BUDGET": str(config.prefill_budget),
        "POLYKEY_MAX_NEW_TOKENS_CAP": str(config.max_new_tokens_cap),
        "POLYKEY_DEFAULT_MAX_NEW_TOKENS": str(config.default_max_new_tokens),
        "POLYKEY_RAGGED": flag if config.ragged_dispatch else "0",
        "POLYKEY_PREFIX_CACHE": flag if config.prefix_cache else "0",
        "POLYKEY_PREFIX_CACHE_PAGES": str(config.prefix_cache_pages),
        # The host KV tier ships as it is; the worker scopes its own
        # kv-<tier>-<replica> subdir of the state dir.
        "POLYKEY_HOST_KV_BYTES": str(config.host_kv_bytes),
        "POLYKEY_KV_RESIDENT_PAGES": str(config.host_kv_resident_pages),
        "POLYKEY_KV_RESTORE_SLOTS": str(config.host_kv_restore_slots),
        "POLYKEY_KV_STATE_DIR": config.kv_state_dir,
        "POLYKEY_DECODE_BLOCK": str(config.decode_block_steps),
        "POLYKEY_ADAPTIVE_BLOCK": flag if config.adaptive_block else "0",
        "POLYKEY_DISPATCH_LOOKAHEAD": str(config.lookahead_blocks),
        "POLYKEY_TIMELINE_CAPACITY": str(config.timeline_capacity),
        "POLYKEY_BLACKBOX_EVERY": str(config.blackbox_every),
        "POLYKEY_SIGNALS_INTERVAL": str(config.signals_interval_s),
        # Signal-plane policy: workers evaluate the pool's windows and
        # SLO, not the defaults.
        "POLYKEY_SIGNALS_WINDOWS": config.signals_windows,
        "POLYKEY_SLO": config.slo_policy,
        "POLYKEY_TOP_P_CANDIDATES": str(config.top_p_candidates),
        "POLYKEY_WATCHDOG_TIMEOUT": str(config.watchdog_timeout_s),
        "POLYKEY_REQUEST_TIMEOUT": str(config.request_timeout_s),
        "POLYKEY_MAX_QUEUE": str(config.max_queue_depth),
        "POLYKEY_SUPERVISE": flag if config.supervise else "0",
        "POLYKEY_MAX_RESTARTS": str(config.max_engine_restarts),
        "POLYKEY_RESTART_WINDOW": str(config.restart_window_s),
        # Weights: a config with a checkpoint must not spawn workers that
        # draw random weights.
        "POLYKEY_CHECKPOINT": config.checkpoint_path or "",
        "POLYKEY_TP": str(config.tp),
        "POLYKEY_DP": str(config.dp),
        "POLYKEY_EP": str(config.ep),
        "POLYKEY_SP": str(config.sp),
        "POLYKEY_PP": str(config.pp),
        "POLYKEY_NUM_SLICES": str(config.num_slices),
    }
