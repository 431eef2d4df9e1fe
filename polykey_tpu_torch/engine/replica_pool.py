"""Replica tier: N supervised engines behind a health- and load-aware
router (the reference's polykey_tpu/engine/replica_pool.py: the same state
machine, router, failover and stats).

- Each replica is an independently supervised `InferenceEngine` — its own
  watchdog, its own `EngineSupervisor` restart budget, its own metrics
  (exported with a ``replica`` label), its own fault-injection scope
  (``POLYKEY_FAULTS="step-stall=1.0@1:replica=1"``), its own KV pools,
  CUDA graphs and engine thread. The replicas share ONE set of weight
  tensors on the device: the first engine holds them (passed in, loaded or
  drawn from the seed) and every other engine, and every supervised
  replacement, is built on them (`InferenceEngine(..., reuse=...)`). A
  replacement is built after the dead engine's device state was released
  (engine/supervisor.py), so a restart never holds a third KV pool.
- A router scores SERVING replicas per request:
  ``prefix_weight x warmth - delay_weight x est_delay``, where warmth is
  the replica's cached-prefix fraction for the prompt
  (``engine.prefix_warmth``) and est_delay its queue-delay estimate.
  Candidates whose estimated delay would blow the request deadline are
  filtered first (headroom). Ties break on the lowest replica index.
- On a replica fault (watchdog trip, loop crash, injected fault) the pool
  marks it DRAINING, stops admissions to it, and re-routes its work: every
  request the dying engine fails with an engine-lifecycle error is
  resubmitted to a healthy replica. Queued requests (no token emitted)
  move losslessly; in-flight streams RESUME — the replacement attempt
  re-executes from the prompt with the same seed and the pool suppresses
  the first `emitted` tokens. Resumed streams are flagged ``restarted``
  for the gateway trailer.
- Health is aggregated: the real `HealthService` reports SERVING while at
  least one replica serves; a per-replica give-up marks that replica DEAD
  and leaves the rest serving.

Replica state machine::

    NEW ──start──▶ SERVING ──fault──▶ DRAINING ──factory──▶ RESTARTING
                      ▲                   │                     │
                      └──────rearm────────┴──────give-up──▶   DEAD

The pool quacks like an engine where the gateway needs it to (`config`,
`tokenizer`, `submit`, `stats`, `dead`, `shutdown`), so `TorchService`
routes through it without a parallel code path.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np

from . import lockstep
from .config import EngineConfig
from .engine import EngineDeadError, EngineOverloadedError, GenRequest, InferenceEngine
from .supervisor import EngineSupervisor
from .watchdog import Watchdog

# Replica lifecycle states (stats()["per_replica"][i]["state"] and the
# polykey_replica_state{replica,state} gauge enumerate exactly these).
NEW = "NEW"
SERVING = "SERVING"
DRAINING = "DRAINING"
RESTARTING = "RESTARTING"
DEAD = "DEAD"
STATES = (NEW, SERVING, DRAINING, RESTARTING, DEAD)

# Stats keys summed across replicas in ReplicaPool.stats() — everything
# here is a monotonic count or an instantaneous quantity where the pool
# total is the meaningful serving-tier number. Percentiles/EWMAs stay
# per-replica (in "per_replica") because they do not add.
_ADDITIVE_KEYS = frozenset({
    "requests_admitted", "requests_completed", "requests_failed",
    "requests_shed",
    "deadline_expired_queued", "deadline_expired_prefill",
    "deadline_expired_decode",
    "tokens_generated", "decode_steps", "tokens_per_sec",
    "slots_busy", "slots_total", "pages_free", "pages_total", "queued",
    "inflight_blocks",
    "blocks_dispatched", "lane_steps", "steps_dispatched",
    "prefill_tokens_total", "blocks_processed", "host_stall_ms_total",
    "device_busy_ms_total",
    "prefix_cache_pages", "prefix_hit_tokens", "prefix_lookup_tokens",
    "prefix_host_pages", "prefix_host_hit_tokens",
    "kv_page_faults_prefix", "kv_page_faults_ctx",
    "kv_pages_evicted", "kv_pages_restored",
    "kv_host_pages", "kv_host_capacity", "kv_device_pages",
    "kv_reloaded_pages",
    "drafts_accepted", "drafts_proposed",
})

_ROUTE_REASONS = ("prefix-hit", "least-delay", "headroom")


class _ReplicaHealth:
    """Per-replica stand-in for the gateway HealthService: the replica's
    watchdog, supervisor, and engine crash path all call the usual
    health methods on it, and the pool folds those per-replica signals
    into the REAL health service's aggregate (SERVING while ≥1 replica
    lives) instead of letting one replica flip the whole process."""

    def __init__(self, pool: "ReplicaPool", index: int):
        self._pool = pool
        self._index = index

    def shutdown(self) -> None:
        self._pool._on_replica_down(self._index)

    def resume_serving(self) -> None:
        self._pool._on_replica_up(self._index)

    def resume(self) -> None:
        pass  # per-replica un-latch is implied by resume_serving

    def set_serving_status(self, service, status) -> None:
        pass  # service-name granularity stays with the real HealthService


@dataclass
class _Replica:
    index: int
    engine: InferenceEngine
    watchdog: Optional[Watchdog]
    supervisor: Optional[EngineSupervisor]
    state: str = NEW


@dataclass
class _FlightRecord:
    """Pool-side tracking for ONE client request across engine attempts.

    `request` is the gateway's GenRequest — its `out` queue is what the
    handler thread drains, and the pool is the only writer to it. Each
    engine attempt is a shadow GenRequest whose `out` is an
    `_AttemptQueue` feeding back here; `suppress` tokens of the current
    attempt are dropped (already delivered by a previous attempt) before
    forwarding resumes."""

    request: GenRequest
    attempt: Optional[GenRequest] = None
    replica: int = -1
    emitted: int = 0            # tokens forwarded to the client, total
    seen: int = 0               # tokens produced by the CURRENT attempt
    suppress: int = 0           # leading tokens of this attempt to drop
    reroutes: int = 0
    terminal: bool = False      # current attempt delivered done/error
    lock: threading.Lock = field(default_factory=threading.Lock)


class _AttemptQueue:
    """The shadow request's `out`: engine events flow through the pool
    (suppression, reroute-on-failure, timing merge) instead of straight
    to the client. Only `put` matters — it is the engine's entire
    surface on a request's out queue."""

    def __init__(self, pool: "ReplicaPool", record: _FlightRecord):
        self._pool = pool
        self._record = record

    def put(self, item, block: bool = True, timeout=None) -> None:
        self._pool._on_attempt_event(self._record, self, item)


class ReplicaPool:
    """Engine-shaped facade over N supervised replicas + the router."""

    def __init__(self, config: EngineConfig, health=None, logger=None,
                 recorder=None):
        config.validate()
        self.config = config
        self.health = health
        self.logger = logger
        self.recorder = recorder
        self.replicas: list[_Replica] = []
        self.tokenizer = None           # first replica's (all identical)
        self._lock = threading.Lock()
        self._closing = False
        self._serving_advertised = True
        self.requests_rerouted = 0
        self.streams_resumed = 0
        self.router_decisions = {reason: 0 for reason in _ROUTE_REASONS}
        # Recovery-hint inputs: how often the
        # supervisors poll (create() overwrites with its real interval)
        # — the no-healthy-replica UNAVAILABLE carries an estimated
        # retry-after derived from it, so clients back off on the
        # SERVER's recovery clock instead of hammering a restarting tier.
        self._supervisor_interval_s = 0.5
        # Pool-assigned seeds for seedless sampled requests: a resumed
        # attempt must replay the SAME stream, so the root is fixed
        # before the first attempt instead of drawn inside one engine.
        self._seed_rng = np.random.default_rng()
        # Live router weights (autopilot actuation surface): _route
        # reads THESE per call, not the frozen config, so a mid-run
        # set_route_weights lands on the very next routing decision.
        self._route_prefix_weight = config.route_prefix_weight
        self._route_delay_weight = config.route_delay_weight

    # -- live-knob actuation (autopilot; any thread) -------------------------

    def set_route_weights(self, prefix: Optional[float] = None,
                          delay: Optional[float] = None) -> tuple:
        """Update the router score weights in place (floats, GIL-atomic
        against concurrent _route calls). None leaves a weight alone;
        both clamp non-negative. Returns the applied pair."""
        if prefix is not None:
            self._route_prefix_weight = max(0.0, float(prefix))
        if delay is not None:
            self._route_delay_weight = max(0.0, float(delay))
        return (self._route_prefix_weight, self._route_delay_weight)

    def knob_setpoints(self) -> dict:
        """Pool-level live knobs plus replica 0's engine knobs (all
        replicas receive identical actuations — the autopilot
        broadcasts through apply_engine_knobs)."""
        out = {
            "route_prefix_weight": round(self._route_prefix_weight, 4),
            "route_delay_weight": round(self._route_delay_weight, 4),
        }
        if self.replicas:
            out.update(self.replicas[0].engine.knob_setpoints())
        return out

    def apply_engine_knobs(self, knobs: dict) -> dict:
        """Broadcast engine-level knob setpoints to EVERY replica (a
        restarted replica's fresh engine is re-covered by the
        autopilot's restart listener). Returns the values applied by
        the last replica — identical engines apply identically."""
        from .autopilot import apply_engine_knobs

        applied: dict = {}
        for rep in self.replicas:
            applied = apply_engine_knobs(rep.engine, knobs)
        return applied

    # -- construction --------------------------------------------------------

    @classmethod
    def create(
        cls, config: EngineConfig, replicas: Optional[int] = None,
        health=None, logger=None, obs=None, seed: int = 0,
        params: Optional[dict] = None, draft_params: Optional[dict] = None,
        watchdog_interval_s: float = 5.0,
        supervisor_interval_s: float = 0.5,
        join_timeout_s: float = 5.0,
        device=None,
        meshes: Optional[list] = None,
    ) -> "ReplicaPool":
        """Build and start a fully wired pool: engines on one set of
        weights, per-replica watchdogs and (when `config.supervise`)
        supervisors, shared stall/restart counters from `obs`. The
        interval knobs let chaos tests scale the detection latency.

        Over a mesh (a process group up, or `meshes`, one serving mesh a
        replica built by engine/lockstep.serving_mesh on every rank) every
        rank builds the same replicas in the same order, each on a mesh of
        its own: its own data, control and pages groups, so two replicas'
        collectives never share a group. Each rank's replicas share its
        one set of weight shards. The mesh's first rank leads every
        replica and routes; on the other ranks each replica is a follower
        replaying its leader's records on its engine thread (`follow`),
        with no watchdog or supervisor of its own: a leader replica's
        supervised restart rebuilds it on every rank (lockstep)."""
        n = replicas or config.replicas
        recorder = obs.recorder if obs is not None else None
        stall_counter = restart_counter = None
        if obs is not None:
            from ..obs import Counter

            # The names TorchService registers; get_or_create keeps either
            # construction order from colliding.
            stall_counter, _ = obs.registry.get_or_create(
                Counter,
                "polykey_watchdog_stalls_total",
                "Watchdog trips on a wedged engine step loop.",
            )
            restart_counter, _ = obs.registry.get_or_create(
                Counter,
                "polykey_engine_restarts_total",
                "Supervised in-process engine restarts.",
            )
        pool = cls(config, health=health, logger=logger, recorder=recorder)
        pool._supervisor_interval_s = supervisor_interval_s
        # Phase 1 — construct everything with replicas registered (state
        # NEW) before any watchdog/supervisor thread starts, so a shim
        # callback can never index a replica that isn't there yet. The
        # engines are built one after the other: each captures its graphs
        # before its constructor returns.
        shared = None
        for i in range(n):
            # Per-replica durable-KV state dir: a shared dir would let each
            # replica's store gc() — capped at one engine's host capacity —
            # delete the other replicas' batches.
            kv_dir = config.kv_state_dir
            if kv_dir:
                kv_dir = os.path.join(kv_dir, f"kv-replica-{i}")
            rep_cfg = dataclasses.replace(
                config, replica=i, kv_state_dir=kv_dir,
            )
            shim = _ReplicaHealth(pool, i)
            mesh = meshes[i] if meshes is not None else None
            if shared is None:
                engine = InferenceEngine(
                    rep_cfg, params=params, device=device, health=shim,
                    logger=logger, seed=seed, draft_params=draft_params, mesh=mesh,
                )
                # The weights as the first engine holds them (on the
                # device, quantized if asked): every other engine serves
                # these tensors.
                shared = engine._ctor_args
            else:
                engine = InferenceEngine(
                    rep_cfg, device=device, health=shim, logger=logger,
                    reuse=shared, mesh=mesh,
                )
            if engine.is_follower:
                pool.replicas.append(_Replica(index=i, engine=engine, watchdog=None,
                                              supervisor=None))
                continue
            engine.mesh_restart = config.supervise and engine.mesh is not None
            watchdog = Watchdog(
                engine, health=shim, logger=logger, recorder=recorder,
                stall_counter=stall_counter,
                check_interval_s=watchdog_interval_s,
            )
            supervisor = None
            if config.supervise:
                factory = partial(
                    pool._build_replacement, i, rep_cfg, shared, shim,
                    engine.device,
                )
                supervisor = EngineSupervisor(
                    engine, factory,
                    watchdog=watchdog, health=shim, logger=logger,
                    recorder=recorder, restart_counter=restart_counter,
                    max_restarts=config.max_engine_restarts,
                    restart_window_s=config.restart_window_s,
                    check_interval_s=supervisor_interval_s,
                    join_timeout_s=join_timeout_s,
                )
                supervisor.add_restart_listener(
                    partial(pool._on_replica_restarted, i)
                )
                supervisor.add_giveup_listener(
                    partial(pool._on_replica_giveup, i)
                )
            pool.replicas.append(_Replica(
                index=i, engine=engine, watchdog=watchdog,
                supervisor=supervisor,
            ))
        pool.tokenizer = pool.replicas[0].engine.tokenizer
        # Phase 2 — go live.
        for rep in pool.replicas:
            rep.state = SERVING
            if rep.watchdog is not None:
                rep.watchdog.start()
            if rep.supervisor is not None:
                rep.supervisor.start()
        if recorder is not None:
            recorder.event("replica_pool_started", replicas=n)
        if logger is not None:
            logger.info(
                "replica pool started", replicas=n,
                model=config.model, slots_per_replica=config.max_decode_slots,
            )
        return pool

    def _build_replacement(self, index, rep_cfg, shared, shim, device):
        """Supervisor restart factory: flag the replica RESTARTING for the
        state gauge, then build a fresh engine on the pool's weights (the
        supervisor released the dead engine's device state first)."""
        self._transition(index, RESTARTING, only_from=(DRAINING,))
        dead = self.replicas[index].engine
        if dead.mesh is None:
            return InferenceEngine(
                rep_cfg, device=device, health=shim, logger=self.logger,
                reuse=shared,
            )
        return lockstep.restart(dead)      # every rank of its mesh rebuilds

    # -- replica state machine ----------------------------------------------

    def _transition(self, index: int, state: str,
                    only_from: Optional[tuple] = None) -> None:
        """Move one replica's state and re-aggregate health. DEAD is
        terminal (a gave-up supervisor never comes back)."""
        flip_down = flip_up = False
        with self._lock:
            if index >= len(self.replicas):
                return  # construction-time callback before registration
            rep = self.replicas[index]
            if rep.state == state or rep.state == DEAD:
                return
            if only_from is not None and rep.state not in only_from:
                return
            previous = rep.state
            rep.state = state
            serving = sum(1 for r in self.replicas if r.state == SERVING)
            if self._serving_advertised and serving == 0:
                self._serving_advertised = False
                flip_down = True
            elif not self._serving_advertised and serving > 0:
                self._serving_advertised = True
                flip_up = True
        if self.recorder is not None:
            self.recorder.event(
                "replica_state", replica=index, state=state,
                previous=previous,
            )
        if self.logger is not None:
            self.logger.info(
                "replica state change", replica=index, state=state,
                previous=previous,
            )
        if self.health is not None and not self._closing:
            # Aggregate health: the real service flips only on the
            # 0 ↔ ≥1 live-replica boundary — one replica's failure is
            # the pool's problem, not the load balancer's.
            if flip_down:
                self.health.shutdown()
            elif flip_up:
                self.health.resume_serving()

    def _on_replica_down(self, index: int) -> None:
        self._transition(index, DRAINING, only_from=(NEW, SERVING))

    def _on_replica_up(self, index: int) -> None:
        self._transition(index, SERVING,
                         only_from=(NEW, DRAINING, RESTARTING))

    def _on_replica_restarted(self, index: int, fresh) -> None:
        with self._lock:
            if index < len(self.replicas):
                self.replicas[index].engine = fresh
        self._transition(index, SERVING, only_from=(DRAINING, RESTARTING))

    def _on_replica_giveup(self, index: int, reason: str) -> None:
        self._transition(index, DEAD)
        lockstep.release(self.replicas[index].engine)

    @property
    def is_follower(self) -> bool:
        """Every replica is a follower: a rank above the first of a mesh."""
        return bool(self.replicas) and all(r.engine.is_follower for r in self.replicas)

    def follow(self, stopped=lambda: False) -> Optional[str]:
        """A follower rank's replicas, each on a thread of its own: its
        engine replays its leader's records on its mesh's groups, and after
        a "restart" record the replica's next engine is built at its
        leader's word (lockstep.follow_lives). Returns once every replica has
        ended (or `stopped()`): the first replica failure, or None."""
        failures: list = []

        def lives(rep: _Replica) -> None:
            engine = lockstep.follow_lives(rep.engine, stopped,
                                           lambda fresh: setattr(rep, "engine", fresh))
            if engine.dead is not None:
                failures.append(f"replica {rep.index}: {engine.dead}")

        threads = [threading.Thread(target=lives, args=(rep,), daemon=True,
                                    name=f"polykey-follow-{rep.index}")
                   for rep in self.replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return failures[0] if failures else None

    # -- engine-shaped surface ----------------------------------------------

    @property
    def dead(self) -> Optional[str]:
        if self._closing:
            return "engine is shut down"
        with self._lock:
            if self.replicas and all(r.state == DEAD for r in self.replicas):
                return "all replicas dead (restart budgets exhausted)"
        return None

    @property
    def busy(self) -> bool:
        return any(rep.engine.busy for rep in self.replicas)

    def submit(self, request: GenRequest) -> None:
        """Route and submit. Raises EngineOverloadedError when the
        chosen replica sheds (retry-after contract unchanged) and
        EngineDeadError when no replica can take work."""
        if self._closing:
            raise EngineDeadError("engine is shut down")
        if request.seed is None and request.temperature > 0.0:
            # Fix the sampling root NOW: a mid-stream resume re-executes
            # with the same seed, which is what makes the suppressed
            # prefix match the delivered one on a plain engine.
            request.seed = int(self._seed_rng.integers(0, 1 << 63))
        record = _FlightRecord(request)
        exclude: set[int] = set()
        for _ in range(len(self.replicas)):
            replica, reason = self._route(request, exclude)
            if replica is None:
                break
            with record.lock:
                attempt = self._make_attempt(record)
                record.attempt = attempt
                record.replica = replica.index
            try:
                replica.engine.submit(attempt)
            except EngineDeadError:
                # Raced a fault the shim hasn't reported yet: mark and
                # try the next replica.
                self._on_replica_down(replica.index)
                exclude.add(replica.index)
                continue
            request.replica = replica.index
            self._count_decision(reason)
            return
        # No-healthy-replica fall-through: UNAVAILABLE with an
        # estimated-recovery hint, so clients back off on the server's
        # recovery clock instead of re-hitting a recovering tier.
        raise EngineDeadError(
            self.dead or "no serving replica available",
            retry_after_ms=self._recovery_hint_ms(),
        )

    def _recovery_hint_ms(self) -> Optional[int]:
        """Estimated time until a replica could serve again: while any
        replica is DRAINING/RESTARTING a supervised restart is in
        flight — a couple of supervisor poll intervals is the earliest
        it can complete. All-DEAD means platform recycle: hint a
        conservative second so retries don't spin. None only when the
        pool is empty (nothing to estimate)."""
        with self._lock:
            if not self.replicas:
                return None
            recovering = any(
                r.state in (DRAINING, RESTARTING, NEW) for r in self.replicas
            )
        if recovering:
            return max(100, int(2000 * self._supervisor_interval_s))
        return 1000

    def stats(self) -> dict:
        per = []
        agg: dict = {}
        restarts = 0
        supervised = False
        gave_up_all = True
        for rep in list(self.replicas):
            snap = rep.engine.stats()
            snap["state"] = rep.state
            if rep.supervisor is not None:
                supervised = True
                snap["engine_restarts"] = rep.supervisor.restarts
                restarts += rep.supervisor.restarts
                gave_up_all = gave_up_all and rep.supervisor.gave_up
            per.append(snap)
            for key, value in snap.items():
                if key in _ADDITIVE_KEYS and isinstance(value, (int, float)):
                    agg[key] = agg.get(key, 0) + value
        agg["model"] = per[0].get("model") if per else self.config.model
        if agg.get("steps_dispatched"):
            agg["avg_lanes"] = round(
                agg.get("lane_steps", 0) / agg["steps_dispatched"], 2
            )
            # avg_lanes is per-DISPATCH (bounded by one replica's slot
            # count), so the occupancy denominator is per-replica slots
            # — dividing by the pool-summed slots_total would understate
            # a saturated pool by 1/N.
            agg["occupancy"] = round(
                agg["avg_lanes"] / max(1, self.config.max_decode_slots), 4
            )
        with self._lock:
            agg["replicas_total"] = len(self.replicas)
            agg["replicas_serving"] = sum(
                r.state == SERVING for r in self.replicas
            )
            agg["replica_states"] = {
                str(r.index): r.state for r in self.replicas
            }
            agg["requests_rerouted"] = self.requests_rerouted
            agg["streams_resumed"] = self.streams_resumed
            agg["router_decisions"] = dict(self.router_decisions)
        agg["engine_restarts"] = restarts
        agg["supervisor_gave_up"] = supervised and gave_up_all
        agg["per_replica"] = per
        return agg

    def shutdown(self, timeout: float = 10.0) -> None:
        self._closing = True
        for rep in self.replicas:
            if rep.supervisor is not None:
                rep.supervisor.stop()
        for rep in self.replicas:
            if rep.watchdog is not None:
                rep.watchdog.stop()
        for rep in self.replicas:
            rep.engine.shutdown(timeout)
            lockstep.release(rep.engine)

    # -- router --------------------------------------------------------------

    def _route(self, request: GenRequest,
               exclude: set) -> tuple[Optional[_Replica], str]:
        """Pick the best SERVING replica for `request`. Deterministic:
        the score orders candidates and ties break on the lowest index.
        Returns (replica, reason) — reason ∈ {prefix-hit, least-delay,
        headroom} for the router-decision counter."""
        now = time.monotonic()
        with self._lock:
            candidates = [
                r for r in self.replicas
                if r.state == SERVING and r.index not in exclude
            ]
        if not candidates:
            return None, ""
        ids: list = []
        if self.config.prefix_cache and request.prompt:
            # Tokenized once per REQUEST, not per route call: reroutes
            # (and the per-candidate warmth probes) reuse the stash
            # instead of re-encoding the whole prompt.
            ids = getattr(request, "_route_ids", None)
            if ids is None:
                ids = self.tokenizer.encode(request.prompt)
                request._route_ids = ids
        scored = []
        for rep in candidates:
            warmth = rep.engine.prefix_warmth(ids) if ids else 0.0
            delay = rep.engine.queue_delay_estimate_s()
            feasible = (
                request.deadline is None or now + delay < request.deadline
            )
            # The load term is epsilon-weighted: it only decides when
            # warmth and the delay estimate tie (cold engines report 0
            # delay until their first completion — without it, every
            # cold-burst request would land on replica 0).
            score = (
                self._route_prefix_weight * warmth
                - self._route_delay_weight * delay
                - 1e-3 * rep.engine.load_fraction()
            )
            scored.append((rep, warmth, delay, feasible, score))
        feasible_only = [entry for entry in scored if entry[3]]
        filtered = bool(feasible_only) and len(feasible_only) < len(scored)
        if feasible_only:
            scored = feasible_only
        scored.sort(key=lambda entry: (-entry[4], entry[0].index))
        best = scored[0]
        if filtered:
            reason = "headroom"
        elif best[1] > 0.0:
            reason = "prefix-hit"
        else:
            reason = "least-delay"
        return best[0], reason

    def _count_decision(self, reason: str) -> None:
        with self._lock:
            if reason in self.router_decisions:
                self.router_decisions[reason] += 1

    # -- attempt plumbing ----------------------------------------------------

    def _make_attempt(self, record: _FlightRecord) -> GenRequest:
        """A shadow GenRequest for one engine attempt: same generation
        inputs (prompt/sampling/seed/deadline), SHARED cancellation
        event and trace, its own out queue feeding the pool. The
        original enqueue time carries over so TTFT spans queue + any
        reroute, not just the last attempt."""
        orig = record.request
        shadow = GenRequest(
            prompt=orig.prompt,
            max_new_tokens=orig.max_new_tokens,
            temperature=orig.temperature,
            top_p=orig.top_p,
            top_k=orig.top_k,
            seed=orig.seed,
            deadline=orig.deadline,
            out=_AttemptQueue(self, record),
            cancelled=orig.cancelled,
            trace=orig.trace,
        )
        shadow.timings.enqueued = orig.timings.enqueued
        return shadow

    def _on_attempt_event(self, record: _FlightRecord, source, item) -> None:
        """Engine event for one attempt (engine/supervisor thread).
        Decisions happen under the record lock; queue puts and resubmits
        happen outside it."""
        kind, value = item
        forward = None
        reroute_cause = None
        with record.lock:
            if record.attempt is None or source is not record.attempt.out:
                return  # late event from a superseded attempt
            if kind == "token":
                record.seen += 1
                if record.seen <= record.suppress:
                    return  # already delivered by a previous attempt
                record.emitted += 1
                timings = record.request.timings
                attempt_t = record.attempt.timings
                if timings.prefill_start == 0.0:
                    timings.prefill_start = attempt_t.prefill_start
                if timings.first_token == 0.0:
                    timings.first_token = (
                        attempt_t.first_token or time.monotonic()
                    )
                if attempt_t.prompt_tokens:
                    timings.prompt_tokens = attempt_t.prompt_tokens
                forward = item
            elif record.terminal:
                return  # duplicate terminal (wedged-restart double fail)
            elif kind == "done":
                record.terminal = True
                timings = record.request.timings
                attempt_t = record.attempt.timings
                timings.finished = attempt_t.finished or time.monotonic()
                if attempt_t.prompt_tokens:
                    timings.prompt_tokens = attempt_t.prompt_tokens
                timings.completion_tokens = record.emitted
                if timings.first_token == 0.0:
                    timings.first_token = attempt_t.first_token
                # Device-time attribution accumulates ACROSS attempts: a
                # resumed stream's device cost includes the replay work
                # on the new replica (that honesty is the point).
                timings.device_ms += attempt_t.device_ms
                forward = ("done", timings)
            else:  # error
                record.terminal = True
                if record.attempt is not None:
                    record.request.timings.device_ms += (
                        record.attempt.timings.device_ms
                    )
                if self._recoverable(record, value):
                    reroute_cause = value
                else:
                    forward = item
        if forward is not None:
            record.request.out.put(forward)
        elif reroute_cause is not None:
            self._reroute(record, reroute_cause)

    def _recoverable(self, record: _FlightRecord, message: str) -> bool:
        """Engine-lifecycle failures (the gateway's UNAVAILABLE prefix
        contract: message starts with "engine") are re-routable; request
        outcomes (deadline, cancellation, admission errors) are not."""
        return (
            message.startswith("engine")
            and not self._closing
            and not record.request.cancelled.is_set()
            and record.reroutes < self.config.max_reroutes
        )

    def _reroute(self, record: _FlightRecord, cause: str) -> None:
        """Move a failed request to a healthy replica: queued requests
        (emitted == 0) transfer losslessly; mid-stream requests resume
        with the already-delivered tokens suppressed."""
        failed_replica = record.replica
        self._on_replica_down(failed_replica)
        exclude = {failed_replica}
        while True:
            replica, reason = self._route(record.request, exclude)
            if replica is None:
                # No healthy replica: surface the original failure — the
                # gateway maps it to UNAVAILABLE and, for streams,
                # attaches the resume-supported trailer so the CLIENT
                # can resume once a replica returns.
                record.request.out.put(("error", cause))
                return
            with record.lock:
                record.reroutes += 1
                record.suppress = record.emitted
                record.seen = 0
                record.terminal = False
                resumed = record.suppress > 0
                attempt = self._make_attempt(record)
                record.attempt = attempt
                record.replica = replica.index
            try:
                replica.engine.submit(attempt)
            except (EngineDeadError, EngineOverloadedError) as e:
                if self.logger is not None:
                    self.logger.warn(
                        "reroute target rejected request; trying next",
                        replica=replica.index, error=str(e),
                    )
                if isinstance(e, EngineDeadError):
                    self._on_replica_down(replica.index)
                exclude.add(replica.index)
                continue
            record.request.replica = replica.index
            if resumed:
                record.request.restarted = True
            with self._lock:
                self.requests_rerouted += 1
                if resumed:
                    self.streams_resumed += 1
            self._count_decision(reason)
            # Trace continuity: the stream keeps its original
            # root span (attempts share it), and the failover becomes an
            # explicit `resume` child — the span tree then SHOWS the
            # replica move a postmortem reader would otherwise have to
            # reconstruct from counters. Instant span (start == end):
            # the resumed work itself lands as further decode children.
            trace = record.request.trace
            if trace is not None:
                now = time.monotonic()
                trace.child(
                    "resume", start=now, end=now,
                    from_replica=failed_replica, to_replica=replica.index,
                    suppressed_tokens=record.suppress, cause=cause,
                )
            # And the TARGET replica's flight-deck timeline marks the
            # arrival, so its Perfetto export explains the admission
            # burst a failover causes.
            timeline = getattr(replica.engine, "timeline", None)
            if timeline is not None:
                timeline.note(
                    "reroute_in", from_replica=failed_replica,
                    resumed=resumed, suppressed_tokens=record.suppress,
                )
            if self.recorder is not None:
                self.recorder.event(
                    "request_rerouted", to_replica=replica.index,
                    cause=cause, resumed=resumed,
                    suppressed_tokens=record.suppress,
                )
            if self.logger is not None:
                self.logger.info(
                    "request rerouted", to_replica=replica.index,
                    resumed=resumed, suppressed_tokens=record.suppress,
                )
            return
