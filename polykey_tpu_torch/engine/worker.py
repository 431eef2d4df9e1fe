"""Disaggregated worker: one engine process behind a localhost control
plane (the reference's polykey_tpu/engine/worker.py, the same protocol).

A worker is ONE tier member of the disaggregated pool
(engine/disagg_pool.py): a supervised `InferenceEngine` (its own watchdog
and `EngineSupervisor` restart budget, the replica pool's per-replica
wiring) plus a small length-framed socket protocol the coordinator
drives. Prefill-tier workers run requests in ``prefill_only`` mode and
RETAIN the serialized KV handoff blob until the coordinator releases it
(the two-phase hand-over: the source keeps the state until the target
has decoded past any need for a re-ship); decode-tier workers accept
``resume_state`` requests and stream tokens.

Protocol — every message is ``!II``-framed (header_len, payload_len) +
JSON header + raw payload bytes; one TCP connection carries one RPC (the
prefill/decode ops stream several response frames on it):

    {"op": "ping"}                  → liveness + routing signals
    {"op": "stats"}                 → engine.stats() (the kernels'
                                      launches in this process among them)
                                      + histogram bucket counts
    {"op": "timeline"}              → the engine's timeline ring
    {"op": "prefill", "req": {…}}   → {"event": "handoff_ready", …}
                                      then {"event": "done"/"error"}
    {"op": "fetch", "handoff_id"}   → one frame whose payload is the
                                      retained KV wire blob
    {"op": "release", "handoff_id"} → drops the retained blob (phase 2)
    {"op": "decode", "req": {…}} + blob payload
                                    → {"event": "accepted", …}, then
                                      {"event": "token", …}* and
                                      {"event": "done"/"error"}
    {"op": "arm_faults", "spec"}    → installs a POLYKEY_FAULTS spec
                                      mid-run, on the live engine
    {"op": "knobs", "knobs"}        → the autopilot's live knobs
    {"op": "exit"}                  → clean shutdown

Fault points (faults.py, all honoring ``:tier=`` / ``:replica=``):
``worker-exit`` kills the process at the next consulted protocol site —
prefill intake (queued/mid-prefill death), payload fetch (mid-handoff
death), or after forwarding `value` tokens of a decode stream
(mid-decode death); ``handoff-delay`` sleeps before shipping a blob;
``kv-handoff-drop`` truncates the shipped blob to half (a partial write),
which the coordinator's validation turns into a clean re-route.

Run as a process: ``python -m polykey_tpu_torch.engine.worker --tier
prefill --replica 0 --port 0 --seed 0`` prints one ``{"ready": true,
"port": N, ...}`` JSON line on stdout once its engine has captured its
graphs, and exits once the process that started it is gone. A worker
whose config has mesh axes above 1 (or with ``--mesh``, a mesh of one) is
a mesh of processes, one a rank (engine/lockstep.py): the process the
pool started is rank 0; it starts the other ranks with the bootstrap
variables (`_start_ranks`), each on its card of ``--cards`` when the
pool's spawner splits the host's cards between workers, every rank joins
the group before its engine is built, rank 0 serves the protocol, and the
others follow it (`_follow`). Its handoffs move whole pages: an export gathers every
rank's shard to rank 0's blob, an import cuts the blob to every rank's
shard. It runs on
the card; ``POLYKEY_DEVICE=cpu`` asks for the CPU, and without CUDA it
raises at start and never becomes ready. Tests run
`WorkerServer` on a background thread with ``exit_mode="simulate"``:
worker-exit then severs the control plane (connections and listener)
instead of killing the test process, which the coordinator cannot tell
from death.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import struct
import sys
import threading
import time
import uuid
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..faults import get_injector
from ..obs import BlackBox, FlightRecorder, Span, Tracer
from . import lockstep
from .config import EngineConfig
from .engine import (
    EngineDeadError,
    EngineOverloadedError,
    GenRequest,
    InferenceEngine,
)
from .kv_cache import deserialize_kv_state, serialize_kv_state
from .supervisor import EngineSupervisor
from .watchdog import Watchdog

# Bounded retention of serialized handoff blobs awaiting release: the
# two-phase hand-over holds state for in-flight transfers only, so a
# coordinator that crashes without releasing cannot grow a worker without
# bound — the oldest entries fall off.
_RETAIN_CAP = 64

# Warm-session index cap: the in-memory LRU and the persisted index keep
# the same newest sessions.
_WARM_KEYS_CAP = 512


def session_key(prompt_ids, page_size: int) -> str:
    """Session identity for sticky routing: a hash of the prompt's first
    page-aligned token window. Turns of one conversation share their
    system-prompt/history head, so they map to one key — the signal that
    keeps them landing on their warm prefill worker."""
    head = np.ascontiguousarray(
        np.asarray(prompt_ids, np.int32)[:page_size]
    ).tobytes()
    return hashlib.blake2b(head, digest_size=8).hexdigest()


def params_fingerprint(params: dict) -> str:
    """A digest of a few of a weight tree's tensors (the first rows of the
    embedding, of a leaf of the first and of the last layer, of the final
    norm and of the head): two processes that drew their weights from one
    seed must agree on it. Reads the tensors once (a device sync): call it
    at start, never on a scrape."""
    def first_leaf(tree):
        while isinstance(tree, dict):       # a layer, or a quantized leaf
            tree = tree[sorted(tree)[0]]
        return tree

    layers = params.get("layers") or [None]
    h = hashlib.blake2b(digest_size=8)
    for tree in (params["embed"], layers[0], layers[-1],
                 params.get("final_norm"), params.get("lm_head")):
        t = first_leaf(tree)
        if not isinstance(t, torch.Tensor):
            continue
        rows = (t.reshape(t.shape[0], -1)[:4] if t.dim() > 1 else t[:4096])
        rows = rows.detach().contiguous().cpu()
        if rows.dtype == torch.bfloat16:
            rows = rows.view(torch.int16)
        h.update(str(tuple(t.shape)).encode())
        h.update(rows.numpy().tobytes())
    return h.hexdigest()


# -- framing ------------------------------------------------------------------

def send_msg(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    raw = json.dumps(header).encode()
    head = struct.pack("!II", len(raw), len(payload)) + raw
    if len(payload) < (1 << 16):
        sock.sendall(head + payload)      # one segment: no Nagle wait
    else:
        sock.sendall(head)                # a blob goes out without a copy
        sock.sendall(payload)


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed mid-frame")
        got += k
    return buf


def recv_msg(sock: socket.socket) -> tuple[dict, bytearray]:
    header_len, payload_len = struct.unpack("!II", _read_exact(sock, 8))
    header = json.loads(_read_exact(sock, header_len)) if header_len else {}
    payload = _read_exact(sock, payload_len) if payload_len else bytearray()
    return header, payload


def _json_safe(obj):
    """Engine stats are mostly plain Python; numpy scalars that slip
    through (histogram snapshots, mirrors) coerce here so the control
    plane never fails a stats scrape."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class _WorkerHealth:
    """Health shim for the worker's watchdog/supervisor: flips the
    worker's advertised state, which `ping` reports to the coordinator —
    the cross-process analog of the replica pool's per-replica shim."""

    def __init__(self, server: "WorkerServer"):
        self._server = server

    def shutdown(self) -> None:
        self._server.serving = False

    def resume_serving(self) -> None:
        self._server.serving = True

    def resume(self) -> None:
        pass

    def set_serving_status(self, service, status) -> None:
        pass


class WorkerServer:
    """One tier worker: engine + supervision + the socket control plane.

    `exit_mode="process"` (the real worker) honors ``worker-exit`` with
    ``os._exit`` — genuine process death, nothing flushes.
    `exit_mode="simulate"` (tests) severs the listener and every open
    connection instead, so an in-process test observes exactly what the
    coordinator would: a dead control plane. `params` (a weight tree on
    `device`) skips drawing weights from `seed`."""

    def __init__(
        self,
        config: EngineConfig,
        tier: str,
        replica: int = 0,
        port: int = 0,
        host: str = "127.0.0.1",
        seed: int = 0,
        params: Optional[dict] = None,
        device=None,
        logger=None,
        exit_mode: str = "process",
        state_dir: Optional[str] = None,
        watchdog_interval_s: float = 5.0,
        supervisor_interval_s: float = 0.5,
    ):
        if tier not in ("prefill", "decode"):
            raise ValueError(f"tier must be prefill or decode, got {tier!r}")
        self.tier = tier
        self.replica = replica
        self.logger = logger
        self.exit_mode = exit_mode
        self.state_dir = state_dir
        self.serving = True
        self._closing = False
        self._died = False
        # With the host KV tier on, the worker's durable prefix pages land
        # in a per-worker subdir of the state dir (beside the warm-session
        # index), so a respawned worker reloads its own spilled pages. An
        # explicit POLYKEY_KV_STATE_DIR gets the worker-scoped subdir too:
        # each worker's durable-store gc() is capped at one engine's host
        # capacity and would delete the others' batches from a shared one.
        worker_cfg = worker_config(config, tier, replica, state_dir)
        self.config = worker_cfg
        self.engine = InferenceEngine(
            worker_cfg, params=params, device=device,
            health=_WorkerHealth(self), logger=logger, seed=seed,
        )
        # A worker of a mesh (its ranks started by `main`): a failure of
        # its leader's engine loop rebuilds every rank in process.
        self.engine.mesh_restart = worker_cfg.supervise and self.engine.mesh is not None
        self.device = str(self.engine.device)
        self.fingerprint = params_fingerprint(self.engine.params)
        self.watchdog = Watchdog(
            self.engine, health=_WorkerHealth(self), logger=logger,
            check_interval_s=watchdog_interval_s,
        )
        self.supervisor = None
        if worker_cfg.supervise:
            self.supervisor = EngineSupervisor(
                self.engine, self._replacement,
                watchdog=self.watchdog, health=_WorkerHealth(self),
                logger=logger,
                max_restarts=worker_cfg.max_engine_restarts,
                restart_window_s=worker_cfg.restart_window_s,
                check_interval_s=supervisor_interval_s,
            )
            self.supervisor.add_restart_listener(self._on_engine_restart)
            self.supervisor.add_giveup_listener(lambda _reason: lockstep.release(self.engine))
        self._retained: OrderedDict[str, bytes] = OrderedDict()
        self._retained_lock = threading.Lock()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"polykey-worker-{tier}{replica}",
            daemon=True,
        )
        # Persisted prefix-cache index: session keys this worker
        # prefilled, reloaded at boot so a restarted worker re-advertises
        # its warm sessions to the router.
        self._warm_keys: "OrderedDict[str, bool]" = OrderedDict()
        self._load_warm_index()
        # Knob setpoints last pushed by the coordinator ({"op": "knobs"}),
        # re-applied to the fresh engine after a supervised restart.
        self._knob_setpoints: dict = {}
        # Worker-local span trees: the engine appends children to any
        # request.trace, but the recorder that keeps finished trees lives
        # with the gateway — a worker keeps its own, so its side of a
        # cross-process request survives in the black box, which exists
        # only when the pool gave this member a state dir.
        self.recorder = FlightRecorder(capacity=32)
        self.tracer = Tracer(self.recorder)
        self.blackbox: Optional[BlackBox] = None
        if state_dir and worker_cfg.blackbox_every > 0:
            self.blackbox = BlackBox(
                state_dir, f"{tier}-{replica}",
                timeline=getattr(self.engine, "timeline", None),
                recorder=self.recorder,
                every=worker_cfg.blackbox_every,
                meta={"tier": tier, "replica": replica},
            )
            if self.supervisor is not None:
                self.supervisor.add_trip_listener(self._on_engine_trip)

    def _replacement(self) -> InferenceEngine:
        """The supervisor's factory: a fresh engine on the dead one's
        weight tensors (`reuse`), built after its device state was freed;
        over a mesh, on every rank at this word (engine/lockstep.py)."""
        dead = self.engine
        if dead.mesh is None:
            return InferenceEngine(
                self.config, device=dead.device, health=_WorkerHealth(self),
                logger=self.logger, reuse=dead._ctor_args,
            )
        return lockstep.restart(dead)

    def _on_engine_restart(self, fresh) -> None:
        self.engine = fresh
        if self._knob_setpoints:
            # A fresh engine boots with config-default knobs; the
            # coordinator's actuations must outlive this worker's own
            # supervised restart.
            self._apply_knobs(self._knob_setpoints)
        if self.blackbox is not None:
            self.blackbox.rebind(getattr(fresh, "timeline", None),
                                 self.recorder)

    def _apply_knobs(self, knobs: dict) -> dict:
        """Apply coordinator-pushed live-knob setpoints (the autopilot's
        cross-process actuation path) and remember them so a supervised
        engine restart re-applies rather than silently reverting."""
        from .autopilot import apply_engine_knobs

        applied = apply_engine_knobs(self.engine, knobs)
        # polylint: disable=ML002(keyed by knob name: the static engine-knob names of autopilot._ENGINE_KNOB_SETTERS, not per-request data)
        self._knob_setpoints.update(applied)
        return applied

    def _on_engine_trip(self, dead_engine, reason: str) -> None:
        # Forced checkpoint of the DYING engine's rings: rebind to the
        # corpse for one flush so the trip evidence is not lost to the
        # restart swapping a fresh (empty) timeline in underneath.
        if self.blackbox is None:
            return
        self.blackbox.rebind(getattr(dead_engine, "timeline", None),
                             self.recorder)
        self.blackbox.tick(force=True)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "WorkerServer":
        self.watchdog.start()
        if self.supervisor is not None:
            self.supervisor.start()
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        # polylint: disable=CL002(one-way shutdown latch: a GIL-atomic bool publish; conn threads re-check it every loop and a stale read only costs one extra iteration)
        self._closing = True
        self._sever()
        if self.supervisor is not None:
            self.supervisor.stop()
        self.watchdog.stop()
        self.engine.shutdown()
        lockstep.release(self.engine)

    def _sever(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _die(self) -> None:
        """worker-exit: the process is gone. In simulate mode only the
        control plane dies — which is all the coordinator can see."""
        if self.exit_mode == "process":
            os._exit(1)
        # polylint: disable=CL002(one-way death latch, simulate mode only: a GIL-atomic bool publish mirroring os._exit, which synchronizes nothing either)
        self._died = True
        self._sever()

    def simulate_death(self) -> None:
        """Test hook: kill this worker the way worker-exit would in
        simulate mode (sever the control plane, keep the test process)."""
        self._die()

    def _maybe_exit(self, site: str) -> Optional[int]:
        """Consult the worker-exit fault for one protocol site. The fault
        VALUE selects where death strikes (faults.py): 0 → op intake, 1 →
        payload fetch (mid-handoff), >= 2 → after that many forwarded
        decode tokens (mid-decode). Returns the value when the site
        matched (stream sites carry it as the token threshold)."""
        faults = get_injector()
        if faults is None:
            return None
        preds = {
            "intake": lambda v: v <= 0,
            "fetch": lambda v: v <= 1,     # 0 or 1: both die in-handoff
            "stream": lambda v: v >= 2,
        }
        value = faults.take_if("worker-exit", preds[site],
                               replica=self.replica, tier=self.tier)
        return None if value is None else int(value)

    # -- warm-index persistence ----------------------------------------------

    def _index_path(self) -> Optional[str]:
        if not self.state_dir:
            return None
        return os.path.join(
            self.state_dir, f"worker-{self.tier}-{self.replica}.prefix.json"
        )

    def _load_warm_index(self) -> None:
        path = self._index_path()
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                for key in json.load(f).get("sessions", []):
                    self._warm_keys[str(key)] = True
                while len(self._warm_keys) > _WARM_KEYS_CAP:
                    self._warm_keys.popitem(last=False)
        except (OSError, ValueError):
            pass  # a corrupt index only costs warmth, never liveness

    def _persist_warm_index(self) -> None:
        path = self._index_path()
        if path is None:
            return
        try:
            os.makedirs(self.state_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"sessions": list(self._warm_keys)[-_WARM_KEYS_CAP:]}, f,
                )
            os.replace(tmp, path)
        except OSError:
            pass  # persistence is an optimization, never a failure

    # -- control plane --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing and not self._died:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._closing and not self._died:
                try:
                    header, payload = recv_msg(conn)
                except (ConnectionError, OSError, ValueError):
                    return
                op = header.get("op")
                if op == "ping":
                    send_msg(conn, self._ping_reply())
                elif op == "stats":
                    send_msg(conn, {"ok": True, "stats": self._stats_reply()})
                elif op == "timeline":
                    # Live ring pull for the merged flight deck; `mono`
                    # lets the caller sanity-check its clock offset.
                    timeline = getattr(self.engine, "timeline", None)
                    send_msg(conn, {
                        "ok": True,
                        "mono": time.monotonic(),
                        "events": _json_safe(
                            timeline.events() if timeline is not None else []
                        ),
                    })
                elif op == "prefill":
                    self._handle_prefill(conn, header.get("req") or {})
                elif op == "fetch":
                    self._handle_fetch(conn, header.get("handoff_id", ""))
                elif op == "release":
                    with self._retained_lock:
                        self._retained.pop(header.get("handoff_id", ""), None)
                    send_msg(conn, {"ok": True})
                elif op == "decode":
                    self._handle_decode(conn, header.get("req") or {}, payload)
                # polylint: disable=CL005(sent from outside the package: chip_smoke.py's disagg phase and the tests arm a live worker this way)
                elif op == "arm_faults":
                    from .. import faults as faults_mod

                    injector = faults_mod.install(header.get("spec", ""))
                    # Engines read the injector at construction: a mid-run
                    # arm must reach the LIVE engine.
                    self.engine._faults = injector
                    send_msg(conn, {"ok": True})
                elif op == "knobs":
                    # Autopilot actuation: apply through the live engine's
                    # setters, reply with what landed (post-clamp).
                    send_msg(conn, {
                        "ok": True,
                        "applied": self._apply_knobs(header.get("knobs") or {}),
                    })
                elif op == "exit":
                    send_msg(conn, {"ok": True})
                    threading.Thread(target=self.stop, daemon=True).start()
                    return
                else:
                    send_msg(conn, {"ok": False, "error": f"unknown op {op!r}"})
        except (ConnectionError, OSError):
            pass  # peer went away; nothing to clean beyond the conn
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _ping_reply(self) -> dict:
        engine = self.engine
        state = "SERVING"
        if engine.dead is not None or not self.serving:
            state = "NOT_SERVING"
        if self.supervisor is not None and self.supervisor.gave_up:
            state = "DEAD"
        return {
            "ok": True, "tier": self.tier, "replica": self.replica,
            "state": state, "pid": os.getpid(),
            # Clock-sync sample (obs/clocks.py): this worker's monotonic
            # stamp, taken by the coordinator to be the exchange's
            # midpoint.
            "mono": time.monotonic(),
            "queued": engine._submit.qsize(),
            "slots_busy": sum(s is not None for s in engine._slots),
            "slots_total": engine.config.max_decode_slots,
            "queue_delay_s": engine.queue_delay_estimate_s(),
            "load": engine.load_fraction(),
            "retained_handoffs": len(self._retained),
            "warm_sessions": list(self._warm_keys)[-_WARM_KEYS_CAP:],
            # Host-KV warmth: host-resident pages restore in ms where a
            # cold recompute costs a prefill.
            "kv_host_pages": (
                engine._host_kv.used
                if getattr(engine, "_host_kv", None) is not None else 0
            ),
            "kv_reloaded_pages": getattr(engine, "_kv_reloaded_pages", 0),
        }

    def _stats_reply(self) -> dict:
        snap = _json_safe(self.engine.stats())
        snap["tier"] = self.tier
        snap["replica"] = self.replica
        snap["pid"] = os.getpid()
        snap["weights_fingerprint"] = self.fingerprint
        if self.engine.device.type == "cuda":
            # The caching allocator's host-side books: no device sync.
            snap["cuda_allocated_bytes"] = torch.cuda.memory_allocated(self.engine.device)
            snap["cuda_reserved_bytes"] = torch.cuda.memory_reserved(self.engine.device)
        hists = {}
        for name, attr in (("ttft_ms", "ttft_hist"), ("itl_ms", "itl_hist")):
            hist = getattr(self.engine.metrics, attr)
            counts, total_sum = hist.counts_snapshot()
            hists[name] = {
                "bounds": list(hist.bounds),
                "counts": list(counts),
                "sum": total_sum,
            }
        snap["_hists"] = hists
        return snap

    def _build_request(self, req: dict, **extra) -> GenRequest:
        deadline = None
        if req.get("deadline_in_s") is not None:
            deadline = time.monotonic() + float(req["deadline_in_s"])
        # Trace propagation: a req carrying the gateway's trace_id gets a
        # worker-local root span with the SAME id, so the engine's
        # children — stamped on this process's monotonic clock — join the
        # distributed trace. The finished tree ships back in the `done`
        # frame and feeds the local flight recorder (and the black box).
        trace = None
        trace_id = req.get("trace_id")
        if trace_id:
            trace = Span(f"worker:{self.tier}{self.replica}",
                         trace_id=str(trace_id))
        return GenRequest(
            prompt=req.get("prompt", ""),
            max_new_tokens=int(req.get("max_new_tokens", 64)),
            temperature=float(req.get("temperature", 0.0)),
            top_p=float(req.get("top_p", 1.0)),
            top_k=int(req.get("top_k", 0)),
            seed=req.get("seed"),
            deadline=deadline,
            trace=trace,
            **extra,
        )

    def _box_note(self, note_kind: str, **attrs) -> None:
        """Timeline note + FORCED black-box checkpoint: op intake calls
        this so the fatal request's trace id is durably in the ring before
        any fault site can kill the process (``os._exit`` flushes nothing —
        the checkpoint must happen-before the death)."""
        timeline = getattr(self.engine, "timeline", None)
        if timeline is not None:
            timeline.note(
                note_kind, **{k: v for k, v in attrs.items() if v is not None},
            )
        if self.blackbox is not None:
            self.blackbox.tick(force=True)

    def _finish_trace(self, request: GenRequest) -> Optional[dict]:
        """Close a traced request's worker-side tree, file it in the local
        flight recorder, and render the wire form (absolute monotonic
        start/end — the coordinator grafts it onto the gateway root after
        clock alignment)."""
        if request.trace is None:
            return None
        self.tracer.finish_and_record(request.trace)
        return _span_wire(request.trace)

    def _submit(self, conn: socket.socket, request: GenRequest) -> bool:
        try:
            self.engine.submit(request)
            return True
        except EngineOverloadedError as e:
            send_msg(conn, {"event": "error", "shed": True,
                            "retry_after_ms": e.retry_after_ms,
                            "message": str(e)})
        except EngineDeadError as e:
            send_msg(conn, {"event": "error", "message": f"engine: {e}"})
        return False

    def _handle_prefill(self, conn: socket.socket, req: dict) -> None:
        handoff_id = req.get("handoff_id") or uuid.uuid4().hex
        self._box_note("prefill_op", trace=req.get("trace_id"),
                       handoff_id=handoff_id)
        if self._maybe_exit("intake") is not None:
            self._die()           # queued / mid-prefill death
            return
        request = self._build_request(req, prefill_only=True)
        if not self._submit(conn, request):
            return
        persist_index = False
        try:
            while True:
                kind, value = request.out.get()
                if kind == "handoff":
                    t_ser = time.monotonic()
                    blob = serialize_kv_state(value)
                    t_ser_end = time.monotonic()
                    serialize_ms = (t_ser_end - t_ser) * 1e3
                    if request.trace is not None:
                        request.trace.child(
                            "handoff_serialize", start=t_ser, end=t_ser_end,
                            handoff_id=handoff_id, bytes=len(blob),
                            gather_ms=round(value.gather_ms, 3),
                        )
                    with self._retained_lock:
                        self._retained[handoff_id] = blob
                        while len(self._retained) > _RETAIN_CAP:
                            self._retained.popitem(last=False)
                    key = session_key(value.prompt_ids.numpy(), value.page_size)
                    self._warm_keys[key] = True
                    self._warm_keys.move_to_end(key)
                    while len(self._warm_keys) > _WARM_KEYS_CAP:
                        self._warm_keys.popitem(last=False)
                    persist_index = True
                    timeline = getattr(self.engine, "timeline", None)
                    if timeline is not None:
                        timeline.note("handoff_retained", handoff_id=handoff_id,
                                      bytes=len(blob))
                    # Arc source for the merged flight deck: serialize END
                    # on this process's clock (+ forced checkpoint — the
                    # next fault site is the mid-handoff fetch kill).
                    self._box_note("handoff_serialize", handoff_id=handoff_id,
                                   trace=req.get("trace_id"), bytes=len(blob),
                                   serialize_ms=round(serialize_ms, 3))
                    send_msg(conn, {
                        "event": "handoff_ready",
                        "handoff_id": handoff_id,
                        "bytes": len(blob),
                        "prompt_tokens": value.prompt_len,
                        "first_token": value.first_token,
                        "session": key,
                        "gather_ms": round(value.gather_ms, 3),
                        "serialize_ms": round(serialize_ms, 3),
                    })
                elif kind == "done":
                    send_msg(conn, {"event": "done",
                                    "timings": _timings_dict(value),
                                    "trace": self._finish_trace(request)})
                    return
                else:
                    send_msg(conn, {"event": "error", "message": str(value)})
                    return
        except (ConnectionError, OSError):
            # Coordinator gone mid-prefill (timeout / re-route / death):
            # stop the work and drop the orphaned retention (nobody will
            # fetch or release this handoff_id).
            request.cancelled.set()
            with self._retained_lock:
                self._retained.pop(handoff_id, None)
        finally:
            if persist_index:
                # Off the handoff's critical path: the index write lands
                # after handoff_ready/done went out.
                self._persist_warm_index()

    def _handle_fetch(self, conn: socket.socket, handoff_id: str) -> None:
        faults = get_injector()
        if faults is not None:
            faults.maybe_sleep("handoff-delay", replica=self.replica,
                               tier=self.tier)
        if self._maybe_exit("fetch") is not None:
            self._die()           # mid-handoff death: the blob never ships
            return
        with self._retained_lock:
            blob = self._retained.get(handoff_id)
        if blob is None:
            send_msg(conn, {"ok": False,
                            "error": f"unknown handoff {handoff_id!r}"})
            return
        if faults is not None and faults._take(
            "kv-handoff-drop", replica=self.replica, tier=self.tier
        ) is not None:
            blob = blob[:len(blob) // 2]     # partial write on the wire
        send_msg(conn, {"ok": True, "bytes": len(blob)}, blob)

    def _handle_decode(self, conn: socket.socket, req: dict,
                       payload: bytes) -> None:
        faults = get_injector()
        if faults is not None:
            faults.maybe_sleep("handoff-delay", replica=self.replica,
                               tier=self.tier)
        self._box_note("decode_op", trace=req.get("trace_id"),
                       handoff_id=req.get("handoff_id"), bytes=len(payload))
        if self._maybe_exit("intake") is not None:
            self._die()           # death at resume intake
            return
        t_deser = time.monotonic()
        try:
            state = deserialize_kv_state(payload)
        except Exception as e:
            send_msg(conn, {"event": "error",
                            "message": f"kv-handoff rejected: {e}"})
            return
        t_deser_end = time.monotonic()
        deserialize_ms = (t_deser_end - t_deser) * 1e3
        request = self._build_request(req, resume_state=state)
        if request.trace is not None:
            request.trace.child(
                "handoff_deserialize", start=t_deser, end=t_deser_end,
                handoff_id=req.get("handoff_id"), bytes=len(payload),
            )
        if not self._submit(conn, request):
            return
        # Arc sink for the merged flight deck: the blob is resident and
        # the engine's import begins at this submit — scatter START on
        # this process's clock.
        self._box_note("handoff_scatter", handoff_id=req.get("handoff_id"),
                       trace=req.get("trace_id"),
                       deserialize_ms=round(deserialize_ms, 3))
        send_msg(conn, {"event": "accepted",
                        "deserialize_ms": round(deserialize_ms, 3)})
        # The stream-site kill arms only once a stream exists: consuming
        # the one-shot budget on a rejected/shed op would silently lose a
        # drill's mid-decode death.
        exit_after = self._maybe_exit("stream")
        forwarded = 0
        while True:
            kind, value = request.out.get()
            try:
                if kind == "token":
                    forwarded += 1
                    send_msg(conn, {"event": "token", "id": int(value)})
                    if self.blackbox is not None:
                        self.blackbox.tick()   # amortized (every K)
                    if exit_after is not None and forwarded >= exit_after:
                        request.cancelled.set()
                        self._die()  # mid-decode death, stream mid-flight
                        return
                elif kind == "done":
                    send_msg(conn, {"event": "done",
                                    "timings": _timings_dict(value),
                                    "trace": self._finish_trace(request)})
                    return
                else:
                    send_msg(conn, {"event": "error", "message": str(value)})
                    return
            except (ConnectionError, OSError):
                # Coordinator gone (client cancel / coordinator death): stop
                # the engine-side stream instead of decoding to max_new for
                # nobody — the lane and its pages free at the next block.
                request.cancelled.set()
                return


def _span_wire(span: Span) -> dict:
    """Wire form of a span tree: unlike `Span.to_dict` it keeps the
    ABSOLUTE monotonic start/end, which the coordinator needs to re-time
    the tree onto its own clock (offset + graft)."""
    with span._lock:
        children = list(span.children)
        attrs = dict(span.attrs)
    out: dict = {"name": span.name, "start": span.start, "end": span.end}
    if attrs:
        out["attrs"] = _json_safe(attrs)
    if children:
        out["children"] = [_span_wire(c) for c in children]
    return out


def _timings_dict(timings) -> dict:
    if timings is None:
        return {}
    return {
        "prompt_tokens": timings.prompt_tokens,
        "completion_tokens": timings.completion_tokens,
        "ttft_ms": timings.ttft_ms,
        "tokens_per_sec": timings.tokens_per_sec,
        "device_ms": round(getattr(timings, "device_ms", 0.0), 3),
    }


# -- client side (used by the coordinator) ------------------------------------

class WorkerConn:
    """One RPC connection to a worker's control plane."""

    def __init__(self, addr: tuple[str, int], timeout: float = 10.0):
        self.sock = socket.create_connection(addr, timeout=timeout)

    def __enter__(self) -> "WorkerConn":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def request(self, header: dict, payload: bytes = b"",
                timeout: Optional[float] = None) -> tuple[dict, bytes]:
        if timeout is not None:
            self.sock.settimeout(timeout)
        send_msg(self.sock, header, payload)
        return recv_msg(self.sock)

    def send(self, header: dict, payload: bytes = b"") -> None:
        send_msg(self.sock, header, payload)

    def recv(self, timeout: Optional[float] = None) -> tuple[dict, bytes]:
        if timeout is not None:
            self.sock.settimeout(timeout)
        return recv_msg(self.sock)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# -- process entry point ------------------------------------------------------

def worker_config(config: EngineConfig, tier: str, replica: int,
                  state_dir: Optional[str]) -> EngineConfig:
    """The config a tier worker's engine serves (on every rank of its mesh).

    With the host KV tier on, the worker's durable prefix pages land in a
    per-worker subdir of the state dir (beside the warm-session index), so
    a respawned worker reloads its own spilled pages. An explicit
    POLYKEY_KV_STATE_DIR gets the worker-scoped subdir too: each worker's
    durable-store gc() is capped at one engine's host capacity and would
    delete the others' batches from a shared one."""
    kv_dir = config.kv_state_dir
    if not kv_dir and state_dir and config.host_kv_bytes > 0:
        kv_dir = state_dir
    if kv_dir:
        kv_dir = os.path.join(kv_dir, f"kv-{tier}-{replica}")
    return dataclasses.replace(config, replicas=1, disagg="", disagg_tier=tier,
                               replica=replica, kv_state_dir=kv_dir)


def mesh_ranks(config: EngineConfig) -> int:
    """The processes a worker of `config` runs: one a rank of its mesh."""
    return (config.tp * config.dp * config.ep * config.sp * config.pp
            * config.num_slices)


def _start_ranks(n: int) -> list:
    """A worker's leader (rank 0) starts its other ranks as the gateway's
    are started: the bootstrap variables (a free localhost port as the
    coordinator) and a rank each, and the same arguments (each rank takes
    its card of ``--cards``). They stay in this process's process group,
    so the pool's kill of a worker reaches them."""
    import subprocess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    boot = {"POLYKEY_COORDINATOR": f"127.0.0.1:{port}", "POLYKEY_NUM_PROCESSES": str(n)}
    procs = []
    for rank in range(1, n):
        env = dict(os.environ, **boot, POLYKEY_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "polykey_tpu_torch.engine.worker", *sys.argv[1:]],
            env=env, stdout=subprocess.DEVNULL))
    os.environ.update(boot, POLYKEY_PROCESS_ID="0")
    return procs


def _follow(config: EngineConfig, args) -> int:
    """A follower rank of a worker's mesh: the same engine, replaying its
    leader's records, rebuilt at its leader's supervised restart
    (lockstep.follow_lives); it ends with its leader (its "shutdown", or
    its death, which fails the next receive), or once its leader's process
    is gone."""
    engine = InferenceEngine(worker_config(config, args.tier, args.replica,
                                           args.state_dir or None), seed=args.seed)
    parent = os.getppid()
    engine = lockstep.follow_lives(engine, lambda: os.getppid() != parent, poll_s=0.2)
    if os.getppid() != parent:
        os._exit(1)                     # the worker's leader is gone
    return 1 if engine.dead else 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="polykey disaggregated worker")
    parser.add_argument("--tier", required=True, choices=("prefill", "decode"))
    parser.add_argument("--replica", type=int, default=0)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--state-dir", default="")
    parser.add_argument("--mesh", action="store_true",
                        help="serve as a mesh even of one rank (a process group up)")
    parser.add_argument("--cards", default="",
                        help="the cards of the worker's ranks, a comma list, one a rank")
    args = parser.parse_args(argv)

    config = EngineConfig.from_env()
    followers = []
    n = mesh_ranks(config)
    if n > 1 or args.mesh:
        # A worker of a mesh: its leader starts the other ranks; every rank
        # joins the group before its engine is built (the mesh path).
        from ..parallel.distributed import initialize_from_env

        if "POLYKEY_PROCESS_ID" not in os.environ:
            followers = _start_ranks(n)
        cards = [c for c in args.cards.split(",") if c]
        if cards:
            os.environ["CUDA_VISIBLE_DEVICES"] = cards[int(os.environ["POLYKEY_PROCESS_ID"])]
        initialize_from_env()
        if int(os.environ["POLYKEY_PROCESS_ID"]) > 0:
            return _follow(config, args)
    server = WorkerServer(
        config, tier=args.tier, replica=args.replica, port=args.port,
        seed=args.seed, state_dir=args.state_dir or None,
        exit_mode="process",
        watchdog_interval_s=min(5.0, config.watchdog_timeout_s / 3),
    ).start()
    # The readiness line is the spawn handshake: the coordinator reads it
    # from the worker's stdout to learn the bound port.
    print(json.dumps({"ready": True, "tier": args.tier,
                      "replica": args.replica, "port": server.port,
                      "pid": os.getpid(), "device": server.device,
                      "ranks": max(n, 1)}), flush=True)
    parent = os.getppid()
    try:
        while not server._closing and not server._died:
            time.sleep(0.2)
            if os.getppid() != parent:
                # The coordinator that spawned this worker is gone without a
                # shutdown (a crash, a kill): nothing routes here any more,
                # and the card's memory must not stay held.
                server.stop()
                break
    except KeyboardInterrupt:
        server.stop()
    for proc in followers:              # they end on the leader's shutdown
        try:
            proc.wait(timeout=30)
        except Exception:  # a follower that hangs dies with this process group
            proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
