"""Lock-step dispatch: one engine over a mesh of processes, one rank per
card (no counterpart file in the reference, where jit's single controller
places the same program on every device).

Processes that share a mesh must issue the same collectives in the same
order (the reference's note in polykey_tpu/parallel/distributed.py), so
only the mesh's first rank, the leader, decides anything. It runs the
gateway, the scheduler, the allocator and the lookahead pipeline as a
single-card engine does. Every other rank is a follower: it builds the
same engine (the same weights' shards, pools, fixed buffers and CUDA
graphs, captured in the same order, each capture's eager warm-up and the
`warm` replays included) and then only replays the leader's device work,
record by record, through the same functions and graphs on its own
shards. A follower makes no timing decision of its own: one that ran its
own scheduler would drift from the leader at the first admission that
differed, and its collectives would hang.

Records (`Record`) travel over the mesh's control group, a gloo group
beside the data groups (`serving_mesh`), as pickled lists. Whole KV pages
travel over a second gloo group, `pages` (`gather_pages`,
`scatter_pages`): the durable state dir's spills, whose record goes out
at once and after which the leader and each follower (replaying it) hand
their shards of the batch to the leader's whole pages, and a new
engine's reload, where the leader cuts the whole pages back to every
rank's shard before any record flows. Every rank calls them at the same
point of the record stream, so the control broadcasts keep their order. The leader
queues the records that issue no collective (lane merges and retires) and
sends them with the next one that does (a prefill, a decode block, a spec
round, a ragged dispatch), always before that dispatch's first collective:
a follower applies them in order, so a merge reads its prefill's output
before any other replay, as the graph-output rule wants (engine/graphs.py).
The host tier's spills and restores issue no collective either and are
queued the same way: a follower gathers the pages, or writes them back,
at the same point of the device work as the leader did, ahead of any
later dispatch that writes or reads them. The prefix cache itself lives on
the leader alone: a hit reaches the followers as the suffix's prefill. When idle the leader sends a
heartbeat every `HEARTBEAT_S`, so a follower's receive, bounded by
`CONTROL_TIMEOUT_S`, never times out while the leader lives; a leader that
stops sends "shutdown" and the followers' loops end.

The in-process restart: a leader whose engine loop failed outside a
dispatch (`Leader.open` is set from a dispatch's record until its
collectives are issued, `dispatch`), and whose supervisor will rebuild it,
sends "restart" instead. Each follower leaves its loop, frees its
engine's pools and graphs and waits (`next_life`): the supervisor's
factory announces "rebuild" and every rank builds the replacement on the
same weights and mesh, capturing in the same order, then follows again
(`follow_lives`, the loop of a server's, a replica's and a worker's
follower); a supervisor that gives up, or a server that stops first,
announces "shutdown". A failure inside a dispatch (a wedged collective, or a record
sent whose dispatch then failed) may leave the followers inside its
collectives, and a gloo group cannot be aborted and made again in step:
it ends with "shutdown", the factory refuses it, health stays
NOT_SERVING and the platform restarts the processes. A follower that dies makes the leader's next record
or collective fail: gloo reports the closed connection at once, NCCL at
its process group's timeout; the leader's engine then dies and fails its
requests with the error.

Every rank computes the same tokens (logits are gathered over tp, sampled
tokens over dp), so the lane state evolves identically on every rank and
only the leader reads tokens back to serve them. `TokenDigest` hashes every
decode block's, spec round's and ragged dispatch's packed tokens in
dispatch order on every rank of a mesh of several, so the ranks' agreement
can be checked.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from collections import deque
from datetime import timedelta
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.distributed import create_hybrid_mesh
from ..parallel.mesh import Mesh, MeshConfig
from .config import MESH_ITEM

HEARTBEAT_S = 5.0          # the idle leader's record interval
CONTROL_TIMEOUT_S = 120.0  # a follower's longest wait for its next record


class Record(NamedTuple):
    """One of the leader's device dispatches: `kind` is "prefill" (width,
    group pad, greedy, aligned, the operand arrays), "merge" (slot, row of
    the last prefill's or ragged dispatch's first tokens, seq_len, cap,
    temperature, top_p, top_k), "retire" (slot), "decode" (greedy, steps),
    "spec" (gamma, greedy, candidates: a draft/verify round's graph),
    "ragged" (the round's candidates or None, gamma, greedy, the host-built
    operand arrays and the kernel work lists), "spill" (device pages, host
    rows, persist: each rank copies its shard of the pages into its host
    pool and, with persist, hands it to the leader's whole pages for the
    state dir) and "restore" (host rows, device pages), "heartbeat",
    "shutdown" or "restart" (then "rebuild" or "shutdown", `announce`)."""

    kind: str
    args: tuple = ()


def serving_mesh(config, ranks=None, device=None) -> Optional[Mesh]:
    """The engine's mesh of `config`'s axes over `ranks` (default every
    rank of the default group), num_slices folded outermost into dp
    (parallel/distributed.create_hybrid_mesh), with its control group.
    Every rank of the default group calls it, in the same order as every
    other group it makes; a rank outside `ranks` gets None."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    mc = MeshConfig(dp=config.dp, pp=config.pp, sp=config.sp, ep=config.ep, tp=config.tp)
    mesh = create_hybrid_mesh(mc, config.num_slices, ranks, device)
    timeout = timedelta(seconds=CONTROL_TIMEOUT_S)
    control = dist.new_group(ranks, backend="gloo", timeout=timeout)
    pages = dist.new_group(ranks, backend="gloo", timeout=timeout)
    if mesh is not None:
        mesh.control, mesh.pages = control, pages
    return mesh


def leader_rank(mesh: Mesh) -> int:
    return int(mesh.devices.flat[0])


def world(mesh: Mesh) -> int:
    return int(mesh.devices.size)


class Leader:
    """The leader's side of the control plane. Over a mesh of one there is
    no one to tell, and nothing is sent. `open` is set while a sent
    record's dispatch runs (`dispatch`): a failure then may leave the
    followers inside its collectives."""

    def __init__(self, mesh: Mesh):
        self._group = mesh.control
        self._src = leader_rank(mesh)
        self._silent = world(mesh) == 1
        self._pending: list = []
        self._last = time.monotonic()
        self.records = 0
        self.by_kind: dict[str, int] = {}
        self.messages = 0
        self.heartbeats = 0
        self.open = False

    def queue(self, record: Record) -> None:
        """Hold a record that issues no collective until the next send."""
        if not self._silent:
            self._pending.append(record)
            self.by_kind[record.kind] = self.by_kind.get(record.kind, 0) + 1

    def send(self, record: Record) -> None:
        """Send the held records and `record`, before its dispatch runs."""
        if self._silent:
            return
        self._pending.append(record)
        self.by_kind[record.kind] = self.by_kind.get(record.kind, 0) + 1
        box = [self._pending]
        self._pending = []
        dist.broadcast_object_list(box, src=self._src, group=self._group)
        self.records += len(box[0])
        self.messages += 1
        self._last = time.monotonic()

    def heartbeat(self) -> None:
        if time.monotonic() - self._last >= HEARTBEAT_S:
            self.send(Record("heartbeat"))
            self.heartbeats += 1

    def close(self, kind: str = "shutdown") -> str:
        """Tell the followers to stop ("shutdown"), or to wait for the
        supervisor's rebuild ("restart"); best effort (a lost follower
        cannot hear it, and its loss is the leader's error already).
        Returns `kind`."""
        try:
            self.send(Record(kind))
        except Exception:  # a follower lost: the engine's own error names it
            pass
        return kind


@contextlib.contextmanager
def dispatch(leader: Optional[Leader], record: Record):
    """Send `record` (with the held ones) and run its dispatch in the
    block; `leader.open` stays set if the block raises. No-op without a
    leader (the single-card engine, a follower)."""
    if leader is None:
        yield
        return
    leader.send(record)
    leader.open = True
    yield
    leader.open = False


def announce(mesh: Mesh, kind: str) -> None:
    """The leader's word to followers waiting after a "restart" record:
    "rebuild" (the supervisor builds the fresh engine now, and so must
    they) or "shutdown" (it gave up, or the server stops)."""
    if world(mesh) > 1:
        dist.broadcast_object_list([[Record(kind)]], src=leader_rank(mesh),
                                   group=mesh.control)


def restart(dead):
    """The supervisor factory's rebuild of a mesh engine (a single engine's,
    a replica's or a worker's): when `dead`'s end sent "restart", announce
    "rebuild" and build the fresh engine (`dead.rebuild()`) as every
    follower does at that word. A failure inside a dispatch cannot be
    restarted in process (the module docstring): NotImplementedError."""
    if dead.closed_with != "restart":
        raise NotImplementedError(
            "the in-process restart of a mesh engine that failed inside a dispatch "
            "(wedged in a collective, or with its record sent) is not ported to "
            f"polykey_tpu_torch (ROADMAP.md queue A: {MESH_ITEM})")
    announce(dead.mesh, "rebuild")
    dead.closed_with = "rebuild"
    return dead.rebuild()


def release(engine) -> None:
    """Tell the followers waiting after `engine`'s "restart" record to stop,
    when no rebuild follows (the supervisor gave up, or the server stops);
    a no-op for any other engine."""
    if getattr(engine, "closed_with", None) == "restart":
        engine.closed_with = "shutdown"
        try:
            announce(engine.mesh, "shutdown")
        except Exception:  # a follower lost: nothing is left to tell
            pass


def await_rebuild(mesh: Mesh) -> bool:
    """A follower's wait after a "restart" record: True when the leader
    announces the rebuild, False on "shutdown"."""
    box = [None]
    dist.broadcast_object_list(box, src=leader_rank(mesh), group=mesh.control)
    return any(record.kind == "rebuild" for record in box[0])


def follow(engine) -> str:
    """A follower's loop: receive the leader's records and apply them in
    order (`engine._replay`) until "shutdown" or "restart"; returns which."""
    mesh = engine.mesh
    src = leader_rank(mesh)
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=src, group=mesh.control)
        for record in box[0]:
            if record.kind in ("shutdown", "restart"):
                return record.kind
            engine._replay(record)
        engine._digest.drain()


def next_life(engine):
    """A follower's engine after its thread ended: the fresh engine built in
    step with the leader's supervised restart, or None when the mesh ends
    (the leader shut it down, the supervisor gave up, or this engine
    failed: a dead follower ends the mesh)."""
    if engine.dead is not None or not engine.restart_requested:
        return None
    engine.release_device_state()
    if not await_rebuild(engine.mesh):
        return None
    return engine.rebuild()


def follow_lives(engine, stopped=lambda: False, on_fresh=None, poll_s: float = 0.1):
    """A follower's lives (a server's, a replica's or a worker's rank):
    wait for `engine`'s thread to end, or for `stopped()`; then take its
    next life (`next_life`), hand it to `on_fresh` and follow again.
    Returns the last engine: its `dead` says whether it failed."""
    while True:
        while not stopped() and not engine.join(poll_s):
            pass
        fresh = None if stopped() else next_life(engine)
        if fresh is None:
            return engine
        engine = fresh
        if on_fresh is not None:
            on_fresh(engine)


# -- whole pages from shards ---------------------------------------------------


def _flat(tensors: list) -> torch.Tensor:
    return torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in tensors])


def _unflat(buf: torch.Tensor, like: list) -> list:
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].clone().view(t.dtype).reshape(t.shape))
        at += n
    return out


def _origin(mesh: Mesh, rank: int, layers: int, heads: int) -> tuple:
    """Where `rank`'s shard of a page starts: (first layer, first kv head)."""
    where = np.argwhere(mesh.devices == rank)[0]
    names = mesh.axis_names
    return (int(where[names.index("pp")]) * layers, int(where[names.index("tp")]) * heads)


def gather_pages(mesh: Mesh, shards: list) -> Optional[list]:
    """Whole pages assembled on the leader from every rank's shard of them:
    each rank passes its host copies of the same pages, k and v [L / pp,
    n, page_size, Hk / tp, D] (and the int8 pools' scales [L / pp, n,
    page_size, Hk / tp]); the leader gets the whole [L, n, page_size, Hk,
    D] arrays (scales [L, n, page_size, Hk]), the others None. Over the
    mesh's `pages` group, a gloo group beside the control group: every
    rank calls it at the same point of the record stream (the leader when
    it spills a batch for the state dir, each follower when it replays
    that spill), so the control broadcasts keep their order."""
    if world(mesh) == 1:
        return list(shards)
    buf = _flat(shards)
    src = leader_rank(mesh)
    ranks = sorted(int(r) for r in mesh.devices.flat)      # the group's order
    parts = [torch.empty_like(buf) for _ in ranks] if mesh.rank == src else None
    dist.gather(buf, parts, dst=src, group=mesh.pages)
    if mesh.rank != src:
        return None
    layers, heads = shards[0].shape[0], shards[0].shape[3]
    pp, tp = mesh.shape["pp"], mesh.shape["tp"]
    wholes = [t.new_empty((layers * pp, *t.shape[1:3], heads * tp, *t.shape[4:]))
              for t in shards]
    for rank, part in zip(ranks, parts):
        l0, h0 = _origin(mesh, rank, layers, heads)
        for whole, piece in zip(wholes, _unflat(part, shards)):
            whole[l0:l0 + layers, :, :, h0:h0 + heads] = piece
    return wholes


def scatter_pages(mesh: Mesh, rows: Optional[list], wholes: Optional[list],
                  like: list) -> tuple:
    """Whole pages cut back to every rank's shard: the leader passes the
    host rows they go to and the whole arrays (`gather_pages`' layout, n =
    len(rows)); every rank gets (rows, its shards), shaped as its host
    pools `like` ([L / pp, capacity, ...]) with n pages. The followers call
    it with None. Over the `pages` group, at the same point on every
    rank."""
    if world(mesh) == 1:
        return rows, wholes
    src = leader_rank(mesh)
    box = [rows]
    dist.broadcast_object_list(box, src=src, group=mesh.pages)
    rows = box[0]
    shards = [torch.empty((t.shape[0], len(rows), *t.shape[2:]), dtype=t.dtype)
              for t in like]
    if not rows:
        return rows, shards
    layers, heads = like[0].shape[0], like[0].shape[3]
    pieces = None
    if mesh.rank == src:
        pieces = []
        for rank in sorted(int(r) for r in mesh.devices.flat):
            l0, h0 = _origin(mesh, rank, layers, heads)
            pieces.append(_flat([w[l0:l0 + layers, :, :, h0:h0 + heads] for w in wholes]))
    buf = torch.empty(sum(t.numel() * t.element_size() for t in shards), dtype=torch.uint8)
    dist.scatter(buf, pieces, src=src, group=mesh.pages)
    return rows, _unflat(buf, shards)


class TokenDigest:
    """A running hash of decode blocks' packed tokens in dispatch order:
    `add` takes a block's host copy and its CUDA event (None on the CPU);
    `drain` hashes the blocks whose copies have landed, oldest first (all
    of them with `block`). Engine thread only; `hexdigest` and `blocks`
    may be read anywhere."""

    def __init__(self):
        self._hash = hashlib.blake2b(digest_size=16)
        self._pending: deque = deque()
        self.blocks = 0
        self.hexdigest = self._hash.hexdigest()

    def add(self, host, event) -> None:
        self._pending.append((host, event))
        self.drain()

    def drain(self, block: bool = False) -> None:
        while self._pending:
            host, event = self._pending[0]
            if event is not None:
                if block:
                    event.synchronize()
                elif not event.query():
                    return
            self._pending.popleft()
            self._hash.update(host.numpy().tobytes())
            self.blocks += 1
        self.hexdigest = self._hash.hexdigest()
