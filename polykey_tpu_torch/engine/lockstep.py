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

The in-process restart, the reference supervisor's for any failure (a
crash outside a dispatch, one with a dispatch's record sent, a wedge the
watchdog trips): every rank of the mesh starts a new life, an engine on
the same weight shards over fresh groups (`remake`), and gives up the old
life's groups. A rank whose engine thread has ended frees its device
state first; one still inside the old life (a leader wedged in a
collective, a follower blocked in one its leader never entered) keeps it
as an orphan, reaped once its thread ends: the old life's NCCL
communicators are aborted (`abandon`), which frees a stream blocked in
one of them, and a gloo collective raises at its group's timeout. An
orphan that wakes touches nothing of the fresh engine: it holds the old
mesh, and a stopped engine flips no health. The leader's word, "rebuild"
or "shutdown", goes through the default group's store under a key of the
mesh and its life (`say`, `heard`), where a follower hears it whatever its
engine thread is blocked in: the supervisor's factory says "rebuild"
(`restart`), a supervisor that gives up or a server that stops says
"shutdown" (`release`). A leader whose engine failed while its followers
wait for a record also sends them "restart", so their threads end before
the word comes and free their state first. Every follower loop (a
server's, a replica's, a worker's: `follow_lives`) polls the word between
joins. A follower that is gone ends the mesh: the new groups cannot form,
the factory raises within `REMAKE_TIMEOUT_S` and the supervisor spends
its budget and gives up, as the reference's engine ends with a lost
device. A follower that dies makes the leader's next record or collective
fail: gloo reports the closed connection at once, NCCL at its process
group's timeout; the leader's engine then dies and fails its requests
with the error.

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
import threading
import time
from collections import deque
from datetime import timedelta
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d

from ..parallel.distributed import hybrid_device_array
from ..parallel.mesh import Mesh, MeshConfig, build_mesh

HEARTBEAT_S = 5.0          # the idle leader's record interval
CONTROL_TIMEOUT_S = 120.0  # a follower's longest wait for its next record (and any
                           # gloo collective's of a serving mesh, by default)
REMAKE_TIMEOUT_S = 30.0    # the longest wait for the mesh's other ranks at a new life

# One life's groups are made at a time in a process: the meshes that share
# a rank make theirs in the same order on every rank (`_make_life`).
_lives_lock = threading.Lock()
_made: dict = {}           # serving meshes made over each set of ranks here


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
    "shutdown" or "restart" (its thread ends; the word comes through the
    store, `heard`)."""

    kind: str
    args: tuple = ()


def serving_mesh(config, ranks=None, device=None, timeout_s=None) -> Optional[Mesh]:
    """The engine's mesh of `config`'s axes over `ranks` (default every
    rank of the default group), num_slices folded outermost into dp
    (parallel/distributed.create_hybrid_mesh), with its control and pages
    groups, its first life. Only the mesh's ranks make its groups
    (parallel/mesh.build_mesh with `local`); every rank of the default
    group may call it, and one outside `ranks` gets None. `timeout_s`
    (default CONTROL_TIMEOUT_S) bounds each collective of its gloo groups,
    where an orphan's blocked collective ends."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    mc = MeshConfig(dp=config.dp, pp=config.pp, sp=config.sp, ep=config.ep, tp=config.tp)
    array = hybrid_device_array(mc, config.num_slices, ranks)
    if dist.get_rank() not in ranks:
        return None
    key = "-".join(str(r) for r in sorted(ranks))
    with _lives_lock:
        n = _made.get(key, 0)
        _made[key] = n + 1
        # polylint: disable=CL004(a life's groups are made under the lives lock, bounded by REMAKE_TIMEOUT_S and the groups' timeout: see _make_life)
        return _make_life(array, device, f"{key}.{n}", 0,
                          CONTROL_TIMEOUT_S if timeout_s is None else timeout_s)


def remake(mesh: Mesh, word: Optional[str] = None) -> Mesh:
    """`mesh`'s next life: its life's NCCL communicators aborted
    (`abandon`), then the same device array, rank, device and key over
    fresh groups, made as `serving_mesh` makes them. Every rank of the
    mesh calls it at the leader's word; the leader passes that `word` to
    say first. All under the lives lock, so the meshes that share ranks
    (replicas) start their lives in the order of their words on every
    rank."""
    with _lives_lock:
        if word is not None:
            say(mesh, word)
        abandon(mesh)
        # polylint: disable=CL004(a life's groups are made under the lives lock, bounded by REMAKE_TIMEOUT_S and the groups' timeout: see _make_life)
        return _make_life(mesh.devices, mesh.device, mesh.key, mesh.life + 1, mesh.timeout_s)


def _make_life(array, device, key: str, life: int, timeout_s: float) -> Mesh:
    """A life's groups, made in one fixed order under `_lives_lock` (the
    caller holds it): the lock covers the count of groups `_align_group_names`
    agrees on and every group made after it, or another mesh's life could
    take a name in between."""
    ranks = sorted(int(r) for r in array.flat)
    timeout = timedelta(seconds=timeout_s)
    _align_group_names(key, life, ranks)
    # NCCL's data groups keep their backend's timeout: a stream blocked in
    # one is freed by its abort (`abandon`), not by a timeout.
    mesh = build_mesh(array, device, local=True,
                      timeout=None if dist.get_backend() == "nccl" else timeout)
    control = dist.new_group(ranks, backend="gloo", timeout=timeout,
                             use_local_synchronization=True)
    pages = dist.new_group(ranks, backend="gloo", timeout=timeout,
                           use_local_synchronization=True)
    mesh.control, mesh.pages = control, pages
    mesh.key, mesh.life, mesh.timeout_s = key, life, timeout_s
    return mesh


def _align_group_names(key: str, life: int, ranks: list) -> None:
    """torch names a group made with `use_local_synchronization` after its
    ranks and the number of groups this process holds
    (distributed_c10d._process_group_name), so the mesh's ranks must hold
    as many before they make a life's groups. Ranks that also serve other
    meshes may not: each tells the others its count through the store and
    the ones behind make groups of their own rank until all agree. Raises
    when a rank of the mesh is not there within REMAKE_TIMEOUT_S."""
    store = distributed_c10d._get_default_store()
    rank = dist.get_rank()
    have = len(distributed_c10d._world.pg_names)
    keys = [f"polykey/mesh/{key}/{life}/groups/{r}" for r in ranks]
    store.set(keys[ranks.index(rank)], str(have))
    try:
        store.wait(keys, timedelta(seconds=REMAKE_TIMEOUT_S))
    except Exception as e:
        raise RuntimeError(f"the mesh's ranks {ranks} did not all reach life {life} within "
                           f"{REMAKE_TIMEOUT_S} s: {e}") from e
    for _ in range(max(int(store.get(k)) for k in keys) - have):
        dist.new_group([rank], backend="gloo", use_local_synchronization=True)


def abandon(mesh: Mesh) -> None:
    """Give up `mesh`'s life: abort its NCCL communicators, which frees a
    stream blocked in one of their collectives; a later collective on one
    raises. The groups stay registered, so no later group takes a name
    theirs had. Gloo groups are left as they are: an abort wakes no thread
    blocked in one, which raises at the group's timeout instead."""
    for group in {id(g): g for g in mesh.groups.values()}.values():
        if dist.get_backend(group) == "nccl":
            group.abort()


def say(mesh: Mesh, word: str) -> None:
    """The leader's word to its followers about the end of `mesh`'s life:
    "rebuild" (every rank builds the next life now) or "shutdown"."""
    if world(mesh) > 1:
        distributed_c10d._get_default_store().set(_word_key(mesh), word)


def heard(mesh: Mesh) -> Optional[str]:
    """A follower's look at its leader's word about `mesh`'s life: None
    while there is none, or while the store cannot be reached (its host,
    the leader's process, is gone: the engine thread's own failure then
    ends the lives, `follow_lives`)."""
    store = distributed_c10d._get_default_store()
    try:
        if not store.check([_word_key(mesh)]):
            return None
        return store.get(_word_key(mesh)).decode()
    except Exception:  # the store is gone with the leader: no word comes
        return None


def _word_key(mesh: Mesh) -> str:
    return f"polykey/mesh/{mesh.key}/{mesh.life}/word"


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
        """End the followers' engine threads: "shutdown", or "restart" when
        the supervisor will rebuild the mesh (a follower then waits for the
        word, `heard`); best effort (a lost follower cannot hear it, and
        its loss is the leader's error already). Returns `kind`."""
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


def restart(dead):
    """The supervisor factory's rebuild of a mesh engine (a single engine's,
    a replica's or a worker's), however it failed: say "rebuild" for its
    life, abort that life's NCCL groups (the supervisor has released its
    device state or kept it as an orphan), make the next life's groups with
    every follower (`remake`) and build the fresh engine on them
    (`dead.rebuild`). Raises when a rank of the mesh does not come."""
    dead.closed_with = "rebuild"
    return dead.rebuild(mesh=remake(dead.mesh, "rebuild"))


def release(engine) -> None:
    """Tell the followers of a mesh leader's engine that no rebuild follows
    (the supervisor gave up, or the server stops): "shutdown" for its
    life; a no-op for any other engine."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None or getattr(engine, "is_follower", True):
        return
    engine.closed_with = "shutdown"
    try:
        say(mesh, "shutdown")
    except Exception:  # the store is gone: nothing is left to tell
        pass


def follow(engine) -> str:
    """A follower's loop: receive the leader's records and apply them in
    order (`engine._replay`) until "shutdown" or "restart", or until the
    engine is stopped (an orphan of a new life replays no more); returns
    which."""
    mesh = engine.mesh
    src = leader_rank(mesh)
    while not engine._stop.is_set():
        box = [None]
        dist.broadcast_object_list(box, src=src, group=mesh.control)
        for record in box[0]:
            if record.kind in ("shutdown", "restart"):
                return record.kind
            if engine._stop.is_set():
                break
            engine._replay(record)
        engine._digest.drain()
    return "stopped"


def follow_lives(engine, stopped=lambda: False, on_fresh=None, poll_s: float = 0.1):
    """A follower's lives (a server's, a replica's or a worker's rank):
    follow until the leader's word for the engine's life, polled between
    joins of its thread; at "rebuild" start the next life (`_next_life`),
    hand the fresh engine to `on_fresh` and follow again. Without a word
    the lives end when the thread ends on the leader's "shutdown" record,
    or on this rank's own failure (a dead follower ends the mesh), or
    CONTROL_TIMEOUT_S after a "restart" record, or at `stopped()`. Orphans
    are reaped as their threads end. Unless stopped, it waits for the
    engine's thread and its orphans' to end (each within its mesh's
    timeout: the "shutdown" record goes out before the word) before it
    returns. Returns the last engine: its `dead` says whether it failed."""
    orphans: list = []
    while True:
        word = _await_word(engine, stopped, poll_s, orphans)
        if word != "rebuild":
            if not stopped():
                for old in [engine] + orphans:
                    old.join(old.mesh.timeout_s + 10.0)
            _reap(orphans)
            return engine
        try:
            engine = _next_life(engine, orphans)
        except Exception as e:  # a rank did not come: the mesh ends
            engine.dead = engine.dead or f"the mesh's restart failed: {e}"
            return engine
        if on_fresh is not None:
            on_fresh(engine)


def _await_word(engine, stopped, poll_s: float, orphans: list) -> Optional[str]:
    since = None
    while not stopped():
        _reap(orphans)
        ended = engine.join(poll_s)
        word = heard(engine.mesh)
        if word is not None:
            return word
        if ended:
            if engine.dead is not None or not engine.restart_requested:
                return None
            since = since or time.monotonic()
            if time.monotonic() - since > CONTROL_TIMEOUT_S:
                return None
    return None


def _next_life(engine, orphans: list):
    """A follower's next engine at its leader's "rebuild": the old one's
    device state freed when its thread has ended, else the engine stopped
    and kept as an orphan; its life's NCCL groups aborted, the next life's
    groups made and the engine built on them, in step with every rank."""
    if engine.join(0):
        engine.release_device_state()
    else:
        engine.shutdown(timeout=0.0)    # it replays nothing once it wakes
        orphans.append(engine)
    return engine.rebuild(mesh=remake(engine.mesh))


def _reap(orphans: list) -> None:
    """Release the device state of orphans whose thread has ended."""
    for old in [o for o in orphans if not o._thread.is_alive()]:
        old.release_device_state()
        orphans.remove(old)


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
