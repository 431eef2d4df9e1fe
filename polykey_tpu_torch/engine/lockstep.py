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
beside the data groups (`serving_mesh`), as pickled lists. The leader
queues the records that issue no collective (lane merges and retires) and
sends them with the next one that does (a prefill, a decode block), always
before that dispatch's first collective: a follower applies them in order,
so a merge reads its prefill's output before any other replay, as the
graph-output rule wants (engine/graphs.py). When idle the leader sends a
heartbeat every `HEARTBEAT_S`, so a follower's receive, bounded by
`CONTROL_TIMEOUT_S`, never times out while the leader lives; a leader that
stops, by a shutdown or a failed engine, sends "shutdown" and the
followers' loops end. A follower that dies makes the leader's next record
or collective fail: gloo reports the closed connection at once, NCCL at
its process group's timeout; the leader's engine then dies and fails its
requests with the error.

Every rank computes the same tokens (logits are gathered over tp, sampled
tokens over dp), so the lane state evolves identically on every rank and
only the leader reads tokens back to serve them. `TokenDigest` hashes every
decode block's packed tokens in dispatch order on every rank of a mesh of
several, so the ranks' agreement can be checked.
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from datetime import timedelta
from typing import NamedTuple, Optional

import torch.distributed as dist

from ..parallel.distributed import create_hybrid_mesh
from ..parallel.mesh import Mesh, MeshConfig

HEARTBEAT_S = 5.0          # the idle leader's record interval
CONTROL_TIMEOUT_S = 120.0  # a follower's longest wait for its next record


class Record(NamedTuple):
    """One of the leader's device dispatches: `kind` is "prefill" (width,
    group pad, greedy, aligned, the operand arrays), "merge" (slot, row of
    the last prefill's tokens, seq_len, cap, temperature, top_p, top_k),
    "retire" (slot), "decode" (greedy, steps), "heartbeat" or
    "shutdown"."""

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
    control = dist.new_group(ranks, backend="gloo",
                             timeout=timedelta(seconds=CONTROL_TIMEOUT_S))
    if mesh is not None:
        mesh.control = control
    return mesh


def leader_rank(mesh: Mesh) -> int:
    return int(mesh.devices.flat[0])


def world(mesh: Mesh) -> int:
    return int(mesh.devices.size)


class Leader:
    """The leader's side of the control plane. Over a mesh of one there is
    no one to tell, and nothing is sent."""

    def __init__(self, mesh: Mesh):
        self._group = mesh.control
        self._src = leader_rank(mesh)
        self._silent = world(mesh) == 1
        self._pending: list = []
        self._last = time.monotonic()
        self.records = 0
        self.messages = 0
        self.heartbeats = 0

    def queue(self, record: Record) -> None:
        """Hold a record that issues no collective until the next send."""
        if not self._silent:
            self._pending.append(record)

    def send(self, record: Record) -> None:
        """Send the held records and `record`, before its dispatch runs."""
        if self._silent:
            return
        self._pending.append(record)
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

    def close(self) -> None:
        """Tell the followers to stop; best effort (a lost follower cannot
        hear it, and its loss is the leader's error already)."""
        try:
            self.send(Record("shutdown"))
        except Exception:  # a follower lost: the engine's own error names it
            pass


def follow(engine) -> None:
    """A follower's loop: receive the leader's records and apply them in
    order (`engine._replay`) until "shutdown"."""
    mesh = engine.mesh
    src = leader_rank(mesh)
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=src, group=mesh.control)
        for record in box[0]:
            if record.kind == "shutdown":
                return
            engine._replay(record)
        engine._digest.drain()


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
