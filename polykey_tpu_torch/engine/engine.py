"""The inference engine: continuous batching over a paged KV cache, on the
GPU (the reference's engine/engine.py, default path).

- One engine thread owns all device state (page pools, slot tensors).
  gRPC handler threads only enqueue GenRequests and read per-request
  queues; nothing else touches the device.
- The decode batch is a fixed set of `max_decode_slots` lanes; slot
  occupancy is data (`active`), not shape. Inactive lanes point their
  page tables at the reserved garbage page 0 and carry position 0.
- Admission: waiting requests take free slots and prefill in padded
  length buckets, up to 8 same-bucket prompts per dispatch (padded to
  1, 2, 4 or 8 rows). The sampled first token and the slot's geometry are
  merged into the device-resident lane state (`_merge_lane_fn`). A prompt
  longer than the largest bucket prefills in chunks of `prefill_chunk`
  tokens, one per loop iteration (`_advance_chunked_prefills`). On the
  GPU every prefill is a replay of a CUDA graph captured at engine start
  per (width, group pad, greedy, aligned), the counterpart of the
  reference's one executable per static prefill shape; a chunk at an
  offset replays its width's graph, positions being operands. The
  operands go up through pinned memory into fixed buffers, without a
  sync.
- Interleaving: while decode lanes are live, each loop iteration admits
  and chunks at most `prefill_budget` prefill tokens (the first chunk
  always goes: a progress floor), round-robin over pending slots.
- Decode: one dispatch runs `decode_block_steps` steps for the whole batch
  with device-side EOS/cap liveness (`_decode_fn`) and returns one packed
  [K, B] token array (-1 where a lane emitted nothing). On the GPU each
  block is a replay of a CUDA graph captured once per (greedy, steps) at
  engine start (engine/graphs.py), the counterpart of the reference's
  jitted block; the lane state lives in fixed buffers that every writer
  updates in place. With the adaptive block (the default) a lone active
  stream gets blocks of max(1, K // 8) steps.
- Lookahead pipeline (`lookahead_blocks`, POLYKEY_DISPATCH_LOOKAHEAD;
  default 2): a block's packed tokens go to pinned host memory by a
  non-blocking copy and a CUDA event, and the host processes the block
  only after dispatching the next one, so its readback and bookkeeping
  hide behind the device's work on the next block. Every dispatch, merge,
  retire and copy runs on one stream, whose order makes a stale block
  safe: device-side stopping ends the lanes the host finished, and a
  per-block snapshot of the slots' requests keeps a cancelled lane's
  tokens from its slot's next occupant. Depth 1 is exactly synchronous.
- Lazy first token (the reference's `_resolve_prefills`): a merged
  prefill's sampled token goes to pinned host memory the same way, and
  the slot keeps a handle to it (`_FirstToken`). The loop delivers every
  handle whose copy has landed after the dispatch frontier, all of them
  on an idle iteration; before the host waits for a block it delivers
  the first tokens queued ahead of that block (they land no later), and
  a block's processing delivers a slot's first token before its block
  tokens. Depth 1 reads it at once.
- Ragged dispatch (`ragged_dispatch`, POLYKEY_RAGGED=1; kill switch
  POLYKEY_DISABLE_RAGGED=1): every prompt registers as pending token
  ranges, and any iteration with prefill work runs ONE flat dispatch of
  every decode lane's single token plus up to the budget of prefill
  tokens (`_ragged_fn`, the ragged attention kernel), eagerly, returned
  as an in-flight block like a decode block; pure-decode iterations
  replay the K-step block. Its kernel work list is built from the host's
  lengths plus the steps in flight, an estimate: the kernel reads the
  true key counts on the device. A speculative engine's iterations with
  prefill work run the round on the same stream (`ragged_spec_fn`): each
  live lane's verify window is a ragged range beside the prompts' ranges,
  one eager dispatch returned as an in-flight round; pure-decode
  iterations replay the round's graph.
- RNG: every sampled draw is keyed by (request seed, token position)
  (engine/sampling.py), so a seeded stream does not depend on the batch.
- int8 KV (`kv_dtype="int8"`, POLYKEY_KV_DTYPE=int8): int8 value pools
  plus bf16 scale pools; rows quantize as they are written and
  dequantize as attention reads them, through the int8 kernels in both
  dispatch modes (flash still serves the bucketed prefill, over a window
  dequantized to bf16).
- Prefix cache (`prefix_cache`, engine/prefix_cache.py): admission looks
  the prompt's page-aligned prefix up, shares the cached pages and
  prefills only the suffix: in its own bucket at `start` = the cached
  length (the bucket's graph; positions are operands, and a page-aligned
  start keeps the window aligned), in chunks from that offset, or in
  ragged mode as ranges from it. In bucketed mode the match is cut so the
  suffix's padded window ends within `max_seq_len` (`_fit_window`): a
  position past the table would clamp onto the slot's last page. A
  prompt's pages enter the cache when its first token is delivered, the
  read that proves its prefill ran.
- Host-KV tier (`host_kv_bytes`): cold cache pages spill to pinned host
  pools (`_spill_for`: under admission pressure, and at retire below the
  resident floor) and fault back through the restore frontier
  (`_issue_restores`), which copies a faulting slot's pages in place into
  the device pools, ahead of its prefill on the one stream: the graphs
  captured the pools' addresses, so nothing rebinds them. With
  `kv_state_dir` the spills are also written to disk in the reference's
  wire format, and a new engine reloads them.
- Speculative decoding (`draft_model`, engine/spec_decode.py): a draft
  model with its own page pools under the same page tables (random
  weights from seed + 2, or `draft_params`, e.g. the target's own
  tensors). Every prefill fills both pools (`spec_prefill_fn` in the
  prefill graphs; a prefix hit shares both pools' pages). A block goes
  out as one draft/verify round (`spec_decode_fn`), a replay of a CUDA
  graph per (gamma rung, greedy, candidates), when every active row is
  untruncated or `top_p_candidates` > 0, else as the plain decode block.
  It rides the same pipeline and the one readback a block; each lane
  carries an acceptance EWMA and a gamma dial on the device, and the host
  picks the rung covering the widest live dial. A request reserves
  `spec_gamma` positions of page slack. The host tier spills and restores
  the target's pools only, as the reference does: a restored prefix's
  draft KV is stale, greedy streams stay exact and acceptance drops.
- Top-p candidates (`top_p_candidates` = C > 0): every sampled path keeps
  top-p / top-k within the top-C logits, and a request's top_k clamps to
  C at admission.

- Weights (`quantize`, POLYKEY_QUANTIZE=int8|int4; models/quant.py):
  weight-only int8 or int4 for the target and the draft, dequantized in
  plain PyTorch inside every product. MoE models (Mixtral; ops/moe.py) run
  in every mode, the capacity-bucketed dispatch where the config asks for
  it (`moe_dispatch`).
- Checkpoints (`checkpoint_path`, `draft_checkpoint_path`; POLYKEY_CHECKPOINT,
  POLYKEY_DRAFT_CHECKPOINT; models/loader.py): local HF safetensors for
  the target and the draft, read onto the device a tensor at a time (over
  a mesh, each tensor's shard for this rank alone) and quantized on load
  under `quantize`; without a path, weights are drawn from the seed. The reference's orbax format is refused (ROADMAP.md
  A.14).

- Serving shell (the reference's): admission sheds on queue depth and on
  an estimated queue delay that already overruns a request's deadline,
  with a retry hint sized from the service-time EWMA; fault points
  (faults.py: step-stall, slow-step, alloc-fail, prefill-error,
  tokenizer-error); `last_progress`, stamped by the engine thread only,
  which the watchdog reads (engine/watchdog.py); a traced request
  (`GenRequest.trace`, the gateway's root span) gets `queue_wait`,
  `prefill` and `decode` children, with a `decode_block` child per
  processed block; the timeline ring (obs/timeline.py) records
  admissions, prefills, dispatches, readbacks, first tokens, retirements,
  expiries and notes. `stats()` reads host state only (no `.item()`, no
  event wait, no synchronize), so a watchdog trip or a scrape never waits
  on a wedged device call. A dead engine's thread touches the device no
  more: after a fault's sleep, before each of a loop iteration's
  dispatching phases and before a prefill group, it checks `dead` (and
  its stop flag) first. The supervisor
  (engine/supervisor.py) builds a fresh engine on the same weights
  (`reuse`: no second copy, no second checkpoint read, no second
  quantization, the same `_params_fingerprint`) after
  `release_device_state` has freed the dead one's pools, graphs and
  pinned buffers, or, when its thread is wedged, keeps the dead one as an
  orphan and frees them once the thread ends; a mesh follower's loop
  does the same with its own engine at each new life (lockstep.follow_lives).

- Replica tier and control (the reference's): `queue_delay_estimate_s`,
  `load_fraction` and `prefix_warmth` are the replica pool's routing
  signals (engine/replica_pool.py); the live setters (`set_lookahead`,
  `set_prefill_budget`, `set_kv_restore_slots`, `set_resident_floor`,
  `set_spec_gamma`) and `knob_setpoints` are the autopilot's
  (engine/autopilot.py); the SLO signal plane (obs/signals.py) samples
  host counters at block boundaries and on the idle tick, and
  `stats()` carries its windowed keys.
- Disaggregated tiers (the reference's handoff halves; engine/worker.py,
  engine/disagg_pool.py): a `prefill_only` request prefills as any other,
  but its lane never activates; once its first token is on the host the
  slot's prompt pages are gathered to pinned host memory in table order
  (`_export_handoff`) and the engine emits ("handoff", KVHandoffState)
  and then ("done", timings). A `resume_state` request skips tokenize
  and prefill (`_admit_resume`): the state is validated before any pool
  write, its pages are copied into freshly allocated pages on the
  engine's stream (behind every block already queued, ahead of every
  later dispatch), and the lane is spliced at seq_len = prompt_len + 1
  through the same fixed buffers the decode graphs read; its first token
  is delivered through the lazy first-token path. `config.disagg_tier`
  scopes ":tier=" faults.

- Serving over a mesh (tp, dp, pp, ep, sp, num_slices; engine/lockstep.py):
  whenever a torch.distributed process group is up (a group of one
  included), or a mesh is passed, the engine serves over a mesh of one
  process per card. It checks the reference's geometry (device count,
  num_kv_heads % tp, slots % (dp x num_slices), ep only for MoE and
  dividing num_experts, num_layers % pp, and the draft's kv heads and
  layers), shards the weights as it draws or reads them
  (parallel/sharding.py) and holds its shard of the pools: its tp heads of
  its pp stage's layers (the draft's too). The mesh's first rank leads: it
  schedules as above and sends a record of each device dispatch (a prefill
  with its operands, a lane merge or retire, a decode block, a spec round,
  a ragged dispatch with its host-built operands and work lists, a spill
  or a restore of the host tier) to the followers, which replay them in
  order on their shards through the same functions and graphs, the
  collectives captured in them. Decode splits the lanes over dp and
  gathers the sampled tokens, so every rank's lane state stays the same; a
  prefill's columns split over sp; pp's stages run in turn
  (models/transformer.forward_paged); the ragged dispatch runs on
  tp-at-most meshes (the reference's rule), on each rank's heads. The
  prefix cache is the leader's alone (a hit is a prefill record of the
  suffix); each rank's host tier holds its shard of each page, at the
  single-card capacity. The durable state dir is the leader's too: a
  spill batch's record goes out at once and every rank hands its shard
  of the batch to the leader's whole pages (lockstep.gather_pages), and
  a reload cuts the whole pages back to each rank's host rows
  (lockstep.scatter_pages), so the files are the single-card engine's. A
  checkpoint is read as each rank's shard (models/loader.py); a
  capacity-bucketed MoE routes over the whole batch under dp and sp
  (ops/moe.moe_mlp_sharded). A supervised mesh engine restarts in
  process however it failed (lockstep.restart): every rank starts a new
  life, the next engine on the same weights over fresh groups (`rebuild`,
  lockstep.remake), the old life's engine freed or kept as an orphan.
  Over a mesh the prefill-error point fires inside the dispatch, and a
  follower's decode dispatch takes the step-stall point. Without a group
  the engine is the single-card one, with no collective.

- Host crossings (the reference's census): every deliberate crossing of
  the serving loop (a resolve point's wait and read, a copy to pinned
  memory, an upload of host-built operands, the merge's and retire's
  scalar writes, the host tier's gathers and restores) sits in a
  `_host_crossing(site)` scope, counted in `CROSSING_CENSUS`. graphlint
  (analysis/graph.py) runs the loop under a host-sync guard entered
  through `loop_guard` on the engine thread, and holds the sites each
  mode fires to the reference's table.

Not ported yet (ROADMAP.md queue A): a CUDA graph of the ragged
dispatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..faults import get_injector
from ..models.config import ModelConfig, get_config
from ..models.loader import load_checkpoint
from ..models.quant import params_bytes, quantize_params
from ..obs.signals import (
    ENV_POLICY,
    ENV_WINDOWS,
    SignalPlane,
    SloPolicy,
    windows_from_spec,
)
from ..obs.timeline import TimelineRecorder
from ..models.transformer import forward_paged, forward_ragged, init_params, unembed
from ..parallel.collectives import gather_from
from ..parallel.sharding import shard_params
from ..ops import (
    flash_attention,
    paged_attention_kernel,
    paged_write_kernel,
    ragged_paged_attention_kernel,
)
from ..ops.ragged_paged_attention_kernel import TOKEN_TILE, ragged_work
from .config import EngineConfig
from . import host_guard, lockstep
from .graphs import CAPTURE_LOCK, CudaGraphs
from .kv_cache import (
    AllocationError,
    BlockAllocator,
    HostKVPool,
    KVHandoffState,
    KVWireError,
    PagedKV,
    host_kv_page_bytes,
    init_paged_kv,
)
from .metrics import EngineMetrics, RequestTimings
from .prefix_cache import TIER_DEVICE, TIER_HOST, PrefixCache, PrefixStateStore
from .sampling import sample_tail
from .spec_decode import (
    GAMMA_EWMA_BETA,
    SPEC_STAT_COLS,
    ragged_spec_fn,
    spec_decode_fn,
    spec_prefill_fn,
)
from .tokenizer import load_tokenizer

if TYPE_CHECKING:
    from ..obs.trace import Span

_MAX_PREFILL_GROUP = 8   # burst admissions batched per prefill dispatch
_GROUP_PADS = (1, 2, 4, 8)
# prefix_warmth's weight of a host-resident token against a device one: a
# restore stands between it and a dispatch.
_HOST_WARMTH_WEIGHT = 0.5

# Error-message prefix contract with the gateway: engine failures that
# begin with this map to gRPC DEADLINE_EXCEEDED (torch_service).
DEADLINE_MSG = "deadline exceeded"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# The kernels of the serving path, by name, for stats and chip_smoke.py.
KERNELS = {
    "flash_attention": flash_attention.KERNEL,
    "paged_attention_decode": paged_attention_kernel.KERNEL,
    "paged_write": paged_write_kernel.KERNEL,
    "ragged_paged_attention": ragged_paged_attention_kernel.KERNEL,
    "paged_attention_decode_int8": paged_attention_kernel.KERNEL_INT8,
    "paged_write_int8": paged_write_kernel.KERNEL_INT8,
    "ragged_paged_attention_int8": ragged_paged_attention_kernel.KERNEL_INT8,
}

# Sanctioned-crossing census (the reference's engine/engine.py): every
# `_host_crossing` scope names its site and counts here, so graphlint's
# GL004 (analysis/graph.py SANCTIONED_CROSSINGS) pins the SET of crossing
# sites a serving sweep fires per engine mode. Engine-thread writes only;
# GL004 reads the deltas around its guarded drive.
CROSSING_CENSUS: dict = {}
_NO_GUARD = contextlib.nullcontext()


def _host_crossing(site: str = "unlabeled"):
    """A deliberate host<->device crossing: a resolve point's wait and read
    of a landed copy, the start of a copy to pinned memory, an upload of
    host-built operands, the lane merge's and retire's scalar writes into
    the lane buffers (on the card a Python scalar goes up as a CPU tensor),
    the host tier's gathers and restores. graphlint's GL004 sweeps the
    serving loop under `host_guard.HostSyncGuard`; these scopes mark the
    sanctioned crossings, so a NEW host read or device copy in the loop
    trips the guard there instead of shipping silently.

    `site` labels the crossing for the census above, by the reference's
    names where the reference has the site. Fast path: with no guard open
    in the process (every run but graphlint's) the scope is its count and
    one test, a shared no-op context."""
    CROSSING_CENSUS[site] = CROSSING_CENSUS.get(site, 0) + 1
    if not host_guard.OPEN:
        return _NO_GUARD
    return host_guard.sanctioned()


@dataclass
class GenRequest:
    """One generation request, enqueued by a gRPC handler thread.

    The engine pushes ("token", id), then ("done", RequestTimings) or
    ("error", message) into `out`.
    """

    prompt: str
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0             # <= 0 → disabled
    # Identical (prompt, seed, sampling) yields an identical stream
    # whatever the batch: draws are keyed by (seed, token position).
    # Seeds are taken mod 2**64; None → a fresh root from the engine's
    # seed RNG.
    seed: Optional[int] = None
    # Absolute monotonic deadline (None → none). Expired requests are
    # dropped at dequeue and at decode-block boundaries.
    deadline: Optional[float] = None
    out: queue.Queue = field(default_factory=queue.Queue)
    cancelled: threading.Event = field(default_factory=threading.Event)
    timings: RequestTimings = field(default_factory=RequestTimings)
    # Root span attached by the gateway; None means the request is
    # untraced and the engine records no spans for it. The engine appends
    # queue_wait / prefill / decode children; decode gets a decode_block
    # child per processed block.
    trace: Optional["Span"] = None
    # Disaggregated tiers. `prefill_only`: prefill, then emit ("handoff",
    # KVHandoffState) and ("done", ...) instead of decoding (the prefill
    # worker's mode). `resume_state`: a deserialized KVHandoffState; the
    # engine skips tokenize and prefill, copies the shipped pages into its
    # own pool and resumes decode at seq_len = prompt_len + 1 (the decode
    # worker's mode). Both off on every other path.
    prefill_only: bool = False
    resume_state: Optional[KVHandoffState] = None


@dataclass
class _Slot:
    request: GenRequest
    pages: list[int]
    table: np.ndarray              # [P] int32 page table
    seed_row: np.ndarray           # [2] int32 seed halves
    prompt_len: int
    position_cap: int              # absolute position limit
    # A grouped prefill's ids from `filled` on, until the dispatch.
    prompt_ids: Optional[np.ndarray] = None
    # Chunked / ragged prefill: the prompt's ids while any are left to
    # prefill. `filled`: positions already in the slot's pages (a prefix
    # cache hit, then the chunks); `pending is None` once merged.
    pending: Optional[np.ndarray] = None
    filled: int = 0
    # The whole prompt, kept until its pages enter the prefix cache.
    cache_ids: Optional[np.ndarray] = None
    # A prefill_only request's whole prompt, for its handoff state.
    handoff_ids: Optional[np.ndarray] = None
    # A faulting slot's host pages, [(key, host page, chain index)], until
    # the restore frontier issues their copy; it joins no prefill before.
    restore_pages: Optional[list] = None
    generated: int = 0
    merged: bool = False           # device lane activated
    last_emit: float = 0.0
    # The merged prefill's first token on its way to host memory, until
    # delivered.
    first: Optional["_FirstToken"] = None
    # The traced request's decode span, open from its first token.
    decode_span: Optional["Span"] = None


class _RRCursor:
    """Starved-first round-robin cursor over a modulo-N slot space. A
    sweep iterates `scan`; a completed sweep calls `advance`, so index
    order alone never privileges a slot; an early exit (budget spent,
    stream full) calls `reanchor` on the first skipped slot, so it scans
    first next time."""

    __slots__ = ("pos",)

    def __init__(self) -> None:
        self.pos = 0

    def scan(self, n: int):
        """(pos + 0) % n ... (pos + n - 1) % n, anchored at the call."""
        base = self.pos
        return ((base + off) % n for off in range(n))

    def reanchor(self, i: int) -> None:
        self.pos = i

    def advance(self, n: int) -> None:
        self.pos = (self.pos + 1) % n


class _InflightBlock(NamedTuple):
    """One dispatched-but-unprocessed decode block, ragged dispatch or
    speculative round of the lookahead pipeline: its packed tokens on
    their way to host memory (`host`, landed once `event` has fired; no
    event on the CPU, where the block ran in the call), the request in
    each slot at dispatch time, its dispatch sequence number (at process
    time, the engine's `_dispatch_seq - seq` is the OBSERVED lookahead,
    the blocks dispatched after this one before its readback), its
    kind: "decode" ([K, B] tokens) or "spec" (the round's packed
    [B, gamma + 1 + SPEC_STAT_COLS] matrix), the host gap before its
    dispatch (ms, the device-time attribution window) and the lanes live
    at dispatch."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    reqs: list
    seq: int
    kind: str = "decode"
    gap_ms: float = 0.0
    live: tuple = ()


class _FirstToken(NamedTuple):
    """A merged lane's sampled first token on its way to host memory: row
    `row` of `host`, landed once `event` has fired (no event on the CPU).
    `seq` is the engine's `_dispatch_seq` when its copy was queued: every
    block of a higher sequence number runs after it on the stream."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    row: int
    seq: int


class EngineDeadError(RuntimeError):
    """The engine (or a replica pool) cannot take work. `retry_after_ms`,
    where the raiser can estimate it (a pool with a supervised restart in
    flight), is the recovery hint the gateway ships as the
    `retry-after-ms` trailer on the UNAVAILABLE it maps to."""

    def __init__(self, message: str, retry_after_ms: Optional[int] = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class EngineOverloadedError(RuntimeError):
    """Admission shed this request (queue bound or estimated-delay
    check). `retry_after_ms` is the engine's best guess at when a retry
    could be admitted — the gateway ships it as trailing metadata."""

    def __init__(self, message: str, retry_after_ms: int = 100):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class LockstepError(RuntimeError):
    """A dispatch over a mesh failed after its record went out: the ranks
    may be out of step, so the engine dies with it (engine/lockstep.py)."""


def _prefill_fn(
    params, cfg: ModelConfig, paged: PagedKV,
    tokens, start, last_rel, page_table, seeds, temperature, top_p, top_k,
    *, greedy: bool, aligned: bool, candidates: int = 0, mesh=None,
):
    """Prefill N windows (tokens [N, T]) at absolute positions
    start[i]..start[i]+T-1 and sample from each hidden state at relative
    index last_rel[i]; the draw is keyed by the sampled token's position.
    Padded tail positions write KV that is masked or later overwritten;
    padded group rows point their whole table at the garbage page.
    `aligned` is the caller's host-side knowledge that every start and T
    are multiples of the page size (the page-granular KV write). Over a
    `mesh` every rank computes every row (T split over sp inside
    forward_paged) and samples the same tokens."""
    N, T = tokens.shape
    positions = (
        start[:, None] + torch.arange(T, dtype=torch.int32, device=tokens.device)
    ).to(torch.int32)
    hidden, paged = forward_paged(
        params, cfg, tokens, positions, paged, page_table, aligned=aligned, mesh=mesh
    )
    last = hidden[torch.arange(N, device=tokens.device), last_rel.long()]
    logits = unembed(params, cfg, last, mesh)
    token = sample_tail(
        logits, seeds, start + last_rel + 1, temperature, top_p, top_k, greedy,
        candidates,
    )
    return token, paged


def _decode_fn(
    params, cfg: ModelConfig, paged: PagedKV,
    last_tokens, seq_lens, page_tables, active, caps, seeds, temperature,
    top_p, top_k,
    *, greedy: bool, steps: int, eos_id: int, candidates: int = 0, mesh=None,
):
    """`steps` decode steps for the whole slot batch in one dispatch.

    Each step writes KV for the current tokens at position seq_lens-1,
    samples the next token for live lanes and advances the lane state on
    the device. A lane stops at EOS or when seq_lens reaches its position
    cap, mirroring the host's _maybe_finish. The final lane state goes
    back into `last_tokens`, `seq_lens` and `active` IN PLACE (the
    reference returns it and donates the old buffers), so a CUDA graph of
    this block reads and writes fixed addresses. Returns the packed
    [steps, B] int32 tokens, -1 where a lane emitted nothing.

    Over a `mesh` each rank computes its dp share of the lanes (a
    contiguous run, in dp order) and the sampled tokens are all-gathered
    over dp, so every rank advances the whole lane state the same way.
    """
    last, seq, act = last_tokens, seq_lens, active
    lanes = slice(None)
    dp = mesh.shape["dp"] if mesh is not None else 1
    if dp > 1:
        b = last_tokens.shape[0] // dp
        lanes = slice(mesh.coord("dp") * b, (mesh.coord("dp") + 1) * b)
    packed = []
    for _ in range(steps):
        positions = torch.clamp(seq - 1, min=0)[:, None]
        hidden, paged = forward_paged(
            params, cfg, last[lanes, None], positions[lanes], paged, page_tables[lanes],
            mesh=mesh,
        )
        logits = unembed(params, cfg, hidden[:, 0], mesh)
        tokens = sample_tail(logits, seeds[lanes], seq[lanes], temperature[lanes],
                             top_p[lanes], top_k[lanes], greedy, candidates)
        if dp > 1:
            tokens = gather_from(tokens, mesh, "dp", 0)
        tokens = torch.where(act, tokens, torch.zeros_like(tokens))
        new_seq = seq + act.to(torch.int32)
        cont = act & (tokens != eos_id) & (new_seq < caps)
        packed.append(torch.where(act, tokens, torch.full_like(tokens, -1)))
        last, seq, act = tokens, new_seq, cont
    last_tokens.copy_(last)
    seq_lens.copy_(seq)
    active.copy_(act)
    return torch.stack(packed)


def _ragged_fn(
    params, cfg: ModelConfig, paged: PagedKV,
    last_tokens, seq_lens, page_tables, active, caps, seeds, temperature,
    top_p, top_k,
    pre_tokens, pre_pos, pre_table_idx, pre_tables,
    pre_range_start, pre_range_len, pre_range_kv, pre_range_table,
    pre_sample_idx, pre_sample_pos, pre_seeds, pre_temp, pre_top_p,
    pre_top_k,
    *, greedy: bool, eos_id: int, work=None, candidates: int = 0, mesh=None,
):
    """One flat mixed prefill+decode dispatch: every decode lane advances
    exactly one step and up to W prefill tokens (ranges appended by the
    host's batch builder) prefill, through one [B + W]-token forward_ragged.

    Rows [0, B) are the decode lanes' single tokens (row b = slot b at
    position seq_lens[b] - 1; inactive lanes compute masked garbage through
    their garbage tables, as in _decode_fn); rows [B, B + W) are the
    prefill stream. `pre_table_idx[w]` maps each prefill row to its slot's
    host-side table in `pre_tables` [B, P] (index B: an all-garbage row).
    `pre_range_*` [B] describe the ranges for the ragged attention (unused
    ones are empty ranges past the end). Decode rows sample and stop
    exactly as one _decode_fn step and return the same packed [1, B] row;
    `pre_sample_idx[b]` names the prefill row whose hidden state samples
    slot b's first token at position key `pre_sample_pos[b]` (= prompt
    length, as _prefill_fn keys it); the host reads only final-range
    slots' draws. `work` is the ragged kernel's work list for these
    ranges. Over a (tp-at-most) `mesh` every rank runs the whole stream on
    its heads and the logits are gathered over tp before sampling.
    Returns (packed, tokens, seq_lens, active, first, paged)."""
    B = last_tokens.shape[0]
    W = pre_tokens.shape[0]
    dev = last_tokens.device
    tokens = torch.cat([last_tokens, pre_tokens])
    positions = torch.cat([torch.clamp(seq_lens - 1, min=0), pre_pos]).to(torch.int32)
    tables_ext = torch.cat([pre_tables, torch.zeros_like(pre_tables[:1])])
    token_tables = torch.cat([page_tables, tables_ext[pre_table_idx.long()]])
    rng_starts = torch.cat([torch.arange(B, dtype=torch.int32, device=dev),
                            B + pre_range_start])
    rng_lens = torch.cat([torch.ones(B, dtype=torch.int32, device=dev), pre_range_len])
    rng_kv = torch.cat([torch.clamp(seq_lens, min=1), pre_range_kv])
    seq_tables = torch.cat([page_tables, tables_ext[pre_range_table.long()]])
    hidden, paged = forward_ragged(
        params, cfg, tokens, positions, paged, token_tables,
        rng_starts, rng_lens, rng_kv, seq_tables, work=work, mesh=mesh,
    )
    logits = unembed(params, cfg, hidden[:B], mesh)
    dec = sample_tail(logits, seeds, seq_lens, temperature, top_p, top_k, greedy,
                      candidates)
    dec = torch.where(active, dec, torch.zeros_like(dec))
    new_seq = seq_lens + active.to(torch.int32)
    cont = active & (dec != eos_id) & (new_seq < caps)
    packed = torch.where(active, dec, torch.full_like(dec, -1))[None, :]
    rows = hidden[B + torch.clamp(pre_sample_idx, 0, W - 1).long()]
    first = sample_tail(
        unembed(params, cfg, rows, mesh), pre_seeds, pre_sample_pos, pre_temp,
        pre_top_p, pre_top_k, greedy, candidates,
    )
    return packed, dec, new_seq, cont, first, paged


def ragged_zero_operands(B: int, W: int, P: int) -> tuple:
    """The 14 positional prefill operands of `_ragged_fn`, all-zero /
    all-garbage (no ranges, no sample rows): the one builder of a
    synthetic ragged call, and the layout `_ragged_prefill_operands` fills."""
    return (
        np.zeros((W,), np.int32),            # pre_tokens
        np.zeros((W,), np.int32),            # pre_pos
        np.full((W,), B, np.int32),          # pre_table_idx -> garbage row
        np.zeros((B, P), np.int32),          # pre_tables
        np.full((B,), W, np.int32),          # pre_range_start -> past end
        np.zeros((B,), np.int32),            # pre_range_len
        np.zeros((B,), np.int32),            # pre_range_kv
        np.full((B,), B, np.int32),          # pre_range_table -> garbage
        np.zeros((B,), np.int32),            # pre_sample_idx
        np.zeros((B,), np.int32),            # pre_sample_pos
        np.zeros((B, 2), np.int32),          # pre_seeds
        np.zeros((B,), np.float32),          # pre_temp
        np.ones((B,), np.float32),           # pre_top_p
        np.zeros((B,), np.int32),            # pre_top_k
    )


def _pack(arrays, pin: bool) -> torch.Tensor:
    """The int32 and float32 `arrays` end to end in one int32 host tensor,
    pinned (`pin`) for a copy to the card that does not synchronize.
    A fresh tensor a call: PyTorch's pinned allocator keeps its block until
    the copies that read it have run, so a refill cannot overtake a copy
    still queued behind the blocks in flight."""
    host = torch.empty(sum(a.size for a in arrays), dtype=torch.int32, pin_memory=pin)
    flat = host.numpy()
    off = 0
    for a in arrays:
        flat[off:off + a.size] = np.ascontiguousarray(a).view(np.int32).reshape(-1)
        off += a.size
    return host


def _unpack(buf: torch.Tensor, specs) -> list:
    """Views of the int32 tensor `buf` laid out as `_pack` lays out arrays
    of `specs`, [(shape, numpy dtype)]."""
    views, off = [], 0
    for shape, dtype in specs:
        n = int(np.prod(shape))
        v = buf[off:off + n]
        if np.dtype(dtype) == np.float32:
            v = v.view(torch.float32)
        views.append(v.view(shape))
        off += n
    return views


def _to_device(arrays, device) -> list:
    """`arrays` (int32, float32) on `device` as views of one buffer, sent
    by one copy through pinned memory that does not synchronize."""
    dev = torch.device(device)
    host = _pack(arrays, pin=dev.type == "cuda")
    buf = host.to(dev, non_blocking=True)
    return _unpack(buf, [(a.shape, a.dtype) for a in arrays])


def prefill_graph_keys(buckets, chunk: int, page_size: int) -> list:
    """The prefill graphs' keys (width, n_pad, greedy, aligned): every
    bucket at every group pad, and the chunk width alone when it is no
    bucket. Buckets prefill from position 0 and chunks from multiples of
    the chunk, so a width's windows are page-aligned exactly when the
    width is a multiple of the page size: `aligned` takes that one value."""
    shapes = {(w, n) for w in buckets for n in _GROUP_PADS} | {(chunk, 1)}
    return [(w, n, g, w % page_size == 0) for w, n in sorted(shapes)
            for g in (True, False)]


def spec_graph_keys(rungs, candidates: int) -> list:
    """The spec round graphs' keys (gamma, greedy, candidates): every gamma
    rung at each variant a batch can reach, (greedy, 0), (sampled, 0) and,
    with the prefilter, (sampled, C). An all-greedy batch is all
    untruncated, so it dispatches candidates 0."""
    variants = [(True, 0), (False, 0)] + ([(False, candidates)] if candidates else [])
    return [(g, greedy, c) for g in sorted(set(rungs)) for greedy, c in variants]


class PrefillOperands:
    """`_prefill_fn`'s operands at group pad `n`, in fixed buffers (the
    addresses the prefill graphs capture), made as ordinary allocations
    before any capture and zero-filled, so every table row points at the
    garbage page 0. One int32 buffer holds starts, last_rel, tables, seeds,
    temperature, top_p, top_k and, last, the [n, width] tokens, so every
    width's views start at the same addresses; `upload` fills it by one
    copy (through pinned memory on the card, without a sync)."""

    def __init__(self, n: int, max_width: int, pages_per_seq: int, device):
        self.n, self._P = n, pages_per_seq
        size = sum(int(np.prod(shape)) for shape, _ in self.specs(max_width))
        self.buf = torch.zeros(size, dtype=torch.int32, device=device)

    def specs(self, width: int) -> list:
        n, i32, f32 = self.n, np.int32, np.float32
        return [((n,), i32), ((n,), i32), ((n, self._P), i32), ((n, 2), i32),
                ((n,), f32), ((n,), f32), ((n,), i32), ((n, width), i32)]

    def views(self, width: int) -> tuple:
        """Device views in `_prefill_fn`'s order: (tokens, start, last_rel,
        page_table, seeds, temperature, top_p, top_k)."""
        *rest, tokens = _unpack(self.buf, self.specs(width))
        return (tokens, *rest)

    def upload(self, tokens, start, last_rel, page_table, seeds, temperature,
               top_p, top_k) -> None:
        """Fill the buffers from numpy arrays in `views`' order."""
        host = _pack([start, last_rel, page_table, seeds, temperature, top_p, top_k,
                      tokens], pin=self.buf.is_cuda)
        self.buf[:host.numel()].copy_(host, non_blocking=True)


def _merge_lane_fn(
    state: dict, slot: int, tokens_vec, row: int, seq_len: int, cap: int,
    temp: float, tp: float, tk: int, table_row, seed_row, *, eos_id: int,
    gamma_reset: Optional[int] = None,
) -> None:
    """Activate ONE decode lane on the device, in place: splice the
    prefill's sampled token (still a device tensor) and the slot's
    geometry into the lane state. The lane is born live only if its first
    token is not EOS and the position budget allows generation. A
    speculative engine (`gamma_reset`, its gamma_max) also starts the
    lane's acceptance EWMA at 1.0 and its dial at gamma_max: the dial is
    the request's own evidence, never its slot's previous occupant's."""
    token = tokens_vec.reshape(-1)[row]
    live = (token != eos_id) & (seq_len < cap)
    state["last_tokens"][slot] = token
    state["seq_lens"][slot] = seq_len
    state["page_tables"][slot] = table_row
    state["active"][slot] = live
    state["caps"][slot] = cap
    state["temperature"][slot] = temp
    state["top_p"][slot] = tp
    state["top_k"][slot] = tk
    state["seeds"][slot] = seed_row
    if gamma_reset is not None:
        state["accept_ewma"][slot] = 1.0
        state["gamma_lane"][slot] = gamma_reset


def _retire_lane_fn(state: dict, slot: int) -> None:
    """Deactivate ONE lane on the device and point its page table at the
    reserved garbage page, so later blocks stop writing through a table
    whose pages went back to the allocator."""
    state["last_tokens"][slot] = 0
    state["seq_lens"][slot] = 0
    state["page_tables"][slot] = 0
    state["active"][slot] = False
    state["caps"][slot] = 0


def _kv_gather_fn(paged: PagedKV, idx: torch.Tensor) -> list:
    """The pages `idx` (int64, on the pools' device) of every pool, for a
    spill to the host tier: k and v, and for int8 KV the pair form, the
    values with their bf16 scale pools. Read-only; each result is [L,
    len(idx), ...]. The reference pads `idx` to pages_per_seq for one
    static shape; eager, this takes exactly the pages named."""
    return [torch.index_select(t, 1, idx) for t in paged.pools]


def _kv_restore_fn(paged: PagedKV, idx: torch.Tensor, pages: list) -> None:
    """Write page contents (`_kv_gather_fn`'s layout, on the pools' device)
    into the pools at page ids `idx`, byte for byte (int8: values and
    scales together). In place: the CUDA graphs read the pools at the
    addresses they captured, so the pools are never rebuilt."""
    for pool, src in zip(paged.pools, pages):
        pool.index_copy_(1, idx, src)


def _page_index(pages, device) -> torch.Tensor:
    """Page ids as an int64 index on `device`, sent without a sync."""
    return _to_device([np.asarray(pages, np.int32)], device)[0].long()


def gather_to_host(paged: PagedKV, pages: list) -> list:
    """The pools' pages `pages` in host memory: gathered on the device
    (`_kv_gather_fn`), copied to pinned memory and waited for (a spill
    blocks here, as the reference's does). On the CPU the gather itself."""
    outs = _kv_gather_fn(paged, _page_index(pages, paged.k.device))
    if paged.k.device.type != "cuda":
        return outs
    hosts = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
    for h, o in zip(hosts, outs):
        h.copy_(o, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return hosts


def restore_from_host(paged: PagedKV, host: HostKVPool, rows: list, pages: list) -> None:
    """Copy host pages `rows` into the pools' pages `pages` on the current
    stream, without a sync: first into a fresh pinned staging buffer (never
    a non-blocking copy from the host pool itself, whose pages the caller
    may release and a later spill overwrite before the copy has run; the
    pinned allocator keeps the buffer until the copy is done), then up to
    the device and in place into the pools (`_kv_restore_fn`)."""
    dev = paged.k.device
    pin = dev.type == "cuda"
    sel = torch.tensor(rows, dtype=torch.long)
    staged = []
    for src in host.pools:
        buf = torch.empty((src.shape[0], len(rows), *src.shape[2:]), dtype=src.dtype,
                          pin_memory=pin)
        torch.index_select(src, 1, sel, out=buf)
        staged.append(buf.to(dev, non_blocking=True))
    _kv_restore_fn(paged, _page_index(pages, dev), staged)


def import_handoff(paged: PagedKV, lanes: dict, slot: int, state: KVHandoffState,
                   pages: list, table, seed_row, cap: int, temp: float, top_p: float,
                   top_k: int, *, eos_id: int, gamma_reset: Optional[int] = None,
                   start: Optional[torch.cuda.Event] = None) -> None:
    """The decode tier's import of a handoff, on the current stream and
    without a sync: the state's page arrays through fresh pinned buffers
    (a copy from pageable memory would wait for the work in flight) into
    the pools' pages `pages` in table order, in place (`_kv_restore_fn`),
    then lane `slot` spliced at seq_len = prompt_len + 1 with the state's
    first token, its table `table` ([P] int32) and seed halves `seed_row`,
    in the buffers `lanes` the decode graphs read (`_merge_lane_fn`).
    `start`, if given, is recorded once everything is staged and allocated,
    right ahead of the copies."""
    dev = paged.k.device
    cuda = dev.type == "cuda"
    pinned = []
    for src in state.pools:
        buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda)
        buf.copy_(src)
        pinned.append(buf)
    idx = _page_index(pages[:state.num_pages], dev)
    token, table_dev, seed_dev = _to_device(
        [np.array([state.first_token], dtype=np.int32), table, seed_row], dev)
    staged = [torch.empty(buf.shape, dtype=buf.dtype, device=dev) for buf in pinned]
    if start is not None:
        start.record()
    for dst, buf in zip(staged, pinned):
        dst.copy_(buf, non_blocking=True)
    _kv_restore_fn(paged, idx, staged)
    _merge_lane_fn(lanes, slot, token, 0, state.prompt_len + 1, cap, temp, top_p, top_k,
                   table_dev, seed_dev, eos_id=eos_id, gamma_reset=gamma_reset)


class InferenceEngine:
    def __init__(
        self,
        config: EngineConfig,
        params: Optional[dict] = None,
        device=None,
        health=None,
        logger=None,
        seed: int = 0,
        draft_params: Optional[dict] = None,
        reuse: Optional[dict] = None,
        mesh=None,
    ):
        """`reuse` is another engine's `_ctor_args` (a supervised restart on
        the same config): its weights serve this engine as they are, with
        no checkpoint read, no quantization and no copy, and its seed and
        fingerprint basis are kept, so a durable prefix store warms the
        fresh engine as it did the old one. `mesh` is a serving mesh built
        by `lockstep.serving_mesh` on every rank (a test's ranks build
        several side by side); None builds it over the whole process group
        when one is up. `params` are the whole model's on every rank."""
        config.validate()
        self.config = config
        self.device = resolve_device(device)
        self.model_cfg = get_config(config.model)
        # Serving over a mesh (engine/lockstep.py): the geometry is checked
        # before any group is made, as the reference checks it.
        self.mesh = self._serving_mesh(config, mesh)
        self._leader: Optional[lockstep.Leader] = None
        self._digest: Optional[lockstep.TokenDigest] = None
        self.is_follower = False
        # The in-process restart of a mesh engine (engine/lockstep.py): set
        # on a leader whose supervisor rebuilds it (gateway/torch_service);
        # `closed_with` is the record its end sent, or the word said of its
        # life ("rebuild", "shutdown"); a follower's `restart_requested`
        # says its leader sent "restart".
        self.mesh_restart = False
        self.closed_with: Optional[str] = None
        self.restart_requested = False
        self.replayed: dict[str, int] = {}     # a follower's records, by kind
        if self.mesh is not None:
            if self.mesh.rank == lockstep.leader_rank(self.mesh):
                self._leader = lockstep.Leader(self.mesh)
            else:
                self.is_follower = True
            if lockstep.world(self.mesh) > 1:
                self._digest = lockstep.TokenDigest()
        # The last prefill's (tokens, page tables, seeds) on the device, the
        # operands of the lane merges that follow it.
        self._last_prefill: Optional[tuple] = None
        self.tokenizer = load_tokenizer(config.tokenizer)
        self.metrics = EngineMetrics()
        self.health = health
        self.logger = logger
        # Fault injection (faults.py): None unless POLYKEY_FAULTS is set or
        # a test installed one, so every injection point is one `is None`.
        self._faults = get_injector()
        # Identity within a replica pool (engine/replica_pool.py): fault
        # targeting (":replica=N") and per-replica metric labels key on it.
        # A lone engine is 0.
        self.replica_id = config.replica
        # Tier identity inside a disaggregated worker (":tier=" targeting);
        # None for every other engine.
        self._tier = config.disagg_tier or None
        # Flight-deck timeline; timeline_capacity=0 allocates no ring.
        self.timeline: Optional[TimelineRecorder] = (
            TimelineRecorder(config.timeline_capacity)
            if config.timeline_capacity > 0 else None
        )
        # SLO signal plane (obs/signals.py): windowed rates and
        # delta-quantiles over a ring of host-counter samples, and the
        # POLYKEY_SLO objectives' burn rates. It rides the metrics object,
        # which a supervised restart hands on; signals_interval_s=0
        # allocates nothing. Config first, the env for empty specs.
        if config.signals_interval_s > 0:
            self.metrics.signals = SignalPlane(
                self.metrics,
                windows=windows_from_spec(
                    config.signals_windows or os.environ.get(ENV_WINDOWS, "")),
                interval_s=config.signals_interval_s,
                policy=SloPolicy.from_spec(
                    config.slo_policy or os.environ.get(ENV_POLICY, "")),
                timeline=self.timeline,
            )
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self._dtype = _DTYPES[config.dtype]
        pool_dtype = _DTYPES.get(config.kv_dtype, self._dtype)
        if reuse is not None:
            seed = reuse["seed"]
            params, draft_params = reuse["params"], reuse["draft_params"]
        self._seed_rng = np.random.default_rng(seed + 3)

        self._params_explicit = (reuse["explicit"] if reuse is not None
                                 else params is not None)
        # Weight-only int8/int4 (models/quant.py), as the reference: passed
        # weights are quantized whole; random ones a layer at a time as
        # they are drawn, the same tree, so a model whose bf16 weights do
        # not fit on the card (mixtral-8x7b) is never held in bf16.
        bits = config.quantize_bits if config.quantize else None
        if reuse is not None:
            pass                # the replaced engine's tree, as it holds it
        elif params is None and config.checkpoint_path:
            # A local checkpoint (models/loader.py: safetensors or orbax),
            # read onto the device a tensor at a time and quantized a layer
            # at a time; over a mesh each tensor is cut to this rank's shard
            # before it reaches the device.
            params = load_checkpoint(config.checkpoint_path, self.model_cfg, self._dtype,
                                     self.device, quantize_bits=bits, mesh=self.mesh)
        elif params is None:
            # Over a mesh each layer is cut to this rank's shard as it is
            # drawn (the same draws on every rank).
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.model_cfg, self._dtype, self.device, gen,
                                 quantize_bits=bits, mesh=self.mesh)
        else:
            if bits is not None:
                params = quantize_params(params, self.model_cfg, bits=bits)
            if self.mesh is not None:
                params = shard_params(params, self.model_cfg, self.mesh)
        self.params = params
        self._weight_bytes = params_bytes(params)
        B, P = config.max_decode_slots, config.pages_per_seq
        kv_q = torch.int8 if config.kv_dtype == "int8" else None
        # This rank's shard of every pool (and host pool): its tp heads of
        # its pp stage's layers.
        self._pool_shard = ({"tp": self.mesh.shape["tp"], "pp": self.mesh.shape["pp"]}
                            if self.mesh is not None else {})
        self.paged = init_paged_kv(
            self.model_cfg, config.num_pages, config.page_size,
            pool_dtype, self.device, kv_dtype=kv_q, **self._pool_shard,
        )
        # Speculative decoding: the draft model and its own pools, indexed
        # by the same page tables (position -> (page, offset) does not
        # depend on the model). Lanes dial gamma on the ladder {gamma_low,
        # gamma_max}; `_gamma` is the dispatch rung, under `_gamma_cap`
        # (set_spec_gamma). Page slack always reserves gamma_max.
        self._spec = config.draft_model is not None
        self._gamma_max = config.spec_gamma if self._spec else 0
        self._gamma = self._gamma_max
        self._gamma_low = (max(1, config.spec_gamma // 2)
                           if self._spec and config.adaptive_gamma else self._gamma_max)
        self._gamma_cap = self._gamma_max
        self._accept_ewma = 1.0     # batch aggregate, observability only
        # Rounds processed, lanes that emitted in them, tokens emitted.
        self._spec_rounds = self._spec_lane_rounds = self._spec_tokens = 0
        if self._spec:
            self.draft_cfg = get_config(config.draft_model)
            if self.draft_cfg.vocab_size != self.model_cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {self.draft_cfg.vocab_size} != target vocab "
                    f"{self.model_cfg.vocab_size}"
                )
            # The quantize knob covers the draft too, as in the reference.
            if reuse is not None:
                pass
            elif draft_params is None and config.draft_checkpoint_path:
                draft_params = load_checkpoint(
                    config.draft_checkpoint_path, self.draft_cfg, self._dtype,
                    self.device, quantize_bits=bits, mesh=self.mesh)
            elif draft_params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed + 2)
                draft_params = init_params(self.draft_cfg, self._dtype, self.device, gen,
                                           quantize_bits=bits, mesh=self.mesh)
            else:
                if bits is not None:
                    draft_params = quantize_params(draft_params, self.draft_cfg, bits=bits)
                if self.mesh is not None:
                    draft_params = shard_params(draft_params, self.draft_cfg, self.mesh)
            self.draft_params = draft_params
            self.d_paged = init_paged_kv(
                self.draft_cfg, config.num_pages, config.page_size,
                pool_dtype, self.device, kv_dtype=kv_q, **self._pool_shard,
            )
        # The weights as this engine holds them (on the device, quantized):
        # the supervisor's factory builds a replacement on them (`reuse`).
        self._ctor_args = {
            "params": self.params,
            "draft_params": self.draft_params if self._spec else None,
            "seed": seed,
            "explicit": self._params_explicit,
        }
        # Pool facts stats() reports, kept on the host: stats() must not
        # touch the pools, which `release_device_state` drops.
        self._kv_pool_bytes = self.paged.nbytes
        self._kv_dtype_name = "int8" if self.paged.quantized else str(
            self.paged.k.dtype).removeprefix("torch.")
        self._draft_kv_pool_bytes = self.d_paged.nbytes if self._spec else 0
        self.allocator = BlockAllocator(config.num_pages)
        # Host-KV tier: cold prefix pages in pinned host pools. 0 bytes: no
        # pool, no store.
        self._host_kv: Optional[HostKVPool] = None
        self._kv_state: Optional[PrefixStateStore] = None
        self._kv_reloaded_pages = 0
        if config.host_kv_bytes > 0:
            page_b = host_kv_page_bytes(self.model_cfg, config.page_size, pool_dtype, kv_q)
            capacity = config.host_kv_bytes // max(1, page_b)
            if capacity < 1:
                raise ValueError(
                    f"POLYKEY_HOST_KV_BYTES={config.host_kv_bytes} is smaller "
                    f"than one KV page ({page_b} bytes for {self.model_cfg.name} "
                    f"at page_size {config.page_size})"
                )
            # The whole model's page bytes set the capacity, as on one card;
            # over a mesh each rank's pool holds its shard of those pages.
            self._host_kv = HostKVPool(
                self.model_cfg, capacity, config.page_size, pool_dtype,
                kv_q is not None, pin=self.device.type == "cuda", **self._pool_shard,
            )
        # _finish spills while fewer device pages than the resident floor
        # are free; the restore frontier issues at most `_restore_slots`
        # slots an iteration (a live knob: set_kv_restore_slots), and at
        # least one.
        self._resident_low = config.host_kv_resident_pages or config.num_pages // 8
        self._restore_slots = max(1, config.host_kv_restore_slots)
        self._restore_rr = _RRCursor()
        # The durable store's gc lists and parses the whole dir: once every
        # 16 spill batches.
        self._kv_gc_countdown = 0
        self._prefix: Optional[PrefixCache] = None
        if config.prefix_cache:
            self._prefix = PrefixCache(
                self.allocator, config.page_size,
                config.prefix_cache_pages or config.num_pages // 2,
                host_pool=self._host_kv,
            )
        if self._host_kv is not None and config.kv_state_dir:
            self._reload_state(config, seed, kv_q is not None, logger)

        # Host mirrors of the per-slot state the host decides on (engine
        # thread only), and the device-resident lane state the decode
        # blocks advance.
        self._seq_lens = np.zeros((B,), dtype=np.int32)
        self._caps = np.zeros((B,), dtype=np.int32)
        self._active = np.zeros((B,), dtype=bool)
        self._temperature = np.zeros((B,), dtype=np.float32)
        self._top_p = np.ones((B,), dtype=np.float32)
        self._top_k = np.zeros((B,), dtype=np.int32)
        # Per-lane dial mirrors (spec engines), refreshed from each
        # processed round's stat columns; the device copy is the truth.
        self._lane_ewma = np.ones((B,), dtype=np.float32)
        self._lane_gamma = np.full((B,), max(self._gamma_max, 1), dtype=np.int32)
        dev = self.device
        self._dev = {
            "last_tokens": torch.zeros(B, dtype=torch.int32, device=dev),
            "seq_lens": torch.zeros(B, dtype=torch.int32, device=dev),
            "page_tables": torch.zeros((B, P), dtype=torch.int32, device=dev),
            "active": torch.zeros(B, dtype=torch.bool, device=dev),
            "caps": torch.zeros(B, dtype=torch.int32, device=dev),
            "temperature": torch.zeros(B, dtype=torch.float32, device=dev),
            "top_p": torch.ones(B, dtype=torch.float32, device=dev),
            "top_k": torch.zeros(B, dtype=torch.int32, device=dev),
            "seeds": torch.zeros((B, 2), dtype=torch.int32, device=dev),
        }
        if self._spec:
            self._dev["accept_ewma"] = torch.ones(B, dtype=torch.float32, device=dev)
            self._dev["gamma_lane"] = torch.full((B,), max(self._gamma_max, 1),
                                                 dtype=torch.int32, device=dev)
        self._slots: list[Optional[_Slot]] = [None] * B

        # Block sizes: K, and with the adaptive block max(1, K // 8) for a
        # lone stream.
        K = config.decode_block_steps
        self._block_steps = K
        self._solo_steps = max(1, K // 8) if config.adaptive_block else K
        # Lookahead pipeline: dispatched-but-unprocessed blocks, oldest
        # first. Depth counts the block just dispatched, so depth 2 keeps
        # one block in flight while the next is dispatched and depth 1 is
        # dispatch-then-read. POLYKEY_DISPATCH_LOOKAHEAD overrides the
        # config however it was built (the reference's operator knob).
        self._inflight_q: deque = deque()
        try:
            self._depth = max(1, int(os.environ.get(
                "POLYKEY_DISPATCH_LOOKAHEAD", config.lookahead_blocks)))
        except ValueError:
            self._depth = config.lookahead_blocks
        # In-flight target for the current block size: a K / steps times
        # smaller block deepens the LOOKAHEAD portion by that factor (the
        # same steps queued ahead), capped at 64 blocks and at what the
        # active streams still need; depth 1 stays 1 at every size.
        self._depth_target = self._depth
        self._dispatch_seq = 0

        self._chunk = config.prefill_chunk or max(config.prefill_buckets)
        # Prefill tokens per loop iteration while decode lanes are live,
        # floored at one chunk: the budget bounds a decode stall, it must
        # never wedge a long prompt.
        self._prefill_budget = max(config.prefill_budget or 2 * self._chunk,
                                   self._chunk)
        self._chunk_rr = _RRCursor()
        # Ragged dispatch; POLYKEY_DISABLE_RAGGED=1 falls back to the
        # bucketed paths without a config change.
        self._ragged = config.ragged_dispatch and os.environ.get(
            "POLYKEY_DISABLE_RAGGED", ""
        ).lower() not in ("1", "true")
        # Prefill stream width: the budget, floored at one chunk and padded
        # so the whole stream (B + W rows) is a multiple of TOKEN_TILE. A
        # speculative engine's stream holds B (gamma + 1) verify rows first,
        # so its width is per gamma rung.
        W = max(self._prefill_budget, self._chunk)
        self._ragged_width = W + (-(B + W)) % TOKEN_TILE
        self._ragged_spec_width = {
            g: W + (-(B * (g + 1) + W)) % TOKEN_TILE
            for g in sorted({self._gamma_low, self._gamma_max})
        } if self._spec else {}
        self._ragged_dispatches = 0
        self._ragged_behind = 0      # dispatched with a block in flight
        # Disaggregated handoffs: exports made, imports made, and the recent
        # imports' (host ms, CUDA events around the copy and the splice).
        self._handoff_exports = self._handoff_imported = 0
        self._handoff_imports: deque = deque(maxlen=32)
        # Ragged spec dispatches, and the verify lanes they carried.
        self._ragged_spec_dispatches = self._ragged_spec_lanes = 0

        # CUDA graphs, captured on the engine thread before it serves: one
        # decode block per (greedy, steps), and in bucketed mode one
        # prefill per (width, group pad, greedy, aligned) over the fixed
        # operand buffers of each group pad.
        bodies = {"decode": (self._decode_block, [
            (g, k) for g in (True, False) for k in (K, self._solo_steps)])}
        self._prefill_ops: dict[int, PrefillOperands] = {}
        if not self._ragged:
            keys = prefill_graph_keys(config.prefill_buckets, self._chunk,
                                      config.page_size)
            widest = max(k[0] for k in keys)
            self._prefill_ops = {n: PrefillOperands(n, widest, P, dev)
                                 for n in _GROUP_PADS}
            bodies["prefill"] = (self._prefill_body, keys)
        if self._spec:
            bodies["spec"] = (self._spec_round, spec_graph_keys(
                (self._gamma_low, self._gamma_max), config.top_p_candidates))
        self._graphs = CudaGraphs(self.device, bodies)

        # A context factory the loop enters around each iteration, on the
        # engine thread (graphlint's host-sync guard and pool watch,
        # analysis/graph.py): dispatch modes are per thread. None serving.
        self.loop_guard = None
        self._submit: queue.Queue[GenRequest] = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.dead: Optional[str] = None
        # The watchdog's no-progress clock; only the engine thread stamps
        # it (a submit() reset would let steady traffic hide a hang).
        self.last_progress = time.monotonic()
        # `_fail_all` may run on the supervisor's thread (a wedged engine
        # thread) and on the engine thread once it wakes: one at a time.
        self._fail_lock = threading.Lock()
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="polykey-engine", daemon=True
        )
        self._thread.start()
        # The engine thread captures the graphs first; no other thread may
        # touch the device while it captures. A failed capture raises here.
        self._started.wait()
        if self.dead is not None:
            raise EngineDeadError(self.dead)

    def _reload_state(self, config: EngineConfig, seed: int, quantized: bool,
                      logger) -> None:
        """Reload the pages an earlier engine on the same weights spilled
        (the params_key gate) into the host tier. The store is the leader's
        (or the single-card engine's) alone: it reads and writes whole
        pages. Over a mesh the leader keeps its shard of each reloaded page
        and cuts the rest to every follower's shard
        (lockstep.scatter_pages), each into the same host row."""
        host = self._host_kv
        if not self.is_follower:
            self._kv_state = PrefixStateStore(
                config.kv_state_dir, self.model_cfg.name, config.page_size,
                params_key=self._params_fingerprint(seed), quantized=quantized,
                logger=logger,
            )
        if self.mesh is None:
            mc = self.model_cfg
            self._kv_reloaded_pages = self._kv_state.load_into(
                self._prefix, host,
                expect_shape=(mc.num_layers, 0, config.page_size,
                              mc.num_kv_heads, mc.head_dim),
            )
            return
        rows, wholes, reloaded = None, None, 0
        if not self.is_follower:
            adopted: dict[int, list] = {}

            def keep(page, *arrays):        # a whole page: scattered below
                adopted[page] = [a for a in arrays if a is not None]

            mc = self.model_cfg
            # The pages adopted, as the single-card engine counts them: a
            # row an adoption freed again (an evicted entry) is written
            # once, with its last page.
            reloaded = self._kv_state.load_into(
                self._prefix, host, write=keep,
                expect_shape=(mc.num_layers, 0, config.page_size,
                              mc.num_kv_heads, mc.head_dim),
            )
            rows = sorted(adopted)
            wholes = ([torch.stack([adopted[r][i] for r in rows], dim=1)
                       for i in range(len(host.pools))] if rows else [])
        rows, shards = lockstep.scatter_pages(self.mesh, rows, wholes, host.pools)
        for j, row in enumerate(rows):
            host.write(row, *(t[:, j] for t in shards))
        self._kv_reloaded_pages = len(rows) if self.is_follower else reloaded

    def _serving_mesh(self, config: EngineConfig, mesh):
        """The mesh this engine serves over, or None for the single-card
        engine (no group up, no mesh passed). Checks the reference's
        geometry in its order (the draft's last) before any group is made,
        and checks that a mesh passed in is the config's."""
        import torch.distributed as dist

        group_up = dist.is_available() and dist.is_initialized()
        n = (config.tp * config.dp * config.ep * config.sp * config.pp
             * config.num_slices)
        have = (int(mesh.devices.size) if mesh is not None
                else dist.get_world_size() if group_up else 1)
        if n > have:
            raise ValueError(
                f"tp={config.tp} x dp={config.dp} x ep={config.ep} x "
                f"sp={config.sp} x pp={config.pp} x slices={config.num_slices} "
                f"needs {n} devices, have {have}"
            )
        mc = self.model_cfg
        if mc.num_kv_heads % config.tp != 0:
            raise ValueError(
                f"tp={config.tp} must divide num_kv_heads={mc.num_kv_heads} ({mc.name})"
            )
        total_dp = config.dp * config.num_slices
        if config.max_decode_slots % total_dp != 0:
            raise ValueError(
                f"dp={config.dp} x num_slices={config.num_slices} must divide "
                f"max_decode_slots={config.max_decode_slots}"
            )
        if config.ep > 1:
            if not mc.is_moe:
                raise ValueError(
                    f"ep={config.ep} requires an MoE model ({mc.name} has no experts)"
                )
            if mc.num_experts % config.ep != 0:
                raise ValueError(
                    f"ep={config.ep} must divide num_experts={mc.num_experts}"
                )
        if mc.num_layers % config.pp != 0:
            raise ValueError(
                f"pp={config.pp} must divide num_layers={mc.num_layers}"
            )
        if config.draft_model is not None:
            dc = get_config(config.draft_model)
            if dc.num_kv_heads % config.tp != 0:
                raise ValueError(
                    f"tp={config.tp} must divide draft num_kv_heads={dc.num_kv_heads}"
                )
            if dc.num_layers % config.pp != 0:
                raise ValueError(
                    f"pp={config.pp} must divide draft num_layers={dc.num_layers} (the "
                    "draft's params and page pool shard the same pp axis)"
                )
        if mesh is None and not group_up:
            return None
        if mesh is None:
            if n != have:
                raise ValueError(
                    f"the mesh spans {n} processes but the group has {have}: "
                    "serving runs one process per card, every one in the mesh"
                )
            mesh = lockstep.serving_mesh(config, device=self.device)
        want = {"dp": total_dp, "pp": config.pp, "sp": config.sp, "ep": config.ep,
                "tp": config.tp}
        if mesh.shape != want:
            raise ValueError(f"mesh {mesh.shape} is not the config's {want}")
        if mesh.control is None:
            raise ValueError("a serving mesh needs its control group "
                             "(engine/lockstep.serving_mesh)")
        return mesh

    def rebuild(self, mesh=None) -> "InferenceEngine":
        """The engine a supervised restart builds in place of this one (its
        device state released first, or this engine kept as an orphan): the
        same config, device, health and logger, on this engine's weights
        (`reuse`), over `mesh` (default this engine's). Over a mesh every
        rank builds it at the leader's word on the mesh's next life
        (lockstep.remake), so their captures issue the same collectives in
        the same order, each new communicator warmed by the capture's eager
        run first (engine/lockstep.py)."""
        fresh = InferenceEngine(self.config, device=self.device, health=self.health,
                                logger=self.logger, reuse=self._ctor_args,
                                mesh=self.mesh if mesh is None else mesh)
        fresh.mesh_restart = self.mesh_restart
        return fresh

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the engine thread to end (on a follower, the leader's
        shutdown record or a failure ends it); True once it has."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- public API (any thread) -------------------------------------------

    def submit(self, request: GenRequest) -> None:
        if self.is_follower:
            raise EngineDeadError("a follower rank of the mesh takes no requests: "
                                  "its leader (the mesh's first rank) serves them")
        if self.dead is not None:
            raise EngineDeadError(self.dead)
        if self._stop.is_set():
            raise EngineDeadError("engine is shut down")
        # Bounded admission: over-limit submissions fail in O(1) with a
        # retry hint instead of queueing into unbounded latency.
        limit = self.config.max_queue_depth
        if limit > 0 and self._submit.qsize() >= limit:
            self.metrics.on_shed()
            raise EngineOverloadedError(
                f"submit queue full ({limit} waiting)",
                retry_after_ms=self._retry_after_ms(),
            )
        if request.deadline is not None:
            # Deadline-aware admission: if the estimated queue delay
            # already blows the request's budget, shed now rather than
            # burn a slot on work the client will throw away. The estimate
            # is 0 until the first completed request (cold engines never
            # shed on it).
            est = self.queue_delay_estimate_s()
            if est > 0.0 and time.monotonic() + est >= request.deadline:
                self.metrics.on_shed()
                raise EngineOverloadedError(
                    f"estimated queue delay {est:.2f}s exceeds request "
                    "deadline",
                    retry_after_ms=self._retry_after_ms(),
                )
        self.metrics.on_admit()
        self._submit.put(request)
        self._wake.set()
        if self.dead is not None or self._stop.is_set():
            self._fail_pending(self.dead or "engine is shut down")

    def queue_delay_estimate_s(self) -> float:
        """Expected wait before a newly queued request is admitted: with S
        slots draining in parallel and an EWMA per-request service time,
        the queue drains at roughly S requests per EWMA. The deadline-aware
        admission sheds on it and the replica pool routes on it."""
        ewma = self.metrics.service_time_ewma_s()
        if ewma <= 0.0:
            return 0.0
        slots = max(1, self.config.max_decode_slots)
        return self._submit.qsize() * ewma / slots

    def load_fraction(self) -> float:
        """Instantaneous load for routing: (busy slots + queued) over
        slots. The delay estimate is 0 until a first request completes, so
        this term spreads a cold pool's concurrent traffic."""
        slots = max(1, self.config.max_decode_slots)
        busy = sum(s is not None for s in self._slots)
        return (busy + self._submit.qsize()) / slots

    def _retry_after_ms(self) -> int:
        """Shed hint: about one slot-drain interval, floored at 50 ms so
        clients never busy-spin, 100 ms on a cold engine."""
        ewma = self.metrics.service_time_ewma_s()
        if ewma <= 0.0:
            return 100
        slots = max(1, self.config.max_decode_slots)
        return max(50, int(1000.0 * ewma / slots))

    def stats(self) -> dict:
        """A snapshot of host state only (counters, host mirrors, queue
        sizes): no device read, no event wait, so the watchdog may call
        it while the engine thread is wedged in a device call."""
        snap = self.metrics.snapshot()
        snap.update({
            "model": self.model_cfg.name,
            "replica": self.replica_id,
            "device": str(self.device),
            "slots_busy": sum(s is not None for s in self._slots),
            "slots_total": self.config.max_decode_slots,
            "pages_free": self.allocator.num_free,
            "pages_total": self.config.num_pages,
            "queued": self._submit.qsize(),
            "inflight_blocks": len(self._inflight_q),
            "lookahead_depth": self._depth,
            "lookahead_target": self._depth_target,
            "decode_graph_captures": self._graphs.captures["decode"],
            "decode_graph_replays": self._graphs.replays["decode"],
            "prefill_graph_captures": self._graphs.captures["prefill"],
            "prefill_graph_replays": self._graphs.replays["prefill"],
            "prefill_eager": self._graphs.eager_calls("prefill"),
            "graph_pool_bytes": self._graphs.pool_bytes,
            "graph_capture_s": round(self._graphs.capture_seconds, 3),
            "graph_pool_bytes_by_body": dict(self._graphs.pool_bytes_after),
            "first_tokens_pending": sum(
                s is not None and s.first is not None for s in self._slots),
            "prefill_budget": self._prefill_budget,
            "ragged": self._ragged,
            "kv_dtype": self._kv_dtype_name,
            "kv_pool_bytes": self._kv_pool_bytes,
            "weight_bytes": self._weight_bytes,
            "quantize": self.config.quantize,
            "quantize_bits": self.config.quantize_bits,
            "kernel_launches": {
                name: k.launches for name, k in KERNELS.items()
            },
        })
        if self.mesh is not None:
            snap["mesh"] = self._mesh_stats()
        if self._tier is not None:
            snap["disagg_tier"] = self._tier
            snap["handoff_exports"] = self._handoff_exports
            snap["handoff_imports"] = self._handoff_imported
            snap["handoff_import_ms"] = self._handoff_import_ms()
        signals = self.metrics.signals
        if signals is not None:
            # Windowed quantiles beside the lifetime ones (ttft_ms_p95_5m
            # and the like cover the last minutes, not the uptime).
            snap.update(signals.stats_fields())
        if self._spec:
            snap.update(self._spec_stats())
        if self._ragged:
            snap["ragged_width"] = self._ragged_width
            snap["ragged_dispatches"] = self._ragged_dispatches
            snap["ragged_behind_inflight"] = self._ragged_behind
            if self._spec:
                snap["ragged_spec_width"] = dict(self._ragged_spec_width)
                snap["ragged_spec_dispatches"] = self._ragged_spec_dispatches
                snap["ragged_spec_verify_lanes"] = self._ragged_spec_lanes
        if self._prefix is not None:
            snap.update(self._prefix.stats())
        # The host tier's fields are always present (0 without a tier).
        host = self._host_kv
        snap["host_kv"] = host is not None
        snap["kv_host_pages"] = host.used if host is not None else 0
        snap["kv_host_capacity"] = host.capacity if host is not None else 0
        # Device pages held by slots and the cache (page 0 excluded).
        snap["kv_device_pages"] = self.config.num_pages - 1 - self.allocator.num_free
        snap["kv_reloaded_pages"] = self._kv_reloaded_pages
        return snap

    def _mesh_stats(self) -> dict:
        """The mesh this engine serves over and this rank's place in it;
        `kv_pool_bytes` beside it is this rank's shard of the pools."""
        leader = self._leader
        out = {
            "axes": dict(self.mesh.shape),
            "rank": self.mesh.rank,
            "world": lockstep.world(self.mesh),
            "role": "follower" if self.is_follower else "leader",
        }
        if leader is not None:
            out["records_sent"] = leader.records
            out["records_by_kind"] = dict(leader.by_kind)
            out["record_messages"] = leader.messages
            out["heartbeats"] = leader.heartbeats
        if self.is_follower:
            out["records_replayed"] = dict(self.replayed)
        if self._digest is not None:
            out["decode_blocks_hashed"] = self._digest.blocks
            out["tokens_digest"] = self._digest.hexdigest
        return out

    def _spec_stats(self) -> dict:
        """The reference's spec keys: the dispatch rung and its cap, the
        per-lane dials and EWMAs over occupied lanes (mean, min, max), the
        batch-aggregate EWMA, and the round graphs' captures and replays."""
        out = {
            "spec_gamma": self._gamma,
            "spec_gamma_cap": self._gamma_cap,
            "spec_accept_ewma": round(self._accept_ewma, 4),
            "spec_graph_captures": self._graphs.captures["spec"],
            "spec_graph_replays": self._graphs.replays["spec"],
            "spec_eager": self._graphs.eager_calls("spec"),
            "spec_rounds": self._spec_rounds,
            "spec_lane_rounds": self._spec_lane_rounds,
            "spec_tokens": self._spec_tokens,
            "draft_kv_pool_bytes": self._draft_kv_pool_bytes,
        }
        occ = [i for i, s in enumerate(self._slots) if s is not None]
        if occ:
            dials, ewmas = self._lane_gamma[occ], self._lane_ewma[occ]
            out.update({
                "spec_gamma_mean": round(float(dials.mean()), 4),
                "spec_gamma_min": int(dials.min()),
                "spec_gamma_max": int(dials.max()),
                "spec_accept_ewma_mean": round(float(ewmas.mean()), 4),
                "spec_accept_ewma_min": round(float(ewmas.min()), 4),
                "spec_accept_ewma_max": round(float(ewmas.max()), 4),
            })
        else:
            out.update({
                "spec_gamma_mean": float(self._gamma), "spec_gamma_min": self._gamma,
                "spec_gamma_max": self._gamma, "spec_accept_ewma_mean": 1.0,
                "spec_accept_ewma_min": 1.0, "spec_accept_ewma_max": 1.0,
            })
        return out

    def set_spec_gamma(self, gamma: int) -> int:
        """Upper bound on the speculative dispatch width, snapped to a
        ladder rung (each rung is its own graph): gamma_max if `gamma`
        reaches it, else gamma_low. Lane dials keep adapting under it, so
        lifting the cap restores the full rung within one round. Returns
        the cap applied, 0 on a plain engine."""
        if not self._spec:
            return 0
        self._gamma_cap = self._gamma_max if int(gamma) >= self._gamma_max else self._gamma_low
        # polylint: disable=CL002(a GIL-atomic int publish; the engine thread recomputes the rung under the new cap at its next round, so a stale read costs one round at the old rung)
        self._gamma = min(self._gamma, self._gamma_cap)
        return self._gamma_cap

    def prefix_warmth(self, ids) -> float:
        """Fraction [0, 1] of the token ids `ids` whose KV this engine could
        serve from its prefix cache, the routers' warmth signal. Read-only
        (no retain, no LRU refresh, no hit accounting). Host-resident pages
        count as warm at weight 0.5. 0.0 with the cache off or no ids."""
        if self._prefix is None or len(ids) == 0:
            return 0.0
        dev, host = self._prefix.probe_tiered(np.asarray(ids, dtype=np.int32))
        return (dev + _HOST_WARMTH_WEIGHT * host) / len(ids)

    def set_kv_restore_slots(self, slots: int) -> int:
        """Faulting slots whose restore may be issued per loop iteration
        (POLYKEY_KV_RESTORE_SLOTS), clamped to 1..max_decode_slots; returns
        the value applied."""
        self._restore_slots = max(1, min(int(slots), self.config.max_decode_slots))
        return self._restore_slots

    def set_lookahead(self, depth: int) -> int:
        """Pipeline depth (POLYKEY_DISPATCH_LOOKAHEAD), clamped to 1..64;
        the next dispatch's in-flight target follows it. Returns the value
        applied."""
        self._depth = max(1, min(64, int(depth)))
        return self._depth

    def set_prefill_budget(self, tokens: int) -> int:
        """Interleaved-prefill token budget per loop iteration, floored at
        one chunk and, in ragged mode, capped at the stream width; returns
        the value applied."""
        tokens = max(int(tokens), self._chunk)
        if self._ragged:
            tokens = min(tokens, self._ragged_width)
        self._prefill_budget = tokens
        return tokens

    def set_resident_floor(self, pages: int) -> int:
        """Host-KV resident floor (POLYKEY_KV_RESIDENT_PAGES): `_finish`
        spills cold pages while a retirement leaves fewer free device
        pages than this. Clamped to 0..num_pages; returns the value
        applied."""
        self._resident_low = max(0, min(int(pages), self.config.num_pages))
        return self._resident_low

    def knob_setpoints(self) -> dict:
        """The live value of every knob the autopilot actuates: what the
        loop reads on its next iteration, not what the config said."""
        out = {
            "lookahead": self._depth,
            "prefill_budget": self._prefill_budget,
        }
        if self._host_kv is not None:
            out["restore_slots"] = self._restore_slots
            out["resident_floor"] = self._resident_low
        if self._spec:
            out["spec_gamma"] = self._gamma_cap
        return out

    @property
    def busy(self) -> bool:
        return (
            bool(self._active.any())
            or not self._submit.empty()
            or any(s is not None for s in self._slots)
        )

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)

    def release_device_state(self) -> None:
        """Free this dead engine's device state before a replacement
        allocates its own: the KV pools, the CUDA graphs and their pool,
        the lane-state buffers, the pinned prefill operands and in-flight
        copies, and the host tier. The weights stay (`_ctor_args`), for
        the replacement to serve. Explicit, not left to the cycle
        collector: `CudaGraphs.capture` holds the collector off, and the
        engine's graphs and bound bodies form a cycle. Only once the
        engine thread has exited, since nothing here may race it, and while
        no other engine captures; stats() keeps working on host values."""
        if self._thread.is_alive():
            raise RuntimeError("the engine thread is still running")
        self._inflight_q.clear()
        self._slots = [None] * len(self._slots)
        self._graphs.release()
        self.paged = None
        self.d_paged = None
        self._dev = {}
        self._prefill_ops = {}
        self._prefix = None
        self._host_kv = None
        if self.device.type == "cuda":
            # Back to the card, not only to PyTorch's cache: the graph
            # pool's blocks are reused by no one else. Not while another
            # engine captures (a replica pool's other engines may).
            with CAPTURE_LOCK:
                torch.cuda.empty_cache()

    def _params_fingerprint(self, seed: int) -> str:
        """Fingerprint of what decides KV content, the gate on durable
        reloads. The basis is the reference's, so a state dir written on
        explicit weights warms either package's engine on those weights.
        Weights made from a seed here come from a torch.Generator, not
        jax.random: the same seed gives other weights, so that basis adds
        a term of its own and never matches the reference's."""
        cfg = self.config
        derived = not (self._params_explicit or cfg.checkpoint_path)
        basis = (
            cfg.model, cfg.dtype, cfg.kv_dtype, cfg.quantize, cfg.quantize_bits,
            cfg.checkpoint_path or "", seed if derived else -1,
            self._params_explicit, cfg.page_size,
        ) + (("torch-init",) if derived else ())
        return hashlib.blake2b(repr(basis).encode(), digest_size=8).hexdigest()

    # -- engine thread ------------------------------------------------------

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                self._graphs.capture()
                # A graph's first launch costs about one decode block; pay
                # it here, not in the first requests' TTFT.
                self._graphs.warm()
                self.last_progress = time.monotonic()
                self._started.set()
                if self.is_follower:
                    # Until the leader's "shutdown" or "restart" record, or
                    # until a new life stops this one (lockstep.follow_lives).
                    self.restart_requested = lockstep.follow(self) == "restart"
                else:
                    self._serve()
                if self._digest is not None:
                    self._digest.drain(block=True)
            # A dead engine fails its work on the host alone (`_finish`
            # retires no lane once `dead` is set).
            self._fail_all(self.dead or "engine is shut down")
        except Exception as e:  # engine thread must never die silently
            self.dead = f"engine loop crashed: {e}"
            if self.logger is not None:
                self.logger.error(
                    "engine loop crashed", error=str(e),
                    traceback=traceback.format_exc(),
                )
            self._fail_all(self.dead)
            # An engine already stopped (replaced by the supervisor) must
            # not flip the health its replacement serves under.
            if self.health is not None and not self._stop.is_set():
                self.health.shutdown()
        finally:
            if self._leader is not None:
                # The followers stop with the leader; when this engine failed
                # and its supervisor rebuilds the mesh they end their threads
                # on "restart" and wait for its word (lockstep.follow_lives).
                # Inside a dispatch they cannot hear a record, and the word
                # reaches them through the store alone. An orphan that wakes
                # sends on its own life's control group only.
                restart = self.mesh_restart and self.dead is not None
                if not (restart and self._leader.open):
                    sent = self._leader.close("restart" if restart else "shutdown")
                    if self.closed_with is None:
                        self.closed_with = sent
            self._started.set()     # also when the capture failed

    def _serve(self) -> None:
        """The engine loop (the leader's, over a mesh): one iteration at a
        time, each inside `loop_guard()` when it is set."""
        while not self._stop.is_set():
            guard = self.loop_guard
            with guard() if guard is not None else _NO_GUARD:
                go_on = self._serve_once()
            if not go_on:
                break

    def _serve_once(self) -> bool:
        """One loop iteration; False when the engine died or stopped in it."""
        if self.dead is not None:
            return False    # the watchdog tripped while we were out
        # With live decode lanes, admissions and chunks share
        # the per-iteration prefill budget; with none there is
        # no stream to stall and the budget is waived.
        decode_live = bool(self._active.any())
        budget = self._prefill_budget if decode_live else None
        worked, spent = self._admit(budget)
        if self.dead is not None:
            return False    # tripped while this iteration ran
        # Restore frontier: faulting slots' host pages go back
        # to the device ahead of this iteration's dispatches.
        if self._host_kv is not None and self._issue_restores():
            worked = True
        if not self._ragged:
            remaining = None if budget is None else max(0, budget - spent)
            chunked = self._advance_chunked_prefills(remaining)
            worked = worked or chunked > 0
            self.metrics.on_prefill_interleave(spent + chunked, decode_live)
        if self.dead is not None:
            return False
        # Dispatch frontier: keep up to `_depth_target` blocks
        # in flight, the one dispatched now included.
        dispatched = False
        if self._active.any() or (
            self._ragged and self._has_pending_prefill()
        ):
            block = self._dispatch_step()
            if self.dead is not None or self._stop.is_set():
                # Woke from a fault's sleep into a dead or
                # stopped engine: touch the device no more.
                return False
            worked = True
            if block is not None:
                self._inflight_q.append(block)
                dispatched = True
            del block
        # First tokens whose copies have landed, after the
        # dispatch: the prefill's device time overlaps the
        # block's, and its read never blocks the loop.
        self._resolve_prefills()
        # Processed frontier: process down to `_depth_target -
        # 1` queued blocks, and any older block whose copy has
        # landed, but keep the freshest in flight at depth > 1:
        # block N is read after block N + 1 is dispatched.
        # Iterations that dispatched nothing drain it all.
        target = max(0, self._depth_target - 1) if dispatched else 0
        floor = 1 if (dispatched and self._depth > 1) else 0
        while self._inflight_q and (
            len(self._inflight_q) > target
            or (len(self._inflight_q) > floor
                and self._block_ready(self._inflight_q[0]))
        ):
            self._process_step(self._inflight_q.popleft())
            worked = True
        if self._digest is not None:
            self._digest.drain()
        # A signal-plane sample at the block boundary (idle
        # iterations reach here too, at the idle tick's rate):
        # time-gated, host counters only, never a device read.
        signals = self.metrics.signals
        if signals is not None:
            signals.maybe_sample()
        if not worked:
            self.metrics.on_dispatch_idle()
            self._resolve_prefills(block=True)
            if self._leader is not None:
                self._leader.heartbeat()
            self._wake.wait(timeout=0.05)
            self._wake.clear()
        # Idle time is not a stall: both kinds of iteration
        # stamp the watchdog's clock.
        self.last_progress = time.monotonic()
        return True

    def _bucket_for(self, length: int) -> Optional[int]:
        for b in self.config.prefill_buckets:
            if length <= b:
                return b
        return None

    @staticmethod
    def _deadline_expired(request: GenRequest) -> bool:
        return request.deadline is not None and time.monotonic() >= request.deadline

    @staticmethod
    def _trace_id_of(request: Optional[GenRequest]) -> Optional[str]:
        if request is None or request.trace is None:
            return None
        return request.trace.trace_id

    def _fail_request(self, request: GenRequest, message: str) -> None:
        request.out.put(("error", message))
        self.metrics.on_finish(request.timings, failed=True,
                               trace_id=self._trace_id_of(request))

    def _expire(self, request: GenRequest, phase: str) -> None:
        """Fail an expired request that holds no slot (slot-holding
        expiries go through _finish)."""
        self.metrics.on_deadline_expired(phase)
        if self.timeline is not None:
            self.timeline.expire(phase, self._trace_id_of(request))
        self._fail_request(request, f"{DEADLINE_MSG} while {phase}")

    def _admit(self, budget: Optional[int] = None) -> tuple[bool, int]:
        """Admit waiting requests into free slots; prefill short prompts
        in per-bucket groups, register long ones (and, in ragged mode,
        every one) as pending. Each grouped admission charges its bucket
        width against `budget` (None: unbounded); once it is spent the
        rest of the queue waits for the next iteration. Returns (whether
        any request was taken, tokens charged)."""
        admitted = False
        spent = 0
        groups: dict[int, list] = {}
        try:
            while budget is None or spent < budget:
                free = [i for i, s in enumerate(self._slots) if s is None]
                if not free:
                    return admitted, spent
                try:
                    request = self._submit.get_nowait()
                except queue.Empty:
                    return admitted, spent
                admitted = True
                if request.cancelled.is_set():
                    continue
                if self._deadline_expired(request):
                    # Dropped at dequeue: never tokenized, never on the card.
                    self._expire(request, "queued")
                    continue
                try:
                    prep = self._prepare_request(free[0], request)
                except (AllocationError, EngineDeadError):
                    # Pool exhausted: back to the front of the queue until
                    # running requests release pages (FIFO fairness). A
                    # resume that found the engine dead waits there too:
                    # the loop fails the queue with the engine's message.
                    self._requeue_front(request)
                    return admitted, spent
                except Exception as e:
                    # A request that cannot be admitted (a failed
                    # tokenization) fails alone; the engine serves on.
                    self._fail_request(request, f"admission failed: {e}")
                    continue
                slot = self._slots[free[0]]
                if (self.timeline is not None and slot is not None
                        and slot.request is request):
                    self.timeline.admit(free[0], self._trace_id_of(request),
                                        request.timings.prompt_tokens)
                if prep is None:
                    continue
                bucket = prep[0]
                spent += bucket
                groups.setdefault(bucket, []).append(prep[1])
                if len(groups[bucket]) >= _MAX_PREFILL_GROUP:
                    self._dispatch_prefill_group(bucket, groups.pop(bucket))
            return admitted, spent
        finally:
            for bucket, group in groups.items():
                self._dispatch_prefill_group(bucket, group)

    def _requeue_front(self, request: GenRequest) -> None:
        items = [request]
        try:
            while True:
                items.append(self._submit.get_nowait())
        except queue.Empty:
            pass
        for item in items:
            self._submit.put(item)

    def _prepare_request(self, slot_idx: int, request: GenRequest):
        """Tokenize, budget, match the prefix cache, allocate pages and
        register the slot; returns (bucket, slot_idx) for a prompt (or a
        cache hit's suffix) the caller prefills in a group, or None for one
        registered as pending (chunked prefill, any prompt in ragged mode,
        a slot faulting on host pages) or failed here. AllocationError: the
        pool is full (the match is undone)."""
        cfg = self.config
        if request.resume_state is not None:
            # Decode-tier resume: the prompt's KV arrives with the request;
            # nothing tokenizes or prefills here.
            return self._admit_resume(slot_idx, request)
        request.timings.prefill_start = time.monotonic()
        if self._faults is not None:
            self._faults.maybe_raise("tokenizer-error", replica=self.replica_id,
                                     tier=self._tier)
        prompt_ids = self.tokenizer.encode(request.prompt)
        # A speculative engine leaves gamma_max positions of slack, so the
        # last verify window's overdraft lands in the request's own pages.
        slack = self._gamma_max
        max_new = max(
            1, min(request.max_new_tokens, cfg.max_new_tokens_cap,
                   cfg.max_seq_len - 1 - slack),
        )
        max_prompt = cfg.max_seq_len - max_new - slack
        if len(prompt_ids) > max_prompt:
            prompt_ids = prompt_ids[-max_prompt:]      # keep the prompt tail
        prompt_len = len(prompt_ids)
        request.timings.prompt_tokens = prompt_len
        total_len = prompt_len + max_new
        ids = np.asarray(prompt_ids, dtype=np.int32)

        # Prefix cache: the cached page-aligned prefix as a chain of (key,
        # tier, page); device pages are retained for this slot. With the
        # host tier, host entries are page faults: each takes a fresh
        # device page here and is detached to this request before anything
        # allocates (a spill into a full host tier drops LRU host entries,
        # never one this restore needs); the restore frontier copies it in.
        chain: list = []
        if self._prefix is not None:
            chain = self._fit_window(self._prefix.lookup_chain(ids)[0], prompt_len)
        restore_items = [(key, self._prefix.detach_host(key), ci)
                         for ci, (key, tier, _) in enumerate(chain) if tier == TIER_HOST]
        need = -(-(total_len + slack) // cfg.page_size) - (len(chain) - len(restore_items))
        try:
            if self._faults is not None:
                # Inside the try: the undo below must still give back the
                # prefix lookup's pages.
                self._faults.maybe_raise("alloc-fail", AllocationError,
                                         replica=self.replica_id, tier=self._tier)
            try:
                fresh = self.allocator.alloc(need)
            except AllocationError:
                if self._prefix is None:
                    raise
                # Pressure: offload cold cache pages to the host tier if
                # there is one, drop them if not (or not enough), retry.
                if self._host_kv is not None:
                    self._spill_for(need)
                if self.allocator.num_free < need:
                    self._prefix.evict_for(need)
                fresh = self.allocator.alloc(need)
        except AllocationError:
            self._undo_match(chain, restore_items)
            raise
        except Exception as e:
            # A failed spill ends this request, never the engine.
            self._undo_match(chain, restore_items)
            self._fail_request(request, f"kv spill failed: {e}")
            return None
        # The table in chain order: device hits keep their shared pages,
        # faults take fresh pages that the restore fills.
        fresh_iter = iter(fresh)
        pages = [page if tier == TIER_DEVICE else next(fresh_iter)
                 for _, tier, page in chain]
        pages += list(fresh_iter)
        if request.trace is not None:
            # Only after the allocation succeeded: a requeued request comes
            # back here, and its tree holds one queue_wait over the whole
            # wait.
            request.trace.child("queue_wait", start=request.timings.enqueued,
                                end=request.timings.prefill_start)
        table = np.zeros((cfg.pages_per_seq,), dtype=np.int32)
        table[: len(pages)] = pages
        seed = request.seed
        if seed is None:
            seed = int(self._seed_rng.integers(0, 1 << 63))
        s = seed & 0xFFFFFFFFFFFFFFFF
        seed_row = np.array(
            [(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], np.uint32
        ).view(np.int32)
        slot = _Slot(
            request=request, pages=pages, table=table, seed_row=seed_row,
            prompt_len=prompt_len, position_cap=total_len,
            filled=len(chain) * cfg.page_size,
            cache_ids=ids if self._prefix is not None else None,
            handoff_ids=ids if request.prefill_only else None,
        )
        self._slots[slot_idx] = slot
        if restore_items:
            # Faulting: the whole prompt pending from the chain's end; it
            # joins no prefill until its restore is issued, so resident
            # admissions dispatch ahead of it.
            slot.restore_pages = restore_items
            kind = "ctx" if prompt_len > max(cfg.prefill_buckets) else "prefix"
            self.metrics.on_kv_fault(kind, len(restore_items))
            slot.pending = ids
            return None
        bucket = self._bucket_for(prompt_len - slot.filled)
        if self._ragged or bucket is None:
            # Ragged mode: every prompt is token ranges of the next ragged
            # dispatches, from the cached offset. Bucketed mode: a prompt
            # (or suffix) past the largest bucket prefills one chunk per
            # iteration from it. Either way the slot's table stays off the
            # device until its lane merges, so decode blocks keep writing
            # this lane's garbage to page 0.
            slot.pending = ids
            return None
        slot.prompt_ids = ids[slot.filled:]
        return bucket, slot_idx

    def _fit_window(self, chain: list, prompt_len: int) -> list:
        """Bucketed mode: drop matched pages from the end of `chain` until
        the suffix's padded prefill window (its bucket, or whole chunks
        from the cached offset, which a faulting slot always takes) ends
        within max_seq_len. A position past the page table clamps onto the
        slot's last page, so a padded row there would write over the
        suffix's own KV in the same launch. Without a hit no window runs
        past: buckets start at 0, chunks at multiples of the chunk. Dropped
        device pages are released and their hit accounting taken back.
        A speculative engine's slack needs no term here: the verify windows
        run to at most prompt_len + max_new + gamma_max <= max_seq_len
        (`_prepare_request`), inside the table, and the prefill window's
        bound is the table's end either way."""
        if self._ragged:
            return chain
        ps, C = self.config.page_size, self._chunk
        while chain:
            filled = len(chain) * ps
            n = prompt_len - filled
            faulting = any(tier == TIER_HOST for _, tier, _ in chain)
            bucket = None if faulting else self._bucket_for(n)
            width = bucket if bucket is not None else -(-n // C) * C
            if filled + width <= self.config.max_seq_len:
                break
            _, tier, page = chain.pop()
            if tier == TIER_DEVICE:
                self.allocator.release(page)
                self._prefix.hit_tokens -= ps
            else:
                self._prefix.host_hit_tokens -= ps
        return chain

    def _undo_match(self, chain: list, restore_items: list) -> None:
        """Give back an admission's match: the chain's device retains, and
        its detached host pages to the cache (warmth survives a requeue; a
        key cached meanwhile keeps its copy and ours frees)."""
        if self._prefix is None:
            return
        self._prefix.release_chain(chain)
        for key, host_page, _ci in restore_items:
            if not self._prefix.adopt_host(key, host_page):
                self._host_kv.release(host_page)

    def _run_prefill(self, rows: list, width: int, n_pad: int):
        """One _prefill_fn dispatch of `n_pad` windows of `width` tokens;
        `rows` holds (slot, ids, start) for the real ones, the rest point
        at the garbage page. The operands go up into the group pad's fixed
        buffers and the prefill graph of (width, n_pad, greedy, aligned)
        replays (on the CPU the body runs). Returns the sampled tokens
        [n_pad] and the page tables [n_pad, P] and seeds [n_pad, 2] the
        dispatch read, all on the device."""
        cfg = self.config
        tokens = np.zeros((n_pad, width), dtype=np.int32)
        starts = np.zeros((n_pad,), dtype=np.int32)
        last_rel = np.zeros((n_pad,), dtype=np.int32)
        tables = np.zeros((n_pad, cfg.pages_per_seq), dtype=np.int32)
        temp = np.zeros((n_pad,), dtype=np.float32)
        top_p = np.ones((n_pad,), dtype=np.float32)
        top_k = np.zeros((n_pad,), dtype=np.int32)
        seeds = np.zeros((n_pad, 2), dtype=np.int32)
        for r, (slot, ids, start) in enumerate(rows):
            tokens[r, : len(ids)] = ids
            starts[r] = start
            last_rel[r] = len(ids) - 1
            tables[r] = slot.table
            temp[r] = slot.request.temperature
            top_p[r] = slot.request.top_p
            top_k[r] = self._eff_top_k(slot.request)
            seeds[r] = slot.seed_row
        ps = cfg.page_size
        args = (width, n_pad, bool(np.all(temp == 0.0)),
                width % ps == 0 and not np.any(starts % ps),
                (tokens, starts, last_rel, tables, seeds, temp, top_p, top_k))
        if self._leader is None:
            self._prefill_fault()
            return self._prefill_dispatch(*args)
        try:
            with lockstep.dispatch(self._leader, lockstep.Record("prefill", args)):
                self._prefill_fault()
                return self._prefill_dispatch(*args)
        except Exception as e:
            raise LockstepError(f"mesh prefill failed: {e}") from e

    def _prefill_fault(self) -> None:
        """The prefill-error point, a device failure of the prefill dispatch:
        over a mesh it fires inside the dispatch, its record sent, where a
        device failure leaves the followers in its collectives."""
        if self._faults is not None:
            self._faults.maybe_raise("prefill-error", replica=self.replica_id,
                                     tier=self._tier)

    def _prefill_dispatch(self, width: int, n_pad: int, greedy: bool, aligned: bool,
                          arrays: tuple):
        """Upload a prefill's operand `arrays` (`PrefillOperands.upload`'s
        order) into the group pad's fixed buffers and replay the graph of
        (width, n_pad, greedy, aligned); a follower replays a prefill
        record here. Returns (and keeps, for the merges after it) the
        sampled tokens and the device tables and seeds the dispatch read."""
        ops = self._prefill_ops[n_pad]
        with _host_crossing("merge-upload"):
            ops.upload(*arrays)
        toks_dev = self._graphs.run("prefill", width, n_pad, greedy, aligned)
        _, _, _, tables_dev, seeds_dev, *_ = ops.views(width)
        self._last_prefill = (toks_dev, tables_dev, seeds_dev)
        return self._last_prefill

    def _prefill_body(self, width: int, n_pad: int, greedy: bool,
                      aligned: bool) -> torch.Tensor:
        """The body the prefill graphs capture: `_prefill_fn` over the
        engine's weights, pools and the group pad's operand buffers. It
        touches no lane state. A speculative engine fills the draft's pools
        in the same body (`spec_prefill_fn`)."""
        ops = self._prefill_ops[n_pad].views(width)
        cand = self.config.top_p_candidates
        if self._spec:
            token, self.paged, self.d_paged = spec_prefill_fn(
                self.params, self.draft_params, self.model_cfg, self.draft_cfg,
                self.paged, self.d_paged, *ops, greedy=greedy, candidates=cand,
                aligned=aligned, mesh=self.mesh,
            )
            return token
        token, self.paged = _prefill_fn(
            self.params, self.model_cfg, self.paged, *ops, greedy=greedy,
            aligned=aligned, candidates=cand, mesh=self.mesh,
        )
        return token

    def _dispatch_prefill_group(self, bucket: int, group: list) -> None:
        """One prefill dispatch for up to 8 same-bucket admissions, padded
        to 1, 2, 4 or 8 rows; padded rows use the garbage page. Each lane
        merges on the device; its first token is delivered later
        (`_resolve_prefills`)."""
        if self.dead is not None:
            # Tripped while admitting: a dead engine launches nothing.
            for slot_idx in group:
                self._finish(slot_idx, error=self.dead)
            return
        n = len(group)
        n_pad = next(p for p in _GROUP_PADS if p >= n)
        rows = []
        for slot_idx in group:
            slot = self._slots[slot_idx]
            rows.append((slot, slot.prompt_ids, slot.filled))   # > 0: a cache hit's suffix
            slot.prompt_ids = None
        try:
            toks_dev, tables, seeds = self._run_prefill(rows, bucket, n_pad)
        except LockstepError as e:
            for slot_idx in group:
                self._finish(slot_idx, error=str(e))
            raise
        except Exception as e:
            # Contain the failure to this group: every member is registered
            # and must be finished, or its pages leak and its client hangs.
            for slot_idx in group:
                self._finish(slot_idx, error=f"prefill failed: {e}")
            return
        self.metrics.on_padding_tokens(n_pad * bucket, sum(len(ids) for _, ids, _ in rows))
        for r, slot_idx in enumerate(group):
            if self.timeline is not None:
                self.timeline.prefill(slot_idx, bucket, True)
            self._merge_slot(slot_idx, toks_dev, r, tables[r], seeds[r])
        self._await_first_tokens(toks_dev, list(zip(group, range(n))))

    def _merge_slot(self, slot_idx: int, toks_dev, row: int, table_row, seed_row) -> None:
        """Activate the slot's lane on the device from row `row` of the
        sampled tokens; `table_row` and `seed_row` are the device copies
        the dispatch read (no upload here)."""
        slot = self._slots[slot_idx]
        request = slot.request
        if request.prefill_only:
            # Prefill tier: the lane never activates; the sampled token and
            # the written pages are this request's product, exported once
            # the token is on the host (`_resolve_slot`).
            slot.pending = None
            return
        top_k = self._eff_top_k(request)
        merge = (slot_idx, row, slot.prompt_len + 1, slot.position_cap,
                 float(request.temperature), float(request.top_p), top_k)
        if self._leader is not None:
            self._leader.queue(lockstep.Record("merge", merge))
        with _host_crossing("merge-upload"):
            _merge_lane_fn(
                self._dev, slot_idx, toks_dev, row, *merge[2:], table_row, seed_row,
                eos_id=self.tokenizer.eos_id,
                gamma_reset=max(self._gamma_max, 1) if self._spec else None,
            )
        slot.merged = True
        slot.pending = None
        self._seq_lens[slot_idx] = slot.prompt_len + 1
        self._caps[slot_idx] = slot.position_cap
        self._active[slot_idx] = True
        self._temperature[slot_idx] = request.temperature
        self._top_p[slot_idx] = request.top_p
        self._top_k[slot_idx] = top_k
        self._lane_ewma[slot_idx] = 1.0
        self._lane_gamma[slot_idx] = max(self._gamma_max, 1)

    def _eff_top_k(self, request: GenRequest) -> int:
        """The request's top_k as every sampled path sees it: with the
        prefilter on (top_p_candidates = C > 0) a wider top_k clamps to C,
        at admission, as in the reference."""
        k, C = int(request.top_k), self.config.top_p_candidates
        return min(k, C) if (C > 0 and k > 0) else k

    def _await_first_tokens(self, toks_dev: torch.Tensor, rows: list):
        """Start the copy of merged lanes' sampled tokens to host memory
        and give each (slot, row) of `rows` its handle; returns the copy's
        (host tensor, event). In stream order right behind the merges and
        before any other replay: the tokens may live in a graph's memory
        (engine/graphs.py). Depth 1 reads them at once."""
        with _host_crossing("first-token-resolve"):
            host, event = self._copy_to_host(toks_dev)
        for slot_idx, row in rows:
            self._slots[slot_idx].first = _FirstToken(host, event, row, self._dispatch_seq)
        if self._depth == 1:
            self._resolve_prefills(block=True)
        return host, event

    def _resolve_prefills(self, block: bool = False, ahead_of: Optional[int] = None) -> None:
        """Deliver the first tokens whose copies have landed: all of them
        with `block`, and those queued ahead of block `ahead_of` (its
        sequence number), which land no later than that block."""
        for i, slot in enumerate(self._slots):
            first = slot.first if slot is not None else None
            if first is not None and (
                    block or first.event is None or first.event.query()
                    or (ahead_of is not None and first.seq < ahead_of)):
                self._resolve_slot(i)

    def _resolve_slot(self, slot_idx: int) -> None:
        """Deliver the slot's first token to the client (waiting for its
        copy if it has not landed) and finish the request if it is done
        (EOS, or a budget of one token). A request cancelled since its
        merge is finished instead."""
        slot = self._slots[slot_idx]
        first, slot.first = slot.first, None
        request = slot.request
        if request.cancelled.is_set():
            self._finish(slot_idx, error="cancelled")
            return
        with _host_crossing("first-token-resolve"):
            if first.event is not None:
                first.event.synchronize()
            token = int(first.host[first.row])
        if slot.cache_ids is not None:
            # The token proves the prefill ran, so the prompt's pages hold
            # its KV: publish them now, never at merge time. Any consumer's
            # own prefill is dispatched after this, behind it on the stream.
            self._prefix.insert(slot.cache_ids, slot.pages)
            slot.cache_ids = None
        slot.generated = 1
        if request.prefill_only:
            self._export_handoff(slot_idx, slot, token)
            return
        request.timings.first_token = time.monotonic()
        slot.last_emit = request.timings.first_token
        if self.timeline is not None:
            self.timeline.slot_start(slot_idx, self._trace_id_of(request))
        if request.trace is not None:
            # Prefill phase: admission through the first token's arrival on
            # the host (bucketed, grouped, chunked and ragged prefills all
            # end in this resolve).
            request.trace.child(
                "prefill", start=request.timings.prefill_start,
                end=request.timings.first_token, prompt_tokens=slot.prompt_len,
                **({"handoff": True} if request.resume_state is not None else {}),
            )
            slot.decode_span = request.trace.child(
                "decode", start=request.timings.first_token)
        request.out.put(("token", token))
        self._maybe_finish(slot_idx, token)

    def _export_handoff(self, slot_idx: int, slot: _Slot, token: int) -> None:
        """Prefill-tier export: gather the slot's prompt pages to pinned host
        memory in table order (`gather_to_host`, which waits for them),
        emit ("handoff", KVHandoffState) and then ("done", timings), and
        release the slot. The target maps the pages to its own ids in the
        same order, with no index translation."""
        request = slot.request
        n_kv = -(-slot.prompt_len // self.config.page_size)
        t0 = time.monotonic()
        try:
            with _host_crossing("handoff-export"):
                if self.mesh is None:
                    pools = gather_to_host(self.paged, slot.pages[:n_kv])
                else:
                    # Whole pages from every rank's shard (the wire format's).
                    pages = list(slot.pages[:n_kv])
                    with lockstep.dispatch(self._leader,
                                           lockstep.Record("export", (pages,))):
                        pools = lockstep.gather_pages(
                            self.mesh, gather_to_host(self.paged, pages))
        except Exception as e:
            self._finish(slot_idx, error=f"handoff export failed: {e}")
            return
        gather_ms = (time.monotonic() - t0) * 1e3
        k, v, ks, vs = (pools + [None, None])[:4]
        halves = slot.seed_row.view(np.uint32).astype(np.uint64)
        seed = int((halves[0] << np.uint64(32)) | halves[1])
        state = KVHandoffState(
            model=self.model_cfg.name, page_size=self.config.page_size,
            prompt_len=slot.prompt_len, first_token=int(token), seed=seed,
            prompt_ids=torch.from_numpy(np.asarray(slot.handoff_ids, dtype=np.int32)),
            k=k, v=v, ks=ks, vs=vs, gather_ms=gather_ms,
        )
        slot.handoff_ids = None
        request.timings.first_token = time.monotonic()
        self._handoff_exports += 1
        if self.timeline is not None:
            self.timeline.note("handoff_export", slot=slot_idx,
                               prompt_tokens=slot.prompt_len, pages=n_kv,
                               gather_ms=round(gather_ms, 3))
        request.out.put(("handoff", state))
        self._finish(slot_idx)

    def _admit_resume(self, slot_idx: int, request: GenRequest) -> None:
        """Decode-tier admission: validate the handed-off state against this
        pool (geometry and dtypes, before any pool write: a mismatch raises
        as "kv-handoff rejected: ..."), allocate the request's pages (an
        AllocationError requeues it, the state riding the request), copy
        the prompt's pages into them and splice the lane at seq_len =
        prompt_len + 1, as a single-process run would hold it after its
        prefill. Greedy continuation is then the uninterrupted run's.

        The copy and the splice (`import_handoff`) run on this engine
        thread's stream, where every dispatch and graph replay runs: behind
        every block already queued (none of which reads the fresh pages:
        this slot's lane was inactive, its table on the garbage page) and
        ahead of every later dispatch. The lane state is written in place,
        in the buffers the decode graphs captured. The work holds
        `CAPTURE_LOCK`, so no import runs while an engine of this process
        captures (a supervised replacement), and an engine found dead under
        it writes nothing (EngineDeadError: the request is requeued and the
        loop fails the queue). The first token goes out through the lazy
        first-token path (`_resolve_slot`), ahead of the lane's block
        tokens."""
        cfg = self.config
        state = request.resume_state
        request.timings.prefill_start = time.monotonic()
        try:
            state.validate_for(self.model_cfg, cfg.page_size, self.paged.quantized)
            for got, pool in zip(state.pools, self.paged.pools):
                if got.dtype != pool.dtype:
                    raise KVWireError(
                        f"kv-handoff pool dtype mismatch: blob {got.dtype}, "
                        f"target {pool.dtype}")
        except KVWireError as e:
            # _admit wraps it as "admission failed: kv-handoff ..."; the
            # coordinator matches the marker and re-runs the prefill.
            raise RuntimeError(f"kv-handoff rejected: {e}") from e
        prompt_len = state.prompt_len
        request.timings.prompt_tokens = prompt_len
        slack = self._gamma_max
        max_new = max(1, min(request.max_new_tokens, cfg.max_new_tokens_cap,
                             cfg.max_seq_len - 1 - slack))
        total_len = prompt_len + max_new
        if total_len + slack > cfg.max_seq_len:
            raise RuntimeError(
                f"kv-handoff rejected: prompt_len {prompt_len} + max_new "
                f"{max_new} exceeds this worker's position budget "
                f"({cfg.max_seq_len})")
        if self._faults is not None:
            self._faults.maybe_raise("alloc-fail", AllocationError,
                                     replica=self.replica_id, tier=self._tier)
        pages = self.allocator.alloc(-(-(total_len + slack) // cfg.page_size))
        n_kv = state.num_pages
        table = np.zeros((cfg.pages_per_seq,), dtype=np.int32)
        table[:len(pages)] = pages
        seed = state.seed & 0xFFFFFFFFFFFFFFFF
        seed_row = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                            np.uint32).view(np.int32)
        token = int(state.first_token)
        top_k = self._eff_top_k(request)
        t0 = time.monotonic()
        events = None
        try:
            with CAPTURE_LOCK:
                if self.dead is not None or self._stop.is_set():
                    raise EngineDeadError(self.dead or "engine is shut down")
                if self.device.type == "cuda":
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                args = (slot_idx, list(pages), table, seed_row, total_len,
                        float(request.temperature), float(request.top_p), top_k,
                        state.prompt_len, token)
                with lockstep.dispatch(self._leader, lockstep.Record("import", args)):
                    self._import(args, state,
                                 start=events[0] if events is not None else None)
                if events is not None:
                    events[1].record()
        except EngineDeadError:
            self.allocator.release_all(pages)
            raise
        except Exception as e:
            self.allocator.release_all(pages)
            raise RuntimeError(f"kv-handoff restore failed: {e}") from e
        host_ms = (time.monotonic() - t0) * 1e3
        self._handoff_imports.append((host_ms, events))
        self._handoff_imported += 1
        if request.trace is not None:
            request.trace.child("queue_wait", start=request.timings.enqueued,
                                end=request.timings.prefill_start)
        slot = _Slot(request=request, pages=pages, table=table, seed_row=seed_row,
                     prompt_len=prompt_len, position_cap=total_len, merged=True)
        self._slots[slot_idx] = slot
        self._seq_lens[slot_idx] = prompt_len + 1
        self._caps[slot_idx] = total_len
        self._active[slot_idx] = True
        self._temperature[slot_idx] = request.temperature
        self._top_p[slot_idx] = request.top_p
        self._top_k[slot_idx] = top_k
        self._lane_ewma[slot_idx] = 1.0
        self._lane_gamma[slot_idx] = max(self._gamma_max, 1)
        slot.first = _FirstToken(torch.tensor([token], dtype=torch.int32), None, 0,
                                 self._dispatch_seq)
        if self.timeline is not None:
            self.timeline.note("handoff_restore", slot=slot_idx, pages=n_kv,
                               seq_len=prompt_len + 1, host_ms=round(host_ms, 3))
        return None

    def _import(self, args: tuple, state: Optional[KVHandoffState], start=None) -> None:
        """A handoff's import (`import_handoff`) from the operands `args`
        an "import" record carries; over a mesh the leader's whole pages
        (`state`) are cut to every rank's shard first
        (lockstep.scatter_pages), a follower passing None."""
        slot, pages, table, seed_row, cap, temp, top_p, top_k, prompt_len, token = args
        if self.mesh is not None:
            rows = list(range(state.num_pages)) if state is not None else None
            rows, shards = lockstep.scatter_pages(
                self.mesh, rows, state.pools if state is not None else None,
                self.paged.pools)
            k, v, ks, vs = (shards + [None, None])[:4]
            state = KVHandoffState(
                model=self.model_cfg.name, page_size=self.config.page_size,
                prompt_len=prompt_len, first_token=token, seed=0,
                prompt_ids=torch.zeros((0,), dtype=torch.int32), k=k, v=v, ks=ks, vs=vs)
        with _host_crossing("handoff-restore"):
            import_handoff(
                self.paged, self._dev, slot, state, pages, table, seed_row, cap, temp,
                top_p, top_k, eos_id=self.tokenizer.eos_id,
                gamma_reset=max(self._gamma_max, 1) if self._spec else None, start=start,
            )

    def _handoff_import_ms(self) -> list:
        """Device ms of the recent imports whose work has run (the copies
        up, the page scatter and the lane splice, between two CUDA events),
        host ms on the CPU; an import still queued is left out. No wait."""
        out = []
        for host_ms, events in list(self._handoff_imports):   # a snapshot
            if events is None:
                out.append(round(host_ms, 3))
            elif events[1].query():
                out.append(round(events[0].elapsed_time(events[1]), 3))
        return out

    def _has_pending_prefill(self) -> bool:
        return any(s is not None and s.pending is not None for s in self._slots)

    def _advance_chunked_prefills(self, budget: Optional[int]) -> int:
        """Advance slots mid-chunked-prefill, round-robin from the cursor,
        one chunk per slot, until `budget` tokens are spent (None: every
        pending slot advances one chunk). The first chunk always goes.
        Returns the prefill tokens charged."""
        spent = 0
        B = len(self._slots)
        for i in self._chunk_rr.scan(B):
            s = self._slots[i]
            if s is None or s.pending is None or s.restore_pages is not None:
                continue                 # a faulting slot waits for its restore
            if budget is not None and spent > 0 and spent >= budget:
                self._chunk_rr.reanchor(i)      # starved: first next time
                return spent
            spent += self._prefill_one_chunk(i)
        self._chunk_rr.advance(B)
        return spent

    def _prefill_one_chunk(self, slot_idx: int) -> int:
        """Prefill the next chunk of a long prompt at its offset through
        _prefill_fn (N = 1, the chunk width's graph); the final chunk
        samples the first token and merges the lane; nothing is read.
        Returns the chunk width charged, 0 when the slot ended without a
        dispatch (cancelled, expired, failed)."""
        slot = self._slots[slot_idx]
        request = slot.request
        if request.cancelled.is_set():
            self._finish(slot_idx, error="cancelled")
            return 0
        if self._deadline_expired(request):
            self.metrics.on_deadline_expired("prefill")
            self._finish(slot_idx, error=f"{DEADLINE_MSG} during prefill")
            return 0
        C = self._chunk
        take = min(C, len(slot.pending) - slot.filled)
        ids = slot.pending[slot.filled:slot.filled + take]
        final = slot.filled + take >= len(slot.pending)
        try:
            token_dev, tables, seeds = self._run_prefill([(slot, ids, slot.filled)], C, 1)
        except LockstepError as e:
            self._finish(slot_idx, error=str(e))
            raise
        except Exception as e:
            self._finish(slot_idx, error=f"prefill failed: {e}")
            return 0
        if self.timeline is not None:
            self.timeline.prefill(slot_idx, take, final)
        self.metrics.on_padding_tokens(C, take)
        if final:
            self._merge_slot(slot_idx, token_dev, 0, tables[0], seeds[0])
            self._await_first_tokens(token_dev, [(slot_idx, 0)])
        else:
            slot.filled += take
        return C

    def _build_ragged_batch(self) -> list:
        """The next ragged dispatch's token ranges: round-robin from the
        cursor over slots with pending prompt tokens, one range of up to a
        chunk per slot, until the budget (while decode lanes are live) or
        the stream width is spent; the first range always goes. A
        speculative engine builds to its narrowest rung's width, so the
        batch fits whichever dispatch the round's gate picks. Returns
        [(slot_idx, slot, take)]."""
        W = min([self._ragged_width, *self._ragged_spec_width.values()])
        budget = min(self._prefill_budget, W) if self._active.any() else W
        ranges: list = []
        spent = 0
        B = len(self._slots)
        starved = None
        for i in self._chunk_rr.scan(B):
            s = self._slots[i]
            if s is None or s.pending is None or s.restore_pages is not None:
                continue                 # a faulting slot waits for its restore
            if s.request.cancelled.is_set():
                self._finish(i, error="cancelled")
                continue
            if self._deadline_expired(s.request):
                self.metrics.on_deadline_expired("prefill")
                self._finish(i, error=f"{DEADLINE_MSG} during prefill")
                continue
            if spent >= budget and ranges:
                starved = i
                break
            take = min(self._chunk, len(s.pending) - s.filled, W - spent)
            if take <= 0:
                if ranges:
                    starved = i
                break
            ranges.append((i, s, take))
            spent += take
        if starved is not None:
            self._chunk_rr.reanchor(starved)
        else:
            self._chunk_rr.advance(B)
        return ranges

    def _ragged_prefill_operands(self, ranges: list, W: int):
        """The 14 `pre_*` numpy operands of a ragged dispatch of stream
        width W for `ranges`; returns (operands, real prefill tokens)."""
        cfg = self.config
        ops = ragged_zero_operands(cfg.max_decode_slots, W, cfg.pages_per_seq)
        (pre_tokens, pre_pos, pre_tidx, pre_tables, rng_start, rng_len, rng_kv,
         rng_tidx, smp_idx, smp_pos, smp_seeds, smp_temp, smp_top_p,
         smp_top_k) = ops
        off = useful = 0
        for r, (i, s, take) in enumerate(ranges):
            pre_tokens[off:off + take] = s.pending[s.filled:s.filled + take]
            pre_pos[off:off + take] = np.arange(s.filled, s.filled + take)
            pre_tidx[off:off + take] = i
            pre_tables[i] = s.table
            rng_start[r] = off
            rng_len[r] = take
            rng_kv[r] = s.filled + take
            rng_tidx[r] = i
            if s.filled + take >= len(s.pending):
                # Final range: sample the first token from its last row at
                # position key prompt_len, as _prefill_fn does.
                smp_idx[i] = off + take - 1
                smp_pos[i] = s.filled + take
                smp_seeds[i] = s.seed_row
                smp_temp[i] = s.request.temperature
                smp_top_p[i] = s.request.top_p
                smp_top_k[i] = self._eff_top_k(s.request)
            off += take
            useful += take
        return ops, useful

    def _steps_in_flight(self) -> int:
        """Decode steps of the blocks in flight, by the host's count: K for
        a decode block, 1 for a ragged dispatch, gamma + 1 for a spec round
        (its host copy is the packed [B, gamma + 1 + SPEC_STAT_COLS]
        matrix), however many a lane really takes."""
        return sum(blk.host.shape[0] if blk.kind == "decode"
                   else blk.host.shape[1] - SPEC_STAT_COLS for blk in self._inflight_q)

    def _ragged_work_lists(self, ops, W: int, G1: int, models) -> list:
        """The ragged kernel's work list for each model config of `models`
        (it depends on the heads) over a stream of B lanes of G1 rows each
        (1: the decode lanes' single tokens; gamma + 1: the verify windows)
        and the W prefill rows of `ops`. From host values: with blocks in
        flight the host's lengths lag the device's, so live lanes count the
        steps in flight on top, capped at their caps, an estimate that
        sizes the splits and orders the CTAs; the kernel reads the true key
        counts on the device. Over a tp mesh the lists are cut for a rank's
        kv heads: the CTA count, and so the splits, depend on them."""
        B = self.config.max_decode_slots
        act = self._active
        kv_est = np.where(act, np.minimum(self._seq_lens + self._steps_in_flight(),
                                          self._caps), self._seq_lens)
        starts = np.concatenate([np.arange(B) * G1, B * G1 + ops[4]])
        lens = np.concatenate([np.full(B, G1, np.int32), ops[5]])
        kvs = np.concatenate([np.maximum(kv_est, 1) + G1 - 1, ops[6]])
        tp = self.mesh.shape["tp"] if self.mesh is not None else 1
        return [ragged_work(starts, lens, kvs, B * G1 + W, mc.num_heads // mc.num_kv_heads,
                            mc.num_kv_heads // tp, "cpu") for mc in models]

    def _dispatch_ragged(self, ranges: list,
                         spec_candidates: Optional[int] = None) -> Optional[_InflightBlock]:
        """One flat mixed dispatch of `ranges` plus every decode lane,
        without waiting for it or for the blocks in flight: final-range
        slots merge on the device and get their first-token handles. Plain
        (`_ragged_fn`): each lane's single token, the packed [1, B] row
        back as an in-flight block. With `spec_candidates` (the round's
        candidates count, `ragged_spec_fn` at the current rung): each lane's
        verify window, the round's packed matrix back as an in-flight round;
        a round is gamma + 1 steps of the pipeline's accounting, and the
        padding counts the prefill rows only. Returns
        None when the dispatch failed (its ranged slots are finished, the
        lanes are untouched)."""
        cfg = self.config
        B = cfg.max_decode_slots
        spec = spec_candidates is not None
        gamma = self._gamma
        G1 = gamma + 1 if spec else 1
        W = self._ragged_spec_width[gamma] if spec else self._ragged_width
        ops, useful = self._ragged_prefill_operands(ranges, W)
        act = self._active
        lanes = int(act.sum())
        smp_temp = ops[11]
        greedy = bool(np.all(self._temperature[act] == 0.0)) and bool(
            np.all(smp_temp == 0.0))
        models = (self.model_cfg, self.draft_cfg) if spec else (self.model_cfg,)
        works = [dataclasses.replace(w, items=w.items.numpy())
                 for w in self._ragged_work_lists(ops, W, G1, models)]
        if spec:
            self._depth_target = min(
                self._depth, max(1, -(-self._remaining_budget(act) // G1)))
        else:
            self._depth_target = self._depth
        gap_ms = self.metrics.on_dispatch(lanes, G1, slots=B)
        live = tuple(int(i) for i in np.flatnonzero(act))
        self.metrics.on_padding_tokens(W, useful)
        self.metrics.on_prefill_interleave(useful, lanes > 0)
        args = (spec_candidates, gamma, greedy, ops, works)
        try:
            if self._leader is not None:
                try:
                    with lockstep.dispatch(self._leader, lockstep.Record("ragged", args)):
                        self._prefill_fault()
                        packed_dev, first_dev = self._ragged_device(*args)
                except Exception as e:
                    raise LockstepError(f"mesh ragged dispatch failed: {e}") from e
            else:
                self._prefill_fault()
                packed_dev, first_dev = self._ragged_device(*args)
        except LockstepError:
            raise
        except Exception as e:
            # Contained to the ranged slots, as a failed prefill group is;
            # the decode lanes' state was not advanced.
            for i, s, _take in ranges:
                if self._slots[i] is s:
                    self._finish(i, error=f"prefill failed: {e}")
            return None
        self._ragged_dispatches += 1
        self._ragged_behind += bool(self._inflight_q)
        if spec:
            self._ragged_spec_dispatches += 1
            self._ragged_spec_lanes += lanes
            if cfg.spec_host_sync:
                self._spec_host_sync(packed_dev)
        self._dispatch_seq += 1
        if self.timeline is not None:
            self.timeline.dispatch(self._dispatch_seq, "spec" if spec else "ragged",
                                   lanes, G1, gap_ms)
        reqs = self._snapshot_requests()
        _, pre_tables, smp_seeds = self._last_prefill
        finals = []
        for i, s, take in ranges:
            if self.timeline is not None:
                self.timeline.prefill(i, take, s.filled + take >= len(s.pending))
            if s.filled + take >= len(s.pending):
                self._merge_slot(i, first_dev, i, pre_tables[i], smp_seeds[i])
                finals.append(i)
            else:
                s.filled += take
        # One copy to host memory: the packed tokens, then the first tokens
        # (slot i's at n + i).
        n = packed_dev.numel()
        host, event = self._await_first_tokens(
            torch.cat([packed_dev.reshape(-1), first_dev]), [(i, n + i) for i in finals])
        if self._digest is not None:
            self._digest.add(host[:n], event)
        return _InflightBlock(host[:n].view(packed_dev.shape), event, reqs,
                              self._dispatch_seq, "spec" if spec else "decode",
                              gap_ms, live)

    def _ragged_device(self, spec_candidates: Optional[int], gamma: int, greedy: bool,
                       ops: tuple, works: list):
        """The device side of a ragged dispatch, the leader's and a
        follower's replay of its record: the host-built operands `ops`
        (`_ragged_prefill_operands`) and the kernel work lists `works` (one
        `RaggedWork` a model, its items as a host array) go up by one copy,
        then `_ragged_fn` (the lane state written back in place) or, with
        `spec_candidates`, `ragged_spec_fn` at rung `gamma`. The work lists
        ride the record rather than being rebuilt by each follower: they
        come from the leader's host lengths and steps in flight, which
        only the leader has, and every rank must launch the same list.
        Returns (packed, first) on the device and keeps (first, prefill
        tables, seeds) as the operands of the merges that follow."""
        cfg = self.config
        with _host_crossing("ragged-upload"):
            on_dev = _to_device([*ops, *(w.items for w in works)], self.device)
        ops_dev = on_dev[:len(ops)]
        works = [dataclasses.replace(w, items=items)
                 for w, items in zip(works, on_dev[len(ops):])]
        dev = self._dev
        lane_state = [dev[k] for k in ("last_tokens", "seq_lens", "page_tables", "active",
                                       "caps", "seeds", "temperature", "top_p", "top_k")]
        if spec_candidates is not None:
            packed_dev, first_dev = ragged_spec_fn(
                self.params, self.draft_params, self.model_cfg, self.draft_cfg,
                self.paged, self.d_paged, *lane_state, dev["accept_ewma"],
                dev["gamma_lane"], *ops_dev,
                gamma=gamma, eos_id=self.tokenizer.eos_id, gamma_low=self._gamma_low,
                gamma_max=self._gamma_max, greedy=greedy,
                candidates=spec_candidates, t_work=works[0], d_work=works[1],
                mesh=self.mesh,
            )
        else:
            packed_dev, *lane, first_dev, self.paged = _ragged_fn(
                self.params, self.model_cfg, self.paged, *lane_state, *ops_dev,
                greedy=greedy, eos_id=self.tokenizer.eos_id, work=works[0],
                candidates=cfg.top_p_candidates, mesh=self.mesh,
            )
            # In place: the decode graphs captured these buffers.
            for name, t in zip(("last_tokens", "seq_lens", "active"), lane):
                dev[name].copy_(t)
        self._last_prefill = (first_dev, ops_dev[3], ops_dev[10])
        return packed_dev, first_dev

    def _dispatch_step(self) -> Optional[_InflightBlock]:
        """Dispatch one decode block, spec round or, in ragged mode with
        pending prefill work, one ragged dispatch (a spec engine's carries
        the round when its gate is on), without waiting for it or for the
        blocks in flight; returns its in-flight record, or None when there
        was nothing to dispatch."""
        if self._faults is not None:
            # Stand-ins for a wedged (step-stall) or degraded (slow-step)
            # device call, where the real dispatch would block. A thread
            # that wakes into a dead or stopped engine dispatches nothing:
            # the engine replacing it may be capturing its graphs.
            self._faults.maybe_sleep("step-stall", replica=self.replica_id,
                                     tier=self._tier)
            self._faults.maybe_sleep("slow-step", replica=self.replica_id,
                                     tier=self._tier)
            if self.dead is not None or self._stop.is_set():
                return None
        act = self._active
        # The round's gate (the reference's): every active row untruncated
        # (greedy rows count as such; the round then skips the truncation,
        # candidates 0), or the prefilter on, which lets top_p < 1 rows
        # speculate. Otherwise the plain block (or ragged dispatch) goes
        # out; the draft's pools then miss its steps and acceptance drops,
        # never correctness. None: the gate is off.
        spec_cand = None
        if self._spec:
            untruncated = bool(np.all(
                ((self._top_p[act] >= 1.0) & (self._top_k[act] <= 0))
                | (self._temperature[act] == 0.0)))
            if untruncated or self.config.top_p_candidates > 0:
                spec_cand = 0 if untruncated else self.config.top_p_candidates
        if self._ragged and self._has_pending_prefill():
            ranges = self._build_ragged_batch()
            block = None
            if ranges:
                block = (self._dispatch_ragged(ranges) if spec_cand is None
                         else self._dispatch_ragged(ranges, spec_cand))
            if block is not None or not self._active.any():
                return block
            act = self._active
        if spec_cand is not None:
            return self._dispatch_spec(act, spec_cand)
        lanes = int(act.sum())
        # The greedy graph skips the sampler's sort and draws; host
        # `_active` covers every lane live on the device, so it is safe.
        greedy = bool(np.all(self._temperature[act] == 0.0))
        # Adaptive K: a lone stream gets the small block.
        steps = self._solo_steps if lanes == 1 else self._block_steps
        # Constant steps in flight across block sizes, but never more
        # blocks than the longest remaining budget needs: a stopped lane's
        # steps still cost a full weight read each.
        blocks_needed = max(1, -(-self._remaining_budget(act) // steps))
        self._depth_target = min(
            64, 1 + (self._depth - 1) * (self._block_steps // steps), blocks_needed,
        )
        gap_ms = self.metrics.on_dispatch(lanes, steps, slots=len(self._slots))
        live = tuple(int(i) for i in np.flatnonzero(act))
        with lockstep.dispatch(self._leader, lockstep.Record("decode", (greedy, steps))):
            packed = self._graphs.run("decode", greedy, steps)
        with _host_crossing("block-packed"):
            host, event = self._copy_to_host(packed)
        if self._digest is not None:
            self._digest.add(host, event)
        self._dispatch_seq += 1
        if self.timeline is not None:
            self.timeline.dispatch(self._dispatch_seq, "plain", lanes, steps, gap_ms)
        return _InflightBlock(host, event, self._snapshot_requests(), self._dispatch_seq,
                              "decode", gap_ms, live)

    def _decode_block(self, greedy: bool, steps: int) -> torch.Tensor:
        """The block body the decode graphs capture: `_decode_fn` over the
        engine's weights, pools and lane-state buffers."""
        dev = self._dev
        return _decode_fn(
            self.params, self.model_cfg, self.paged,
            dev["last_tokens"], dev["seq_lens"], dev["page_tables"],
            dev["active"], dev["caps"], dev["seeds"], dev["temperature"],
            dev["top_p"], dev["top_k"],
            greedy=greedy, steps=steps, eos_id=self.tokenizer.eos_id,
            candidates=self.config.top_p_candidates, mesh=self.mesh,
        )

    def _replay(self, record: lockstep.Record) -> None:
        """A follower's application of one of the leader's records, through
        the functions and graphs the leader ran (engine/lockstep.py)."""
        kind, args = record
        if self._faults is not None and kind in ("decode", "spec", "ragged"):
            # The leader's step-stall point (`_dispatch_step`) at a
            # follower's decode dispatch: a wedged device call there holds
            # the leader in the dispatch's collectives. A follower that wakes
            # into a stopped engine (a new life's orphan) replays nothing.
            self._faults.maybe_sleep("step-stall", replica=self.replica_id,
                                     tier=self._tier)
            if self._stop.is_set():
                return
        if kind == "prefill":
            self._prefill_dispatch(*args)
        elif kind == "merge":
            toks, tables, seeds = self._last_prefill
            slot, row = args[:2]
            with _host_crossing("merge-upload"):
                _merge_lane_fn(self._dev, slot, toks, row, *args[2:], tables[row],
                               seeds[row], eos_id=self.tokenizer.eos_id,
                               gamma_reset=max(self._gamma_max, 1) if self._spec else None)
        elif kind == "retire":
            with _host_crossing("retire-upload"):
                _retire_lane_fn(self._dev, *args)
        elif kind in ("decode", "spec"):
            # Copied out like the leader's block before any other replay
            # (engine/graphs.py), and hashed.
            packed = self._graphs.run(kind, *args)
            with _host_crossing("block-packed" if kind == "decode" else "spec-packed"):
                self._digest.add(*self._copy_to_host(packed))
        elif kind == "ragged":
            packed, first = self._ragged_device(*args)
            with _host_crossing("first-token-resolve"):
                host, event = self._copy_to_host(torch.cat([packed.reshape(-1), first]))
            self._digest.add(host[:packed.numel()], event)
        elif kind == "spill":
            pages, rows, persist = args
            with _host_crossing("kv-evict-gather"):
                hosts = gather_to_host(self.paged, pages)
            for j, row in enumerate(rows):
                self._host_kv.write(row, *(t[:, j] for t in hosts))
            if persist:             # the leader writes the whole pages
                lockstep.gather_pages(self.mesh, hosts)
        elif kind == "restore":
            with _host_crossing("kv-fault-restore"):
                restore_from_host(self.paged, self._host_kv, *args)
        elif kind == "export":          # the leader assembles the whole pages
            with _host_crossing("handoff-export"):
                lockstep.gather_pages(self.mesh, gather_to_host(self.paged, args[0]))
        elif kind == "import":
            self._import(args, None)
        elif kind != "heartbeat":
            raise ValueError(f"unknown lock-step record {kind!r}")
        self.replayed[kind] = self.replayed.get(kind, 0) + 1
        self.last_progress = time.monotonic()

    def _dispatch_spec(self, act, cand: int) -> _InflightBlock:
        """Dispatch one draft/verify round at the current rung, a replay of
        the (gamma, greedy, candidates `cand`) graph. A round is gamma + 1
        steps of the pipeline's accounting."""
        lanes = int(act.sum())
        greedy = bool(np.all(self._temperature[act] == 0.0))
        gamma = self._gamma
        steps = gamma + 1
        blocks_needed = max(1, -(-self._remaining_budget(act) // steps))
        self._depth_target = min(self._depth, blocks_needed)
        gap_ms = self.metrics.on_dispatch(lanes, steps, slots=len(self._slots))
        live = tuple(int(i) for i in np.flatnonzero(act))
        with lockstep.dispatch(self._leader, lockstep.Record("spec", (gamma, greedy, cand))):
            packed = self._graphs.run("spec", gamma, greedy, cand)
        with _host_crossing("spec-packed"):
            host, event = self._copy_to_host(packed)
        if self.config.spec_host_sync:
            self._spec_host_sync(packed)
        if self._digest is not None:
            self._digest.add(host, event)
        self._dispatch_seq += 1
        if self.timeline is not None:
            self.timeline.dispatch(self._dispatch_seq, "spec", lanes, steps, gap_ms)
        return _InflightBlock(host, event, self._snapshot_requests(), self._dispatch_seq,
                              "spec", gap_ms, live)

    def _spec_host_sync(self, packed: torch.Tensor) -> None:
        """EngineConfig.spec_host_sync (A/B instrumentation only): three
        timed blocking reads of the round's packed result right after its
        dispatch, outside any graph capture, each one host stall
        (metrics.on_spec_host_sync), as a round read back at dispatch time
        costs. Only the leader dispatches, so followers never read."""
        for _ in range(3):
            t0 = time.monotonic()
            with _host_crossing("spec-host-sync"):
                packed.to("cpu", copy=True)
            self.metrics.on_spec_host_sync((time.monotonic() - t0) * 1e3)

    def _spec_round(self, gamma: int, greedy: bool, candidates: int) -> torch.Tensor:
        """The body the spec graphs capture: `spec_decode_fn` over both
        models' weights and pools and the lane-state buffers, the dial
        included."""
        dev = self._dev
        return spec_decode_fn(
            self.params, self.draft_params, self.model_cfg, self.draft_cfg,
            self.paged, self.d_paged,
            dev["last_tokens"], dev["seq_lens"], dev["page_tables"], dev["active"],
            dev["caps"], dev["seeds"], dev["temperature"], dev["top_p"], dev["top_k"],
            dev["accept_ewma"], dev["gamma_lane"],
            gamma=gamma, eos_id=self.tokenizer.eos_id, gamma_low=self._gamma_low,
            gamma_max=self._gamma_max, candidates=candidates, greedy=greedy,
            mesh=self.mesh,
        )

    @staticmethod
    def _copy_to_host(packed: torch.Tensor):
        """Start the tokens' copy to host memory (pinned, non-blocking);
        returns (host tensor, CUDA event that fires when it has landed). On
        the CPU the tensor itself is the host copy and there is no event.
        Callers hold the crossing's scope (`_host_crossing`)."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _remaining_budget(self, act) -> int:
        """Longest remaining token budget over active lanes (host
        mirrors): the tail-work cap of the in-flight target."""
        return int(np.max(np.where(act, self._caps - self._seq_lens, 0)))

    def _snapshot_requests(self) -> list:
        """The request in each slot at dispatch time: a slot can be
        finished (cancel) and re-admitted while its block is in flight, and
        the stale lane's tokens must never reach the new occupant."""
        return [s.request if s is not None else None for s in self._slots]

    @staticmethod
    def _block_ready(block: _InflightBlock) -> bool:
        """Whether the block's packed copy has landed (its read would not
        block the host)."""
        return block.event is None or block.event.query()

    def _process_step(self, block: _InflightBlock) -> None:
        """Read a dispatched block's tokens and emit/finish on the host.
        Slots activated after its dispatch were not in it: their lanes
        were inactive and their columns read -1, and the request snapshot
        skips them."""
        # Observed lookahead: blocks dispatched after this one, before its
        # readback (0 is the synchronous depth-1 shape).
        lookahead = self._dispatch_seq - block.seq
        queued_after = len(self._inflight_q)
        if block.kind == "spec":
            # Spec rounds always sync: their stat columns feed the dial
            # mirrors and the rung even when every occupant is gone.
            self._process_spec(block, lookahead, queued_after)
            return
        if not any(s is not None and s.request is block.reqs[i]
                   for i, s in enumerate(self._slots)):
            # Dead block: every dispatch-time occupant is gone; nothing to
            # emit, so nothing is read (no stall, no device time charged).
            self.metrics.on_process_block(lookahead, None)
            if self.timeline is not None:
                now = time.monotonic()
                self.timeline.process(block.seq, now, now, None, lookahead,
                                      queued_after, 0.0)
            return
        t_sync = time.monotonic()
        # First tokens queued ahead of this block land no later than it:
        # deliver them before waiting for it, not after.
        self._resolve_prefills(ahead_of=block.seq)
        with _host_crossing("block-packed"):
            if block.event is not None:
                block.event.synchronize()
            packed = block.host.numpy()
        stall_ms = (time.monotonic() - t_sync) * 1e3
        self.metrics.on_process_block(lookahead, stall_ms,
                                      trace_id=self._block_trace_id(block))
        busy_ms = self._attribute_device_time(block, stall_ms)
        self._emit_block(packed, block.reqs, t_sync, steps=int(packed.shape[0]))
        if self.timeline is not None:
            self.timeline.process(block.seq, t_sync, time.monotonic(), stall_ms,
                                  lookahead, queued_after, busy_ms)

    def _block_trace_id(self, block: _InflightBlock) -> Optional[str]:
        """A trace id to exemplar block-level observations with: the first
        traced request live in the block."""
        for i in block.live:
            trace_id = self._trace_id_of(block.reqs[i])
            if trace_id is not None:
                return trace_id
        return None

    def _attribute_device_time(self, block: _InflightBlock, stall_ms: float) -> float:
        """Charge the block's device-busy window — the host gap before its
        dispatch minus the host stall its readback cost — equally to the
        lanes live at dispatch, into each request's timings.device_ms (the
        reference's attribution: dispatches serialize on the stream, so at
        steady state consecutive dispatches tile the device's schedule).
        Returns the busy ms charged (0.0 when nothing was)."""
        if not block.live or block.gap_ms <= 0.0:
            return 0.0
        busy = block.gap_ms - max(0.0, stall_ms)
        if busy <= 0.0:
            return 0.0
        self.metrics.on_device_busy(busy)
        share = busy / len(block.live)
        for i in block.live:
            request = block.reqs[i]
            if request is not None:
                request.timings.device_ms += share
        return busy

    def _process_spec(self, block: _InflightBlock, lookahead: int,
                      queued_after: int) -> None:
        """Read a round's packed matrix: emit each row's prefix (-1 padded,
        truncated on the device), refresh the dial mirrors of the lanes
        whose request still holds the slot from the stat columns, count
        the drafts, then pick the next rung: gamma_max if any live dial
        wants more than gamma_low, under the cap."""
        t_sync = time.monotonic()
        self._resolve_prefills(ahead_of=block.seq)
        with _host_crossing("spec-packed"):
            if block.event is not None:
                block.event.synchronize()
            packed = block.host.numpy()
        stall_ms = (time.monotonic() - t_sync) * 1e3
        self.metrics.on_process_block(lookahead, stall_ms,
                                      trace_id=self._block_trace_id(block))
        busy_ms = self._attribute_device_time(block, stall_ms)
        g1 = packed.shape[1] - SPEC_STAT_COLS
        acc_col, prop_col = packed[:, g1], packed[:, g1 + 1]
        for i, slot in enumerate(self._slots):
            # A stale round must not overwrite a re-admitted lane's fresh
            # dial (the device copy is already right: the merge ran after).
            if slot is not None and slot.request is block.reqs[i]:
                self._lane_ewma[i] = packed[i, g1 + 2] / 1e6
                self._lane_gamma[i] = packed[i, g1 + 3]
        self._emit_block(np.ascontiguousarray(packed[:, :g1].T), block.reqs, t_sync,
                         spec_round=True)
        if self.timeline is not None:
            self.timeline.process(block.seq, t_sync, time.monotonic(), stall_ms,
                                  lookahead, queued_after, busy_ms)
        accepted, proposed = int(acc_col.sum()), int(prop_col.sum())
        self.metrics.on_spec(accepted, proposed)
        self._spec_rounds += 1
        self._spec_lane_rounds += int((packed[:, 0] >= 0).sum())
        self._spec_tokens += int((packed[:, :g1] >= 0).sum())
        if proposed > 0:
            self._accept_ewma = (GAMMA_EWMA_BETA * self._accept_ewma
                                 + (1.0 - GAMMA_EWMA_BETA) * accepted / proposed)
        live = [i for i, s in enumerate(self._slots) if s is not None and self._active[i]]
        want = int(self._lane_gamma[live].max()) if live else self._gamma_max
        rung = self._gamma_max if want > self._gamma_low else self._gamma_low
        self._gamma = min(rung, self._gamma_cap)

    def _emit_block(self, packed: np.ndarray, reqs: list, t_sync: float,
                    **span_attrs) -> None:
        """Emit a block's packed [K, B] tokens to the requests that held
        their slots at dispatch (`reqs`) and finish streams on the host.
        The block's own K, not the configured one: the adaptive block
        varies it. A traced slot's decode span gets a decode_block child
        (`span_attrs`) opened at the block's sync start `t_sync`."""
        emitted = 0
        for i, slot in enumerate(self._slots):
            if slot is None or not self._active[i] or slot.request is not reqs[i]:
                continue
            if slot.request.cancelled.is_set():
                self._finish(i, error="cancelled")
                continue
            if self._deadline_expired(slot.request):
                self.metrics.on_deadline_expired("decode")
                self._finish(i, error=f"{DEADLINE_MSG} mid-decode")
                continue
            if slot.first is not None:
                # The first token precedes the block's tokens in the
                # client's stream (its copy was queued no later than the
                # block's).
                self._resolve_slot(i)
                if self._slots[i] is not slot:
                    continue
            before = slot.generated
            block_span = None
            for k in range(packed.shape[0]):
                token = int(packed[k, i])
                if token < 0:
                    break
                slot.generated += 1
                self._seq_lens[i] += 1
                block_span = self._note_block_token(slot, block_span, before, t_sync,
                                                    span_attrs)
                slot.request.out.put(("token", token))
                emitted += 1
                self._maybe_finish(i, token)
                if self._slots[i] is None:
                    break
            n = slot.generated - before
            if n > 0:
                now = time.monotonic()
                self.metrics.on_itl((now - slot.last_emit) * 1e3 / n, n,
                                    trace_id=self._trace_id_of(slot.request))
                slot.last_emit = now
        self.metrics.on_step(emitted)

    @staticmethod
    def _note_block_token(slot: _Slot, block_span, before: int, t_sync: float,
                          attrs: dict):
        """Per-token upkeep of a traced slot's decode_block span: opened on
        the block's first token (no earlier than the decode span), its
        token count and end kept current BEFORE the token reaches the
        client — the gateway may freeze the tree the moment the stream
        ends."""
        if slot.decode_span is None:
            return None
        if block_span is None:
            block_span = slot.decode_span.child(
                "decode_block", start=max(t_sync, slot.decode_span.start), **attrs)
        block_span.set(tokens=slot.generated - before)
        block_span.end = time.monotonic()
        return block_span

    def _maybe_finish(self, slot_idx: int, token: int) -> None:
        slot = self._slots[slot_idx]
        request = slot.request
        hit_eos = token == self.tokenizer.eos_id
        hit_cap = (
            slot.generated >= request.max_new_tokens
            or slot.generated >= self.config.max_new_tokens_cap
            or int(self._seq_lens[slot_idx]) >= slot.position_cap
        )
        if hit_eos or hit_cap:
            self._finish(slot_idx)

    def _finish(self, slot_idx: int, error: Optional[str] = None) -> None:
        slot = self._slots[slot_idx]
        if slot is None:
            return
        request = slot.request
        slot.first = None     # an undelivered first token goes with its request
        request.timings.finished = time.monotonic()
        request.timings.completion_tokens = slot.generated
        if self.timeline is not None:
            self.timeline.slot_end(
                slot_idx,
                "cancelled" if error == "cancelled"
                else ("error" if error is not None else "done"),
                slot.generated,
            )
        if slot.decode_span is not None:
            slot.decode_span.set(tokens=slot.generated)
            slot.decode_span.finish(end=request.timings.finished)
        if request.trace is not None:
            if request.timings.device_ms > 0:
                request.trace.set(device_ms=round(request.timings.device_ms, 3))
            # A cancellation (stop sequence, client gone) is the expected
            # end of those RPCs, not a failure label.
            if error == "cancelled":
                request.trace.set(cancelled=True)
            elif error is not None:
                request.trace.set(error=error)
        if slot.restore_pages:
            # Ended before its restore was issued: its host pages go back
            # to the cache, so the warmth outlives the slot.
            self._undo_match([], slot.restore_pages)
            slot.restore_pages = None
        self.allocator.release_all(slot.pages)
        self._slots[slot_idx] = None
        self._active[slot_idx] = False
        self._seq_lens[slot_idx] = 0
        self._caps[slot_idx] = 0
        self._temperature[slot_idx] = 0.0
        self._top_p[slot_idx] = 1.0
        self._top_k[slot_idx] = 0
        if slot.merged and self.dead is None:
            if self._leader is not None:
                self._leader.queue(lockstep.Record("retire", (slot_idx,)))
            with _host_crossing("retire-upload"):
                _retire_lane_fn(self._dev, slot_idx)
        if error is not None:
            self._fail_request(request, error)
        else:
            request.out.put(("done", request.timings))
            self.metrics.on_finish(request.timings, trace_id=self._trace_id_of(request))
        if (self._host_kv is not None and self.dead is None and not self._stop.is_set()
                and self.allocator.num_free < self._resident_low):
            # Below the resident floor: spill cold cache pages now, off any
            # admission's critical path (after the request's own end, so a
            # failed gather cannot leave it unanswered).
            self._spill_for(self._resident_low)

    # -- host-KV tier ----------------------------------------------------------

    def _issue_restores(self) -> int:
        """The restore frontier: issue the host-to-device restore of up to
        `_restore_slots` faulting slots, round-robin from the cursor, ahead
        of this iteration's dispatches. The first always goes (the progress
        floor). A faulting slot joins no prefill until its restore is
        issued; after that, stream order puts the restored pages ahead of
        every dispatch that reads them, with no host wait. Returns the
        slots restored."""
        issued = 0
        B = len(self._slots)
        for i in self._restore_rr.scan(B):
            slot = self._slots[i]
            if slot is None or slot.restore_pages is None:
                continue
            if issued >= self._restore_slots and issued > 0:
                self._restore_rr.reanchor(i)     # starved: first next time
                return issued
            if slot.request.cancelled.is_set():
                self._finish(i, error="cancelled")
                continue
            self._restore_slot_pages(i, slot)
            issued += 1
        self._restore_rr.advance(B)
        return issued

    def _restore_slot_pages(self, slot_idx: int, slot: _Slot) -> None:
        """One faulting slot's restore (`restore_from_host`) into its own
        device pages, on the current stream, the one every dispatch and
        graph replay runs on; then its host pages are released and the
        cache entries promoted to the device pages. A failure finishes the
        slot with an error (its host pages go back to the cache) and is
        never retried elsewhere."""
        items = slot.restore_pages
        t0 = time.monotonic()
        host = self._host_kv
        rows, pages = [hp for _, hp, _ in items], [slot.pages[ci] for _, _, ci in items]
        try:
            with _host_crossing("kv-fault-restore"):
                restore_from_host(self.paged, host, rows, pages)
        except Exception as e:
            self._finish(slot_idx, error=f"kv restore failed: {e}")
            return
        if self._leader is not None:
            # No collective: it rides with the next record that issues one,
            # ahead of the prefill that reads the restored pages.
            self._leader.queue(lockstep.Record("restore", (rows, pages)))
        for key, host_page, ci in items:
            host.release(host_page)
            # Promote under the slot's page; a key re-inserted meanwhile
            # wins, and this slot's copy still serves it.
            self._prefix.reinsert_device(key, slot.pages[ci])
        slot.restore_pages = None
        ms = (time.monotonic() - t0) * 1e3
        trace_id = self._trace_id_of(slot.request)
        self.metrics.on_kv_restore(len(items), ms, trace_id=trace_id)
        if self.timeline is not None:
            self.timeline.note("kv_restore", slot=slot_idx, pages=len(items),
                               ms=round(ms, 3), trace=trace_id)

    def _spill_for(self, target_free: int) -> int:
        """Spill LRU device-tier cache entries to the host tier until the
        allocator has `target_free` free pages or nothing is left to spill.
        A spilled page a live slot still holds frees only when the slot
        retires, so the loop reads num_free again. Returns pages spilled."""
        if self._host_kv is None or self._prefix is None:
            return 0
        spilled = 0
        while self.allocator.num_free < target_free:
            cands = self._prefix.spill_candidates(self.config.pages_per_seq)
            if not cands:
                break
            spilled += self._spill_batch(cands)
        return spilled

    def _spill_batch(self, cands: list) -> int:
        """Gather one batch of cold pages [(key, device page)] to host memory
        (`gather_to_host`, which waits for the copy), then move each page
        into the host pool (dropping the LRU host entry when it is full) and
        write the batch to the durable store. The cache's device references
        are released only after the copy; a later writer of a freed page is
        queued behind the gather on the same stream anyway."""
        with _host_crossing("kv-evict-gather"):
            hosts = gather_to_host(self.paged, [page for _, page in cands])
        moved: list[tuple[bytes, int]] = []       # (key, gather row)
        placed: list[tuple[int, int]] = []        # (device page, host page)
        for r, (key, page) in enumerate(cands):
            try:
                host_page = self._host_kv.alloc()
            except AllocationError:
                # Host tier full: drop its LRU entry; none (the tier is
                # smaller than this batch) drops this entry outright.
                if self._prefix.pop_lru_host() is None:
                    self._prefix.drop(key)
                    continue
                host_page = self._host_kv.alloc()
            self._host_kv.write(host_page, *(t[:, r] for t in hosts))
            self._prefix.mark_host(key, host_page)
            moved.append((key, r))
            placed.append((page, host_page))
        if self._kv_state is not None:
            whole = [t[:, [r for _, r in moved]] for t in hosts]
        if placed and self._leader is not None:
            # Each follower copies its own shard of the same pages into the
            # same host rows; no collective, so it rides with the next
            # record that issues one, ahead of any write to those pages.
            # With the state dir it goes now, and every rank hands its
            # shard of the batch to the leader's whole pages.
            spill = lockstep.Record("spill", (*(list(x) for x in zip(*placed)),
                                              self._kv_state is not None))
            if self._kv_state is None:
                self._leader.queue(spill)
            else:
                with lockstep.dispatch(self._leader, spill):
                    whole = lockstep.gather_pages(self.mesh, whole)
        if moved:
            self.metrics.on_kv_evict(len(moved))
            if self.timeline is not None:
                self.timeline.note("kv_evict", pages=len(moved))
            if self._kv_state is not None:
                k, v, ks, vs = (whole + [None, None])[:4]
                self._kv_state.save_batch([key for key, _ in moved], k, v, ks, vs)
                self._kv_gc_countdown -= 1
                if self._kv_gc_countdown <= 0:
                    self._kv_state.gc(self._host_kv.capacity)
                    self._kv_gc_countdown = 16
        return len(moved)

    def _fail_pending(self, message: str) -> None:
        try:
            while True:
                self._submit.get_nowait().out.put(("error", message))
        except queue.Empty:
            pass

    def _fail_all(self, message: str) -> None:
        with self._fail_lock:
            self._inflight_q.clear()   # unprocessed blocks: their streams fail
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    # polylint: disable=CL004(the lock only serializes the engine and supervisor threads failing the same slots; requests' out queues are unbounded, so put never waits, and the spill's os.path.join computes a path)
                    self._finish(i, error=message)
            self._fail_pending(message)
