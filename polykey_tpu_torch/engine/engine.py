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
  true key counts on the device.
- RNG: every sampled draw is keyed by (request seed, token position)
  (engine/sampling.py), so a seeded stream does not depend on the batch.
- int8 KV (`kv_dtype="int8"`, POLYKEY_KV_DTYPE=int8): int8 value pools
  plus bf16 scale pools; rows quantize as they are written and
  dequantize as attention reads them, through the int8 kernels in both
  dispatch modes (flash still serves the bucketed prefill, over a window
  dequantized to bf16).

Not ported yet (ROADMAP.md queue A): a CUDA graph of the ragged
dispatch, the prefix cache, speculative decoding.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig, get_config
from ..models.transformer import forward_paged, forward_ragged, init_params, unembed
from ..ops import (
    flash_attention,
    paged_attention_kernel,
    paged_write_kernel,
    ragged_paged_attention_kernel,
)
from ..ops.ragged_paged_attention_kernel import TOKEN_TILE, ragged_work
from .config import EngineConfig
from .graphs import CudaGraphs
from .kv_cache import AllocationError, BlockAllocator, PagedKV, init_paged_kv
from .metrics import EngineMetrics, RequestTimings
from .sampling import sample_tail
from .tokenizer import load_tokenizer

_MAX_PREFILL_GROUP = 8   # burst admissions batched per prefill dispatch
_GROUP_PADS = (1, 2, 4, 8)

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


@dataclass
class _Slot:
    request: GenRequest
    pages: list[int]
    table: np.ndarray              # [P] int32 page table
    seed_row: np.ndarray           # [2] int32 seed halves
    prompt_len: int
    position_cap: int              # absolute position limit
    prompt_ids: Optional[np.ndarray] = None   # until the prefill dispatch
    # Chunked / ragged prefill: the prompt's ids while any are left to
    # prefill, and how many already are (`pending is None` once merged).
    pending: Optional[np.ndarray] = None
    filled: int = 0
    generated: int = 0
    merged: bool = False           # device lane activated
    last_emit: float = 0.0
    # The merged prefill's first token on its way to host memory, until
    # delivered.
    first: Optional["_FirstToken"] = None


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
    """One dispatched-but-unprocessed decode block (or ragged dispatch) of
    the lookahead pipeline: its packed [K, B] tokens on their way to host
    memory (`host`, landed once `event` has fired; no event on the CPU,
    where the block ran in the call), the request in each slot at dispatch time, and its
    dispatch sequence number: at process time, the engine's
    `_dispatch_seq - seq` is the OBSERVED lookahead, the blocks dispatched
    after this one before its readback."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    reqs: list
    seq: int


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
    """The engine cannot take work."""


class EngineOverloadedError(RuntimeError):
    """Admission shed this request (queue bound)."""

    def __init__(self, message: str, retry_after_ms: int = 100):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


def _prefill_fn(
    params, cfg: ModelConfig, paged: PagedKV,
    tokens, start, last_rel, page_table, seeds, temperature, top_p, top_k,
    *, greedy: bool, aligned: bool,
):
    """Prefill N windows (tokens [N, T]) at absolute positions
    start[i]..start[i]+T-1 and sample from each hidden state at relative
    index last_rel[i]; the draw is keyed by the sampled token's position.
    Padded tail positions write KV that is masked or later overwritten;
    padded group rows point their whole table at the garbage page.
    `aligned` is the caller's host-side knowledge that every start and T
    are multiples of the page size (the page-granular KV write)."""
    N, T = tokens.shape
    positions = (
        start[:, None] + torch.arange(T, dtype=torch.int32, device=tokens.device)
    ).to(torch.int32)
    hidden, paged = forward_paged(
        params, cfg, tokens, positions, paged, page_table, aligned=aligned
    )
    last = hidden[torch.arange(N, device=tokens.device), last_rel.long()]
    logits = unembed(params, cfg, last)
    token = sample_tail(
        logits, seeds, start + last_rel + 1, temperature, top_p, top_k, greedy
    )
    return token, paged


def _decode_fn(
    params, cfg: ModelConfig, paged: PagedKV,
    last_tokens, seq_lens, page_tables, active, caps, seeds, temperature,
    top_p, top_k,
    *, greedy: bool, steps: int, eos_id: int,
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
    """
    last, seq, act = last_tokens, seq_lens, active
    packed = []
    for _ in range(steps):
        positions = torch.clamp(seq - 1, min=0)[:, None]
        hidden, paged = forward_paged(
            params, cfg, last[:, None], positions, paged, page_tables
        )
        logits = unembed(params, cfg, hidden[:, 0])
        tokens = sample_tail(logits, seeds, seq, temperature, top_p, top_k, greedy)
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
    *, greedy: bool, eos_id: int, work=None,
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
    ranges. Returns (packed, tokens, seq_lens, active, first, paged)."""
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
        rng_starts, rng_lens, rng_kv, seq_tables, work=work,
    )
    logits = unembed(params, cfg, hidden[:B])
    dec = sample_tail(logits, seeds, seq_lens, temperature, top_p, top_k, greedy)
    dec = torch.where(active, dec, torch.zeros_like(dec))
    new_seq = seq_lens + active.to(torch.int32)
    cont = active & (dec != eos_id) & (new_seq < caps)
    packed = torch.where(active, dec, torch.full_like(dec, -1))[None, :]
    rows = hidden[B + torch.clamp(pre_sample_idx, 0, W - 1).long()]
    first = sample_tail(
        unembed(params, cfg, rows), pre_seeds, pre_sample_pos, pre_temp,
        pre_top_p, pre_top_k, greedy,
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
) -> None:
    """Activate ONE decode lane on the device, in place: splice the
    prefill's sampled token (still a device tensor) and the slot's
    geometry into the lane state. The lane is born live only if its first
    token is not EOS and the position budget allows generation."""
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


def _retire_lane_fn(state: dict, slot: int) -> None:
    """Deactivate ONE lane on the device and point its page table at the
    reserved garbage page, so later blocks stop writing through a table
    whose pages went back to the allocator."""
    state["last_tokens"][slot] = 0
    state["seq_lens"][slot] = 0
    state["page_tables"][slot] = 0
    state["active"][slot] = False
    state["caps"][slot] = 0


class InferenceEngine:
    def __init__(
        self,
        config: EngineConfig,
        params: Optional[dict] = None,
        device=None,
        health=None,
        logger=None,
        seed: int = 0,
    ):
        config.validate()
        self.config = config
        self.device = resolve_device(device)
        self.model_cfg = get_config(config.model)
        self.tokenizer = load_tokenizer(config.tokenizer)
        self.metrics = EngineMetrics()
        self.health = health
        self.logger = logger
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self._dtype = _DTYPES[config.dtype]
        pool_dtype = _DTYPES.get(config.kv_dtype, self._dtype)
        self._seed_rng = np.random.default_rng(seed + 3)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.model_cfg, self._dtype, self.device, gen)
        self.params = params
        B, P = config.max_decode_slots, config.pages_per_seq
        self.paged = init_paged_kv(
            self.model_cfg, config.num_pages, config.page_size,
            pool_dtype, self.device,
            kv_dtype=torch.int8 if config.kv_dtype == "int8" else None,
        )
        self.allocator = BlockAllocator(config.num_pages)

        # Host mirrors of the per-slot state the host decides on (engine
        # thread only), and the device-resident lane state the decode
        # blocks advance.
        self._seq_lens = np.zeros((B,), dtype=np.int32)
        self._caps = np.zeros((B,), dtype=np.int32)
        self._active = np.zeros((B,), dtype=bool)
        self._temperature = np.zeros((B,), dtype=np.float32)
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
        # so the whole stream (B + W rows) is a multiple of TOKEN_TILE.
        W = max(self._prefill_budget, self._chunk)
        self._ragged_width = W + (-(B + W)) % TOKEN_TILE
        self._ragged_dispatches = 0
        self._ragged_behind = 0      # dispatched with a block in flight

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
        self._graphs = CudaGraphs(self.device, bodies)

        self._submit: queue.Queue[GenRequest] = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.dead: Optional[str] = None
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

    # -- public API (any thread) -------------------------------------------

    def submit(self, request: GenRequest) -> None:
        if self.dead is not None:
            raise EngineDeadError(self.dead)
        if self._stop.is_set():
            raise EngineDeadError("engine is shut down")
        limit = self.config.max_queue_depth
        if limit > 0 and self._submit.qsize() >= limit:
            self.metrics.on_shed()
            raise EngineOverloadedError(f"submit queue full ({limit} waiting)")
        self.metrics.on_admit()
        self._submit.put(request)
        self._wake.set()
        if self.dead is not None or self._stop.is_set():
            self._fail_pending(self.dead or "engine is shut down")

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap.update({
            "model": self.model_cfg.name,
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
            "prefill_eager": self._graphs.eager["prefill"],
            "graph_pool_bytes": self._graphs.pool_bytes,
            "graph_capture_s": round(self._graphs.capture_seconds, 3),
            "first_tokens_pending": sum(
                s is not None and s.first is not None for s in self._slots),
            "prefill_budget": self._prefill_budget,
            "ragged": self._ragged,
            "kv_dtype": "int8" if self.paged.quantized else str(
                self.paged.k.dtype).removeprefix("torch."),
            "kv_pool_bytes": self.paged.nbytes,
            "kernel_launches": {
                name: k.launches for name, k in KERNELS.items()
            },
        })
        if self._ragged:
            snap["ragged_width"] = self._ragged_width
            snap["ragged_dispatches"] = self._ragged_dispatches
            snap["ragged_behind_inflight"] = self._ragged_behind
        return snap

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

    # -- engine thread ------------------------------------------------------

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                self._graphs.capture()
                self._started.set()
                while not self._stop.is_set():
                    # With live decode lanes, admissions and chunks share
                    # the per-iteration prefill budget; with none there is
                    # no stream to stall and the budget is waived.
                    decode_live = bool(self._active.any())
                    budget = self._prefill_budget if decode_live else None
                    worked, spent = self._admit(budget)
                    if not self._ragged:
                        remaining = None if budget is None else max(0, budget - spent)
                        chunked = self._advance_chunked_prefills(remaining)
                        worked = worked or chunked > 0
                        self.metrics.on_prefill_interleave(spent + chunked, decode_live)
                    # Dispatch frontier: keep up to `_depth_target` blocks
                    # in flight, the one dispatched now included.
                    dispatched = False
                    if self._active.any() or (
                        self._ragged and self._has_pending_prefill()
                    ):
                        block = self._dispatch_step()
                        worked = True
                        if block is not None:
                            self._inflight_q.append(block)
                            dispatched = True
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
                    if not worked:
                        self.metrics.on_dispatch_idle()
                        self._resolve_prefills(block=True)
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
            self._fail_all("engine is shut down")
        except Exception as e:  # engine thread must never die silently
            self.dead = f"engine loop crashed: {e}"
            if self.logger is not None:
                self.logger.error(
                    "engine loop crashed", error=str(e),
                    traceback=traceback.format_exc(),
                )
            self._fail_all(self.dead)
            if self.health is not None:
                self.health.shutdown()
        finally:
            self._started.set()     # also when the capture failed

    def _bucket_for(self, length: int) -> Optional[int]:
        for b in self.config.prefill_buckets:
            if length <= b:
                return b
        return None

    @staticmethod
    def _deadline_expired(request: GenRequest) -> bool:
        return request.deadline is not None and time.monotonic() >= request.deadline

    def _fail_request(self, request: GenRequest, message: str) -> None:
        request.out.put(("error", message))
        self.metrics.on_finish(request.timings, failed=True)

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
                    self.metrics.on_deadline_expired("queued")
                    self._fail_request(request, f"{DEADLINE_MSG} while queued")
                    continue
                try:
                    prep = self._prepare_request(free[0], request)
                except AllocationError:
                    # Pool exhausted: back to the front of the queue until
                    # running requests release pages (FIFO fairness).
                    self._requeue_front(request)
                    return admitted, spent
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
        """Tokenize, budget, allocate pages and register the slot; returns
        (bucket, slot_idx) for a short prompt the caller prefills in a
        group, or None for a prompt registered as pending (chunked
        prefill, or any prompt in ragged mode)."""
        cfg = self.config
        request.timings.prefill_start = time.monotonic()
        prompt_ids = self.tokenizer.encode(request.prompt)
        max_new = max(
            1, min(request.max_new_tokens, cfg.max_new_tokens_cap,
                   cfg.max_seq_len - 1),
        )
        max_prompt = cfg.max_seq_len - max_new
        if len(prompt_ids) > max_prompt:
            prompt_ids = prompt_ids[-max_prompt:]      # keep the prompt tail
        prompt_len = len(prompt_ids)
        request.timings.prompt_tokens = prompt_len
        total_len = prompt_len + max_new
        pages = self.allocator.alloc(-(-total_len // cfg.page_size))
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
        )
        self._slots[slot_idx] = slot
        ids = np.asarray(prompt_ids, dtype=np.int32)
        bucket = self._bucket_for(prompt_len)
        if self._ragged or bucket is None:
            # Ragged mode: every prompt is token ranges of the next ragged
            # dispatches. Bucketed mode: a prompt past the largest bucket
            # prefills one chunk per iteration. Either way the slot's table
            # stays off the device until its lane merges, so decode blocks
            # keep writing this lane's garbage to page 0.
            slot.pending = ids
            return None
        slot.prompt_ids = ids
        return bucket, slot_idx

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
            top_k[r] = slot.request.top_k
            seeds[r] = slot.seed_row
        ops = self._prefill_ops[n_pad]
        ops.upload(tokens, starts, last_rel, tables, seeds, temp, top_p, top_k)
        ps = cfg.page_size
        toks_dev = self._graphs.run(
            "prefill", width, n_pad, bool(np.all(temp == 0.0)),
            width % ps == 0 and not np.any(starts % ps),
        )
        _, _, _, tables_dev, seeds_dev, *_ = ops.views(width)
        return toks_dev, tables_dev, seeds_dev

    def _prefill_body(self, width: int, n_pad: int, greedy: bool,
                      aligned: bool) -> torch.Tensor:
        """The body the prefill graphs capture: `_prefill_fn` over the
        engine's weights, pools and the group pad's operand buffers. It
        touches no lane state."""
        token, self.paged = _prefill_fn(
            self.params, self.model_cfg, self.paged,
            *self._prefill_ops[n_pad].views(width), greedy=greedy, aligned=aligned,
        )
        return token

    def _dispatch_prefill_group(self, bucket: int, group: list) -> None:
        """One prefill dispatch for up to 8 same-bucket admissions, padded
        to 1, 2, 4 or 8 rows; padded rows use the garbage page. Each lane
        merges on the device; its first token is delivered later
        (`_resolve_prefills`)."""
        n = len(group)
        n_pad = next(p for p in _GROUP_PADS if p >= n)
        rows = []
        for slot_idx in group:
            slot = self._slots[slot_idx]
            rows.append((slot, slot.prompt_ids, 0))
            slot.prompt_ids = None
        try:
            toks_dev, tables, seeds = self._run_prefill(rows, bucket, n_pad)
        except Exception as e:
            # Contain the failure to this group: every member is registered
            # and must be finished, or its pages leak and its client hangs.
            for slot_idx in group:
                self._finish(slot_idx, error=f"prefill failed: {e}")
            return
        self.metrics.on_padding_tokens(n_pad * bucket, sum(len(ids) for _, ids, _ in rows))
        for r, slot_idx in enumerate(group):
            self._merge_slot(slot_idx, toks_dev, r, tables[r], seeds[r])
        self._await_first_tokens(toks_dev, list(zip(group, range(n))))

    def _merge_slot(self, slot_idx: int, toks_dev, row: int, table_row, seed_row) -> None:
        """Activate the slot's lane on the device from row `row` of the
        sampled tokens; `table_row` and `seed_row` are the device copies
        the dispatch read (no upload here)."""
        slot = self._slots[slot_idx]
        request = slot.request
        _merge_lane_fn(
            self._dev, slot_idx, toks_dev, row, slot.prompt_len + 1,
            slot.position_cap, float(request.temperature),
            float(request.top_p), int(request.top_k), table_row, seed_row,
            eos_id=self.tokenizer.eos_id,
        )
        slot.merged = True
        slot.pending = None
        self._seq_lens[slot_idx] = slot.prompt_len + 1
        self._caps[slot_idx] = slot.position_cap
        self._active[slot_idx] = True
        self._temperature[slot_idx] = request.temperature

    def _await_first_tokens(self, toks_dev: torch.Tensor, rows: list):
        """Start the copy of merged lanes' sampled tokens to host memory
        and give each (slot, row) of `rows` its handle; returns the copy's
        (host tensor, event). In stream order right behind the merges and
        before any other replay: the tokens may live in a graph's memory
        (engine/graphs.py). Depth 1 reads them at once."""
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
        if first.event is not None:
            first.event.synchronize()
        token = int(first.host[first.row])
        slot.generated = 1
        request.timings.first_token = time.monotonic()
        slot.last_emit = request.timings.first_token
        request.out.put(("token", token))
        self._maybe_finish(slot_idx, token)

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
            if s is None or s.pending is None:
                continue
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
        except Exception as e:
            self._finish(slot_idx, error=f"prefill failed: {e}")
            return 0
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
        the stream width is spent; the first range always goes. Returns
        [(slot_idx, slot, take)]."""
        W = self._ragged_width
        budget = min(self._prefill_budget, W) if self._active.any() else W
        ranges: list = []
        spent = 0
        B = len(self._slots)
        starved = None
        for i in self._chunk_rr.scan(B):
            s = self._slots[i]
            if s is None or s.pending is None:
                continue
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
        off = 0
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
                smp_top_k[i] = s.request.top_k
            off += take
        return ops, off

    def _dispatch_ragged(self, ranges: list) -> Optional[_InflightBlock]:
        """One flat mixed prefill+decode dispatch of `ranges` plus every
        decode lane's single token, without waiting for it or for the
        blocks in flight: final-range slots merge on the device and get
        their first-token handles, and the decode lanes' packed [1, B] row
        comes back as an in-flight block. Returns None when the dispatch
        failed (its ranged slots are finished, the lanes are untouched)."""
        cfg = self.config
        W = self._ragged_width
        B = cfg.max_decode_slots
        ops, useful = self._ragged_prefill_operands(ranges, W)
        act = self._active
        lanes = int(act.sum())
        smp_temp = ops[11]
        greedy = bool(np.all(self._temperature[act] == 0.0)) and bool(
            np.all(smp_temp == 0.0))
        # The kernel's work list from host values. With blocks in flight
        # the host's lengths lag the device's, so decode lanes count the
        # steps in flight on top, capped at their caps: an estimate that
        # sizes the splits and orders the CTAs; the kernel reads the true
        # key counts on the device.
        mc = self.model_cfg
        ahead = sum(blk.host.shape[0] for blk in self._inflight_q)
        kv_est = np.where(act, np.minimum(self._seq_lens + ahead, self._caps),
                          self._seq_lens)
        work = ragged_work(
            np.concatenate([np.arange(B), B + ops[4]]),
            np.concatenate([np.ones(B, np.int32), ops[5]]),
            np.concatenate([np.maximum(kv_est, 1), ops[6]]),
            B + W, mc.num_heads // mc.num_kv_heads, mc.num_kv_heads, "cpu",
        )
        *ops_dev, items = _to_device([*ops, work.items.numpy()], self.device)
        work = dataclasses.replace(work, items=items)
        self._depth_target = self._depth
        self.metrics.on_dispatch(lanes, 1, slots=B)
        self.metrics.on_padding_tokens(W, useful)
        self.metrics.on_prefill_interleave(useful, lanes > 0)
        dev = self._dev
        try:
            packed_dev, last, seq, active, first_dev, self.paged = _ragged_fn(
                self.params, mc, self.paged,
                dev["last_tokens"], dev["seq_lens"], dev["page_tables"],
                dev["active"], dev["caps"], dev["seeds"], dev["temperature"],
                dev["top_p"], dev["top_k"], *ops_dev,
                greedy=greedy, eos_id=self.tokenizer.eos_id, work=work,
            )
        except Exception as e:
            # Contained to the ranged slots, as a failed prefill group is;
            # the decode lanes' state was not advanced.
            for i, s, _take in ranges:
                if self._slots[i] is s:
                    self._finish(i, error=f"prefill failed: {e}")
            return None
        # In place: the decode graphs captured these buffers.
        dev["last_tokens"].copy_(last)
        dev["seq_lens"].copy_(seq)
        dev["active"].copy_(active)
        self._ragged_dispatches += 1
        self._ragged_behind += bool(self._inflight_q)
        self._dispatch_seq += 1
        reqs = self._snapshot_requests()
        pre_tables, smp_seeds = ops_dev[3], ops_dev[10]
        finals = []
        for i, s, take in ranges:
            if s.filled + take >= len(s.pending):
                self._merge_slot(i, first_dev, i, pre_tables[i], smp_seeds[i])
                finals.append(i)
            else:
                s.filled += take
        # One copy to host memory: the packed decode row, then the first
        # tokens (slot i's at B + i).
        host, event = self._await_first_tokens(
            torch.cat([packed_dev.reshape(-1), first_dev]), [(i, B + i) for i in finals])
        return _InflightBlock(host[:B].view(1, B), event, reqs, self._dispatch_seq)

    def _dispatch_step(self) -> Optional[_InflightBlock]:
        """Dispatch one decode block, or in ragged mode with pending
        prefill work one ragged dispatch, without waiting for it or for
        the blocks in flight; returns its in-flight record, or None when
        there was nothing to dispatch."""
        if self._ragged and self._has_pending_prefill():
            ranges = self._build_ragged_batch()
            block = self._dispatch_ragged(ranges) if ranges else None
            if block is not None or not self._active.any():
                return block
        act = self._active
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
        self.metrics.on_dispatch(lanes, steps, slots=len(self._slots))
        packed = self._graphs.run("decode", greedy, steps)
        host, event = self._copy_to_host(packed)
        self._dispatch_seq += 1
        return _InflightBlock(host, event, self._snapshot_requests(), self._dispatch_seq)

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
        )

    @staticmethod
    def _copy_to_host(packed: torch.Tensor):
        """Start the tokens' copy to host memory (pinned, non-blocking);
        returns (host tensor, CUDA event that fires when it has landed). On
        the CPU the tensor itself is the host copy and there is no event."""
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
        if not any(s is not None and s.request is block.reqs[i]
                   for i, s in enumerate(self._slots)):
            # Dead block: every dispatch-time occupant is gone; nothing to
            # emit, so nothing is read (no stall).
            self.metrics.on_process_block(lookahead, None)
            return
        t_sync = time.monotonic()
        # First tokens queued ahead of this block land no later than it:
        # deliver them before waiting for it, not after.
        self._resolve_prefills(ahead_of=block.seq)
        if block.event is not None:
            block.event.synchronize()
        packed = block.host.numpy()
        self.metrics.on_process_block(lookahead, (time.monotonic() - t_sync) * 1e3)
        self._emit_block(packed, block.reqs)

    def _emit_block(self, packed: np.ndarray, reqs: list) -> None:
        """Emit a block's packed [K, B] tokens to the requests that held
        their slots at dispatch (`reqs`) and finish streams on the host.
        The block's own K, not the configured one: the adaptive block
        varies it."""
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
            for k in range(packed.shape[0]):
                token = int(packed[k, i])
                if token < 0:
                    break
                slot.generated += 1
                self._seq_lens[i] += 1
                slot.request.out.put(("token", token))
                emitted += 1
                self._maybe_finish(i, token)
                if self._slots[i] is None:
                    break
            n = slot.generated - before
            if n > 0:
                now = time.monotonic()
                self.metrics.on_itl((now - slot.last_emit) * 1e3 / n, n)
                slot.last_emit = now
        self.metrics.on_step(emitted)

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
        self.allocator.release_all(slot.pages)
        self._slots[slot_idx] = None
        self._active[slot_idx] = False
        self._seq_lens[slot_idx] = 0
        self._caps[slot_idx] = 0
        self._temperature[slot_idx] = 0.0
        if slot.merged and self.dead is None:
            _retire_lane_fn(self._dev, slot_idx)
        if error is not None:
            self._fail_request(request, error)
        else:
            request.out.put(("done", request.timings))
            self.metrics.on_finish(request.timings)

    def _fail_pending(self, message: str) -> None:
        try:
            while True:
                self._submit.get_nowait().out.put(("error", message))
        except queue.Empty:
            pass

    def _fail_all(self, message: str) -> None:
        self._inflight_q.clear()   # unprocessed blocks: their streams fail
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._finish(i, error=message)
        self._fail_pending(message)
