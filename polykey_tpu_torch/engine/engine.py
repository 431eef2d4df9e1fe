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
  merged into the device-resident lane state (`_merge_lane_fn`).
- Decode: one dispatch runs `decode_block_steps` steps for the whole batch
  with device-side EOS/cap liveness (`_decode_fn`) and returns one packed
  [K, B] token array (-1 where a lane emitted nothing), read once per
  block. This port runs the exact-sync mode (lookahead depth 1): each
  block is read before the next is dispatched.
- RNG: every sampled draw is keyed by (request seed, token position)
  (engine/sampling.py), so a seeded stream does not depend on the batch.

Not ported yet (ROADMAP.md queue A): chunked prefill of prompts longer than
the largest bucket (such a request ends with an error naming it), the
lookahead pipeline, ragged dispatch, prefix cache, speculative decoding.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig, get_config
from ..models.transformer import forward_paged, init_params, unembed
from ..ops import flash_attention, paged_attention_kernel, paged_write_kernel
from .config import EngineConfig
from .kv_cache import AllocationError, BlockAllocator, PagedKV, init_paged_kv
from .metrics import EngineMetrics, RequestTimings
from .sampling import sample_tail
from .tokenizer import load_tokenizer

_MAX_PREFILL_GROUP = 8   # burst admissions batched per prefill dispatch

# Error-message prefix contract with the gateway: engine failures that
# begin with this map to gRPC DEADLINE_EXCEEDED (torch_service).
DEADLINE_MSG = "deadline exceeded"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# The kernels of the serving path, by name, for stats and chip_smoke.py.
KERNELS = {
    "flash_attention": flash_attention.KERNEL,
    "paged_attention_decode": paged_attention_kernel.KERNEL,
    "paged_write": paged_write_kernel.KERNEL,
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
    generated: int = 0
    merged: bool = False           # device lane activated
    last_emit: float = 0.0


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
    cap, mirroring the host's _maybe_finish. Returns (packed [steps, B]
    int32 with -1 where a lane emitted nothing, last, seq, active, paged).
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
    return torch.stack(packed), last, seq, act, paged


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
        )
        self.allocator = BlockAllocator(config.num_pages)

        # Host mirrors of the per-slot state the host decides on (engine
        # thread only), and the device-resident lane state the decode
        # blocks advance.
        self._seq_lens = np.zeros((B,), dtype=np.int32)
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

        self._submit: queue.Queue[GenRequest] = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.dead: Optional[str] = None
        self._thread = threading.Thread(
            target=self._run, name="polykey-engine", daemon=True
        )
        self._thread.start()

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
            "lookahead_depth": 1,
            "kernel_launches": {
                name: k.launches for name, k in KERNELS.items()
            },
        })
        return snap

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
                while not self._stop.is_set():
                    worked = self._admit()
                    if self._active.any():
                        self._process_step(self._dispatch_step())
                        worked = True
                    if not worked:
                        self.metrics.on_dispatch_idle()
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

    def _admit(self) -> bool:
        """Admit waiting requests into free slots; prefill them in
        per-bucket groups. Returns whether any request was taken."""
        admitted = False
        groups: dict[int, list] = {}
        try:
            while True:
                free = [i for i, s in enumerate(self._slots) if s is None]
                if not free:
                    return admitted
                try:
                    request = self._submit.get_nowait()
                except queue.Empty:
                    return admitted
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
                    return admitted
                if prep is None:
                    continue
                bucket = prep[0]
                groups.setdefault(bucket, []).append(prep[1])
                if len(groups[bucket]) >= _MAX_PREFILL_GROUP:
                    self._dispatch_prefill_group(bucket, groups.pop(bucket))
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
        (bucket, slot_idx) or None when the request was refused."""
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
        bucket = self._bucket_for(prompt_len)
        if bucket is None:
            self._fail_request(
                request,
                f"prompt of {prompt_len} tokens exceeds the largest prefill "
                f"bucket ({max(cfg.prefill_buckets)}): chunked prefill is "
                "not ported to polykey_tpu_torch yet (ROADMAP.md queue A)",
            )
            return None
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
        self._slots[slot_idx] = _Slot(
            request=request, pages=pages, table=table, seed_row=seed_row,
            prompt_len=prompt_len, position_cap=total_len,
            prompt_ids=np.asarray(prompt_ids, dtype=np.int32),
        )
        return bucket, slot_idx

    def _dispatch_prefill_group(self, bucket: int, group: list) -> None:
        """One prefill dispatch for up to 8 same-bucket admissions, padded
        to 1, 2, 4 or 8 rows; padded rows use the garbage page."""
        n = len(group)
        n_pad = 1 if n == 1 else 2 if n == 2 else 4 if n <= 4 else 8
        cfg = self.config
        tokens = np.zeros((n_pad, bucket), dtype=np.int32)
        last_rel = np.zeros((n_pad,), dtype=np.int32)
        tables = np.zeros((n_pad, cfg.pages_per_seq), dtype=np.int32)
        temp = np.zeros((n_pad,), dtype=np.float32)
        top_p = np.ones((n_pad,), dtype=np.float32)
        top_k = np.zeros((n_pad,), dtype=np.int32)
        seeds = np.zeros((n_pad, 2), dtype=np.int32)
        useful = 0
        for r, slot_idx in enumerate(group):
            slot = self._slots[slot_idx]
            ids, slot.prompt_ids = slot.prompt_ids, None
            tokens[r, : len(ids)] = ids
            last_rel[r] = len(ids) - 1
            tables[r] = slot.table
            temp[r] = slot.request.temperature
            top_p[r] = slot.request.top_p
            top_k[r] = slot.request.top_k
            seeds[r] = slot.seed_row
            useful += len(ids)
        greedy = bool(np.all(temp == 0.0))
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        try:
            toks_dev, self.paged = _prefill_fn(
                self.params, self.model_cfg, self.paged,
                put(tokens), torch.zeros(n_pad, dtype=torch.int32, device=dev),
                put(last_rel), put(tables), put(seeds), put(temp), put(top_p),
                put(top_k), greedy=greedy,
                # Every window starts at position 0.
                aligned=bucket % cfg.page_size == 0,
            )
        except Exception as e:
            # Contain the failure to this group: every member is registered
            # and must be finished, or its pages leak and its client hangs.
            for slot_idx in group:
                self._finish(slot_idx, error=f"prefill failed: {e}")
            return
        self.metrics.on_padding_tokens(n_pad * bucket, useful)
        for r, slot_idx in enumerate(group):
            self._merge_slot(slot_idx, toks_dev, r)
        first = toks_dev.cpu().numpy()
        for r, slot_idx in enumerate(group):
            self._resolve_slot(slot_idx, int(first[r]))

    def _merge_slot(self, slot_idx: int, toks_dev, row: int) -> None:
        slot = self._slots[slot_idx]
        request = slot.request
        _merge_lane_fn(
            self._dev, slot_idx, toks_dev, row, slot.prompt_len + 1,
            slot.position_cap, float(request.temperature),
            float(request.top_p), int(request.top_k),
            torch.from_numpy(slot.table).to(self.device),
            torch.from_numpy(slot.seed_row).to(self.device),
            eos_id=self.tokenizer.eos_id,
        )
        slot.merged = True
        self._seq_lens[slot_idx] = slot.prompt_len + 1
        self._active[slot_idx] = True
        self._temperature[slot_idx] = request.temperature

    def _resolve_slot(self, slot_idx: int, token: int) -> None:
        """Deliver the first token to the client."""
        slot = self._slots[slot_idx]
        slot.generated = 1
        request = slot.request
        request.timings.first_token = time.monotonic()
        slot.last_emit = request.timings.first_token
        request.out.put(("token", token))
        self._maybe_finish(slot_idx, token)

    def _dispatch_step(self) -> torch.Tensor:
        """Run one decode block; returns its packed [K, B] device tensor.
        At lookahead depth 1 it is read before anything else changes the
        slots, so no per-block request snapshot is needed."""
        dev = self._dev
        act = self._active
        greedy = bool(np.all(self._temperature[act] == 0.0))
        steps = self.config.decode_block_steps
        self.metrics.on_dispatch(int(act.sum()), steps, slots=len(self._slots))
        packed, last, seq, active, self.paged = _decode_fn(
            self.params, self.model_cfg, self.paged,
            dev["last_tokens"], dev["seq_lens"], dev["page_tables"],
            dev["active"], dev["caps"], dev["seeds"], dev["temperature"],
            dev["top_p"], dev["top_k"],
            greedy=greedy, steps=steps, eos_id=self.tokenizer.eos_id,
        )
        dev["last_tokens"], dev["seq_lens"], dev["active"] = last, seq, active
        return packed

    def _process_step(self, packed_dev: torch.Tensor) -> None:
        """Read a block's packed tokens and emit/finish on the host."""
        t_sync = time.monotonic()
        packed = packed_dev.cpu().numpy()              # [K, B]; waits for the block
        self.metrics.on_process_block(0, (time.monotonic() - t_sync) * 1e3)
        emitted = 0
        for i, slot in enumerate(self._slots):
            if slot is None or not self._active[i]:
                continue
            if slot.request.cancelled.is_set():
                self._finish(i, error="cancelled")
                continue
            if self._deadline_expired(slot.request):
                self.metrics.on_deadline_expired("decode")
                self._finish(i, error=f"{DEADLINE_MSG} mid-decode")
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
        request.timings.finished = time.monotonic()
        request.timings.completion_tokens = slot.generated
        self.allocator.release_all(slot.pages)
        self._slots[slot_idx] = None
        self._active[slot_idx] = False
        self._seq_lens[slot_idx] = 0
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
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._finish(i, error=message)
        self._fail_pending(message)
