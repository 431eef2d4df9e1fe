"""Ragged paged attention (the reference's
ops/ragged_paged_attention_kernel.py): one call attends a flat token stream
of decode singles and prefill chunks, each sequence over its own paged KV.

Sequence s owns rows [seq_starts[s], seq_starts[s] + seq_lens[s]) of
q [T, Hq, D] and attends over its KV positions [0, kv_lens[s]) through
page_tables[s]; the query position of row r is
kv_lens[s] - seq_lens[s] + (r - seq_starts[s]). Causal masking inside the
new tokens, GQA, logit soft-capping and a sliding window. The output is
normalized, and rows outside every range (padding, empty ranges, ranges
that start past the stream) are exactly 0.

The kernel (csrc/ragged_paged_attention.cu, pk_ragged_attention) takes a
work list that the host builds from the ranges (`ragged_work`): tiles of
64 / G query tokens per (sequence, kv head), longest first; a long decode
single split into shares of SPLIT_ROWS keys (a prefill tile only when the
stream is too small to fill the card), whose partial states the last share
to finish merges inside the same launch, on counters from
`arrival_counters`. On a CUDA tensor the kernel runs or the call raises;
`ragged_attention_plain` computes the same function in plain PyTorch, one
sequence at a time, and runs only for CPU tensors, as the comparison in
tests and chip_smoke.py, and under POLYKEY_DISABLE_RAGGED_KERNEL=1, the
reference's kill switch (off by default).

int8 KV: the pools come as (values, scales) pairs and go to the int8
instance of the same kernel template (pk_ragged_attention_int8, launch
count `KERNEL_INT8`): the same work list, one launch, the merge inside it;
the int8 rows are taken exactly into bf16 tiles in shared memory, the K
scale multiplies each logit and the V scale folds into each probability.
The plain version dequantizes in fp32, k8 * ks. Only
POLYKEY_DISABLE_RAGGED_KERNEL gates it, as in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ._build import F, I, P, Kernel, check_cuda_tensor
from .paged_attention_kernel import (
    arrival_counters, check_kv_pools, gather_pages_f32, pool_values,
)

# q, pools, ranges, items, out, the split scratch and its counters; int8
# with the scale pools after the value pools.
KERNEL = Kernel("pk_ragged_attention", [P] * 12 + [I] * 7 + [F, F, I])
KERNEL_INT8 = Kernel("pk_ragged_attention_int8", [P] * 14 + [I] * 7 + [F, F, I])

# Flat streams must be a multiple of this many rows. Load-bearing beyond
# this module: the engine pads its ragged stream width against it.
TOKEN_TILE = 8

RAGGED_HEAD_DIMS = frozenset({64, 128, 256})
RAGGED_GROUPS = frozenset({1, 2, 4, 8})   # query heads per kv head
TILE_ROWS = 64        # query-head rows per CTA: 64 / G tokens x G heads
# Visible keys per split of a decode single (a 1-token item), so a long
# context spreads over CTAs: of 128..2048, 512 was fastest on an H100 for
# the 16 singles of chip_smoke.py's main case alone, and within 8% of the
# best with its prefill chunks (PERF.md, section 6). A prefill tile, which
# already does 64 / G tokens' work per key, splits only in a stream of too
# few CTAs to fill half the card's SMs (CARD_SMS, an H100 SXM's 132), and
# then as a single does.
SPLIT_ROWS = 512
CARD_SMS = 132
_NEG_INF = -1e30


def _window_int(window) -> int:
    return 0 if window is None else int(window)


def use_ragged_kernel() -> bool:
    """POLYKEY_DISABLE_RAGGED_KERNEL=1 is the operational kill switch: the
    ragged kernel is its own code, so a fault there can be contained
    without taking the decode kernel down (the plain version serves)."""
    return os.environ.get("POLYKEY_DISABLE_RAGGED_KERNEL", "").lower() not in (
        "1", "true"
    )


@dataclass
class RaggedWork:
    """The kernel's work list on the device: `items` are [n, 6] int32 rows
    (sequence, first stream row, row count, split, split count, partial
    slot); the `n_part` partial slots hold the splits' states, which both
    kernels merge in their launch (an item of n splits owns slots
    [part, part + n)). `gaps` are the stream's row ranges [lo, hi) outside
    every item, which the wrapper zero-fills (the kernels write every row of
    every item)."""

    items: torch.Tensor
    n_part: int
    gaps: tuple


def ragged_work(seq_starts, seq_lens, kv_lens, T: int, groups: int, kv_heads: int,
                device) -> RaggedWork:
    """Cut the ranges (host values: sequences, lists or numpy arrays) into
    the kernel's items, ordered by visible keys per CTA, longest first
    (ties in stream order; a split item's shares stay together). `kv_lens`
    sizes the splits and the order only; the kernel reads the true KV
    lengths on the device, so an estimate is never wrong, at worst slower.
    Every row of every range must be covered, so the starts and lengths
    must be the ones the kernel is given.

    Over a tp mesh `kv_heads` is a rank's own count (Hk / tp): the CTA
    count, and with it the choice to split, depends on it, so a rank's
    list differs from the full-width one. The mesh engine cuts it once,
    on the leader, and the ragged dispatch's record carries it to the
    followers (engine.InferenceEngine._ragged_device): every rank launches
    the same list, built from the leader's host lengths."""
    if groups not in RAGGED_GROUPS:
        raise ValueError(f"ragged kernel: Hq / Hk = {groups} not in {sorted(RAGGED_GROUPS)}")
    tq = TILE_ROWS // groups
    tiles = []      # (sequence, first row, rows, keys its last row sees)
    for s, (start, length, kv) in enumerate(zip(
            np.asarray(seq_starts).tolist(), np.asarray(seq_lens).tolist(),
            np.asarray(kv_lens).tolist())):
        end = min(start + length, T)
        for row0 in range(max(start, 0), end, tq):
            n = min(tq, end - row0)
            tiles.append((s, row0, n, kv - length + (row0 - start) + n))

    def nsplit(n, visible, cut_prefill):
        return max(1, -(-visible // SPLIT_ROWS)) if n == 1 or cut_prefill else 1

    ctas = kv_heads * sum(nsplit(n, vis, False) for _, _, n, vis in tiles)
    cut = 2 * ctas < CARD_SMS
    ranked = []
    n_part = 0
    for s, row0, n, visible in tiles:
        ns = nsplit(n, visible, cut)
        if ns == 1:
            rows = [(s, row0, n, 0, 1, 0)]
        else:
            rows = [(s, row0, n, j, ns, n_part) for j in range(ns)]
            n_part += ns
        ranked.append((-(-visible // ns), rows))
    ranked.sort(key=lambda r: -r[0])
    items = [row for _, rows in ranked for row in rows]
    gaps, at = [], 0
    for _, row0, n, _ in sorted(tiles, key=lambda tile: tile[1]):
        if row0 > at:
            gaps.append((at, row0))
        at = max(at, row0 + n)
    if at < T:
        gaps.append((at, T))

    rows = torch.from_numpy(np.asarray(items, dtype=np.int32).reshape(-1, 6))
    return RaggedWork(rows.to(device), n_part, tuple(gaps))


def ragged_scratch(n_part: int, Hk: int, D: int, device) -> tuple:
    """The split items' fp32 state, acc [n_part, Hk, 64, D] and (m, l)
    [n_part, Hk, 64, 2]. Uninitialized: a split writes its rows' state
    before any merge reads it."""
    f32 = dict(dtype=torch.float32, device=device)
    n = max(n_part, 1)
    return (torch.empty((n, Hk, TILE_ROWS, D), **f32),
            torch.empty((n, Hk, TILE_ROWS, 2), **f32))


def ragged_attention_plain(
    q: torch.Tensor,             # [T, Hq, D]
    k_pages,                     # [N, ps, Hk, D], or an int8 (values, scales) pair
    v_pages,
    page_tables: torch.Tensor,   # [S, P] int32
    seq_starts: torch.Tensor,    # [S] int32
    seq_lens: torch.Tensor,      # [S] int32
    kv_lens: torch.Tensor,       # [S] int32
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch; returns normalized fp32
    [T, Hq, D]. Per sequence: gather its window [0, kv_len) once and attend
    its rows, so memory grows with one window, not with one window per
    token. Reads the range metadata on the host."""
    T, Hq, D = q.shape
    _, ps, Hk, _ = pool_values(k_pages).shape
    P_ = page_tables.shape[1]
    G = Hq // Hk
    w = _window_int(window)
    out = torch.zeros((T, Hq, D), dtype=torch.float32, device=q.device)
    for s, (start, length, kv) in enumerate(zip(
            seq_starts.tolist(), seq_lens.tolist(), kv_lens.tolist())):
        first, end = max(start, 0), min(start + length, T)
        pages = min(-(-kv // ps), P_)
        if end <= first or pages <= 0:
            continue
        n, S = end - first, pages * ps
        idx = page_tables[s, :pages].long()
        k = gather_pages_f32(k_pages, idx).flatten(0, 1)
        v = gather_pages_f32(v_pages, idx).flatten(0, 1)
        kv_pos = torch.arange(S, device=q.device)
        # Rows at or past kv_len were never written: zero them, so stale
        # NaN cannot reach a sum through a probability of 0.
        v = torch.where((kv_pos < kv)[:, None, None], v, torch.zeros_like(v))
        q_pos = kv - length + torch.arange(first - start, end - start, device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]                  # [n, S]
        if w > 0:
            mask &= kv_pos[None, :] > q_pos[:, None] - w
        qs = q[first:end].float().reshape(n, Hk, G, D)
        logits = torch.einsum("thgd,shd->hgts", qs, k) * scale
        if logit_softcap is not None:
            logits = logit_softcap * torch.tanh(logits / logit_softcap)
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("hgts,shd->hgtd", p, v) / torch.clamp(l, min=1e-9)
        out[first:end] = o.permute(2, 0, 1, 3).reshape(n, Hq, D)
    return out


def ragged_attention_cuda(
    q, k_pages, v_pages, page_tables, seq_starts, seq_lens, kv_lens, *,
    scale, logit_softcap=None, window=None, work: Optional[RaggedWork] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel (the int8 one for (values, scales) pairs);
    returns normalized fp32 [T, Hq, D]. Without a `work` list it builds one
    from the range metadata, which reads it on the host (a device sync).
    Raises on anything the kernel does not take."""
    T, Hq, D = q.shape
    pools, int8 = check_kv_pools("ragged kernel", k_pages, v_pages)
    N, ps, Hk, Dk = pools[0].shape
    S, P_ = page_tables.shape
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    check_cuda_tensor("page_tables", page_tables, torch.int32, 2)
    for name, t in (("seq_starts", seq_starts), ("seq_lens", seq_lens),
                    ("kv_lens", kv_lens)):
        check_cuda_tensor(name, t, torch.int32, 1)
        if t.shape[0] != S:
            raise ValueError(f"ragged kernel: {name} has {t.shape[0]} rows, tables {S}")
    if D not in RAGGED_HEAD_DIMS or Dk != D:
        raise ValueError(
            f"ragged kernel: head_dim {D} (pools {tuple(pools[0].shape)}) "
            f"not in {sorted(RAGGED_HEAD_DIMS)}"
        )
    if Hq % Hk or Hq // Hk not in RAGGED_GROUPS:
        raise ValueError(
            f"ragged kernel: Hq={Hq}, Hk={Hk} needs Hq / Hk in {sorted(RAGGED_GROUPS)}"
        )
    for name, t in (("q", q), ("k_pages", pools[0]), ("v_pages", pools[1])):
        if t.data_ptr() % 16:
            raise ValueError(f"ragged kernel: {name} is not 16-byte aligned")
    # The int8 kernel copies each scale as the aligned 4-byte word holding it.
    for name, t in zip(("k_scales", "v_scales"), pools[2:]):
        if t.data_ptr() % 4:
            raise ValueError(f"ragged kernel: {name} is not 4-byte aligned")
    if work is None:
        work = ragged_work(seq_starts.cpu(), seq_lens.cpu(), kv_lens.cpu(), T,
                           Hq // Hk, Hk, q.device)
    check_cuda_tensor("work.items", work.items, torch.int32, 2)
    out = torch.empty((T, Hq, D), dtype=torch.float32, device=q.device)
    for lo, hi in work.gaps:
        out[lo:hi].zero_()
    n_items = work.items.shape[0]
    if n_items == 0:
        return out
    scratch = ragged_scratch(work.n_part, Hk, D, q.device)
    counters = arrival_counters(max(work.n_part, 1) * Hk, q.device)
    (KERNEL_INT8 if int8 else KERNEL)(
        q, *pools, page_tables, seq_starts, seq_lens, kv_lens, work.items, out,
        *scratch, counters, n_items, T, Hq, Hk, D, ps, P_, float(scale),
        float(logit_softcap or 0.0), _window_int(window))
    return out


def ragged_gather_attention(
    q: torch.Tensor,             # [T, Hq, D]
    k_pages,                     # [N, ps, Hk, D], or an int8 (values, scales) pair
    v_pages,
    token_tables: torch.Tensor,  # [T, P] int32, each token's table row
    q_positions: torch.Tensor,   # [T] int32 absolute positions
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
) -> torch.Tensor:
    """The reference's per-token gather: one batch row per token through
    paged_attention. Every token materializes its whole window, so it is a
    test oracle at small sizes, never a serving path."""
    from .paged_attention import paged_attention

    out = paged_attention(
        q[:, None], k_pages, v_pages, token_tables,
        q_positions[:, None].to(torch.int32),
        scale=scale, logit_softcap=logit_softcap, window=window,
    )
    return out[:, 0]


def ragged_paged_attention(
    q: torch.Tensor,             # [T, Hq, D] flat token stream (tile-padded)
    k_pages,                     # [N, ps, Hk, D], or an int8 (values, scales) pair
    v_pages,
    page_tables: torch.Tensor,   # [S, P] int32 per-sequence tables
    seq_starts: torch.Tensor,    # [S] int32 row range starts (ascending)
    seq_lens: torch.Tensor,      # [S] int32 new-token counts
    kv_lens: torch.Tensor,       # [S] int32 KV lengths (new tokens incl.)
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
    token_tile: int = TOKEN_TILE,
    work: Optional[RaggedWork] = None,
) -> torch.Tensor:
    """Ragged paged attention over the flat stream; returns [T, Hq, D] in
    q's dtype. `work` is the kernel's work list (`ragged_work`), built by a
    caller that knows the ranges on the host; the plain path ignores it."""
    T = q.shape[0]
    if T % token_tile:
        raise ValueError(
            f"ragged token stream T={T} must be a multiple of "
            f"token_tile={token_tile} (the engine pads the stream)"
        )
    args = (q.contiguous(), k_pages, v_pages, page_tables.to(torch.int32).contiguous(),
            *(t.to(torch.int32).contiguous() for t in (seq_starts, seq_lens, kv_lens)))
    kw = dict(scale=scale, logit_softcap=logit_softcap, window=window)
    if q.device.type == "cuda" and use_ragged_kernel():
        out = ragged_attention_cuda(*args, work=work, **kw)
    else:
        out = ragged_attention_plain(*args, **kw)
    return out.to(q.dtype)
