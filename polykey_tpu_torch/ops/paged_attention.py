"""Paged attention: KV read and written through page-table indirection
(the reference's ops/paged_attention.py).

Page-table convention (engine/kv_cache.py): page_tables[b, j] is the page
holding positions [j*page_size, (j+1)*page_size); unused tail entries point
at the reserved garbage page 0 and are hidden by the position mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .paged_attention_kernel import use_paged_kernel
from .paged_write_kernel import paged_write_decode


def paged_gather_kv(
    k_pages: torch.Tensor,       # [num_pages, page_size, Hk, D]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,   # [B, P] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize [B, P*page_size, Hk, D] K/V windows from the pools."""
    B, P = page_tables.shape
    _, ps, Hk, D = k_pages.shape
    idx = page_tables.long()
    return (
        k_pages[idx].reshape(B, P * ps, Hk, D),
        v_pages[idx].reshape(B, P * ps, Hk, D),
    )


def paged_attention(
    q: torch.Tensor,             # [B, T, Hq, D]
    k_pages: torch.Tensor,       # [num_pages, page_size, Hk, D]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,   # [B, P]
    q_positions: torch.Tensor,   # [B, T]
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
) -> torch.Tensor:
    """Attention over paged KV; returns [B, T, Hq, D]. Slot j of the
    gathered window holds position j, so the absolute-position mask hides
    unwritten slots and garbage-page tails, and the window is a valid
    input for the flash kernel at prefill widths."""
    k, v = paged_gather_kv(k_pages, v_pages, page_tables)
    return flash_attention(
        q, k, v, q_positions,
        scale=scale, logit_softcap=logit_softcap, window=window,
    )


def positions_aligned(positions: torch.Tensor, page_size: int) -> bool:
    """Whether every row of `positions` [B, T] runs consecutively from a
    multiple of `page_size` (reads the tensor: a host-device sync)."""
    pos = positions.long()
    ar = torch.arange(pos.shape[1], device=pos.device)
    return bool(
        torch.all(pos == pos[:, :1] + ar) & torch.all(pos[:, 0] % page_size == 0)
    )


def paged_write(
    k_pages: torch.Tensor,       # [num_pages, page_size, Hk, D]
    v_pages: torch.Tensor,
    k_new: torch.Tensor,         # [B, T, Hk, D]
    v_new: torch.Tensor,
    page_tables: torch.Tensor,   # [B, P]
    positions: torch.Tensor,     # [B, T] absolute position of each token
    *,
    aligned: Optional[bool] = None,
):
    """Write new KV at (page_table[pos // ps], pos % ps), IN PLACE; returns
    the pools. Three paths, as in the reference:

    - T == 1 (decode): the paged write kernel (ops/paged_write_kernel.py),
      unless POLYKEY_DISABLE_PAGED_KERNEL=1 sends it to the token scatter
      as in the reference;
    - T > 1 with page-aligned consecutive rows (every engine prefill
      window): one page-granular scatter, T/ps page rows per lane;
    - otherwise: the per-token scatter.

    `aligned` says whether every row's positions run consecutively from a
    multiple of the page size; a caller that knows it on the host passes
    it, and None has it read from `positions` (a host-device sync).
    """
    ps = k_pages.shape[1]
    B, T = positions.shape
    P = page_tables.shape[1]
    if T == 1 and use_paged_kernel():
        return paged_write_decode(
            k_pages, v_pages, k_new, v_new, page_tables, positions
        )
    pos = positions.long()
    k_rows = k_new.to(k_pages.dtype)
    v_rows = v_new.to(v_pages.dtype)
    if T % ps == 0:
        if aligned is None:
            aligned = positions_aligned(positions, ps)
        if aligned:
            n_pg = T // ps
            first = pos[:, 0] // ps
            pg_idx = torch.clamp(
                first[:, None] + torch.arange(n_pg, device=pos.device), 0, P - 1
            )
            pg_ids = torch.gather(page_tables.long(), 1, pg_idx)   # [B, n_pg]
            shape = (B, n_pg, ps, *k_rows.shape[2:])
            k_pages[pg_ids] = k_rows.reshape(shape)
            v_pages[pg_ids] = v_rows.reshape(shape)
            return k_pages, v_pages
    bi = torch.arange(B, device=pos.device)[:, None]
    page_ids = page_tables.long()[bi, torch.clamp(pos // ps, 0, P - 1)]
    offsets = pos % ps
    k_pages[page_ids, offsets] = k_rows
    v_pages[page_ids, offsets] = v_rows
    return k_pages, v_pages
