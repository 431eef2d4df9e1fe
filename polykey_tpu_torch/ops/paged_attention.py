"""Paged attention: KV read and written through page-table indirection
(the reference's ops/paged_attention.py).

Page-table convention (engine/kv_cache.py): page_tables[b, j] is the page
holding positions [j*page_size, (j+1)*page_size); unused tail entries point
at the reserved garbage page 0 and are hidden by the position mask.

int8 KV pools come as (values, scales) pairs: values [N, ps, Hk, D] int8,
scales [N, ps, Hk] bf16. Every op here dispatches on that pair form, as
the reference's do: rows quantize at write time (`quantize_kv_rows`) and
dequantize at read time (`dequantize_kv`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .paged_attention_kernel import use_paged_kernel, use_quantized_paged_kernel
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
    input for the flash kernel at prefill widths. int8 pools (pairs) are
    gathered with their scales and dequantized into q's dtype."""
    if isinstance(k_pages, tuple):
        (kq, ks_pool), (vq, vs_pool) = k_pages, v_pages
        k, v = paged_gather_kv(kq, vq, page_tables)
        B, P = page_tables.shape
        ps, Hk = kq.shape[1], kq.shape[2]
        idx = page_tables.long()
        k = dequantize_kv(k, ks_pool[idx].reshape(B, P * ps, Hk), q.dtype)
        v = dequantize_kv(v, vs_pool[idx].reshape(B, P * ps, Hk), q.dtype)
    else:
        k, v = paged_gather_kv(k_pages, v_pages, page_tables)
    return flash_attention(
        q, k, v, q_positions,
        scale=scale, logit_softcap=logit_softcap, window=window,
    )


def quantize_kv_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) int8 quantization of KV rows
    [..., Hk, D] -> (int8 values, bf16 scales [..., Hk]), bit for bit the
    reference's: absmax over D in fp32, max(absmax, 1e-8) / 127 rounded to
    bf16 (nearest even), then round(x / scale) half to even against the
    ROUNDED scale, the one dequantization multiplies by, clipped to +-127."""
    x = rows.float()
    absmax = x.abs().amax(dim=-1)
    # Divide by a device tensor, not a Python number: CUDA's division by a
    # host scalar multiplies by its reciprocal, which is not always exact.
    # torch.full fills it on the device (no host-to-device copy per call).
    div = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = (torch.clamp(absmax, min=1e-8) / div).to(torch.bfloat16)
    q = torch.clamp(torch.round(x / scale[..., None].float()), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor, dtype) -> torch.Tensor:
    """[..., Hk, D] int8 + [..., Hk] scales -> dtype, multiplied in dtype."""
    return values.to(dtype) * scales[..., None].to(dtype)


def positions_aligned(positions: torch.Tensor, page_size: int) -> bool:
    """Whether every row of `positions` [B, T] runs consecutively from a
    multiple of `page_size` (reads the tensor: a host-device sync)."""
    pos = positions.long()
    ar = torch.arange(pos.shape[1], device=pos.device)
    return bool(
        torch.all(pos == pos[:, :1] + ar) & torch.all(pos[:, 0] % page_size == 0)
    )


def paged_write(
    k_pages,                     # [num_pages, page_size, Hk, D], or a
    v_pages,                     # (values, scales) pair for int8 KV
    k_new: torch.Tensor,         # [B, T, Hk, D]
    v_new: torch.Tensor,
    page_tables: torch.Tensor,   # [B, P]
    positions: torch.Tensor,     # [B, T] absolute position of each token
    *,
    aligned: Optional[bool] = None,
):
    """Write new KV at (page_table[pos // ps], pos % ps), IN PLACE; returns
    the pools (pairs for int8 KV, whose rows quantize on the way in and
    whose scale pools take the same write path as the values). Three
    paths, as in the reference:

    - T == 1 (decode): the paged write kernel (ops/paged_write_kernel.py;
      the quantizing one for int8 pools), unless
      POLYKEY_DISABLE_PAGED_KERNEL=1 (POLYKEY_DISABLE_KV_KERNEL=1 for int8
      pools) sends it to the token scatter as in the reference;
    - T > 1 with page-aligned consecutive rows (every engine prefill
      window): one page-granular scatter, T/ps page rows per lane;
    - otherwise: the per-token scatter.

    `aligned` says whether every row's positions run consecutively from a
    multiple of the page size; a caller that knows it on the host passes
    it, and None has it read from `positions` (a host-device sync).
    """
    quantized = isinstance(k_pages, tuple)
    gate = use_quantized_paged_kernel if quantized else use_paged_kernel
    B, T = positions.shape
    if T == 1 and gate():
        return paged_write_decode(
            k_pages, v_pages, k_new, v_new, page_tables, positions
        )
    if quantized:
        (kq, ks_pool), (vq, vs_pool) = k_pages, v_pages
        k8, k_s = quantize_kv_rows(k_new)
        v8, v_s = quantize_kv_rows(v_new)
        writes = [(kq, k8), (vq, v8), (ks_pool, k_s), (vs_pool, v_s)]
    else:
        writes = [(k_pages, k_new), (v_pages, v_new)]
    ps = writes[0][0].shape[1]
    P = page_tables.shape[1]
    pos = positions.long()
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
            for pool, rows in writes:
                pool[pg_ids] = rows.to(pool.dtype).reshape(B, n_pg, ps, *rows.shape[2:])
            return k_pages, v_pages
    bi = torch.arange(B, device=pos.device)[:, None]
    page_ids = page_tables.long()[bi, torch.clamp(pos // ps, 0, P - 1)]
    offsets = pos % ps
    for pool, rows in writes:
        pool[page_ids, offsets] = rows.to(pool.dtype)
    return k_pages, v_pages
