"""Paged KV write for a decode step (the reference's
ops/paged_write_kernel.py): each lane's new K/V row lands at
(page_tables[b, pos // ps], pos % ps) of the pools, IN PLACE.

The reference's JAX version is functional (pools donated and aliased);
here the pools are updated in place and returned, which is what the
donation achieved without a copy. On a CUDA tensor the CUDA kernel
(csrc/paged_write.cu) runs or the call raises; `paged_write_decode_plain`
runs only for CPU tensors and as the comparison in tests and
chip_smoke.py.

int8 KV: for (values, scales) pool pairs the rows quantize on the way in
(`quantize_kv_rows`, per (row, head): absmax over D, a bf16 scale, round
half to even) and land in four pools, int8 k and v plus their bf16
scales. On a CUDA tensor the quantizing instance of the same kernel
template (csrc/paged_write.cu, its own launch count `KERNEL_INT8`) does all
of it in one launch; `paged_write_int8_plain` is its plain version, bit for
bit the same (a head holding a NaN gets a NaN scale in both).
"""

from __future__ import annotations

import torch

from ._build import I, P, Kernel, check_cuda_tensor
from .paged_attention_kernel import check_kv_pools

KERNEL = Kernel("pk_paged_write", [P, P, P, P, P, P, I, I, I, I])
KERNEL_INT8 = Kernel("pk_paged_write_int8", [P, P, P, P, P, P, P, P, I, I, I, I, I])


def _slots(page_tables: torch.Tensor, positions: torch.Tensor, ps: int):
    """(page_ids [B], offsets [B]) of each lane's single new row; the page
    index clamps to the table like a gather."""
    B, P_ = page_tables.shape
    pos = positions.reshape(B).long()
    pidx = torch.clamp(pos // ps, 0, P_ - 1)
    page_ids = page_tables[torch.arange(B, device=pos.device), pidx].long()
    return page_ids, pos % ps


def paged_write_decode_plain(
    k_pages: torch.Tensor,       # [N, ps, Hk, D]
    v_pages: torch.Tensor,
    k_new: torch.Tensor,         # [B, 1, Hk, D]
    v_new: torch.Tensor,
    page_tables: torch.Tensor,   # [B, P] int32
    positions: torch.Tensor,     # [B, 1] int32
):
    page_ids, offsets = _slots(page_tables, positions, k_pages.shape[1])
    k_pages[page_ids, offsets] = k_new[:, 0].to(k_pages.dtype)
    v_pages[page_ids, offsets] = v_new[:, 0].to(v_pages.dtype)
    return k_pages, v_pages


def paged_write_decode_cuda(k_pages, v_pages, k_new, v_new, page_tables, positions):
    N, ps, Hk, D = k_pages.shape
    B, P_ = page_tables.shape
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        check_cuda_tensor(name, t, k_pages.dtype, 4)
    if v_pages.shape != k_pages.shape:
        raise ValueError("paged write kernel: k and v pools differ in shape")
    k_rows = k_new.to(k_pages.dtype).contiguous()
    v_rows = v_new.to(v_pages.dtype).contiguous()
    if tuple(k_rows.shape) != (B, 1, Hk, D) or v_rows.shape != k_rows.shape:
        raise ValueError(
            f"paged write kernel: rows must be [{B}, 1, {Hk}, {D}], got "
            f"{tuple(k_new.shape)} / {tuple(v_new.shape)}"
        )
    check_cuda_tensor("k_new", k_rows)
    check_cuda_tensor("v_new", v_rows)
    check_cuda_tensor("page_tables", page_tables, torch.int32, 2)
    pos = positions.reshape(B)
    check_cuda_tensor("positions", pos, torch.int32, 1)
    row_bytes = Hk * D * k_pages.element_size()
    if row_bytes % 16:
        raise ValueError(
            f"paged write kernel: a row of {row_bytes} bytes is not a whole "
            "number of 16-byte vectors"
        )
    if any(t.data_ptr() % 16 for t in (k_pages, v_pages, k_rows, v_rows)):
        raise ValueError("paged write kernel: pools and rows must be 16-byte aligned")
    KERNEL(k_pages, v_pages, k_rows, v_rows, page_tables, pos, B, P_, ps, row_bytes)
    return k_pages, v_pages


def paged_write_int8_plain(
    k_pages,                     # (values [N, ps, Hk, D] int8, scales [N, ps, Hk] bf16)
    v_pages,
    k_new: torch.Tensor,         # [B, 1, Hk, D]
    v_new: torch.Tensor,
    page_tables: torch.Tensor,   # [B, P] int32
    positions: torch.Tensor,     # [B, 1] int32
):
    from .paged_attention import quantize_kv_rows

    (kq, ks), (vq, vs) = k_pages, v_pages
    page_ids, offsets = _slots(page_tables, positions, kq.shape[1])
    for (values, scales), rows in (((kq, ks), k_new), ((vq, vs), v_new)):
        q8, sc = quantize_kv_rows(rows[:, 0])
        values[page_ids, offsets] = q8
        scales[page_ids, offsets] = sc
    return k_pages, v_pages


def paged_write_int8_cuda(k_pages, v_pages, k_new, v_new, page_tables, positions):
    """Quantize and write one bf16 row per lane in one launch. Any Hk and D
    (the kernel picks each lane's vector width from D and the alignment of
    the rows and pools, down to single values, so no row needs to be a
    whole number of 16-byte vectors)."""
    pools, int8 = check_kv_pools("paged write int8 kernel", k_pages, v_pages)
    if not int8:
        raise ValueError("paged write int8 kernel: pools must be (values, scales) pairs")
    N, ps, Hk, D = pools[0].shape
    B, P_ = page_tables.shape
    k_rows, v_rows = k_new.contiguous(), v_new.contiguous()
    if tuple(k_rows.shape) != (B, 1, Hk, D) or v_rows.shape != k_rows.shape:
        raise ValueError(
            f"paged write int8 kernel: rows must be [{B}, 1, {Hk}, {D}], got "
            f"{tuple(k_new.shape)} / {tuple(v_new.shape)}"
        )
    check_cuda_tensor("k_new", k_rows, torch.bfloat16)
    check_cuda_tensor("v_new", v_rows, torch.bfloat16)
    check_cuda_tensor("page_tables", page_tables, torch.int32, 2)
    pos = positions.reshape(B)
    check_cuda_tensor("positions", pos, torch.int32, 1)
    KERNEL_INT8(*pools, k_rows, v_rows, page_tables, pos, B, P_, ps, Hk, D)
    return k_pages, v_pages


def paged_write_decode(k_pages, v_pages, k_new, v_new, page_tables, positions):
    """Write one new row per lane into the pools in place; returns them.
    int8 pools come as (values, scales) pairs and quantize the rows."""
    if isinstance(k_pages, tuple):
        op = (paged_write_int8_cuda if k_pages[0].device.type == "cuda"
              else paged_write_int8_plain)
        return op(k_pages, v_pages, k_new, v_new, page_tables, positions)
    if k_pages.device.type == "cuda":
        return paged_write_decode_cuda(
            k_pages, v_pages, k_new, v_new, page_tables, positions
        )
    return paged_write_decode_plain(
        k_pages, v_pages, k_new, v_new, page_tables, positions
    )
