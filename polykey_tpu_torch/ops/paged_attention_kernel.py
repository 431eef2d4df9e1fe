"""Paged decode attention (the reference's ops/paged_attention_kernel.py):
one query token per sequence over its own KV pages.

The kernel (csrc/paged_attention_decode.cu) reads only the pages a
sequence owns, [lo, hi) from its position and sliding window, clipped to a
page sub-range [rlo, rhi), and returns UNNORMALIZED online-softmax state
(acc [B, Hq, D] f32, m and l [B, Hq, 1] f32); `paged_attention_decode`
normalizes. The context splits over CTAs of SPLIT_ROWS rows whose partial
states a second launch merges (the wrapper allocates their scratch). On a
CUDA tensor the kernel runs or the call raises;
`paged_decode_plain` computes the same function in plain PyTorch and runs
only for CPU tensors and as the comparison in tests and chip_smoke.py.
POLYKEY_DISABLE_PAGED_KERNEL=1 is the reference's kill switch (off by
default): it routes decode through the gather path, ops/paged_attention.py.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ._build import F, I, P, Kernel, check_cuda_tensor

KERNEL = Kernel(
    "pk_paged_decode",
    [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, I, I, I, I, I],
)

DECODE_HEAD_DIMS = frozenset({64, 128, 256})
DECODE_GROUPS = frozenset({1, 2, 4, 8})   # query heads per kv head
# KV rows per split CTA (split-KV over the context). Of 64..1024 rows,
# 256 was fastest on an H100 at B=16 for contexts of 128, 512 and 1..4096.
SPLIT_ROWS = 256
MAX_SPLIT_PAGES = 64
_NEG_INF = -1e30


def _window_int(window) -> int:
    return 0 if window is None else int(window)


def paged_decode_plain(
    q: torch.Tensor,             # [B, Hq, D]
    k_pages: torch.Tensor,       # [N, ps, Hk, D]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,   # [B, P] int32
    positions: torch.Tensor,     # [B] int32
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
    page_range: Optional[tuple[int, int]] = None,
):
    """(acc, m, l) over the pages in `page_range` ([0, P) by default), the
    kernel's contract: rows outside [lo, hi) ∩ [rlo, rhi) or masked by
    position/window contribute nothing, m starts at -1e30."""
    B, Hq, D = q.shape
    _, ps, Hk, _ = k_pages.shape
    P_ = page_tables.shape[1]
    rlo, rhi = page_range if page_range is not None else (0, P_)
    G = Hq // Hk
    S = P_ * ps
    k = k_pages[page_tables.long()].reshape(B, S, Hk, D).float()
    v = v_pages[page_tables.long()].reshape(B, S, Hk, D).float()
    kv_pos = torch.arange(S, device=q.device)[None, :]           # [1, S]
    pos = positions.reshape(B, 1).long()
    valid = (kv_pos <= pos) & (kv_pos >= rlo * ps) & (kv_pos < rhi * ps)
    w = _window_int(window)
    if w > 0:
        valid &= kv_pos > pos - w
    qg = q.reshape(B, Hk, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, _NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG_INF)
    p = torch.where(vmask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    v = torch.where(valid[:, :, None, None], v, torch.zeros_like(v))
    acc = torch.einsum("bhgs,bshd->bhgd", p, v)
    return (
        acc.reshape(B, Hq, D), m.reshape(B, Hq, 1), l.reshape(B, Hq, 1),
    )


def paged_decode_cuda(
    q, k_pages, v_pages, page_tables, positions, *, scale,
    logit_softcap=None, window=None, page_range=None,
):
    """Launch the CUDA kernel; returns (acc, m, l). Raises on anything the
    kernel does not take."""
    B, Hq, D = q.shape
    N, ps, Hk, Dk = k_pages.shape
    P_ = page_tables.shape[1]
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    check_cuda_tensor("k_pages", k_pages, torch.bfloat16, 4)
    check_cuda_tensor("v_pages", v_pages, torch.bfloat16, 4)
    check_cuda_tensor("page_tables", page_tables, torch.int32, 2)
    check_cuda_tensor("positions", positions, torch.int32, 1)
    if D not in DECODE_HEAD_DIMS or Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged decode kernel: head_dim {D} (pools {tuple(k_pages.shape)}) "
            f"not in {sorted(DECODE_HEAD_DIMS)}"
        )
    if Hq % Hk or Hq // Hk not in DECODE_GROUPS:
        raise ValueError(
            f"paged decode kernel: Hq={Hq}, Hk={Hk} needs Hq / Hk in "
            f"{sorted(DECODE_GROUPS)}"
        )
    if page_tables.shape[0] != B or positions.shape[0] != B:
        raise ValueError("paged decode kernel: batch sizes disagree")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged decode kernel: {name} is not 16-byte aligned")
    rlo, rhi = page_range if page_range is not None else (0, P_)
    if not 0 <= rlo <= rhi <= P_:
        raise ValueError(f"paged decode kernel: page range [{rlo}, {rhi}) of {P_}")
    split_pages = max(1, min(MAX_SPLIT_PAGES, SPLIT_ROWS // ps))
    nsplit = max(1, -(-(rhi - rlo) // split_pages))
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Hq, D), **f32)
    m = torch.empty((B, Hq, 1), **f32)
    l = torch.empty((B, Hq, 1), **f32)
    # Per-split state, merged by the kernel's second launch.
    parts = (
        (torch.empty((B, Hq, nsplit, D), **f32), torch.empty((B, Hq, nsplit), **f32),
         torch.empty((B, Hq, nsplit), **f32))
        if nsplit > 1 else (acc, m, l)
    )
    KERNEL(
        q, k_pages, v_pages, page_tables, positions, acc, m, l, *parts,
        B, Hq, Hk, D, ps, P_, float(scale), float(logit_softcap or 0.0),
        _window_int(window), int(rlo), int(rhi), split_pages, nsplit,
    )
    return acc, m, l


def use_paged_kernel() -> bool:
    """POLYKEY_DISABLE_PAGED_KERNEL=1 is the operational kill switch."""
    return os.environ.get("POLYKEY_DISABLE_PAGED_KERNEL", "").lower() not in (
        "1", "true"
    )


def paged_attention_decode(
    q: torch.Tensor,             # [B, 1, Hq, D]
    k_pages: torch.Tensor,       # [N, ps, Hk, D]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,   # [B, P]
    q_positions: torch.Tensor,   # [B, 1]
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
) -> torch.Tensor:
    """Decode-step paged attention; returns [B, 1, Hq, D]."""
    if not use_paged_kernel():
        from .paged_attention import paged_attention

        return paged_attention(
            q, k_pages, v_pages, page_tables, q_positions,
            scale=scale, logit_softcap=logit_softcap, window=window,
        )
    B = q.shape[0]
    op = paged_decode_cuda if q.device.type == "cuda" else paged_decode_plain
    acc, _, l = op(
        q[:, 0].contiguous(), k_pages, v_pages,
        page_tables.to(torch.int32).contiguous(),
        q_positions.reshape(B).to(torch.int32).contiguous(),
        scale=scale, logit_softcap=logit_softcap, window=window,
    )
    out = acc / torch.clamp(l, min=1e-9)
    return out.to(q.dtype)[:, None]
