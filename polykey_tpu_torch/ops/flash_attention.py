"""Flash attention for prefill: blockwise online softmax over a contiguous
KV window (the reference's ops/flash_attention.py).

`flash_attention` keeps the reference's contract and dispatch policy:
masks come from absolute query positions (padding rows carry -1), and the
kernel serves the shapes where not materializing the [T, S] logits matters
(`use_flash`: T >= 128, S >= 128, head_dim in {64, 128, 256}); other
shapes take the plain masked attention, as they do in the reference. On a CUDA tensor that passes the
gate the CUDA kernel (csrc/flash_attention.cu) runs or the call raises;
the plain version (`flash_attention_plain`) runs only for CPU tensors and
as the comparison in tests and chip_smoke.py. POLYKEY_DISABLE_FLASH=1 is
the reference's kill switch and is off by default.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ._build import F, I, P, Kernel, check_cuda_tensor
from .attention import attention, make_attention_mask

KERNEL = Kernel(
    "pk_flash_attention",
    [P, P, P, P, P, I, I, I, I, I, I, F, F, I],
)

# Head dims the kernel is instantiated for (the served families use these).
FLASH_HEAD_DIMS = frozenset({64, 128, 256})


def use_flash(T: int, S: int, head_dim: int) -> bool:
    """Dispatch policy, the reference's geometry gate: the kernel wins when
    the logits matrix is large enough that not materializing it matters,
    for the head dims it is instantiated for. POLYKEY_DISABLE_FLASH=1 is
    the operational kill switch (the plain path serves every shape)."""
    if os.environ.get("POLYKEY_DISABLE_FLASH", "").lower() in ("1", "true"):
        return False
    return T >= 128 and S >= 128 and head_dim in FLASH_HEAD_DIMS


def _window_int(window) -> int:
    if window is None:
        return 0
    return int(window)


def flash_attention_plain(
    q: torch.Tensor,             # [B, T, Hq, D]
    k: torch.Tensor,             # [B, S, Hk, D]
    v: torch.Tensor,
    q_positions: torch.Tensor,   # [B, T]
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,                 # int; None/<=0 → global
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: masked reference attention
    over the window, mask from positions (kv <= q, kv > q - window). A row
    that sees no key (padding, position -1) is 0, as in the kernel."""
    S = k.shape[1]
    mask = make_attention_mask(q_positions, S)
    w = _window_int(window)
    if w > 0:
        kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, None, :]
        mask &= kv_pos > q_positions[:, :, None] - w
    out = attention(q, k, v, mask, scale=scale, logit_softcap=logit_softcap)
    seen = mask.any(dim=-1)[:, :, None, None]                  # [B, T, 1, 1]
    return torch.where(seen, out, torch.zeros_like(out))


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    B, T, Hq, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(name, t, torch.bfloat16, 4)
    check_cuda_tensor("q_positions", q_positions, torch.int32, 2)
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {D} not in {sorted(FLASH_HEAD_DIMS)}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % Hk:
        raise ValueError(
            f"flash kernel: q {tuple(q.shape)} / k {tuple(k.shape)} / "
            f"v {tuple(v.shape)} do not form a GQA attention"
        )
    if tuple(q_positions.shape) != (B, T):
        raise ValueError(f"flash kernel: q_positions must be [{B}, {T}]")
    out = torch.empty_like(q)
    KERNEL(
        q, k, v, q_positions, out, B, T, S, Hq, Hk, D, float(scale),
        float(logit_softcap or 0.0), _window_int(window),
    )
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
    dispatch_T: Optional[int] = None,
) -> torch.Tensor:
    """Blockwise attention; returns [B, T, Hq, D] in q's dtype.
    `dispatch_T` is the T the gate decides on, when q is one sp rank's
    block of a longer query (the reference's shard_map decides on the
    whole window's T and then forces the kernel on each block)."""
    T, S, D = q.shape[1], k.shape[1], q.shape[3]
    if q.device.type == "cuda" and use_flash(dispatch_T or T, S, D):
        return flash_attention_cuda(
            q, k, v, q_positions.to(torch.int32).contiguous(),
            scale=scale, logit_softcap=logit_softcap, window=window,
        )
    return flash_attention_plain(
        q, k, v, q_positions, scale=scale, logit_softcap=logit_softcap,
        window=window,
    )
