"""Reference attention in plain PyTorch — the correctness oracle for the
flash kernel (ops/flash_attention.py) and the path for shapes too small
for it, as ops/attention.py is in the reference.

GQA, causal masking by absolute position, attention-logit soft-capping and
sliding windows. Logits and softmax run in fp32 whatever the input dtype;
probabilities are rounded to V's dtype before the PV product, as the
reference does.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_attention_mask(
    q_positions: torch.Tensor,    # [B, T] absolute position of each query
    num_kv_slots: int,            # S — slot s holds the token at position s
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Boolean [B, T, S] mask: True where the query may attend."""
    kv_pos = torch.arange(
        num_kv_slots, dtype=torch.int32, device=q_positions.device
    )[None, None, :]
    q_pos = q_positions[:, :, None]
    mask = kv_pos <= q_pos
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    return mask


def attention(
    q: torch.Tensor,              # [B, T, Hq, D]
    k: torch.Tensor,              # [B, S, Hk, D]
    v: torch.Tensor,              # [B, S, Hk, D]
    mask: torch.Tensor,           # [B, T, S] bool
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention; returns [B, T, Hq, D] in q's dtype."""
    B, T, Hq, D = q.shape
    Hk = k.shape[2]
    groups = Hq // Hk
    qg = q.reshape(B, T, Hk, groups, D).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    neg = torch.finfo(torch.float32).min
    logits = torch.where(mask[:, None, None, :, :], logits, neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)
