"""Ring attention: sequence-parallel attention around the sp ring (the
reference's ops/ring_attention.py).

Queries stay put; K/V chunks (with their absolute positions) rotate one
rank on around the mesh's `sp` axis, `sp - 1` times, and each rank folds
every visiting chunk into online-softmax state (running max m,
denominator l, fp32 accumulator). The full [T, S] logits never exist on
any rank. The rotation is `parallel.collectives.ring_shift` (send and
receive posted as pairs with batch_isend_irecv); autograd runs through the
per-block math and the rotation, whose backward rotates the gradients the
other way, so K/V gradients find their way home.

Masking is by absolute position, so causality does not depend on how the
sequence is laid out around the ring. Plain PyTorch: the reference's
training path runs no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import ring_shift, shift

_NEG_INF = -1e30


def _block_update(q, k, v, q_pos, kv_pos, m, l, acc, *, scale: float,
                  logit_softcap: Optional[float], window: Optional[int]):
    """Fold one K/V chunk into (m [B, Hq, T], l [B, Hq, T], acc
    [B, T, Hq, D]), all fp32. q [B, T, Hq, D]; k, v [B, S, Hk, D]."""
    B, T, Hq, D = q.shape
    Hk = k.shape[2]
    g = Hq // Hk

    qg = q.reshape(B, T, Hk, g, D).float()
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale   # [B, Hk, g, T, S]
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)

    mask = kv_pos[:, None, :] <= q_pos[:, :, None]                 # [B, T, S]
    if window is not None and window > 0:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, _NEG_INF)

    s = s.reshape(B, Hq, T, -1)
    m_new = torch.maximum(m, s.amax(dim=-1))                       # [B, Hq, T]
    # Explicit zero where masked: a fully masked chunk has s == m_new ==
    # _NEG_INF, and exp(0) would add spurious mass to l.
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask[:, None], p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = corr * l + p.sum(dim=-1)

    pv = torch.einsum("bhgts,bshd->bthgd", p.reshape(B, Hk, g, T, -1),
                      v.float()).reshape(B, T, Hq, D)
    acc_new = acc * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def ring_attention(
    q: torch.Tensor,             # [B, T_local, Hq, D]
    k: torch.Tensor,             # [B, S_local, Hk, D]
    v: torch.Tensor,
    q_positions: torch.Tensor,   # [B, T_local] absolute positions
    kv_positions: torch.Tensor,  # [B, S_local]
    *,
    mesh,
    axis_name: str = "sp",
    scale: float,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One rank's ring attention over the `axis_name` ring of `mesh`:
    (k, v, kv_positions) rotate `axis size - 1` times; returns
    [B, T_local, Hq, D] in q.dtype."""
    B, T, Hq, D = q.shape
    n = mesh.shape[axis_name]
    m = torch.full((B, Hq, T), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, T, Hq, D), dtype=torch.float32, device=q.device)
    for i in range(n):
        m, l, acc = _block_update(q, k, v, q_positions, kv_positions, m, l, acc,
                                  scale=scale, logit_softcap=logit_softcap, window=window)
        if i < n - 1:
            k, v = ring_shift((k, v), mesh, axis_name)
            (kv_positions,) = shift((kv_positions,), mesh, axis_name, +1)
    l = l.clamp_min(1e-9).transpose(1, 2)[..., None]               # [B, T, Hq, 1]
    return (acc / l).to(q.dtype)


def ring_attention_spmd(
    q: torch.Tensor,             # this rank's [B/dp, T/sp, Hq/tp, D]
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,   # [B/dp, T/sp]
    kv_positions: torch.Tensor,
    mesh,
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    seq_axis: str = "sp",
) -> torch.Tensor:
    """The reference's wrapper, on a rank's shards as they already lie
    (batch over dp, sequence over sp, heads over tp): the ring runs over
    `seq_axis`. GQA constraint: num_kv_heads divisible by tp."""
    return ring_attention(q, k, v, q_positions, kv_positions, mesh=mesh,
                          axis_name=seq_axis, scale=scale,
                          logit_softcap=logit_softcap, window=window)
