"""Ulysses attention: head-split sequence parallelism through all-to-all
(the reference's ops/ulysses_attention.py).

One tiled all-to-all over the `sp` axis turns each rank's sequence chunk
[B, T/sp, H, D] into a head chunk over the whole sequence [B, T, H/sp, D];
each rank then runs the plain attention (ops/attention.py) for its heads,
and a second all-to-all restores the sequence chunks. Heads go out in
contiguous chunks, so a rank's q heads keep their GQA groups over its k
heads. Two exchanges a layer against the ring's sp - 1; the better trade
when the heads cover the axis and T fits one rank at H/sp heads.

Masking is by absolute position: the positions are all-gathered in rank
order, the order the exchange reassembles the sequence in. Gradients run
back through the inverse exchanges (parallel/collectives.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import all_to_all, gather_from
from .attention import attention


def ulysses_attention(
    q: torch.Tensor,             # [B, T_local, Hq, D] sequence chunk
    k: torch.Tensor,             # [B, T_local, Hk, D]
    v: torch.Tensor,
    q_positions: torch.Tensor,   # [B, T_local] absolute positions
    kv_positions: torch.Tensor,  # [B, T_local]
    *,
    mesh,
    axis_name: str = "sp",
    scale: float,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One rank's Ulysses attention over the `axis_name` axis of `mesh`.
    Requires Hq % sp == 0 and Hk % sp == 0 (this rank's head counts, i.e.
    after any tp split)."""
    axis_size = mesh.shape[axis_name]
    Hq, Hk = q.shape[2], k.shape[2]
    if Hq % axis_size or Hk % axis_size:
        raise ValueError(
            f"Ulysses needs head counts divisible by the sp axis: "
            f"Hq={Hq}, Hk={Hk}, sp={axis_size} (use ring attention instead)"
        )
    # sequence chunks -> head chunks over the whole sequence: [B, T, H/sp, D]
    q, k, v = (all_to_all(t, mesh, axis_name, split_dim=2, concat_dim=1) for t in (q, k, v))
    with torch.no_grad():
        q_pos = gather_from(q_positions, mesh, axis_name, dim=1)
        kv_pos = gather_from(kv_positions, mesh, axis_name, dim=1)
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]                  # [B, T, T]
    if window is not None and window > 0:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    ctx = attention(q, k, v, mask, scale=scale, logit_softcap=logit_softcap)
    # head chunks -> sequence chunks: [B, T_local, Hq, D]
    return all_to_all(ctx, mesh, axis_name, split_dim=1, concat_dim=2)


def ulysses_attention_spmd(
    q: torch.Tensor,             # this rank's [B/dp, T/sp, Hq/tp, D]
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    mesh,
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    seq_axis: str = "sp",
) -> torch.Tensor:
    """The reference's wrapper, on a rank's shards as they already lie (the
    same contract as ring_attention_spmd)."""
    return ulysses_attention(q, k, v, q_positions, kv_positions, mesh=mesh,
                             axis_name=seq_axis, scale=scale,
                             logit_softcap=logit_softcap, window=window)
