"""Speculative decoding's acceptance math (the reference's
models/speculative.py, `rejection_accept` and `residual_extra_dist`).

A draft model proposes gamma tokens; the target scores them in one
forward over gamma + 1 positions. Sampled rows accept draft x with
probability min(1, p_t(x) / p_d(x)) and, at the first rejection, draw the
extra token from the normalized residual max(p_t - p_d, 0) [Leviathan et
al. 2023], so the output follows the target's distribution. The serving
path (engine/spec_decode.py) uses both. The reference's contiguous-cache
`speculative_generate` waits for the port's models/generate.py (ROADMAP.md
queue A).
"""

from __future__ import annotations

import torch


def rejection_accept(t_probs: torch.Tensor, d_dists: torch.Tensor,
                     drafts: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[B, gamma] bool: accept draft x with probability min(1, p_t(x) /
    p_d(x)) given uniforms `u` [B, gamma]. t_probs [B, gamma(+1), V],
    d_dists [B, gamma, V] (the distributions the drafts were drawn from),
    drafts [B, gamma]."""
    gamma = drafts.shape[1]
    idx = drafts.long()[..., None]
    p_t = torch.gather(t_probs[:, :gamma], -1, idx)[..., 0]
    p_d = torch.gather(d_dists, -1, idx)[..., 0]
    return u < torch.clamp(p_t / torch.clamp(p_d, min=1e-20), max=1.0)


def residual_extra_dist(t_probs: torch.Tensor, d_dists: torch.Tensor,
                        n_acc: torch.Tensor) -> torch.Tensor:
    """[B, V] distribution of the extra token: the normalized residual
    max(p_t - p_d, 0) at the first rejection, or the target's distribution
    at the bonus position when all gamma drafts were accepted; a residual
    of no mass falls back to the target's distribution."""
    B, g1, _ = t_probs.shape
    gamma = g1 - 1
    rows = torch.arange(B, device=t_probs.device)
    n = n_acc.long()
    p_t_x = t_probs[rows, n]
    p_d_x = d_dists[rows, torch.clamp(n, max=gamma - 1)]
    residual = torch.clamp(p_t_x - p_d_x, min=0.0)
    mass = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(mass > 1e-20, residual / torch.clamp(mass, min=1e-20), p_t_x)
    return torch.where((n == gamma)[:, None], p_t_x, residual)
