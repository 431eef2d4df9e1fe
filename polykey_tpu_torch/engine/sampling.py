"""Token sampling: greedy, temperature, top-k, top-p (the reference's
engine/sampling.py, exact full-vocab path).

Draws are keyed by (seed, position): every sampled token of a request is a
Gumbel-max over a counter-based hash of (seed, token position, vocab
index), written in torch integer ops, so a seeded stream depends only on
its own seed and positions — never on the batch it rides in or its slot —
and needs no generator state on the device. The bits differ from
jax.random's; the distribution is the same.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 32-bit values held in int64, without int64
    overflow: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply; lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_bits(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] 32-bit hashes of (seed_hi, seed_lo, position, vocab index).
    seeds [B, 2] int32 (two halves of a 64-bit seed), positions [B]."""
    dev = seeds.device
    hi = seeds[:, 0].long() & _M32
    lo = seeds[:, 1].long() & _M32
    pos = positions.long() & _M32
    key = _mix32(_mix32(hi ^ 0x9E3779B9) ^ lo)
    row = _mix32(key ^ _mix32(pos ^ 0x85EBCA6B))                 # [B]
    col = torch.arange(vocab, device=dev, dtype=torch.int64)
    return _mix32(_mix32(row[:, None] ^ col[None, :]) ^ (row[:, None] >> 7))


def gumbel_noise(seeds, positions, vocab: int) -> torch.Tensor:
    """[B, V] standard Gumbel noise, deterministic in (seed, position)."""
    bits = uniform_bits(seeds, positions, vocab)
    u = ((bits >> 8).double() + 0.5) * (1.0 / (1 << 24))       # (0, 1)
    return (-torch.log(-torch.log(u))).float()


def prefix_keep_mask(desc_probs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """THE top-p keep rule (shared with the reference): over descending
    probabilities, keep each entry whose exclusive cumulative mass is < p,
    always keeping the first."""
    keep = torch.cumsum(desc_probs, dim=-1) - desc_probs < p
    keep[..., 0] = True
    return keep


def truncation_thresholds(scaled: torch.Tensor, top_p: torch.Tensor, top_k: torch.Tensor):
    """(thr_p, thr_k) from one descending sort: keeping `scaled >= thr_p`
    realizes the top-p rule, `scaled >= thr_k` keeps the k largest (ties
    keep all equal values); top_k <= 0 disables."""
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    keep_p = prefix_keep_mask(torch.softmax(sorted_desc, dim=-1), top_p[:, None])
    inf = torch.full_like(sorted_desc, float("inf"))
    thr_p = torch.where(keep_p, sorted_desc, inf).amin(dim=-1, keepdim=True)
    kidx = torch.clamp(torch.where(top_k > 0, top_k, V) - 1, 0, V - 1)
    thr_k = torch.gather(sorted_desc, 1, kidx.long()[:, None])
    return thr_p, thr_k


def sample_tail(logits, seeds, positions, temperature, top_p, top_k, greedy: bool):
    """THE shared sampling tail for prefill and decode: greedy takes the
    argmax (no randomness); sampled rows draw independently, each keyed by
    (its seed, positions[row]). Rows with temperature 0 stay greedy."""
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy:
        return greedy_tok
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    thr_p, thr_k = truncation_thresholds(scaled, top_p, top_k)
    masked = torch.where(
        (scaled < thr_p) | (scaled < thr_k),
        torch.full_like(scaled, float("-inf")), scaled,
    )
    noise = gumbel_noise(seeds, positions, logits.shape[-1])
    sampled = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return torch.where(temperature == 0.0, greedy_tok, sampled)
