"""Speculative decoding: the acceptance math and draft/verify generation
over a contiguous cache (the reference's models/speculative.py).

A draft model proposes gamma tokens; the target scores them in one
forward over gamma + 1 positions. Sampled rows accept draft x with
probability min(1, p_t(x) / p_d(x)) and, at the first rejection, draw the
extra token from the normalized residual max(p_t - p_d, 0) [Leviathan et
al. 2023], so the output follows the target's distribution. The serving
path (engine/spec_decode.py) and `speculative_generate` here use both.

`speculative_generate` has `models.generate.generate`'s contract: greedy
output is exactly the target's greedy decode for any draft; sampled
output follows target-only sampling at the temperature. top_p and top_k
are refused (truncation breaks the residual identity). KV caches hold
slot s for position s, so KV written for rejected drafts is overwritten
before any query attends it; the last window may draft gamma positions
past the last token, so the cache must hold them (`index_put_` raises on
a position past it).
"""

from __future__ import annotations

import torch

from ..engine.sampling import ACCEPT_TAG, DRAFT_TAG, EXTRA_TAG, SamplingParams, TaggedDraws, sample
from .config import ModelConfig
from .generate import row_seeds
from .transformer import forward, init_cache, unembed


def _token_probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """[..., V] fp32 probabilities at the temperature."""
    return torch.softmax(logits / max(temperature, 1e-6), dim=-1)


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


@torch.inference_mode()
def speculative_generate(target_params: dict, target_cfg: ModelConfig, draft_params: dict,
                         draft_cfg: ModelConfig, tokens: torch.Tensor,
                         seq_lens: torch.Tensor, seed: int, sampling: SamplingParams,
                         max_len: int, gamma: int = 4, eos_id: int = -1,
                         return_stats: bool = False) -> tuple:
    """Draft/verify generation with `generate`'s contract: returns
    (generated [B, max_new_tokens] int32, num_generated [B]), and with
    `return_stats` the accepted and proposed drafts (0-d int32 tensors)
    after them. Stats count only the drafts that could be emitted (each
    round clipped by the row's remaining budget), so a perfect draft reads
    exactly 1.0. Rounds run while a row is not done (one host read of the
    done flags a round), at most max_new_tokens of them."""
    B, T = tokens.shape
    max_new = sampling.max_new_tokens
    greedy = sampling.is_greedy
    if sampling.top_k > 0 or sampling.top_p < 1.0:
        raise ValueError(
            "speculative_generate supports greedy and plain-temperature "
            "sampling only: top_k/top_p truncation breaks the rejection-"
            "sampling residual identity (output would not match target-only "
            "sampling). Filter-free SamplingParams required."
        )
    if T + max_new + gamma > max_len:
        raise ValueError(
            f"cache too small: prompt window {T} + max_new_tokens {max_new} "
            f"+ gamma {gamma} exceeds max_len {max_len}"
        )
    dev = tokens.device
    i32 = torch.int32
    t_cache = init_cache(target_cfg, B, max_len, target_params["embed"].dtype, dev)
    d_cache = init_cache(draft_cfg, B, max_len, draft_params["embed"].dtype, dev)
    rows = torch.arange(B, device=dev)
    offsets = torch.arange(gamma + 1, dtype=i32, device=dev)[None, :]
    seeds = row_seeds(seed, B, dev)
    draws = TaggedDraws(seeds)
    temp = sampling.temperature

    # Prefill both models; the first token is the target's.
    positions = torch.arange(T, dtype=i32, device=dev).expand(B, T)
    t_hidden, _ = forward(target_params, target_cfg, tokens, positions, t_cache)
    forward(draft_params, draft_cfg, tokens, positions, d_cache)
    t_logits = unembed(target_params, target_cfg, t_hidden[rows, (seq_lens - 1).long()])
    first = sample(t_logits, seeds, seq_lens, sampling)

    # One spare column takes the writes past max_new (the reference drops
    # them); it is cut off at the end.
    out = torch.full((B, max_new + 1), eos_id, dtype=i32, device=dev)
    out[:, 0] = first
    counts = torch.ones(B, dtype=i32, device=dev)
    done = first == eos_id
    prev, pos = first, seq_lens.to(i32)
    acc_total = torch.zeros((), dtype=i32, device=dev)
    prop_total = torch.zeros((), dtype=i32, device=dev)
    for _ in range(max_new):
        if bool(done.all()):
            break
        # Draft gamma tokens, one T=1 step each.
        tok, p = prev, pos
        drafts, dists = [], []
        for _ in range(gamma):
            hidden, _ = forward(draft_params, draft_cfg, tok[:, None], p[:, None], d_cache)
            logits = unembed(draft_params, draft_cfg, hidden[:, 0])
            if greedy:
                nxt = torch.argmax(logits, dim=-1).to(i32)
            else:
                dists.append(_token_probs(logits, temp))
                nxt = draws.categorical(p + 1, DRAFT_TAG, logits / temp)
            drafts.append(nxt)
            tok, p = nxt, p + 1
        drafts = torch.stack(drafts, dim=1)

        # Verify: one target forward over [prev, drafts]; then the draft's
        # cache over the same window, so on full acceptance the last
        # draft's slot holds its KV.
        window = torch.cat([prev[:, None], drafts], dim=1)
        w_pos = pos[:, None] + offsets
        t_hidden, _ = forward(target_params, target_cfg, window, w_pos, t_cache)
        t_logits = unembed(target_params, target_cfg, t_hidden)
        forward(draft_params, draft_cfg, window, w_pos, d_cache)

        if greedy:
            t_choice = torch.argmax(t_logits, dim=-1).to(i32)
            accept = drafts == t_choice[:, :gamma]
            n_acc = torch.cumprod(accept.to(i32), dim=1).sum(dim=1)
            extra = t_choice[rows, n_acc]
        else:
            t_probs = _token_probs(t_logits, temp)
            d_dists = torch.stack(dists, dim=1)
            u = draws.uniform(pos[:, None] + 1 + offsets[:, :gamma], ACCEPT_TAG)
            accept = rejection_accept(t_probs, d_dists, drafts, u)
            n_acc = torch.cumprod(accept.to(i32), dim=1).sum(dim=1)
            dist = residual_extra_dist(t_probs, d_dists, n_acc)
            extra = draws.categorical(pos + 1 + n_acc, EXTRA_TAG,
                                      torch.log(torch.clamp(dist, min=1e-20)))

        # Emit the accepted drafts and the extra token.
        emit = torch.cat([drafts, torch.zeros((B, 1), dtype=i32, device=dev)], dim=1)
        emit = emit.scatter(1, n_acc.long()[:, None], extra.to(i32)[:, None])
        n_out = n_acc + 1
        new_counts = counts
        eos_seen = torch.zeros_like(done)
        for j in range(gamma + 1):
            tok_j = emit[:, j]
            valid = (j < n_out) & ~done & ~eos_seen
            idx = torch.where(valid, torch.clamp(counts + j, max=max_new),
                              torch.full_like(counts, max_new))
            out.scatter_(1, idx.long()[:, None], tok_j[:, None])
            new_counts = new_counts + (idx < max_new).to(i32)
            eos_seen = eos_seen | (valid & (tok_j == eos_id))
        new_done = done | eos_seen | (new_counts >= max_new)
        prev = out[rows, torch.clamp(new_counts - 1, 0, max_new - 1).long()]
        emitted = new_counts - counts
        pos = pos + torch.where(done, torch.zeros_like(emitted), emitted)

        live = (~done).to(i32)
        budget = torch.clamp(max_new - counts, min=0)
        acc_total = acc_total + (live * torch.minimum(n_acc.to(i32), budget)).sum().to(i32)
        prop_total = prop_total + (live * torch.clamp(budget, max=gamma)).sum().to(i32)
        counts, done = new_counts, new_done
    out = out[:, :max_new]
    if return_stats:
        return out, counts, acc_total, prop_total
    return out, counts
