"""Speculative decoding over the paged cache: the engine's draft/verify
round (the reference's engine/spec_decode.py, bucketed path).

A draft model with its own page pools, indexed by the same page tables,
proposes gamma tokens one T=1 step at a time (the paged decode and write
kernels); the target scores [last token, drafts] in one forward over
gamma + 1 positions; the draft's pools are then rewritten over the same
window, so on full acceptance slot pos + gamma holds the last draft's KV.
Position p always maps to the same slot (page_tables[p // page_size],
p % page_size), so KV written for rejected drafts is overwritten by the
next window's own writes before any query attends it: the window starts
at the accepted frontier and spans gamma + 1 positions. The engine
reserves `gamma_max` positions of page slack per request, so the last
window's overdraft lands in the request's own pages.

The round runs on the device from end to end: acceptance (exact argmax
match for greedy rows, rejection sampling for sampled rows, both over the
top-p / top-k truncated distributions when `candidates` > 0), the extra
token, EOS and cap truncation, the lane state's advance and the per-lane
gamma dial (an acceptance EWMA with a hysteresis band). As the port's
`_decode_fn` does, `spec_decode_fn` writes the lane state back IN PLACE
(last tokens, seq lens, active, EWMA, dial), so a CUDA graph of the round
reads and writes fixed addresses, and returns only the packed
[B, gamma + 1 + SPEC_STAT_COLS] int32 matrix: the emitted tokens (-1
past each row's prefix), then accepted, proposed, the EWMA in 1e-6 fixed
point and the next dial. Nothing in a round reads the device on the host.

A lane whose dial g is below the dispatched gamma never offers drafts past
g (they are masked in the acceptance scan), so one graph per gamma rung
serves every mix of dials; when every offered draft is accepted, the extra
token is the bonus draw from the target's distribution at the frontier.
`greedy=True` (an all-greedy batch) skips the distributions, the draws
and the truncation: its packed output equals the sampled body's on such a
batch. Draws are `sampling.TaggedDraws`, keyed by (seed, position, tag).

`ragged_spec_fn` is the same round on the ragged stream (the reference's
ragged x spec dispatch): the verify windows ride one flat stream with the
prefill ranges of prompts being admitted, through one `forward_ragged`
per model (the ragged attention kernel), so admissions do not wait for a
round of their own.

Over a serving mesh (`mesh=`) both models run their sharded forwards (the
draft's weights and pools are cut as the target's) and both models'
logits are gathered over tp before any sampling or acceptance math. Under
dp each rank runs the round for its dp share of the lanes: the draft
steps, the verify window and the draft's resync all take forward_paged's
decode rule (`dp_lanes`: K/V rows gathered over dp before the write),
and the round's outputs are all-gathered over dp, so every rank advances
the whole lane state alike. The ragged round serves tp-at-most meshes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.speculative import rejection_accept, residual_extra_dist
from ..models.transformer import forward_paged, forward_ragged, unembed
from ..parallel.collectives import gather_from
from .sampling import (
    ACCEPT_TAG,
    DRAFT_TAG,
    EXTRA_TAG,
    TaggedDraws,
    sample_tail,
    truncated_dist,
)

# The per-lane dial's EWMA blend and hysteresis band (the reference's
# constants): a lane's EWMA below the floor dials it down to gamma_low,
# above the ceiling back up to gamma_max.
GAMMA_EWMA_BETA = 0.8
GAMMA_ACCEPT_FLOOR = 0.35
GAMMA_ACCEPT_CEIL = 0.55

# Stat columns after the gamma + 1 emit columns of the packed matrix:
# accepted, proposed, acceptance EWMA (1e-6 fixed point), next gamma dial.
SPEC_STAT_COLS = 4


def _dists(logits, temp, top_p, top_k, candidates: int):
    """The sampled rows' distributions over the last axis: truncated with
    the prefilter, the plain softmax at temperature without it."""
    if candidates:
        return truncated_dist(logits, temp, top_p, top_k, candidates)
    return torch.softmax(logits / temp[..., None], dim=-1)


def _draft_scan(d_params, d_cfg, d_paged, last_tokens, pos, page_tables, greedy_row,
                temp, eff_top_p, eff_top_k, draws, gamma: int, candidates: int,
                greedy: bool, mesh=None):
    """Draft gamma tokens autoregressively, one T=1 paged step each.
    Returns (drafts [B, gamma] int32, d_dists [B, gamma, V], or None for
    the greedy body)."""
    tok, p = last_tokens, pos
    drafts, dists = [], []
    for _ in range(gamma):
        hidden, d_paged = forward_paged(d_params, d_cfg, tok[:, None], p[:, None],
                                        d_paged, page_tables, mesh=mesh)
        logits = unembed(d_params, d_cfg, hidden[:, 0], mesh)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if not greedy:
            dist = _dists(logits, temp, eff_top_p, eff_top_k, candidates)
            sampled = draws.categorical(p + 1, DRAFT_TAG,
                                        torch.log(torch.clamp(dist, min=1e-20)))
            nxt = torch.where(greedy_row, nxt, sampled)
            dists.append(dist)
        drafts.append(nxt)
        tok, p = nxt, p + 1
    return torch.stack(drafts, dim=1), (torch.stack(dists, dim=1) if dists else None)


def _accept_merge(t_logits, drafts, d_dists, last_tokens, seq_lens, active, caps,
                  accept_ewma, gamma_lane, pos, greedy_row, temp, eff_top_p, eff_top_k,
                  draws, *, gamma: int, gamma_low: int, gamma_max: int, eos_id: int,
                  candidates: int, greedy: bool):
    """The accept/merge core (the reference's `_accept_merge`): acceptance,
    the extra token, EOS and cap truncation, the lane state's advance and
    the dial. A stopped lane (inactive) emits nothing and keeps its state.
    Returns (packed [B, gamma + 1 + SPEC_STAT_COLS], new_last, new_seq_lens,
    new_active, new_ewma, new_gamma_lane)."""
    B = last_tokens.shape[0]
    dev = last_tokens.device
    i32 = torch.int32
    rows = torch.arange(B, device=dev)
    t_choice = torch.argmax(t_logits, dim=-1).to(i32)              # [B, gamma+1]
    accept = drafts == t_choice[:, :gamma]
    t_probs = None
    if not greedy:
        shape = t_logits.shape[:2]
        t_probs = _dists(t_logits, temp[:, None].expand(shape),
                         eff_top_p[:, None].expand(shape),
                         eff_top_k[:, None].expand(shape), candidates)
        draft_idx = pos[:, None] + 1 + torch.arange(gamma, dtype=i32, device=dev)[None, :]
        u = draws.uniform(draft_idx, ACCEPT_TAG)
        accept = torch.where(greedy_row[:, None], accept,
                             rejection_accept(t_probs, d_dists, drafts, u))
    g_lane = torch.clamp(gamma_lane, 1, gamma)
    offered = torch.arange(gamma, device=dev)[None, :] < g_lane[:, None]
    accept = accept & offered
    n_acc = torch.cumprod(accept.to(i32), dim=1).sum(dim=1).to(i32)   # [B]
    extra = t_choice[rows, n_acc.long()]
    if not greedy:
        bonus = n_acc >= g_lane
        dist = torch.where(bonus[:, None], t_probs[rows, n_acc.long()],
                           residual_extra_dist(t_probs, d_dists, n_acc))
        sampled = draws.categorical(pos + 1 + n_acc, EXTRA_TAG,
                                    torch.log(torch.clamp(dist, min=1e-20)))
        extra = torch.where(greedy_row, extra, sampled)

    # Emit the accepted prefix and the extra token; advance the lane.
    act = active.to(i32)
    emit = torch.cat([drafts, torch.zeros((B, 1), dtype=i32, device=dev)], dim=1)
    emit = emit.scatter(1, n_acc.long()[:, None], extra[:, None])
    n_out = (n_acc + 1) * act
    cols = torch.arange(gamma + 1, dtype=i32, device=dev)[None, :]
    is_eos = (emit == eos_id) & (cols < n_out[:, None])
    has_eos = is_eos.any(dim=1)
    first_eos = torch.argmax(is_eos.to(i32), dim=1).to(i32)
    n_out = torch.where(has_eos, first_eos + 1, n_out)
    n_out = torch.minimum(n_out, torch.clamp(caps - seq_lens, min=0))
    emit = torch.where(active[:, None], emit, torch.zeros_like(emit))
    new_seq = seq_lens + n_out
    last_col = torch.clamp(n_out - 1, min=0).long()
    new_last = torch.where(active & (n_out > 0), emit[rows, last_col], last_tokens)
    new_active = active & ~has_eos & (new_seq < caps)
    tokens_out = torch.where(cols < n_out[:, None], emit, torch.full_like(emit, -1))

    # The dial's stats: a round cut short by EOS or the cap counts only
    # the drafts that could be emitted (a perfect draft reads exactly 1.0);
    # a full round counts the lane's offered drafts; stopped lanes nothing.
    untrunc = (n_acc + 1) * act
    cut = n_out < untrunc
    acc_rows = torch.minimum(torch.clamp(untrunc - 1, min=0), n_out)
    prop_rows = torch.where(cut, n_out, g_lane) * act
    rate = acc_rows.float() / torch.clamp(prop_rows, min=1).float()
    new_ewma = torch.where(
        prop_rows > 0,
        GAMMA_EWMA_BETA * accept_ewma + (1.0 - GAMMA_EWMA_BETA) * rate,
        accept_ewma,
    )
    # The hold band keeps the STORED dial, not the clipped one: a round at
    # the low rung does not forget that a lane's dial was at gamma_max.
    new_gamma = torch.where(
        new_ewma < GAMMA_ACCEPT_FLOOR, torch.full_like(gamma_lane, gamma_low),
        torch.where(new_ewma > GAMMA_ACCEPT_CEIL, torch.full_like(gamma_lane, gamma_max),
                    torch.clamp(gamma_lane, gamma_low, gamma_max)),
    ).to(i32)
    packed = torch.cat([
        tokens_out, acc_rows[:, None], prop_rows[:, None],
        torch.round(new_ewma * 1e6).to(i32)[:, None], new_gamma[:, None],
    ], dim=1)
    return packed, new_last, new_seq, new_active, new_ewma, new_gamma


def spec_prefill_fn(t_params, d_params, t_cfg: ModelConfig, d_cfg: ModelConfig,
                    t_paged, d_paged, tokens, start, last_rel, page_table, seeds,
                    temperature, top_p, top_k, *, greedy: bool, candidates: int = 0,
                    aligned: Optional[bool] = None, mesh=None):
    """Prefill BOTH pools for N windows; the first token comes from the
    target. The contract of the engine's `_prefill_fn` (windows at per-row
    offsets, the draw keyed by the sampled token's position) plus the
    draft's pools: a draft that has not seen the prompt proposes from a
    cold cache. Returns (tokens [N], t_paged, d_paged)."""
    N, T = tokens.shape
    positions = (start[:, None]
                 + torch.arange(T, dtype=torch.int32, device=tokens.device)).to(torch.int32)
    hidden, t_paged = forward_paged(t_params, t_cfg, tokens, positions, t_paged,
                                    page_table, aligned=aligned, mesh=mesh)
    _, d_paged = forward_paged(d_params, d_cfg, tokens, positions, d_paged, page_table,
                               aligned=aligned, mesh=mesh)
    last = hidden[torch.arange(N, device=tokens.device), last_rel.long()]
    logits = unembed(t_params, t_cfg, last, mesh)
    token = sample_tail(logits, seeds, start + last_rel + 1, temperature, top_p, top_k,
                        greedy, candidates)
    return token, t_paged, d_paged


def spec_decode_fn(t_params, d_params, t_cfg: ModelConfig, d_cfg: ModelConfig,
                   t_paged, d_paged, last_tokens, seq_lens, page_tables, active, caps,
                   seeds, temperature, top_p, top_k, accept_ewma, gamma_lane, *,
                   gamma: int, eos_id: int, gamma_low: Optional[int] = None,
                   gamma_max: Optional[int] = None, candidates: int = 0,
                   greedy: bool = False, draws: Optional[TaggedDraws] = None,
                   mesh=None) -> torch.Tensor:
    """One draft/verify round for the whole slot batch. `last_tokens` is
    the emitted token at position seq_lens - 1 whose KV is not written yet
    (the decode block's invariant); an active row emits n_acc + 1 tokens,
    cut at EOS and its cap. The lane state (last_tokens, seq_lens, active,
    accept_ewma, gamma_lane) advances IN PLACE; returns the packed
    [B, gamma + 1 + SPEC_STAT_COLS] int32 matrix. Greedy rows reproduce the
    target's greedy chain for any draft. Over a `mesh` with dp > 1 this
    rank runs the round for its dp share of the lanes (module docstring)."""
    gamma_low = gamma if gamma_low is None else gamma_low
    gamma_max = gamma if gamma_max is None else gamma_max
    dp = mesh.shape["dp"] if mesh is not None else 1
    lanes = slice(None)
    if dp > 1:
        b = last_tokens.shape[0] // dp
        lanes = slice(mesh.coord("dp") * b, (mesh.coord("dp") + 1) * b)
    last, seq, tables, act, cap = (t[lanes] for t in (last_tokens, seq_lens, page_tables,
                                                      active, caps))
    temperature, top_p, top_k, seeds = (t[lanes] for t in (temperature, top_p, top_k, seeds))
    dev = last_tokens.device
    pos = torch.clamp(seq - 1, min=0)
    greedy_row = temperature == 0.0
    temp = torch.clamp(temperature, min=1e-6)
    draws = TaggedDraws(seeds) if draws is None else draws
    # Greedy rows accept by argmax equality: their distributions are
    # untruncated whatever their top_p.
    eff_top_p = torch.where(greedy_row, torch.ones_like(top_p), top_p)
    eff_top_k = torch.where(greedy_row, torch.zeros_like(top_k), top_k)

    drafts, d_dists = _draft_scan(
        d_params, d_cfg, d_paged, last, pos, tables, greedy_row, temp,
        eff_top_p, eff_top_k, draws, gamma, candidates, greedy, mesh,
    )
    # Verify: one target forward over [last, drafts] (gamma + 1 wide), then
    # the draft's pools rewritten over the same window. The window starts
    # anywhere, so its KV write is the per-token scatter.
    window = torch.cat([last[:, None], drafts], dim=1)
    w_pos = (pos[:, None]
             + torch.arange(gamma + 1, dtype=torch.int32, device=dev)[None, :]).to(torch.int32)
    t_hidden, t_paged = forward_paged(t_params, t_cfg, window, w_pos, t_paged,
                                      tables, aligned=False, mesh=mesh, dp_lanes=True)
    t_logits = unembed(t_params, t_cfg, t_hidden, mesh)           # [B, gamma+1, V]
    forward_paged(d_params, d_cfg, window, w_pos, d_paged, tables, aligned=False,
                  mesh=mesh, dp_lanes=True)

    packed, new_last, new_seq, new_active, new_ewma, new_gamma = _accept_merge(
        t_logits, drafts, d_dists, last, seq, act, cap, accept_ewma[lanes],
        gamma_lane[lanes], pos, greedy_row, temp, eff_top_p, eff_top_k, draws,
        gamma=gamma, gamma_low=gamma_low, gamma_max=gamma_max, eos_id=eos_id,
        candidates=candidates, greedy=greedy,
    )
    if dp > 1:
        # One all-gather of every output column over dp (int32 words).
        i32 = torch.int32
        cols = torch.cat([packed, new_last[:, None], new_seq[:, None],
                          new_active.to(i32)[:, None], new_ewma.view(i32)[:, None],
                          new_gamma[:, None]], dim=1)
        cols = gather_from(cols, mesh, "dp", 0)
        n = packed.shape[1]
        packed = cols[:, :n]
        new_last, new_seq, new_gamma = cols[:, n], cols[:, n + 1], cols[:, n + 4]
        new_active = cols[:, n + 2] != 0
        new_ewma = cols[:, n + 3].contiguous().view(torch.float32)
    last_tokens.copy_(new_last)
    seq_lens.copy_(new_seq)
    active.copy_(new_active)
    accept_ewma.copy_(new_ewma)
    gamma_lane.copy_(new_gamma)
    return packed


def ragged_spec_fn(t_params, d_params, t_cfg: ModelConfig, d_cfg: ModelConfig,
                   t_paged, d_paged, last_tokens, seq_lens, page_tables, active, caps,
                   seeds, temperature, top_p, top_k, accept_ewma, gamma_lane,
                   pre_tokens, pre_pos, pre_table_idx, pre_tables,
                   pre_range_start, pre_range_len, pre_range_kv, pre_range_table,
                   pre_sample_idx, pre_sample_pos, pre_seeds, pre_temp, pre_top_p,
                   pre_top_k, *, gamma: int, eos_id: int, gamma_low: Optional[int] = None,
                   gamma_max: Optional[int] = None, greedy: bool = False,
                   candidates: int = 0, t_work=None, d_work=None,
                   draws: Optional[TaggedDraws] = None, mesh=None):
    """One ragged dispatch of mixed prefill and speculative verify: every
    decode lane runs a whole draft/verify round and up to W prefill tokens
    advance, in one flat `forward_ragged` per model.

    The flat stream: rows [0, B (gamma + 1)) are the verify windows [prev,
    drafts], lane-major (lane b's window at rows b (gamma + 1)..), then the
    W-row prefill stream with the engine's `_ragged_fn` operand contract
    (`pre_table_idx` B: the all-garbage table row; unused ranges sit past
    the stream's end). The B verify ranges (start b (gamma + 1), length
    gamma + 1, KV max(seq_lens, 1) + gamma) come before the prefill ranges.
    The draft's forward runs over the same stream: its verify rows rewrite
    the draft's pools over the window (the bucketed round's sync) and its
    prompt rows prefill them (the bucketed prefill's second forward).
    Inactive lanes carry position 0 and all-garbage tables, so their
    windows write only page 0.

    The drafts come from `_draft_scan` and the acceptance from
    `_accept_merge`, as in `spec_decode_fn`; slot b's first token is drawn
    from prefill row `pre_sample_idx[b]` at position key
    `pre_sample_pos[b]`, as in `_ragged_fn` (the host reads only final
    ranges' draws). `t_work` and `d_work` are each model's ragged kernel
    work list (`ragged_work` depends on the heads: over a tp mesh, a rank's
    local kv heads). The lane state advances IN PLACE; returns (packed
    [B, gamma + 1 + SPEC_STAT_COLS], first [B])."""
    gamma_low = gamma if gamma_low is None else gamma_low
    gamma_max = gamma if gamma_max is None else gamma_max
    B = last_tokens.shape[0]
    W = pre_tokens.shape[0]
    G1 = gamma + 1
    dev = last_tokens.device
    i32 = torch.int32
    pos = torch.clamp(seq_lens - 1, min=0)
    greedy_row = temperature == 0.0
    temp = torch.clamp(temperature, min=1e-6)
    draws = TaggedDraws(seeds) if draws is None else draws
    eff_top_p = torch.where(greedy_row, torch.ones_like(top_p), top_p)
    eff_top_k = torch.where(greedy_row, torch.zeros_like(top_k), top_k)

    drafts, d_dists = _draft_scan(
        d_params, d_cfg, d_paged, last_tokens, pos, page_tables, greedy_row, temp,
        eff_top_p, eff_top_k, draws, gamma, candidates, greedy, mesh,
    )
    window = torch.cat([last_tokens[:, None], drafts], dim=1)
    w_pos = pos[:, None] + torch.arange(G1, dtype=i32, device=dev)[None, :]
    tokens = torch.cat([window.reshape(-1), pre_tokens])
    positions = torch.cat([w_pos.reshape(-1), pre_pos]).to(i32)
    tables_ext = torch.cat([pre_tables, torch.zeros_like(pre_tables[:1])])
    token_tables = torch.cat([page_tables.repeat_interleave(G1, dim=0),
                              tables_ext[pre_table_idx.long()]])
    rng_starts = torch.cat([torch.arange(B, dtype=i32, device=dev) * G1,
                            B * G1 + pre_range_start])
    rng_lens = torch.cat([torch.full((B,), G1, dtype=i32, device=dev), pre_range_len])
    rng_kv = torch.cat([torch.clamp(seq_lens, min=1) + gamma, pre_range_kv])
    seq_tables = torch.cat([page_tables, tables_ext[pre_range_table.long()]])
    ranges = (rng_starts, rng_lens, rng_kv, seq_tables)
    hidden, t_paged = forward_ragged(t_params, t_cfg, tokens, positions, t_paged,
                                     token_tables, *ranges, work=t_work, mesh=mesh)
    t_logits = unembed(t_params, t_cfg, hidden[:B * G1].reshape(B, G1, -1), mesh)
    forward_ragged(d_params, d_cfg, tokens, positions, d_paged, token_tables, *ranges,
                   work=d_work, mesh=mesh)

    packed, new_last, new_seq, new_active, new_ewma, new_gamma = _accept_merge(
        t_logits, drafts, d_dists, last_tokens, seq_lens, active, caps, accept_ewma,
        gamma_lane, pos, greedy_row, temp, eff_top_p, eff_top_k, draws,
        gamma=gamma, gamma_low=gamma_low, gamma_max=gamma_max, eos_id=eos_id,
        candidates=candidates, greedy=greedy,
    )
    rows = hidden[B * G1 + torch.clamp(pre_sample_idx, 0, W - 1).long()]
    first = sample_tail(unembed(t_params, t_cfg, rows, mesh), pre_seeds, pre_sample_pos,
                        pre_temp, pre_top_p, pre_top_k, greedy, candidates)
    last_tokens.copy_(new_last)
    seq_lens.copy_(new_seq)
    active.copy_(new_active)
    accept_ewma.copy_(new_ewma)
    gamma_lane.copy_(new_gamma)
    return packed, first
