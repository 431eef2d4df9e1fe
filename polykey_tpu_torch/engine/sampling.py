"""Token sampling: greedy, temperature, top-k, top-p, and the top-k
candidates prefilter (the reference's engine/sampling.py).

Draws are keyed by (seed, position): every sampled token of a request is a
Gumbel-max over a counter-based hash of (seed, token position, vocab
index), written in torch integer ops, so a seeded stream depends only on
its own seed and positions — never on the batch it rides in or its slot —
and needs no generator state on the device. The bits differ from
jax.random's; the distribution is the same. Speculative decoding's draws
(engine/spec_decode.py) add a stream tag to the key (`TaggedDraws`).

`candidates` > 0 prefilters each row to its top-C scaled logits and keeps
the top-p / top-k set within them, with probabilities normalized by the
full-vocabulary logsumexp, so the keep rule is the exact path's whenever
the kept set fits in C. A candidate's noise is the noise of its vocab
index, so such a row draws the same token on either path.

The offline generation path takes a static `SamplingParams` through
`sample`, with the same keyed draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_M32 = 0xFFFFFFFF

# Stream tags of the speculative round's draws (the reference's
# spec_decode._lane_tagger tags): a draft sample, an acceptance uniform,
# the extra token.
DRAFT_TAG = 101
ACCEPT_TAG = 102
EXTRA_TAG = 103


@dataclass(frozen=True)
class SamplingParams:
    """Static sampling configuration of the offline generation path
    (models/generate.py, models/speculative.py)."""

    temperature: float = 0.0   # 0 -> greedy
    top_k: int = 0             # 0 -> disabled
    top_p: float = 1.0         # 1.0 -> disabled
    max_new_tokens: int = 128

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


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


def _row_keys(seeds: torch.Tensor, positions: torch.Tensor,
              tag: Optional[int] = None) -> torch.Tensor:
    """32-bit keys of (seed, position[, tag]) in int64, positions' shape:
    seeds [B, 2] int32 (two halves of a 64-bit seed), positions [B] or
    [B, G]."""
    hi = seeds[:, 0].long() & _M32
    lo = seeds[:, 1].long() & _M32
    key = _mix32(_mix32(hi ^ 0x9E3779B9) ^ lo)
    pos = positions.long() & _M32
    key = key.reshape((-1,) + (1,) * (pos.dim() - 1))
    row = _mix32(key ^ _mix32(pos ^ 0x85EBCA6B))
    if tag is not None:
        row = _mix32(row ^ _mix32(tag ^ 0xC2B2AE35))
    return row


def uniform_bits(seeds: torch.Tensor, positions: torch.Tensor, vocab: int,
                 cols: Optional[torch.Tensor] = None, tag: Optional[int] = None
                 ) -> torch.Tensor:
    """[*positions.shape, V] 32-bit hashes of (seed_hi, seed_lo, position,
    vocab index), or of the vocab indices `cols` [*positions.shape, C]
    instead of 0..V-1; `tag` names a speculative draw's stream."""
    row = _row_keys(seeds, positions, tag)[..., None]
    if cols is None:
        cols = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    return _mix32(_mix32(row ^ cols.long()) ^ (row >> 7))


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit hashes -> uniforms in (0, 1), float64."""
    return ((bits >> 8).double() + 0.5) * (1.0 / (1 << 24))


def gumbel_noise(seeds, positions, vocab: int, cols=None, tag=None) -> torch.Tensor:
    """[B, V] standard Gumbel noise, deterministic in (seed, position) (at
    vocab indices `cols` when given)."""
    u = _uniform(uniform_bits(seeds, positions, vocab, cols, tag))
    return (-torch.log(-torch.log(u))).float()


class TaggedDraws:
    """THE draws of the speculative round, each derived from (seed,
    position, tag) (the reference's `_lane_tagger`, so the key scheme
    cannot drift between its streams): `uniform` for the acceptance test
    and `categorical` for the draft samples and the extra token. A test
    may replace either with the reference's draws."""

    def __init__(self, seeds: torch.Tensor):
        self.seeds = seeds

    def uniform(self, positions: torch.Tensor, tag: int) -> torch.Tensor:
        """Uniforms in (0, 1), positions' shape, float32."""
        zero = torch.zeros(1, dtype=torch.int64, device=positions.device)
        return _uniform(uniform_bits(self.seeds, positions, 1, zero, tag))[..., 0].float()

    def categorical(self, positions: torch.Tensor, tag: int,
                    logp: torch.Tensor) -> torch.Tensor:
        """One draw a row from log-probabilities `logp` [B, V]: Gumbel-max,
        as the reference's `_row_categorical`."""
        noise = gumbel_noise(self.seeds, positions, logp.shape[-1], tag=tag)
        return torch.argmax(logp + noise, dim=-1).to(torch.int32)


def prefix_keep_mask(desc_probs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """THE top-p keep rule (shared with the reference): over descending
    probabilities, keep each entry whose exclusive cumulative mass is < p,
    always keeping the first."""
    keep = torch.cumsum(desc_probs, dim=-1) - desc_probs < p
    keep[..., 0] = True
    return keep


def rank_keep_mask(width: int, top_k: torch.Tensor) -> torch.Tensor:
    """[..., width] keep mask for per-row top-k over descending entries
    (rank < k); top_k <= 0 disables. THE top-k rule of every
    candidates-prefiltered path."""
    r = torch.arange(width, device=top_k.device)
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, width))
    return r < k[..., None]


def truncation_thresholds(scaled: torch.Tensor, top_p: torch.Tensor, top_k: torch.Tensor):
    """(thr_p, thr_k) from one descending sort over the last axis: keeping
    `scaled >= thr_p` realizes the top-p rule, `scaled >= thr_k` keeps the
    k largest (ties keep all equal values); top_k <= 0 disables. top_p and
    top_k have scaled's shape without its last axis."""
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    keep_p = prefix_keep_mask(torch.softmax(sorted_desc, dim=-1), top_p[..., None])
    inf = torch.full_like(sorted_desc, float("inf"))
    thr_p = torch.where(keep_p, sorted_desc, inf).amin(dim=-1, keepdim=True)
    kidx = torch.clamp(torch.where(top_k > 0, top_k, V) - 1, 0, V - 1)
    thr_k = torch.gather(sorted_desc, -1, kidx.long()[..., None])
    return thr_p, thr_k


def _candidates_keep(scaled: torch.Tensor, top_p, top_k, candidates: int):
    """The prefilter: (top-C values [..., C], their vocab indices, keep
    mask, full-vocab probabilities of the C) by the shared rules."""
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    vals, idx = torch.topk(scaled, candidates, dim=-1)
    p_c = torch.exp(vals - lse)
    keep = prefix_keep_mask(p_c, top_p[..., None]) & rank_keep_mask(candidates, top_k)
    return vals, idx, keep, p_c


def truncated_dist(logits: torch.Tensor, temp: torch.Tensor, top_p: torch.Tensor,
                   top_k: torch.Tensor, candidates: int) -> torch.Tensor:
    """Per-row top-p / top-k truncated, renormalized distribution [..., V],
    exactly what the sampler draws from for the same (candidates, top_p):
    the prefiltered rule when 0 < candidates < V, the exact full-vocab sort
    otherwise. Rows with top_p >= 1 and no top_k get the plain softmax.
    temp (> 0), top_p and top_k have logits' shape without its last axis.
    The speculative draft/verify pair samples and accepts against this."""
    V = logits.shape[-1]
    scaled = logits / temp[..., None]
    probs = torch.softmax(scaled, dim=-1)
    if candidates and candidates < V:
        _, idx, keep, p_c = _candidates_keep(scaled, top_p, top_k, candidates)
        trunc = torch.zeros_like(probs).scatter(
            -1, idx, torch.where(keep, p_c, torch.zeros_like(p_c)))
    else:
        thr_p, thr_k = truncation_thresholds(scaled, top_p, top_k)
        trunc = torch.where((scaled >= thr_p) & (scaled >= thr_k), probs,
                            torch.zeros_like(probs))
    trunc = trunc / torch.clamp(trunc.sum(dim=-1, keepdim=True), min=1e-20)
    no_trunc = (top_p >= 1.0) & (top_k <= 0)
    return torch.where(no_trunc[..., None], probs, trunc)


def sample_tail(logits, seeds, positions, temperature, top_p, top_k, greedy: bool,
                candidates: int = 0):
    """THE shared sampling tail for prefill and decode: greedy takes the
    argmax (no randomness); sampled rows draw independently, each keyed by
    (its seed, positions[row]), with the top-C prefilter when `candidates`
    > 0. Rows with temperature 0 stay greedy."""
    V = logits.shape[-1]
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    neg = float("-inf")
    if candidates and candidates < V:
        vals, idx, keep, _ = _candidates_keep(scaled, top_p, top_k, candidates)
        greedy_tok = idx[:, 0].to(torch.int32)
        noise_c = gumbel_noise(seeds, positions, V, cols=idx)
        local = torch.argmax(torch.where(keep, vals, torch.full_like(vals, neg)) + noise_c,
                             dim=-1)
        truncated = torch.gather(idx, 1, local[:, None])[:, 0].to(torch.int32)
        # Untruncated rows: the whole vocabulary, with the exact path's noise.
        full = torch.argmax(scaled + gumbel_noise(seeds, positions, V), dim=-1)
        sampled = torch.where((top_p >= 1.0) & (top_k <= 0), full.to(torch.int32),
                              truncated)
    else:
        greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        thr_p, thr_k = truncation_thresholds(scaled, top_p, top_k)
        masked = torch.where((scaled < thr_p) | (scaled < thr_k),
                             torch.full_like(scaled, neg), scaled)
        noise = gumbel_noise(seeds, positions, V)
        sampled = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return torch.where(temperature == 0.0, greedy_tok, sampled)


def sample(logits: torch.Tensor, seeds: torch.Tensor, positions: torch.Tensor,
           sampling: SamplingParams) -> torch.Tensor:
    """Token ids [B] from logits [B, V] under the static `sampling`, as the
    reference's `sample`: greedy takes the argmax; otherwise the logits at
    the temperature are cut to the top k (ties at the k-th value kept),
    then to the top-p set of what is left (renormalized, the shared keep
    rule), and each row draws by Gumbel-max keyed by (its seed `seeds[row]`
    [B, 2], `positions[row]`) with the port's bits."""
    if sampling.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    B, V = logits.shape
    scaled = logits / sampling.temperature
    neg = torch.full_like(scaled, float("-inf"))
    if sampling.top_k > 0:
        kth = torch.topk(scaled, min(sampling.top_k, V), dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, neg, scaled)
    if sampling.top_p < 1.0:
        top_p = torch.full((B,), sampling.top_p, device=logits.device)
        no_k = torch.zeros((B,), dtype=torch.int32, device=logits.device)
        thr_p, _ = truncation_thresholds(scaled, top_p, no_k)
        scaled = torch.where(scaled < thr_p, neg, scaled)
    noise = gumbel_noise(seeds, positions, V)
    return torch.argmax(scaled + noise, dim=-1).to(torch.int32)
