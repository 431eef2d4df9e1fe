"""Batch generation over a contiguous KV cache (the reference's
models/generate.py).

The simple generation loop for tests, offline evaluation and scoring: one
prefill writes the right-padded prompts into a `KVCache` and samples the
first token, then one decode step a token for the whole batch; per-row
prompt lengths are data. The serving engine (engine/engine.py) uses the
paged cache instead. The reference's jitted prefill and `lax.scan` become
eager calls and a plain loop; on the card a prompt window of T >= 128
runs the flash kernel (models/transformer.forward), decode steps the
plain attention, in both packages alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.sampling import SamplingParams, sample
from .config import ModelConfig
from .transformer import KVCache, forward, init_cache, unembed

def row_seeds(seed: int, batch: int, device) -> torch.Tensor:
    """[batch, 2] int32 seed halves for the draws of `seed`: row b keys its
    draws by (seed >> 32 ^ b, seed & 0xFFFFFFFF), so the rows of a batch
    draw independently and a seed gives the same streams again."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    rows = [((s >> 32) ^ b, s & 0xFFFFFFFF) for b in range(batch)]
    return torch.from_numpy(np.array(rows, np.uint32).view(np.int32)).to(device)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, seq_lens: torch.Tensor,
            cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Write the right-padded prompts [B, T] into the cache; returns fp32
    logits at each row's last real token ([B, V]) and the cache."""
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    hidden, cache = forward(params, cfg, tokens, positions, cache)
    last = hidden[torch.arange(B, device=tokens.device), (seq_lens - 1).long()]
    return unembed(params, cfg, last), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One decode step of the last tokens [B] at `positions` [B]; returns
    fp32 logits [B, V] and the cache."""
    hidden, cache = forward(params, cfg, tokens[:, None], positions[:, None], cache)
    return unembed(params, cfg, hidden[:, 0]), cache


@torch.inference_mode()
def generate(params: dict, cfg: ModelConfig, tokens: torch.Tensor, seq_lens: torch.Tensor,
             seed: int, sampling: SamplingParams, max_len: int,
             eos_id: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Generate `sampling.max_new_tokens` per row of the right-padded
    prompts `tokens` [B, T] (true lengths `seq_lens` [B]), on their device.

    Returns (generated [B, max_new_tokens] int32, num_generated [B]). A row
    that emits `eos_id` keeps emitting it (the shapes are fixed), and
    num_generated counts its tokens through the eos (-1: never stops).
    Sampled draws are keyed by (`seed`, the row, the token's position)
    (`row_seeds`, engine/sampling.sample), not by jax.random's keys."""
    B, T = tokens.shape
    max_new = sampling.max_new_tokens
    if T + max_new > max_len:
        raise ValueError(
            f"cache too small: prompt window {T} + max_new_tokens {max_new} "
            f"exceeds max_len {max_len} (a cache write past it would raise)"
        )
    dev = tokens.device
    cache = init_cache(cfg, B, max_len, params["embed"].dtype, dev)
    seeds = row_seeds(seed, B, dev)
    logits, cache = prefill(params, cfg, tokens, seq_lens, cache)
    token = sample(logits, seeds, seq_lens, sampling)
    pos = seq_lens.to(torch.int32)
    done = token == eos_id
    out, alive = [token], [torch.ones_like(done)]
    for _ in range(max_new - 1):
        logits, cache = decode_step(params, cfg, token, pos, cache)
        nxt = sample(logits, seeds, pos + 1, sampling)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        alive.append(~done)
        done = done | (nxt == eos_id)
        out.append(nxt)
        token, pos = nxt, pos + 1
    generated = torch.stack(out, dim=1)
    num_generated = torch.stack(alive, dim=1).sum(dim=1).to(torch.int32)
    return generated, num_generated
