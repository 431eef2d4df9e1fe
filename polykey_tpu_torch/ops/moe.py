"""Mixture-of-Experts layer, Mixtral-style top-k routing (the reference's
ops/moe.py).

- `moe_mlp`: einsum-dense. Every token runs through every expert, weighted
  by the sparse combine matrix (E / k times the dispatch's operations).
- `moe_mlp_dispatch`: capacity-bucketed sparse dispatch (GShard). Each
  expert takes a fixed bucket of C = max(1, int(N * k / E * 1.25)) rows;
  a (token, choice) pair's place in its expert's bucket is a cumulative
  sum over the pairs in token-major, choice-minor order, and pairs past C
  are dropped (the residual carries them). Every row of the batch takes
  its share, padding and idle decode lanes included, as in the reference.

Router logits in fp32, top-k with ties to the lower expert index (as
`jax.lax.top_k`: a stable descending sort, on the CPU and on the card),
and the combine weights renormalized over the selected k by a softmax.
Both forms go through `qeinsum_expert`, so fp, int8 and int4 experts share
one body. Static shapes and no host read: the layer runs inside the
engine's CUDA graphs.

`moe_mlp_sharded` is the reference's expert-parallel layout over a mesh
("expert-replicated compute"): the router runs on every rank, each ep rank
computes its local experts' contributions over its tp columns, and the
combine is summed over ep and tp. No token moves between ranks; under dp
and sp the capacity-bucketed form gathers the router's choices alone, so
its capacity and drops are the whole batch's, as the reference's.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.layers import _activate
from ..models.quant import qeinsum_expert
from ..parallel.collectives import all_gather_along, copy_to, reduce_from


def _router_weights(layer_params: dict, h: torch.Tensor, cfg: ModelConfig):
    """Top-k routing: (combine [..., E] fp32, expert_idx [..., k] int64).
    The logits are the fp32 product of the operands (bf16 values are exact
    in fp32, and in TF32), as the reference's preferred_element_type."""
    logits = h.float() @ layer_params["router"].float()
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = order.values[..., :cfg.num_experts_per_tok]
    idx = order.indices[..., :cfg.num_experts_per_tok]
    weights = torch.softmax(weights, dim=-1)
    combine = torch.zeros_like(logits).scatter_(-1, idx, weights)
    return combine, idx


def moe_mlp(layer_params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense-compute MoE: [B, T, H] -> [B, T, H]."""
    combine, _ = _router_weights(layer_params, h, cfg)              # [B, T, E]
    experts = layer_params["experts"]
    up = qeinsum_expert("bth,ehi->beti", h, experts["up"], e_axis=1)
    gate = _activate(qeinsum_expert("bth,ehi->beti", h, experts["gate"], e_axis=1),
                     cfg.activation)
    out = qeinsum_expert("beti,eih->beth", gate * up, experts["down"], e_axis=1)
    return torch.einsum("beth,bte->bth", out.float(), combine).to(h.dtype)


def _dispatch_slots(idx: torch.Tensor, num_experts: int, capacity: int):
    """Each (token, choice)'s slot in its expert's bucket, from a cumulative
    sum over the flattened pairs: (slot [N, k], keep [N, k])."""
    N, k = idx.shape
    experts = torch.arange(num_experts, device=idx.device)
    onehot = (idx[..., None] == experts).to(torch.int32)            # [N, k, E]
    flat = onehot.reshape(N * k, num_experts)
    position = (torch.cumsum(flat, dim=0) * flat - 1).reshape(N, k, num_experts)
    slot = (position * onehot).sum(dim=-1)
    return slot, slot < capacity


def _scatter(tokens: torch.Tensor, idx: torch.Tensor, slot, keep, num_experts: int,
             capacity: int) -> torch.Tensor:
    """Buckets [E, C, H]: each kept pair's token written once at (expert,
    slot); dropped pairs go to a spare row that is cut off. Empty slots
    stay zero."""
    N, k = idx.shape
    H = tokens.shape[-1]
    dest = torch.where(keep, idx * capacity + slot, num_experts * capacity).reshape(-1)
    buckets = tokens.new_zeros((num_experts * capacity + 1, H))
    buckets[dest] = tokens[:, None].expand(N, k, H).reshape(N * k, H)
    return buckets[:-1].reshape(num_experts, capacity, H)


def _combine(out: torch.Tensor, combine, idx, slot, keep) -> torch.Tensor:
    """Each pair reads its bucket slot (a dropped pair its expert's last,
    weighted 0); the k reads summed in fp32 with their weights: [N, H]."""
    N, k = idx.shape
    flat_slot = torch.where(keep, slot, out.shape[1] - 1)
    gathered = out[idx.reshape(-1), flat_slot.reshape(-1)].reshape(N, k, -1)
    weight = torch.where(keep, combine.gather(-1, idx), 0.0)
    return (gathered.float() * weight[..., None]).sum(dim=1)


def moe_mlp_dispatch(layer_params: dict, h: torch.Tensor, cfg: ModelConfig,
                     capacity_factor: float = 1.25) -> torch.Tensor:
    """Capacity-bucketed sparse dispatch: [B, T, H] -> [B, T, H]."""
    B, T, H = h.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    N = B * T
    capacity = max(1, int(N * k / E * capacity_factor))
    tokens = h.reshape(N, H)
    combine, idx = _router_weights(layer_params, tokens, cfg)       # [N, E], [N, k]
    slot, keep = _dispatch_slots(idx, E, capacity)
    buckets = _scatter(tokens, idx, slot, keep, E, capacity)
    experts = layer_params["experts"]
    up = qeinsum_expert("ech,ehi->eci", buckets, experts["up"], e_axis=0)
    gate = _activate(qeinsum_expert("ech,ehi->eci", buckets, experts["gate"], e_axis=0),
                     cfg.activation)
    out = qeinsum_expert("eci,eih->ech", gate * up, experts["down"], e_axis=0)
    return _combine(out, combine, idx, slot, keep).reshape(B, T, H).to(h.dtype)


def moe_mlp_sharded(layer_params: dict, h: torch.Tensor, cfg: ModelConfig, mesh,
                    split: tuple = ()) -> torch.Tensor:
    """Either form over a mesh: `layer_params` holds this rank's experts
    (a contiguous run of E / ep, each with its tp columns) and the whole
    router. The fp32 partial sums of the combine are reduced over (ep, tp)
    before the cast, and the router and the experts' input take the
    gradients of every rank's share back.

    `split` names the (mesh axis, dimension of `h`) pairs over which the
    batch's tokens are split: ("dp", 0) for a serving mesh's decode lanes
    (a rank holds one contiguous block of them), ("sp", 1) for a prefill's
    columns (a rank holds a column range of every sequence). The
    capacity-bucketed dispatch drops by position in the whole batch, as
    the reference's (its MoE lies outside shard_map, so GSPMD takes the
    capacity and the cumulative sum over the global batch): the router's
    choices are gathered over those axes in the global token order
    (b-major, padding lanes and padded columns in their places), the
    capacity, slots and keep-mask are the whole batch's, and the rank
    keeps its own tokens' rows. Expert products are row-independent, so
    nothing else of the other ranks' tokens is needed."""
    axes = ("ep", "tp")
    B, T, H = h.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    experts = layer_params["experts"]
    e = experts["gate"].shape[0]
    e0 = mesh.coord("ep") * e
    combine, idx = _router_weights(layer_params, h, cfg)
    combine = copy_to(combine, mesh, axes)[..., e0:e0 + e]
    x = copy_to(h, mesh, axes)
    if cfg.moe_dispatch:
        N = B * T
        slot, keep, capacity = _global_slots(idx, E, mesh, split)
        idx = idx.reshape(N, k)
        keep = keep & (idx >= e0) & (idx < e0 + e)
        local = (idx - e0).clamp(0, e - 1)
        buckets = _scatter(x.reshape(N, H), local, slot, keep, e, capacity)
        up = qeinsum_expert("ech,ehi->eci", buckets, experts["up"], e_axis=0)
        gate = _activate(qeinsum_expert("ech,ehi->eci", buckets, experts["gate"], e_axis=0),
                         cfg.activation)
        out = qeinsum_expert("eci,eih->ech", gate * up, experts["down"], e_axis=0)
        y = _combine(out, combine.reshape(N, e), local, slot, keep).reshape(B, T, H)
    else:
        up = qeinsum_expert("bth,ehi->beti", x, experts["up"], e_axis=1)
        gate = _activate(qeinsum_expert("bth,ehi->beti", x, experts["gate"], e_axis=1),
                         cfg.activation)
        out = qeinsum_expert("beti,eih->beth", gate * up, experts["down"], e_axis=1)
        y = torch.einsum("beth,bte->bth", out.float(), combine)
    return reduce_from(y, mesh, axes).to(h.dtype)


def _global_slots(idx: torch.Tensor, num_experts: int, mesh, split: tuple):
    """(slot [N, k], keep [N, k], capacity) of this rank's N = B * T tokens
    (`idx` [B, T, k]) in the dispatch over the whole batch: the choices
    gathered over each split axis of more than one rank (a group of one
    holds the whole batch already), the global batch's capacity and
    cumulative sum, and this rank's block of rows of the result."""
    B, T, k = idx.shape
    whole = idx
    for axis, dim in split:
        if mesh.shape[axis] > 1:
            whole = all_gather_along(whole, mesh, axis, dim)
    Bg, Tg = whole.shape[:2]
    capacity = max(1, int(Bg * Tg * k / num_experts * 1.25))
    slot, keep = _dispatch_slots(whole.reshape(Bg * Tg, k), num_experts, capacity)
    slot, keep = slot.reshape(Bg, Tg, k), keep.reshape(Bg, Tg, k)
    for axis, dim in split:
        size = idx.shape[dim]
        if whole.shape[dim] != size:
            slot = slot.narrow(dim, mesh.coord(axis) * size, size)
            keep = keep.narrow(dim, mesh.coord(axis) * size, size)
    return slot.reshape(B * T, k), keep.reshape(B * T, k), capacity
