"""Sharded training step (the reference's train/train.py).

Loss: next-token cross-entropy, targets < 0 masked, divided by the mask
count over the whole global batch (all-reduced over dp and sp, so shards
that mask differently still give the single-device gradients). The
forward is checkpointed whole (torch.utils.checkpoint, non-reentrant), as
the reference's jax.checkpoint: only its inputs live between the forward
and the backward, which recomputes it. Every rank recomputes in the same
order, so the collectives inside it (tp sums, the sp ring or all-to-all)
are issued again in step. The pp path checkpoints inside the pipeline
instead (parallel/pipeline.py): a rank cannot recompute a stage hand-off
on its own.

Gradients: tp and ep ranks get full gradients for what they hold from
the collectives' own backwards (parallel/collectives.py). The batch is
split over dp and sp, so every gradient is summed over those axes; a leaf
that pp does not split (embed, final_norm, lm_head) is summed over pp too,
after only the last stage seeded the loss (the pipeline's outputs are
replicated from it; stage 0 holds the embedding's input-side gradient).
Every replica of a leaf then takes the same update.

Optimizer: the reference's optax.adamw(1e-4, weight_decay=0.01) is
torch.optim.AdamW(lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
weight_decay=0.01) over every parameter, decay on every leaf as optax
applies it with no mask; moments in the parameters' dtype. The fused
kernel on the card, the single-tensor loop on the CPU: the default
multi-tensor loop makes temporaries the size of whole parameter groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..models.config import ModelConfig
from ..models.transformer import forward, make_sp_override, unembed
from ..parallel.collectives import all_reduce
from ..parallel.sharding import batch_spec, local_slice, replicated_over, shard_params


@dataclass
class TrainState:
    step: int
    params: dict
    optimizer: torch.optim.Optimizer


def cross_entropy_loss(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B, T] input ids (this rank's shard)
    targets: torch.Tensor,      # [B, T] next-token ids (-1 -> masked)
    positions: torch.Tensor,    # [B, T]
    mesh=None,
    sp_impl: str = "ring",
    pp_microbatches: int = 4,
) -> torch.Tensor:
    """Next-token cross-entropy of this rank's tokens over the global mask
    count: summed over the ranks that split the batch it is the loss of
    the whole batch. With a mesh of sp > 1 attention runs sequence-
    parallel (`sp_impl`: "ring" or "ulysses"); with pp > 1 the stack runs
    the GPipe schedule; sp and pp cannot be combined. Without a mesh it is
    the single-device loss."""
    sp = pp = 1
    if mesh is not None:
        sp, pp = mesh.shape["sp"], mesh.shape["pp"]
    if sp > 1 and pp > 1:
        raise ValueError("sp>1 and pp>1 are mutually exclusive")
    if pp > 1:
        from ..parallel.pipeline import pipeline_forward

        hidden = pipeline_forward(params, cfg, tokens, positions, mesh, pp_microbatches)
    else:
        override = make_sp_override(cfg, mesh, positions, sp_impl)

        def run(p, t, pos):
            return forward(p, cfg, t, pos, None, override, mesh)[0]

        hidden = checkpoint(run, params, tokens, positions, use_reentrant=False)
    logits = unembed(params, cfg, hidden, mesh)            # [B, T, V] fp32
    mask = targets >= 0
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(mask, targets, 0).long()[..., None])[..., 0]
    count = mask.sum()
    if mesh is not None:
        count = all_reduce(count, mesh, ("dp", "sp"))
    return (nll * mask).sum() / count.clamp_min(1)


def default_optimizer(params: list) -> torch.optim.Optimizer:
    cuda = params[0].device.type == "cuda"
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01, fused=cuda or None,
                             foreach=False if not cuda else None)


def _leaves_with_paths(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves_with_paths(v, path + (k,))
    elif isinstance(node, list):
        for v in node:
            yield from _leaves_with_paths(v, path)
    else:
        yield path, node


def sync_grads(params: dict, mesh) -> None:
    """Sum every gradient over the axes that split the batch (dp, sp), and
    a leaf that pp does not split over pp too (in place)."""
    for path, leaf in _leaves_with_paths(params):
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        axes = ("dp", "sp") + (("pp",) if replicated_over(path, "pp") else ())
        for axis in axes:
            dist.all_reduce(leaf.grad, group=mesh.group(axis))


def make_train_step(
    cfg: ModelConfig,
    mesh,
    optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
    sp_impl: str = "ring",
    pp_microbatches: int = 4,
):
    """Returns (init_state, train_step, shard_batch) bound to the mesh.

    init_state(params) takes the whole parameter tree (the same on every
    rank), keeps this rank's shards as trainable leaves (a shard that is
    the whole leaf is the caller's tensor, trained in place) and builds
    the optimizer over them (`optimizer(list_of_leaves)`, default AdamW as
    above). train_step(state, tokens, targets, positions) runs one step on
    this rank's batch shard and returns (state, loss of the global batch).
    shard_batch(tokens, targets, positions) takes this rank's dp rows and,
    when sp > 1, its sp columns of the global batch, on the mesh's
    device."""
    make_opt = optimizer or default_optimizer
    last_stage = mesh.coord("pp") == mesh.shape["pp"] - 1

    def init_state(params: dict) -> TrainState:
        local = shard_params(params, cfg, mesh)
        leaves = [leaf for _, leaf in _leaves_with_paths(local)]
        for leaf in leaves:
            leaf.requires_grad_(True)
        return TrainState(step=0, params=local, optimizer=make_opt(leaves))

    def train_step(state: TrainState, tokens, targets, positions):
        state.optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(state.params, cfg, tokens, targets, positions, mesh,
                                  sp_impl, pp_microbatches)
        (loss if last_stage else loss * 0).backward()
        sync_grads(state.params, mesh)
        state.optimizer.step()
        state.step += 1
        return state, all_reduce(loss, mesh, ("dp", "sp"))

    seq_axis = 1 if mesh.shape["sp"] > 1 else None

    def shard_batch(tokens, targets, positions):
        spec = batch_spec(2, seq_axis)
        return tuple(local_slice(t, spec, mesh).to(mesh.device) for t in (tokens, targets, positions))

    return init_state, train_step, shard_batch
