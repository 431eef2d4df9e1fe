"""GPipe pipeline parallelism over the mesh's ``pp`` axis (the reference's
parallel/pipeline.py).

Stage p holds layers [p * L/P, (p + 1) * L/P) (parallel/sharding.py) and
runs them with their global indices, so Gemma-2's window interleave lands
on the same layers as in the unsharded stack. The forward is the
reference's tick schedule: at tick t stage p runs microbatch m = t - p
(when 0 <= m < M), then every stage hands its output one stage on and takes
the previous stage's, the send and the receive posted as a pair with
batch_isend_irecv. M + P - 1 ticks; the bubble is (P - 1) / (M + P - 1).

The backward is the mirrored schedule, written out in `_GPipe.backward`:
ticks in reverse, each stage recomputing its microbatch from the input it
kept (the stage's activations are rematerialized, as the reference's
jax.checkpoint over the pipeline does), taking its output gradient from
the next stage, and handing its input gradient to the previous one, again
in pairs. Keeping the exchanges out of autograd's own ordering keeps every
stage's sends and receives in lock step. tp collectives inside a stage run
as in the unsharded forward.

The outputs live on the last stage; one all-reduce over pp (of the last
stage's values, zeros elsewhere) gives every stage the hidden states, and
its backward hands the gradient to the last stage only. The result is the
same contract as ``forward(...)[0]``: hidden states after the final norm.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.layers import rms_norm
from ..models.transformer import apply_layer, embed_tokens, make_causal_attend
from .collectives import reduce_from


def _hand_off(mesh, send, recv_like, step: int):
    """One tick's hand-off along pp, posted as a pair: `send` (or None) to
    the stage `step` on, and a tensor like `recv_like` (or nothing, when
    None) from the stage `step` back."""
    ranks = mesh.ranks_along("pp")
    p = mesh.coord("pp")
    group = mesh.group("pp")
    ops, got = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), ranks[p + step], group))
    if recv_like is not None:
        got = torch.empty_like(recv_like, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, got, ranks[p - step], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got


class _GPipe(torch.autograd.Function):
    """The stage's share of the schedule. `run(m, x)` runs this stage's
    layers on microbatch m; `xs` [M, b, T, H] is the embedded input on
    stage 0 (ignored elsewhere); `weights` are the stage's parameters, so
    their gradients come back through this function."""

    @staticmethod
    def forward(ctx, run, mesh, xs, *weights):
        P, p = mesh.shape["pp"], mesh.coord("pp")
        M = xs.shape[0]
        like = xs[0]
        kept, outs, x_next = [None] * M, [None] * M, None
        for t in range(M + P - 1):
            m, y = t - p, None
            if 0 <= m < M:
                kept[m] = xs[m] if p == 0 else x_next
                y = run(m, kept[m])
                if p == P - 1:
                    outs[m] = y
            x_next = _hand_off(mesh, y if p < P - 1 else None,
                               like if p > 0 and 0 <= t + 1 - p < M else None, +1)
        ctx.run, ctx.mesh, ctx.kept, ctx.weights = run, mesh, kept, weights
        ctx.input_grad = p == 0 and ctx.needs_input_grad[2]
        return torch.stack(outs) if p == P - 1 else torch.zeros_like(xs)

    @staticmethod
    def backward(ctx, d_out):
        mesh, kept, weights = ctx.mesh, ctx.kept, ctx.weights
        P, p = mesh.shape["pp"], mesh.coord("pp")
        M = len(kept)
        d_w = [torch.zeros_like(w) for w in weights]
        d_xs = torch.zeros_like(d_out) if ctx.input_grad else None
        g_next = None
        for t in reversed(range(M + P - 1)):
            m, dx = t - p, None
            if 0 <= m < M:
                g = d_out[m] if p == P - 1 else g_next
                x = kept[m].detach().requires_grad_(p > 0 or ctx.input_grad)
                with torch.enable_grad():
                    y = ctx.run(m, x)
                inputs = ([x] if x.requires_grad else []) + list(weights)
                grads = torch.autograd.grad(y, inputs, g, allow_unused=True)
                if x.requires_grad:
                    dx, grads = grads[0], grads[1:]
                for acc, gw in zip(d_w, grads):
                    if gw is not None:
                        acc += gw
                if d_xs is not None:
                    d_xs[m] = dx
            g_next = _hand_off(mesh, dx if p > 0 else None,
                               kept[0] if p < P - 1 and 0 <= t - 1 - p < M else None, -1)
        return (None, None, d_xs, *d_w)


def pipeline_forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, T] this dp rank's rows
    positions: torch.Tensor,     # [B, T]
    mesh,
    num_microbatches: int,
) -> torch.Tensor:
    """Run the stack pipelined over `mesh`'s pp axis; `params` are this
    rank's shards (its stage's layers). Returns hidden states [B, T, H]
    after the final norm on every stage: the contract of
    ``forward(...)[0]`` on the no-cache path, so callers unembed the same
    way. Requires num_layers % pp == 0 and batch % num_microbatches == 0."""
    n_stages = mesh.shape["pp"]
    M = num_microbatches
    B, T = tokens.shape
    if cfg.num_layers % n_stages != 0:
        raise ValueError(f"pp={n_stages} must divide num_layers={cfg.num_layers}")
    if B % M != 0:
        raise ValueError(f"microbatches={M} must divide batch={B}")
    layers = params["layers"]
    run_len = cfg.num_layers // n_stages
    if len(layers) != run_len:
        raise ValueError(
            f"stage holds {len(layers)} layers, expected {run_len} "
            "(pass parallel.sharding.shard_params' output)"
        )
    p = mesh.coord("pp")
    first = p * run_len
    pos = positions.reshape(M, B // M, T)
    dtype = params["embed"].dtype

    if p == 0:
        xs = embed_tokens(params, cfg, tokens, mesh).reshape(M, B // M, T, -1)
    else:
        xs = torch.zeros((M, B // M, T, cfg.hidden_size), dtype=dtype, device=tokens.device)

    def run(m, x):
        attend = make_causal_attend(cfg, pos[m])
        for i, layer in enumerate(layers):
            x = apply_layer(layer, first + i, x, pos[m], cfg, attend, mesh)
        return x

    weights = [w for w in _tensors(layers) if w.requires_grad]
    hidden = _GPipe.apply(run, mesh, xs, *weights)     # zeros off the last stage
    hidden = reduce_from(hidden.reshape(B, T, -1), mesh, "pp")
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0
    return rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps, norm_offset)


def _tensors(node):
    if isinstance(node, dict):
        for child in node.values():
            yield from _tensors(child)
    elif isinstance(node, list):
        for child in node:
            yield from _tensors(child)
    elif isinstance(node, torch.Tensor):
        yield node
