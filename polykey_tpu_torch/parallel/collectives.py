"""Collectives over a mesh axis, with their gradients.

In the reference GSPMD emits every collective of a sharded program and
differentiates through it; here each one is a torch.autograd.Function
whose backward is the collective's transpose:

- `copy_to` / `reduce_from`: the Megatron conjugate pair. `copy_to`
  (identity forward, all-reduce backward) goes where a replicated
  activation enters a column-parallel product; `reduce_from` (all-reduce
  forward, identity backward) sums a row-parallel product's partial
  outputs. With a loss computed the same on every rank of the axis, each
  rank's gradients are then the full ones, not a multiple of them.
- `gather_from` / `split_to`: the all-gather along a dimension and its
  slice, each the other's backward.
- `all_to_all`: the tiled all-to-all (split one dimension, concatenate
  another) whose backward is the inverse exchange.
- `ring_shift`: send to the next rank along the axis and receive from the
  previous one; the backward shifts the other way.

Every call communicates, over a group of one too. Axes may be one name or
a tuple of names (reduced one after another). `all_reduce` is the plain
sum (or another reduction) with no gradient, for counts, reported losses
and the serving path's split-softmax merge. `stage_hop` is the serving
path's pp hop (no gradient): a broadcast over the pp group, so it is a
collective that a CUDA graph captures like the others.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

from .mesh import Mesh

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or `op`, e.g. ReduceOp.MAX) of `x` over `axes` (a new tensor; no
    gradient)."""
    y = x.detach().clone()
    for axis in _axes(axes):
        dist.all_reduce(y, op=op, group=mesh.group(axis))
    return y


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    return _CopyTo.apply(x, mesh, _axes(axes))


def reduce_from(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, _axes(axes))


def _gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def all_gather_along(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' `x` along `axis` concatenated on `dim` in rank order, with
    no gradient (an int tensor's, as the MoE router's choices)."""
    return _gather(x, mesh, axis, dim)


def _split(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    return x.chunk(mesh.shape[axis], dim=dim)[mesh.coord(axis)].contiguous()


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _split(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def gather_from(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather along `dim` in the axis's rank order; backward slices."""
    return _GatherFrom.apply(x, mesh, axis, dim)


def split_to(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous chunk along `dim`; backward all-gathers."""
    return _SplitTo.apply(x, mesh, axis, dim)


def _a2a(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int, concat_dim: int):
    n = mesh.shape[axis]
    ins = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=mesh.group(axis))
    return torch.cat(outs, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return _a2a(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: chunk j of `split_dim` goes to rank j of the axis;
    the chunks received are concatenated along `concat_dim` in rank
    order (jax.lax.all_to_all with tiled=True)."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str, step: int) -> list:
    """Send each tensor `step` ranks on along the axis (cyclically) and
    receive the ones coming from `step` ranks back: posted as pairs with
    batch_isend_irecv, so no rank waits on a send before its receive."""
    ranks = mesh.ranks_along(axis)
    c, n = mesh.coord(axis), len(ranks)
    dst, src = ranks[(c + step) % n], ranks[(c - step) % n]
    group = mesh.group(axis)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for tag, (t, o) in enumerate(zip(tensors, outs)):
        ops.append(dist.P2POp(dist.isend, t, dst, group, tag))
        ops.append(dist.P2POp(dist.irecv, o, src, group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(shift(tensors, mesh, axis, +1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *shift(grads, ctx.mesh, ctx.axis, -1))


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> tuple:
    """Rotate `tensors` one rank on around the axis's ring; the backward
    rotates their gradients one rank back."""
    return _RingShift.apply(mesh, axis, *tensors)


def stage_hop(x: torch.Tensor, mesh: Mesh, stage: int) -> torch.Tensor:
    """Stage `stage`'s `x` on every rank of this rank's pp line, in place
    on the others (their `x` is the buffer it lands in, of the same shape
    and dtype): the serving forward's hop from one stage to the next, and
    from the last stage back to every stage (models/transformer.py). A
    broadcast, not a send: every stage issues the same pp collectives in
    the same order, which keeps the mesh's lock-step order and needs no
    point-to-point capture. No gradient."""
    x = x.contiguous()
    dist.broadcast(x, src=mesh.ranks_along("pp")[stage], group=mesh.group("pp"))
    return x
