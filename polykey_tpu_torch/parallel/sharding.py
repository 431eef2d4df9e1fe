"""Partition specs: how parameters, caches and batches split over the mesh
(the reference's parallel/sharding.py).

Megatron tensor parallelism for the block: column-parallel first products
(wq/wk/wv, gate/up split their *output* features over ``tp``), row-parallel
second products (wo, down split their *input* features), so a block's only
tp traffic is the sum of the row-parallel outputs (models/transformer.py
places the collectives, parallel/collectives.py). The embedding and
lm_head split the vocabulary over ``tp``; MoE expert stacks split over
``ep``; a layer's leading spec entry is ``pp`` (the reference's stacked
layer axis, here a rank's run of the `layers` list). The spec table is
data keyed as the reference's, so the two stay comparable leaf by leaf.

`shard_params` gives each rank its local slice of every leaf. A slice that
is the whole leaf is the leaf itself (no copy), so a one-rank mesh shares
the caller's tensors.

GQA constraint: num_kv_heads must divide by tp (Llama-3-8B: 8 kv heads ->
tp in {1, 2, 4, 8}).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.quant import QuantizedTensor
from .mesh import Mesh


class P(tuple):
    """A partition spec: one mesh axis name (or None, replicated) per
    dimension, as jax.sharding.PartitionSpec."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# Leaf path within a layer -> spec *without* the leading layer axis (added
# uniformly below as the pp dimension).
_LAYER_RULES: dict[tuple[str, ...], P] = {
    ("attn", "wq"): P(None, "tp"),
    ("attn", "wk"): P(None, "tp"),
    ("attn", "wv"): P(None, "tp"),
    ("attn", "wo"): P("tp", None),
    ("mlp", "gate"): P(None, "tp"),
    ("mlp", "up"): P(None, "tp"),
    ("mlp", "down"): P("tp", None),
    ("router",): P(None, None),
    ("experts", "gate"): P("ep", None, "tp"),
    ("experts", "up"): P("ep", None, "tp"),
    ("experts", "down"): P("ep", "tp", None),
    ("ln1",): P(None),
    ("ln2",): P(None),
    ("post_ln1",): P(None),
    ("post_ln2",): P(None),
}

_TOP_RULES: dict[tuple[str, ...], P] = {
    ("embed",): P("tp", None),     # vocab-split; the lookup sums over tp
    ("final_norm",): P(None),
    ("lm_head",): P(None, "tp"),   # logits split over vocab on tp
}


def _spec_for_path(path: tuple[str, ...], leaf=None, mesh: Optional[Mesh] = None) -> P:
    """The reference's spec for the leaf at `path` (layer leaves keyed
    ("layers", ...) without their index). A quantized leaf's `q` keeps the
    weight's spec; an int8 `s` is the weight's spec without the
    contraction (-2) axis; an int4 `s` (group-wise, the weight's rank) keeps
    it, with the group axis replicated when the contraction axis's mesh
    extent does not divide the group count. `leaf` is the port's tensor:
    a layer leaf has no stacked layer axis, so its rank counts one more."""
    if path and path[-1] in ("q", "s"):
        base = _spec_for_path(path[:-1])
        if path[-1] == "q":
            return base
        ndim = getattr(leaf, "ndim", -1)
        if ndim >= 0 and path[0] == "layers":
            ndim += 1
        if ndim == len(base):                # group-wise (int4)
            contr = base[-2]
            if contr is not None and mesh is not None:
                axes = contr if isinstance(contr, tuple) else (contr,)
                size = 1
                for a in axes:
                    size *= mesh.shape[a]
                if leaf.shape[-2] % size != 0:
                    return P(*base[:-2], None, base[-1])
            return base
        return P(*base[:-2], base[-1]) if len(base) >= 2 else base
    if path in _TOP_RULES:
        return _TOP_RULES[path]
    if path and path[0] == "layers":
        layer_path = path[1:]
        if layer_path in _LAYER_RULES:
            return P("pp", *_LAYER_RULES[layer_path])
    raise KeyError(f"no sharding rule for param path {path}")


def _map(fn, node, path=()):
    """`fn(path, leaf)` over the port's tree; a layer's path drops its
    index; a QuantizedTensor's fields are leaves of their own."""
    if isinstance(node, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v, path) for v in node]
    if isinstance(node, QuantizedTensor):
        return QuantizedTensor(q=fn(path + ("q",), node.q), s=fn(path + ("s",), node.s),
                               act_dtype=node.act_dtype, bits=node.bits)
    return fn(path, node)


def param_shardings(cfg: ModelConfig, mesh: Optional[Mesh], params_tree: dict) -> dict:
    """The spec of every leaf, in the tree's own structure."""
    return _map(lambda path, leaf: _spec_for_path(path, leaf, mesh), params_tree)


def local_slice(t: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of `t` under `spec` (one entry per dimension of
    `t`): the leaf itself when nothing splits, a contiguous copy
    otherwise."""
    out = t
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for axis in (axes if isinstance(axes, tuple) else (axes,)):
            n = mesh.shape[axis]
            if n == 1:
                continue
            if out.shape[dim] % n:
                raise ValueError(
                    f"{axis}={n} does not divide dimension {dim} of a "
                    f"{tuple(t.shape)} leaf"
                )
            size = out.shape[dim] // n
            out = out.narrow(dim, mesh.coord(axis) * size, size)
    return out if out is t else out.contiguous()


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    """Each rank's local parameters: its run of `cfg.num_layers / pp`
    layers (global layer index = pp coordinate x run length + local
    index), and of every leaf its slice over tp and ep."""
    pp = mesh.shape["pp"]
    if cfg.num_layers % pp:
        raise ValueError(f"pp={pp} must divide num_layers={cfg.num_layers}")
    run = cfg.num_layers // pp
    start = mesh.coord("pp") * run
    local = dict(params)
    local["layers"] = params["layers"][start:start + run]
    return shard_tree(local, mesh)


def shard_tree(tree: dict, mesh: Mesh) -> dict:
    """Every leaf of `tree` (keyed as the parameter tree is: "embed",
    "lm_head", "layers" a list of layer dicts, ...) sliced to this rank's
    share over tp and ep; the layers list is taken as it is (pp's run is
    `shard_params`' choice). For weights drawn or read a part at a time."""
    def place(path, leaf):
        spec = _spec_for_path(path, leaf, mesh)
        if path[0] == "layers":
            spec = spec[1:]                       # the pp entry: the caller's run
        return local_slice(leaf, spec, mesh)

    return _map(place, tree)


def replicated_over(path: tuple[str, ...], axis: str) -> bool:
    """True when no dimension of the leaf at `path` splits over `axis`."""
    spec = _spec_for_path(path)
    return all(axis != a and not (isinstance(a, tuple) and axis in a) for a in spec)


def batch_spec(ndim: int, seq_axis: Optional[int] = None) -> P:
    """Token batches [B, T, ...]: batch over dp, optionally T over sp."""
    spec = ["dp"] + [None] * (ndim - 1)
    if seq_axis is not None:
        spec[seq_axis] = "sp"
    return P(*spec)


def paged_kv_spec() -> P:
    """Page pools [L, N, page_size, Hk, D]: heads over tp; pages replicate
    over dp (any slot may hold any page)."""
    return P("pp", None, None, "tp", None)


def paged_kv_scale_spec() -> P:
    """int8-KV scale pools [L, N, page_size, Hk]: the data pools'
    placement with the head axis last."""
    return P("pp", None, None, "tp")


def contiguous_kv_spec() -> P:
    """Contiguous cache [L, B, S, Hk, D]: batch over dp, heads over tp."""
    return P("pp", "dp", None, "tp", None)
