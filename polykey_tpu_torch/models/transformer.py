"""Config-driven transformer (the reference's models/transformer.py): the
serving path over the paged KV cache, and `forward` over a contiguous
cache (offline generation, models/generate.py) or none (scoring).

Parameters are a plain dict: "embed" [V, H], "final_norm" [H], optional
"lm_head" [H, V], and "layers", a LIST of per-layer dicts ("attn": wq, wk,
wv, wo; "ln1", "ln2"; "mlp": gate, up, down; Gemma's "post_ln1/2"). The
stack is a Python loop over that list — the reference's stacked [L, ...]
arrays driven by lax.scan become one dict per layer. Weights keep the
[in, out] layout (`x @ w`). A MoE layer (Mixtral) holds "router" [H, E]
and "experts": gate, up, down stacked [E, in, out], in place of "mlp".
Any linear may be a models.quant.QuantizedTensor. models/interop.py
converts the reference's stacked pytree into this form.

Over a mesh (`mesh=` on `embed_tokens`, `apply_layer`, `forward` and
`unembed`; parallel/mesh.py) the parameters are a rank's local shards
(parallel/sharding.shard_params) and the collectives are placed here, as
the reference's GSPMD places them: each rank runs its local heads and MLP
columns, the row-parallel wo/down outputs are summed over tp, the
vocabulary-split embedding is looked up locally and summed over tp, and
the logits are gathered over tp (parallel/collectives.py gives each its
gradient). Sequence parallelism mounts through `make_sp_override`.
`forward_paged` serves over a mesh too (the reference's shard_mapped
kernels): tp's local heads, a decode batch's dp lanes, a prefill window's
sp columns, pp's stages in turn (each its run of layers and the pools of
those layers). `forward_ragged` serves tp-at-most meshes (the reference's
rule): the ragged kernel on a rank's local heads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.attention import attention
from ..ops.moe import moe_mlp, moe_mlp_dispatch, moe_mlp_sharded
from ..parallel.collectives import copy_to, gather_from, reduce_from, stage_hop
from .config import ModelConfig
from .layers import mlp, qkv_project, rms_norm, rope
from .quant import embed_lookup, qdot, quantize, quantize_embed, quantize_tree, unembed_logits


@dataclass
class KVCache:
    """Contiguous per-layer KV cache, [num_layers, B, S, num_kv_heads,
    head_dim]: slot s of a row holds the token at position s. The simple
    generation path (a fixed batch to a fixed length); the engine serves
    from the paged cache (engine/kv_cache.py)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cpu") -> KVCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _normal(shape, std, dtype, device, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=device) * std


def init_params(
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    generator: Optional[torch.Generator] = None,
    quantize_bits: Optional[int] = None,
    mesh=None,
) -> dict:
    """Random weights drawn like the reference's init_params: normal x
    fan-in^-0.5 for every matrix (a MoE router hidden^-0.5, the experts'
    stacks like a dense MLP's matrices), norm gains initialized so the
    effective gain is 1. Drawn on `device` from `generator` (which must
    live on the same device), in `dtype`.

    With `quantize_bits` (8 or 4) each layer is quantized as soon as it is
    drawn, then the embedding and lm_head, so only one layer is ever held
    in `dtype`: the same tree as `quantize_params(init_params(...))` from
    the same generator, for a model whose `dtype` weights do not fit on
    the card.

    With `mesh` (a serving mesh) each layer, then the embedding and
    lm_head, is cut to this rank's tp/ep shard as soon as it is drawn (and
    quantized), and only this rank's pp stage's run of layers is kept
    (every layer is drawn on every rank, so the draws stay the same):
    `shard_params(init_params(...), cfg, mesh)` from the same generator,
    holding one whole layer at a time."""
    if mesh is not None:
        from ..parallel.sharding import shard_tree

        def shard(name, node):
            return shard_tree({name: node}, mesh)[name]
    else:
        def shard(name, node):
            return node
    h, d, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0

    def norm_init():
        return torch.full((h,), 1.0 - norm_offset, dtype=dtype, device=device)

    def normal(shape, fan_in):
        return _normal(shape, fan_in ** -0.5, dtype, device, generator)

    def mlp_params(*lead):
        """gate, up, down, each stacked over `lead` (the experts)."""
        return {"gate": normal((*lead, h, inter), h), "up": normal((*lead, h, inter), h),
                "down": normal((*lead, inter, h), inter)}

    keep = stage_layers(cfg, mesh)
    layers = []
    for i in range(cfg.num_layers):
        layer = {
            "attn": {
                "wq": normal((h, cfg.num_heads * d), h),
                "wk": normal((h, cfg.num_kv_heads * d), h),
                "wv": normal((h, cfg.num_kv_heads * d), h),
                "wo": normal((cfg.num_heads * d, h), cfg.num_heads * d),
            },
            "ln1": norm_init(),
            "ln2": norm_init(),
        }
        if cfg.is_moe:
            layer["router"] = normal((h, cfg.num_experts), h)
            layer["experts"] = mlp_params(cfg.num_experts)
        else:
            layer["mlp"] = mlp_params()
        if cfg.use_post_norms:
            layer["post_ln1"] = norm_init()
            layer["post_ln2"] = norm_init()
        if i not in keep:
            continue                 # another stage's layer: drawn, not kept
        if quantize_bits is not None:
            layer = quantize_tree(layer, quantize_bits)
        layers.append(shard("layers", [layer])[0])
    embed = normal((cfg.vocab_size, h), h)
    params = {
        "embed": shard("embed", embed if quantize_bits is None else quantize_embed(embed)),
        "layers": layers,
        "final_norm": norm_init(),
    }
    if not cfg.tie_embeddings:
        head = normal((h, cfg.vocab_size), h)
        params["lm_head"] = shard(
            "lm_head", head if quantize_bits is None else quantize(head, bits=8))
    return params


def stage_layers(cfg: ModelConfig, mesh=None) -> range:
    """The global indices of the layers this rank's pp stage holds: a run
    of num_layers / pp (all of them without a mesh or at pp 1), as
    parallel/sharding.shard_params cuts them."""
    pp = mesh.shape["pp"] if mesh is not None else 1
    run = cfg.num_layers // pp
    start = mesh.coord("pp") * run if pp > 1 else 0
    return range(start, start + run)


def layer_window(cfg: ModelConfig, layer_idx: int) -> Optional[int]:
    """Gemma-2 interleaving: even layers sliding-window, odd layers global."""
    if cfg.sliding_window is None:
        return None
    return cfg.sliding_window if layer_idx % 2 == 0 else cfg.max_seq_len


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Token embedding lookup (+ Gemma's sqrt(H) scaling). Over a mesh the
    embedding is this rank's vocabulary rows: ids outside them read 0, and
    the lookups are summed over tp (ids past the vocabulary clamp to its
    last row first, as on one device)."""
    if mesh is None:
        x = embed_lookup(params["embed"], tokens)
    else:
        rows = params["embed"].shape[0]
        ids = tokens.clamp(0, rows * mesh.shape["tp"] - 1) - mesh.coord("tp") * rows
        mine = (ids >= 0) & (ids < rows)
        x = embed_lookup(params["embed"], ids.clamp(0, rows - 1))
        x = reduce_from(torch.where(mine[..., None], x, torch.zeros_like(x)), mesh, "tp")
    if cfg.scale_embeddings:
        x = (x.float() * cfg.hidden_size ** 0.5).to(x.dtype)
    return x


def _moe_mlp(layer_params: dict, h: torch.Tensor, cfg: ModelConfig, mesh=None,
             split: tuple = ()) -> torch.Tensor:
    if mesh is not None:
        return moe_mlp_sharded(layer_params, h, cfg, mesh, split)
    if cfg.moe_dispatch:
        return moe_mlp_dispatch(layer_params, h, cfg)
    return moe_mlp(layer_params, h, cfg)


def apply_layer(layer_params: dict, layer_idx: int, x, positions, cfg: ModelConfig, attend,
                mesh=None, split: tuple = ()):
    """One transformer block at global layer index `layer_idx`. The KV
    mechanics are injected via `attend(layer_idx, q, k, v) -> ctx`
    [B, T, Hq, D]. Over a mesh: local heads and MLP columns, the
    row-parallel outputs summed over tp before Gemma's post-norms; `split`
    names the (axis, dimension) pairs the batch's tokens are split over,
    for the capacity-bucketed MoE's whole-batch routing
    (ops/moe.moe_mlp_sharded)."""
    B, T = x.shape[:2]
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0
    eps = cfg.rms_norm_eps

    h = rms_norm(x, layer_params["ln1"], eps, norm_offset)
    if mesh is not None:
        h = copy_to(h, mesh, "tp")
    q, k, v = qkv_project(layer_params["attn"], h, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    ctx = attend(layer_idx, q, k, v)

    attn_out = qdot(ctx.reshape(B, T, -1), layer_params["attn"]["wo"])
    if mesh is not None:
        attn_out = reduce_from(attn_out, mesh, "tp")
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, layer_params["post_ln1"], eps, norm_offset)
    x = x + attn_out

    h = rms_norm(x, layer_params["ln2"], eps, norm_offset)
    if cfg.is_moe:
        mlp_out = _moe_mlp(layer_params, h, cfg, mesh, split)
    elif mesh is not None:
        mlp_out = reduce_from(mlp(layer_params["mlp"], copy_to(h, mesh, "tp"), cfg.activation),
                              mesh, "tp")
    else:
        mlp_out = mlp(layer_params["mlp"], h, cfg.activation)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, layer_params["post_ln2"], eps, norm_offset)
    return x + mlp_out


def make_causal_attend(cfg: ModelConfig, positions: torch.Tensor):
    """No-cache causal attention over `positions` [B, T]: each query sees
    the current tokens at or before its position (inside the layer's
    window for Gemma's sliding layers), through the plain attention."""
    q_pos = positions[:, :, None]
    kv_pos = positions[:, None, :]

    def attend(layer_idx, q, k, v):
        mask = kv_pos <= q_pos
        window = layer_window(cfg, layer_idx)
        if window is not None:
            mask = mask & (kv_pos > q_pos - window)
        return attention(q, k, v, mask, scale=cfg.q_scale,
                         logit_softcap=cfg.attn_logit_softcap)

    return attend


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, T] int, right-padded
    positions: torch.Tensor,     # [B, T] int32 absolute positions
    cache: Optional[KVCache] = None,
    attn_override=None,          # (layer_idx, q, k, v) -> ctx; no-cache only
    mesh=None,                   # local shards over a mesh; no-cache only
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Run the stack; returns (hidden [B, T, H], cache).

    With a cache: each layer writes its new K/V at their positions (in
    place, `index_put_`; every position must lie inside the cache, which
    raises on one that does not) and attends over the whole cache through
    `ops.flash_attention.flash_attention` with the layer's window and the
    soft-cap (the flash kernel on the card where its geometry gate holds,
    T >= 128 and S >= 128; the plain attention otherwise): prefill and
    decode share this path. Without one (scoring): causal attention over
    the current tokens (`make_causal_attend`), or `attn_override`.

    With `mesh`: `params` are this rank's shards (its tp heads and
    columns, its ep experts) and tokens its batch rows (and, with an sp
    override, its columns); the stack is the whole model's, so pp must be
    1 here (parallel/pipeline.py runs pp > 1)."""
    if mesh is not None and (cache is not None or mesh.shape["pp"] > 1):
        raise ValueError(
            "a sharded forward runs without a cache and with pp == 1 "
            "(parallel.pipeline.pipeline_forward runs pp > 1)"
        )
    if cache is not None and attn_override is not None:
        raise ValueError(
            "attn_override applies to the no-cache path only (the cached "
            "path would silently ignore it and run full attention over the "
            "gathered cache, defeating the override's purpose)"
        )
    if cache is not None:
        from ..ops.flash_attention import flash_attention

        rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
        idx = (rows.expand_as(positions), positions.long())

        def attend(layer_idx, q, k, v):
            kc, vc = cache.k[layer_idx], cache.v[layer_idx]
            kc.index_put_(idx, k.to(kc.dtype))
            vc.index_put_(idx, v.to(vc.dtype))
            return flash_attention(
                q, kc, vc, positions,
                scale=cfg.q_scale,
                logit_softcap=cfg.attn_logit_softcap,
                window=layer_window(cfg, layer_idx),
            )
    else:
        attend = attn_override or make_causal_attend(cfg, positions)

    x = embed_tokens(params, cfg, tokens, mesh)
    for i, layer in enumerate(params["layers"]):
        x = apply_layer(layer, i, x, positions, cfg, attend, mesh)
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, norm_offset)
    return x, cache


def forward_paged(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, T] int, right-padded
    positions: torch.Tensor,     # [B, T] int32 absolute positions
    paged,                       # engine.kv_cache.PagedKV
    page_tables: torch.Tensor,   # [B, P] int32
    *,
    aligned: Optional[bool] = None,
    mesh=None,                   # serving mesh (parallel/mesh.py)
    dp_lanes: Optional[bool] = None,
):
    """Forward pass over the paged KV cache; returns (hidden [B, T, H],
    paged). New K/V are written into the pools in place before attention
    reads them; prefill (T = bucket) attends through the gathered window
    and the flash kernel, decode (T = 1) through the paged decode kernel.
    `aligned` (see ops.paged_attention.paged_write) is decided once for
    all layers: by the caller on the host, or here from `positions`. With
    int8 pools (`paged.quantized`) each layer's cache operands are
    (values, scales) pairs, on which the write and read ops dispatch.

    Over a mesh, as the reference shards it: `params` and the pools are
    this rank's tp shards (its local heads; the same kernels run on
    them). A decode batch is this rank's dp share of the lanes: its new
    K/V rows, page tables and positions are all-gathered over dp before
    the write, since every replica of the pools holds every lane; under
    sp each rank reads a page sub-range and the states merge over sp
    (ops.paged_attention_kernel.paged_attention_decode). A prefill batch
    is whole on every rank and its T columns split over sp: each rank
    computes its T / sp columns, K and V are all-gathered over sp before
    the write, flash runs the rank's query block against the whole window
    from the pools, and the hidden states are gathered back, so the result
    is [B, T, H] on every rank. `dp_lanes` (default: T == 1) says the
    batch is this rank's dp share of the decode lanes, as a speculative
    round's verify window of T = gamma + 1 is: its K/V rows are gathered
    over dp before the write and its columns are not split over sp. A
    capacity-bucketed MoE layer is told which axis splits the tokens, and
    routes over the whole batch (ops/moe.moe_mlp_sharded).

    Under pp the stages run in turn: stage 0 embeds, each stage runs its
    run of layers on its own pools (`paged` holds that run's layers; a
    layer's pool is found by its local index, its Gemma-2 window by its
    global one) and hops its output to the next (`stage_hop`); the last
    stage's output hops back to every stage, and every rank applies the
    final norm, so every rank returns the same hidden states and samples
    the same tokens from them."""
    from ..ops.paged_attention import paged_attention, paged_write, positions_aligned
    from ..ops.paged_attention_kernel import paged_attention_decode

    T, ps = tokens.shape[1], paged.k.shape[2]
    decode = T == 1
    lanes = decode if dp_lanes is None else dp_lanes
    op = paged_attention_decode if decode else paged_attention
    if aligned is None and not decode and T % ps == 0:
        aligned = positions_aligned(positions, ps)
    shape = mesh.shape if mesh is not None else {}
    gather_dp = lanes and shape.get("dp", 1) > 1         # KV rows over dp
    split_sp = not lanes and shape.get("sp", 1) > 1      # columns over sp
    first = stage_layers(cfg, mesh).start
    write_tables, write_pos = page_tables, positions
    if gather_dp:
        write_tables = gather_from(page_tables, mesh, "dp", 0)
        write_pos = gather_from(positions, mesh, "dp", 0)
    if split_sp:
        n = T // shape["sp"]
        cols = slice(mesh.coord("sp") * n, (mesh.coord("sp") + 1) * n)
        tokens, positions = tokens[:, cols], positions[:, cols]
    # The decode op splits its pages over sp; flash decides on the whole
    # window's T, as the reference's shard_map does, not on the block's.
    kw = {"mesh": mesh} if decode else {"dispatch_T": T}

    def attend(layer_idx, q, k, v):
        kc, vc = paged.layer(layer_idx - first)
        if gather_dp or split_sp:
            kv = gather_from(torch.cat([k, v], dim=-1), mesh,
                             "dp" if gather_dp else "sp", 0 if gather_dp else 1)
            k, v = (t.contiguous() for t in kv.split(k.shape[-1], dim=-1))
        paged_write(kc, vc, k, v, write_tables, write_pos, aligned=aligned)
        return op(
            q, kc, vc, page_tables, positions,
            scale=cfg.q_scale,
            logit_softcap=cfg.attn_logit_softcap,
            window=layer_window(cfg, layer_idx),
            **kw,
        )

    split = (("dp", 0),) if gather_dp else (("sp", 1),) if split_sp else ()
    x = _stages(params, cfg, tokens, positions, attend, mesh, split)
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, norm_offset)
    if split_sp:
        x = gather_from(x, mesh, "sp", 1)
    return x, paged


def _stages(params: dict, cfg: ModelConfig, tokens, positions, attend, mesh,
            split: tuple = ()):
    """The embedding and this rank's layers, before the final norm. Over
    pp > 1 the stages take turns: stage s runs its layers on what stage
    s - 1 hopped to it, then hops its output on; the last hop (from the
    last stage) reaches every stage. Every stage issues the same pp hops
    in the same order, so the lock-step order holds."""
    pp = mesh.shape["pp"] if mesh is not None else 1
    stage = mesh.coord("pp") if pp > 1 else 0
    first = stage_layers(cfg, mesh).start
    x = embed_tokens(params, cfg, tokens, mesh) if stage == 0 else None
    for s in range(pp):
        if s == stage:
            for i, layer in enumerate(params["layers"]):
                x = apply_layer(layer, first + i, x, positions, cfg, attend, mesh, split)
        if pp > 1:
            if x is None:       # the hop's landing buffer, before any hop reached us
                x = torch.empty((*tokens.shape, cfg.hidden_size),
                                dtype=params["final_norm"].dtype, device=tokens.device)
            x = stage_hop(x, mesh, s)
    return x


def forward_ragged(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [T] int flat token stream
    positions: torch.Tensor,     # [T] int32 absolute positions
    paged,                       # engine.kv_cache.PagedKV
    token_tables: torch.Tensor,  # [T, P] int32 per-TOKEN table rows
    seq_starts: torch.Tensor,    # [S] int32 ragged range starts
    seq_lens: torch.Tensor,      # [S] int32 new-token counts
    kv_lens: torch.Tensor,       # [S] int32 KV lengths (new incl.)
    page_tables: torch.Tensor,   # [S, P] int32 per-SEQUENCE tables
    *,
    work=None,
    mesh=None,                   # serving mesh of tp (and ep) only
):
    """Forward pass over a ragged flat token stream: decode and prefill
    tokens of many sequences in one call, each attending over its own
    paged KV; returns (hidden [T, H], paged).

    Position-wise compute runs on the stream as a [1, T] batch. The KV
    write goes through paged_write's T == 1 path with one row per token
    ([T, 1], the decode write kernel); attention through
    ragged_paged_attention, whose kernel takes `work`
    (ops.ragged_paged_attention_kernel.ragged_work) from a caller that knows
    the ranges on the host. Padding rows carry position 0 and all-garbage
    table rows: they write to the reserved garbage page, like inactive
    decode lanes. int8 pools go to each layer as (values, scales) pairs,
    as in forward_paged.

    Over a mesh (tp-at-most, the reference's rule for the ragged dispatch:
    the flat stream does not shard over dp, sp or pp) every rank runs the
    whole stream on its local heads and MLP columns, with apply_layer's
    collectives: the write and the ragged kernel take the rank's Hq / tp,
    Hk / tp heads, and `work` must be cut for Hk / tp kv heads."""
    from ..ops.paged_attention import paged_write
    from ..ops.ragged_paged_attention_kernel import ragged_paged_attention

    if mesh is not None and max(mesh.shape["dp"], mesh.shape["sp"], mesh.shape["pp"]) > 1:
        raise ValueError(f"the ragged forward serves tp-at-most meshes, not {mesh.shape}")
    T = tokens.shape[0]
    pos_row = positions.reshape(T, 1)

    def attend(layer_idx, q, k, v):
        kc, vc = paged.layer(layer_idx)
        paged_write(kc, vc, k.reshape(T, 1, *k.shape[2:]),
                    v.reshape(T, 1, *v.shape[2:]), token_tables, pos_row)
        ctx = ragged_paged_attention(
            q[0], kc, vc, page_tables, seq_starts, seq_lens, kv_lens,
            scale=cfg.q_scale,
            logit_softcap=cfg.attn_logit_softcap,
            window=layer_window(cfg, layer_idx),
            work=work,
        )
        return ctx[None]

    x = embed_tokens(params, cfg, tokens[None], mesh)
    for i, layer in enumerate(params["layers"]):
        x = apply_layer(layer, i, x, positions[None], cfg, attend, mesh)
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, norm_offset)
    return x[0], paged


def make_sp_override(cfg: ModelConfig, mesh, positions: torch.Tensor, impl: str = "ring"):
    """An attn_override that runs attention sequence-parallel over the
    mesh's sp axis: ``impl="ring"`` rotates K/V around the sp ring
    (ops/ring_attention.py: any head count, sp - 1 hops), ``"ulysses"``
    re-splits heads with all-to-all (ops/ulysses_attention.py: two
    exchanges, per-rank head counts divisible by sp). `positions` are this
    rank's [B, T / sp] columns. The scale, soft-cap and each layer's window
    are wired here, beside the dense attend. None when sp is 1."""
    if mesh is None or mesh.shape.get("sp", 1) <= 1:
        return None
    if impl == "ring":
        from ..ops.ring_attention import ring_attention_spmd as sp_attention
    elif impl == "ulysses":
        from ..ops.ulysses_attention import ulysses_attention_spmd as sp_attention
    else:
        raise ValueError(f"unknown sp attention impl {impl!r}")

    def override(layer_idx, q, k, v):
        return sp_attention(
            q, k, v, positions, positions, mesh,
            scale=cfg.q_scale,
            logit_softcap=cfg.attn_logit_softcap,
            window=layer_window(cfg, layer_idx),
        )

    return override


def make_ring_override(cfg: ModelConfig, mesh, positions: torch.Tensor):
    """make_sp_override with impl="ring" (the reference keeps this name)."""
    return make_sp_override(cfg, mesh, positions, impl="ring")


def unembed(params: dict, cfg: ModelConfig, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """Project hidden states to fp32 vocab logits, applying Gemma's final
    soft-cap. Callers gather the rows they need first. Over a mesh each tp
    rank projects onto its vocabulary columns (a tied embedding's rows) and
    the logits are gathered over tp, so every rank holds all of them."""
    if mesh is not None:
        hidden = copy_to(hidden, mesh, "tp")
    if cfg.tie_embeddings:
        logits = unembed_logits(hidden, params["embed"], tied=True)
    else:
        logits = unembed_logits(hidden, params["lm_head"], tied=False)
    if mesh is not None:
        logits = gather_from(logits, mesh, "tp", dim=-1)
    if cfg.final_logit_softcap is not None:
        logits = cfg.final_logit_softcap * torch.tanh(
            logits / cfg.final_logit_softcap
        )
    return logits
