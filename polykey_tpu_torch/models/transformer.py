"""Config-driven transformer over the paged KV cache (the reference's
models/transformer.py, serving path).

Parameters are a plain dict: "embed" [V, H], "final_norm" [H], optional
"lm_head" [H, V], and "layers", a LIST of per-layer dicts ("attn": wq, wk,
wv, wo; "ln1", "ln2"; "mlp": gate, up, down; Gemma's "post_ln1/2"). The
stack is a Python loop over that list — the reference's stacked [L, ...]
arrays driven by lax.scan become one dict per layer. Weights keep the
[in, out] layout (`x @ w`). models/interop.py converts the reference's
stacked pytree into this form.

Only dense models are ported: MoE layers (Mixtral) are a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import ModelConfig
from .layers import mlp, qkv_project, rms_norm, rope
from .quant import embed_lookup, qdot, unembed_logits


def _normal(shape, std, dtype, device, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=device) * std


def init_params(
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """Random weights drawn like the reference's init_params: normal x
    fan-in^-0.5 for every matrix, norm gains initialized so the effective
    gain is 1. Drawn on `device` from `generator` (which must live on the
    same device), in `dtype`."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE models are not ported to polykey_tpu_torch yet — "
            "ROADMAP.md queue A, 'Gemma-2 and Mixtral families'"
        )
    h, d, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0

    def norm_init():
        return torch.full((h,), 1.0 - norm_offset, dtype=dtype, device=device)

    def normal(shape, fan_in):
        return _normal(shape, fan_in ** -0.5, dtype, device, generator)

    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "attn": {
                "wq": normal((h, cfg.num_heads * d), h),
                "wk": normal((h, cfg.num_kv_heads * d), h),
                "wv": normal((h, cfg.num_kv_heads * d), h),
                "wo": normal((cfg.num_heads * d, h), cfg.num_heads * d),
            },
            "ln1": norm_init(),
            "ln2": norm_init(),
            "mlp": {
                "gate": normal((h, inter), h),
                "up": normal((h, inter), h),
                "down": normal((inter, h), inter),
            },
        }
        if cfg.use_post_norms:
            layer["post_ln1"] = norm_init()
            layer["post_ln2"] = norm_init()
        layers.append(layer)
    params = {
        "embed": normal((cfg.vocab_size, h), h),
        "layers": layers,
        "final_norm": norm_init(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((h, cfg.vocab_size), h)
    return params


def layer_window(cfg: ModelConfig, layer_idx: int) -> Optional[int]:
    """Gemma-2 interleaving: even layers sliding-window, odd layers global."""
    if cfg.sliding_window is None:
        return None
    return cfg.sliding_window if layer_idx % 2 == 0 else cfg.max_seq_len


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (+ Gemma's sqrt(H) scaling)."""
    x = embed_lookup(params["embed"], tokens)
    if cfg.scale_embeddings:
        x = (x.float() * cfg.hidden_size ** 0.5).to(x.dtype)
    return x


def apply_layer(layer_params: dict, layer_idx: int, x, positions, cfg: ModelConfig, attend):
    """One transformer block. The KV mechanics are injected via
    `attend(layer_idx, q, k, v) -> ctx` [B, T, Hq, D]."""
    B, T = x.shape[:2]
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0
    eps = cfg.rms_norm_eps

    h = rms_norm(x, layer_params["ln1"], eps, norm_offset)
    q, k, v = qkv_project(layer_params["attn"], h, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    ctx = attend(layer_idx, q, k, v)

    attn_out = qdot(ctx.reshape(B, T, cfg.num_heads * cfg.head_dim),
                    layer_params["attn"]["wo"])
    if cfg.use_post_norms:
        attn_out = rms_norm(attn_out, layer_params["post_ln1"], eps, norm_offset)
    x = x + attn_out

    h = rms_norm(x, layer_params["ln2"], eps, norm_offset)
    mlp_out = mlp(layer_params["mlp"], h, cfg.activation)
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, layer_params["post_ln2"], eps, norm_offset)
    return x + mlp_out


def forward_paged(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, T] int, right-padded
    positions: torch.Tensor,     # [B, T] int32 absolute positions
    paged,                       # engine.kv_cache.PagedKV
    page_tables: torch.Tensor,   # [B, P] int32
    *,
    aligned: Optional[bool] = None,
):
    """Forward pass over the paged KV cache; returns (hidden [B, T, H],
    paged). New K/V are written into the pools in place before attention
    reads them; prefill (T = bucket) attends through the gathered window
    and the flash kernel, decode (T = 1) through the paged decode kernel.
    `aligned` (see ops.paged_attention.paged_write) is decided once for
    all layers: by the caller on the host, or here from `positions`."""
    from ..ops.paged_attention import paged_attention, paged_write, positions_aligned
    from ..ops.paged_attention_kernel import paged_attention_decode

    T, ps = tokens.shape[1], paged.k.shape[2]
    decode = T == 1
    op = paged_attention_decode if decode else paged_attention
    if aligned is None and not decode and T % ps == 0:
        aligned = positions_aligned(positions, ps)

    def attend(layer_idx, q, k, v):
        kc, vc = paged.k[layer_idx], paged.v[layer_idx]
        paged_write(kc, vc, k, v, page_tables, positions, aligned=aligned)
        return op(
            q, kc, vc, page_tables, positions,
            scale=cfg.q_scale,
            logit_softcap=cfg.attn_logit_softcap,
            window=layer_window(cfg, layer_idx),
        )

    x = embed_tokens(params, cfg, tokens)
    for i, layer in enumerate(params["layers"]):
        x = apply_layer(layer, i, x, positions, cfg, attend)
    norm_offset = 1.0 if cfg.scale_embeddings else 0.0
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, norm_offset)
    return x, paged


def unembed(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project hidden states to fp32 vocab logits, applying Gemma's final
    soft-cap. Callers gather the rows they need first."""
    if cfg.tie_embeddings:
        logits = unembed_logits(hidden, params["embed"], tied=True)
    else:
        logits = unembed_logits(hidden, params["lm_head"], tied=False)
    if cfg.final_logit_softcap is not None:
        logits = cfg.final_logit_softcap * torch.tanh(
            logits / cfg.final_logit_softcap
        )
    return logits
