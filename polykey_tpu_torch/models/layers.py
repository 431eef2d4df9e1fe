"""Transformer layer primitives (the reference's models/layers.py).

Plain functions on tensors. Linear weights keep the reference's
[in_features, out_features] layout, applied as `x @ w`, so the tests can
hand the same arrays to both implementations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .quant import qdot


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, offset: float = 0.0
) -> torch.Tensor:
    """RMSNorm with fp32 accumulation. Gemma stores weights as (1 + w),
    which callers express via offset=1.0."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + weight.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding, half-split (rotate-half) convention.
    x [B, T, H, D], positions [B, T]; angles in fp32."""
    half = x.shape[-1] // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )                                                       # [half]
    angles = positions.float()[:, :, None] * freqs          # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]                  # [B, T, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return F.silu(x)
    if activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")


def mlp(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU): act(x@gate) * (x@up) @ down."""
    gate = _activate(qdot(x, p["gate"]), activation)
    return qdot(gate * qdot(x, p["up"]), p["down"])


def qkv_project(
    p: dict, x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T, _ = x.shape
    q = qdot(x, p["wq"]).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = qdot(x, p["wk"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = qdot(x, p["wv"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v
