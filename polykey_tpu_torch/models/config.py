"""Model architecture configs + registry.

Covers the three served families from BASELINE.json's measurement configs
(Llama-3-8B, Mixtral-8x7B, Gemma-2-27B) plus scaled-down variants of each for
CPU tests and single-chip experiments. Hyperparameters follow the public
model cards / HF config.json values.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    activation: str = "silu"            # "gelu_tanh" for gemma
    # Gemma-2 specifics
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None      # even layers use the window
    query_pre_attn_scalar: Optional[float] = None
    use_post_norms: bool = False              # post-attn/post-mlp RMSNorms
    scale_embeddings: bool = False            # multiply embeds by sqrt(hidden)
    # MoE (Mixtral) specifics
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # Capacity-bucketed sparse dispatch (ops/moe.py: moe_mlp_dispatch) instead
    # of the einsum-dense formulation. On for real MoE sizes — dense pays
    # num_experts/top_k x the dispatch FLOPs; off for tiny test configs,
    # where dispatch's token-drop-on-overflow would perturb exactness checks.
    moe_dispatch: bool = False

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_scale(self) -> float:
        if self.query_pre_attn_scalar is not None:
            return self.query_pre_attn_scalar**-0.5
        return self.head_dim**-0.5

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        embed = self.vocab_size * self.hidden_size
        attn = self.hidden_size * self.head_dim * (
            self.num_heads * 2 + self.num_kv_heads * 2
        )
        if self.is_moe:
            mlp = 3 * self.hidden_size * self.intermediate_size * self.num_experts
            mlp += self.hidden_size * self.num_experts  # router
        else:
            mlp = 3 * self.hidden_size * self.intermediate_size
        norms = self.hidden_size * (4 if self.use_post_norms else 2)
        block = attn + mlp + norms
        head = 0 if self.tie_embeddings else embed
        return embed + self.num_layers * block + self.hidden_size + head

    def num_active_params(self) -> int:
        """Parameters touched per token: for MoE, only the router plus the
        top-k routed experts count (roofline math — per-token FLOPs scale
        with active params, not total)."""
        if not self.is_moe:
            return self.num_params()
        return self.num_params() - (
            self.num_layers * 3 * self.hidden_size * self.intermediate_size
            * (self.num_experts - self.num_experts_per_tok))


LLAMA3_8B = ModelConfig(
    name="llama-3-8b",
    vocab_size=128_256,
    hidden_size=4096,
    intermediate_size=14_336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=8192,
    rope_theta=500_000.0,
)

LLAMA3_70B = ModelConfig(
    name="llama-3-70b",
    vocab_size=128_256,
    hidden_size=8192,
    intermediate_size=28_672,
    num_layers=80,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=8192,
    rope_theta=500_000.0,
)

LLAMA32_1B = ModelConfig(
    name="llama-3.2-1b",
    vocab_size=128_256,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    max_seq_len=8192,
    rope_theta=500_000.0,
    tie_embeddings=True,
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32_000,
    hidden_size=4096,
    intermediate_size=14_336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=8192,
    rope_theta=1_000_000.0,
    num_experts=8,
    num_experts_per_tok=2,
    moe_dispatch=True,
)

GEMMA2_27B = ModelConfig(
    name="gemma-2-27b",
    vocab_size=256_128,
    hidden_size=4608,
    intermediate_size=36_864,
    num_layers=46,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    max_seq_len=8192,
    rope_theta=10_000.0,
    rms_norm_eps=1e-6,
    tie_embeddings=True,
    activation="gelu_tanh",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    query_pre_attn_scalar=144.0,  # hidden_size / num_heads
    use_post_norms=True,
    scale_embeddings=True,
)

GEMMA2_2B = ModelConfig(
    # The family's small member (HF gemma-2-2b config.json values) — the
    # natural speculative DRAFT for gemma-2-9b/27b (same 256k vocab).
    name="gemma-2-2b",
    vocab_size=256_128,
    hidden_size=2304,
    intermediate_size=9216,
    num_layers=26,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    max_seq_len=8192,
    rope_theta=10_000.0,
    rms_norm_eps=1e-6,
    tie_embeddings=True,
    activation="gelu_tanh",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    query_pre_attn_scalar=256.0,
    use_post_norms=True,
    scale_embeddings=True,
)

GEMMA2_9B = ModelConfig(
    name="gemma-2-9b",
    vocab_size=256_128,
    hidden_size=3584,
    intermediate_size=14_336,
    num_layers=42,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    max_seq_len=8192,
    rope_theta=10_000.0,
    rms_norm_eps=1e-6,
    tie_embeddings=True,
    activation="gelu_tanh",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    query_pre_attn_scalar=256.0,
    use_post_norms=True,
    scale_embeddings=True,
)

# Scaled-down variants: same architectural features, CPU-testable sizes.
TINY_LLAMA = ModelConfig(
    name="tiny-llama",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_seq_len=128,
    rope_theta=10_000.0,
)

TINY_MIXTRAL = replace(
    TINY_LLAMA,
    name="tiny-mixtral",
    num_experts=4,
    num_experts_per_tok=2,
)

TINY_GEMMA = replace(
    TINY_LLAMA,
    name="tiny-gemma",
    tie_embeddings=True,
    activation="gelu_tanh",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=16,
    query_pre_attn_scalar=16.0,
    use_post_norms=True,
    scale_embeddings=True,
)

# A mid-size llama for single-chip benchmarking without 8B's 16 GiB of bf16
# weights (v5e has 16 GiB HBM; 8B serves in int8 — see engine docs).
LLAMA_1B_BENCH = replace(LLAMA32_1B, name="llama-1b-bench")

# Mixtral ARCHITECTURE (8 experts, top-2, dispatch routing) scaled to
# ~4.7 B params so the int8 tree (~4.7 GiB) + KV fits one v5e chip:
# hardware evidence for measurement config 4's mechanism (MoE routing +
# grouped expert matmuls) without 8x7B's 47 B params, which need tp>=4.
MIXTRAL_BENCH = replace(
    MIXTRAL_8X7B,
    name="mixtral-bench",
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
)

MODEL_REGISTRY = {
    cfg.name: cfg
    for cfg in (
        LLAMA3_8B,
        LLAMA3_70B,
        LLAMA32_1B,
        MIXTRAL_8X7B,
        GEMMA2_27B,
        GEMMA2_9B,
        GEMMA2_2B,
        TINY_LLAMA,
        TINY_MIXTRAL,
        TINY_GEMMA,
        LLAMA_1B_BENCH,
        MIXTRAL_BENCH,
    )
}


def get_config(name: str) -> ModelConfig:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}"
        ) from None
