"""The port against an independent implementation (HF transformers), on
the CPU: the port's counterpart of tests/test_golden_hf.py.

Tiny random-init real-architecture HF models (LlamaForCausalLM,
MixtralForCausalLM, Gemma2ForCausalLM, float32, eager attention) are
saved as safetensors with `save_pretrained` and loaded through the port's
own loader (models/loader.py, no safetensors package). The port's
`forward_paged` logits must equal HF's within float32 tolerance (2e-4
absolute, 2e-3 relative, as the JAX package's golden test), with the same
argmax everywhere: Llama's GQA and RoPE, Mixtral's top-2 routing,
Gemma-2's post-norms, soft-caps, query_pre_attn_scalar, scaled
embeddings and its even/odd sliding window. The serving path (a paged
prefill, then one-token decode steps) must give HF's full-sequence
logits too, and a bfloat16 save (BF16 files) loads to the float32
model's weights rounded to bfloat16.
"""

import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from polykey_tpu_torch.engine.kv_cache import init_paged_kv  # noqa: E402
from polykey_tpu_torch.models.config import (  # noqa: E402
    TINY_GEMMA,
    TINY_LLAMA,
    TINY_MIXTRAL,
    ModelConfig,
)
from polykey_tpu_torch.models.loader import load_checkpoint  # noqa: E402
from polykey_tpu_torch.models.transformer import forward_paged, unembed  # noqa: E402

torch.set_num_threads(2)

B, T, PS = 2, 12, 8
ATOL, RTOL = 2e-4, 2e-3


def _hf_config(cfg: ModelConfig):
    """The HF config class matching a port ModelConfig."""
    common = dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, max_position_embeddings=cfg.max_seq_len,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
        tie_word_embeddings=cfg.tie_embeddings,
    )
    if cfg.use_post_norms:
        return transformers.Gemma2Config(
            **common, hidden_activation="gelu_pytorch_tanh",
            attn_logit_softcapping=cfg.attn_logit_softcap,
            final_logit_softcapping=cfg.final_logit_softcap,
            sliding_window=cfg.sliding_window,
            query_pre_attn_scalar=cfg.query_pre_attn_scalar, attention_bias=False)
    if cfg.is_moe:
        common.pop("head_dim")
        return transformers.MixtralConfig(
            **common, num_local_experts=cfg.num_experts,
            num_experts_per_tok=cfg.num_experts_per_tok, hidden_act="silu")
    return transformers.LlamaConfig(**common, hidden_act="silu", attention_bias=False,
                                    mlp_bias=False)


def _save_hf(cfg: ModelConfig, path, seed: int = 0, dtype=torch.float32):
    """A random-init HF twin of `cfg`, saved as safetensors in `dtype`."""
    torch.manual_seed(seed)
    model = transformers.AutoModelForCausalLM.from_config(
        _hf_config(cfg), attn_implementation="eager").to(torch.float32).eval()
    model.to(dtype).save_pretrained(path, safe_serialization=True)
    return model.to(torch.float32)


def _tokens(cfg: ModelConfig, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int64)


def _hf_logits(model, tokens) -> torch.Tensor:
    with torch.no_grad():
        return model(input_ids=torch.from_numpy(tokens)).logits.float()


def _port_logits(params, cfg, tokens, split: int = T) -> torch.Tensor:
    """forward_paged over pages of 8: a prefill of the first `split`
    tokens, then one decode step per token; every position's logits."""
    pages = -(-T // PS)
    paged = init_paged_kv(cfg, 1 + B * pages, PS, torch.float32)
    tables = torch.arange(1, 1 + B * pages, dtype=torch.int32).reshape(B, pages)
    toks = torch.from_numpy(tokens).to(torch.int32)
    pos = torch.arange(split, dtype=torch.int32)[None].repeat(B, 1)
    with torch.inference_mode():
        hidden, paged = forward_paged(params, cfg, toks[:, :split], pos, paged, tables)
        out = [unembed(params, cfg, hidden)]
        for t in range(split, T):
            p = torch.full((B, 1), t, dtype=torch.int32)
            hidden, paged = forward_paged(params, cfg, toks[:, t:t + 1], p, paged, tables)
            out.append(unembed(params, cfg, hidden))
    return torch.cat(out, dim=1)


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=ATOL, rtol=RTOL)


CFGS = [TINY_LLAMA, TINY_MIXTRAL, TINY_GEMMA]


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_logits_match_hf(cfg, tmp_path):
    model = _save_hf(cfg, tmp_path)
    params = load_checkpoint(str(tmp_path), cfg, torch.float32)
    tokens = _tokens(cfg)
    ours, theirs = _port_logits(params, cfg, tokens), _hf_logits(model, tokens)
    _close(ours, theirs)
    assert torch.equal(ours.argmax(-1), theirs.argmax(-1))


def test_gemma_sliding_window_is_exercised(tmp_path):
    """With T > window the even (windowed) layers mask differently from the
    odd (global) ones; a port that ignored the window must diverge."""
    cfg = dataclasses.replace(TINY_GEMMA, sliding_window=4)
    model = _save_hf(cfg, tmp_path)
    params = load_checkpoint(str(tmp_path), cfg, torch.float32)
    tokens = _tokens(cfg, seed=2)
    theirs = _hf_logits(model, tokens)
    _close(_port_logits(params, cfg, tokens), theirs)
    broken = dataclasses.replace(cfg, sliding_window=None)
    ours_broken = _port_logits(params, broken, tokens)
    assert not np.allclose(ours_broken.numpy(), theirs.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_serving_path_matches_hf(cfg, tmp_path):
    """Prefill half the sequence, then one-token decode steps over the
    paged cache: every position's logits equal HF's full-sequence ones."""
    model = _save_hf(cfg, tmp_path)
    params = load_checkpoint(str(tmp_path), cfg, torch.float32)
    tokens = _tokens(cfg, seed=3)
    _close(_port_logits(params, cfg, tokens, split=T // 2), _hf_logits(model, tokens))


def test_a_bfloat16_save_loads_as_the_rounded_weights(tmp_path):
    """HF's bfloat16 save (BF16 tensors) read by the port's reader: each
    weight equals the float32 model's rounded to bfloat16."""
    cfg = TINY_GEMMA
    _save_hf(cfg, tmp_path / "bf16", dtype=torch.bfloat16)
    _save_hf(cfg, tmp_path / "fp32")
    got = load_checkpoint(str(tmp_path / "bf16"), cfg, torch.bfloat16)
    want = load_checkpoint(str(tmp_path / "fp32"), cfg, torch.bfloat16)
    assert got["embed"].dtype == torch.bfloat16
    for a, b in ((got["embed"], want["embed"]), (got["final_norm"], want["final_norm"]),
                 *((g[k], w[k]) for g, w in zip(got["layers"], want["layers"])
                   for k in ("ln1", "ln2", "post_ln1", "post_ln2")),
                 *((g["attn"][k], w["attn"][k]) for g, w in zip(got["layers"],
                                                                 want["layers"])
                   for k in ("wq", "wk", "wv", "wo"))):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
