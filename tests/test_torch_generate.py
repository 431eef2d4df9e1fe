"""The port's offline generation over a contiguous KV cache on the CPU
(models/generate.py, models/speculative.py), against the JAX package.

- `forward` with a cache (a right-padded prefill, then a decode step) and
  without one, on tiny-llama, tiny-gemma (soft-caps, the 16-position
  window) and tiny-mixtral: hidden states within TOL of the JAX
  `forward`'s, and the caches the steps wrote.
- `generate` greedy token-identical to the JAX `generate`, with
  `num_generated` under an eos that rows reach at different steps.
- `speculative_generate` greedy identical to the JAX function's and to
  `generate`'s, with a 1-layer draft and with the target as its own draft,
  its `return_stats` equal to the JAX ones. Sampled runs are held within
  the port (the draws' bits are the port's, ROADMAP.md C.4): a seed gives
  the same streams again, and a self-draft accepts every draft.
- The refusals, matched by message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polykey_tpu.engine.sampling import SamplingParams as JSamplingParams
from polykey_tpu.models import config as jcfg
from polykey_tpu.models import generate as jgen
from polykey_tpu.models import speculative as jspec
from polykey_tpu.models import transformer as jt
from polykey_tpu_torch.engine.sampling import SamplingParams, sample
from polykey_tpu_torch.models import config as tcfg
from polykey_tpu_torch.models import generate as tgen
from polykey_tpu_torch.models import speculative as tspec
from polykey_tpu_torch.models import transformer as tt
from polykey_tpu_torch.models.interop import params_from_numpy

torch.set_num_threads(2)

TOL = 2e-5      # hidden states and caches: fp32 on both sides

# tests/test_speculative.py's draft: one layer, narrower, one kv head.
DRAFT = dict(name="spec-draft", hidden_size=32, intermediate_size=64, num_layers=1,
             num_heads=2, num_kv_heads=1)


def _weights(cfg_j, seed):
    jp = jt.init_params(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    return jp, params_from_numpy(jax.device_get(jp))


def _prompts(vocab, seed=1, B=3, T=8, lens=(8, 5, 6)):
    """Right-padded prompts [B, T] with their true lengths."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, vocab, (B, T)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b, n in enumerate(lens):
        tokens[b, n:] = 0
    return tokens, lens


@pytest.fixture(scope="module")
def llama():
    """tiny-llama target and the 1-layer draft, both packages."""
    cfg_d = dataclasses.replace(jcfg.TINY_LLAMA, **DRAFT)
    jp, tp = _weights(jcfg.TINY_LLAMA, 0)
    jd, td = _weights(cfg_d, 7)
    return jp, tp, jd, td, cfg_d, dataclasses.replace(tcfg.TINY_LLAMA, **DRAFT)


# -- forward --------------------------------------------------------------------


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma", "tiny-mixtral"])
@pytest.mark.parametrize("cached", [True, False], ids=["cache", "no-cache"])
def test_forward_matches_jax(model, cached):
    cfg_j, cfg = jcfg.get_config(model), tcfg.get_config(model)
    jp, tp = _weights(cfg_j, 0)
    B, T, S = 2, 20, 32
    tokens, _ = _prompts(cfg.vocab_size, B=B, T=T, lens=(20, 13))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if not cached:
        jh, _ = jt.forward(jp, cfg_j, jnp.asarray(tokens), jnp.asarray(pos), None)
        th, cache = tt.forward(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(pos))
        assert cache is None
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=0)
        return
    jc = jt.init_cache(cfg_j, B, S, jnp.float32)
    tc = tt.init_cache(cfg, B, S, torch.float32)
    assert tc.k.shape == jc.k.shape and tc.num_slots == S
    # A prefill of 20 positions (past the 16-position window), then one
    # decode step at each row's own position.
    jh, jc = jt.forward(jp, cfg_j, jnp.asarray(tokens), jnp.asarray(pos), jc)
    th, tc = tt.forward(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=0)
    step_tok = np.array([[5], [9]], np.int32)
    step_pos = np.array([[20], [13]], np.int32)
    jh, jc = jt.forward(jp, cfg_j, jnp.asarray(step_tok), jnp.asarray(step_pos), jc)
    th, tc = tt.forward(tp, cfg, torch.from_numpy(step_tok), torch.from_numpy(step_pos), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=TOL, rtol=0)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=TOL, rtol=0)


def test_forward_refuses_an_override_with_a_cache(llama):
    cfg = tcfg.TINY_LLAMA
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="attn_override applies to the no-cache path"):
        tt.forward(llama[1], cfg, tokens, pos, tt.init_cache(cfg, 1, 8, torch.float32),
                   attn_override=lambda i, q, k, v: q)
    # Without a cache the override replaces the attention.
    seen = []
    tt.forward(llama[1], cfg, tokens, pos,
               attn_override=lambda i, q, k, v: seen.append(i) or torch.zeros_like(q))
    assert seen == list(range(cfg.num_layers))


# -- generate -------------------------------------------------------------------


def _jax_generate(jp, cfg_j, tokens, lens, max_new, max_len, eos_id=-1):
    out, n = jgen.generate(jp, cfg_j, jnp.asarray(tokens), jnp.asarray(lens),
                           jax.random.PRNGKey(0), JSamplingParams(max_new_tokens=max_new),
                           max_len, eos_id)
    return np.asarray(out), np.asarray(n)


def _port_generate(tp, cfg, tokens, lens, max_new, max_len, eos_id=-1, **sampling):
    out, n = tgen.generate(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(lens), 0,
                           SamplingParams(max_new_tokens=max_new, **sampling), max_len,
                           eos_id)
    return out.numpy(), n.numpy()


def test_generate_greedy_matches_jax_through_an_eos(llama):
    """Greedy streams equal the JAX `generate`'s; with an eos that one row
    reaches mid-stream, that row keeps emitting it, and num_generated
    counts through it, as in JAX."""
    jp, tp = llama[:2]
    cfg_j, cfg = jcfg.TINY_LLAMA, tcfg.TINY_LLAMA
    tokens, lens = _prompts(cfg.vocab_size)
    want, want_n = _jax_generate(jp, cfg_j, tokens, lens, 10, 32)
    got, got_n = _port_generate(tp, cfg, tokens, lens, 10, 32)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got_n == 10).all()
    eos = int(want[1, 3])
    want, want_n = _jax_generate(jp, cfg_j, tokens, lens, 10, 32, eos)
    got, got_n = _port_generate(tp, cfg, tokens, lens, 10, 32, eos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_n, want_n)
    assert got_n[1] <= 4 and (got[1, got_n[1]:] == eos).all()


def test_generate_sampled_is_reproducible_and_keyed_by_the_seed(llama):
    tp = llama[1]
    cfg = tcfg.TINY_LLAMA
    tokens, lens = _prompts(cfg.vocab_size)
    kw = dict(temperature=0.9, top_k=20, top_p=0.9)
    a, _ = _port_generate(tp, cfg, tokens, lens, 12, 32, **kw)
    b, _ = _port_generate(tp, cfg, tokens, lens, 12, 32, **kw)
    np.testing.assert_array_equal(a, b)
    c, _ = tgen.generate(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(lens), 5,
                         SamplingParams(max_new_tokens=12, **kw), 32)
    assert (c.numpy() != a).any()
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


def test_sample_cuts_top_k_then_top_p():
    """`sample`'s truncation is the reference's: top_k 1 and a tiny top_p
    give the argmax; a draw stays inside the top-k set; top-p is taken
    over what top-k kept (renormalized)."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32) * 3)
    seeds = torch.zeros((6, 2), dtype=torch.int32)
    pos = torch.arange(6, dtype=torch.int32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    for sp in (SamplingParams(temperature=1.0, top_k=1), SamplingParams(temperature=1.0,
                                                                        top_p=1e-6)):
        assert torch.equal(sample(logits, seeds, pos, sp), greedy)
    top5 = torch.topk(logits, 5, dim=-1).indices
    for p in range(40):
        got = sample(logits, seeds, pos + 7 * p, SamplingParams(temperature=2.0, top_k=5))
        assert (top5 == got[:, None].long()).any(dim=1).all()
    # Probabilities [0.5, 0.3, 0.2] (rest -inf): top_k 2 leaves [0.625,
    # 0.375], so top_p 0.6 keeps only the first (over the whole
    # distribution it would keep two).
    row = torch.full((1, 50), float("-inf"))
    row[0, :3] = torch.log(torch.tensor([0.5, 0.3, 0.2]))
    sp = SamplingParams(temperature=1.0, top_k=2, top_p=0.6)
    draws = {int(sample(row, seeds[:1], torch.tensor([q], dtype=torch.int32), sp))
             for q in range(40)}
    assert draws == {0}


def test_generate_refuses_a_small_cache(llama):
    tokens, lens = _prompts(tcfg.TINY_LLAMA.vocab_size)
    with pytest.raises(ValueError, match="cache too small"):
        _port_generate(llama[1], tcfg.TINY_LLAMA, tokens, lens, 25, 32)


# -- speculative_generate -------------------------------------------------------


def _jax_spec(target, cfg_t, draft, cfg_d, tokens, lens, max_new, max_len, gamma, eos_id=-1):
    out = jspec.speculative_generate(
        target, cfg_t, draft, cfg_d, jnp.asarray(tokens), jnp.asarray(lens),
        jax.random.PRNGKey(3), JSamplingParams(max_new_tokens=max_new), max_len,
        gamma=gamma, eos_id=eos_id, return_stats=True)
    return [np.asarray(x) for x in out]


def _port_spec(target, cfg_t, draft, cfg_d, tokens, lens, max_new, max_len, gamma,
               eos_id=-1, seed=3, **sampling):
    out = tspec.speculative_generate(
        target, cfg_t, draft, cfg_d, torch.from_numpy(tokens), torch.from_numpy(lens), seed,
        SamplingParams(max_new_tokens=max_new, **sampling), max_len, gamma=gamma,
        eos_id=eos_id, return_stats=True)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("draft", ["1-layer", "self"])
def test_speculative_greedy_matches_jax_and_generate(llama, draft):
    """Greedy output is the target's chain for any draft: equal to the JAX
    function's and to `generate`'s, through an eos, with the same accepted
    and proposed counts as JAX; the self-draft accepts every draft."""
    jp, tp, jd, td, cfg_dj, cfg_d = llama
    cfg_j, cfg = jcfg.TINY_LLAMA, tcfg.TINY_LLAMA
    if draft == "self":
        jd, td, cfg_dj, cfg_d = jp, tp, cfg_j, cfg
    tokens, lens = _prompts(cfg.vocab_size)
    plain, _ = _port_generate(tp, cfg, tokens, lens, 16, 40)
    eos = int(plain[2, 9])
    for eos_id in (-1, eos):
        want = _jax_spec(jp, cfg_j, jd, cfg_dj, tokens, lens, 16, 40, 4, eos_id)
        got = _port_spec(tp, cfg, td, cfg_d, tokens, lens, 16, 40, 4, eos_id)
        for name, g, w in zip(("out", "num_generated", "accepted", "proposed"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        ref, ref_n = _port_generate(tp, cfg, tokens, lens, 16, 40, eos_id)
        np.testing.assert_array_equal(got[0], ref)
        np.testing.assert_array_equal(got[1], ref_n)
        assert got[3] > 0
        if draft == "self":
            assert got[2] == got[3]
    assert got[1][2] <= 10 and got[1][0] == 16


def test_speculative_sampled_reproducible_and_self_draft_accepts_all(llama):
    tp, td, cfg_d = llama[1], llama[3], llama[5]
    cfg = tcfg.TINY_LLAMA
    tokens, lens = _prompts(cfg.vocab_size)
    a = _port_spec(tp, cfg, td, cfg_d, tokens, lens, 16, 40, 4, temperature=0.8)
    b = _port_spec(tp, cfg, td, cfg_d, tokens, lens, 16, 40, 4, temperature=0.8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert (a[1] == 16).all() and ((a[0] >= 0) & (a[0] < cfg.vocab_size)).all()
    assert 0 < a[2] < a[3]
    s = _port_spec(tp, cfg, tp, cfg, tokens, lens, 16, 40, 4, temperature=0.8)
    assert s[3] > 0 and s[2] == s[3]


def test_speculative_refusals(llama):
    tp, td, cfg_d = llama[1], llama[3], llama[5]
    cfg = tcfg.TINY_LLAMA
    tokens, lens = _prompts(cfg.vocab_size)
    with pytest.raises(ValueError, match="top_k/top_p"):
        _port_spec(tp, cfg, td, cfg_d, tokens, lens, 8, 40, 4, temperature=0.8, top_p=0.9)
    with pytest.raises(ValueError, match="top_k/top_p"):
        _port_spec(tp, cfg, td, cfg_d, tokens, lens, 8, 40, 4, temperature=0.8, top_k=5)
    # 8 + 16 + 4 > 27: the last window's writes would fall past the cache.
    with pytest.raises(ValueError, match="cache too small"):
        _port_spec(tp, cfg, td, cfg_d, tokens, lens, 16, 27, 4)
