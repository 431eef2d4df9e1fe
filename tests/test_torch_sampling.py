"""The port's sampler (engine/sampling.py) on the CPU.

It is not expected to reproduce jax.random's bits: draws come from a
counter-based hash of (seed, position, vocab index). What must hold is the
contract: greedy is the argmax, a seeded stream does not depend on the
batch it rides in, and sampled tokens follow the softmax mass over the set
that the reference's temperature / top-k / top-p rule keeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from polykey_tpu.engine import sampling as js
from polykey_tpu_torch.engine import sampling as ts

torch.set_num_threads(2)


def _logits(B, V, seed=0, scale=2.0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((B, V), dtype=np.float32) * scale
    )


def _seeds(values):
    s = np.array([[(v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF] for v in values], np.uint32)
    return torch.from_numpy(s.view(np.int32))


def _rows(B, temp=0.0, top_p=1.0, top_k=0):
    return (torch.full((B,), temp), torch.full((B,), top_p),
            torch.full((B,), top_k, dtype=torch.int32))


def test_greedy_is_argmax():
    logits = _logits(6, 50)
    seeds, pos = _seeds(range(6)), torch.arange(6)
    got = ts.sample_tail(logits, seeds, pos, *_rows(6), greedy=True)
    assert torch.equal(got, logits.argmax(-1).to(torch.int32))
    # Temperature-0 rows inside a sampled batch stay greedy.
    temp = torch.tensor([0.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    got = ts.sample_tail(logits, seeds, pos, temp, torch.ones(6),
                         torch.zeros(6, dtype=torch.int32), greedy=False)
    assert torch.equal(got[::2], logits.argmax(-1).to(torch.int32)[::2])


def test_seeded_stream_does_not_depend_on_batch_or_slot():
    """The same (seed, position, logits) row draws the same token alone,
    in slot 0 of a batch, or in slot 5 beside other requests."""
    V, seed = 300, 123456789012345
    target = _logits(1, V, seed=7)
    temp, top_p, top_k = 0.9, 0.95, 40
    stream_alone, stream_crowded = [], []
    for position in range(20, 40):
        alone = ts.sample_tail(
            target, _seeds([seed]), torch.tensor([position]),
            *_rows(1, temp, top_p, top_k), greedy=False)
        others = _logits(8, V, seed=position)
        others[5] = target[0]
        seeds = _seeds([1, 2, 3, 4, 5, seed, 6, 7])
        pos = torch.tensor([3, 9, 27, 81, 2, position, 0, 1])
        crowded = ts.sample_tail(others, seeds, pos, *_rows(8, temp, top_p, top_k),
                                 greedy=False)
        stream_alone.append(int(alone[0]))
        stream_crowded.append(int(crowded[5]))
    assert stream_alone == stream_crowded
    assert len(set(stream_alone)) > 1          # it really samples


@pytest.mark.parametrize("temp,top_p,top_k", [
    (1.0, 1.0, 0), (0.5, 1.0, 0), (1.0, 1.0, 3), (1.3, 0.7, 0), (1.0, 0.8, 4),
])
def test_draws_follow_the_kept_softmax_mass(temp, top_p, top_k):
    """Chi-square of 20000 draws (one seed, 20000 positions) against the
    softmax of logits/temperature over the kept set; significance 1e-4."""
    V, n = 8, 20000
    logits = _logits(1, V, seed=3, scale=1.0)
    scaled = logits[0] / temp
    probs = torch.softmax(scaled.double(), -1).numpy()
    order = np.argsort(-probs)
    desc = probs[order]
    keep = (np.cumsum(desc) - desc) < top_p
    keep[0] = True
    if top_k > 0:
        keep &= np.arange(V) < top_k
    kept = np.zeros(V, bool)
    kept[order[keep]] = True
    expected = np.where(kept, probs, 0.0)
    expected /= expected.sum()
    draws = ts.sample_tail(
        logits.expand(n, V), _seeds([42] * n), torch.arange(n),
        *_rows(n, temp, top_p, top_k), greedy=False).numpy()
    counts = np.bincount(draws, minlength=V)
    assert counts[~kept].sum() == 0
    chi2, p = stats.chisquare(counts[kept], expected[kept] * n)
    assert p > 1e-4, (counts, expected * n, chi2)


def test_truncation_thresholds_match_the_reference_rule():
    """One keep rule: the thresholds that cut top-p and top-k agree with
    the JAX package's on the same logits."""
    logits = _logits(5, 64, seed=11)
    top_p = torch.tensor([0.1, 0.5, 0.9, 1.0, 0.0])
    top_k = torch.tensor([0, 5, 1, 64, 0], dtype=torch.int32)
    tp, tk = ts.truncation_thresholds(logits, top_p, top_k)
    jp_, jk = js._trunc_thresholds(jnp.asarray(logits.numpy()),
                                   jnp.asarray(top_p.numpy())[:, None],
                                   jnp.asarray(top_k.numpy()))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp_))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_gumbel_noise_is_uniform_in_distribution():
    """The hash's uniforms (through the Gumbel transform) are uniform:
    Kolmogorov-Smirnov against U(0, 1) over 64k draws."""
    g = ts.gumbel_noise(_seeds([9]), torch.tensor([17]), 65536)[0].double()
    u = torch.exp(-torch.exp(-g)).numpy()
    assert stats.kstest(u, "uniform").pvalue > 1e-4


# -- the top-k candidates prefilter and the speculative draws ----------------

def _trunc_rows(B, seed=0):
    rng = np.random.default_rng(seed)
    temp = rng.uniform(0.5, 1.5, B).astype(np.float32)
    top_p = np.array([0.1, 0.5, 0.9, 1.0, 0.7, 1.0, 0.0, 0.95][:B], np.float32)
    top_k = np.array([0, 5, 1, 0, 40, 3, 0, 100][:B], np.int32)
    return temp, top_p, top_k


@pytest.mark.parametrize("candidates", [0, 32, 100])
def test_truncated_dist_matches_the_reference(candidates):
    """The truncated, renormalized distribution (prefiltered with 0 < C < V,
    exact otherwise, untruncated rows the plain softmax) within 1e-6 of the
    JAX package's on the same logits; also over a [B, G, V] block."""
    V = 64
    logits = _logits(8, V, seed=5)
    temp, top_p, top_k = _trunc_rows(8)
    got = ts.truncated_dist(logits, torch.from_numpy(temp), torch.from_numpy(top_p),
                            torch.from_numpy(top_k), candidates)
    want = js.truncated_dist(jnp.asarray(logits.numpy()), jnp.asarray(temp),
                             jnp.asarray(top_p), jnp.asarray(top_k), candidates)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    block = logits.reshape(2, 4, V)
    rs = [torch.from_numpy(a.reshape(2, 4)) for a in (temp, top_p, top_k)]
    got3 = ts.truncated_dist(block, *rs, candidates)
    want3 = js.truncated_dist(jnp.asarray(block.numpy()),
                              *(jnp.asarray(r.numpy()) for r in rs), candidates)
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), atol=1e-6, rtol=0)


def test_candidates_keep_set_matches_the_reference():
    """The prefilter keeps exactly the reference's candidates: the same
    top-C indices in order and the same keep mask (top-p on full-vocab
    probabilities, top-k by rank)."""
    V, C = 300, 32
    logits = _logits(8, V, seed=9)
    temp, top_p, top_k = _trunc_rows(8)
    scaled = logits / torch.from_numpy(temp)[:, None]
    _, idx, keep, _ = ts._candidates_keep(scaled, torch.from_numpy(top_p),
                                          torch.from_numpy(top_k), C)
    _, masked, jidx, _ = js._masked_rows(
        jnp.asarray(logits.numpy()), jnp.asarray(temp)[:, None], jnp.asarray(top_p),
        jnp.asarray(top_k), C)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(keep.numpy(), np.isfinite(np.asarray(masked)))


def test_candidates_draw_equals_the_exact_draw_when_the_set_fits():
    """A candidate's noise is its vocab index's noise, so a row whose kept
    set fits in C draws the same token on both paths; untruncated rows
    draw from the whole vocabulary the same way too."""
    V, C, n = 200, 32, 64
    logits = _logits(n, V, seed=13)
    seeds, pos = _seeds(range(100, 100 + n)), torch.arange(n)
    temp = torch.full((n,), 0.9)
    top_p = torch.where(torch.arange(n) % 4 == 0, 1.0, 0.6)
    top_k = torch.where(torch.arange(n) % 3 == 0, 10, 0).to(torch.int32)
    exact = ts.sample_tail(logits, seeds, pos, temp, top_p, top_k, greedy=False)
    pre = ts.sample_tail(logits, seeds, pos, temp, top_p, top_k, greedy=False,
                         candidates=C)
    kept = (ts.truncated_dist(logits, temp, top_p, top_k, 0) > 0).sum(-1)
    fits = (kept <= C) | ((top_p >= 1.0) & (top_k <= 0))
    assert fits.sum() > n // 2
    assert torch.equal(exact[fits], pre[fits])


@pytest.mark.parametrize("temp,top_p,top_k", [(1.0, 0.8, 0), (0.7, 1.0, 3)])
def test_candidates_draws_follow_the_kept_softmax_mass(temp, top_p, top_k):
    """Chi-square of 20000 prefiltered draws against the truncated
    distribution; significance 1e-4."""
    V, n = 12, 20000
    logits = _logits(1, V, seed=3, scale=1.0)
    expected = ts.truncated_dist(logits, torch.tensor([temp]), torch.tensor([top_p]),
                                 torch.tensor([top_k], dtype=torch.int32), 8)[0].double().numpy()
    draws = ts.sample_tail(logits.expand(n, V), _seeds([42] * n), torch.arange(n),
                           *_rows(n, temp, top_p, top_k), greedy=False,
                           candidates=8).numpy()
    counts = np.bincount(draws, minlength=V)
    kept = expected > 0
    expected /= expected[kept].sum()           # float64, so the sums agree
    assert counts[~kept].sum() == 0
    chi2, p = stats.chisquare(counts[kept], expected[kept] * n)
    assert p > 1e-4, (counts, expected * n, chi2)


def test_tagged_draws_are_uniform_and_independent_of_tag_and_batch():
    """The speculative draws: uniforms pass Kolmogorov-Smirnov, each tag
    is its own stream, and a row's draw depends only on (seed, position,
    tag), not on its batch."""
    n = 4096
    d = ts.TaggedDraws(_seeds([77] * n))
    pos = torch.arange(n)
    u101, u102 = d.uniform(pos, ts.DRAFT_TAG), d.uniform(pos, ts.ACCEPT_TAG)
    assert stats.kstest(u102.double().numpy(), "uniform").pvalue > 1e-4
    assert abs(float(np.corrcoef(u101.numpy(), u102.numpy())[0, 1])) < 0.05
    grid = ts.TaggedDraws(_seeds([77, 5])).uniform(torch.tensor([[3, 4], [3, 4]]),
                                                   ts.ACCEPT_TAG)
    alone = ts.TaggedDraws(_seeds([77])).uniform(torch.tensor([[3, 4]]), ts.ACCEPT_TAG)
    assert torch.equal(grid[0], alone[0]) and not torch.equal(grid[0], grid[1])
    logp = torch.log_softmax(_logits(1, 50, seed=2), -1).expand(3, 50)
    a = ts.TaggedDraws(_seeds([1, 2, 3])).categorical(torch.tensor([9, 9, 9]),
                                                     ts.EXTRA_TAG, logp)
    b = ts.TaggedDraws(_seeds([2])).categorical(torch.tensor([9]), ts.EXTRA_TAG, logp[:1])
    assert a[1] == b[0]
