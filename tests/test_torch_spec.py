"""The port's speculative-decoding math on the CPU, against the JAX package
(polykey_tpu/models/speculative.py and engine/spec_decode.py), on the same
numpy inputs.

`rejection_accept` must give the same booleans for the same uniforms and
`residual_extra_dist` the same distribution within 1e-6. The accept/merge
core must give the reference's packed matrix, new lane state, EWMA and
gamma dial: exactly for greedy rows (EOS and cap truncation mid-window
included), and for sampled rows when it is handed the reference's draws
(its uniforms and its categorical draws, through `TaggedDraws`). The
round's gamma constants and stat columns are the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polykey_tpu.engine import spec_decode as jsd
from polykey_tpu.models import speculative as jsp
from polykey_tpu_torch.engine import sampling as ts
from polykey_tpu_torch.engine import spec_decode as tsd
from polykey_tpu_torch.models import speculative as tsp

torch.set_num_threads(2)

B, GAMMA, V = 8, 4, 48


def _probs(rng, shape, sharp=2.0):
    x = rng.standard_normal(shape).astype(np.float32) * sharp
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_constants_are_the_reference_s():
    assert (tsd.GAMMA_EWMA_BETA, tsd.GAMMA_ACCEPT_FLOOR, tsd.GAMMA_ACCEPT_CEIL,
            tsd.SPEC_STAT_COLS) == (jsd.GAMMA_EWMA_BETA, jsd.GAMMA_ACCEPT_FLOOR,
                                    jsd.GAMMA_ACCEPT_CEIL, jsd.SPEC_STAT_COLS)


def test_rejection_accept_matches_the_reference():
    rng = np.random.default_rng(0)
    t = _probs(rng, (B, GAMMA + 1, V))
    d = _probs(rng, (B, GAMMA, V))
    drafts = rng.integers(0, V, (B, GAMMA)).astype(np.int32)
    drafts[:, 0] = d[:, 0].argmax(-1)
    u = rng.uniform(size=(B, GAMMA)).astype(np.float32)
    got = tsp.rejection_accept(*map(torch.from_numpy, (t, d, drafts, u)))
    want = jsp.rejection_accept(*map(jnp.asarray, (t, d, drafts, u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_residual_extra_dist_matches_the_reference():
    rng = np.random.default_rng(1)
    t = _probs(rng, (B, GAMMA + 1, V))
    d = _probs(rng, (B, GAMMA, V))
    d[3, 1] = t[3, 1]                     # a zero-mass residual: the target's dist
    n_acc = np.array([0, 1, 2, 1, 4, 3, 0, 4], np.int32)
    got = tsp.residual_extra_dist(*map(torch.from_numpy, (t, d, n_acc)))
    want = jsp.residual_extra_dist(*map(jnp.asarray, (t, d, n_acc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


class _ReferenceDraws(ts.TaggedDraws):
    """The JAX package's draws (its `_lane_tagger` keys) behind the port's
    interface: uniforms and categorical draws from jax.random."""

    def __init__(self, seeds):
        super().__init__(seeds)
        self.tagged = jsd._lane_tagger(jnp.asarray(seeds.numpy()))

    def uniform(self, positions, tag):
        keys = self.tagged(jnp.asarray(positions.numpy()), tag)
        u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k)))(keys)
        return torch.from_numpy(np.array(u))

    def categorical(self, positions, tag, logp):
        keys = self.tagged(jnp.asarray(positions.numpy()), tag)
        return torch.from_numpy(np.asarray(
            jsd._row_categorical(keys, jnp.asarray(logp.numpy()))).astype(np.int32))


def _merge_inputs(seed, sampled, candidates):
    """One batch of 8 lanes at gamma 4 (low rung 2): lane 7 inactive, lane
    5 one position from its cap, lane 2's drafts all right with EOS inside
    the window, lanes 0/1 right for a prefix; dials 4, 2, 3, 1, 4, 4, 2, 4
    and EWMAs across the hysteresis band."""
    rng = np.random.default_rng(seed)
    t_logits = rng.standard_normal((B, GAMMA + 1, V)).astype(np.float32) * 3
    t_choice = t_logits.argmax(-1)
    drafts = rng.integers(0, V, (B, GAMMA)).astype(np.int32)
    drafts[0, :2] = t_choice[0, :2]
    drafts[1, :1] = t_choice[1, :1]
    drafts[2] = t_choice[2, :GAMMA]
    drafts[4] = t_choice[4, :GAMMA]
    eos = int(t_choice[2, 2])
    d_dists = _probs(rng, (B, GAMMA, V))
    seq_lens = np.array([10, 20, 30, 12, 40, 50, 9, 0], np.int32)
    caps = np.array([64, 64, 64, 64, 64, 51, 64, 0], np.int32)
    active = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    last = rng.integers(0, V, B).astype(np.int32)
    ewma = np.array([1.0, 0.4, 0.36, 0.2, 0.56, 0.5, 0.3, 1.0], np.float32)
    dial = np.array([4, 2, 3, 1, 4, 4, 2, 4], np.int32)
    temp = np.where(sampled, np.array([0.0, 0.8, 1.0, 0.7, 0.0, 1.2, 0.9, 0.0]), 0.0)
    top_p = np.array([1.0, 0.9, 0.7, 1.0, 0.5, 1.0, 0.8, 1.0], np.float32)
    top_k = np.array([0, 0, 5, 0, 0, 3, 0, 0], np.int32)
    if not candidates:
        top_p[:], top_k[:] = 1.0, 0
    seeds = rng.integers(0, 1 << 31, (B, 2)).astype(np.int32)
    return dict(t_logits=t_logits, drafts=drafts, d_dists=d_dists, last=last,
                seq_lens=seq_lens, active=active, caps=caps, ewma=ewma, dial=dial,
                temp=temp.astype(np.float32), top_p=top_p, top_k=top_k, seeds=seeds,
                eos=eos)


def _run_both(x, candidates, greedy):
    pos = np.maximum(x["seq_lens"] - 1, 0)
    greedy_row = x["temp"] == 0.0
    temp = np.maximum(x["temp"], 1e-6).astype(np.float32)
    eff_p = np.where(greedy_row, 1.0, x["top_p"]).astype(np.float32)
    eff_k = np.where(greedy_row, 0, x["top_k"]).astype(np.int32)
    kw = dict(gamma=GAMMA, gamma_low=2, gamma_max=GAMMA, eos_id=x["eos"],
              candidates=candidates)
    args = [x["t_logits"], x["drafts"], x["d_dists"], x["last"], x["seq_lens"],
            x["active"], x["caps"], x["ewma"], x["dial"], pos, greedy_row, temp,
            eff_p, eff_k]
    want = jsd._accept_merge(*map(jnp.asarray, args),
                             jsd._lane_tagger(jnp.asarray(x["seeds"])), **kw)
    seeds = torch.from_numpy(x["seeds"])
    got = tsd._accept_merge(*map(torch.from_numpy, args), _ReferenceDraws(seeds),
                            greedy=greedy, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy-body", "sampled-body"])
def test_accept_merge_greedy_rows_match_the_reference(greedy):
    """An all-greedy batch: the packed matrix (EOS and cap truncation in
    mid-window, a stopped lane), the new lane state, the EWMA and the dial
    equal the reference's, from the greedy body and from the sampled one."""
    x = _merge_inputs(3, sampled=False, candidates=0)
    want, got = _run_both(x, 0, greedy)
    names = ("packed", "last", "seq_lens", "active", "ewma", "dial")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    packed = got[0]
    assert (packed[7, :GAMMA + 1] == -1).all()           # the stopped lane
    assert (packed[5, 1:GAMMA + 1] == -1).all()          # cut at its cap
    row2 = packed[2, :GAMMA + 1]
    assert row2[2] == x["eos"] and (row2[3:] == -1).all()   # cut at EOS
    assert len(set(got[5][:7])) > 1                      # dials moved both ways


@pytest.mark.parametrize("candidates", [0, 16])
def test_accept_merge_sampled_rows_match_given_the_reference_draws(candidates):
    """Greedy and sampled rows together, the sampled ones over truncated
    distributions with the prefilter: handed the reference's uniforms and
    categorical draws, the port accepts, truncates and dials as it does."""
    x = _merge_inputs(4, sampled=True, candidates=candidates)
    want, got = _run_both(x, candidates, greedy=False)
    for name, w, g in zip(("packed", "last", "seq_lens", "active", "ewma", "dial"),
                          want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    acc = got[0][:, GAMMA + 1]
    assert acc.sum() > 0


def test_spec_decode_fn_greedy_round_matches_the_reference():
    """One whole round (draft scan, verify, draft sync, merge) on tiny
    models with the same weights and pools in both packages: the packed
    matrix, the lane state and both pools agree."""
    from polykey_tpu.engine.kv_cache import init_paged_kv as j_init_paged_kv
    from polykey_tpu.models import transformer as jt
    from polykey_tpu.models.config import get_config as j_get_config
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.interop import paged_kv_from_numpy, params_from_numpy

    cfg_j = j_get_config("tiny-llama")
    tp = jt.init_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    dp = jt.init_params(jax.random.PRNGKey(2), cfg_j, jnp.float32)
    rng = np.random.default_rng(7)
    pages, ps, P, n = 32, 8, 8, 4
    jt_paged = j_init_paged_kv(cfg_j, pages, ps, jnp.float32)
    jd_paged = j_init_paged_kv(cfg_j, pages, ps, jnp.float32)
    jt_paged = jt_paged.replace(k=jnp.asarray(rng.standard_normal(jt_paged.k.shape),
                                               jnp.float32),
                                 v=jnp.asarray(rng.standard_normal(jt_paged.v.shape),
                                               jnp.float32))
    tables = np.zeros((n, P), np.int32)
    tables[:3] = 1 + np.arange(3 * P).reshape(3, P) % (pages - 1)
    lanes = dict(
        last_tokens=np.array([5, 17, 200, 0], np.int32),
        seq_lens=np.array([9, 14, 30, 0], np.int32),
        page_tables=tables, active=np.array([1, 1, 1, 0], bool),
        caps=np.array([60, 16, 60, 0], np.int32), seeds=np.zeros((n, 2), np.int32),
        temperature=np.zeros(n, np.float32), top_p=np.ones(n, np.float32),
        top_k=np.zeros(n, np.int32), accept_ewma=np.ones(n, np.float32),
        gamma_lane=np.array([3, 2, 3, 3], np.int32),
    )
    out = jsd.spec_decode_fn(tp, dp, cfg_j, cfg_j, jt_paged, jd_paged,
                             *map(jnp.asarray, lanes.values()), gamma=3, eos_id=2,
                             gamma_low=1, gamma_max=3)
    cfg = get_config("tiny-llama")
    t_params = params_from_numpy(jax.device_get(tp))
    d_params = params_from_numpy(jax.device_get(dp))
    t_paged = paged_kv_from_numpy(jax.device_get(jt_paged))
    d_paged = paged_kv_from_numpy(jax.device_get(j_init_paged_kv(cfg_j, pages, ps,
                                                                 jnp.float32)))
    state = {k: torch.from_numpy(v.copy()) for k, v in lanes.items()}
    packed = tsd.spec_decode_fn(t_params, d_params, cfg, cfg, t_paged, d_paged,
                                *state.values(), gamma=3, eos_id=2, gamma_low=1,
                                gamma_max=3, greedy=True)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(out[0]))
    for name, w in zip(("last_tokens", "seq_lens", "active", "accept_ewma",
                        "gamma_lane"), out[1:6]):
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(w), err_msg=name)
    for got, want in ((t_paged, out[6]), (d_paged, out[7])):
        np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=1e-5)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-5)
