"""The port's ragged mixed prefill+decode path on the CPU against the JAX
package's.

Three levels, each fed the same numpy inputs on both sides:
- the attention op: `ragged_attention_plain` and `ragged_paged_attention`
  (CPU tensors take the plain version) against the JAX kernel in interpret
  mode and the JAX gather reference, within 2e-5 on in-sequence rows (the
  reference's own TOL in tests/test_ragged.py; both sides compute in fp32
  in another summation order); padding rows must be exactly 0;
- the model and engine functions: `forward_ragged` and `_ragged_fn`
  against the JAX ones on the tiny models;
- the engine: the port's ragged engine against the JAX engine in its
  BUCKETED mode (greedy streams token-identical), and against the port's
  own bucketed engine for sampled streams, whose draws come from another
  generator than jax.random's (engine/sampling.py).
"""

import dataclasses
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polykey_tpu.engine import engine as jengine
from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu.ops.ragged_paged_attention_kernel import (
    ragged_gather_attention as j_gather,
)
from polykey_tpu.ops.ragged_paged_attention_kernel import (
    ragged_paged_attention as j_ragged,
)
from polykey_tpu_torch.engine import engine as tengine
from polykey_tpu_torch.engine import kv_cache as tkv
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.models import transformer as tt
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

torch.set_num_threads(2)

TOL = 2e-5
LOGIT_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the attention op ---------------------------------------------------------


def _case(seed, seq_lens, kv_lens, *, N=32, ps=8, Hk=2, Hq=4, D=32, P=8,
          pad_to=8, empty=0):
    """Ascending contiguous ranges with tail padding (tests/test_ragged.py's
    _ragged_case), plus `empty` unused ranges that start past the stream."""
    rng = np.random.default_rng(seed)
    seq_lens = np.asarray(list(seq_lens) + [0] * empty, np.int32)
    kv_lens = np.asarray(list(kv_lens) + [0] * empty, np.int32)
    used = int(seq_lens.sum())
    T = -(-used // pad_to) * pad_to
    starts = np.concatenate([[0], np.cumsum(seq_lens)[:-1]]).astype(np.int32)
    starts[len(starts) - empty:] = T
    S = len(seq_lens)
    kp = rng.normal(size=(N, ps, Hk, D)).astype(np.float32)
    vp = rng.normal(size=(N, ps, Hk, D)).astype(np.float32)
    tables = rng.integers(1, N, size=(S, P)).astype(np.int32)
    q = rng.normal(size=(T, Hq, D)).astype(np.float32)
    rows = np.arange(T)
    sid = np.clip(np.searchsorted(starts, rows, side="right") - 1, 0, S - 1)
    in_seq = (rows >= starts[sid]) & (rows < starts[sid] + seq_lens[sid])
    pos = np.where(in_seq, kv_lens[sid] - seq_lens[sid] + rows - starts[sid], 0)
    tok_tables = np.where(in_seq[:, None], tables[sid], 0).astype(np.int32)
    return dict(q=q, kp=kp, vp=vp, tables=tables, starts=starts, lens=seq_lens,
                kvs=kv_lens, in_seq=in_seq, tok_tables=tok_tables,
                pos=pos.astype(np.int32))


def _op_args(c, lib):
    conv = jnp.asarray if lib == "jax" else _t
    return [conv(c[k]) for k in ("q", "kp", "vp", "tables", "starts", "lens", "kvs")]


# The cases of tests/test_ragged.py's kernel tests, as one matrix: the mixed
# stream across soft-cap x window, multi-tile ranges with P=7, 48 decode
# singles, one prefill-only chunk, Hk == Hq; plus a mixed stream with
# unused ranges past the end.
CASES = {
    "mixed": dict(seed=0, seq_lens=[1, 11, 1, 5], kv_lens=[37, 20, 5, 48]),
    "multi_tile_P7": dict(seed=1, seq_lens=[1, 29, 3, 1], kv_lens=[11, 29, 40, 63],
                          P=7, N=64),
    "decode_only_48": dict(seed=2, seq_lens=[1] * 48, N=64,
                           kv_lens=list(np.random.default_rng(3).integers(1, 60, size=48))),
    "prefill_only": dict(seed=4, seq_lens=[24], kv_lens=[24]),
    "gqa_none": dict(seed=5, seq_lens=[1, 9], kv_lens=[33, 9], Hk=4, Hq=4),
    "empty_ranges": dict(seed=6, seq_lens=[1, 13, 2], kv_lens=[30, 13, 50], empty=3),
}


@pytest.mark.parametrize("name,softcap,win", [
    ("mixed", None, None), ("mixed", 30.0, None), ("mixed", None, 16),
    ("mixed", 30.0, 16), ("multi_tile_P7", None, None),
    ("decode_only_48", None, None), ("prefill_only", None, None),
    ("gqa_none", None, None), ("empty_ranges", 30.0, 16),
])
def test_ragged_attention_matches_jax(name, softcap, win):
    """Plain version and public op against the JAX kernel (interpret mode)
    and the JAX gather reference; padding rows exactly 0."""
    spec = dict(CASES[name])
    c = _case(spec.pop("seed"), **spec)
    scale = 0.2 if name == "multi_tile_P7" else 0.125
    kw = dict(scale=scale, logit_softcap=softcap)
    jw = None if win is None else jnp.int32(win)
    want_k = np.asarray(j_ragged(*_op_args(c, "jax"), interpret=True, window=jw,
                                 **({"pages_per_block": 2} if name == "multi_tile_P7"
                                    else {}), **kw))
    want_g = np.asarray(j_gather(jnp.asarray(c["q"]), jnp.asarray(c["kp"]),
                                 jnp.asarray(c["vp"]), jnp.asarray(c["tok_tables"]),
                                 jnp.asarray(c["pos"]), window=jw, **kw))
    plain = rk.ragged_attention_plain(*_op_args(c, "torch"), window=win, **kw).numpy()
    public = rk.ragged_paged_attention(*_op_args(c, "torch"), window=win, **kw).numpy()
    rows = c["in_seq"]
    for got in (plain, public):
        np.testing.assert_allclose(got[rows], want_k[rows], atol=TOL, rtol=0)
        np.testing.assert_allclose(got[rows], want_g[rows], atol=TOL, rtol=0)
        assert np.all(got[~rows] == 0.0)
    gather = rk.ragged_gather_attention(
        _t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["tok_tables"]), _t(c["pos"]),
        window=win, **kw).numpy()
    np.testing.assert_allclose(gather[rows], want_g[rows], atol=TOL, rtol=0)


def test_ragged_attention_never_multiplies_stale_v():
    """NaN in V rows at or past each sequence's KV length (unwritten slots
    of its last page) must not reach the output."""
    c = _case(8, seq_lens=[1, 6], kv_lens=[13, 6])
    vp = c["vp"].copy()
    vp[c["tables"][0, 1], 13 - 8:] = np.nan
    vp[c["tables"][1, 0], 6:] = np.nan
    args = _op_args(c, "torch")
    args[2] = _t(vp)
    got = rk.ragged_attention_plain(*args, scale=0.125).numpy()
    assert np.isfinite(got).all()


def test_ragged_tile_alignment_raises():
    c = _case(7, seq_lens=[1, 4], kv_lens=[9, 4])
    args = _op_args(c, "torch")
    args[0] = args[0][:5]
    with pytest.raises(ValueError, match="token_tile"):
        rk.ragged_paged_attention(*args, scale=0.125)


def _keys_per_cta(items, starts, lens, kvs):
    """Visible keys of each item's last row over its split count: the
    work estimate the list is ordered by."""
    s, row0, n, ns = items[:, 0], items[:, 1], items[:, 2], items[:, 4]
    visible = kvs[s] - lens[s] + (row0 - starts[s]) + n
    return -(-visible // ns)


def _check_cover(work, starts, lens, T, tq):
    """Each row of each range in exactly one tile of at most `tq` tokens,
    no row past the ranges; every split item's shares 0..n-1 present once,
    its partial slots [part, part + n) disjoint from every other's."""
    items = work.items.numpy()
    covered = np.zeros(T, int)
    for s, row0, n, split, nsplit, part in items:
        assert 0 < n <= tq and starts[s] <= row0 and row0 + n <= starts[s] + lens[s]
        if split == 0:
            covered[row0:row0 + n] += 1
    want = np.zeros(T, int)
    for st, ln in zip(starts, lens):
        want[st:min(st + ln, T)] += 1
    assert covered.tolist() == want.tolist()
    split = {(s, r) for s, r, _, _, ns, _ in items if ns > 1}
    for s, row0 in split:
        shares = items[(items[:, 0] == s) & (items[:, 1] == row0)]
        nsplit, part = shares[0, 4], shares[0, 5]
        assert sorted(shares[:, 3].tolist()) == list(range(nsplit))
        assert (shares[:, 4] == nsplit).all() and (shares[:, 5] == part).all()
    # Share j of a split item owns slot part + j: every slot once.
    slots = sorted(p + j for _, _, _, j, ns, p in items if ns > 1)
    assert slots == list(range(work.n_part))
    return items


@pytest.mark.parametrize("kv_heads,tail_splits", [(2, 3), (8, 1)])
def test_ragged_work_covers_every_row_once(kv_heads, tail_splits):
    """The kernel's work list: each row of each range in exactly one tile,
    tiles of 64 / G tokens, partial slots numbered without overlap, the
    long decode single split by its visible keys. Without prefill splits
    the stream is 13 CTAs a kv head: at 2 kv heads, 26, under half the
    card's 132 SMs, so its prefill tiles split too (the last tile of the
    1100-key range into ceil(1100 / 512) = 3); at 8, 104, they stay
    whole. Rows outside every range are the work list's gaps."""
    starts = np.array([0, 1, 2, 40, 200], np.int32)
    lens = np.array([1, 1, 38, 100, 0], np.int32)
    kvs = np.array([1, 700, 38, 1100, 0], np.int32)
    work = rk.ragged_work(starts, lens, kvs, 144, 4, kv_heads, "cpu")
    items = _check_cover(work, starts, lens, 144, 16)
    assert rk.SPLIT_ROWS == 512
    # The 700-key decode single needs ceil(700 / 512) = 2 splits.
    assert sorted(items[items[:, 0] == 1][:, 3].tolist()) == [0, 1]
    tail = items[(items[:, 0] == 3) & (items[:, 1] == 136)]
    assert len(tail) == tail_splits and (tail[:, 4] == tail_splits).all()
    keys = _keys_per_cta(items, starts, lens, kvs)
    assert (np.diff(keys) <= 0).all()
    assert work.gaps == ((140, 144),)


def test_ragged_work_default_stream_keeps_prefill_tiles_whole():
    """The engine's default ragged stream (16 decode singles over 1..4096
    keys plus 1024 prefill rows as chunks at KV 512 and 1024; G = 4, Hk =
    8) fills the card without prefill splits: no prefill tile is split,
    every single past SPLIT_ROWS keys is, and items come longest first by
    visible keys per CTA."""
    ctx = [1, 15, 16, 17, 31, 33, 255, 256, 257, 1000, 1024, 2047, 2049,
           3001, 4095, 4096]
    starts = np.array(list(range(16)) + [16, 528], np.int32)
    lens = np.array([1] * 16 + [512, 512], np.int32)
    kvs = np.array(ctx + [512, 1024], np.int32)
    work = rk.ragged_work(starts, lens, kvs, 1040, 4, 8, "cpu")
    items = _check_cover(work, starts, lens, 1040, 16)
    prefill = items[items[:, 2] > 1]
    assert len(prefill) == 64 and (prefill[:, 4] == 1).all()
    singles = items[items[:, 2] == 1]
    for s, n in enumerate(ctx):
        assert (singles[singles[:, 0] == s][:, 4] == -(-n // rk.SPLIT_ROWS)).all()
    assert work.n_part == sum(-(-n // rk.SPLIT_ROWS) for n in ctx if n > rk.SPLIT_ROWS)
    keys = _keys_per_cta(items, starts, lens, kvs)
    assert (np.diff(keys) <= 0).all() and keys[0] == 1024


# -- forward_ragged and _ragged_fn --------------------------------------------


def _params(model):
    jcfg = j_get_config(model)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, jp, params_from_numpy(jax.device_get(jp))


def _stream(cfg, seed=9):
    """Two decode singles (positions 6 and 9) and a 7-token prefill range at
    KV length 12 (positions 5..11), padded to 16 rows; page size 8."""
    rng = np.random.default_rng(seed)
    T, P = 16, 4
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0]], np.int32)
    tokens = rng.integers(3, cfg.vocab_size, T).astype(np.int32)
    positions = np.zeros(T, np.int32)
    positions[:2] = [6, 9]
    positions[2:9] = np.arange(5, 12)
    tok_tables = np.zeros((T, P), np.int32)
    tok_tables[0], tok_tables[1], tok_tables[2:9] = tables
    starts = np.array([0, 1, 2, T], np.int32)
    lens = np.array([1, 1, 7, 0], np.int32)
    kvs = np.array([7, 10, 12, 0], np.int32)
    seq_tables = np.concatenate([tables, np.zeros((1, P), np.int32)])
    return tokens, positions, tok_tables, starts, lens, kvs, seq_tables


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma"])
def test_forward_ragged_matches_jax(model):
    """Mixed stream over pools that already hold the sequences' earlier KV:
    hidden states of every in-sequence row, and the pools the pass wrote
    (tiny-gemma adds soft-capping and the sliding window)."""
    jcfg, jp, tp = _params(model)
    cfg = get_config(model)
    ops = _stream(cfg)
    rng = np.random.default_rng(1)
    shape = (cfg.num_layers, 8, 8, cfg.num_kv_heads, cfg.head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    jpaged = jkv.init_paged_kv(jcfg, 8, 8, jnp.float32).replace(
        k=jnp.asarray(k0), v=jnp.asarray(v0))
    tpaged = tkv.PagedKV(k=_t(k0.copy()), v=_t(v0.copy()))
    jh, jpaged = jt.forward_ragged(jp, jcfg, *(jnp.asarray(a) for a in ops[:2]), jpaged,
                                   *(jnp.asarray(a) for a in ops[2:]))
    th, tpaged = tt.forward_ragged(tp, cfg, *(_t(a) for a in ops[:2]), tpaged,
                                   *(_t(a) for a in ops[2:]))
    np.testing.assert_allclose(th[:9].numpy(), np.asarray(jh)[:9], atol=TOL, rtol=0)
    np.testing.assert_allclose(tpaged.k[:, 1:].numpy(), np.asarray(jpaged.k)[:, 1:],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tpaged.v[:, 1:].numpy(), np.asarray(jpaged.v)[:, 1:],
                               atol=TOL, rtol=0)


def test_ragged_fn_matches_jax():
    """One engine dispatch: 4 decode lanes (two live, one stopping at its
    cap, one inactive) and two prefill ranges (a final one whose first
    token is sampled, a non-final chunk): the same packed row, lane state
    and first tokens."""
    jcfg, jp, tp = _params("tiny-llama")
    cfg = get_config("tiny-llama")
    B, W, P, N, ps = 4, 12, 4, 16, 8
    rng = np.random.default_rng(3)
    shape = (cfg.num_layers, N, ps, cfg.num_kv_heads, cfg.head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    lane = dict(
        last_tokens=np.array([5, 17, 99, 0], np.int32),
        seq_lens=np.array([7, 12, 9, 0], np.int32),
        page_tables=np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0],
                              [0, 0, 0, 0]], np.int32),
        active=np.array([True, True, True, False]),
        caps=np.array([20, 20, 10, 0], np.int32),
        seeds=np.zeros((B, 2), np.int32),
        temperature=np.zeros(B, np.float32),
        top_p=np.ones(B, np.float32),
        top_k=np.zeros(B, np.int32),
    )
    pre = list(jengine.ragged_zero_operands(B, W, P))
    assert [a.tolist() for a in pre] == [
        a.tolist() for a in tengine.ragged_zero_operands(B, W, P)]
    # Slot 3: final 5-token range at positions 0..4 (rows 0..4); slot 2's
    # table stands in for a second slot's non-final chunk at rows 5..10.
    tokens = rng.integers(3, cfg.vocab_size, W).astype(np.int32)
    pre[0][:11] = tokens[:11]
    pre[1][:5], pre[1][5:11] = np.arange(5), np.arange(8, 14)
    pre[2][:5], pre[2][5:11] = 3, 0
    pre[3][3] = [7, 8, 0, 0]
    pre[3][0] = [9, 10, 11, 0]
    pre[4][:2], pre[5][:2], pre[6][:2], pre[7][:2] = [0, 5], [5, 6], [5, 14], [3, 0]
    pre[8][3], pre[9][3] = 4, 5
    order = ("last_tokens", "seq_lens", "page_tables", "active", "caps", "seeds",
             "temperature", "top_p", "top_k")
    jout = jengine._ragged_fn(
        jp, jcfg, jkv.init_paged_kv(jcfg, N, ps, jnp.float32).replace(
            k=jnp.asarray(k0), v=jnp.asarray(v0)),
        *(jnp.asarray(lane[k]) for k in order), *(jnp.asarray(a) for a in pre),
        greedy=True, eos_id=-1)
    tout = tengine._ragged_fn(
        tp, cfg, tkv.PagedKV(k=_t(k0.copy()), v=_t(v0.copy())),
        *(_t(lane[k]) for k in order), *(_t(a) for a in pre),
        greedy=True, eos_id=-1)
    for name, j, t in zip(("packed", "dec", "seq", "cont", "first"), jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


# -- the engine: ragged against the JAX bucketed streams ----------------------


FIELDS = dict(
    model="tiny-llama", tokenizer="byte", dtype="float32",
    max_decode_slots=4, page_size=8, num_pages=64, max_seq_len=64,
    prefill_buckets=(16, 32), max_new_tokens_cap=16, decode_block_steps=4,
)
# The JAX engine runs at lookahead depth 1, the port's own, so both engines
# dispatch the same sequence of batches.
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
CLIPPED = dict(prefill_budget=16, prefill_chunk=16)

GREEDY = [
    dict(prompt="hi", max_new_tokens=8, seed=11),
    dict(prompt="abcdefgh" * 2, max_new_tokens=8, seed=11),
    dict(prompt="abcdefgh" * 6, max_new_tokens=8, seed=11),   # chunked
    dict(prompt="xyz", max_new_tokens=8, seed=11),
]
SAMPLED = [
    dict(prompt="hello world", max_new_tokens=6, temperature=0.9, top_p=0.8,
         top_k=5, seed=42),
    dict(prompt="abcdefgh" * 3, max_new_tokens=6, temperature=1.0, seed=7),
]
BURST = [dict(prompt="abcdefgh" * 3, max_new_tokens=4, seed=3) for _ in range(4)]
TAIL = [
    dict(prompt="warm", max_new_tokens=12, seed=9),
    dict(prompt="abcdefgh" * 7, max_new_tokens=6, seed=9),   # 56 > W=16
]


def _drain(request, timeout=60.0):
    tokens, done, error = [], None, None
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            kind, value = request.out.get(timeout=deadline - time.monotonic())
        except queue.Empty:
            break
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            done = value
            break
        else:
            error = value
            break
    return tokens, done, error


def _streams(engine, make, specs):
    requests = [make(**s) for s in specs]
    for r in requests:
        engine.submit(r)
    outs = []
    for r in requests:
        tokens, done, error = _drain(r)
        assert error is None, error
        assert done is not None
        outs.append(tokens)
    return outs


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                          jnp.float32)


@pytest.fixture(scope="module")
def want(jax_params):
    """The JAX engine's bucketed streams for every greedy spec set."""
    out = {}
    for name, extra, sets in (
        ("base", {}, {"greedy": GREEDY, "burst": BURST}),
        ("clipped", CLIPPED, {"tail": TAIL}),
    ):
        eng = JInferenceEngine(JEngineConfig(**FIELDS, **JAX_ONLY, **extra),
                               params=jax_params)
        try:
            for key, specs in sets.items():
                out[key] = _streams(eng, JGenRequest, specs)
        finally:
            eng.shutdown()
    return out


def _port(jax_params, **extra):
    return InferenceEngine(EngineConfig(**{**FIELDS, **extra}),
                           params=params_from_numpy(jax.device_get(jax_params)),
                           device="cpu")


def _serve(jax_params, specs, **extra):
    eng = _port(jax_params, **extra)
    try:
        return _streams(eng, GenRequest, specs), eng.stats()
    finally:
        eng.shutdown()


def test_ragged_greedy_streams_match_jax_bucketed(jax_params, want):
    """Short prompts, a bucket-sized prompt, a 48-byte prompt longer than
    the largest bucket, concurrent decode: the same tokens as the JAX
    bucketed engine."""
    got, stats = _serve(jax_params, GREEDY, ragged_dispatch=True)
    assert got == want["greedy"]
    assert stats["ragged"] is True and stats["ragged_width"] == 68
    assert stats["kernel_launches"].keys() == tengine.KERNELS.keys()


def test_ragged_sampled_streams_match_bucketed(jax_params):
    """Draws are keyed by (seed, position), so sampled streams do not
    depend on the dispatch mode."""
    bucketed, _ = _serve(jax_params, SAMPLED)
    ragged, _ = _serve(jax_params, SAMPLED, ragged_dispatch=True)
    assert ragged == bucketed


def test_ragged_prefill_only_cold_burst(jax_params, want):
    """A cold burst fills every slot from idle with more prompt tokens than
    one stream holds: admissions span several prefill-only dispatches."""
    got, stats = _serve(jax_params, BURST, ragged_dispatch=True)
    assert got == want["burst"]
    assert stats["tokens_useful"] > 0


def test_ragged_budget_clipped_chunk_tail(jax_params, want):
    """A 56-token prompt whose ranges clip at W=16 while another lane
    decodes: the tail range is partial and the stream stays correct."""
    got, stats = _serve(jax_params, TAIL, ragged_dispatch=True, **CLIPPED)
    assert got == want["tail"]
    assert stats["prefill_tokens_total"] >= 56


def test_ragged_decode_only_iterations_keep_block_path(jax_params):
    """Two lanes (a lone one would take the adaptive block's 1-step blocks):
    their decode-only iterations run K-step blocks."""
    _, stats = _serve(jax_params, [dict(prompt="abc", max_new_tokens=12, seed=1),
                                   dict(prompt="xyz", max_new_tokens=12, seed=1)],
                      ragged_dispatch=True)
    assert stats["steps_dispatched"] > stats["blocks_dispatched"]


def test_ragged_padding_waste_accounting(jax_params):
    for extra in (dict(ragged_dispatch=True), {}):
        _, stats = _serve(jax_params, [dict(prompt="abcd" * 4, max_new_tokens=4)],
                          **extra)
        assert stats["tokens_dispatched"] >= stats["tokens_useful"] > 0
        assert 0.0 < stats["tokens_useful_fraction"] <= 1.0


def test_ragged_kill_switch_serves_bucketed_chunks(jax_params, want, monkeypatch):
    """POLYKEY_DISABLE_RAGGED=1 falls back to the bucketed executables,
    which serve the long prompts through chunked prefill: the same tokens,
    and the clipped-budget tail too."""
    monkeypatch.setenv("POLYKEY_DISABLE_RAGGED", "1")
    got, stats = _serve(jax_params, GREEDY, ragged_dispatch=True)
    assert stats["ragged"] is False and got == want["greedy"]
    got, stats = _serve(jax_params, TAIL, ragged_dispatch=True, **CLIPPED)
    assert got == want["tail"] and stats["prefill_tokens_total"] >= 56


def test_set_prefill_budget_floors_and_caps(jax_params):
    eng = _port(jax_params, ragged_dispatch=True)
    try:
        assert eng.set_prefill_budget(1) == 32           # one chunk
        assert eng.set_prefill_budget(10_000) == 68      # the stream width
        assert eng.stats()["prefill_budget"] == 68
    finally:
        eng.shutdown()


def test_round_robin_cursor():
    cur = tengine._RRCursor()
    assert list(cur.scan(3)) == [0, 1, 2]
    cur.advance(3)
    assert list(cur.scan(3)) == [1, 2, 0]
    cur.reanchor(0)
    assert list(cur.scan(3)) == [0, 1, 2]


def test_config_accepts_ragged():
    EngineConfig(**FIELDS, ragged_dispatch=True).validate()
    EngineConfig(**FIELDS, ragged_dispatch=True, kv_dtype="int8").validate()
    # Quantized weights and a draft model ride the ragged stream too.
    dataclasses.replace(EngineConfig(**FIELDS, ragged_dispatch=True),
                        quantize=True, quantize_bits=4).validate()
    dataclasses.replace(EngineConfig(**FIELDS, ragged_dispatch=True),
                        draft_model="tiny-llama").validate()
