"""The port's int8 KV cache on the CPU against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; int8
pools and bf16 scales cross as numpy (`models/interop.py`). Tolerances:

- `quantize_kv_rows` and every pool a write produces: bit-identical (the
  quantizer is exact arithmetic: absmax, one IEEE division, bf16 rounding,
  round half to even);
- attention (decode, ragged, gather) on fp32 queries: 2e-5 absolute on
  O(1) outputs, as tests/test_torch_ops.py and tests/test_torch_ragged.py
  hold the bf16 paths: both sides dequantize in fp32 (k8 * ks) and differ
  only in summation order;
- forward passes: hidden states within 2e-5 and the pools they wrote
  bit-identical; engines: greedy streams token-identical.

The port's sampled draws come from another generator than jax.random's
(engine/sampling.py), so a seeded sampled stream is held to the port's own
bucketed int8 engine, whose draws are keyed by (seed, position) alike.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu.ops import paged_attention as jpa
from polykey_tpu.ops.paged_attention_kernel import (
    paged_attention_decode as j_decode,
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
from polykey_tpu_torch.models.interop import (
    paged_kv_from_numpy,
    params_from_numpy,
    tensor_from_numpy,
)
from polykey_tpu_torch.ops import paged_attention as tpa
from polykey_tpu_torch.ops import paged_attention_kernel as pak
from polykey_tpu_torch.ops import paged_write_kernel as pw
from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

torch.set_num_threads(2)

TOL = 2e-5


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _bits(x) -> np.ndarray:
    """Raw bits of an int8 or bf16 array (torch or numpy), for exact
    comparison (NaN patterns included)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _same(got, want, what=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


# -- the quantizer ------------------------------------------------------------


def _rows(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "normal":
        return rng.normal(size=(5, 7, 4, 32)).astype(np.float32)
    if kind == "bf16":
        return (rng.normal(size=(5, 7, 4, 32)) * 3).astype(ml_dtypes.bfloat16)
    if kind == "zeros":
        rows = rng.normal(size=(3, 4, 16)).astype(np.float32)
        rows[0] = 0.0
        rows[1, 2] = 0.0
        return rows
    # Half-way ties: scales 1.0 and 0.25 are exact (absmax 127 and 31.75),
    # so x / scale lands exactly on k + 0.5 and must round to even.
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.0, 0.0],
                      np.float32)
    rows = np.zeros((2, 3, 16), np.float32)
    for i, s in enumerate((1.0, 0.25)):
        rows[i, :, 0] = 127 * s
        rows[i, :, 1:11] = halves * s
        rows[i, :, 11:] = -127 * s
    return rows


@pytest.mark.parametrize("kind", ["normal", "bf16", "zeros", "ties"])
def test_quantize_kv_rows_is_bit_identical(kind):
    rows = _rows(kind)
    jq, js = jpa.quantize_kv_rows(jnp.asarray(rows))
    tq, ts = tpa.quantize_kv_rows(_t(rows))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    _same(tq, jq, "values")
    _same(ts, js, "scales")
    if kind == "ties":
        assert tq[0, 0, 1:4].tolist() == [0, 2, 2]        # 0.5, 1.5, 2.5
        assert tq[0, 0, 4:7].tolist() == [0, -2, -2]
    back = tpa.dequantize_kv(tq, ts, torch.float32)
    want = jpa.dequantize_kv(jq, js, jnp.float32)
    _same(back.view(torch.int32), np.asarray(want).view(np.int32), "dequantized")


def test_quantize_kv_rows_keeps_a_nan_scale():
    """A head holding a NaN gets a NaN scale in both packages (jnp.max and
    torch.amax keep NaN, and so do the clamp to 1e-8 and the division), as
    the card's quantizing write does; every other head's values and scales
    stay bit-identical. The NaN head's int8 values have no defined value in
    either package and are not compared."""
    rows = _rows("normal")
    rows[1, 3, 2, 9] = np.nan
    jq, js = jpa.quantize_kv_rows(jnp.asarray(rows))
    tq, ts = tpa.quantize_kv_rows(_t(rows))
    nan = np.zeros(rows.shape[:-1], bool)
    nan[1, 3, 2] = True
    js32 = np.asarray(js, np.float32)
    assert np.isnan(js32[nan]).all() and torch.isnan(ts.float()[torch.from_numpy(nan)]).all()
    assert not np.isnan(js32[~nan]).any()
    keep = torch.from_numpy(~nan)
    _same(tq[keep], np.asarray(jq)[~nan], "values")
    _same(ts[keep], np.asarray(js)[~nan], "scales")


# -- the write ----------------------------------------------------------------


def _pools(seed, N=13, ps=8, Hk=2, D=16):
    """Pair-form pools holding earlier int8 values and bf16 scales."""
    rng = np.random.default_rng(seed)
    k8 = rng.integers(-127, 128, (N, ps, Hk, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (N, ps, Hk, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.1, (N, ps, Hk)).astype(ml_dtypes.bfloat16)
    vs = rng.uniform(0.001, 0.1, (N, ps, Hk)).astype(ml_dtypes.bfloat16)
    return k8, v8, ks, vs


def _jax_pairs(k8, v8, ks, vs):
    return (jnp.asarray(k8), jnp.asarray(ks)), (jnp.asarray(v8), jnp.asarray(vs))


def _torch_pairs(k8, v8, ks, vs):
    return (_t(k8), _t(ks)), (_t(v8), _t(vs))


@pytest.mark.parametrize("path,start", [
    ("decode", [5, 16, 23, 0, 0]),       # T == 1; two inactive lanes on page 0
    ("page_scatter", [0, 8, 16]),         # T == 16, page-aligned
    ("token_scatter", [0, 8, 17]),        # T == 16, unaligned
])
def test_paged_write_pair_pools_match_jax(path, start):
    """Every path writes the same four pools as the JAX paged_write, in
    place; page 0 (the garbage page inactive lanes race on) aside."""
    B, T = len(start), 1 if path == "decode" else 16
    pools = _pools(1)
    rng = np.random.default_rng(2)
    kn = rng.normal(size=(B, T, 2, 16)).astype(np.float32)
    vn = rng.normal(size=(B, T, 2, 16)).astype(np.float32)
    tables = np.arange(1, 1 + B * 4, dtype=np.int32).reshape(B, 4) % 12 + 1
    if path == "decode":
        tables[3:] = 0
    pos = (np.asarray(start)[:, None] + np.arange(T)).astype(np.int32)
    jk, jv = jpa.paged_write(*_jax_pairs(*pools), jnp.asarray(kn), jnp.asarray(vn),
                             jnp.asarray(tables), jnp.asarray(pos))
    tk, tv = _torch_pairs(*pools)
    got = tpa.paged_write(tk, tv, _t(kn), _t(vn), _t(tables), _t(pos))
    assert got[0][0] is tk[0] and got[1][1] is tv[1]
    for name, g, w in (("k", tk[0], jk[0]), ("v", tv[0], jv[0]),
                       ("ks", tk[1], jk[1]), ("vs", tv[1], jv[1])):
        _same(g[1:], np.asarray(w)[1:], name)


def test_write_kernel_plain_matches_numpy_scatter():
    """The T == 1 write's plain version (what a CPU tensor takes) against
    the JAX quantizer's rows stored by numpy indexing; no launch is counted
    on the CPU, and a negative position keeps floor semantics."""
    k8, v8, ks, vs = (a.copy() for a in _pools(3))
    rng = np.random.default_rng(4)
    kn = rng.normal(size=(4, 1, 2, 16)).astype(np.float32)
    tables = np.array([[1, 2], [3, 4], [5, 6], [7, 8]], np.int32)
    pos = np.array([[3], [8], [15], [-3]], np.int32)
    pairs = _torch_pairs(k8, v8, ks, vs)
    before = pw.KERNEL_INT8.launches
    pw.paged_write_decode(*pairs, _t(kn), _t(-kn), _t(tables), _t(pos))
    assert pw.KERNEL_INT8.launches == before
    page = tables[np.arange(4), np.clip(pos[:, 0] // 8, 0, 1)]
    off = pos[:, 0] % 8
    for values, scales, rows in ((k8, ks, kn), (v8, vs, -kn)):
        q8, sc = jpa.quantize_kv_rows(jnp.asarray(rows[:, 0]))
        values[page, off] = np.asarray(q8)
        scales[page, off] = np.asarray(sc)
    for got, want in zip((*pairs[0], *pairs[1]), (k8, ks, v8, vs)):
        _same(got, want)


# -- decode attention ---------------------------------------------------------


def _decode_case(seed, B=5, Hq=8, Hk=2, D=16, ps=16, P=8,
                 positions=(5, 15, 16, 63, 100)):
    r = np.random.default_rng(seed)
    N = B * P + 1
    q = r.standard_normal((B, 1, Hq, D), dtype=np.float32)
    k8, ks = jpa.quantize_kv_rows(jnp.asarray(r.standard_normal((N, ps, Hk, D),
                                                                dtype=np.float32)))
    v8, vs = jpa.quantize_kv_rows(jnp.asarray(r.standard_normal((N, ps, Hk, D),
                                                                dtype=np.float32)))
    pts = np.zeros((B, P), np.int32)
    page = 1
    for b in range(B):
        for j in range(positions[b] // ps + 1):
            pts[b, j] = page
            page += 1
    pos = np.asarray(positions, np.int32).reshape(B, 1)
    pools = tuple(np.asarray(a) for a in (k8, v8, ks, vs))
    return q, pools, pts, pos


# Contexts 255..257 straddle the CUDA kernel's ring stages and 1023..1025
# its splits; a batch of one-row sequences leaves most of its splits
# empty. Hk = 2, D = 64.
_SPLIT_EDGES = dict(B=6, D=64, P=65, positions=(254, 255, 256, 1022, 1023, 1024))
_SINGLE_ROWS = dict(B=8, D=64, P=20, positions=(0, 0, 0, 0, 0, 0, 1, 300))


@pytest.mark.parametrize("softcap,win,layout", [
    pytest.param(None, None, {}, id="None-None"),
    pytest.param(50.0, None, {}, id="50.0-None"),
    pytest.param(None, 24, {}, id="None-24"),
    pytest.param(30.0, 24, {}, id="30.0-24"),
    pytest.param(None, None, _SPLIT_EDGES, id="split-edges"),
    pytest.param(50.0, 300, _SPLIT_EDGES, id="split-edges-softcap-window"),
    pytest.param(None, None, _SINGLE_ROWS, id="single-rows"),
])
def test_quantized_decode_matches_jax_kernel(softcap, win, layout):
    """The plain int8 decode (what the wrapper takes on the CPU) against the
    JAX int8 kernel in interpret mode: page-boundary positions, garbage
    tails, GQA, soft-cap and window; contexts at the CUDA kernel's split
    edges, and a batch of mostly one-row sequences."""
    q, pools, pts, pos = _decode_case(0, **layout)
    want = j_decode(jnp.asarray(q), *_jax_pairs(*pools), jnp.asarray(pts),
                    jnp.asarray(pos), scale=0.125, logit_softcap=softcap,
                    window=None if win is None else jnp.int32(win), interpret=True)
    got = pak.paged_attention_decode(_t(q), *_torch_pairs(*pools), _t(pts), _t(pos),
                                     scale=0.125, logit_softcap=softcap, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_decode_scratch_helpers():
    """The wrapper's scratch: per-split state of the asked shapes, and one
    zeroed int32 counter buffer per (device, stream), reused while it is
    large enough and replaced, never freed, by a larger zeroed one when it
    is not."""
    acc_p, m_p, l_p = pak.split_scratch(3, 8, 64, 5, "cpu")
    assert acc_p.shape == (3, 8, 5, 64) and m_p.shape == l_p.shape == (3, 8, 5)
    assert {t.dtype for t in (acc_p, m_p, l_p)} == {torch.float32}
    first = pak.arrival_counters(6, "cpu")
    assert first.dtype == torch.int32 and first.numel() >= 6 and (first == 0).all()
    assert pak.arrival_counters(4, "cpu") is first
    grown = pak.arrival_counters(first.numel() + 1, "cpu")
    assert grown.numel() > first.numel() and (grown == 0).all()
    assert pak.arrival_counters(1, torch.device("cpu")) is grown
    # The outgrown buffer stays held: a captured graph may still use it.
    assert any(t is first for t in pak._ARRIVALS[("cpu", 0)])


def _fp16_pv_decode(q, k_pair, v_pair, pts, pos, scale):
    """The int8 CUDA kernel's arithmetic in plain torch, normalized: fp32
    logits, each probability times its V scale rounded to fp16 once, fp32
    sums over the exact int8 V values."""
    (v8, vs), idx = v_pair, pts.long()
    B, Hq, D = q.shape
    Hk = v8.shape[2]
    k = pak.gather_pages_f32(k_pair, idx).reshape(B, -1, Hk, D)
    valid = torch.arange(k.shape[1])[None] <= pos[:, None]          # [B, S]
    k = torch.where(valid[..., None, None], k, torch.zeros_like(k))
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, Hk, -1, D).float(), k) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid[:, None, None]
    v_scale = torch.where(valid[..., None], vs[idx].float().reshape(B, -1, Hk), 0.0)
    pv = (p * v_scale.permute(0, 2, 1)[:, :, None]).half().float()
    acc = torch.einsum("bhgs,bshd->bhgd", pv, v8[idx].float().reshape(B, -1, Hk, D))
    return (acc / p.sum(-1, keepdim=True)).reshape(B, Hq, D)


def test_decode_error_bound_covers_fp16_rounding_and_catches_a_dropped_page():
    """decode_error_bound, the int8 decode kernel's tolerance: it holds the
    kernel's one fp16 rounding (emulated) at contexts up to 1024 with NaN
    in stale scales, and it is tight enough that leaving out a sequence's
    first page fails it."""
    q, (k8, v8, ks, vs), pts, pos = _decode_case(4, **_SPLIT_EDGES)
    ks, vs = ks.copy(), vs.copy()
    for b, p in enumerate(pos[:, 0]):
        ks[pts[b, p // 16], p % 16 + 1:] = np.nan
        vs[pts[b, p // 16], p % 16 + 1:] = np.nan
    k_pair, v_pair = _torch_pairs(k8, v8, ks, vs)
    args = (_t(q)[:, 0], k_pair, v_pair, _t(pts), _t(pos)[:, 0])
    acc, _, l = pak.paged_decode_plain(*args, scale=0.125)
    ref = acc / l
    bound = pak.decode_error_bound(*args, scale=0.125)
    assert torch.isfinite(bound).all() and (bound >= 1e-5).all()
    emulated = _fp16_pv_decode(*args, scale=0.125)
    assert 0 < (emulated - ref).abs().max() and ((emulated - ref).abs() <= bound).all()
    acc, _, l = pak.paged_decode_plain(*args, scale=0.125, page_range=(1, pts.shape[1]))
    assert ((acc / l - ref).abs() > bound).any(dim=(1, 2)).all()


def test_quantized_decode_never_multiplies_stale_scales():
    """NaN in the values' scales of rows past each position (unwritten
    slots of the last page) must not reach the output."""
    q, (k8, v8, ks, vs), pts, pos = _decode_case(1, B=2, positions=(5, 20))
    ks, vs = ks.copy(), vs.copy()
    for b, p in enumerate((5, 20)):
        page = pts[b, p // 16]
        ks[page, p % 16 + 1:] = np.nan
        vs[page, p % 16 + 1:] = np.nan
    got = pak.paged_attention_decode(_t(q), *_torch_pairs(k8, v8, ks, vs), _t(pts),
                                     _t(pos), scale=0.25)
    assert np.isfinite(got.numpy()).all()


def test_kv_kill_switch_routes_int8_to_gather_and_scatter(monkeypatch):
    """POLYKEY_DISABLE_KV_KERNEL=1: int8 decode goes to the gather path
    (dequantized window, flash_attention's plain version) and the T == 1
    write to the token scatter, with the same results; the bf16 gate is
    untouched."""
    q, pools, pts, pos = _decode_case(2)
    args = (_t(q), *_torch_pairs(*pools), _t(pts), _t(pos))
    want = pak.paged_attention_decode(*args, scale=0.125, window=24)
    kn = np.random.default_rng(5).normal(size=(5, 1, 2, 16)).astype(np.float32)
    w_pools = _torch_pairs(*pools)
    tpa.paged_write(*w_pools, _t(kn), _t(kn), _t(pts), _t(pos))
    monkeypatch.setenv("POLYKEY_DISABLE_KV_KERNEL", "1")
    assert not pak.use_quantized_paged_kernel() and pak.use_paged_kernel()
    got = pak.paged_attention_decode(*args, scale=0.125, window=24)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    s_pools = _torch_pairs(*pools)
    tpa.paged_write(*s_pools, _t(kn), _t(kn), _t(pts), _t(pos))
    for x, y in zip((*w_pools[0], *w_pools[1]), (*s_pools[0], *s_pools[1])):
        _same(x, y)


# -- ragged attention ---------------------------------------------------------


def _ragged_case(seed, seq_lens, kv_lens, *, N=32, ps=8, Hk=2, Hq=4, D=32, P=8,
                 empty=0):
    """Ascending contiguous ranges padded to a multiple of 8 rows, `empty`
    unused ranges past the stream, int8 pools quantized from normals."""
    rng = np.random.default_rng(seed)
    seq_lens = np.asarray(list(seq_lens) + [0] * empty, np.int32)
    kv_lens = np.asarray(list(kv_lens) + [0] * empty, np.int32)
    T = -(-int(seq_lens.sum()) // 8) * 8
    starts = np.concatenate([[0], np.cumsum(seq_lens)[:-1]]).astype(np.int32)
    starts[len(starts) - empty:] = T
    pools = []
    for _ in range(2):
        q8, s = jpa.quantize_kv_rows(jnp.asarray(rng.normal(size=(N, ps, Hk, D)),
                                                 jnp.float32))
        pools += [np.asarray(q8), np.asarray(s)]
    k8, ks, v8, vs = pools
    tables = rng.integers(1, N, size=(len(seq_lens), P)).astype(np.int32)
    q = rng.normal(size=(T, Hq, D)).astype(np.float32)
    rows = np.arange(T)
    sid = np.clip(np.searchsorted(starts, rows, side="right") - 1, 0, len(starts) - 1)
    in_seq = (rows >= starts[sid]) & (rows < starts[sid] + seq_lens[sid])
    return dict(q=q, pools=(k8, v8, ks, vs), tables=tables, meta=(starts, seq_lens,
                kv_lens), in_seq=in_seq)


RAGGED = {
    "mixed": dict(seed=0, seq_lens=[1, 11, 1, 5], kv_lens=[37, 20, 5, 48]),
    "decode_only": dict(seed=2, seq_lens=[1] * 12, N=64,
                        kv_lens=[1, 7, 8, 9, 15, 16, 17, 30, 31, 40, 55, 63]),
    "prefill_only": dict(seed=4, seq_lens=[24], kv_lens=[24]),
    "empty_ranges": dict(seed=6, seq_lens=[1, 13, 2], kv_lens=[30, 13, 50], empty=3),
}


@pytest.mark.parametrize("name,softcap,win", [
    ("mixed", None, None), ("mixed", 30.0, None), ("mixed", None, 16),
    ("mixed", 30.0, 16), ("decode_only", None, None), ("prefill_only", None, None),
    ("empty_ranges", 30.0, 16),
])
def test_quantized_ragged_matches_jax_kernel(name, softcap, win):
    """The plain int8 ragged attention and the public op against the JAX
    int8 kernel (_ragged_call, interpret mode); padding rows exactly 0."""
    spec = dict(RAGGED[name])
    c = _ragged_case(spec.pop("seed"), **spec)
    kw = dict(scale=0.125, logit_softcap=softcap)
    want = np.asarray(j_ragged(
        jnp.asarray(c["q"]), *_jax_pairs(*c["pools"]), jnp.asarray(c["tables"]),
        *(jnp.asarray(m) for m in c["meta"]), interpret=True,
        window=None if win is None else jnp.int32(win), **kw))
    args = (_t(c["q"]), *_torch_pairs(*c["pools"]), _t(c["tables"]),
            *(_t(m) for m in c["meta"]))
    rows = c["in_seq"]
    for got in (rk.ragged_attention_plain(*args, window=win, **kw),
                rk.ragged_paged_attention(*args, window=win, **kw)):
        np.testing.assert_allclose(got.numpy()[rows], want[rows], atol=TOL, rtol=0)
        assert np.all(got.numpy()[~rows] == 0.0)


def test_quantized_ragged_gather_matches_plain():
    """The per-token gather oracle over pair pools (dequantized windows)
    against the plain version."""
    c = _ragged_case(8, seq_lens=[1, 6, 1], kv_lens=[13, 6, 20])
    starts, lens, kvs = c["meta"]
    T = c["q"].shape[0]
    sid = np.clip(np.searchsorted(starts, np.arange(T), side="right") - 1, 0, 2)
    pos = np.where(c["in_seq"], kvs[sid] - lens[sid] + np.arange(T) - starts[sid], 0)
    tok_tables = np.where(c["in_seq"][:, None], c["tables"][sid], 0).astype(np.int32)
    pairs = _torch_pairs(*c["pools"])
    got = rk.ragged_gather_attention(_t(c["q"]), *pairs, _t(tok_tables),
                                     _t(pos.astype(np.int32)), scale=0.125)
    want = rk.ragged_attention_plain(_t(c["q"]), *pairs, _t(c["tables"]),
                                     *(_t(m) for m in c["meta"]), scale=0.125)
    rows = c["in_seq"]
    np.testing.assert_allclose(got.numpy()[rows], want.numpy()[rows], atol=TOL, rtol=0)


# -- forward passes -----------------------------------------------------------


def _params(model):
    jcfg = j_get_config(model)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, jp, params_from_numpy(jax.device_get(jp))


def _same_pools(tpaged, jpaged):
    """Every pool but the garbage page 0, bit for bit."""
    for name in ("k", "v", "ks", "vs"):
        _same(getattr(tpaged, name)[:, 1:], np.asarray(getattr(jpaged, name))[:, 1:],
              name)


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma"])
def test_forward_paged_int8_matches_jax(model):
    """Prefill two right-padded prompts, then two decode steps, over int8
    pools on both sides: hidden states and the four pools."""
    jcfg, jp, tp = _params(model)
    cfg = get_config(model)
    B, T, ps, N = 2, 16, 8, 9
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jpaged = jkv.init_paged_kv(jcfg, N, ps, jnp.float32, kv_dtype=jnp.int8)
    tpaged = tkv.init_paged_kv(cfg, N, ps, torch.float32, kv_dtype=torch.int8)
    assert tpaged.quantized and tpaged.k.dtype == torch.int8
    jh, jpaged = jt.forward_paged(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                  jpaged, jnp.asarray(tables))
    th, tpaged = tt.forward_paged(tp, cfg, _t(tokens), _t(positions), tpaged, _t(tables))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=0)
    for step in range(2):
        last = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.array([[11 + step], [16 + step]], np.int32)
        jh, jpaged = jt.forward_paged(jp, jcfg, jnp.asarray(last), jnp.asarray(pos),
                                      jpaged, jnp.asarray(tables))
        th, tpaged = tt.forward_paged(tp, cfg, _t(last), _t(pos), tpaged, _t(tables))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=0)
    _same_pools(tpaged, jpaged)


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma"])
def test_forward_ragged_int8_matches_jax(model):
    """Two decode singles (positions 6 and 9) and a 7-token prefill range at
    KV length 12, over int8 pools that already hold earlier rows (the
    JAX package quantized them; both sides start from its pools)."""
    jcfg, jp, tp = _params(model)
    cfg = get_config(model)
    rng = np.random.default_rng(9)
    T, P = 16, 4
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0]], np.int32)
    tokens = rng.integers(3, cfg.vocab_size, T).astype(np.int32)
    positions = np.zeros(T, np.int32)
    positions[:2] = [6, 9]
    positions[2:9] = np.arange(5, 12)
    tok_tables = np.zeros((T, P), np.int32)
    tok_tables[0], tok_tables[1], tok_tables[2:9] = tables
    meta = (np.array([0, 1, 2, T], np.int32), np.array([1, 1, 7, 0], np.int32),
            np.array([7, 10, 12, 0], np.int32))
    seq_tables = np.concatenate([tables, np.zeros((1, P), np.int32)])
    shape = (cfg.num_layers, 8, 8, cfg.num_kv_heads, cfg.head_dim)
    k8, ks = jpa.quantize_kv_rows(jnp.asarray(rng.normal(size=shape), jnp.float32))
    v8, vs = jpa.quantize_kv_rows(jnp.asarray(rng.normal(size=shape), jnp.float32))
    jpaged = jkv.PagedKV(k=k8, v=v8, ks=ks, vs=vs)
    tpaged = paged_kv_from_numpy(jax.device_get(jpaged))
    ops = (tok_tables, *meta, seq_tables)
    jh, jpaged = jt.forward_ragged(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                   jpaged, *(jnp.asarray(a) for a in ops))
    th, tpaged = tt.forward_ragged(tp, cfg, _t(tokens), _t(positions), tpaged,
                                   *(_t(a) for a in ops))
    np.testing.assert_allclose(th[:9].numpy(), np.asarray(jh)[:9], atol=TOL, rtol=0)
    _same_pools(tpaged, jpaged)


def test_paged_kv_from_numpy_is_exact():
    jcfg, cfg = j_get_config("tiny-llama"), get_config("tiny-llama")
    rng = np.random.default_rng(3)
    k8, ks = jpa.quantize_kv_rows(jnp.asarray(rng.normal(size=(2, 4, 8, 2, 16)),
                                              jnp.float32))
    jpaged = jkv.init_paged_kv(jcfg, 4, 8, kv_dtype=jnp.int8).replace(k=k8, ks=ks)
    tpaged = paged_kv_from_numpy(jax.device_get(jpaged))
    assert tpaged.quantized and tpaged.ks.dtype == torch.bfloat16
    _same(tpaged.k, np.asarray(k8))
    _same(tpaged.ks, np.asarray(ks))
    jfp = jkv.init_paged_kv(jcfg, 4, 8, jnp.float32)
    fp = paged_kv_from_numpy(jax.device_get(jfp.replace(k=jfp.k + 1.0)))
    assert not fp.quantized and fp.vs is None and fp.k.dtype == torch.float32
    assert bool((fp.k == 1.0).all()) and bool((fp.v == 0.0).all())
    assert tkv.kv_pool_bytes(cfg, 64, 8, kv_dtype=torch.int8) == jkv.kv_pool_bytes(
        jcfg, 64, 8, kv_dtype=jnp.int8)
    big, jbig = get_config("llama-3-8b"), j_get_config("llama-3-8b")
    assert tkv.kv_pool_bytes(big, 2048, 16, kv_dtype=torch.int8) == jkv.kv_pool_bytes(
        jbig, 2048, 16, kv_dtype=jnp.int8) == 2 * 32 * 2048 * 16 * 8 * 130


# -- the engines --------------------------------------------------------------


FIELDS = dict(
    model="tiny-llama", tokenizer="byte", dtype="float32", kv_dtype="int8",
    max_decode_slots=4, page_size=8, num_pages=64, max_seq_len=64,
    prefill_buckets=(16, 32), max_new_tokens_cap=16, decode_block_steps=4,
    prefill_chunk=16, prefill_budget=16,
)
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
GREEDY = [
    dict(prompt="hi", max_new_tokens=8, seed=11),
    dict(prompt="abcdefgh" * 2, max_new_tokens=8, seed=11),
    dict(prompt="abcdefgh" * 5, max_new_tokens=8, seed=11),   # chunked
    dict(prompt="xyz", max_new_tokens=8, seed=11),
]
SAMPLED = [dict(prompt="hello world", max_new_tokens=6, temperature=0.9, top_p=0.8,
                top_k=5, seed=42)]


def _streams(engine, make, specs, timeout=60.0):
    requests = [make(**s) for s in specs]
    for r in requests:
        engine.submit(r)
    outs = []
    for r in requests:
        tokens, deadline = [], time.monotonic() + timeout
        while True:
            kind, value = r.out.get(timeout=max(0.0, deadline - time.monotonic()))
            if kind == "token":
                tokens.append(value)
            else:
                assert kind == "done", value
                break
        outs.append(tokens)
    return outs


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                          jnp.float32)


@pytest.fixture(scope="module")
def want_greedy(jax_params):
    eng = JInferenceEngine(JEngineConfig(**FIELDS, **JAX_ONLY), params=jax_params)
    try:
        assert eng.paged.quantized
        return _streams(eng, JGenRequest, GREEDY)
    finally:
        eng.shutdown()


def _serve(jax_params, specs, **extra):
    eng = InferenceEngine(EngineConfig(**{**FIELDS, **extra}),
                          params=params_from_numpy(jax.device_get(jax_params)),
                          device="cpu")
    try:
        return _streams(eng, GenRequest, specs), eng.stats()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("ragged", [False, True])
def test_int8_greedy_streams_match_jax_bucketed(jax_params, want_greedy, ragged):
    """Short prompts, a bucket-sized one and a 40-byte prompt past the
    largest bucket (chunked in the bucketed mode, ranges in the ragged
    one), served over int8 pools: the JAX bucketed int8 engine's tokens."""
    got, stats = _serve(jax_params, GREEDY, ragged_dispatch=ragged)
    assert got == want_greedy
    assert stats["ragged"] is ragged and stats["kv_dtype"] == "int8"
    assert stats["kv_pool_bytes"] == tkv.kv_pool_bytes(
        get_config("tiny-llama"), 64, 8, kv_dtype=torch.int8)
    assert stats["kernel_launches"].keys() == tengine.KERNELS.keys()


def test_int8_sampled_stream_is_the_same_in_both_modes(jax_params):
    """A seeded sampled stream over int8 pools: the ragged engine's tokens
    are the bucketed engine's (draws keyed by seed and position)."""
    bucketed, _ = _serve(jax_params, SAMPLED)
    ragged, _ = _serve(jax_params, SAMPLED, ragged_dispatch=True)
    assert ragged == bucketed and len(bucketed[0]) == 6


def test_int8_config_validates_and_reads_the_env(monkeypatch):
    EngineConfig(**FIELDS).validate()
    dataclasses.replace(EngineConfig(**FIELDS), ragged_dispatch=True).validate()
    monkeypatch.setenv("POLYKEY_KV_DTYPE", "int8")
    assert EngineConfig.from_env().kv_dtype == "int8"
    with pytest.raises(ValueError, match="kv_dtype"):
        dataclasses.replace(EngineConfig(**FIELDS), kv_dtype="int4").validate()
