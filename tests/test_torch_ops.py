"""The port's attention ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both. On the CPU the
port's kernel wrappers take their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_kernels.py does.
Tolerance: both sides compute in float32 with different summation orders
(XLA vs ATen, blockwise vs whole-row softmax), so 2e-5 absolute on O(1)
outputs, the same bound tests/test_kernels.py holds the kernels to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polykey_tpu.ops import attention as jattn
from polykey_tpu.ops import paged_attention as jpa
from polykey_tpu.ops.flash_attention import flash_attention as j_flash
from polykey_tpu.ops.paged_attention_kernel import (
    paged_attention_decode as j_decode,
)
from polykey_tpu.ops.paged_write_kernel import paged_write_decode_kernel
from polykey_tpu_torch.ops import attention as tattn
from polykey_tpu_torch.ops import paged_attention as tpa
from polykey_tpu_torch.ops.flash_attention import flash_attention as t_flash
from polykey_tpu_torch.ops.paged_attention_kernel import (
    paged_attention_decode as t_decode,
)
from polykey_tpu_torch.ops.paged_write_kernel import paged_write_decode

torch.set_num_threads(2)

TOL = 2e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _qkv(B, T, S, Hq, Hk, D, seed=0):
    r = _rng(seed)
    return (
        r.standard_normal((B, T, Hq, D), dtype=np.float32),
        r.standard_normal((B, S, Hk, D), dtype=np.float32),
        r.standard_normal((B, S, Hk, D), dtype=np.float32),
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("win,softcap", [(None, None), (8, 30.0)])
def test_attention_reference_matches(win, softcap):
    q, k, v = _qkv(2, 12, 20, 4, 2, 16)
    qpos = np.broadcast_to(np.arange(12, dtype=np.int32) + 5, (2, 12)).copy()
    jm = jattn.make_attention_mask(jnp.asarray(qpos), 20, sliding_window=win)
    tm = tattn.make_attention_mask(_t(qpos), 20, sliding_window=win)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                           scale=0.25, logit_softcap=softcap)
    got = tattn.attention(_t(q), _t(k), _t(v), tm, scale=0.25,
                          logit_softcap=softcap)
    _close(got, want)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("softcap,win", [
    (None, None), (50.0, None), (None, 24), (30.0, 24),
])
def test_flash_attention_matches_jax_kernel(D, softcap, win):
    """GQA, soft-cap, sliding window, ragged per-row offsets, and padded
    rows at position -1 (which must come out 0)."""
    B, T, S, Hq, Hk = 2, 40, 72, 4, 2
    q, k, v = _qkv(B, T, S, Hq, Hk, D, seed=D)
    qpos = (np.arange(T, dtype=np.int32)[None, :] + np.array([[3], [17]])).astype(np.int32)
    qpos[1, -6:] = -1                                   # padding rows
    w = None if win is None else win
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(qpos), scale=D ** -0.5, logit_softcap=softcap,
                   window=None if w is None else jnp.int32(w), interpret=True)
    got = t_flash(_t(q), _t(k), _t(v), _t(qpos), scale=D ** -0.5,
                  logit_softcap=softcap, window=w)
    _close(got, want)
    assert np.all(got.numpy()[1, -6:] == 0.0)


def _paged_case(B, Hq, Hk, D, ps, P, positions, seed=0):
    r = _rng(seed)
    N = B * P + 1
    q = r.standard_normal((B, 1, Hq, D), dtype=np.float32)
    kp = r.standard_normal((N, ps, Hk, D), dtype=np.float32)
    vp = r.standard_normal((N, ps, Hk, D), dtype=np.float32)
    pts = np.zeros((B, P), np.int32)         # garbage-page tails stay 0
    page = 1
    for b in range(B):
        for j in range(positions[b] // ps + 1):
            pts[b, j] = page
            page += 1
    pos = np.asarray(positions, np.int32).reshape(B, 1)
    return q, kp, vp, pts, pos


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("softcap,win", [
    (None, None), (50.0, None), (None, 24), (30.0, 24),
])
def test_paged_decode_matches_jax_kernel(D, softcap, win):
    """Page-boundary positions (15, 16, 63), garbage tails, GQA."""
    q, kp, vp, pts, pos = _paged_case(5, 8, 2, D, 16, 8, [5, 15, 16, 63, 100])
    want = j_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(pts), jnp.asarray(pos), scale=0.125,
                    logit_softcap=softcap,
                    window=None if win is None else jnp.int32(win),
                    interpret=True)
    got = t_decode(_t(q), _t(kp), _t(vp), _t(pts), _t(pos), scale=0.125,
                   logit_softcap=softcap, window=win)
    _close(got, want)


@pytest.mark.parametrize("g", [1, 3])
def test_paged_decode_matches_multi_group_kernel(g):
    """The JAX kernel streaming pages in groups of g (partial last group,
    window starting mid-group) against the port's one-pass version."""
    q, kp, vp, pts, pos = _paged_case(4, 8, 2, 64, 16, 8, [5, 37, 63, 100])
    want = j_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(pts), jnp.asarray(pos), scale=0.125,
                    window=jnp.int32(24), interpret=True, pages_per_block=g)
    got = t_decode(_t(q), _t(kp), _t(vp), _t(pts), _t(pos), scale=0.125,
                   window=24)
    _close(got, want)


def test_paged_decode_never_multiplies_stale_v():
    """NaN in V rows past the position (stale tail of the last page) must
    not reach the output: masked rows contribute exactly nothing."""
    q, kp, vp, pts, pos = _paged_case(2, 4, 2, 16, 16, 4, [5, 20])
    vp = vp.copy()
    vp[pts[0, 0], 6:] = np.nan               # rows 6..15 of lane 0's page
    vp[pts[1, 1], 5:] = np.nan               # rows 21..31 of lane 1
    got = t_decode(_t(q), _t(kp), _t(vp), _t(pts), _t(pos), scale=0.25)
    assert np.isfinite(got.numpy()).all()


def test_paged_gather_matches():
    _, kp, vp, pts, _ = _paged_case(3, 4, 2, 16, 8, 4, [3, 9, 30])
    jk, jv = jpa.paged_gather_kv(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pts))
    tk, tv = tpa.paged_gather_kv(_t(kp), _t(vp), _t(pts))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def _write_fixture(B, T, P, start, ps=8, Hk=2, D=16, seed=0):
    r = _rng(seed)
    N = B * P + 1
    kp = r.standard_normal((N, ps, Hk, D), dtype=np.float32)
    vp = r.standard_normal((N, ps, Hk, D), dtype=np.float32)
    kn = r.standard_normal((B, T, Hk, D), dtype=np.float32)
    vn = r.standard_normal((B, T, Hk, D), dtype=np.float32)
    pts = np.zeros((B, P), np.int32)
    page = 1
    for b in range(B):
        for j in range(P):
            pts[b, j] = page
            page += 1
    pos = (np.asarray(start)[:, None] + np.arange(T)[None, :]).astype(np.int32)
    return kp, vp, kn, vn, pts, pos


@pytest.mark.parametrize("start", [[0, 8, 16], [0, 8, 17]])
def test_paged_write_prefill_paths_match(start):
    """Page-aligned consecutive rows (the page scatter) and unaligned
    starts (the token scatter) against the JAX paged_write."""
    kp, vp, kn, vn, pts, pos = _write_fixture(3, 16, 4, start)
    jk, jv = jpa.paged_write(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn),
                             jnp.asarray(vn), jnp.asarray(pts), jnp.asarray(pos))
    tk, tv = tpa.paged_write(_t(kp), _t(vp), _t(kn), _t(vn), _t(pts), _t(pos))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("start,aligned", [([0, 8, 16], True), ([0, 8, 17], False)])
def test_paged_write_host_alignment_hint(start, aligned):
    """A caller's host-side `aligned` picks the same path the check on the
    positions picks, and writes the same pools."""
    kp, vp, kn, vn, pts, pos = _write_fixture(3, 16, 4, start)
    assert tpa.positions_aligned(_t(pos), kp.shape[1]) is aligned
    want = tpa.paged_write(_t(kp.copy()), _t(vp.copy()), _t(kn), _t(vn), _t(pts),
                           _t(pos))
    got = tpa.paged_write(_t(kp.copy()), _t(vp.copy()), _t(kn), _t(vn), _t(pts),
                          _t(pos), aligned=aligned)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_paged_write_decode_matches_jax_kernel():
    """T == 1 rows against the JAX write kernel (interpret mode), with two
    inactive lanes writing the garbage page 0: every page but 0 must agree
    exactly; the write happens in place."""
    B, P = 5, 3
    kp, vp, kn, vn, pts, pos = _write_fixture(B, 1, P, [5, 16, 23, 0, 0])
    pts[3:] = 0                                     # inactive lanes
    ps = kp.shape[1]
    page_ids = pts[np.arange(B), pos[:, 0] // ps]
    want_k, want_v = paged_write_decode_kernel(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(page_ids), jnp.asarray(pos[:, 0] % ps), interpret=True,
    )
    tk, tv = _t(kp.copy()), _t(vp.copy())
    got_k, got_v = paged_write_decode(tk, tv, _t(kn), _t(vn), _t(pts), _t(pos))
    assert got_k is tk and got_v is tv
    np.testing.assert_array_equal(np.asarray(want_k)[1:], tk.numpy()[1:])
    np.testing.assert_array_equal(np.asarray(want_v)[1:], tv.numpy()[1:])
    via_dispatch = tpa.paged_write(
        _t(kp.copy()), _t(vp.copy()), _t(kn), _t(vn), _t(pts), _t(pos)
    )
    np.testing.assert_array_equal(via_dispatch[0].numpy()[1:], tk.numpy()[1:])


def test_kill_switches_route_to_the_plain_paths(monkeypatch):
    """POLYKEY_DISABLE_PAGED_KERNEL sends decode through the gather path
    and the T == 1 write through the token scatter, POLYKEY_DISABLE_FLASH
    sends prefill to the masked reference; each gives the same result."""
    q, kp, vp, pts, pos = _paged_case(3, 4, 2, 16, 8, 4, [3, 9, 30])
    args = (_t(q), _t(kp), _t(vp), _t(pts), _t(pos))
    want = t_decode(*args, scale=0.25)
    wk, wv, kn, vn, wpts, wpos = _write_fixture(3, 1, 4, [5, 9, 30])
    want_w = tpa.paged_write(_t(wk.copy()), _t(wv.copy()), _t(kn), _t(vn),
                             _t(wpts), _t(wpos))
    fq, fk, fv = _qkv(1, 128, 128, 4, 2, 16)
    fpos = np.arange(128, dtype=np.int32)[None]
    want_f = t_flash(_t(fq), _t(fk), _t(fv), _t(fpos), scale=0.25)
    monkeypatch.setenv("POLYKEY_DISABLE_PAGED_KERNEL", "1")
    monkeypatch.setenv("POLYKEY_DISABLE_FLASH", "1")
    _close(t_decode(*args, scale=0.25), want)
    got_w = tpa.paged_write(_t(wk.copy()), _t(wv.copy()), _t(kn), _t(vn),
                            _t(wpts), _t(wpos))
    np.testing.assert_array_equal(got_w[0].numpy(), want_w[0].numpy())
    _close(t_flash(_t(fq), _t(fk), _t(fv), _t(fpos), scale=0.25), want_f)
