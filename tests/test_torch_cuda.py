"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu` and skipped where there is no CUDA device. On a machine with
the card (which need not have JAX, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py checks the kernels at the Llama-3-8B shapes of the main
path; these cover the other geometries each kernel is instantiated for
(head dims 64/128/256, 1/2/4/8 query heads per kv head, small pages,
partial tiles, stale rows that hold NaN) and the wrappers' refusals.
Tolerances as in chip_smoke.py:
decode 2e-3 on the normalized fp32 output and, per element,
paged_attention_kernel.decode_error_bound (below; the bf16 kernel takes q,
K and V exactly and each probability in two bf16 halves, within 2^-16 p),
flash per element 2^-7 (|ref| + sum p|v|) + 1e-4 (bf16 probabilities and
output rounded once on each side), ragged per element 2^-7 sum p|v| + 1e-4
(the kernel rounds each probability to bf16 once, unit roundoff 2^-8; the
factor 2 covers exp and fp32 sums in another order), the write exact.
The int8-KV variants are held to the same bounds over the dequantized
values (k8 * ks, v8 * vs), and the int8 decode kernel, which takes the int8
values exactly in fp16 on tensor cores with fp32 sums and rounds each
probability times its V scale to fp16 once, also per element to
paged_attention_kernel.decode_error_bound (2^-11 sum p|v| / l + 2^-25
sum |v8| / l + 1e-5 (1 + sum p|v| / l)); the int8 ragged kernel folds each
V scale into the probability before the one bf16 rounding; the quantizing
write is exact.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(python -m pytest --noconftest tests/test_torch_cuda.py on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_decode_kernel_geometries(gen, monkeypatch, D, groups):
    """The bf16 decode kernel over contexts split and unsplit, soft-cap,
    window and a page range; NaN in the unwritten K and V rows of each
    sequence's last page. Within 2e-3 flat and decode_error_bound per
    element, m within 1e-3; every call repeated bit-identically, once more
    with the split scratch poisoned with NaN; the arrival counters back at
    0; one launch a call."""
    _decode_repeat_and_poison(gen, monkeypatch, _bf16_decode_inputs,
                              D, groups, 2, 8, 80, _CTX)


def _bf16_decode_inputs(gen, D, groups, Hk, ps, P, ctx):
    """(q, k, v, tables, positions) over bf16 pools, each sequence on pages
    of its own; the unwritten rows of each last page hold NaN in K and V."""
    B, Hq = len(ctx), Hk * groups
    pages = [-(-n // ps) for n in ctx]
    N = sum(pages) + 1
    kp, vp = _randn((N, ps, Hk, D), gen), _randn((N, ps, Hk, D), gen)
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    nxt = 1
    for b, n in enumerate(pages):
        tables[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
        tail = ctx[b] - (n - 1) * ps
        kp[nxt - 1, tail:] = float("nan")
        vp[nxt - 1, tail:] = float("nan")
    q = _randn((B, Hq, D), gen)
    pos = torch.tensor([n - 1 for n in ctx], dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, pos


def _decode_repeat_and_poison(gen, monkeypatch, inputs, D, groups, Hk, ps, P, ctx):
    """The decode kernel on `inputs`' case (bf16 or int8 pools) with no
    options, soft-cap and window, and a page range: each call checked by
    _check_decode, repeated bit-identically, and again with the split
    scratch poisoned with NaN (no split without rows is read); the arrival
    counters back at 0 after each; one launch of the pools' kernel a call."""
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    args = inputs(gen, D, groups, Hk, ps, P, ctx)
    kernel = pak.KERNEL_INT8 if isinstance(args[1], tuple) else pak.KERNEL
    before = kernel.launches
    cases = (dict(), dict(logit_softcap=30.0, window=50), dict(page_range=(3, 40)))
    for kw in cases:
        got = pak.paged_decode_cuda(*args, scale=D ** -0.5, **kw)
        _check_decode(pak, got, args, scale=D ** -0.5, **kw)
        again = pak.paged_decode_cuda(*args, scale=D ** -0.5, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(pak, "split_scratch", _poisoned(pak.split_scratch))
            poisoned = pak.paged_decode_cuda(*args, scale=D ** -0.5, **kw)
        for other in (again, poisoned):
            for x, y in zip(got, other):
                assert torch.equal(x, y), kw
        assert (pak.arrival_counters(0, "cuda") == 0).all(), kw
    assert kernel.launches == before + 3 * len(cases)


def _stale_rows(x, qpos, window):
    """A copy of the window `x` [B, S, Hk, D] with NaN in every row no query
    of its batch row can see: past the largest position, before the
    smallest position's window."""
    x = x.clone()
    for b in range(x.shape[0]):
        valid = qpos[b][qpos[b] >= 0]
        if valid.numel() == 0:
            x[b] = float("nan")
            continue
        x[b, int(valid.max()) + 1:] = float("nan")
        if window:
            x[b, :max(0, int(valid.min()) - window + 1)] = float("nan")
    return x


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [1, 63, 65, 200])
def test_flash_kernel_geometries(gen, D, groups, T):
    """Query counts around the 64-row tile, GQA groups 1..8, windows whose
    edge falls inside a key tile, a batch row of padding only (and, at
    T=200, a last query tile of padding), and stale rows: NaN in K and V
    at every row no query sees, against the plain version over the same
    window with those rows 0."""
    from polykey_tpu_torch.ops import flash_attention as fa

    Hk, B, S = 2, 3, 333                      # partial query and key tiles
    Hq = Hk * groups
    q, k, v = (_randn((B, T, Hq, D), gen), _randn((B, S, Hk, D), gen),
               _randn((B, S, Hk, D), gen))
    qpos = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    qpos[1] += 120
    pad = T - T // 4
    qpos[1, pad:] = -1
    qpos[2] = -1
    for kw in (dict(), dict(logit_softcap=50.0, window=64), dict(window=37)):
        w = kw.get("window")
        for stale in (False, True):
            kk, vv = (_stale_rows(k, qpos, w), _stale_rows(v, qpos, w)) if stale else (k, v)
            out = fa.flash_attention_cuda(q, kk, vv, qpos, scale=D ** -0.5, **kw)
            kz, vz = torch.nan_to_num(kk, nan=0.0), torch.nan_to_num(vv, nan=0.0)
            ref = fa.flash_attention_plain(q, kz, vz, qpos, scale=D ** -0.5, **kw).float()
            ref_abs = fa.flash_attention_plain(q, kz, vz.abs(), qpos, scale=D ** -0.5,
                                               **kw).float()
            tol = 2.0 ** -7 * (ref.abs() + ref_abs) + 1e-4
            assert torch.isfinite(out).all(), (kw, stale)
            err = (out.float() - ref).abs()
            assert (err <= tol).all(), (kw, stale, (err / tol).max().item())
            assert (out[1, pad:] == 0).all() and (out[2] == 0).all(), (kw, stale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_write_kernel_is_exact(gen, dtype):
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    N, ps, Hk, D, B, P = 40, 8, 2, 64, 7, 5
    kp, vp = _randn((N, ps, Hk, D), gen, dtype), _randn((N, ps, Hk, D), gen, dtype)
    kn, vn = _randn((B, 1, Hk, D), gen, dtype), _randn((B, 1, Hk, D), gen, dtype)
    tables = torch.arange(1, 1 + B * P, dtype=torch.int32, device="cuda").reshape(B, P)
    tables[5] = 0                                        # an inactive lane
    # The last lane's negative position takes floor division and modulo,
    # as in the plain version: page index clamps to 0, offset ps - 3.
    pos = torch.tensor([[0], [7], [8], [39], [12], [0], [-3]], dtype=torch.int32,
                       device="cuda")
    a = pw.paged_write_decode_cuda(kp.clone(), vp.clone(), kn, vn, tables, pos)
    b = pw.paged_write_decode_plain(kp.clone(), vp.clone(), kn, vn, tables, pos)
    assert torch.equal(a[0][1:], b[0][1:]) and torch.equal(a[1][1:], b[1][1:])


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    from polykey_tpu_torch.ops import flash_attention as fa
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    q = _randn((1, 128, 4, 48), gen)
    k = _randn((1, 128, 2, 48), gen)
    qpos = torch.arange(128, dtype=torch.int32, device="cuda")[None]
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, k, k, qpos, scale=0.1)
    with pytest.raises(ValueError, match="must be"):
        fa.flash_attention_cuda(q.float(), k, k, qpos, scale=0.1)
    qd = _randn((2, 6, 64), gen)
    pool = _randn((4, 8, 2, 64), gen)
    tables = torch.ones((2, 3), dtype=torch.int32, device="cuda")
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="Hq / Hk"):
        pak.paged_decode_cuda(qd, pool, pool, tables, pos, scale=0.1)
    # The copy moves 16-byte vectors: rows 8 bytes off a boundary are refused.
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    rows = torch.empty(2 * 2 * 64 + 4, dtype=torch.bfloat16, device="cuda")[4:]
    rows = rows.view(2, 1, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pw.paged_write_decode_cuda(pool, pool.clone(), rows, rows, tables, pos[:, None])


def _ragged_case(gen, D, Hq, Hk, lens, kvs, ps=8, P=80, empty=2):
    """Ascending ranges from row 0, the stream padded to a multiple of 8,
    `empty` unused ranges past its end; distinct pages per sequence, and
    NaN in the unwritten V rows of each sequence's last page."""
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    used = sum(lens)
    T = -(-used // rk.TOKEN_TILE) * rk.TOKEN_TILE
    starts = [sum(lens[:i]) for i in range(len(lens))] + [T] * empty
    lens, kvs = list(lens) + [0] * empty, list(kvs) + [0] * empty
    pages = [-(-kv // ps) for kv in kvs]
    N = sum(pages) + 1
    kp, vp = _randn((N, ps, Hk, D), gen), _randn((N, ps, Hk, D), gen)
    tables = torch.zeros((len(lens), P), dtype=torch.int32, device="cuda")
    nxt = 1
    for s, (kv, n) in enumerate(zip(kvs, pages)):
        if n:
            tables[s, :n] = torch.arange(nxt, nxt + n)
            nxt += n
            vp[nxt - 1, kv - (n - 1) * ps:] = float("nan")
    q = _randn((T, Hq, D), gen)
    meta = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (starts, lens, kvs)]
    return (q, kp, vp, tables, *meta), used


def _ragged_int8_case(gen, D, Hq, Hk, lens, kvs, **kw):
    """_ragged_case over int8 pools quantized from its bf16 ones; in the
    unwritten rows of each sequence's last page K holds 127 and both scales
    NaN."""
    from polykey_tpu_torch.ops.paged_attention import quantize_kv_rows

    (q, kp, vp, *rest), used = _ragged_case(gen, D, Hq, Hk, lens, kvs, **kw)
    stale = torch.isnan(vp).any(-1)                      # [N, ps, Hk]
    kpair = quantize_kv_rows(kp)
    vpair = quantize_kv_rows(torch.nan_to_num(vp, nan=0.0))
    kpair[0][stale] = 127
    for _, scales in (kpair, vpair):
        scales[stale] = float("nan")
    return (q, kpair, vpair, *rest), used


def _ragged_within_tolerance(rk, out, args, **kw):
    """Per element: |out - plain| <= 2^-7 sum p|v| / l + 1e-4 (a tensor of
    booleans), the plain version on `args`; over int8 pools p|v| is over the
    dequantized V."""
    v = args[2]
    v_abs = (v[0].abs(), v[1]) if isinstance(v, tuple) else v.abs()
    ref = rk.ragged_attention_plain(*args, **kw)
    ref_abs = rk.ragged_attention_plain(*args[:2], v_abs, *args[3:], **kw)
    return (out - ref).abs() <= 2.0 ** -7 * ref_abs + 1e-4


def _ragged_calls(rk, monkeypatch, args, **kw):
    """The kernel (bf16, or int8 for (values, scales) pools) three times on
    `args`: twice, then with the split scratch poisoned with NaN; all three
    must be bit-identical (splits merge in split order, the arrival counters
    are back at 0, no merge reads a slot no split wrote). Returns the first
    output and the work list."""
    pool = args[1][0] if isinstance(args[1], tuple) else args[1]
    (T, Hq, _), Hk = args[0].shape, pool.shape[2]
    work = rk.ragged_work(*(a.cpu() for a in args[4:]), T, Hq // Hk, Hk, "cuda")
    scratch = rk.ragged_scratch

    def poisoned(*a):
        parts = scratch(*a)
        for x in parts:
            x.fill_(float("nan"))
        return parts

    got = rk.ragged_attention_cuda(*args, work=work, **kw)
    again = rk.ragged_attention_cuda(*args, work=work, **kw)
    with monkeypatch.context() as mp:
        mp.setattr(rk, "ragged_scratch", poisoned)
        bad = rk.ragged_attention_cuda(*args, work=work, **kw)
    assert torch.equal(got, again) and torch.equal(got, bad), kw
    return got, work


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_ragged_kernel_geometries(gen, monkeypatch, D, groups):
    """Decode singles from 1 to 4096 keys (split and unsplit), a 37-token
    range whose rows start mid-page (page boundaries fall inside query
    tiles), a 130-token range at KV length 500 (multi-tile), padding rows
    and empty ranges; and a stream of one 40-token range at KV length 1500,
    too few CTAs to fill the card, whose prefill tiles split. Every call
    three times, bit-identical, the last with NaN in the split scratch;
    the arrival counters back at 0."""
    from polykey_tpu_torch.ops import paged_attention_kernel as pak
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    Hk = 2
    streams = [([1, 1, 1, 1, 1, 1, 37, 130], [1, 8, 9, 300, 640, 4096, 57, 500]),
               ([40], [1500])]
    before = rk.KERNEL.launches
    for lens, kvs in streams:
        args, used = _ragged_case(gen, D, Hk * groups, Hk, lens, kvs, P=512)
        for kw in (dict(), dict(logit_softcap=30.0, window=50), dict(window=200)):
            out, work = _ragged_calls(rk, monkeypatch, args, scale=D ** -0.5, **kw)
            assert torch.isfinite(out).all(), kw
            ok = _ragged_within_tolerance(rk, out, args, scale=D ** -0.5, **kw)
            assert ok.all(), kw
            assert (out[used:] == 0).all(), kw
            assert (pak.arrival_counters(0, "cuda") == 0).all(), kw
        items = work.items.cpu()
        if len(lens) > 2:           # the 4096-key single splits
            assert (items[items[:, 0] == 5][:, 4] == -(-4096 // rk.SPLIT_ROWS)).all()
        else:                       # so do the lone range's prefill tiles
            assert (items[:, 4] > 1).any() and (items[:, 2] > 1).all()
    assert rk.KERNEL.launches == before + 3 * 3 * len(streams)


def test_ragged_kernel_counters_survive_growth(gen, monkeypatch):
    """On a stream of its own (so a counter buffer of its own): a small
    call, a larger one that outgrows the counter buffer, and the small call
    again. The two small calls are bit-identical, the large one within its
    tolerance, the outgrown buffer still held, and every counter back at 0."""
    _counters_survive_growth(gen, _ragged_case)


def test_ragged_int8_kernel_counters_survive_growth(gen):
    """test_ragged_kernel_counters_survive_growth over int8 pools."""
    _counters_survive_growth(gen, _ragged_int8_case)


def _counters_survive_growth(gen, case):
    from polykey_tpu_torch.ops import paged_attention_kernel as pak
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    small, _ = case(gen, 128, 8, 2, [1, 1], [700, 30], P=160)
    large, _ = case(gen, 128, 8, 2, [1] * 40, [1100] * 40, P=160, empty=0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = rk.ragged_attention_cuda(*small, scale=128 ** -0.5)
        buf = pak.arrival_counters(0, "cuda")
        big = rk.ragged_attention_cuda(*large, scale=128 ** -0.5)
        grown = pak.arrival_counters(0, "cuda")
        again = rk.ragged_attention_cuda(*small, scale=128 ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert grown is not buf and grown.numel() >= 40 * 2 > buf.numel()
    assert any(x is buf for held in pak._ARRIVALS.values() for x in held)
    assert (buf == 0).all() and (grown == 0).all()
    assert torch.equal(first, again)
    assert _ragged_within_tolerance(rk, big, large, scale=128 ** -0.5).all()


def test_ragged_tolerance_catches_a_swapped_page(gen):
    """The kernel given a table in which one page of the 300-key single is
    another sequence's page, against the plain version on the true table:
    the per-element tolerance must fail, so it would catch a dropped page."""
    _swapped_page(gen, _ragged_case)


def test_ragged_int8_tolerance_catches_a_swapped_page(gen):
    """test_ragged_tolerance_catches_a_swapped_page over int8 pools: the
    int8 tolerance must fail on the swapped page too."""
    _swapped_page(gen, _ragged_int8_case)


def _swapped_page(gen, case):
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    args, _ = case(gen, 128, 8, 2, [1, 1, 1, 37], [9, 300, 640, 57])
    tables = args[3].clone()
    tables[1, 5] = args[3][2, 0]
    out = rk.ragged_attention_cuda(*args[:3], tables, *args[4:], scale=128 ** -0.5)
    ok = _ragged_within_tolerance(rk, out, args, scale=128 ** -0.5)
    assert torch.isfinite(out).all()
    assert ok[0].all() and ok[2:].all() and not ok[1].all()


def test_ragged_kernel_launch_count_and_refusals(gen):
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    args, _ = _ragged_case(gen, 64, 6, 2, [1, 5], [9, 5])
    with pytest.raises(ValueError, match="Hq / Hk"):
        rk.ragged_attention_cuda(*args, scale=0.1)
    args, _ = _ragged_case(gen, 64, 4, 2, [1, 5], [9, 5])
    with pytest.raises(ValueError, match="must be"):
        rk.ragged_attention_cuda(args[0].float(), *args[1:], scale=0.1)
    before = rk.KERNEL.launches
    rk.ragged_paged_attention(*args, scale=0.1)
    assert rk.KERNEL.launches == before + 1


def _int8_pools(gen, N, ps, Hk, D):
    """int8 values and bf16 scales as the quantizing write stores them."""
    from polykey_tpu_torch.ops.paged_attention import quantize_kv_rows

    pairs = [quantize_kv_rows(_randn((N, ps, Hk, D), gen) * 3) for _ in range(2)]
    return pairs[0], pairs[1]


_CTX = [1, 7, 8, 9, 100, 255, 256, 257, 640]
# (D, groups, Hk, ps, P, contexts): every head dim and group at Hk = 2 and
# pages of 8; the serve geometry (Hq 32, Hk 8, D 128, pages of 16, P 256)
# at ring-stage (256 rows) and split (1024 rows) boundaries; a batch whose
# sequences mostly hold one row (most splits empty); Hk 3 and 5 with pages
# of 8 and 16 (scale blocks of ps x Hk x 2 bytes, not a multiple of 16),
# split and unsplit; G = 8 at D = 256, the register-heaviest instance, at
# its stage (128 rows) and split boundaries.
_INT8_DECODE = [(D, g, 2, 8, 80, _CTX) for D in (64, 128, 256) for g in (1, 2, 4, 8)] + [
    (128, 4, 8, 16, 256, [255, 256, 257, 511, 512, 513, 1023, 1024, 1025, 2049, 4096]),
    (128, 4, 8, 16, 256, [1] * 12 + [2, 17, 1100, 4096]),
    (64, 2, 3, 8, 80, _CTX),
    (128, 1, 3, 16, 128, [1, 15, 16, 17, 300, 1025, 2000]),
    (64, 4, 5, 16, 40, [1, 15, 16, 17, 300, 640]),
    (128, 2, 5, 8, 300, [1, 7, 8, 9, 1023, 1024, 1025, 2400]),
    (256, 8, 2, 16, 256, [1, 127, 128, 129, 1023, 1024, 1025, 3000]),
]


def _poisoned(split_scratch):
    """`split_scratch` with every per-split buffer filled with NaN."""
    def scratch(*args, **kwargs):
        parts = split_scratch(*args, **kwargs)
        for t in parts:
            t.fill_(float("nan"))
        return parts
    return scratch


def _int8_decode_inputs(gen, D, groups, Hk, ps, P, ctx):
    """(q, k pair, v pair, tables, positions) over int8 pools, each sequence
    on pages of its own; the unwritten rows of each last page hold 127 in
    K and NaN in both scales."""
    B, Hq = len(ctx), Hk * groups
    pages = [-(-n // ps) for n in ctx]
    N = sum(pages) + 1
    (kq, ks), (vq, vs) = _int8_pools(gen, N, ps, Hk, D)
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    nxt = 1
    for b, n in enumerate(pages):
        tables[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
        tail = ctx[b] - (n - 1) * ps
        kq[nxt - 1, tail:] = 127
        ks[nxt - 1, tail:] = float("nan")
        vs[nxt - 1, tail:] = float("nan")
    q = _randn((B, Hq, D), gen)
    pos = torch.tensor([n - 1 for n in ctx], dtype=torch.int32, device="cuda")
    return q, (kq, ks), (vq, vs), tables, pos


def _check_decode(pak, got, args, **kw):
    """`got` (acc, m, l) against the plain version: finite, within
    decode_error_bound per element and 2e-3 flat, m within 1e-3."""
    want = pak.paged_decode_plain(*args, **kw)
    out = got[0] / torch.clamp(got[2], min=1e-9)
    ref = want[0] / torch.clamp(want[2], min=1e-9)
    assert torch.isfinite(out).all(), kw
    assert ((out - ref).abs() <= pak.decode_error_bound(*args, **kw)).all(), kw
    assert (out - ref).abs().max().item() <= 2e-3, kw
    assert (got[1] - want[1]).abs().max().item() <= 1e-3, kw


# The int8 list's serve geometries over bf16 pools, at the bf16 instance's
# stage (128 rows at D = 128, 64 at D = 256, 256 at D = 64) and split
# boundaries; a batch whose sequences mostly hold one row.
_BF16_DECODE = [
    (128, 4, 8, 16, 256, [127, 128, 129, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025,
                          2049, 4096]),
    (128, 4, 8, 16, 256, [1] * 12 + [2, 17, 1100, 4096]),
    (64, 2, 8, 16, 256, [1, 255, 256, 257, 1023, 1024, 1025, 4096]),
    (256, 8, 2, 16, 256, [1, 63, 64, 65, 511, 512, 513, 1023, 1024, 1025, 3000]),
]


@pytest.mark.parametrize("D,groups,Hk,ps,P,ctx", _BF16_DECODE)
def test_decode_kernel_serve_geometries(gen, monkeypatch, D, groups, Hk, ps, P, ctx):
    """test_decode_kernel_geometries at the serve geometry (Hq 32, Hk 8, D
    128, pages of 16, P 256) and its neighbours."""
    _decode_repeat_and_poison(gen, monkeypatch, _bf16_decode_inputs,
                              D, groups, Hk, ps, P, ctx)


@pytest.mark.parametrize("D,groups,Hk,ps,P,ctx", _INT8_DECODE)
def test_decode_int8_kernel_geometries(gen, monkeypatch, D, groups, Hk, ps, P, ctx):
    """The int8 decode kernel over contexts split and unsplit, soft-cap,
    window and a page range; NaN in the values AND the scales of every
    unwritten row of each sequence's last page. Each call is repeated and
    must give bit-identical (acc, m, l) (splits merge in split order, the
    arrival counters are back at 0), and again with the split scratch
    poisoned with NaN (no split without rows is read)."""
    _decode_repeat_and_poison(gen, monkeypatch, _int8_decode_inputs,
                              D, groups, Hk, ps, P, ctx)


def test_decode_counters_survive_growth(gen):
    """On a stream of its own (so a counter buffer of its own): a small
    bf16 call, a larger batch that outgrows the buffer, and the small call
    again. The two small calls are bit-identical, the large one is within
    its bound, the outgrown buffer is still held (a graph that captured it
    would still point at live memory), and every counter is back at 0."""
    _decode_counters_survive_growth(gen, _bf16_decode_inputs)


def test_decode_int8_counters_survive_growth(gen):
    """test_decode_counters_survive_growth over int8 pools."""
    _decode_counters_survive_growth(gen, _int8_decode_inputs)


def _decode_counters_survive_growth(gen, inputs):
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    small = inputs(gen, 128, 4, 8, 16, 256, [300, 1100, 2100])
    large = inputs(gen, 128, 4, 8, 16, 256, [1100] * 40 + [4096])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = pak.paged_decode_cuda(*small, scale=128 ** -0.5)
        buf = pak.arrival_counters(0, "cuda")
        big = pak.paged_decode_cuda(*large, scale=128 ** -0.5)
        grown = pak.arrival_counters(0, "cuda")
        again = pak.paged_decode_cuda(*small, scale=128 ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    assert grown is not buf and grown.numel() >= 41 * 8 > buf.numel()
    assert any(t is buf for held in pak._ARRIVALS.values() for t in held)
    assert (buf == 0).all() and (grown == 0).all()
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    _check_decode(pak, big, large, scale=128 ** -0.5)


@pytest.mark.parametrize("Hk,D", [(1, 64), (2, 128), (3, 64), (5, 256), (8, 128),
                                  (2, 48)])
def test_write_int8_kernel_is_exact(gen, Hk, D):
    """The quantizing write against quantize_kv_rows + index writes, bit for
    bit, for kv-head counts below 8 (scale rows of Hk x 2 bytes, no whole
    number of 16-byte vectors) and above, and a head dim off the vector path
    (48: not a multiple of 32 lanes x 2 values); an inactive lane, a
    negative position, and all-zero and tie-heavy rows."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    N, ps, B, P = 40, 8, 7, 5
    (kq, ks), (vq, vs) = _int8_pools(gen, N, ps, Hk, D)
    kn, vn = _randn((B, 1, Hk, D), gen), _randn((B, 1, Hk, D), gen)
    kn[1] = 0.0                                          # absmax floor 1e-8
    vn[2] = torch.round(vn[2] * 4) / 4                   # many exact halves
    vn[2, 0, :, 0] = 31.75                               # scale 0.25 exactly
    tables = torch.arange(1, 1 + B * P, dtype=torch.int32, device="cuda").reshape(B, P)
    tables[5] = 0
    pos = torch.tensor([[0], [7], [8], [39], [12], [0], [-3]], dtype=torch.int32,
                       device="cuda")
    a = (kq.clone(), ks.clone()), (vq.clone(), vs.clone())
    b = (kq.clone(), ks.clone()), (vq.clone(), vs.clone())
    pw.paged_write_int8_cuda(*a, kn, vn, tables, pos)
    pw.paged_write_int8_plain(*b, kn, vn, tables, pos)
    for x, y in zip((*a[0], *a[1]), (*b[0], *b[1])):
        assert torch.equal(x[1:].view(torch.int8), y[1:].view(torch.int8))


def _leaves(pools):
    return [t for p in pools for t in (p if isinstance(p, tuple) else (p,))]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_write_kernels_at_stream_size(gen, int8):
    """Both write instances over a 300-row ragged stream ([T, 1] rows, each
    active row to its own slot) whose last 40 rows are padding: all-zero
    table rows at position 0, all writing slot 0 of the garbage page 0.
    Exact against the plain version on every page but page 0; one launch a
    call."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    N, ps, Hk, D, P, T, pad = 400, 16, 8, 128, 64, 300, 40
    slots = torch.randperm((N - 1) * ps, generator=gen, device="cuda")[:T]
    pidx = torch.randint(0, P, (T,), generator=gen, device="cuda")
    pos = (pidx * ps + slots % ps).to(torch.int32)
    tables = torch.zeros((T, P), dtype=torch.int32, device="cuda")
    tables[torch.arange(T, device="cuda"), pidx] = (1 + slots // ps).to(torch.int32)
    tables[T - pad:] = 0
    pos[T - pad:] = 0
    kn, vn = _randn((T, 1, Hk, D), gen), _randn((T, 1, Hk, D), gen)
    if int8:
        pools = _int8_pools(gen, N, ps, Hk, D)
        a = tuple((v.clone(), s.clone()) for v, s in pools)
        b = tuple((v.clone(), s.clone()) for v, s in pools)
        kernel, plain, count = pw.paged_write_int8_cuda, pw.paged_write_int8_plain, pw.KERNEL_INT8
    else:
        pools = _randn((N, ps, Hk, D), gen), _randn((N, ps, Hk, D), gen)
        a = tuple(p.clone() for p in pools)
        b = tuple(p.clone() for p in pools)
        kernel, plain, count = pw.paged_write_decode_cuda, pw.paged_write_decode_plain, pw.KERNEL
    before = count.launches
    kernel(*a, kn, vn, tables, pos[:, None])
    assert count.launches == before + 1
    plain(*b, kn, vn, tables, pos[:, None])
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x[1:].view(torch.int8), y[1:].view(torch.int8))


def test_write_int8_kernel_keeps_a_nan_scale(gen):
    """One NaN in one head of a K row and of a V row: that (row, head)'s
    written scale is NaN and its dequantized values all NaN, in the kernel
    and in the plain version alike (the reference's jnp.max keeps NaN too).
    The int8 bytes of such a head have no defined value in either package,
    so they and the NaN scales (whose NaN bits may differ) are blanked
    before every other head and row is compared byte for byte."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw
    from polykey_tpu_torch.ops.paged_attention import dequantize_kv

    N, ps, Hk, D, B, P = 40, 8, 4, 128, 7, 5
    (kq, ks), (vq, vs) = _int8_pools(gen, N, ps, Hk, D)
    kn, vn = _randn((B, 1, Hk, D), gen), _randn((B, 1, Hk, D), gen)
    kn[3, 0, 2, 77] = float("nan")
    vn[4, 0, 0, 5] = float("nan")
    tables = torch.arange(1, 1 + B * P, dtype=torch.int32, device="cuda").reshape(B, P)
    pos = torch.tensor([[0], [7], [8], [39], [12], [20], [33]], dtype=torch.int32,
                       device="cuda")
    a = (kq.clone(), ks.clone()), (vq.clone(), vs.clone())
    b = (kq.clone(), ks.clone()), (vq.clone(), vs.clone())
    pw.paged_write_int8_cuda(*a, kn, vn, tables, pos)
    pw.paged_write_int8_plain(*b, kn, vn, tables, pos)
    page_ids, offsets = pw._slots(tables, pos, ps)
    for pools in (a, b):
        for (values, scales), (row, head) in zip(pools, ((3, 2), (4, 0))):
            at = page_ids[row], offsets[row]
            assert torch.isnan(scales[at][head])
            assert torch.isnan(dequantize_kv(values[at], scales[at], torch.float32)[head]).all()
            assert not torch.isnan(scales[at][torch.arange(Hk, device="cuda") != head]).any()
            values[at[0], at[1], head] = 0
            scales[at[0], at[1], head] = 0
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x[1:].view(torch.int8), y[1:].view(torch.int8))


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_ragged_int8_kernel_geometries(gen, monkeypatch, D, groups):
    """The int8 ragged kernel on the bf16 kernel's two streams (decode
    singles split and unsplit, ranges whose rows start mid-page, a
    multi-tile range, padding rows and empty ranges; a lone 40-token range
    at KV 1500 whose prefill tiles split), with 127 in the stale K values
    and NaN in the stale scales. Every call three times, bit-identical, the
    last with NaN in the split scratch; tolerance over the dequantized V,
    padding rows exactly 0, the arrival counters back at 0."""
    from polykey_tpu_torch.ops import paged_attention_kernel as pak
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    Hk = 2
    streams = [([1, 1, 1, 1, 1, 1, 37, 130], [1, 8, 9, 300, 640, 4096, 57, 500]),
               ([40], [1500])]
    before = rk.KERNEL_INT8.launches
    for lens, kvs in streams:
        args, used = _ragged_int8_case(gen, D, Hk * groups, Hk, lens, kvs, P=512)
        for kw in (dict(), dict(logit_softcap=30.0, window=50), dict(window=200)):
            out, work = _ragged_calls(rk, monkeypatch, args, scale=D ** -0.5, **kw)
            assert torch.isfinite(out).all(), kw
            ok = _ragged_within_tolerance(rk, out, args, scale=D ** -0.5, **kw)
            assert ok.all(), kw
            assert (out[used:] == 0).all(), kw
            assert (pak.arrival_counters(0, "cuda") == 0).all(), kw
        items = work.items.cpu()
        if len(lens) > 2:           # the 4096-key single splits
            assert (items[items[:, 0] == 5][:, 4] == -(-4096 // rk.SPLIT_ROWS)).all()
        else:                       # so do the lone range's prefill tiles
            assert (items[:, 4] > 1).any() and (items[:, 2] > 1).all()
    assert rk.KERNEL_INT8.launches == before + 3 * 3 * len(streams)


@pytest.mark.parametrize("Hk,groups,ps", [(1, 4, 16), (3, 2, 8), (5, 1, 16)])
def test_ragged_int8_kernel_odd_kv_heads(gen, monkeypatch, Hk, groups, ps):
    """Scale rows of Hk x 2 bytes that are not a whole number of 4-byte
    words (odd Hk): each scale comes as the aligned word that holds it, and
    its half is picked by row. Singles split and unsplit and a prefill
    range, repeated bit for bit, within tolerance."""
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    args, used = _ragged_int8_case(gen, 128, Hk * groups, Hk, [1, 1, 1, 45],
                                   [7, 333, 1300, 90], ps=ps, P=256)
    for kw in (dict(), dict(window=100)):
        out, _ = _ragged_calls(rk, monkeypatch, args, scale=128 ** -0.5, **kw)
        assert torch.isfinite(out).all(), kw
        assert _ragged_within_tolerance(rk, out, args, scale=128 ** -0.5, **kw).all(), kw
        assert (out[used:] == 0).all(), kw


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(gen):
    from polykey_tpu_torch.ops import paged_attention_kernel as pak
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    (kq, ks), (vq, vs) = _int8_pools(gen, 4, 8, 2, 64)
    qd = _randn((2, 4, 64), gen)
    tables = torch.ones((2, 3), dtype=torch.int32, device="cuda")
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="must be"):
        pak.paged_decode_cuda(qd, (kq.float(), ks), (vq, vs), tables, pos, scale=0.1)
    with pytest.raises(ValueError, match="scales"):
        pak.paged_decode_cuda(qd, (kq, ks[:, :4]), (vq, vs), tables, pos, scale=0.1)
    with pytest.raises(ValueError, match="pairs"):
        pak.paged_decode_cuda(qd, (kq, ks), vq, tables, pos, scale=0.1)
    rows = _randn((2, 1, 2, 64), gen)
    with pytest.raises(ValueError, match="must be"):
        pw.paged_write_int8_cuda((kq, ks), (vq, vs), rows.float(), rows, tables,
                                 pos[:, None])
    # The int8 ragged kernel: int8 values, and scales on a 4-byte boundary
    # (each is copied as the aligned word that holds it).
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    args, _ = _ragged_int8_case(gen, 64, 4, 2, [1, 5], [9, 5])
    (kq, ks), (vq, vs) = args[1], args[2]
    with pytest.raises(ValueError, match="must be"):
        rk.ragged_attention_cuda(args[0], (kq.float(), ks), (vq, vs), *args[3:], scale=0.1)
    odd = torch.empty(ks.numel() + 1, dtype=ks.dtype, device="cuda")[1:].view(ks.shape)
    odd.copy_(ks)
    with pytest.raises(ValueError, match="4-byte aligned"):
        rk.ragged_attention_cuda(args[0], (kq, odd), (vq, vs), *args[3:], scale=0.1)


# -- the decode block as CUDA graphs (engine/graphs.py) -----------------------

_LANES = ("last_tokens", "seq_lens", "page_tables", "active", "caps", "seeds",
          "temperature", "top_p", "top_k")


def _graph_parts(gen, int8, pages=64, P=16):
    """A 2-layer model at head_dim 64 (2 query heads per kv head, so both
    decode kernels take it), bf16 weights, pools of `pages` pages of 16 rows
    (int8 values with bf16 scales for `int8`), and 4 idle lanes with tables
    of P pages."""
    from dataclasses import replace

    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.transformer import init_params

    cfg = replace(get_config("tiny-llama"), hidden_size=256, intermediate_size=512,
                  head_dim=64)
    params = init_params(cfg, torch.bfloat16, "cuda", gen)
    paged = init_paged_kv(cfg, pages, 16, torch.bfloat16, "cuda",
                          kv_dtype=torch.int8 if int8 else None)
    B = 4
    i32 = dict(dtype=torch.int32, device="cuda")
    state = dict(
        last_tokens=torch.zeros(B, **i32), seq_lens=torch.zeros(B, **i32),
        page_tables=torch.zeros((B, P), **i32),
        active=torch.zeros(B, dtype=torch.bool, device="cuda"),
        caps=torch.zeros(B, **i32), seeds=torch.zeros((B, 2), **i32),
        temperature=torch.zeros(B, device="cuda"), top_p=torch.ones(B, device="cuda"),
        top_k=torch.zeros(B, **i32),
    )
    return cfg, params, paged, state


def _capture(cfg, params, paged, state, eos_id=2):
    """CudaGraphs over the parts, the decode block captured for steps 8 and 1
    while every lane is idle, as the engine captures."""
    from polykey_tpu_torch.engine.engine import _decode_fn
    from polykey_tpu_torch.engine.graphs import CudaGraphs

    def body(greedy, steps):
        return _decode_fn(params, cfg, paged, *(state[k] for k in _LANES),
                          greedy=greedy, steps=steps, eos_id=eos_id)

    graphs = CudaGraphs(torch.device("cuda"), {"decode": (
        body, [(g, k) for g in (True, False) for k in (8, 1)])})
    with torch.inference_mode():
        graphs.capture()
    return graphs


def _fill_pools(gen, paged):
    """Random KV in every pool (int8 values with small positive scales)."""
    for t in (paged.k, paged.v):
        if paged.quantized:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device="cuda",
                                  dtype=torch.int32).to(torch.int8))
        else:
            t.copy_(_randn(t.shape, gen))
    for t in (paged.ks, paged.vs):
        if t is not None:
            t.copy_((torch.rand(t.shape, generator=gen, device="cuda") * 0.02
                     + 1e-3).to(torch.bfloat16))


def _fill_lanes(gen, paged, state, sampled):
    """Random KV in every pool; lanes 0-2 live at contexts 5, 40 and 100 on
    pages of their own (lane 3 idle on the garbage page); sampled lanes at
    temperatures 0.8 and 1.0 with top-p and top-k, one greedy."""
    _fill_pools(gen, paged)
    P = state["page_tables"].shape[1]
    for b, n in enumerate((5, 40, 100)):
        state["page_tables"][b] = torch.arange(1 + P * b, 1 + P * (b + 1))
        state["seq_lens"][b] = n
    state["last_tokens"][:3] = torch.randint(3, 500, (3,), generator=gen, device="cuda",
                                             dtype=torch.int32)
    state["active"][:3] = True
    state["caps"][:3] = 200
    state["seeds"].copy_(torch.randint(0, 1 << 30, (4, 2), generator=gen, device="cuda",
                                       dtype=torch.int32))
    if sampled:
        state["temperature"][:3] = torch.tensor([0.8, 1.0, 0.0])
        state["top_p"][0] = 0.9
        state["top_k"][0] = 20


def _pools(paged):
    return [t for t in (paged.k, paged.v, paged.ks, paged.vs) if t is not None]


def _eager_and_replay(cfg, params, paged, state, graphs, greedy, steps, eos_id=2):
    """The eager `_decode_fn` on copies of the lane state and the pools, then
    a replay on the live ones; returns (eager packed, replay packed, eager
    lane state, eager pools)."""
    from polykey_tpu_torch.engine.engine import _decode_fn
    from polykey_tpu_torch.engine.kv_cache import PagedKV

    with torch.inference_mode():
        ref = {k: t.clone() for k, t in state.items()}
        ref_paged = PagedKV(*(t.clone() if t is not None else None
                              for t in (paged.k, paged.v, paged.ks, paged.vs)))
        want = _decode_fn(params, cfg, ref_paged, *(ref[k] for k in _LANES),
                          greedy=greedy, steps=steps, eos_id=eos_id)
        got = graphs.run("decode", greedy, steps).clone()
    torch.cuda.synchronize()
    return want, got, ref, ref_paged


@pytest.mark.parametrize("steps", [8, 1])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_graph_replay_matches_eager(gen, int8, greedy, steps):
    """Captured while every lane is idle, a replay from live lanes gives
    the eager block's packed tokens, final lane state and pools, bit for
    bit; the capture's warm-up wrote only the garbage page."""
    cfg, params, paged, state = _graph_parts(gen, int8)
    graphs = _capture(cfg, params, paged, state)
    assert graphs.captures["decode"] == 4 and graphs.pool_bytes >= 0
    assert all(not t[:, 1:].any() for t in _pools(paged)), "warm-up wrote past page 0"
    assert not state["active"].any() and not state["seq_lens"].any()
    _fill_lanes(gen, paged, state, sampled=not greedy)
    want, got, ref, ref_paged = _eager_and_replay(cfg, params, paged, state, graphs,
                                                  greedy, steps)
    assert got.shape == (steps, 4) and (got[:, :3] >= 0).any()
    assert torch.equal(got, want) and (got[:, 3] == -1).all()
    for k in _LANES:
        assert torch.equal(state[k], ref[k]), k
    for a, b in zip(_pools(paged), _pools(ref_paged)):
        assert torch.equal(a, b)
    assert graphs.replays["decode"] == 1


def test_decode_graph_serves_a_lane_merged_in_place(gen):
    """A lane merged by `_merge_lane_fn` after the capture (in place, as the
    engine merges) is served by the next replay as by the eager block."""
    from polykey_tpu_torch.engine.engine import _merge_lane_fn

    cfg, params, paged, state = _graph_parts(gen, False)
    graphs = _capture(cfg, params, paged, state)
    _fill_lanes(gen, paged, state, sampled=False)
    ptrs = {k: t.data_ptr() for k, t in state.items()}
    with torch.inference_mode():
        first = torch.tensor([0, 321], dtype=torch.int32, device="cuda")
        table = torch.zeros(16, dtype=torch.int32, device="cuda")
        table[:15] = torch.arange(49, 64)
        _merge_lane_fn(state, 3, first, 1, 30, 200, 0.0, 1.0, 0, table,
                       torch.tensor([5, 6], dtype=torch.int32, device="cuda"), eos_id=2)
    want, got, ref, _ = _eager_and_replay(cfg, params, paged, state, graphs, True, 8)
    assert {k: t.data_ptr() for k, t in state.items()} == ptrs
    assert got[0, 3].item() >= 0 and torch.equal(got, want)
    for k in _LANES:
        assert torch.equal(state[k], ref[k]), k


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_graph_counts_launches_and_resets_the_counters(gen, int8):
    """Capture and warm-up count no launch; each replay adds the launches its
    capture made (one decode and one write kernel a layer a step); every
    arrival counter reads 0 after replays."""
    from polykey_tpu_torch.ops import paged_attention_kernel as pak
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    decode = pak.KERNEL_INT8 if int8 else pak.KERNEL
    write = pw.KERNEL_INT8 if int8 else pw.KERNEL
    cfg, params, paged, state = _graph_parts(gen, int8)
    before = (decode.launches, write.launches)
    graphs = _capture(cfg, params, paged, state)
    assert (decode.launches, write.launches) == before
    _fill_lanes(gen, paged, state, sampled=True)
    L = cfg.num_layers
    with torch.inference_mode():
        for greedy, steps in ((True, 8), (False, 1), (False, 8), (True, 1)):
            n0, w0 = decode.launches, write.launches
            graphs.run("decode", greedy, steps)
            assert decode.launches - n0 == L * steps
            assert write.launches - w0 == L * steps
    torch.cuda.synchronize()
    assert graphs.replays["decode"] == 4
    for held in pak._ARRIVALS.values():
        for buf in held:
            assert not buf.any()


# -- the prefill as CUDA graphs (engine/graphs.py, engine.PrefillOperands) ----

def _prefill_graphs(cfg, params, paged, state, keys):
    """CudaGraphs over the parts as the engine builds them: the decode block
    (steps 8) and the prefill over fixed operand buffers per group pad,
    captured into one pool with every buffer zeroed (every table on the
    garbage page). Returns (graphs, operands by group pad)."""
    from polykey_tpu_torch.engine.engine import PrefillOperands, _decode_fn, _prefill_fn
    from polykey_tpu_torch.engine.graphs import CudaGraphs

    P = state["page_tables"].shape[1]
    ops = {n: PrefillOperands(n, max(k[0] for k in keys), P, "cuda")
           for n in {k[1] for k in keys}}

    def decode(greedy, steps):
        return _decode_fn(params, cfg, paged, *(state[k] for k in _LANES),
                          greedy=greedy, steps=steps, eos_id=2)

    def prefill(width, n_pad, greedy, aligned):
        return _prefill_fn(params, cfg, paged, *ops[n_pad].views(width),
                           greedy=greedy, aligned=aligned)[0]

    graphs = CudaGraphs(torch.device("cuda"), {
        "decode": (decode, [(True, 8)]), "prefill": (prefill, keys)})
    with torch.inference_mode():
        graphs.capture()
    return graphs, ops


def _prefill_rows(gen, ops, width, start, greedy, first_page=1):
    """Fill `ops` (group pad n) with n random prompts of `width` tokens at
    `start`, each on consecutive pages of its own from `first_page`;
    sampled rows (not `greedy`) at temperatures 0.8 / 1.0 with top-p and
    top-k, the last row greedy."""
    import numpy as np

    n, (P,) = ops.n, ops.views(width)[3].shape[1:]
    need = -(-(start + width) // 16)
    tables = np.zeros((n, P), np.int32)
    tables[:, :need] = first_page + np.arange(n * need).reshape(n, need)
    rng = np.random.default_rng(width * 10 + n)
    temp = np.zeros(n, np.float32)
    top_p, top_k = np.ones(n, np.float32), np.zeros(n, np.int32)
    if not greedy:
        temp[:-1] = np.resize([0.8, 1.0], n - 1)
        top_p[0], top_k[0] = 0.9, 20
    ops.upload(rng.integers(3, 500, (n, width)).astype(np.int32),
               np.full(n, start, np.int32), rng.integers(0, width, n).astype(np.int32),
               tables, rng.integers(0, 1 << 30, (n, 2)).astype(np.int32), temp, top_p, top_k)


def _eager_prefill_and_replay(cfg, params, paged, graphs, ops, key):
    """The eager `_prefill_fn` on copies of the pools, then the replay of
    `key` on the live ones; returns (eager tokens, replayed tokens, eager
    pools)."""
    from polykey_tpu_torch.engine.engine import _prefill_fn
    from polykey_tpu_torch.engine.kv_cache import PagedKV

    width, n, greedy, aligned = key
    with torch.inference_mode():
        ref_paged = PagedKV(*(t.clone() if t is not None else None
                              for t in (paged.k, paged.v, paged.ks, paged.vs)))
        want = _prefill_fn(params, cfg, ref_paged, *ops[n].views(width), greedy=greedy,
                           aligned=aligned)[0]
        got = graphs.run("prefill", *key).clone()
    torch.cuda.synchronize()
    return want, got, ref_paged


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_prefill_graph_replay_matches_eager_at_every_key(gen, int8):
    """Every key of buckets (128,) and chunk 256 (widths 128 at group pads
    1, 2, 4, 8 and 256 alone; greedy and sampled): captured over zeroed
    operands (the warm-up writes only the garbage page), each replay gives
    the eager prefill's tokens and pools bit for bit; each replay adds one
    flash launch a layer and capture adds none."""
    from polykey_tpu_torch.engine.engine import prefill_graph_keys
    from polykey_tpu_torch.ops import flash_attention as fa

    cfg, params, paged, state = _graph_parts(gen, int8, pages=80)
    keys = prefill_graph_keys((128,), 256, 16)
    assert len(keys) == 10 and all(k[3] for k in keys)
    before = fa.KERNEL.launches
    graphs, ops = _prefill_graphs(cfg, params, paged, state, keys)
    assert fa.KERNEL.launches == before
    assert graphs.captures["prefill"] == 10 and graphs.pool_bytes >= 0
    assert all(not t[:, 1:].any() for t in _pools(paged)), "warm-up wrote past page 0"
    _fill_pools(gen, paged)
    for key in keys:
        width, n, greedy, _ = key
        _prefill_rows(gen, ops[n], width, 0, greedy)
        n0 = fa.KERNEL.launches
        want, got, ref_paged = _eager_prefill_and_replay(cfg, params, paged, graphs, ops, key)
        assert fa.KERNEL.launches - n0 == 2 * cfg.num_layers, key   # eager + replay
        assert got.shape == (n,) and torch.equal(got, want), key
        for a, b in zip(_pools(paged), _pools(ref_paged)):
            assert torch.equal(a, b), key
    assert graphs.replays["prefill"] == 10 and graphs.eager["prefill"] == 0


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_prefill_chunk_at_an_offset_replays_its_width(gen, int8):
    """A chunk at offset 512 (the third and fourth pages' worth of a
    1024-position table) replays the (512, 1) graph, captured from position
    0 on the garbage page: positions are operands. Tokens and pools as
    eager, for a greedy and a sampled chunk."""
    from polykey_tpu_torch.engine.engine import prefill_graph_keys

    cfg, params, paged, state = _graph_parts(gen, int8, pages=80, P=64)
    keys = [k for k in prefill_graph_keys((128, 512), 512, 16) if k[1] == 1]
    graphs, ops = _prefill_graphs(cfg, params, paged, state, keys)
    _fill_pools(gen, paged)
    for greedy in (True, False):
        _prefill_rows(gen, ops[1], 512, 512, greedy)
        key = (512, 1, greedy, True)
        want, got, ref_paged = _eager_prefill_and_replay(cfg, params, paged, graphs, ops, key)
        assert torch.equal(got, want), greedy
        for a, b in zip(_pools(paged), _pools(ref_paged)):
            assert torch.equal(a, b), greedy


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_prefill_output_survives_a_decode_replay(gen, int8):
    """The engine's order: replay prefill (128, 1), merge its token into a
    lane and start its copy to host memory, replay a decode block (same
    pool), then read the copy: it is the eager prefill's token, the lane
    holds it, and the block served the merged lane as the eager block
    does."""
    from polykey_tpu_torch.engine.engine import (
        InferenceEngine,
        _decode_fn,
        _merge_lane_fn,
        _prefill_fn,
        prefill_graph_keys,
    )
    from polykey_tpu_torch.engine.kv_cache import PagedKV

    cfg, params, paged, state = _graph_parts(gen, int8, pages=80)
    keys = prefill_graph_keys((128,), 128, 16)
    graphs, ops = _prefill_graphs(cfg, params, paged, state, keys)
    _fill_lanes(gen, paged, state, sampled=False)
    _prefill_rows(gen, ops[1], 128, 0, True, first_page=64)
    _, _, _, tables, seeds, *_ = ops[1].views(128)
    with torch.inference_mode():
        ref = {k: t.clone() for k, t in state.items()}
        ref_paged = PagedKV(*(t.clone() if t is not None else None
                              for t in (paged.k, paged.v, paged.ks, paged.vs)))
        want_tok = _prefill_fn(params, cfg, ref_paged, *ops[1].views(128), greedy=True,
                               aligned=True)[0]
        _merge_lane_fn(ref, 3, want_tok, 0, 129, 200, 0.0, 1.0, 0, tables[0], seeds[0],
                       eos_id=2)
        want_packed = _decode_fn(params, cfg, ref_paged, *(ref[k] for k in _LANES),
                                 greedy=True, steps=8, eos_id=2)
        tok = graphs.run("prefill", 128, 1, True, True)
        _merge_lane_fn(state, 3, tok, 0, 129, 200, 0.0, 1.0, 0, tables[0], seeds[0],
                       eos_id=2)
        host, event = InferenceEngine._copy_to_host(tok)
        packed = graphs.run("decode", True, 8).clone()
    event.synchronize()
    torch.cuda.synchronize()
    assert host.tolist() == want_tok.tolist()
    assert torch.equal(packed, want_packed) and (packed[:, 3] >= 0).any()
    for k in _LANES:
        assert torch.equal(state[k], ref[k]), k


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_kernel_takes_a_work_list_from_short_lengths(gen, int8):
    """The engine builds the ragged work list from the host's lengths while
    blocks are in flight: the kernel, given a list built from decode
    lengths 16 to 64 keys short (split counts change at 530 and 1040 keys),
    stays within its tolerance of the plain version on the true lengths."""
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    lens = [1, 1, 1, 1, 1, 1, 37]
    kvs = [70, 300, 530, 1040, 2000, 4096, 57]
    case = _ragged_int8_case if int8 else _ragged_case
    args, used = case(gen, 128, 16, 2, lens, kvs, P=512)
    T = args[0].shape[0]
    true = args[6].cpu()
    short = true.clone()
    for s, d in zip(range(6), (16, 32, 48, 64, 16, 32)):
        short[s] = max(1, int(true[s]) - d)
    work = rk.ragged_work(args[4].cpu(), args[5].cpu(), short, T, 8, 2, "cuda")
    exact = rk.ragged_work(args[4].cpu(), args[5].cpu(), true, T, 8, 2, "cuda")
    assert work.n_part != exact.n_part, "no split count changed"
    out = rk.ragged_attention_cuda(*args, work=work, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out[:used]).all()
    ok = _ragged_within_tolerance(rk, out, args, scale=128 ** -0.5)
    assert ok.all()
    assert (out[used:] == 0).all()
