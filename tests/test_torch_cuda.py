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


def _graph_parts(gen, int8, pages=64, P=16, model="tiny-llama", bits=None):
    """A 2-layer model at head_dim 64 (2 query heads per kv head, so both
    decode kernels take it), bf16 weights (int8 or int4 with `bits`), pools
    of `pages` pages of 16 rows (int8 values with bf16 scales for `int8`),
    and 4 idle lanes with tables of P pages. `model="tiny-mixtral"` makes
    each MLP a MoE of 8 experts, top-2, with the capacity-bucketed
    dispatch."""
    from dataclasses import replace

    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.transformer import init_params

    cfg = replace(get_config(model), hidden_size=256, intermediate_size=512,
                  head_dim=64)
    if cfg.is_moe:
        cfg = replace(cfg, num_experts=8, moe_dispatch=True)
    params = init_params(cfg, torch.bfloat16, "cuda", gen, quantize_bits=bits)
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
def test_resume_import_behind_a_replay_is_served_as_eager(gen, int8):
    """The decode tier's import (`import_handoff`): a live lane's pages,
    gathered to host memory and through the KV wire format, are copied into
    fresh pages and an idle lane is spliced at seq_len = prompt_len + 1, in
    place, right behind a replay still in flight and with no sync between.
    The imported pages equal the shipped ones, and the next replay serves
    the resumed lane as the eager block does, bit for bit."""
    import numpy as np

    from polykey_tpu_torch.engine.engine import gather_to_host, import_handoff
    from polykey_tpu_torch.engine.kv_cache import (
        KVHandoffState,
        deserialize_kv_state,
        serialize_kv_state,
    )

    cfg, params, paged, state = _graph_parts(gen, int8)
    graphs = _capture(cfg, params, paged, state)
    _fill_lanes(gen, paged, state, sampled=False)
    src = state["page_tables"][1, :3].tolist()        # lane 1: 40 positions
    k, v, *scales = gather_to_host(paged, src)
    blob = serialize_kv_state(KVHandoffState(
        model=cfg.name, page_size=16, prompt_len=40, first_token=321, seed=(5 << 32) | 6,
        prompt_ids=torch.arange(40, dtype=torch.int32), k=k, v=v,
        ks=scales[0] if scales else None, vs=scales[1] if scales else None))
    shipped = deserialize_kv_state(blob)
    dst = list(range(49, 64))
    table = np.zeros(16, np.int32)
    table[:15] = dst
    ptrs = {k: t.data_ptr() for k, t in state.items()}
    with torch.inference_mode():
        graphs.run("decode", True, 8)                 # in flight; lane 3 idle
        import_handoff(paged, state, 3, shipped, dst, table,
                       np.array([5, 6], np.int32), 200, 0.0, 1.0, 0, eos_id=2)
    torch.cuda.synchronize()
    for pool, sent in zip(_pools(paged), shipped.pools):
        assert torch.equal(pool[:, dst[:3]].cpu(), sent)
    assert state["seq_lens"][3].item() == 41 and state["last_tokens"][3].item() == 321
    assert bool(state["active"][3]) and state["caps"][3].item() == 200
    want, got, ref, ref_paged = _eager_and_replay(cfg, params, paged, state, graphs, True, 8)
    assert {k: t.data_ptr() for k, t in state.items()} == ptrs
    assert (got[:, 3] >= 0).all() and torch.equal(got, want)
    for k in _LANES:
        assert torch.equal(state[k], ref[k]), k
    for a, b in zip(_pools(paged), _pools(ref_paged)):
        assert torch.equal(a, b)


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
    assert graphs.replays["prefill"] == 10 and graphs.eager_calls("prefill") == 0


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


# -- the prefix cache and the host-KV tier on the card -------------------------

def _spill_and_restore(paged, src, dst, host_pool):
    """The engine's page movers end to end, in `_spill_batch`'s and
    `_restore_slot_pages`' order: gather `src` to pinned memory, write each
    page into the host pool, then restore them into `dst` from a fresh
    pinned staging buffer, without a sync."""
    from polykey_tpu_torch.engine.engine import gather_to_host, restore_from_host

    hosts = gather_to_host(paged, src)
    for r in range(len(src)):
        host_pool.write(r, *(h[:, r] for h in hosts), *([None] * (4 - len(hosts))))
    restore_from_host(paged, host_pool, list(range(len(src))), dst)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_kv_gather_restore_round_trip_is_bit_exact(gen, int8):
    """Pages gathered to the host tier and restored into other device pages
    equal the originals bit for bit (int8: values and scales), the pools
    keep their addresses, and no other page changes."""
    from polykey_tpu_torch.engine.kv_cache import HostKVPool

    cfg, _, paged, _ = _graph_parts(gen, int8)
    _fill_pools(gen, paged)
    ptrs = [t.data_ptr() for t in _pools(paged)]
    before = [t.clone() for t in _pools(paged)]
    host = HostKVPool(cfg, 4, 16, torch.bfloat16, int8, pin=True)
    src, dst = [3, 7, 11, 12], [40, 41, 50, 2]
    _spill_and_restore(paged, src, dst, host)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in _pools(paged)] == ptrs
    keep = [p for p in range(paged.num_pages) if p not in dst]
    for t, b in zip(_pools(paged), before):
        assert torch.equal(t[:, dst], b[:, src])
        assert torch.equal(t[:, keep], b[:, keep])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_restore_ahead_of_a_prefill_replay_is_read_by_it(gen, int8):
    """A cached prefix's pages are spilled, overwritten on the device, and
    restored just before the suffix's prefill graph replays, with no sync in
    between: stream order makes the replay read the restored pages, so its
    token and pools equal the eager prefill's over the original pages."""
    from polykey_tpu_torch.engine.engine import _prefill_fn, prefill_graph_keys
    from polykey_tpu_torch.engine.kv_cache import HostKVPool, PagedKV

    cfg, params, paged, state = _graph_parts(gen, int8, pages=80)
    keys = [k for k in prefill_graph_keys((128,), 128, 16) if k[1] == 1]
    graphs, ops = _prefill_graphs(cfg, params, paged, state, keys)
    _fill_pools(gen, paged)
    _prefill_rows(gen, ops[1], 128, 128, True)        # 8 cached pages, then the suffix
    prefix = list(range(1, 9))
    with torch.inference_mode():
        ref_paged = PagedKV(*(t.clone() if t is not None else None
                              for t in (paged.k, paged.v, paged.ks, paged.vs)))
        want = _prefill_fn(params, cfg, ref_paged, *ops[1].views(128), greedy=True,
                           aligned=True)[0]
        host = HostKVPool(cfg, len(prefix), 16, torch.bfloat16, int8, pin=True)
        # Spill the prefix out of spare pages holding its copy, clobber the
        # table's pages, then restore and replay back to back.
        spare = list(range(60, 68))
        for t in _pools(paged):
            t[:, spare] = t[:, prefix]
            t[:, prefix] = 0
        ptrs = [t.data_ptr() for t in _pools(paged)]
        _spill_and_restore(paged, spare, prefix, host)
        got = graphs.run("prefill", 128, 1, True, True).clone()
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in _pools(paged)] == ptrs
    assert torch.equal(got, want)
    for a, b in zip(_pools(paged), _pools(ref_paged)):
        assert torch.equal(a[:, :60], b[:, :60])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_prefix_hit_suffix_replay_matches_eager(gen, int8):
    """Two suffixes sharing cached pages, at page-aligned offsets 128 and 64
    in one (128, 2) replay: tokens and pools as the eager body's, and the
    shared pages untouched (a hit only reads them)."""
    import numpy as np

    from polykey_tpu_torch.engine.engine import prefill_graph_keys

    cfg, params, paged, state = _graph_parts(gen, int8, pages=80)
    keys = [k for k in prefill_graph_keys((128,), 128, 16) if k[1] == 2]
    graphs, ops = _prefill_graphs(cfg, params, paged, state, keys)
    _fill_pools(gen, paged)
    rng = np.random.default_rng(1)
    tables = np.zeros((2, 16), np.int32)
    tables[0, :16] = np.arange(1, 17)                        # 8 shared + 8 own
    tables[1, :12] = np.r_[np.arange(1, 5), np.arange(30, 38)]  # 4 shared + 8 own
    ops[2].upload(rng.integers(3, 500, (2, 128)).astype(np.int32),
                  np.array([128, 64], np.int32), np.array([100, 127], np.int32), tables,
                  rng.integers(0, 1 << 30, (2, 2)).astype(np.int32),
                  np.zeros(2, np.float32), np.ones(2, np.float32), np.zeros(2, np.int32))
    shared = [t[:, 1:9].clone() for t in _pools(paged)]
    want, got, ref_paged = _eager_prefill_and_replay(cfg, params, paged, graphs, ops,
                                                     (128, 2, True, True))
    assert torch.equal(got, want)
    for a, b, s in zip(_pools(paged), _pools(ref_paged), shared):
        assert torch.equal(a, b)
        assert torch.equal(a[:, 1:9], s)                     # read, never written


def test_engine_prefix_cache_and_host_tier_on_the_card(gen, monkeypatch):
    """A 2-layer, head_dim 64 engine on the card with the prefix cache and a
    host tier small enough that sticky sessions spill at retire and fault
    back: its greedy streams equal the uncached engine's on the same
    weights, every prefill is a graph replay, pages were restored, and the
    pools kept their addresses through the restores."""
    from dataclasses import replace

    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
    from polykey_tpu_torch.models import config as model_config

    cfg = replace(model_config.get_config("tiny-llama"), name="tiny-llama-d64",
                  hidden_size=256, intermediate_size=512, head_dim=64)
    monkeypatch.setitem(model_config.MODEL_REGISTRY, cfg.name, cfg)
    fields = dict(model=cfg.name, max_decode_slots=4, page_size=16, num_pages=40,
                  max_seq_len=256, prefill_buckets=(32, 64), max_new_tokens_cap=16)
    sessions = [f"session {i} " + "header text " * 8 for i in range(4)]
    mix = sessions + [sessions[0], sessions[2], sessions[1], sessions[3]]

    def serve(engine):
        out = []
        for p in mix:
            r = GenRequest(prompt=p, max_new_tokens=12)
            engine.submit(r)
            toks = []
            while True:
                kind, value = r.out.get(timeout=120)
                assert kind != "error", value
                if kind == "done":
                    break
                toks.append(value)
            out.append(toks)
        return out

    cold = InferenceEngine(EngineConfig(**fields), device="cuda", seed=3)
    try:
        want = serve(cold)
    finally:
        cold.shutdown()
    eng = InferenceEngine(EngineConfig(**fields, prefix_cache=True, host_kv_bytes=16 << 20,
                                       host_kv_resident_pages=20), device="cuda", seed=3)
    try:
        ptrs = [t.data_ptr() for t in eng.paged.pools]
        got = serve(eng)
        stats = eng.stats()
        assert [t.data_ptr() for t in eng.paged.pools] == ptrs
    finally:
        eng.shutdown()
    assert got == want
    assert stats["kv_pages_evicted"] > 0 and stats["kv_pages_restored"] > 0
    assert stats["prefix_hit_tokens"] + stats["prefix_host_hit_tokens"] > 0
    assert stats["prefill_graph_replays"] > 0 and stats["prefill_eager"] == 0


# -- the speculative round as CUDA graphs (engine/spec_decode.py) ------------

_SPEC_LANES = _LANES + ("accept_ewma", "gamma_lane")


def _spec_parts(gen, int8):
    """`_graph_parts`' target with a 1-layer draft of the same vocabulary
    (head_dim 64, its own pools under the same tables), and the lanes'
    dials at gamma 4 with an EWMA of 1."""
    from dataclasses import replace

    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.transformer import init_params

    cfg, params, paged, state = _graph_parts(gen, int8)
    d_cfg = replace(cfg, name="tiny-draft", num_layers=1)
    d_params = init_params(d_cfg, torch.bfloat16, "cuda", gen)
    d_paged = init_paged_kv(d_cfg, paged.k.shape[1], 16, torch.bfloat16, "cuda",
                            kv_dtype=torch.int8 if int8 else None)
    B = state["active"].shape[0]
    state["accept_ewma"] = torch.ones(B, device="cuda")
    state["gamma_lane"] = torch.full((B,), 4, dtype=torch.int32, device="cuda")
    return cfg, params, paged, d_cfg, d_params, d_paged, state


def _spec_body(cfg, params, paged, d_cfg, d_params, d_paged, state):
    from polykey_tpu_torch.engine.spec_decode import spec_decode_fn

    def body(gamma, greedy, cand):
        return spec_decode_fn(params, d_params, cfg, d_cfg, paged, d_paged,
                              *(state[k] for k in _SPEC_LANES), gamma=gamma, eos_id=2,
                              gamma_low=2, gamma_max=4, candidates=cand, greedy=greedy)
    return body


def _clone_paged(paged):
    from polykey_tpu_torch.engine.kv_cache import PagedKV

    return PagedKV(*(t.clone() if t is not None else None
                     for t in (paged.k, paged.v, paged.ks, paged.vs)))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_spec_round_replay_matches_eager_at_every_key(gen, int8):
    """Captured while every lane is idle (the warm-up writes only the
    garbage page), each (gamma, greedy, candidates) key's replay from live
    lanes gives the eager round's packed matrix, lane state (dial and EWMA
    included) and both models' pools, bit for bit."""
    from polykey_tpu_torch.engine.engine import spec_graph_keys
    from polykey_tpu_torch.engine.graphs import CudaGraphs

    cfg, params, paged, d_cfg, d_params, d_paged, state = _spec_parts(gen, int8)
    keys = spec_graph_keys((2, 4), 32)
    assert len(keys) == 6
    graphs = CudaGraphs(torch.device("cuda"), {"spec": (
        _spec_body(cfg, params, paged, d_cfg, d_params, d_paged, state), keys)})
    with torch.inference_mode():
        graphs.capture()
    assert graphs.captures["spec"] == 6
    assert all(not t[:, 1:].any() for t in _pools(paged) + _pools(d_paged))
    for gamma, greedy, cand in keys:
        _fill_lanes(gen, paged, state, sampled=not greedy)
        _fill_pools(gen, d_paged)
        state["gamma_lane"].copy_(torch.tensor([4, 2, 3, 4]))
        with torch.inference_mode():
            ref = {k: t.clone() for k, t in state.items()}
            ref_t, ref_d = _clone_paged(paged), _clone_paged(d_paged)
            want = _spec_body(cfg, params, ref_t, d_cfg, d_params, ref_d, ref)(
                gamma, greedy, cand)
            got = graphs.run("spec", gamma, greedy, cand).clone()
        torch.cuda.synchronize()
        assert got.shape == (4, gamma + 1 + 4)
        assert torch.equal(got, want), (gamma, greedy, cand)
        assert (got[:3, 0] >= 0).all() and (got[3, :gamma + 1] == -1).all()
        for k in _SPEC_LANES:
            assert torch.equal(state[k], ref[k]), (k, gamma, greedy, cand)
        for a, b in zip(_pools(paged) + _pools(d_paged), _pools(ref_t) + _pools(ref_d)):
            assert torch.equal(a, b)
    assert graphs.replays["spec"] == 6


@pytest.mark.parametrize("gamma", [2, 4])
def test_spec_greedy_key_equals_sampled_key_on_a_greedy_batch(gen, gamma):
    """On an all-greedy batch the greedy key (no distributions, no draws)
    and the sampled key give the same packed matrix, lane state and pools."""
    from polykey_tpu_torch.engine.graphs import CudaGraphs

    cfg, params, paged, d_cfg, d_params, d_paged, state = _spec_parts(gen, False)
    graphs = CudaGraphs(torch.device("cuda"), {"spec": (
        _spec_body(cfg, params, paged, d_cfg, d_params, d_paged, state),
        [(gamma, True, 0), (gamma, False, 0)])})
    with torch.inference_mode():
        graphs.capture()
    _fill_lanes(gen, paged, state, sampled=False)
    _fill_pools(gen, d_paged)
    start = {k: t.clone() for k, t in state.items()}
    pools = [t.clone() for t in _pools(paged) + _pools(d_paged)]
    outs = []
    for greedy in (True, False):
        with torch.inference_mode():
            for k, t in start.items():
                state[k].copy_(t)
            for t, p in zip(_pools(paged) + _pools(d_paged), pools):
                t.copy_(p)
            packed = graphs.run("spec", gamma, greedy, 0).clone()
        torch.cuda.synchronize()
        outs.append((packed, {k: t.clone() for k, t in state.items()},
                     [t.clone() for t in _pools(paged) + _pools(d_paged)]))
    (pa, sa, qa), (pb, sb, qb) = outs
    assert torch.equal(pa, pb)
    for k in _SPEC_LANES:
        assert torch.equal(sa[k], sb[k]), k
    for a, b in zip(qa, qb):
        assert torch.equal(a, b)


# -- MoE layers and quantized weights ------------------------------------------

@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "int8", "int4"])
def test_moe_dispatch_decode_graph_replay_matches_eager(gen, bits):
    """A 2-layer MoE model (8 experts, top-2, the capacity-bucketed
    dispatch: 4 lanes give a capacity of 1 a expert, so pairs drop) with
    bf16, int8 or int4 weights: captured while every lane is idle, a
    replay of each decode key from live lanes gives the eager block's
    packed tokens, lane state and pools, bit for bit."""
    cfg, params, paged, state = _graph_parts(gen, False, model="tiny-mixtral", bits=bits)
    graphs = _capture(cfg, params, paged, state)
    _fill_lanes(gen, paged, state, sampled=True)
    start = {k: t.clone() for k, t in state.items()}
    pools = [t.clone() for t in _pools(paged)]
    for greedy, steps in ((True, 8), (False, 8), (True, 1)):
        for k, t in start.items():
            state[k].copy_(t)
        for t, p in zip(_pools(paged), pools):
            t.copy_(p)
        want, got, ref, ref_paged = _eager_and_replay(cfg, params, paged, state, graphs,
                                                      greedy, steps)
        assert torch.equal(got, want), (greedy, steps)
        for k in _LANES:
            assert torch.equal(state[k], ref[k]), (k, greedy, steps)
        for a, b in zip(_pools(paged), _pools(ref_paged)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [None, 8], ids=["bf16", "int8"])
def test_moe_dispatch_layer_graph_replay_matches_eager(gen, bits):
    """The dispatch layer alone at mixtral-8x7b's routing (8 experts,
    top-2) on 4 x 128 rows whose router favours two experts (buckets
    overflow): a graph replay on new rows equals the eager layer bit for
    bit, and the scatter writes each kept slot once (no atomics)."""
    from dataclasses import replace

    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.quant import quantize
    from polykey_tpu_torch.ops import moe

    cfg = replace(get_config("mixtral-8x7b"), hidden_size=512, intermediate_size=1024)
    H, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    router = _randn((H, E), gen) * H ** -0.5
    router[:, :2] += 0.05
    experts = {"gate": _randn((E, H, I), gen) * H ** -0.5,
               "up": _randn((E, H, I), gen) * H ** -0.5,
               "down": _randn((E, I, H), gen) * I ** -0.5}
    if bits:
        experts = {k: quantize(v, bits=bits) for k, v in experts.items()}
    layer = {"router": router, "experts": experts}
    h = _randn((4, 128, H), gen)
    with torch.inference_mode():
        moe.moe_mlp_dispatch(layer, h, cfg)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = moe.moe_mlp_dispatch(layer, h, cfg)
        for _ in range(2):
            h.copy_(_randn(h.shape, gen))
            graph.replay()
            want = moe.moe_mlp_dispatch(layer, h, cfg)
            torch.cuda.synchronize()
            assert torch.equal(out, want)
        _, idx = moe._router_weights(layer, h.reshape(-1, H), cfg)
        capacity = int(4 * 128 * 2 / E * 1.25)
        _, keep = moe._dispatch_slots(idx, E, capacity)
    assert not keep.all(), "no bucket overflowed"


def _slice(cfg, params, gen, steps=4):
    """Prefill 2 prompts (bucket 128: 100 and 77 tokens) then `steps` forced
    decode steps through forward_paged: (sampled rows' logits, hidden)."""
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.transformer import forward_paged, unembed

    g = torch.Generator(device="cuda").manual_seed(5)
    B, T, lens = 2, 128, [100, 77]
    tokens = torch.randint(3, 259, (B, T), generator=g, device="cuda", dtype=torch.int32)
    forced = torch.randint(3, 259, (steps, B), generator=g, device="cuda",
                           dtype=torch.int32)
    per = -(-(T + steps) // 16)
    tables = torch.zeros((B, 256), dtype=torch.int32, device="cuda")
    for b in range(B):
        tables[b, :per] = torch.arange(1 + b * per, 1 + (b + 1) * per)
    paged = init_paged_kv(cfg, 1 + B * per, 16, torch.bfloat16, "cuda")
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    with torch.inference_mode():
        hidden, _ = forward_paged(params, cfg, tokens, pos, paged, tables)
        hiddens = [hidden.reshape(-1, hidden.shape[-1])]
        logits = [unembed(params, cfg, hidden[torch.arange(B), torch.tensor(lens) - 1])]
        for i in range(steps):
            p = torch.tensor([[n + i] for n in lens], dtype=torch.int32, device="cuda")
            hidden, _ = forward_paged(params, cfg, forced[i][:, None], p, paged, tables)
            hiddens.append(hidden[:, 0])
            logits.append(unembed(params, cfg, hidden[:, 0]))
    torch.cuda.synchronize()
    return torch.stack(logits), torch.cat(hiddens).float()


_PLAIN = ("POLYKEY_DISABLE_FLASH", "POLYKEY_DISABLE_PAGED_KERNEL",
          "POLYKEY_DISABLE_RAGGED_KERNEL", "POLYKEY_DISABLE_KV_KERNEL")


def test_mixtral_width_slice_kernels_match_plain(gen, monkeypatch):
    """mixtral-8x7b at its published widths, 2 layers, int8 weights drawn
    and quantized a layer at a time: the kernels' logits within 0.12 of
    the plain versions' with the same argmax on every row (chip_smoke.py's
    slice tolerance). Top-2 routing is a step function, so the plain run
    takes the kernel run's experts (weighted by its own router logits),
    and any token whose own choice differs must be a near-tie: its k-th
    logit within 0.12 of its logit for the least recorded expert
    (chip_smoke.py's _Routing)."""
    from dataclasses import replace

    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.transformer import init_params
    from polykey_tpu_torch.ops import moe

    cfg = replace(get_config("mixtral-8x7b"), num_layers=2)
    params = init_params(cfg, torch.bfloat16, "cuda", gen, quantize_bits=8)
    router, routes, margins = moe._router_weights, [], []

    def recording(layer_params, h, c):
        combine, idx = router(layer_params, h, c)
        routes.append(idx)
        return combine, idx

    def replaying(layer_params, h, c):
        idx = routes[len(margins)]
        logits = h.float() @ layer_params["router"].float()
        kth = logits.topk(c.num_experts_per_tok, dim=-1).values[..., -1]
        chosen = logits.gather(-1, idx)
        margins.append((kth - chosen.min(-1).values).max())
        return torch.zeros_like(logits).scatter_(-1, idx, torch.softmax(chosen, -1)), idx

    monkeypatch.setattr(moe, "_router_weights", recording)
    got, _ = _slice(cfg, params, gen)
    for name in _PLAIN:
        monkeypatch.setenv(name, "1")
    monkeypatch.setattr(moe, "_router_weights", replaying)
    want, _ = _slice(cfg, params, gen)
    assert len(margins) == len(routes) and max(m.item() for m in margins) <= 0.12
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 0.12
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("bits,gate", [(8, 0.05), (4, 0.35)])
def test_quantized_weights_track_bf16_under_the_reference_gates(gen, bits, gate):
    """llama-3-8b widths, 2 layers: int8 / int4 weights (quantized as the
    engine does) against the bf16 weights on the same tokens, through the
    kernels: the mean |dh| / max(|h|, 1) under the reference's gates
    (tests/test_quant.py: 0.05 int8, 0.35 int4)."""
    from dataclasses import replace

    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.quant import quantize_params
    from polykey_tpu_torch.models.transformer import init_params

    cfg = replace(get_config("llama-3-8b"), num_layers=2)
    params = init_params(cfg, torch.bfloat16, "cuda", gen)
    _, h_bf16 = _slice(cfg, params, gen)
    _, h_q = _slice(cfg, quantize_params(params, cfg, bits=bits), gen)
    assert torch.isfinite(h_q).all()
    rel = ((h_q - h_bf16).abs() / h_bf16.abs().clamp_min(1.0)).mean().item()
    assert rel < gate, rel


# Gemma-2's kernel geometries (chip_smoke.py's GEMMA_SHAPES): (Hq, Hk, D,
# query scale), soft-cap 50 and window 4096.
_GEMMA = [(32, 16, 128, 144.0 ** -0.5), (8, 4, 256, 256.0 ** -0.5)]


@pytest.mark.parametrize("Hq,Hk,D,scale", _GEMMA, ids=["gemma-2-27b", "gemma-2-2b"])
def test_gemma_geometry_kernels_match_plain(gen, Hq, Hk, D, scale):
    """At Gemma-2's geometry (group 2, its query scale, soft-cap 50, window
    4096): the bf16 decode kernel over contexts 1..4096 and 16 lanes at 512
    within decode_error_bound and 2e-3; flash at T=512, S=4096 within 2^-7
    (|ref| + sum p|v|) + 1e-4 per element; both paged writes at 16 lanes
    exact."""
    from polykey_tpu_torch.ops import flash_attention as fa
    from polykey_tpu_torch.ops import paged_attention_kernel as pak
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    kw = dict(scale=scale, logit_softcap=50.0, window=4096)
    for ctx in ([1, 15, 16, 17, 255, 256, 257, 1000, 2049, 4095, 4096], [512] * 16):
        args = _bf16_decode_inputs(gen, D, Hq // Hk, Hk, 16, 256, ctx)
        _check_decode(pak, pak.paged_decode_cuda(*args, **kw), args, **kw)

    B, T, S = 2, 512, 4096
    q, k, v = (_randn((B, T, Hq, D), gen), _randn((B, S, Hk, D), gen),
               _randn((B, S, Hk, D), gen))
    qpos = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    qpos[1] += 1000
    qpos[1, T - T // 4:] = -1
    out = fa.flash_attention_cuda(q, k, v, qpos, **kw)
    ref = fa.flash_attention_plain(q, k, v, qpos, **kw).float()
    ref_abs = fa.flash_attention_plain(q, k, v.abs(), qpos, **kw).float()
    assert torch.isfinite(out.float()).all()
    assert ((out.float() - ref).abs() <= 2.0 ** -7 * (ref.abs() + ref_abs) + 1e-4).all()

    N, P = 64, 256
    kn, vn = _randn((16, 1, Hk, D), gen), _randn((16, 1, Hk, D), gen)
    tables = torch.randperm(N - 1, generator=gen, device="cuda")[:16].to(torch.int32)
    tables = (tables + 1)[:, None].repeat(1, P)
    tables[13:] = 0                                       # inactive lanes
    pos = torch.randint(0, 16, (16, 1), generator=gen, device="cuda", dtype=torch.int32)
    kp, vp = _randn((N, 16, Hk, D), gen), _randn((N, 16, Hk, D), gen)
    a = pw.paged_write_decode_cuda(kp.clone(), vp.clone(), kn, vn, tables, pos)
    b = pw.paged_write_decode_plain(kp.clone(), vp.clone(), kn, vn, tables, pos)
    assert torch.equal(a[0][1:], b[0][1:]) and torch.equal(a[1][1:], b[1][1:])
    (kq, ks), (vq, vs) = _int8_pools(gen, N, 16, Hk, D)
    a8 = (kq.clone(), ks.clone()), (vq.clone(), vs.clone())
    b8 = (kq.clone(), ks.clone()), (vq.clone(), vs.clone())
    pw.paged_write_int8_cuda(*a8, kn, vn, tables, pos)
    pw.paged_write_int8_plain(*b8, kn, vn, tables, pos)
    for x, y in zip((*a8[0], *a8[1]), (*b8[0], *b8[1])):
        assert torch.equal(x[1:].view(torch.int8), y[1:].view(torch.int8))


@pytest.mark.parametrize("model", ["tiny-mixtral", "tiny-gemma"])
def test_a_bf16_checkpoint_loads_onto_the_card_as_on_the_cpu(gen, tmp_path, model):
    """A bf16 HF checkpoint (chip_smoke.py's writer: two shards and an
    index) read straight onto the card equals its read onto the CPU, and
    the tree written, bit for bit."""
    import chip_smoke
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.loader import load_checkpoint
    from polykey_tpu_torch.models.transformer import init_params

    cfg = get_config(model)
    params = init_params(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(4))
    chip_smoke.write_hf_checkpoint(params, cfg, str(tmp_path))
    on_card = load_checkpoint(str(tmp_path), cfg, torch.bfloat16, "cuda")
    on_cpu = load_checkpoint(str(tmp_path), cfg, torch.bfloat16, "cpu")

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            return all(same(a[k], b[k]) for k in b)
        if isinstance(b, list):
            return all(same(x, y) for x, y in zip(a, b)) and len(a) == len(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu().view(torch.int16), b.view(torch.int16)))

    assert on_card["embed"].device.type == "cuda"
    assert same(on_card, on_cpu) and same(on_cpu, params)


def test_graph_capture_holds_the_cycle_collector_off(gen):
    """A cycle collection during a capture may destroy the graphs of an
    engine dropped earlier, which invalidates the capture (an engine
    started after others were shut down crashed so on the card): the
    capture collects first, and no automatic collection runs while a
    stream captures, even with the collector's threshold at 1; the
    collector is on again after it."""
    import gc

    from polykey_tpu_torch.engine.graphs import CudaGraphs

    x = torch.ones(16, device="cuda")
    capturing = []

    def watch(phase, info):
        if phase == "start":
            capturing.append(torch.cuda.is_current_stream_capturing())

    def body(k):
        [[] for _ in range(100)]                # container allocations
        return x * k

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(watch)
    try:
        graphs = CudaGraphs(torch.device("cuda"), {"b": (body, [(1,), (2,)])})
        graphs.capture()
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*threshold)
    assert capturing and not any(capturing)
    assert gc.isenabled()
    assert torch.equal(graphs.run("b", 2), x * 2)


# -- the spec round on the ragged stream (engine/spec_decode.ragged_spec_fn) ----

@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_spec_dispatch_kernels_match_plain(gen, monkeypatch, int8):
    """One ragged spec dispatch at depth 2 (a 2-layer target and a 2-layer
    draft at head_dim 64): three live lanes' verify windows (gamma 4) and
    a 40-token prompt's final range, through the kernels (the draft's
    decode steps, both models' ragged attention and writes), then through
    the plain versions given the kernel run's drafts: the live lanes'
    window logits and the prompt's first-token logits within 0.12, and
    every row whose argmax differs a near-tie (the kernel run's choice
    within 0.12 of the top logit of the plain run, chip_smoke.py's rule);
    where no row a lane emits from differs, the packed rows and the first
    token are equal. Each model's ragged kernel launches once a layer.
    (The idle lane's window reads the garbage page, which its own rows and
    the stream's padding rows write in the same launch: its logits are
    garbage, and its packed row is -1.)"""
    from dataclasses import replace

    import numpy as np

    from polykey_tpu_torch.engine import spec_decode as sd
    from polykey_tpu_torch.engine.engine import ragged_zero_operands
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.transformer import init_params
    from polykey_tpu_torch.ops import paged_attention_kernel as pak
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    cfg, params, paged, state = _graph_parts(gen, int8)
    d_cfg = replace(cfg, name="tiny-draft", num_layers=2, hidden_size=128,
                    intermediate_size=256)
    d_params = init_params(d_cfg, torch.bfloat16, "cuda", gen)
    d_paged = init_paged_kv(d_cfg, paged.k.shape[1], 16, torch.bfloat16, "cuda",
                            kv_dtype=torch.int8 if int8 else None)
    _fill_lanes(gen, paged, state, sampled=False)
    _fill_pools(gen, d_paged)
    B, P, gamma = 4, state["page_tables"].shape[1], 4
    G1 = gamma + 1
    state["accept_ewma"] = torch.ones(B, device="cuda")
    state["gamma_lane"] = torch.full((B,), gamma, dtype=torch.int32, device="cuda")
    W = 44                                               # 4 x 5 + 44 = 64 rows
    pre = ragged_zero_operands(B, W, P)
    pre[0][:40] = np.random.default_rng(3).integers(3, 500, 40)
    pre[1][:40] = range(40)
    pre[2][:40] = 3
    pre[3][3, :3] = [49, 50, 51]
    pre[4][0], pre[5][0], pre[6][0], pre[7][0] = 0, 40, 40, 3
    pre[8][3], pre[9][3] = 39, 40
    starts = np.concatenate([np.arange(B) * G1, B * G1 + pre[4]])
    lens = np.concatenate([np.full(B, G1), pre[5]])
    kvs = np.concatenate([np.maximum(state["seq_lens"].cpu().numpy(), 1) + gamma, pre[6]])
    works = [rk.ragged_work(starts, lens, kvs, B * G1 + W, c.num_heads // c.num_kv_heads,
                            c.num_kv_heads, "cuda") for c in (cfg, d_cfg)]
    pre_dev = [torch.from_numpy(a).cuda() for a in pre]
    real_scan, real_unembed = sd._draft_scan, sd.unembed
    drafts, logits = [], []

    def recording_scan(*a, **k):
        out = real_scan(*a, **k)
        drafts.append(out)
        return out

    def recording_unembed(*a, **k):
        out = real_unembed(*a, **k)
        logits.append(out)
        return out

    def run():
        st = {k: t.clone() for k, t in state.items()}
        t_p, d_p = _clone_paged(paged), _clone_paged(d_paged)
        with torch.inference_mode():
            packed, first = sd.ragged_spec_fn(
                params, d_params, cfg, d_cfg, t_p, d_p, *(st[k] for k in _SPEC_LANES),
                *pre_dev, gamma=gamma, eos_id=2, greedy=True, t_work=works[0],
                d_work=works[1])
        torch.cuda.synchronize()
        return packed, first, logits[-2][:3].float(), logits[-1][3:].float()

    monkeypatch.setattr(sd, "_draft_scan", recording_scan)
    monkeypatch.setattr(sd, "unembed", recording_unembed)
    rag = rk.KERNEL_INT8 if int8 else rk.KERNEL
    dec = pak.KERNEL_INT8 if int8 else pak.KERNEL
    rag.launches = dec.launches = 0
    got = run()
    assert rag.launches == cfg.num_layers + d_cfg.num_layers
    assert dec.launches == gamma * d_cfg.num_layers
    for name in _PLAIN:
        monkeypatch.setenv(name, "1")
    monkeypatch.setattr(sd, "_draft_scan", lambda *a, **k: drafts[0])
    want = run()
    assert rag.launches == cfg.num_layers + d_cfg.num_layers
    flips = []
    for g, w in zip(got[2:], want[2:]):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 0.12
        choice = g.argmax(-1, keepdim=True)
        margin = w.max(-1, keepdim=True).values - w.gather(-1, choice)
        flip = choice != w.argmax(-1, keepdim=True)
        assert (margin[flip] <= 0.12).all()
        flips.append(flip[..., 0])
    # A lane emits from rows 0..n_acc of its window (n_acc: the accepted
    # count, the first stat column).
    n_acc = got[0][:3, G1].long()
    emits = torch.arange(G1, device="cuda")[None, :] <= n_acc[:, None]
    for b in range(3):
        if not (flips[0][b] & emits[b]).any():
            assert torch.equal(got[0][b], want[0][b])
    if not flips[1].any():
        assert torch.equal(got[1][3], want[1][3])
    assert (got[0][:3, 0] >= 0).all() and (got[0][3, :G1] == -1).all()


def test_cache_forward_flash_matches_plain(gen, monkeypatch):
    """`forward` over a contiguous cache at Llama-3-8B's widths, 2 layers:
    a right-padded prefill of 150- and 200-token prompts (window 200, cache
    512) launches flash once a layer; then 4 forced decode steps (the
    plain attention, T = 1). The last rows' logits against the plain run
    (POLYKEY_DISABLE_FLASH) within 0.12 with the same argmax on every row,
    and the cache the kernel run wrote within 0.12 of the plain run's."""
    from dataclasses import replace

    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.generate import decode_step, prefill
    from polykey_tpu_torch.models.transformer import init_cache, init_params
    from polykey_tpu_torch.ops import flash_attention

    cfg = replace(get_config("llama-3-8b"), num_layers=2)
    params = init_params(cfg, torch.bfloat16, "cuda", gen)
    g = torch.Generator(device="cuda").manual_seed(5)
    B, T, S, steps = 2, 200, 512, 4
    tokens = torch.randint(3, 259, (B, T), generator=g, device="cuda", dtype=torch.int32)
    tokens[0, 150:] = 0
    lens = torch.tensor([150, 200], dtype=torch.int32, device="cuda")
    forced = torch.randint(3, 259, (steps, B), generator=g, device="cuda",
                           dtype=torch.int32)

    def run():
        cache = init_cache(cfg, B, S, torch.bfloat16, "cuda")
        with torch.inference_mode():
            out, cache = prefill(params, cfg, tokens, lens, cache)
            rows = [out]
            for i in range(steps):
                out, cache = decode_step(params, cfg, forced[i], lens + i, cache)
                rows.append(out)
        torch.cuda.synchronize()
        return torch.stack(rows).float(), cache

    flash_attention.KERNEL.launches = 0
    got, got_cache = run()
    assert flash_attention.KERNEL.launches == cfg.num_layers
    monkeypatch.setenv("POLYKEY_DISABLE_FLASH", "1")
    want, want_cache = run()
    assert flash_attention.KERNEL.launches == cfg.num_layers
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 0.12
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    for a, b in ((got_cache.k, want_cache.k), (got_cache.v, want_cache.v)):
        assert (a.float() - b.float()).abs().max().item() <= 0.12


# -- the replica pool (engine/replica_pool.py) ---------------------------------

def test_replica_restart_beside_a_live_replica_keeps_both_streams(gen, monkeypatch):
    """Two replicas of a 2-layer, head_dim 64 model on one set of weights:
    replica 0 is stalled past its watchdog window and restarted by its
    supervisor (the fresh engine captures its graphs) while replica 1
    replays its decode graph for a paced 180-token stream. Replica 1's
    stream is bit-identical to its run without the restart, and the fresh
    replica 0's stream to its first engine's."""
    import time
    from dataclasses import replace

    from polykey_tpu_torch import faults
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import GenRequest
    from polykey_tpu_torch.engine.replica_pool import SERVING, ReplicaPool
    from polykey_tpu_torch.models import config as model_config

    cfg = replace(model_config.get_config("tiny-llama"), name="tiny-llama-d64",
                  hidden_size=256, intermediate_size=512, head_dim=64)
    monkeypatch.setitem(model_config.MODEL_REGISTRY, cfg.name, cfg)
    config = EngineConfig(model=cfg.name, max_decode_slots=4, page_size=16,
                          num_pages=64, max_seq_len=256, prefill_buckets=(32, 64),
                          max_new_tokens_cap=192, watchdog_timeout_s=1.0, replicas=2)
    prompts = ["the first replica's prompt", "the second replica's prompt"]

    def stream(engine, prompt, n):
        r = GenRequest(prompt=prompt, max_new_tokens=n)
        engine.submit(r)
        toks, first = [], None
        while True:
            kind, value = r.out.get(timeout=120)
            assert kind != "error", value
            if kind == "done":
                return toks, first, time.monotonic()
            first = first or time.monotonic()
            toks.append(value)

    faults.clear()
    pool = ReplicaPool.create(config, device="cuda", seed=5, watchdog_interval_s=0.05,
                              supervisor_interval_s=0.05)
    try:
        engines = [rep.engine for rep in pool.replicas]
        assert engines[0].params is engines[1].params
        want0 = stream(engines[0], prompts[0], 24)[0]
        want1 = stream(engines[1], prompts[1], 180)[0]
        injector = faults.install("slow-step=0.03:replica=1,step-stall=2.0@1:replica=0")
        for engine in engines:
            engine._faults = injector
        live: dict = {}

        import threading

        thread = threading.Thread(target=lambda: live.setdefault(
            "out", stream(engines[1], prompts[1], 180)))
        thread.start()
        replays0 = engines[1].stats()["decode_graph_replays"]
        victim = GenRequest(prompt=prompts[0], max_new_tokens=24)
        engines[0].submit(victim)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not (
                pool.replicas[0].supervisor.restarts == 1
                and pool.replicas[0].state == SERVING):
            time.sleep(0.01)
        thread.join(timeout=120)
        faults.clear()
        fresh = pool.replicas[0].engine
        assert fresh is not engines[0] and fresh.params is engines[1].params
        assert engines[0].paged is None
        toks1, first1, end1 = live["out"]
        c0, c1 = fresh._graphs.capture_window
        assert first1 < c0 and c1 < end1, "the capture did not overlap the live stream"
        assert engines[1].stats()["decode_graph_replays"] > replays0
        assert toks1 == want1
        fresh._faults = None
        assert stream(fresh, prompts[0], 24)[0] == want0
    finally:
        faults.clear()
        pool.shutdown()


# -- a mesh rank's shards (serving over a mesh, engine/lockstep.py) -----------

# (groups, Hk, D) of a tp rank's local heads: Llama-3-8B (Hq 32, Hk 8) at
# tp=2 and tp=4, Gemma-2-27B (Hq 32, Hk 16) at tp=2, D 128; the Llama-3.2-1B
# draft (Hq 32, Hk 8, D 64) at tp=2; pages of 16, P 256.
_SHARDS = {"llama-3-8b-tp2": (4, 4, 128), "llama-3-8b-tp4": (4, 2, 128),
           "gemma-2-27b-tp2": (2, 8, 128), "llama-3.2-1b-tp2": (4, 4, 64)}
_SHARD_CTX = [[512] * 16, [1, 15, 16, 17, 255, 256, 257, 1023, 1024, 1025, 2049, 4096]]


@pytest.mark.parametrize("ctx", _SHARD_CTX, ids=["16x512", "1-4096"])
@pytest.mark.parametrize("shard", list(_SHARDS))
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_kernels_at_shard_heads(gen, monkeypatch, int8, shard, ctx):
    """Both decode kernels at a tp rank's local heads, as
    test_decode_kernel_serve_geometries holds them."""
    groups, Hk, D = _SHARDS[shard]
    _decode_repeat_and_poison(gen, monkeypatch,
                              _int8_decode_inputs if int8 else _bf16_decode_inputs,
                              D, groups, Hk, 16, 256, ctx)


# (Hq, Hk) of a Llama-3-8B tp rank, and the ragged streams a mesh engine's
# dispatches carry: the serve case (16 singles at 512 keys, a first and a
# second 512-token chunk) and the spec stream (16 verify windows of 5 rows,
# their last keys over 5..4096, and the same two chunks).
_RAGGED_SHARDS = {"llama-3-8b-tp2": (16, 4), "llama-3-8b-tp4": (8, 2)}
_SPEC_KVS = [5, 15, 16, 17, 31, 33, 255, 256, 257, 1000, 1024, 2047, 2049, 3001, 4095, 4096]
_RAGGED_STREAMS = {
    "serve": ([1] * 16 + [512, 512], [512] * 16 + [512, 1024]),
    "spec": ([5] * 16 + [512, 512], _SPEC_KVS + [512, 1024]),
}


@pytest.mark.parametrize("stream", list(_RAGGED_STREAMS))
@pytest.mark.parametrize("shard", list(_RAGGED_SHARDS))
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_kernels_at_shard_heads(gen, monkeypatch, int8, shard, stream):
    """Both ragged kernels at a tp rank's local heads, the work list cut for
    those heads (as the mesh engine cuts it): three calls bit-identical,
    the last with NaN in the split scratch, within the per-element
    tolerance of the plain version, padding rows 0."""
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    Hq, Hk = _RAGGED_SHARDS[shard]
    lens, kvs = _RAGGED_STREAMS[stream]
    make = _ragged_int8_case if int8 else _ragged_case
    args, used = make(gen, 128, Hq, Hk, lens, kvs, ps=16, P=256)
    out, work = _ragged_calls(rk, monkeypatch, args, scale=128 ** -0.5)
    assert torch.isfinite(out).all()
    assert _ragged_within_tolerance(rk, out, args, scale=128 ** -0.5).all()
    assert (out[used:] == 0).all()
    assert work.items.shape[0] > 0


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_sp2_merge_matches_the_whole_range(gen, int8):
    """sp=2 decode: each half of the page table through the kernel
    (sp_page_range), the two states merged (merge_split_states) against
    the plain version over the whole range, within decode_error_bound and
    2e-3. Lanes of up to 128 pages leave the second half (pages 128..255)
    without rows."""
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    ctx = [1, 16, 17, 2047, 2048, 2049, 3000, 4096]
    inputs = _int8_decode_inputs if int8 else _bf16_decode_inputs
    args = inputs(gen, 128, 4, 4, 16, 256, ctx)
    parts = [pak.paged_decode_cuda(*args, scale=128 ** -0.5,
                                   page_range=pak.sp_page_range(256, 2, s)) for s in (0, 1)]
    assert (parts[1][2][:4] == 0).all() and (parts[1][1][:4] == -1e30).all()
    _check_decode(pak, pak.merge_split_states(parts), args, scale=128 ** -0.5)


@pytest.mark.parametrize("case", ["tp4-heads", "sp2-second-half"])
def test_flash_kernel_at_shard_shapes(gen, case):
    """Flash at Llama-3-8B tp=4's heads (Hq 8, Hk 2) over 512 tokens, and
    sp=2's second query block (rows 256..511 of a 512-token prefill)
    against the whole 512-row window; per element 2^-7 (|ref| + sum p|v|)
    + 1e-4 against the plain version."""
    from polykey_tpu_torch.ops import flash_attention as fa

    B, S, D = 2, 512, 128
    Hq, Hk = (8, 2) if case == "tp4-heads" else (32, 8)
    T = S if case == "tp4-heads" else S // 2
    q = _randn((B, T, Hq, D), gen)
    k, v = _randn((B, S, Hk, D), gen), _randn((B, S, Hk, D), gen)
    qpos = torch.arange(S - T, S, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    out = fa.flash_attention_cuda(q, k, v, qpos, scale=D ** -0.5)
    ref = fa.flash_attention_plain(q, k, v, qpos, scale=D ** -0.5).float()
    ref_abs = fa.flash_attention_plain(q, k, v.abs(), qpos, scale=D ** -0.5).float()
    err = (out.float() - ref).abs()
    assert (err <= 2.0 ** -7 * (ref.abs() + ref_abs) + 1e-4).all()


@pytest.mark.parametrize("Hk", [2, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_write_kernels_at_shard_heads(gen, int8, Hk):
    """Both writes at a Llama-3-8B tp rank's kv heads (4 at tp=2, 2 at
    tp=4): 16 lanes (a dp gather's whole batch) into pages of 16, exact
    against the plain version; one launch a call."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    N, ps, D, B, P = 300, 16, 128, 16, 256
    tables = torch.arange(1, 1 + B * 16, dtype=torch.int32, device="cuda").reshape(B, 16)
    tables = torch.nn.functional.pad(tables, (0, P - 16))
    pos = torch.randint(0, 16 * ps, (B, 1), generator=gen, device="cuda").to(torch.int32)
    kn, vn = _randn((B, 1, Hk, D), gen), _randn((B, 1, Hk, D), gen)
    if int8:
        pools = _int8_pools(gen, N, ps, Hk, D)
        a = tuple((x.clone(), s.clone()) for x, s in pools)
        b = tuple((x.clone(), s.clone()) for x, s in pools)
        kernel, plain, count = pw.paged_write_int8_cuda, pw.paged_write_int8_plain, pw.KERNEL_INT8
    else:
        pools = _randn((N, ps, Hk, D), gen), _randn((N, ps, Hk, D), gen)
        a = tuple(p.clone() for p in pools)
        b = tuple(p.clone() for p in pools)
        kernel, plain, count = pw.paged_write_decode_cuda, pw.paged_write_decode_plain, pw.KERNEL
    before = count.launches
    kernel(*a, kn, vn, tables, pos)
    assert count.launches == before + 1
    plain(*b, kn, vn, tables, pos)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x.view(torch.int8), y.view(torch.int8))


# -- the rest of serving over a mesh, on one card ------------------------------


def test_sliced_checkpoint_get_copies_its_part_alone_to_the_card(gen, tmp_path):
    """A run of rows and a range of columns of one bf16 tensor read onto the
    card: each equal to the CPU read's part, `copied` counts the part's
    bytes, and the card's allocated memory grows by the part alone."""
    import chip_smoke
    from polykey_tpu_torch.models import loader as tl
    from polykey_tpu_torch.models.config import get_config

    cfg = get_config("tiny-llama")
    rng = torch.Generator().manual_seed(1)
    params = {"embed": torch.randn(1024, 64, generator=rng).to(torch.bfloat16), "layers": [],
              "final_norm": torch.ones(64, dtype=torch.bfloat16),
              "lm_head": torch.randn(64, 1024, generator=rng).to(torch.bfloat16)}
    chip_smoke.write_hf_checkpoint(params, cfg, str(tmp_path), shards=1)
    (f,) = [tl.SafetensorsFile(p) for p in tl.checkpoint_files(str(tmp_path))]
    whole = f.get("model.embed_tokens.weight")
    for index in ([(256, 512), (0, 64)], [(0, 1024), (16, 32)]):
        torch.cuda.synchronize()
        before, copied = torch.cuda.memory_allocated(), f.copied
        part = f.get("model.embed_tokens.weight", "cuda", index)
        grown = torch.cuda.memory_allocated() - before
        (r0, nr), (c0, nc) = index
        assert part.device.type == "cuda" and part.is_contiguous()
        assert torch.equal(part.cpu().view(torch.int16),
                           whole[r0:r0 + nr, c0:c0 + nc].contiguous().view(torch.int16))
        assert f.copied - copied == nr * nc * 2
        assert grown == nr * nc * 2, (grown, nr * nc * 2)
        del part


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "int8", "int4"])
def test_shard_read_on_the_card_equals_the_whole_read_cut(gen, tmp_path, bits):
    """Each tp=2 rank's read of a checkpoint onto the card (the scale passes
    of its row-parallel leaves on the card, a chunk at a time) equals
    shard_params of the whole read onto the card, bit for bit."""
    from dataclasses import replace

    import numpy as np

    import chip_smoke
    from polykey_tpu_torch.models import loader as tl
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.quant import QuantizedTensor
    from polykey_tpu_torch.models.transformer import init_params
    from polykey_tpu_torch.parallel.mesh import Mesh
    from polykey_tpu_torch.parallel.sharding import shard_params

    cfg = replace(get_config("tiny-llama"), name="tiny-llama-wide", intermediate_size=512)
    params = init_params(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(5))
    chip_smoke.write_hf_checkpoint(params, cfg, str(tmp_path))
    whole = tl.load_checkpoint(str(tmp_path), cfg, torch.bfloat16, "cuda", quantize_bits=bits)

    def same(a, b):
        if isinstance(b, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in b)
        if isinstance(b, list):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(b, QuantizedTensor):
            return same(a.q, b.q) and same(a.s, b.s)
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)

    devices = np.arange(2).reshape(1, 1, 1, 1, 2)
    for rank in range(2):
        mesh = Mesh(devices, rank, torch.device("cuda"))
        got = tl.load_checkpoint(str(tmp_path), cfg, torch.bfloat16, "cuda",
                                 quantize_bits=bits, mesh=mesh)
        assert same(got, shard_params(whole, cfg, mesh)), rank


def test_gathered_moe_equals_the_rank_local_dispatch_on_one_rank(gen):
    """The capacity-bucketed layer through moe_mlp_sharded's whole-batch
    routing over a one-rank NCCL group (dp = sp = 1: nothing to gather)
    equals moe_mlp_dispatch on the same tokens, at a decode batch and a
    prefill's, in bf16 and int8 experts."""
    import torch.distributed as dist

    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.quant import quantize_params
    from polykey_tpu_torch.models.transformer import init_params
    from polykey_tpu_torch.ops.moe import moe_mlp_dispatch, moe_mlp_sharded
    from polykey_tpu_torch.parallel.mesh import single_device_mesh

    from dataclasses import replace

    cfg = replace(get_config("tiny-mixtral"), moe_dispatch=True)
    params = init_params(cfg, torch.bfloat16, "cuda", gen)
    mesh = single_device_mesh("cuda")
    try:
        for layer in (params["layers"][0], quantize_params(params, cfg, 8)["layers"][0]):
            for shape in ((16, 1), (2, 128)):
                h = _randn((*shape, cfg.hidden_size), gen)
                want = moe_mlp_dispatch(layer, h, cfg)
                got = moe_mlp_sharded(layer, h, cfg, mesh, (("dp", 0), ("sp", 1)))
                assert torch.equal(got, want), shape
    finally:
        dist.destroy_process_group()


# -- a serving mesh's lives over NCCL (engine/lockstep.py) ----------------------


def _nccl_life(mesh, gen) -> None:
    """The life's tp group warmed by an eager sum (which makes its
    communicator), then a sum captured in a CUDA graph and replayed on new
    input: over one rank, the input itself."""
    import torch.distributed as dist

    group = mesh.group("tp")
    assert group is not dist.group.WORLD and dist.get_backend(group) == "nccl"
    warm = torch.ones(8, device="cuda")
    dist.all_reduce(warm, group=group)
    torch.cuda.synchronize()
    assert torch.equal(warm, torch.ones(8, device="cuda"))
    x = torch.zeros(8, device="cuda")
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        dist.all_reduce(x, group=group)
        y = x * 2
    want = _randn((8,), gen, torch.float32)
    x.copy_(want)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want * 2)


def test_a_serving_mesh_life_over_nccl_is_aborted_and_remade(gen):
    """One rank's NCCL serving mesh: its life warmed and captured, then
    remade (lockstep.remake aborts its communicators and makes the next
    life's groups): a collective on the aborted group, issued from a
    thread as an orphan's first call after it wakes, raises within 30 s
    instead of hanging, and the next life, on new groups of the same
    geometry and key, warms, captures and replays like the first."""
    import threading

    import numpy as np
    import torch.distributed as dist

    from polykey_tpu_torch.engine import lockstep
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.parallel.mesh import single_device_mesh

    single_device_mesh("cuda")
    try:
        old = lockstep.serving_mesh(EngineConfig(), device="cuda")
        _nccl_life(old, gen)
        fresh = lockstep.remake(old)
        box = {}

        def orphan():
            try:
                dist.all_reduce(torch.ones(1, device="cuda"), group=old.group("tp"))
                torch.cuda.synchronize()
                box["got"] = "returned"
            except Exception as e:
                box["got"] = type(e).__name__

        thread = threading.Thread(target=orphan, daemon=True)
        thread.start()
        thread.join(30)
        assert not thread.is_alive() and box["got"] != "returned", box
        assert fresh.life == old.life + 1 and fresh.key == old.key
        assert np.array_equal(fresh.devices, old.devices) and fresh.device == old.device
        assert fresh.group("tp") is not old.group("tp")
        assert fresh.control is not old.control and fresh.pages is not old.pages
        _nccl_life(fresh, gen)
    finally:
        dist.destroy_process_group()
