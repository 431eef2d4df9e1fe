"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu` and skipped where there is no CUDA device. On a machine with
the card (which need not have JAX, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py checks the kernels at the Llama-3-8B shapes of the main
path; these cover the other geometries each kernel is instantiated for
(head dims 64/128/256, 1/2/4/8 query heads per kv head, small pages,
partial tiles) and the wrappers' refusals. Tolerances as in chip_smoke.py:
decode 2e-3 on the normalized fp32 output (fp32 sums in another order),
flash per element 2^-7 (|ref| + sum p|v|) + 1e-4 (bf16 probabilities and
output rounded once on each side), the write exact.
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
def test_decode_kernel_geometries(gen, D, groups):
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    Hk, ps, P = 2, 8, 80
    ctx = [1, 7, 8, 9, 100, 255, 256, 257, 640]
    B, Hq = len(ctx), Hk * groups
    pages = [-(-n // ps) for n in ctx]
    N = sum(pages) + 1
    kp, vp = _randn((N, ps, Hk, D), gen), _randn((N, ps, Hk, D), gen)
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    nxt = 1
    for b, n in enumerate(pages):
        tables[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
        vp[nxt - 1, ctx[b] - (n - 1) * ps:] = float("nan")     # stale tail
    q = _randn((B, Hq, D), gen)
    pos = torch.tensor([n - 1 for n in ctx], dtype=torch.int32, device="cuda")
    for kw in (dict(), dict(logit_softcap=30.0, window=50),
               dict(page_range=(3, 40))):
        got = pak.paged_decode_cuda(q, kp, vp, tables, pos, scale=D ** -0.5, **kw)
        want = pak.paged_decode_plain(q, kp, vp, tables, pos, scale=D ** -0.5, **kw)
        out = got[0] / torch.clamp(got[2], min=1e-9)
        ref = want[0] / torch.clamp(want[2], min=1e-9)
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= 2e-3, kw
        assert (got[1] - want[1]).abs().max().item() <= 1e-3, kw


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Hq,Hk", [(4, 4), (8, 2)])
def test_flash_kernel_geometries(gen, D, Hq, Hk):
    from polykey_tpu_torch.ops import flash_attention as fa

    B, T, S = 2, 200, 333                     # partial query and key tiles
    q, k, v = (_randn((B, T, Hq, D), gen), _randn((B, S, Hk, D), gen),
               _randn((B, S, Hk, D), gen))
    qpos = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    qpos[1] += 120
    qpos[1, 150:] = -1
    for kw in (dict(), dict(logit_softcap=50.0, window=64)):
        out = fa.flash_attention_cuda(q, k, v, qpos, scale=D ** -0.5, **kw)
        ref = fa.flash_attention_plain(q, k, v, qpos, scale=D ** -0.5, **kw).float()
        ref_abs = fa.flash_attention_plain(q, k, v.abs(), qpos, scale=D ** -0.5,
                                           **kw).float()
        tol = 2.0 ** -7 * (ref.abs() + ref_abs) + 1e-4
        assert ((out.float() - ref).abs() <= tol).all(), kw
        assert (out[1, 150:] == 0).all()


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
