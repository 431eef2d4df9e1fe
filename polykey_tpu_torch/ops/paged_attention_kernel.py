"""Paged decode attention (the reference's ops/paged_attention_kernel.py):
one query token per sequence over its own KV pages.

The kernel (csrc/paged_attention_decode.cu) reads only the pages a
sequence owns, [lo, hi) from its position and sliding window, clipped to a
page sub-range [rlo, rhi), and returns UNNORMALIZED online-softmax state
(acc [B, Hq, D] f32, m and l [B, Hq, 1] f32); `paged_attention_decode`
normalizes. One kernel template serves both pool types, one launch a
call: the context splits over CTAs of SPLIT_ROWS rows (bf16 pools) or
SPLIT_ROWS_INT8 rows (int8 pools), a CTA whose split holds no rows
returns at once, K and V stream through a shared-memory ring, q.k and p.v
run on tensor cores, and the last split of each (sequence, kv head) to
finish merges the others inside the launch. The wrapper takes the
per-split scratch from `split_scratch` and the arrival counters from
`arrival_counters`. bf16 pools go to pk_paged_decode (launch count
`KERNEL`): bf16 operands, each probability in two bf16 halves so that p.v
keeps p to 2^-16 relative. On a CUDA tensor the kernel runs or the call
raises; `paged_decode_plain` computes the same function in plain PyTorch
and runs only for CPU tensors and as the comparison in tests and
chip_smoke.py. `decode_error_bound` is the tolerance of both instances.
POLYKEY_DISABLE_PAGED_KERNEL=1 is the reference's kill switch (off by
default): it routes decode through the gather path, ops/paged_attention.py.

int8 KV: the pools come as (values, scales) pairs, values [N, ps, Hk, D]
int8 and scales [N, ps, Hk] bf16, and go to pk_paged_decode_int8 (its own
launch count `KERNEL_INT8`): the scales ride the ring beside the values,
the int8 values are taken exactly into fp16 without an int-to-float
conversion, and the K scale multiplies each logit and the V scale each
probability (rounded to fp16 once). POLYKEY_DISABLE_KV_KERNEL=1, the
reference's kill switch for the int8 paths (off by default), sends int8
decode to the gather path and the int8 decode write to the scatter.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ._build import F, I, P, Kernel, check_cuda_tensor

# Pointers: q, k, v, tables, positions, acc, m, l, the split scratch, the
# arrival counters.
_ARGS = [P] * 12 + [I, I, I, I, I, I, F, F, I, I, I, I, I]
KERNEL = Kernel("pk_paged_decode", _ARGS)
# The int8 variant takes the two scale pools after the value pools.
KERNEL_INT8 = Kernel("pk_paged_decode_int8", _ARGS[:3] + [P, P] + _ARGS[3:])

DECODE_HEAD_DIMS = frozenset({64, 128, 256})
DECODE_GROUPS = frozenset({1, 2, 4, 8})   # query heads per kv head
# KV rows per split CTA (split-KV over the context). bf16 (8-warp CTAs at D
# = 128): of 256..1024 rows, 1024 was fastest at 16 lanes of context 512
# and 768-1024 at contexts 1..4096, within 1% of each other. int8 (16-warp
# CTAs): of 512..4096 rows, 1024 was fastest at contexts 1..4096 and within
# 8% of the best at 16 lanes of context 512 (chip_smoke.py's decode cases,
# on an H100; PERF.md, section 6). Pages per split are capped by each
# instance's table of page ids in shared memory (kMaxSplitPages and
# kMaxSplitPagesInt8 in the source).
SPLIT_ROWS = 1024
SPLIT_ROWS_INT8 = 1024
MAX_SPLIT_PAGES = 64
MAX_SPLIT_PAGES_INT8 = 256
_NEG_INF = -1e30


def _window_int(window) -> int:
    return 0 if window is None else int(window)


def pool_values(pages) -> torch.Tensor:
    return pages[0] if isinstance(pages, tuple) else pages


def gather_pages_f32(pages, idx: torch.Tensor) -> torch.Tensor:
    """fp32 rows [*idx.shape, ps, Hk, D] of the pages `idx`; an int8 pair
    is dequantized in fp32, k8 * ks, the kernels' arithmetic."""
    if isinstance(pages, tuple):
        values, scales = pages
        return values[idx].float() * scales[idx][..., None].float()
    return pages[idx].float()


def paged_decode_plain(
    q: torch.Tensor,             # [B, Hq, D]
    k_pages,                     # [N, ps, Hk, D], or an int8 (values, scales) pair
    v_pages,
    page_tables: torch.Tensor,   # [B, P] int32
    positions: torch.Tensor,     # [B] int32
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
    page_range: Optional[tuple[int, int]] = None,
):
    """(acc, m, l) over the pages in `page_range` ([0, P) by default), the
    kernel's contract: rows outside [lo, hi) ∩ [rlo, rhi) or masked by
    position/window contribute nothing, m starts at -1e30."""
    B, Hq, D = q.shape
    _, ps, Hk, _ = pool_values(k_pages).shape
    P_ = page_tables.shape[1]
    rlo, rhi = page_range if page_range is not None else (0, P_)
    G = Hq // Hk
    S = P_ * ps
    k = gather_pages_f32(k_pages, page_tables.long()).reshape(B, S, Hk, D)
    v = gather_pages_f32(v_pages, page_tables.long()).reshape(B, S, Hk, D)
    kv_pos = torch.arange(S, device=q.device)[None, :]           # [1, S]
    pos = positions.reshape(B, 1).long()
    valid = (kv_pos <= pos) & (kv_pos >= rlo * ps) & (kv_pos < rhi * ps)
    w = _window_int(window)
    if w > 0:
        valid &= kv_pos > pos - w
    qg = q.reshape(B, Hk, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, _NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG_INF)
    p = torch.where(vmask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    v = torch.where(valid[:, :, None, None], v, torch.zeros_like(v))
    acc = torch.einsum("bhgs,bshd->bhgd", p, v)
    return (
        acc.reshape(B, Hq, D), m.reshape(B, Hq, 1), l.reshape(B, Hq, 1),
    )


def decode_error_bound(q, k_pages, v_pages, page_tables, positions, **kw) -> torch.Tensor:
    """Per-element bound [B, Hq, D] on how far a decode kernel's normalized
    output, acc / l, may lie from `paged_decode_plain`'s on the same inputs
    (keywords as there). The int8 kernel takes q and the int8 values into
    fp16 exactly (bf16 q from 2^-14 to 65504) and rounds each probability
    times its V scale, p vs, to fp16 once before p.v: an error of at most
    2^-11 p vs where the product is a normal fp16 number and 2^-25 below.
    Over the rows that count that is 2^-11 sum p |v| / l + 2^-25 sum |v8|
    / l; 1e-5 (1 + sum p |v| / l) covers exp, the logits and fp32 sums in
    another order. The bf16 kernel takes q, K and V exactly and each
    probability in two bf16 halves, hi = bf16(p) and lo = bf16(p - hi),
    within 2^-16 p of p: inside the same bound."""
    def magnitudes(pages, unit_scales: bool):
        if not isinstance(pages, tuple):
            return pages.abs()
        values, scales = pages
        return values.abs(), torch.ones_like(scales) if unit_scales else scales

    acc_abs, _, l = paged_decode_plain(q, k_pages, magnitudes(v_pages, False),
                                       page_tables, positions, **kw)
    # q = 0: every row that counts has p = 1, so acc sums its |v8|.
    v8_sum, _, _ = paged_decode_plain(torch.zeros_like(q), k_pages, magnitudes(v_pages, True),
                                      page_tables, positions, **kw)
    l = torch.clamp(l, min=1e-9)
    mean_abs = acc_abs / l
    return 2.0 ** -11 * mean_abs + 2.0 ** -25 * v8_sum / l + 1e-5 * (1 + mean_abs)


def check_kv_pools(kernel: str, k_pages, v_pages) -> tuple:
    """Check a kernel's K/V pool operands on the card: bf16 pools, or int8
    (values, scales) pairs with bf16 scales [N, ps, Hk]. Returns the
    tensors to pass, (k, v) or (k, v, ks, vs), and whether they are int8."""
    if isinstance(k_pages, tuple) != isinstance(v_pages, tuple):
        raise ValueError(f"{kernel}: k and v pools must both be pairs or both not")
    if not isinstance(k_pages, tuple):
        check_cuda_tensor("k_pages", k_pages, torch.bfloat16, 4)
        check_cuda_tensor("v_pages", v_pages, torch.bfloat16, 4)
        if v_pages.shape != k_pages.shape:
            raise ValueError(f"{kernel}: k and v pools differ in shape")
        return (k_pages, v_pages), False
    (kq, ks), (vq, vs) = k_pages, v_pages
    for name, t in (("k_pages", kq), ("v_pages", vq)):
        check_cuda_tensor(name, t, torch.int8, 4)
    for name, t in (("k_scales", ks), ("v_scales", vs)):
        check_cuda_tensor(name, t, torch.bfloat16, 3)
    if vq.shape != kq.shape or ks.shape != kq.shape[:3] or vs.shape != ks.shape:
        raise ValueError(
            f"{kernel}: int8 pools {tuple(kq.shape)} / {tuple(vq.shape)} need "
            f"scales {tuple(kq.shape[:3])}, got {tuple(ks.shape)} / {tuple(vs.shape)}"
        )
    return (kq, vq, ks, vs), True


def split_pages(ps: int, int8: bool) -> int:
    """Pages per split of the decode kernels for pages of `ps` rows."""
    if int8:
        return max(1, min(MAX_SPLIT_PAGES_INT8, SPLIT_ROWS_INT8 // ps))
    return max(1, min(MAX_SPLIT_PAGES, SPLIT_ROWS // ps))


def split_scratch(B: int, Hq: int, D: int, nsplit: int, device) -> tuple:
    """Per-split state of a split call, f32: acc [B, Hq, nsplit, D], m and
    l [B, Hq, nsplit]. Uninitialized: a kernel writes a split's state
    before it reads it, and reads no split that holds no rows."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, Hq, nsplit, D), **f32), torch.empty((B, Hq, nsplit), **f32),
            torch.empty((B, Hq, nsplit), **f32))


# (device, stream) -> every arrival-counter buffer handed out, newest last.
_ARRIVALS: dict = {}


def arrival_counters(n: int, device) -> torch.Tensor:
    """At least `n` int32 arrival counters for the calls of the kernels that
    merge their splits in the launch (both decode kernels, both ragged
    kernels) on `device`'s current stream, zero between calls (a call
    resets every counter it counts on). Calls that share a buffer must not overlap, so
    each stream has its own, and the calls on it run in stream order. A
    buffer is replaced by a larger one when too small but never freed, so
    a CUDA graph that captured a call keeps valid counters. A counter is
    left nonzero only by a launch that dies mid-grid, which leaves the
    CUDA context unusable anyway."""
    device = torch.device(device)
    stream = 0
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.current_stream(device).cuda_stream
    held = _ARRIVALS.setdefault((str(device), stream), [])
    if not held or held[-1].numel() < n:
        size = max(n, 2 * held[-1].numel() if held else 1)
        held.append(torch.zeros(size, dtype=torch.int32, device=device))
    return held[-1]


def paged_decode_cuda(
    q, k_pages, v_pages, page_tables, positions, *, scale,
    logit_softcap=None, window=None, page_range=None,
):
    """Launch the CUDA kernel (the int8 one for (values, scales) pairs);
    returns (acc, m, l). Raises on anything the kernel does not take."""
    B, Hq, D = q.shape
    pools, int8 = check_kv_pools("paged decode kernel", k_pages, v_pages)
    N, ps, Hk, Dk = pools[0].shape
    P_ = page_tables.shape[1]
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    check_cuda_tensor("page_tables", page_tables, torch.int32, 2)
    check_cuda_tensor("positions", positions, torch.int32, 1)
    if D not in DECODE_HEAD_DIMS or Dk != D:
        raise ValueError(
            f"paged decode kernel: head_dim {D} (pools {tuple(pools[0].shape)}) "
            f"not in {sorted(DECODE_HEAD_DIMS)}"
        )
    if Hq % Hk or Hq // Hk not in DECODE_GROUPS:
        raise ValueError(
            f"paged decode kernel: Hq={Hq}, Hk={Hk} needs Hq / Hk in "
            f"{sorted(DECODE_GROUPS)}"
        )
    if page_tables.shape[0] != B or positions.shape[0] != B:
        raise ValueError("paged decode kernel: batch sizes disagree")
    for name, t in (("q", q), ("k_pages", pools[0]), ("v_pages", pools[1])):
        if t.data_ptr() % 16:
            raise ValueError(f"paged decode kernel: {name} is not 16-byte aligned")
    # The int8 kernel copies each scale as the aligned 4-byte word holding it.
    for name, t in zip(("k_scales", "v_scales"), pools[2:]):
        if t.data_ptr() % 4:
            raise ValueError(f"paged decode kernel: {name} is not 4-byte aligned")
    rlo, rhi = page_range if page_range is not None else (0, P_)
    if not 0 <= rlo <= rhi <= P_:
        raise ValueError(f"paged decode kernel: page range [{rlo}, {rhi}) of {P_}")
    split = split_pages(ps, int8)
    nsplit = max(1, -(-(rhi - rlo) // split))
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Hq, D), **f32)
    m = torch.empty((B, Hq, 1), **f32)
    l = torch.empty((B, Hq, 1), **f32)
    parts = split_scratch(B, Hq, D, nsplit, q.device) if nsplit > 1 else (acc, m, l)
    (KERNEL_INT8 if int8 else KERNEL)(
        q, *pools, page_tables, positions, acc, m, l, *parts,
        arrival_counters(B * Hk, q.device),
        B, Hq, Hk, D, ps, P_, float(scale), float(logit_softcap or 0.0),
        _window_int(window), int(rlo), int(rhi), split, nsplit,
    )
    return acc, m, l


def use_paged_kernel() -> bool:
    """POLYKEY_DISABLE_PAGED_KERNEL=1 is the operational kill switch."""
    return os.environ.get("POLYKEY_DISABLE_PAGED_KERNEL", "").lower() not in (
        "1", "true"
    )


def use_quantized_paged_kernel() -> bool:
    """Gate of the int8-KV kernel paths (decode read, decode write): the
    data pools' gate plus the reference's own kill switch,
    POLYKEY_DISABLE_KV_KERNEL=1, so a fault in the int8 kernels can be
    contained without taking the working bf16 kernels down (the int8
    gather and scatter serve instead)."""
    if os.environ.get("POLYKEY_DISABLE_KV_KERNEL", "").lower() in ("1", "true"):
        return False
    return use_paged_kernel()


def paged_attention_decode(
    q: torch.Tensor,             # [B, 1, Hq, D]
    k_pages,                     # [N, ps, Hk, D], or an int8 (values, scales) pair
    v_pages,
    page_tables: torch.Tensor,   # [B, P]
    q_positions: torch.Tensor,   # [B, 1]
    *,
    scale: float,
    logit_softcap: Optional[float] = None,
    window=None,
) -> torch.Tensor:
    """Decode-step paged attention; returns [B, 1, Hq, D]."""
    gate = use_quantized_paged_kernel if isinstance(k_pages, tuple) else use_paged_kernel
    if not gate():
        from .paged_attention import paged_attention

        return paged_attention(
            q, k_pages, v_pages, page_tables, q_positions,
            scale=scale, logit_softcap=logit_softcap, window=window,
        )
    B = q.shape[0]
    op = paged_decode_cuda if q.device.type == "cuda" else paged_decode_plain
    acc, _, l = op(
        q[:, 0].contiguous(), k_pages, v_pages,
        page_tables.to(torch.int32).contiguous(),
        q_positions.reshape(B).to(torch.int32).contiguous(),
        scale=scale, logit_softcap=logit_softcap, window=window,
    )
    out = acc / torch.clamp(l, min=1e-9)
    return out.to(q.dtype)[:, None]
