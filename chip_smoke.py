#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (polykey_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own line and each followed by
torch.cuda.synchronize(); any failure ends the run with a non-zero exit:

1. device:  the card's name, compute capability and power limit.
2. build:   nvcc builds the CUDA kernels from polykey_tpu_torch/csrc.
3. kernels: each kernel against its plain PyTorch version on the card, at
            Llama-3-8B shapes in bf16: largest error against the stated
            tolerance, kernel / plain / library-call times (CUDA events) and
            the least time the card could take (the roofline bound).
4. slice:   a full-width, depth-2 Llama-3-8B runs prefill (bucket 128) and
            8 decode steps through forward_paged, once through the kernels
            and once through their plain versions; the logits must agree.
5. serve:   the full 32-layer Llama-3-8B (random bf16 weights from --seed)
            behind the port's gRPC server on a free local port, with the
            default EngineConfig; 4 concurrent llm_generate requests. Every
            kernel's launch count is set to 0 before this phase and must
            have risen after it.

The second-to-last line of standard output is the card's name and power
limit as nvidia-smi reports them; before it, one JSON line sums up each
kernel. The last line is {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM: published HBM3 rate
BF16_FLOPS_PER_S = 989e12       # H100 SXM: dense bf16 tensor-core peak


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def device_time_ms(fn, samples: int = 10, reps: int = 10) -> float:
    """Median over `samples` of the device time of one call of `fn`: each
    sample is a pair of CUDA events around `reps` back-to-back calls (which
    spreads the events' own cost). A sleep kernel holds the card while the
    host enqueues them all, so host launch overhead is not counted."""
    for _ in range(2):
        fn()
    sync()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(samples)]
    torch.cuda._sleep(100_000_000)
    for start, end in pairs:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    sync()
    return statistics.median(start.elapsed_time(end) / reps for start, end in pairs)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


# -- phase 1 ---------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", f"{name}, compute capability {cap[0]}.{cap[1]}, "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    check(cap == (9, 0), f"need compute capability 9.0 (sm_90a), got {cap}")
    return {"name": name, "smi": smi}


# -- phase 2 ---------------------------------------------------------------

def phase_build() -> None:
    from polykey_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.load_library()
    say("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}: {len(_build._sources())} "
        f"sources built and loaded in {time.monotonic() - t0:.2f} s "
        f"(compile {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  ptxas {line.strip()}", file=sys.stderr)


# -- phase 3 ---------------------------------------------------------------

PAGE_SIZE, TABLE = 16, 256     # default EngineConfig: 4096 positions in pages of 16


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def kernel_write(gen) -> dict:
    """B = 16 lanes into [2048, 16, 8, 128] pools; lanes 13-15 inactive on
    the garbage page 0."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    B, N, ps, Hk, D, P = 16, 2048, 16, 8, 128, 256
    k_pool = _randn((N, ps, Hk, D), gen)
    v_pool = _randn((N, ps, Hk, D), gen)
    k_new = _randn((B, 1, Hk, D), gen)
    v_new = _randn((B, 1, Hk, D), gen)
    positions = torch.tensor(
        [0, 15, 16, 17, 100, 255, 256, 1000, 2047, 2048, 3000, 4095, 7, 0, 0, 0],
        dtype=torch.int32, device="cuda",
    ).reshape(B, 1)
    tables = torch.randint(1, N, (B, P), generator=gen, device="cuda",
                           dtype=torch.int32)
    tables[13:] = 0
    # Distinct target pages, so no two active lanes write the same row.
    targets = torch.randperm(N - 1, generator=gen, device="cuda")[:13] + 1
    tables[torch.arange(13, device="cuda"), positions[:13, 0].long() // ps] = (
        targets.to(torch.int32))
    kk, vk = k_pool.clone(), v_pool.clone()
    kp, vp = k_pool.clone(), v_pool.clone()
    pw.paged_write_decode_cuda(kk, vk, k_new, v_new, tables, positions)
    pw.paged_write_decode_plain(kp, vp, k_new, v_new, tables, positions)
    sync()
    # Exact on every page but the garbage page 0 (inactive lanes race there).
    err = max(
        (kk[1:].float() - kp[1:].float()).abs().max().item(),
        (vk[1:].float() - vp[1:].float()).abs().max().item(),
    )
    check(err == 0.0, f"paged write differs from plain by {err}")
    page_ids, offsets = pw._slots(tables, positions, ps)
    rows_k, rows_v = k_new[:, 0], v_new[:, 0]

    def library():
        kk.index_put_((page_ids, offsets), rows_k)
        vk.index_put_((page_ids, offsets), rows_v)

    ms = device_time_ms(lambda: pw.paged_write_decode_cuda(
        kk, vk, k_new, v_new, tables, positions))
    plain = device_time_ms(lambda: pw.paged_write_decode_plain(
        kp, vp, k_new, v_new, tables, positions))
    lib = device_time_ms(library)
    row = Hk * D * 2
    nbytes = 2 * 2 * B * row + 2 * B * 4      # rows read + written; index reads
    b_ms, b_by = bound_ms(nbytes, 0)
    say("kernels", f"paged_write B={B} pools [{N},{ps},{Hk},{D}] bf16: max |err| "
        f"{err} (tolerance 0: a copy); kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"index_put_ x2 {lib:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": b_ms, "bound_by": b_by}


def _decode_case(gen, D, Hq, Hk, ctx_lens, softcap, window, page_range):
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    ps, P = PAGE_SIZE, TABLE
    B = len(ctx_lens)
    pages = [-(-n // ps) for n in ctx_lens]
    N = sum(pages) + 1
    k_pool = _randn((N, ps, Hk, D), gen)
    v_pool = _randn((N, ps, Hk, D), gen)
    # Stale rows past each position hold NaN: masked rows must never reach
    # the sums (0 x NaN would poison them).
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    order = (torch.randperm(N - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    used = 0
    for b, (n, npg) in enumerate(zip(ctx_lens, pages)):
        tables[b, :npg] = order[used: used + npg]
        used += npg
        last = int(tables[b, npg - 1])
        tail = n - (npg - 1) * ps
        v_pool[last, tail:] = float("nan")
    q = _randn((B, Hq, D), gen)
    pos = torch.tensor([n - 1 for n in ctx_lens], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, logit_softcap=softcap, window=window,
              page_range=page_range)
    acc, m, l = pak.paged_decode_cuda(q, k_pool, v_pool, tables, pos, **kw)
    acc_p, m_p, l_p = pak.paged_decode_plain(q, k_pool, v_pool, tables, pos, **kw)
    sync()
    out = acc / torch.clamp(l, min=1e-9)
    out_p = acc_p / torch.clamp(l_p, min=1e-9)
    check(bool(torch.isfinite(out).all()), "decode kernel output is not finite")
    err = (out - out_p).abs().max().item()
    err_m = (m - m_p).abs().max().item()
    check(err <= 2e-3 and err_m <= 1e-3,
          f"decode kernel differs from plain: out {err}, m {err_m}")
    # Rows this run's data needs: [max(0, pos - window + 1), pos] within
    # the page range; each read once, plus the page ids of their pages.
    rlo, rhi = page_range or (0, P)
    split = max(1, min(pak.MAX_SPLIT_PAGES, pak.SPLIT_ROWS // ps))
    visible = read_pages = busy_ctas = 0
    for n in ctx_lens:
        first = max(n - window, 0) if window else 0
        rows = max(0, min(n, rhi * ps) - max(first, rlo * ps))
        visible += rows
        read_pages += -(-rows // ps)
        lo, hi = max(first // ps, rlo), min(-(-n // ps), rhi)
        busy_ctas += Hk * len({(p - rlo) // split for p in range(lo, hi)})
    grid = Hk * B * max(1, -(-(rhi - rlo) // split))
    nbytes = (2 * visible * Hk * D * 2 + B * Hq * D * 2 + B * Hq * (D + 2) * 4
              + read_pages * 4 + B * 4)
    flops = 4 * Hq * D * visible
    ctas = f"{grid} CTAs, {busy_ctas} with rows to read"
    return (q, k_pool, v_pool, tables, pos, kw), err, nbytes, flops, ctas


def kernel_decode(gen) -> dict:
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    # Context lengths over 1..4096 with page-boundary cases.
    ctx = [1, 15, 16, 17, 31, 33, 255, 256, 257, 1000, 1024, 2047, 2049,
           3001, 4095, 4096]
    cases = [
        ("main", 128, 32, 8, ctx, None, None, None),
        ("softcap 50, window 4096", 128, 32, 8, ctx, 50.0, 4096, None),
        ("window 1000", 128, 32, 8, ctx, None, 1000, None),
        ("D=64", 64, 32, 8, ctx, None, None, None),
        ("pages [3, 200)", 128, 32, 8, ctx, None, None, (3, 200)),
    ]
    result = None
    for label, D, Hq, Hk, lens, softcap, window, prange in cases:
        args, err, nbytes, flops, ctas = _decode_case(gen, D, Hq, Hk, lens,
                                                      softcap, window, prange)
        q, kp, vp, tables, pos, kw = args
        ms = device_time_ms(lambda: pak.paged_decode_cuda(q, kp, vp, tables, pos, **kw))
        plain = device_time_ms(
            lambda: pak.paged_decode_plain(q, kp, vp, tables, pos, **kw), reps=2)
        b_ms, b_by = bound_ms(nbytes, flops)
        say("kernels", f"paged_attention_decode [{label}] B={len(lens)} Hq={Hq} "
            f"Hk={Hk} D={D} ps=16 P=256, ctx 1..4096: max |err| {err:.3e} "
            "(tolerance 2e-3 on the normalized fp32 output: bf16 inputs, fp32 "
            "accumulation in another order); "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}); {ctas}, on "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        else:
            result["max_abs_err"] = max(result["max_abs_err"], err)
    return result


def _sdpa(q, k, v, qpos, S, scale, window):
    """One library call over the same inputs, as a yardstick only."""
    import torch.nn.functional as F

    kv_pos = torch.arange(S, device="cuda")[None, None, :]
    mask = kv_pos <= qpos[:, :, None]
    if window:
        mask &= kv_pos > qpos[:, :, None] - window
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    groups = q.shape[2] // k.shape[2]
    kt = kt.repeat_interleave(groups, dim=1)
    vt = vt.repeat_interleave(groups, dim=1)
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, scale=scale)


def kernel_flash(gen) -> dict:
    from polykey_tpu_torch.ops import flash_attention as fa

    cases = [
        ("main", 2, 512, 4096, 32, 8, 128, None, None),
        ("T=128", 2, 128, 4096, 32, 8, 128, None, None),
        ("softcap 50, window 1024", 2, 512, 4096, 32, 8, 128, 50.0, 1024),
        ("D=64", 2, 512, 4096, 32, 8, 64, None, None),
        ("D=256", 2, 512, 4096, 16, 8, 256, None, None),
    ]
    result = None
    for label, B, T, S, Hq, Hk, D, softcap, window in cases:
        q = _randn((B, T, Hq, D), gen)
        k = _randn((B, S, Hk, D), gen)
        v = _randn((B, S, Hk, D), gen)
        # Row 0 prefills positions 0..T-1; row 1 a prompt whose tail rows
        # are padding (position -1) and which starts mid-window.
        qpos = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
        qpos[1] += 1000
        qpos[1, T - T // 4:] = -1
        kw = dict(scale=D ** -0.5, logit_softcap=softcap, window=window)
        out = fa.flash_attention_cuda(q, k, v, qpos, **kw)
        ref = fa.flash_attention_plain(q, k, v, qpos, **kw).float()
        # Per element: each side rounds every probability and its output to
        # bf16 once (unit roundoff 2^-8), so the two may differ by
        # 2^-7 (|out| + sum_i p_i |v_i|); the second term is the plain
        # attention over |V|. 1e-4 covers fp32 sums in another order.
        ref_abs = fa.flash_attention_plain(q, k, v.abs(), qpos, **kw).float()
        tol = 2.0 ** -7 * (ref.abs() + ref_abs) + 1e-4
        sync()
        check(bool(torch.isfinite(out.float()).all()), "flash output is not finite")
        check(bool((out[1, T - T // 4:] == 0).all()), "flash padding rows are not 0")
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        # Rows 0 (prefix from 0) and 1 (offset 1000, mid-window) apart, so
        # the small outputs of long rows are held to their own scale.
        ratio = [(diff[b] / tol[b]).max().item() for b in range(B)]
        check(max(ratio) <= 1.0, f"flash kernel differs from plain beyond "
              f"tolerance: largest err/tol per batch row {ratio}")
        ms = device_time_ms(lambda: fa.flash_attention_cuda(q, k, v, qpos, **kw))
        plain = device_time_ms(lambda: fa.flash_attention_plain(q, k, v, qpos, **kw),
                               reps=2)
        lib = device_time_ms(_sdpa(q, k, v, qpos, S, D ** -0.5, window), reps=2)
        # What this run's data needs: each query row sees keys [lo, p];
        # each batch row's K/V is read once over the union of those spans.
        p = qpos.long()
        valid = p >= 0
        lo = torch.clamp(p - window + 1, min=0) if window else torch.zeros_like(p)
        hi = torch.clamp(p, max=S - 1)
        visible = int(torch.where(valid, hi - lo + 1, torch.zeros_like(p)).sum())
        big = torch.full_like(p, S)
        kv_rows = sum(
            max(0, int(torch.where(valid[b], hi[b], -1).max())
                - int(torch.where(valid[b], lo[b], big[b]).min()) + 1)
            for b in range(B)
        )
        flops = 4 * D * Hq * visible
        nbytes = 2 * (2 * q.numel() + 2 * kv_rows * Hk * D) + qpos.numel() * 4
        b_ms, b_by = bound_ms(nbytes, flops)
        say("kernels", f"flash_attention [{label}] B={B} T={T} S={S} Hq={Hq} Hk={Hk} "
            f"D={D}: max |err| {err:.3e}, largest err/tol row 0 {ratio[0]:.3f}, "
            f"row 1 {ratio[1]:.3f} (tolerance per element 2^-7 (|ref| + "
            "sum p|v|) + 1e-4: bf16 probabilities and output rounded once on "
            "each side, fp32 accumulation in another order); kernel "
            f"{ms:.4f} ms, plain "
            f"{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
        else:
            result["max_abs_err"] = max(result["max_abs_err"], err)
    return result


def phase_kernels(seed: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("kernels", "TF32 off for matmuls and cuDNN (allow_tf32 = False): plain "
        "versions run in full fp32 where they compute in fp32")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.inference_mode():
        results = {
            "paged_write": kernel_write(gen),
            "paged_attention_decode": kernel_decode(gen),
            "flash_attention": kernel_flash(gen),
        }
    sync()
    return results


# -- phase 4 ---------------------------------------------------------------

class _PlainPath:
    """Route forward_paged through the plain versions with the reference's
    own kill switches (POLYKEY_DISABLE_FLASH, POLYKEY_DISABLE_PAGED_KERNEL)."""

    NAMES = ("POLYKEY_DISABLE_FLASH", "POLYKEY_DISABLE_PAGED_KERNEL")

    def __enter__(self):
        self.saved = {n: os.environ.get(n) for n in self.NAMES}
        for n in self.NAMES:
            os.environ[n] = "1"

    def __exit__(self, *exc):
        for n, v in self.saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def _launches() -> dict:
    from polykey_tpu_torch.engine.engine import KERNELS

    return {name: k.launches for name, k in KERNELS.items()}


def phase_slice(seed: int) -> None:
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.transformer import (
        forward_paged, init_params, unembed,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("slice", "TF32 off for matmuls and cuDNN (allow_tf32 = False)")
    cfg = replace(get_config("llama-3-8b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, torch.bfloat16, "cuda", gen)
    B, T, ps, P, steps = 2, 128, 16, 256, 8
    prompt_lens = [100, 77]
    tokens = torch.randint(3, 259, (B, T), generator=gen, device="cuda",
                           dtype=torch.int32)
    forced = torch.randint(3, 259, (steps, B), generator=gen, device="cuda",
                           dtype=torch.int32)
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    per = -(-(T + steps) // ps)
    for b in range(B):
        tables[b, :per] = torch.arange(1 + b * per, 1 + (b + 1) * per)

    def run():
        paged = init_paged_kv(cfg, 1 + B * per, ps, torch.bfloat16, "cuda")
        positions = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
        hidden, paged = forward_paged(params, cfg, tokens, positions, paged, tables)
        rows = torch.tensor([n - 1 for n in prompt_lens], device="cuda")
        logits = [unembed(params, cfg, hidden[torch.arange(B), rows])]
        for i in range(steps):
            pos = torch.tensor([[n + i] for n in prompt_lens], dtype=torch.int32,
                               device="cuda")
            hidden, paged = forward_paged(params, cfg, forced[i][:, None], pos,
                                          paged, tables)
            logits.append(unembed(params, cfg, hidden[:, 0]))
        sync()
        return torch.stack(logits)

    with torch.inference_mode():
        before = _launches()
        got = run()
        mid = _launches()
        with _PlainPath():
            want = run()
        after = _launches()
    check(all(mid[n] > before[n] for n in mid),
          f"the kernel run skipped a kernel: {before} -> {mid}")
    check(after == mid, f"the plain run launched kernels: {mid} -> {after}")
    check(bool(torch.isfinite(got).all()), "slice logits are not finite")
    err = (got - want).abs().max().item()
    rms = want.square().mean().sqrt().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    say("slice", f"llama-3-8b width, 2 layers, bf16: prefill T={T} (prompts "
        f"{prompt_lens}) + {steps} decode steps, kernels vs plain: max |dlogit| "
        f"{err:.4f} over logits of RMS {rms:.3f} (tolerance 0.12, about twice "
        f"the 0.055 measured on the H100: bf16 activations round differently "
        f"once attention sums in another order); argmax agreement {agree:.3f} "
        f"(must be 1); kernel launches in the kernel run "
        f"{({n: mid[n] - before[n] for n in mid})}")
    check(err <= 0.12, f"slice logits differ by {err}")
    check(agree == 1.0, f"slice argmax agrees on only {agree:.3f} of the rows")
    del params
    torch.cuda.empty_cache()


# -- phase 5 ---------------------------------------------------------------

SHORT = [
    "Summarize the tradeoffs between paged and contiguous KV caches for a "
    "batch of chat requests, briefly.",
    "List three reasons a decode step on a GPU is bound by memory traffic "
    "rather than by arithmetic.",
]
LONG = [
    ("Explain, step by step, how a continuous-batching inference server "
     "admits new requests while others are decoding: how it picks free "
     "slots, pads prompts to a bucket, writes their keys and values into "
     "pages, and then merges the new lanes into the running decode batch "
     "without stalling the requests that were already generating text. ") * 1
    + "Then say what limits the batch size on one card, and why.",
    ("A user sends a long document and asks for a short answer. Describe "
     "what happens to the prompt inside the engine: tokenization, the "
     "bucket it lands in, how many pages of the key/value pool it takes, "
     "how the prefill attends over its own window, and how the first "
     "token is sampled from the last hidden state of the prompt. Keep the "
     "description concrete and brief, and mention the cost. ") * 1,
]


def _struct(**kv):
    from google.protobuf import struct_pb2

    s = struct_pb2.Struct()
    s.update(kv)
    return s


def phase_serve(seed: int, card: str) -> dict:
    import grpc

    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, GenRequest, InferenceEngine
    from polykey_tpu_torch.gateway.jsonlog import Logger
    from polykey_tpu_torch.gateway.server import build_server
    from polykey_tpu_torch.gateway.torch_service import TorchService
    from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
    from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

    config = EngineConfig(model="llama-3-8b")
    t0 = time.monotonic()
    engine = InferenceEngine(config, device="cuda", seed=seed)
    sync()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params))
    kv = 2 * engine.paged.k.numel() * engine.paged.k.element_size()
    say("serve", f"engine up in {time.monotonic() - t0:.1f} s: {config.model}, "
        f"{len(engine.params['layers'])} layers, bf16 weights {nbytes / 2**30:.2f} "
        f"GiB, KV pool {kv / 2**30:.2f} GiB ({config.num_pages} pages x "
        f"{config.page_size}), {config.max_decode_slots} slots, buckets "
        f"{config.prefill_buckets}, decode block {config.decode_block_steps}")
    # Keep each request the gateway submits, to read its timings after.
    submitted: list = []
    submit = engine.submit

    def recording_submit(request):
        submitted.append(request)
        submit(request)

    engine.submit = recording_submit
    logger = Logger(stream=sys.stderr, level="WARN")
    service = TorchService(engine, logger=logger)
    server, _health, port = build_server(service, logger, address="127.0.0.1:0")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    stub = PolykeyServiceStub(channel)
    try:
        for k in KERNELS.values():
            k.launches = 0
        results = _serve_requests(stub, pk, submitted)
        counts = {name: k.launches for name, k in KERNELS.items()}
        sync()
        say("serve", f"kernel launches in this phase: {counts}")
        check(all(n > 0 for n in counts.values()),
              f"a kernel of the main path was not launched: {counts}")
        # Token-level determinism on the same engine: the gRPC text of a
        # random-weight model over a 128k vocab is mostly ids outside the
        # byte tokenizer's range, so compare the ids themselves too.
        ids = []
        for _ in range(2):
            req = GenRequest(prompt=SHORT[0], max_new_tokens=32)
            engine.submit(req)
            toks = []
            while True:
                kind, value = req.out.get(timeout=600)
                if kind == "token":
                    toks.append(value)
                elif kind == "error":
                    raise AssertionError(f"engine error: {value}")
                else:
                    break
            ids.append(toks)
        check(ids[0] == ids[1] and len(ids[0]) == 32,
              "a repeated greedy prompt gave other token ids")
        say("serve", f"repeated greedy prompt: identical 32 token ids "
            f"{ids[0][:8]}...")
        for r in results:
            say("serve", f"{r['label']}: status {r['status']}, prompt "
                f"{r['prompt_tokens']} tokens, {r['completion_tokens']} completion "
                f"tokens, TTFT {r['ttft_ms']:.1f} ms, {r['tok_s']:.1f} tok/s "
                f"(wall {r['wall_s']:.2f} s) on {card}")
    finally:
        channel.close()
        server.stop(grace=5).wait()
        service.close()
    sync()
    return {"requests": results, "launches": counts}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _serve_requests(stub, pk, submitted: list) -> list[dict]:
    """After one warm-up request per bucket, 4 concurrent requests: two
    short prompts (bucket 128), two long (bucket 512); one streamed, the
    rest unary; then the first greedy prompt again, which must return the
    same text."""
    specs = [
        ("short greedy", SHORT[0], dict(), False),
        ("short sampled stream", SHORT[1], dict(temperature=0.8, top_p=0.9,
                                                  top_k=50, seed=7), True),
        ("long greedy", LONG[0], dict(), False),
        ("long sampled", LONG[1], dict(temperature=1.0, top_p=0.95, seed=11), False),
    ]
    # One request per bucket first, alone: the first prefill of each shape
    # pays one-time library set-up that is not serving latency.
    for prompt in (SHORT[0], LONG[0]):
        warm = stub.ExecuteTool(pk.ExecuteToolRequest(
            tool_name="llm_generate",
            parameters=_struct(prompt=prompt, max_tokens=4)), timeout=900)
        check(warm.status.code == 200, "warm-up request failed")
    out: list = [None] * len(specs)
    errors: queue.Queue = queue.Queue()

    def one(i, label, prompt, extra, stream):
        try:
            req = pk.ExecuteToolRequest(
                tool_name="llm_generate",
                parameters=_struct(prompt=prompt, max_tokens=32, **extra),
            )
            t0 = time.monotonic()
            if stream:
                text, final, first = "", None, None
                for chunk in stub.ExecuteToolStream(req, timeout=900):
                    if chunk.final:
                        final = chunk
                    else:
                        first = first or time.monotonic()
                        text += chunk.delta
                check(final is not None and final.status.code == 200,
                      f"{label}: no final chunk with status 200")
                u = final.usage
                check(u.completion_tokens == 32 and u.prompt_tokens > 0,
                      f"{label}: usage {u}")
                out[i] = dict(label=label, status=final.status.code, text=text,
                              prompt_tokens=u.prompt_tokens,
                              completion_tokens=u.completion_tokens,
                              ttft_ms=u.ttft_ms, tok_s=u.tokens_per_sec,
                              wall_s=time.monotonic() - t0)
            else:
                resp = stub.ExecuteTool(req, timeout=900)
                check(resp.status.code == 200, f"{label}: status {resp.status}")
                out[i] = dict(label=label, status=resp.status.code,
                              text=resp.string_output, wall_s=time.monotonic() - t0)
        except BaseException as e:  # reported by the caller's check below
            errors.put(f"{label}: {e!r}")

    threads = [threading.Thread(target=one, args=(i, *s)) for i, s in enumerate(specs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(errors.empty(), "request failed: " + "; ".join(list(errors.queue)))
    # Unary responses carry no Usage: read the engine's record of each
    # request (the timings the streamed Usage is built from).
    by_prompt = {r.prompt: r.timings for r in submitted}
    for r, (_label, prompt, _extra, _stream) in zip(out, specs):
        t = by_prompt[prompt]
        check(t.completion_tokens == 32, f"{r['label']}: {t.completion_tokens} tokens")
        r.setdefault("prompt_tokens", t.prompt_tokens)
        r.setdefault("completion_tokens", t.completion_tokens)
        r.setdefault("ttft_ms", t.ttft_ms)
        r.setdefault("tok_s", t.tokens_per_sec)
    stats = stub.ExecuteTool(pk.ExecuteToolRequest(tool_name="engine_stats"), timeout=60)
    check(stats.status.code == 200, "engine_stats failed")
    again = stub.ExecuteTool(pk.ExecuteToolRequest(
        tool_name="llm_generate",
        parameters=_struct(prompt=SHORT[0], max_tokens=32)), timeout=900)
    check(again.status.code == 200 and again.string_output == out[0]["text"],
          "the repeated greedy prompt returned other text")
    return out


# -- main ------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import polykey_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the polykey_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    dev = phase_device()
    sync()
    phase_build()
    sync()
    kernels = phase_kernels(args.seed)
    phase_slice(args.seed)
    sync()
    serve = phase_serve(args.seed, dev["smi"])

    from polykey_tpu_torch.engine.engine import KERNELS

    sources = {
        "flash_attention": ("polykey_tpu_torch/csrc/flash_attention.cu",
                            "polykey_tpu/ops/flash_attention.py:157"),
        "paged_attention_decode": ("polykey_tpu_torch/csrc/paged_attention_decode.cu",
                                   "polykey_tpu/ops/paged_attention_kernel.py:349"),
        "paged_write": ("polykey_tpu_torch/csrc/paged_write.cu",
                        "polykey_tpu/ops/paged_write_kernel.py:134"),
    }
    summary = []
    for name in KERNELS:
        src, tpu = sources[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": serve["launches"][name]}
        entry.update(kernels[name])
        summary.append(entry)
    print(json.dumps({"kernels": summary}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
