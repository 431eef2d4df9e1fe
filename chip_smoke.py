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
            the least time the card could take (the roofline bound). The
            ragged kernel at the engine's default ragged stream: 16 decode
            singles over 1..4096 keys plus two 512-token chunks (T = 1040),
            at profile_decode --ragged's (16 lanes at context 512), and
            the 16 singles alone.
            Both paged writes (the copy and the quantizing one) at 16
            lanes and at a 1040-row ragged stream, exact, beside the
            launch floor (an empty kernel timed back to back). Then the
            int8-KV variants at the same shapes: decode and ragged over
            int8 pools with bf16 scales.
4. slice:   a full-width, depth-2 Llama-3-8B runs prefill (bucket 128) and
            8 decode steps through forward_paged, once through the kernels
            and once through their plain versions; the logits must agree.
            Then a mixed prefill+decode run through forward_ragged, kernels
            against plain and against forward_paged on the same tokens.
            Both again over int8 KV, kernels against plain, and the hidden
            states against the bf16-KV runs (the reference's 0.05 gate).
5. serve:   the full 32-layer Llama-3-8B (random bf16 weights from --seed)
            behind the port's gRPC server on a free local port, with the
            default EngineConfig; 5 concurrent llm_generate requests, one of
            them a ~1500-token prompt (chunked prefill). Every kernel's
            launch count is set to 0 before this phase; the bucketed path's
            kernels must have risen after it, and no other.
6. ragged:  the same weights behind a second engine with ragged_dispatch
            on, the same requests: the ragged, decode and write kernels
            must have launched, the flash kernel not (every prefill rides
            the ragged stream).
7. serve-int8, ragged-int8: phases 5 and 6 again with kv_dtype="int8"
            (POLYKEY_KV_DTYPE=int8): only the int8 variants of decode,
            write and ragged run, beside flash in the bucketed mode.
            Every serve runs the default pipeline: lookahead depth 2 and
            the adaptive block, each decode block a replay of one of the
            four CUDA graphs the engine captured at start ((greedy,
            sampled) x (8, 1) steps), and in the bucketed serves each
            prefill and chunk a replay of one of 16 prefill graphs
            (buckets 128, 512 x group pads 1, 2, 4, 8 x greedy, sampled),
            its first token read lazily; a ragged dispatch goes out
            without draining the blocks in flight. Each prints the graphs'
            capture seconds and pool bytes, its replays, the observed
            lookahead and the host stall p50, and fails unless the decode
            graphs were replayed in it, and (bucketed) unless the prefill
            graphs were, no prefill ran eagerly and every flash launch came
            from a prefill replay, or (ragged) unless a ragged dispatch
            went out with another block in flight.
8. graph:   the full-depth Llama-3-8B decode block (16 greedy lanes at
            context 512, as profile_decode sets it up; bf16 and int8 KV),
            eager and as a replay of its graph, from the same lane state:
            the packed tokens and the final lane state must be identical;
            then both in turns (eager, graph, graph, eager, ...), each
            run's wall per step on the host clock and its idle share from
            torch.profiler.
9. prefill-graph: the full-depth bucketed prefill (512 tokens at positions
            1024..1535, 1 and 8 rows, greedy; bf16 and int8 KV), eager and
            as a replay of its graph, from the same pools: the sampled
            tokens and the KV pages of the rows must be identical; then
            both in turns, 3 runs each, each run's wall and idle share.

The second-to-last line of standard output is the card's name and power
limit as nvidia-smi reports them; before it, one JSON line sums up each
kernel, its launches taken from the serve phase that runs it. The last
line is {"ok": true, "device": {...}}. Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
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
        if (any(w in line for w in ("Compiling entry", "registers", "spill", "wgmma"))
                or line.startswith("==")):
            print(f"  ptxas {line.strip()}", file=sys.stderr)


# -- phase 3 ---------------------------------------------------------------

PAGE_SIZE, TABLE = 16, 256     # default EngineConfig: 4096 positions in pages of 16


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _write_slots(gen, B, N, ps, P, pad):
    """Positions [B, 1] and tables [B, P] that send each of the first B - pad
    rows to its own slot (a random page and offset) and the last `pad` rows
    (inactive lanes, a stream's padding) to the garbage page 0 at position 0."""
    slots = torch.randperm((N - 1) * ps, generator=gen, device="cuda")[:B]
    positions = torch.randint(0, P * ps, (B, 1), generator=gen, device="cuda",
                              dtype=torch.int32)
    positions[:, 0] = positions[:, 0] - positions[:, 0] % ps + (slots % ps).to(torch.int32)
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    rows = torch.arange(B, device="cuda")
    tables[rows, positions[:, 0].long() // ps] = (1 + slots // ps).to(torch.int32)
    tables[B - pad:] = 0
    positions[B - pad:] = 0
    return positions, tables


def _write_case(label, B, err, kernel, plain, library, nbytes) -> dict:
    """Time one write case (kernel, plain version, library call) beside its
    bound and the launch floor: an empty kernel timed back to back by the
    same method, the least any launch takes."""
    ms, plain_ms, lib = (device_time_ms(f) for f in (kernel, plain, library))
    floor = device_time_ms(lambda: torch.cuda._sleep(0))
    b_ms, b_by = bound_ms(nbytes, 0)
    say("kernels", f"{label}, B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib:.4f} ms, bound {b_ms:.6f} ms ({b_by}), launch floor "
        f"{floor:.4f} ms")
    return {"rows": B, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
            "launch_floor_ms": floor}


def kernel_write(gen) -> dict:
    """B = 16 lanes into [2048, 16, 8, 128] pools, lanes 13-15 inactive on
    the garbage page 0; then the 1040 rows of a ragged stream, the last 3
    padding on page 0."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    N, ps, Hk, D, P = 2048, 16, 8, 128, 256
    k_pool = _randn((N, ps, Hk, D), gen)
    v_pool = _randn((N, ps, Hk, D), gen)
    cases = []
    for B in (16, 1040):
        k_new = _randn((B, 1, Hk, D), gen)
        v_new = _randn((B, 1, Hk, D), gen)
        if B == 16:
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
        else:
            positions, tables = _write_slots(gen, B, N, ps, P, 3)
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
        check(err == 0.0, f"paged write B={B} differs from plain by {err}")
        say("kernels", f"paged_write B={B} pools [{N},{ps},{Hk},{D}] bf16: max |err| "
            f"{err} (tolerance 0: a copy)")
        page_ids, offsets = pw._slots(tables, positions, ps)
        rows_k, rows_v = k_new[:, 0], v_new[:, 0]

        def library():
            kk.index_put_((page_ids, offsets), rows_k)
            vk.index_put_((page_ids, offsets), rows_v)

        row = Hk * D * 2
        cases.append(_write_case(
            "paged_write (library: index_put_ x2)", B, err,
            lambda: pw.paged_write_decode_cuda(kk, vk, k_new, v_new, tables, positions),
            lambda: pw.paged_write_decode_plain(kp, vp, k_new, v_new, tables, positions),
            library,
            2 * 2 * B * row + 2 * B * 4))      # rows read + written; index reads
    return {**cases[0], "stream": cases[1]}     # 16 lanes; the stream beside


def kernel_write_int8(gen) -> dict:
    """The quantizing write: 16 decode lanes (lanes 13-15 inactive on page 0)
    and the 1040 rows of a ragged stream (the last 3 padding on page 0),
    into int8 [2048, 16, 8, 128] pools with bf16 scales; exact against its
    plain version."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw
    from polykey_tpu_torch.ops.paged_attention import quantize_kv_rows

    N, ps, Hk, D, P = 2048, 16, 8, 128, 256
    pools = [quantize_kv_rows(_randn((N, ps, Hk, D), gen)) for _ in range(2)]
    cases = []
    for B in (16, 1040):
        k_new, v_new = _randn((B, 1, Hk, D), gen), _randn((B, 1, Hk, D), gen)
        k_new[1] = 0.0                                   # an all-zero row
        positions, tables = _write_slots(gen, B, N, ps, P, 3)
        kern = [(v.clone(), s.clone()) for v, s in pools]
        plain = [(v.clone(), s.clone()) for v, s in pools]
        pw.paged_write_int8_cuda(*kern, k_new, v_new, tables, positions)
        pw.paged_write_int8_plain(*plain, k_new, v_new, tables, positions)
        sync()
        diff = [int((a[1:].view(torch.int8) != b[1:].view(torch.int8)).sum())
                for ka, kb in zip(kern, plain) for a, b in zip(ka, kb)]
        check(sum(diff) == 0, f"int8 write B={B} differs from plain in {diff} bytes")
        say("kernels", f"paged_write_int8 B={B} bf16 rows into int8 pools [{N},{ps},"
            f"{Hk},{D}] + bf16 scales: bytes differing from plain {sum(diff)} "
            "(tolerance 0: the quantizer is exact)")
        page_ids, offsets = pw._slots(tables, positions, ps)
        (kq, ks), (vq, vs) = kern

        def library():
            for (values, scales), new in (((kq, ks), k_new), ((vq, vs), v_new)):
                q8, sc = quantize_kv_rows(new[:, 0])
                values.index_put_((page_ids, offsets), q8)
                scales.index_put_((page_ids, offsets), sc)

        cases.append(_write_case(
            "paged_write_int8 (library: quantize + index_put_ x4)", B, 0.0,
            lambda: pw.paged_write_int8_cuda(*kern, k_new, v_new, tables, positions),
            lambda: pw.paged_write_int8_plain(*plain, k_new, v_new, tables, positions),
            library,
            2 * B * Hk * D * 2 + 2 * B * Hk * (D + 2) + 2 * B * 4))
    return {**cases[0], "stream": cases[1]}     # 16 lanes; the stream beside


def _int8_pools(k_pool, v_pool, stale):
    """Quantize bf16 pools into (values, scales) pairs; `stale` [N, ps]
    rows are unwritten slots, whose scales hold NaN."""
    from polykey_tpu_torch.ops.paged_attention import quantize_kv_rows

    pairs = [quantize_kv_rows(torch.nan_to_num(p, nan=0.0)) for p in (k_pool, v_pool)]
    for _, scales in pairs:
        scales[stale] = float("nan")
    return pairs


def _decode_case(gen, D, Hq, Hk, ctx_lens, softcap, window, page_range, int8):
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    ps, P = PAGE_SIZE, TABLE
    B = len(ctx_lens)
    pages = [-(-n // ps) for n in ctx_lens]
    N = sum(pages) + 1
    k_pool = _randn((N, ps, Hk, D), gen)
    v_pool = _randn((N, ps, Hk, D), gen)
    # Stale K and V rows past each position hold NaN: masked rows must never
    # reach the sums (0 x NaN would poison them).
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    order = (torch.randperm(N - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    used = 0
    for b, (n, npg) in enumerate(zip(ctx_lens, pages)):
        tables[b, :npg] = order[used: used + npg]
        used += npg
        last = int(tables[b, npg - 1])
        tail = n - (npg - 1) * ps
        k_pool[last, tail:] = float("nan")
        v_pool[last, tail:] = float("nan")
    if int8:
        k_pool, v_pool = _int8_pools(k_pool, v_pool, torch.isnan(v_pool).any(-1).any(-1))
    q = _randn((B, Hq, D), gen)
    pos = torch.tensor([n - 1 for n in ctx_lens], dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, logit_softcap=softcap, window=window,
              page_range=page_range)
    acc, m, l = pak.paged_decode_cuda(q, k_pool, v_pool, tables, pos, **kw)
    acc_p, m_p, l_p = pak.paged_decode_plain(q, k_pool, v_pool, tables, pos, **kw)
    tol = pak.decode_error_bound(q, k_pool, v_pool, tables, pos, **kw)
    sync()
    out = acc / torch.clamp(l, min=1e-9)
    out_p = acc_p / torch.clamp(l_p, min=1e-9)
    check(bool(torch.isfinite(out).all()), "decode kernel output is not finite")
    diff = (out - out_p).abs()
    err, err_m = diff.max().item(), (m - m_p).abs().max().item()
    ratio = (diff / tol).max().item()
    check(ratio <= 1.0 and err <= 2e-3 and err_m <= 1e-3,
          f"decode kernel differs from plain: out {err} (largest err/tol {ratio}), "
          f"m {err_m}")
    # Rows this run's data needs: [max(0, pos - window + 1), pos] within
    # the page range; each read once, plus the page ids of their pages.
    rlo, rhi = page_range or (0, P)
    split = pak.split_pages(ps, int8)
    visible = read_pages = busy_ctas = merged = 0
    for n in ctx_lens:
        first = max(n - window, 0) if window else 0
        rows = max(0, min(n, rhi * ps) - max(first, rlo * ps))
        visible += rows
        read_pages += -(-rows // ps)
        lo, hi = max(first // ps, rlo), min(-(-n // ps), rhi)
        splits = len({(p - rlo) // split for p in range(lo, hi)})
        busy_ctas += Hk * splits
        merged += Hk * (splits > 1)
    grid = Hk * B * max(1, -(-(rhi - rlo) // split))
    row = Hk * (D + 2) if int8 else Hk * D * 2      # one K or V row, scales incl.
    nbytes = (2 * visible * row + B * Hq * D * 2 + B * Hq * (D + 2) * 4
              + read_pages * 4 + B * 4)
    flops = 4 * Hq * D * visible
    ctas = (f"one launch: {busy_ctas} of the grid's {grid} CTAs hold rows and work "
            f"(the rest return at once); {merged} (sequence, kv head) merges in the launch")
    return (q, k_pool, v_pool, tables, pos, kw), (err, ratio), nbytes, flops, ctas


def kernel_decode(gen, int8: bool = False) -> dict:
    """The decode kernel, or with `int8` its int8 variant over pools
    quantized from the same kind of data (stale scales NaN)."""
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
        ("serve: 16 lanes at context 512", 128, 32, 8, [512] * 16, None, None, None),
    ]
    result = None
    for label, D, Hq, Hk, lens, softcap, window, prange in cases:
        args, (err, ratio), nbytes, flops, ctas = _decode_case(
            gen, D, Hq, Hk, lens, softcap, window, prange, int8)
        q, kp, vp, tables, pos, kw = args
        ms = device_time_ms(lambda: pak.paged_decode_cuda(q, kp, vp, tables, pos, **kw))
        plain = device_time_ms(
            lambda: pak.paged_decode_plain(q, kp, vp, tables, pos, **kw), reps=2)
        b_ms, b_by = bound_ms(nbytes, flops)
        name = "paged_attention_decode_int8" if int8 else "paged_attention_decode"
        pools = "int8 pools + bf16 scales" if int8 else "bf16 pools"
        why = ("int8 values exact in fp16 on tensor cores, each probability times its "
               "V scale rounded to fp16 once, fp32 sums" if int8 else
               "bf16 q, K and V exact on tensor cores, each probability in two bf16 "
               "halves (bf16(p) and bf16(p - bf16(p)), within 2^-16 p), fp32 sums")
        say("kernels", f"{name} [{label}] B={len(lens)} Hq={Hq} "
            f"Hk={Hk} D={D} ps=16 P=256, {pools}, ctx {min(lens)}..{max(lens)}: "
            f"max |err| {err:.3e}, largest err/tol {ratio:.3f} (tolerance per element "
            "of the normalized output 2^-11 sum p|v| / l + 2^-25 sum |v8| / l + "
            f"1e-5 (1 + sum p|v| / l), and 2e-3 flat, 1e-3 on m: {why}); "
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


def _flash_positions(layout: str, B: int, T: int):
    """"mixed": row 0 prefills positions 0..T-1; row 1 a prompt that starts
    mid-window at 1000 and whose last quarter is padding (position -1).
    "chunk3": every row a 512-token chunk at positions 1024..1535, the
    third chunk of the serve's document."""
    qpos = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    if layout == "chunk3":
        return qpos + 1024
    qpos[1] += 1000
    qpos[1, T - T // 4:] = -1
    return qpos


def _nan_unseen(x, qpos, window):
    """NaN in every window row no query of its batch row sees (past the
    largest position, before the smallest one's window): stale slots."""
    x = x.clone()
    for b in range(x.shape[0]):
        valid = qpos[b][qpos[b] >= 0]
        x[b, int(valid.max()) + 1:] = float("nan")
        if window:
            x[b, :max(0, int(valid.min()) - window + 1)] = float("nan")
    return x


def kernel_flash(gen) -> dict:
    from polykey_tpu_torch.ops import flash_attention as fa

    cases = [
        ("main", 2, 512, 4096, 32, 8, 128, None, None, "mixed", False),
        ("T=128", 2, 128, 4096, 32, 8, 128, None, None, "mixed", False),
        ("softcap 50, window 1024", 2, 512, 4096, 32, 8, 128, 50.0, 1024, "mixed", False),
        ("D=64", 2, 512, 4096, 32, 8, 64, None, None, "mixed", False),
        ("D=256", 2, 512, 4096, 16, 8, 256, None, None, "mixed", False),
        ("document chunk 3, positions 1024..1535", 1, 512, 4096, 32, 8, 128, None,
         None, "chunk3", False),
        ("short bucket", 4, 128, 4096, 32, 8, 128, None, None, "mixed", False),
        ("stale rows NaN, window 1024", 2, 512, 4096, 32, 8, 128, None, 1024, "mixed",
         True),
    ]
    result = None
    for label, B, T, S, Hq, Hk, D, softcap, window, layout, stale in cases:
        q = _randn((B, T, Hq, D), gen)
        k = _randn((B, S, Hk, D), gen)
        v = _randn((B, S, Hk, D), gen)
        qpos = _flash_positions(layout, B, T)
        kw = dict(scale=D ** -0.5, logit_softcap=softcap, window=window)
        # The stale case feeds the kernel NaN where no query looks and
        # holds it to the plain version over the same window with 0 there.
        if stale:
            kk, vk = _nan_unseen(k, qpos, window), _nan_unseen(v, qpos, window)
            k, v = torch.nan_to_num(kk, nan=0.0), torch.nan_to_num(vk, nan=0.0)
        else:
            kk, vk = k, v
        out = fa.flash_attention_cuda(q, kk, vk, qpos, **kw)
        ref = fa.flash_attention_plain(q, k, v, qpos, **kw).float()
        # Per element: each side rounds every probability and its output to
        # bf16 once (unit roundoff 2^-8), so the two may differ by
        # 2^-7 (|out| + sum_i p_i |v_i|); the second term is the plain
        # attention over |V|. 1e-4 covers fp32 sums in another order.
        ref_abs = fa.flash_attention_plain(q, k, v.abs(), qpos, **kw).float()
        tol = 2.0 ** -7 * (ref.abs() + ref_abs) + 1e-4
        sync()
        check(bool(torch.isfinite(out.float()).all()), f"flash [{label}] output is not finite")
        check(bool((out[qpos < 0] == 0).all()), f"flash [{label}] padding rows are not 0")
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        # Each batch row apart, so the small outputs of long rows are held
        # to their own scale.
        ratio = [(diff[b] / tol[b]).max().item() for b in range(B)]
        check(max(ratio) <= 1.0, f"flash kernel [{label}] differs from plain beyond "
              f"tolerance: largest err/tol per batch row {ratio}")
        ms = device_time_ms(lambda: fa.flash_attention_cuda(q, kk, vk, qpos, **kw))
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
        rows = ", ".join(f"{r:.3f}" for r in ratio)
        say("kernels", f"flash_attention [{label}] B={B} T={T} S={S} Hq={Hq} Hk={Hk} "
            f"D={D}: max |err| {err:.3e}, largest err/tol per batch row {rows} "
            "(tolerance per element 2^-7 (|ref| + "
            "sum p|v|) + 1e-4: bf16 probabilities and output rounded once on "
            "each side, fp32 accumulation in another order); kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
        else:
            result["max_abs_err"] = max(result["max_abs_err"], err)
    return result


def _ragged_case(gen, lens, kvs, T, empty, int8):
    """Ranges from row 0 in order, `empty` unused ranges past the stream,
    pools [2048, 16, 8, 128] bf16 with distinct pages per sequence and NaN
    in the unwritten V rows of each sequence's last page."""
    N, ps, Hk, Hq, D = 2048, PAGE_SIZE, 8, 32, 128
    starts = [sum(lens[:i]) for i in range(len(lens))] + [T] * empty
    lens, kvs = list(lens) + [0] * empty, list(kvs) + [0] * empty
    k_pool = _randn((N, ps, Hk, D), gen)
    v_pool = _randn((N, ps, Hk, D), gen)
    tables = torch.zeros((len(lens), TABLE), dtype=torch.int32, device="cuda")
    order = (torch.randperm(N - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    used = 0
    for s, kv in enumerate(kvs):
        npg = -(-kv // ps)
        if npg:
            tables[s, :npg] = order[used: used + npg]
            used += npg
            v_pool[int(tables[s, npg - 1]), kv - (npg - 1) * ps:] = float("nan")
    if int8:
        k_pool, v_pool = _int8_pools(k_pool, v_pool, torch.isnan(v_pool).any(-1).any(-1))
    q = _randn((T, Hq, D), gen)
    meta = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (starts, lens, kvs)]
    return (q, k_pool, v_pool, tables, *meta), (starts, lens, kvs)


def kernel_ragged(gen, int8: bool = False) -> dict:
    """The ragged kernel, or with `int8` its int8 variant over pools
    quantized from the same kind of data (stale scales NaN)."""
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    Hq, Hk, D = 32, 8, 128
    ctx = [1, 15, 16, 17, 31, 33, 255, 256, 257, 1000, 1024, 2047, 2049,
           3001, 4095, 4096]
    singles = [1] * len(ctx)
    cases = [
        # 16 decode singles, a first chunk (kv 512), a second chunk (kv 1024).
        ("main", singles + [512, 512], ctx + [512, 1024], 1040, 14, None, None),
        ("softcap 50, window 1024", singles + [512, 512], ctx + [512, 1024], 1040, 14,
         50.0, 1024),
        # A 300-token tail range at KV length 1800, 724 padding rows.
        ("tail + padding", singles + [300], ctx + [1800], 1040, 15, None, None),
        # profile_decode --ragged's dispatch: 16 lanes at context 512, a
        # first chunk (kv 512) and a second (kv 1024).
        ("serve: 16 lanes at context 512", singles + [512, 512], [512] * 16 + [512, 1024],
         1040, 14, None, None),
        # The main case's singles alone: the byte-bound part of the stream.
        ("singles: the main case's 16 alone", singles, ctx, 16, 16, None, None),
    ]
    result = None
    for label, lens, kvs, T, empty, softcap, window in cases:
        args, (starts, lens_, kvs_) = _ragged_case(gen, lens, kvs, T, empty, int8)
        work = rk.ragged_work(starts, lens_, kvs_, T, Hq // Hk, Hk, "cuda")
        kw = dict(scale=D ** -0.5, logit_softcap=softcap, window=window)
        out = rk.ragged_attention_cuda(*args, work=work, **kw)
        ref = rk.ragged_attention_plain(*args, **kw)
        # Per element: the kernel rounds each probability to bf16 once (unit
        # roundoff 2^-8; for int8 the probability times its V scale, over
        # V values exact in bf16), so it may differ from the fp32 plain
        # version by 2^-8 sum p|v| / l over the (dequantized) V; the plain
        # attention over |V| gives that sum, and the factor 2 and 1e-4 cover
        # exp and fp32 sums in another order.
        v_abs = (args[2][0].abs(), args[2][1]) if int8 else args[2].abs()
        ref_abs = rk.ragged_attention_plain(*args[:2], v_abs, *args[3:], **kw)
        tol = 2.0 ** -7 * ref_abs + 1e-4
        sync()
        used = sum(lens)
        check(bool(torch.isfinite(out).all()), "ragged output is not finite")
        check(bool((out[used:] == 0).all()), "ragged padding rows are not 0")
        err = (out - ref).abs().max().item()
        ratio = ((out - ref).abs() / tol).max().item()
        check(ratio <= 1.0, f"ragged kernel differs from plain beyond tolerance: "
              f"largest err/tol {ratio}")
        ms = device_time_ms(lambda: rk.ragged_attention_cuda(*args, work=work, **kw))
        plain = device_time_ms(lambda: rk.ragged_attention_plain(*args, **kw), reps=2)
        # What this run's data needs: each query row sees keys
        # [max(0, p - window + 1), p]; each sequence's K and V rows are read
        # once over the union of its rows' spans.
        kv_rows = pairs = 0
        for st, ln, kv in zip(starts, lens_, kvs_):
            n = max(0, min(st + ln, T) - st)
            if n == 0:
                continue
            p0, p1 = kv - ln, kv - ln + n - 1
            lo = max(0, p0 - window + 1) if window else 0
            kv_rows += p1 + 1 - lo
            pairs += sum(min(p + 1, window) if window else p + 1
                         for p in range(p0, p1 + 1))
        row = Hk * (D + 2) if int8 else Hk * D * 2    # one K or V row, scales incl.
        nbytes = 2 * kv_rows * row + T * Hq * D * (2 + 4)
        flops = 4 * pairs * Hq * D
        b_ms, b_by = bound_ms(nbytes, flops)
        name = "ragged_paged_attention_int8" if int8 else "ragged_paged_attention"
        pools = "int8 pools + bf16 scales" if int8 else "bf16 pools"
        items = work.items.cpu()
        split = len({(s, r) for s, r, _, _, ns, _ in items.tolist() if ns > 1})
        say("kernels", f"{name} [{label}] T={T} Hq={Hq} Hk={Hk} "
            f"D={D} ps=16 P=256, {pools}, {len(items)} work items x {Hk} kv heads, "
            f"{split} split into {work.n_part} shares, merged in the launch: "
            f"max |err| {err:.3e}, largest err/tol "
            f"{ratio:.3f} (tolerance per element 2^-7 sum p|v| + 1e-4: the "
            "kernel rounds each probability to bf16 once, the fp32 plain "
            "version does not); padding rows 0; kernel "
            f"{ms:.4f} ms ({ms / b_ms:.1f}x the bound), plain {plain:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
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
            "ragged_paged_attention": kernel_ragged(gen),
            "paged_write_int8": kernel_write_int8(gen),
            "paged_attention_decode_int8": kernel_decode(gen, int8=True),
            "ragged_paged_attention_int8": kernel_ragged(gen, int8=True),
        }
    sync()
    return results


# -- phase 4 ---------------------------------------------------------------

class _PlainPath:
    """Route the forward passes through the plain versions with the
    reference's own kill switches."""

    NAMES = ("POLYKEY_DISABLE_FLASH", "POLYKEY_DISABLE_PAGED_KERNEL",
             "POLYKEY_DISABLE_RAGGED_KERNEL", "POLYKEY_DISABLE_KV_KERNEL")

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

    def run(int8=False):
        """Logits of the sampled rows and every hidden state of the run."""
        paged = init_paged_kv(cfg, 1 + B * per, ps, torch.bfloat16, "cuda",
                              kv_dtype=torch.int8 if int8 else None)
        positions = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
        hidden, paged = forward_paged(params, cfg, tokens, positions, paged, tables)
        hiddens = [hidden.reshape(-1, hidden.shape[-1])]
        rows = torch.tensor([n - 1 for n in prompt_lens], device="cuda")
        logits = [unembed(params, cfg, hidden[torch.arange(B), rows])]
        for i in range(steps):
            pos = torch.tensor([[n + i] for n in prompt_lens], dtype=torch.int32,
                               device="cuda")
            hidden, paged = forward_paged(params, cfg, forced[i][:, None], pos,
                                          paged, tables)
            hiddens.append(hidden[:, 0])
            logits.append(unembed(params, cfg, hidden[:, 0]))
        sync()
        return torch.stack(logits), torch.cat(hiddens).float()

    bucketed = ("flash_attention", "paged_attention_decode", "paged_write")
    bucketed8 = ("flash_attention", "paged_attention_decode_int8", "paged_write_int8")
    with torch.inference_mode():
        for int8, names in ((False, bucketed), (True, bucketed8)):
            before = _launches()
            got, hidden = run(int8)
            mid = _launches()
            with _PlainPath():
                want, _ = run(int8)
            after = _launches()
            ran = {n: mid[n] - before[n] for n in mid if mid[n] > before[n]}
            check(set(ran) == set(names),
                  f"the kernel run launched {ran}, not each of {names} alone")
            check(after == mid, f"the plain run launched kernels: {mid} -> {after}")
            check(bool(torch.isfinite(got).all()), "slice logits are not finite")
            err = (got - want).abs().max().item()
            rms = want.square().mean().sqrt().item()
            agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            kv = "int8 KV" if int8 else "bf16 KV"
            say("slice", f"llama-3-8b width, 2 layers, bf16 weights, {kv}: prefill "
                f"T={T} (prompts {prompt_lens}) + {steps} decode steps, kernels vs "
                f"plain: max |dlogit| {err:.4f} over logits of RMS {rms:.3f} "
                f"(tolerance 0.12, about twice the 0.055 measured on the H100 for "
                f"bf16 KV: bf16 activations round differently once attention sums "
                f"in another order); argmax agreement {agree:.3f} (must be 1); "
                f"kernel launches in the kernel run {ran}")
            check(err <= 0.12, f"slice logits differ by {err}")
            check(agree == 1.0, f"slice argmax agrees on only {agree:.3f} of the rows")
            if int8:
                _kv_gap("forward_paged", hidden, hidden_bf16)
            else:
                hidden_bf16 = hidden
    _slice_ragged(cfg, params, gen)
    del params
    torch.cuda.empty_cache()


def _kv_gap(label: str, hidden_int8, hidden_bf16) -> None:
    """The reference's int8-KV accuracy gate (tests/test_kv_cache.py,
    test_forward_paged_int8_kv_tracks_fp): the largest hidden-state gap
    between int8 and bf16 KV on the same tokens, relative to the largest
    bf16 hidden value, under 0.05."""
    check(bool(torch.isfinite(hidden_int8).all()), f"{label} int8 hidden not finite")
    gap = ((hidden_int8 - hidden_bf16).abs().max()
           / (hidden_bf16.abs().max() + 1e-6)).item()
    say("slice", f"{label}, int8 KV vs bf16 KV on the same tokens, kernels: largest "
        f"|dh| / max |h| {gap:.5f} over {hidden_bf16.shape[0]} hidden rows "
        f"(tolerance 0.05, the reference's int8-KV accuracy gate)")
    check(gap < 0.05, f"{label}: int8 KV hidden states differ from bf16 by {gap}")


def _slice_ragged(cfg, params, gen) -> None:
    """Mixed prefill+decode through forward_ragged: a first dispatch
    prefills prompts A (100 tokens) and B (77); the next four decode A and
    B one token each, and the first of them also prefills prompt C (200
    tokens), which decodes in the last three. Logits of the rows that
    sample: kernels against plain, and against forward_paged over the same
    tokens (prefill per prompt, then batched decode steps)."""
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.transformer import (
        forward_paged, forward_ragged, unembed,
    )
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    ps, P, steps = 16, 256, 4
    lens = {"A": 100, "B": 77, "C": 200}
    prompts = {k: torch.randint(3, 259, (n,), generator=gen, device="cuda",
                                dtype=torch.int32) for k, n in lens.items()}
    forced = torch.randint(3, 259, (steps, 3), generator=gen, device="cuda",
                           dtype=torch.int32)
    per = -(-(max(lens.values()) + steps) // ps)
    tables = {k: torch.zeros(P, dtype=torch.int32, device="cuda") for k in lens}
    for i, k in enumerate(lens):
        tables[k][:per] = torch.arange(1 + i * per, 1 + (i + 1) * per)
    num_pages = 1 + 3 * per

    def dispatches():
        """Per dispatch: [(seq, tokens, first position)] ranges."""
        out = [[("A", prompts["A"], 0), ("B", prompts["B"], 0)]]
        for i in range(steps):
            live = ["A", "B"] + (["C"] if i else [])
            ranges = [(k, forced[i, j:j + 1], lens[k] + i - (1 if k == "C" else 0))
                      for j, k in enumerate(live)]
            if i == 0:
                ranges.append(("C", prompts["C"], 0))
            out.append(ranges)
        return out

    def run_ragged(int8=False):
        paged = init_paged_kv(cfg, num_pages, ps, torch.bfloat16, "cuda",
                              kv_dtype=torch.int8 if int8 else None)
        logits, hiddens = [], []
        for ranges in dispatches():
            toks = torch.cat([t for _, t, _ in ranges])
            used = toks.shape[0]
            T = -(-used // rk.TOKEN_TILE) * rk.TOKEN_TILE
            tokens = torch.zeros(T, dtype=torch.int32, device="cuda")
            tokens[:used] = toks
            positions = torch.zeros(T, dtype=torch.int32, device="cuda")
            token_tables = torch.zeros((T, P), dtype=torch.int32, device="cuda")
            starts, seq_lens, kvs, rows = [], [], [], []
            off = 0
            for k, t, p0 in ranges:
                n = t.shape[0]
                positions[off:off + n] = torch.arange(p0, p0 + n)
                token_tables[off:off + n] = tables[k]
                starts.append(off)
                seq_lens.append(n)
                kvs.append(p0 + n)
                rows.append(off + n - 1)
                off += n
            meta = [torch.tensor(x, dtype=torch.int32, device="cuda")
                    for x in (starts, seq_lens, kvs)]
            seq_tables = torch.stack([tables[k] for k, _, _ in ranges])
            work = rk.ragged_work(starts, seq_lens, kvs, T,
                                  cfg.num_heads // cfg.num_kv_heads, cfg.num_kv_heads,
                                  "cuda")
            hidden, paged = forward_ragged(params, cfg, tokens, positions, paged,
                                           token_tables, *meta, seq_tables, work=work)
            logits.append(unembed(params, cfg, hidden[torch.tensor(rows, device="cuda")]))
            hiddens.append(hidden[:used])
        sync()
        return torch.cat(logits), torch.cat(hiddens).float()

    def run_paged():
        paged = init_paged_kv(cfg, num_pages, ps, torch.bfloat16, "cuda")
        logits = []
        for ranges in dispatches():
            rows = []
            singles = [(k, t, p0) for k, t, p0 in ranges if t.shape[0] == 1]
            if singles:
                hidden, paged = forward_paged(
                    params, cfg, torch.stack([t for _, t, _ in singles]),
                    torch.tensor([[p0] for _, _, p0 in singles], dtype=torch.int32,
                                 device="cuda"),
                    paged, torch.stack([tables[k] for k, _, _ in singles]))
                rows.append(hidden[:, 0])
            for k, t, p0 in ranges:
                if t.shape[0] > 1:
                    pos = torch.arange(p0, p0 + t.shape[0], dtype=torch.int32,
                                       device="cuda")[None]
                    hidden, paged = forward_paged(params, cfg, t[None], pos, paged,
                                                  tables[k][None])
                    rows.append(hidden[:, -1])
            logits.append(unembed(params, cfg, torch.cat(rows)))
        sync()
        return torch.cat(logits)

    with torch.inference_mode():
        before = _launches()
        got, hidden_bf16 = run_ragged()
        mid = _launches()
        with _PlainPath():
            want, _ = run_ragged()
        after = _launches()
        paged_ref = run_paged()
    name = "ragged_paged_attention"
    check(mid[name] > before[name] and mid["paged_write"] > before["paged_write"],
          f"the ragged kernel run skipped a kernel: {before} -> {mid}")
    check(after == mid, f"the plain ragged run launched kernels: {mid} -> {after}")
    check(bool(torch.isfinite(got).all()), "ragged slice logits are not finite")
    rms = want.square().mean().sqrt().item()
    for label, ref in (("plain forward_ragged", want), ("forward_paged", paged_ref)):
        err = (got - ref).abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        say("slice", f"llama-3-8b width, 2 layers, bf16, forward_ragged with kernels "
            f"vs {label}: 1 prefill dispatch (A 100, B 77 tokens) + {steps} mixed "
            f"dispatches (A, B decode; C 200-token prefill, then decode), "
            f"{got.shape[0]} sampled rows: max |dlogit| {err:.4f} over logits of RMS "
            f"{rms:.3f} (tolerance 0.12, the bucketed slice's bound); argmax "
            f"agreement {agree:.3f} (must be 1); ragged kernel launches "
            f"{mid[name] - before[name]} in the kernel run, "
            f"{after[name] - mid[name]} in the plain run")
        check(err <= 0.12, f"ragged slice logits differ from {label} by {err}")
        check(agree == 1.0, f"ragged slice argmax agrees with {label} on only "
              f"{agree:.3f} of the rows")

    # The same dispatches over int8 KV: the int8 ragged and write kernels
    # alone, against their plain versions and against bf16 KV.
    names8 = ("ragged_paged_attention_int8", "paged_write_int8")
    with torch.inference_mode():
        before = _launches()
        got8, hidden_int8 = run_ragged(int8=True)
        mid = _launches()
        with _PlainPath():
            want8, _ = run_ragged(int8=True)
        after = _launches()
    ran = {n: mid[n] - before[n] for n in mid if mid[n] > before[n]}
    check(set(ran) == set(names8), f"the int8 ragged run launched {ran}, not {names8}")
    check(after == mid, f"the plain int8 ragged run launched kernels: {mid} -> {after}")
    check(bool(torch.isfinite(got8).all()), "int8 ragged slice logits are not finite")
    err = (got8 - want8).abs().max().item()
    agree = (got8.argmax(-1) == want8.argmax(-1)).float().mean().item()
    say("slice", f"llama-3-8b width, 2 layers, bf16 weights, int8 KV, forward_ragged "
        f"with kernels vs plain, the same {steps + 1} dispatches: max |dlogit| "
        f"{err:.4f} over logits of RMS {want8.square().mean().sqrt().item():.3f} "
        f"(tolerance 0.12, the bf16 slices' bound); argmax agreement {agree:.3f} "
        f"(must be 1); kernel launches {ran}")
    check(err <= 0.12, f"int8 ragged slice logits differ from plain by {err}")
    check(agree == 1.0, f"int8 ragged slice argmax agrees on only {agree:.3f}")
    _kv_gap("forward_ragged", hidden_int8, hidden_bf16)


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
# About 1500 tokens (the byte tokenizer: one per byte, plus BOS): past the
# largest bucket, so it prefills in three chunks of up to 512 tokens.
DOCUMENT = (
    "Section {}. The service keeps a pool of key and value pages on the card "
    "and gives each request a table of page ids; a prompt longer than the "
    "largest bucket prefills one chunk at a time while other requests go on "
    "decoding, and its first token is sampled from the last chunk. Pages "
    "return on finish. "
)
LONG_DOC = "".join(DOCUMENT.format(i) for i in range(5)) + "Summarize the document."


def _struct(**kv):
    from google.protobuf import struct_pb2

    s = struct_pb2.Struct()
    s.update(kv)
    return s


# The kernels each serve phase must launch; every other kernel must not.
SERVE_KERNELS = {
    (False, False): ("flash_attention", "paged_attention_decode", "paged_write"),
    (True, False): ("ragged_paged_attention", "paged_attention_decode", "paged_write"),
    (False, True): ("flash_attention", "paged_attention_decode_int8", "paged_write_int8"),
    (True, True): ("ragged_paged_attention_int8", "paged_attention_decode_int8",
                   "paged_write_int8"),
}


def phase_serve(seed: int, card: str, ragged: bool = False, params=None,
                int8: bool = False) -> dict:
    """Serve through gRPC. Bucketed (default) or ragged dispatch, over bf16
    or (`int8`) int8 KV; `params` reuses the weights of an earlier engine
    (shut down first)."""
    import grpc

    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, GenRequest, InferenceEngine
    from polykey_tpu_torch.gateway.jsonlog import Logger
    from polykey_tpu_torch.gateway.server import build_server
    from polykey_tpu_torch.gateway.torch_service import TorchService
    from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
    from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

    phase = ("ragged" if ragged else "serve") + ("-int8" if int8 else "")
    config = EngineConfig(model="llama-3-8b", ragged_dispatch=ragged,
                          kv_dtype="int8" if int8 else "")
    t0 = time.monotonic()
    engine = InferenceEngine(config, params=params, device="cuda", seed=seed)
    sync()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params))
    kv = engine.paged.nbytes
    mode = (f"ragged dispatch, stream width {engine.stats()['ragged_width']} "
            f"(prefill budget {engine.stats()['prefill_budget']})" if ragged
            else f"buckets {config.prefill_buckets}, chunks of 512")
    say(phase, f"engine up in {time.monotonic() - t0:.1f} s: {config.model}, "
        f"{len(engine.params['layers'])} layers, bf16 weights {nbytes / 2**30:.2f} "
        f"GiB, KV pool {kv / 2**30:.4f} GiB ({engine.stats()['kv_dtype']}"
        f"{', scales included' if int8 else ''}; {config.num_pages} pages x "
        f"{config.page_size}), {config.max_decode_slots} slots, {mode}, decode "
        f"block {config.decode_block_steps}")
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
        check(config.lookahead_blocks == 2 and config.adaptive_block,
              f"not the default pipeline: {config}")
        before = engine.stats()
        for k in KERNELS.values():
            k.launches = 0
        results = _serve_requests(stub, pk, submitted)
        counts = {name: k.launches for name, k in KERNELS.items()}
        stats = engine.stats()
        sync()
        say(phase, f"kernel launches in this phase: {counts}")
        replays = stats["decode_graph_replays"] - before["decode_graph_replays"]
        prefills = stats["prefill_graph_replays"] - before["prefill_graph_replays"]
        say(phase, f"graphs captured at start in {stats['graph_capture_s']:.2f} s: "
            f"{stats['decode_graph_captures']} decode, {stats['prefill_graph_captures']} "
            f"prefill, one pool of {stats['graph_pool_bytes'] / 2**20:.1f} MiB "
            f"(decode and prefill together) on {card}")
        say(phase, f"decode graphs: {replays} "
            f"replays in this phase; lookahead depth {stats['lookahead_depth']}, "
            f"observed max {stats['lookahead_observed_max']} (mean "
            f"{stats['lookahead_observed_mean']}; {stats['blocks_overlapped']} of "
            f"{stats['blocks_processed']} blocks overlapped); host stall p50 "
            f"{stats.get('host_stall_ms_p50', 'not measured')} ms, p95 "
            f"{stats.get('host_stall_ms_p95', 'not measured')} ms")
        check(stats["decode_graph_captures"] == 4,
              f"{stats['decode_graph_captures']} decode graphs captured, not 4")
        check(replays > 0, "no decode graph was replayed in this phase")
        layers = len(engine.params["layers"])
        if ragged:
            behind = (stats["ragged_behind_inflight"]
                      - before["ragged_behind_inflight"])
            say(phase, f"ragged dispatches: {stats['ragged_dispatches'] - before['ragged_dispatches']}"
                f" in this phase, {behind} of them dispatched with another block "
                f"in flight")
            check(behind > 0, "no ragged dispatch went out with another block in flight")
        else:
            eager = stats["prefill_eager"] - before["prefill_eager"]
            say(phase, f"prefill graphs: {prefills} replays in this phase, {eager} "
                f"prefills run eagerly; flash launches {counts['flash_attention']} "
                f"= {layers} layers x {counts['flash_attention'] / layers:.0f}")
            check(stats["prefill_graph_captures"] == 16,
                  f"{stats['prefill_graph_captures']} prefill graphs captured, not 16")
            check(prefills > 0 and eager == 0,
                  f"prefills: {prefills} graph replays, {eager} eager")
            # Flash runs only in the prefill: every launch came from a replay.
            check(counts["flash_attention"] == layers * prefills,
                  f"{counts['flash_attention']} flash launches for {prefills} prefill "
                  f"replays of {layers} layers")
        # The ragged modes' prefills ride the stream (flash 0); int8 KV
        # runs only the int8 variants, bf16 KV only the bf16 ones.
        want = SERVE_KERNELS[(ragged, int8)]
        check(all(counts[n] > 0 for n in want),
              f"a kernel of this path was not launched: {counts}")
        check(all(counts[n] == 0 for n in counts if n not in want),
              f"a kernel of another path was launched: {counts}")
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
        say(phase, f"repeated greedy prompt: identical 32 token ids "
            f"{ids[0][:8]}...")
        for r in results:
            say(phase, f"{r['label']}: status {r['status']}, prompt "
                f"{r['prompt_tokens']} tokens, {r['completion_tokens']} completion "
                f"tokens, TTFT {r['ttft_ms']:.1f} ms, {r['tok_s']:.1f} tok/s "
                f"(wall {r['wall_s']:.2f} s) on {card}")
    finally:
        channel.close()
        server.stop(grace=5).wait()
        service.close()
    sync()
    return {"requests": results, "launches": counts, "params": engine.params,
            "kv_gib": kv / 2**30}


# -- phase 8 ---------------------------------------------------------------

def phase_graph(seed: int, params, card: str, turns: int = 3) -> None:
    """The full-depth decode block eager and as its graph's replay, from the
    same lanes: identical tokens and lane state, then walls and idle shares
    in turns."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.tools.profile_decode import (
        LANES,
        decode_block,
        decode_lanes,
        device_kernels,
    )

    econf = EngineConfig(model="llama-3-8b")
    cfg = get_config(econf.model)
    steps, context = econf.decode_block_steps, 512
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for int8 in (False, True):
        kv = "int8 KV" if int8 else "bf16 KV"
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        paged, state = decode_lanes(econf, cfg, context, gen, int8)
        with torch.inference_mode():
            eager, reset = decode_block(params, cfg, paged, state, steps)
            graph, _ = decode_block(params, cfg, paged, state, steps, graph=True)
            out = {}
            for name, run in (("eager", eager), ("graph", graph)):
                reset()
                packed = run().clone()
                out[name] = (packed, {k: state[k].clone() for k in LANES})
            sync()
            check(torch.equal(out["graph"][0], out["eager"][0]),
                  f"{kv}: the graph's packed tokens differ from the eager block's")
            check(all(torch.equal(out["graph"][1][k], out["eager"][1][k]) for k in LANES),
                  f"{kv}: the graph's lane state differs from the eager block's")
            tokens = out["eager"][0]
            check(bool((tokens >= 0).all()), f"{kv}: a live lane emitted nothing")
            walls, idle = {"eager": [], "graph": []}, {"eager": [], "graph": []}
            for turn in range(2 * turns):
                name = ("eager", "graph", "graph", "eager")[turn % 4]
                run = eager if name == "eager" else graph
                reset()
                sync()
                t0 = time.perf_counter()
                run()
                sync()
                wall = (time.perf_counter() - t0) * 1e3
                reset()
                sync()
                with torch.profiler.profile(activities=acts) as prof:
                    run()
                    sync()
                busy = sum(e.time_range.elapsed_us() for e in device_kernels(prof)) / 1e3
                walls[name].append(wall / steps)
                idle[name].append(1 - busy / wall if busy else float("nan"))
        del paged, state
        say("graph", f"llama-3-8b 32 layers bf16, {kv}, 16 greedy lanes at context "
            f"{context}, block of {steps}: graph replay and eager block identical "
            f"(packed [{steps}, 16] tokens {tokens[0, :4].tolist()}..., lane state)")
        for name in ("eager", "graph"):
            w, i = walls[name], idle[name]
            say("graph", f"{kv}, {name}: wall per step median {statistics.median(w):.3f} "
                f"ms (range {min(w):.3f}-{max(w):.3f}), idle share median "
                f"{statistics.median(i):.3f} (range {min(i):.3f}-{max(i):.3f}), "
                f"{len(w)} runs, on {card}")


# -- phase 9 ---------------------------------------------------------------

def phase_prefill_graph(seed: int, params, card: str, turns: int = 3) -> None:
    """The full-depth bucketed prefill (width 512 at positions 1024..1535,
    group pads 1 and 8, greedy) eager and as its graph's replay from the
    same pools: identical tokens and KV pages, then walls and idle shares
    in turns."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.tools.profile_decode import (
        device_kernels,
        prefill_block,
        prefill_inputs,
    )

    econf = EngineConfig(model="llama-3-8b")
    cfg = get_config(econf.model)
    T, context = max(econf.prefill_buckets), 1024
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for int8 in (False, True):
        kv = "int8 KV" if int8 else "bf16 KV"
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        paged = init_paged_kv(cfg, econf.num_pages, econf.page_size, torch.bfloat16,
                              "cuda", kv_dtype=torch.int8 if int8 else None)
        pools = [t for t in (paged.k, paged.v, paged.ks, paged.vs) if t is not None]
        for n in (1, 8):
            ops = prefill_inputs(econf, cfg, T, context, n, gen)
            tables = ops.views(T)[3]
            pages = torch.unique(tables[tables > 0]).long()
            with torch.inference_mode():
                eager = prefill_block(params, cfg, paged, ops, T)
                graph = prefill_block(params, cfg, paged, ops, T, graph=True)
                # Random KV on the rows' pages: the context is read, the
                # chunk written.
                for t in pools:
                    shape = (t.shape[0], len(pages), *t.shape[2:])
                    if t.dtype == torch.int8:
                        fill = torch.randint(-127, 128, shape, generator=gen,
                                             device="cuda", dtype=torch.int8)
                    elif int8:
                        fill = (torch.rand(shape, generator=gen, device="cuda") * 0.02
                                + 1e-3).to(torch.bfloat16)
                    else:
                        fill = torch.randn(shape, generator=gen, device="cuda",
                                           dtype=torch.bfloat16)
                    t[:, pages] = fill
                    del fill
                saved = [t[:, pages].clone() for t in pools]
                out = {}
                for name, run in (("eager", eager), ("graph", graph)):
                    for t, v in zip(pools, saved):
                        t[:, pages] = v
                    tokens = run().clone()
                    out[name] = (tokens, [t[:, pages].clone() for t in pools])
                sync()
                check(torch.equal(out["graph"][0], out["eager"][0]),
                      f"{kv}, {n} rows: the graph's tokens differ from the eager prefill's")
                check(all(torch.equal(a, b) for a, b in zip(out["graph"][1], out["eager"][1])),
                      f"{kv}, {n} rows: the graph's KV pages differ from the eager prefill's")
                check(not all(torch.equal(a, b) for a, b in zip(saved, out["eager"][1])),
                      f"{kv}, {n} rows: the prefill wrote no KV")
                tokens = out["eager"][0].tolist()
                del saved, out
                walls, idle = {"eager": [], "graph": []}, {"eager": [], "graph": []}
                for turn in range(2 * turns):
                    name = ("eager", "graph", "graph", "eager")[turn % 4]
                    run = eager if name == "eager" else graph
                    sync()
                    t0 = time.perf_counter()
                    run()
                    sync()
                    wall = (time.perf_counter() - t0) * 1e3
                    with torch.profiler.profile(activities=acts) as prof:
                        run()
                        sync()
                    busy = sum(e.time_range.elapsed_us() for e in device_kernels(prof)) / 1e3
                    walls[name].append(wall)
                    idle[name].append(1 - busy / wall if busy else float("nan"))
            del graph, eager, ops
            torch.cuda.empty_cache()
            say("prefill-graph", f"llama-3-8b 32 layers bf16, {kv}, {n} x {T} tokens at "
                f"positions {context}..{context + T - 1}, greedy: graph replay and eager "
                f"prefill identical (tokens {tokens}, the KV pages of {len(pages)} pages)")
            for name in ("eager", "graph"):
                w, i = walls[name], idle[name]
                say("prefill-graph", f"{kv}, {n} rows, {name}: walls "
                    f"{', '.join(f'{x:.3f}' for x in w)} ms, idle shares "
                    f"{', '.join(f'{x:.3f}' for x in i)}; median wall "
                    f"{statistics.median(w):.3f} ms, idle {statistics.median(i):.3f}, "
                    f"on {card}")
        del paged, pools
        torch.cuda.empty_cache()


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
    """After one warm-up request per bucket, 5 concurrent requests: two
    short prompts (bucket 128), two long (bucket 512), one ~1500-token
    document (chunked prefill); one streamed, the rest unary; then the
    first greedy prompt again, which must return the same text."""
    specs = [
        ("short greedy", SHORT[0], dict(), False),
        ("short sampled stream", SHORT[1], dict(temperature=0.8, top_p=0.9,
                                                  top_k=50, seed=7), True),
        ("long greedy", LONG[0], dict(), False),
        ("long sampled", LONG[1], dict(temperature=1.0, top_p=0.95, seed=11), False),
        ("document greedy", LONG_DOC, dict(), False),
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
    serves = {}
    params = None
    for ragged, int8 in ((False, False), (True, False), (False, True), (True, True)):
        out = phase_serve(args.seed, dev["smi"], ragged=ragged, params=params,
                          int8=int8)
        params = out.pop("params")
        serves[(ragged, int8)] = out
    phase_graph(args.seed, params, dev["smi"])
    sync()
    phase_prefill_graph(args.seed, params, dev["smi"])
    sync()
    del params
    for int8 in (False, True):
        kv = "int8 KV" if int8 else "bf16 KV"
        for bucketed, rag in zip(serves[(False, int8)]["requests"],
                                 serves[(True, int8)]["requests"]):
            say("serve", f"{kv}, {bucketed['label']}: TTFT bucketed "
                f"{bucketed['ttft_ms']:.1f} ms, ragged {rag['ttft_ms']:.1f} ms; "
                f"tok/s bucketed {bucketed['tok_s']:.1f}, ragged {rag['tok_s']:.1f} "
                f"on {dev['smi']}")
    say("serve", f"KV pool: bf16 {serves[(False, False)]['kv_gib']:.4f} GiB, int8 "
        f"{serves[(False, True)]['kv_gib']:.4f} GiB (scales included)")

    from polykey_tpu_torch.engine.engine import KERNELS

    # Each kernel's launches come from the serve phase that runs it (the
    # first of SERVE_KERNELS' phases naming it).
    launches = {}
    for key, names in SERVE_KERNELS.items():
        for name in names:
            launches.setdefault(name, serves[key]["launches"][name])
    paged_src = "polykey_tpu_torch/csrc/paged_attention_decode.cu"
    ragged_src = "polykey_tpu_torch/csrc/ragged_paged_attention.cu"
    decode_tpu = "polykey_tpu/ops/paged_attention_kernel.py:349"
    ragged_tpu = "polykey_tpu/ops/ragged_paged_attention_kernel.py:387"
    write_src = "polykey_tpu_torch/csrc/paged_write.cu"
    write_tpu = "polykey_tpu/ops/paged_write_kernel.py:134"
    sources = {
        "flash_attention": ("polykey_tpu_torch/csrc/flash_attention.cu",
                            "polykey_tpu/ops/flash_attention.py:157"),
        "paged_attention_decode": (paged_src, decode_tpu),
        "paged_write": (write_src, write_tpu),
        "ragged_paged_attention": (ragged_src, ragged_tpu),
        "paged_attention_decode_int8": (paged_src, decode_tpu),
        "paged_write_int8": (write_src, write_tpu),
        "ragged_paged_attention_int8": (ragged_src, ragged_tpu),
    }
    summary = []
    for name in KERNELS:
        src, tpu = sources[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": launches[name]}
        entry.update(kernels[name])
        summary.append(entry)
    check(all(e["launches"] > 0 for e in summary), f"a kernel read 0 launches: {summary}")
    print(json.dumps({"kernels": summary}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
