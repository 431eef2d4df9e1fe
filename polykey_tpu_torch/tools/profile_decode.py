"""Where a decode step's (or a ragged dispatch's, or a prefill's) time goes, on the GPU.

    python -m polykey_tpu_torch.tools.profile_decode [--context 512] [--seed 0] [--ragged]
        [--kv-dtype int8] [--prefill [T]] [--graph] [--repeat N]

Builds the 32-layer Llama-3-8B with random bf16 weights, puts 16 live lanes
(the default EngineConfig's slots) at `context` positions of the default
paged KV pool, and runs the engine's decode block (`engine._decode_fn`, the
default 8 greedy steps) once to warm up, once on the host clock, and once
under torch.profiler; the lanes go back to `context` before each run (the
block advances them in place). With --graph it also captures the block as
the engine does (engine/graphs.py: on idle lanes, then the lanes are
set live) and measures the eager block and the graph's replay in turns
(eager, graph, graph, eager, ...), each line and summary labelled with its
mode; its launches are the kernels the profiler saw the card run; with
--prefill as well it does the same for the prefill (captured over
zeroed operand buffers, every table on the garbage page, as the engine
captures). With --ragged it runs one ragged dispatch instead
(`engine._ragged_fn`): the 16 lanes' single tokens plus the default
1024-token prefill budget, as a first 512-token chunk (KV length 512) and a
second one (KV length 1024). --kv-dtype int8 runs either over the int8 KV
pool (int8 values plus bf16 scales, EngineConfig.kv_dtype="int8"), whose
rows quantize as they are written. With --prefill T (512 if T is left
out) it runs one bucketed prefill instead (`engine._prefill_fn`, the
engine's prefill entry: forward_paged over a [1, T] window at positions
context..context+T-1, then the unembed and the sample), through the flash
kernel over the gathered window, and splits its device time into flash,
the window gather of `paged_gather_kv` (with the int8 dequantize; the
scales' own small gather counts as the rest), the KV write, GEMMs and the
rest (elementwise, norms, RoPE, copies). Prints, per
step (per dispatch with --ragged, per prefill with --prefill):
the wall time, the time the device spent in kernels (the sum of the CUDA
kernel spans the profiler recorded), the device's idle share, the kernel
launches, the device time of decode attention (every kernel whose name
holds "paged_decode"), of ragged attention (every kernel whose name
holds "ragged") and of the paged write kernel (every kernel whose name
holds "paged_write"), and the kernels that took the most device time.
--repeat N measures N times in the process (wall and profile each time)
and ends with the median and range of each number. Each line names the
card and its power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import statistics
import subprocess
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ragged", action="store_true",
                    help="profile one ragged mixed prefill+decode dispatch")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16",
                    help="KV pool: bf16, or int8 values with bf16 scales")
    ap.add_argument("--prefill", type=int, nargs="?", const=512, default=None,
                    metavar="T", help="profile one bucketed prefill of T tokens "
                    "(default 512) at positions context..context+T-1")
    ap.add_argument("--graph", action="store_true",
                    help="measure the decode block (or with --prefill the prefill) "
                    "eagerly and as a CUDA graph replay, in turns")
    ap.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="measure N times and report the median and range")
    args = ap.parse_args()
    if args.ragged and (args.prefill is not None or args.graph):
        raise SystemExit("profile_decode: --ragged profiles its own dispatch, "
                         "alone (--graph takes the block or --prefill)")
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: no CUDA device")

    from ..engine.config import EngineConfig
    from ..engine.engine import _prefill_fn, _ragged_fn, ragged_zero_operands
    from ..models.config import get_config
    from ..models.transformer import init_params
    from ..ops.ragged_paged_attention_kernel import TOKEN_TILE, ragged_work

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    econf = EngineConfig(model="llama-3-8b")
    cfg = get_config(econf.model)
    B, steps = econf.max_decode_slots, econf.decode_block_steps
    P, ps = econf.pages_per_seq, econf.page_size
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, torch.bfloat16, dev, gen)
    int8 = args.kv_dtype == "int8"
    paged, state = decode_lanes(econf, cfg, args.context, gen, int8)
    per = -(-(args.context + 3 * steps) // ps)
    lane_args = [state[k] for k in LANES]
    eager, reset = decode_block(params, cfg, paged, state, steps)
    blocks = {"eager": lambda: eager().cpu()}
    if args.graph and args.prefill is None:
        graph, _ = decode_block(params, cfg, paged, state, steps, graph=True)
        blocks["graph"] = lambda: graph().cpu()

    if args.ragged:
        # The engine's stream: W = the default 1024-token budget, padded so
        # B + W is a multiple of TOKEN_TILE. Two prompts on fresh pages: X
        # prefills its first chunk (positions 0..511), Y its second
        # (512..1023, the final one, which samples Y's first token).
        chunk = max(econf.prefill_buckets)
        W = 2 * chunk + (-(B + 2 * chunk)) % TOKEN_TILE
        pre = ragged_zero_operands(B, W, P)
        (tokens, pos, tidx, ptables, r_start, r_len, r_kv, r_tidx,
         s_idx, s_pos) = pre[:10]
        fresh = 1 + (B * per + np.arange(3 * chunk // ps)) % (econf.num_pages - 1)
        ptables[0, : chunk // ps] = fresh[: chunk // ps]
        ptables[1, : 2 * chunk // ps] = fresh[chunk // ps:]
        tokens[: 2 * chunk] = np.random.default_rng(args.seed).integers(3, 259, 2 * chunk)
        pos[: 2 * chunk] = np.arange(2 * chunk)
        tidx[: 2 * chunk] = np.repeat([0, 1], chunk)
        r_start[:2], r_len[:2], r_kv[:2], r_tidx[:2] = [0, chunk], chunk, [chunk, 2 * chunk], [0, 1]
        s_idx[1], s_pos[1] = 2 * chunk - 1, 2 * chunk
        work = ragged_work(
            np.concatenate([np.arange(B), B + r_start]),
            np.concatenate([np.ones(B, np.int32), r_len]),
            np.concatenate([np.full(B, args.context), r_kv]),
            B + W, cfg.num_heads // cfg.num_kv_heads, cfg.num_kv_heads, dev,
        )
        pre_dev = [torch.from_numpy(a).to(dev) for a in pre]
        steps = 1

        def ragged():
            packed, *_, first, _ = _ragged_fn(
                params, cfg, paged, *lane_args, *pre_dev, greedy=True, eos_id=-1,
                work=work,
            )
            return torch.cat([packed.reshape(-1), first]).cpu()

        blocks = {"ragged": ragged}

    if args.prefill is not None:
        T = args.prefill
        ops = prefill_inputs(econf, cfg, T, args.context, 1, gen)
        runs = {"eager": prefill_block(params, cfg, paged, ops, T)}
        if args.graph:
            runs["graph"] = prefill_block(params, cfg, paged, ops, T, graph=True)
        steps = 1
        blocks = {name: (lambda run=run: run().cpu()) for name, run in runs.items()}

    pool = "int8 KV" if int8 else "bf16 KV"
    if args.prefill is not None:
        where = (f"{cfg.name} {cfg.num_layers} layers bf16, {pool}, one bucketed prefill "
                 f"of {args.prefill} tokens at positions {args.context}.."
                 f"{args.context + args.prefill - 1}, greedy"
                 f"{', eager and as its graph replay in turns' if args.graph else ''}, "
                 f"on {card}")
    elif args.ragged:
        where = (f"{cfg.name} {cfg.num_layers} layers bf16, {pool}, one ragged dispatch: "
                 f"B={B} decode lanes at context {args.context} + {W}-token prefill "
                 f"stream (chunks at KV 512 and 1024), greedy, on {card}")
    else:
        where = (f"{cfg.name} {cfg.num_layers} layers bf16, {pool}, B={B}, context "
                 f"{args.context}, block of {steps} greedy steps, on {card}")
    print(f"[profile_decode] {where}")
    unit = "prefill" if args.prefill is not None else "dispatch" if args.ragged else "step"
    labels = _labelled_ranges() if args.prefill is not None else contextlib.nullcontext()
    runs = collections.defaultdict(list)
    names = list(blocks)
    with labels, torch.inference_mode():
        for fn in blocks.values():
            reset()
            fn()
        torch.cuda.synchronize()
        for rep in range(args.repeat):
            # In turns: a, b, b, a, ... so drift falls on both alike.
            for name in names if rep % 2 == 0 else names[::-1]:
                fn = blocks[name]
                reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
                reset()
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    fn()
                    torch.cuda.synchronize()
                tag = f"{name} " if len(names) > 1 else ""
                for key, value in _report(prof, wall_ms, steps, unit, args.prefill is not None,
                                          rep == args.repeat - 1, tag).items():
                    runs[tag + key].append(value)
    if args.repeat > 1:
        for key, values in runs.items():
            print(f"[profile_decode] {key} over {args.repeat} runs: median "
                  f"{statistics.median(values):.3f}, range {min(values):.3f}-"
                  f"{max(values):.3f} on {card}")


LANES = ("last_tokens", "seq_lens", "page_tables", "active", "caps", "seeds",
         "temperature", "top_p", "top_k")


def decode_lanes(econf, cfg, context: int, gen: torch.Generator, int8: bool):
    """The engine's default paged KV pool on the card (int8 values with bf16
    scales for `int8`) and its `max_decode_slots` lanes live and greedy at
    `context` positions, each table holding room for three blocks more.
    Returns (paged, lane state dict keyed as the engine's)."""
    from ..engine.kv_cache import init_paged_kv

    dev = torch.device("cuda")
    B, steps = econf.max_decode_slots, econf.decode_block_steps
    paged = init_paged_kv(cfg, econf.num_pages, econf.page_size, torch.bfloat16, dev,
                          kv_dtype=torch.int8 if int8 else None)
    P, ps = econf.pages_per_seq, econf.page_size
    per = -(-(context + 3 * steps) // ps)
    if per > P:
        raise SystemExit(f"profile_decode: context {context} needs {per} "
                         f"pages of a {P}-entry table")
    # Distinct pages while the pool lasts; past it, lanes share pages
    # (the data is random either way; every id stays inside the pool).
    ids = 1 + torch.arange(B * per, device=dev) % (econf.num_pages - 1)
    tables = torch.zeros((B, P), dtype=torch.int32, device=dev)
    tables[:, :per] = ids.reshape(B, per).to(torch.int32)
    state = dict(
        last_tokens=torch.randint(3, 259, (B,), generator=gen, device=dev,
                                  dtype=torch.int32),
        seq_lens=torch.full((B,), context, dtype=torch.int32, device=dev),
        page_tables=tables,
        active=torch.ones(B, dtype=torch.bool, device=dev),
        caps=torch.full((B,), econf.max_seq_len, dtype=torch.int32, device=dev),
        seeds=torch.zeros((B, 2), dtype=torch.int32, device=dev),
        temperature=torch.zeros(B, device=dev),
        top_p=torch.ones(B, device=dev),
        top_k=torch.zeros(B, dtype=torch.int32, device=dev),
    )
    return paged, state


def decode_block(params, cfg, paged, state: dict, steps: int, graph: bool = False):
    """(run, reset) for one greedy decode block of `steps` over the lanes
    of `state`: `run()` dispatches it, eagerly (`engine._decode_fn`) or, with
    `graph`, as the replay of a CUDA graph captured here the engine's way
    (engine/decode_graph.py, on idle lanes that are then set live again),
    and returns its packed [steps, B] tokens on the device; `reset()` puts
    the lanes back where they were when this was called (a block advances
    them in place)."""
    from ..engine.engine import _decode_fn
    from ..engine.graphs import CudaGraphs

    live = {k: t.clone() for k, t in state.items()}

    def reset():
        for k, t in live.items():
            state[k].copy_(t)

    def body(greedy, steps):
        return _decode_fn(params, cfg, paged, *(state[k] for k in LANES),
                          greedy=greedy, steps=steps, eos_id=-1)

    if not graph:
        return (lambda: body(True, steps)), reset
    for k in ("last_tokens", "seq_lens", "page_tables", "active"):
        state[k].zero_()
    graphs = CudaGraphs(torch.device("cuda"), {"decode": (body, [(True, steps)])})
    with torch.inference_mode():
        graphs.capture()
    reset()
    return (lambda: graphs.run("decode", True, steps)), reset


def prefill_inputs(econf, cfg, T: int, context: int, n: int, gen: torch.Generator):
    """The engine's prefill operand buffers for group pad `n`
    (engine.PrefillOperands), holding n greedy prompt rows of T random
    tokens at positions context..context+T-1, each row's table on pages of
    its own (1, 2, ... in order; its context pages are whatever the pool
    holds there)."""
    from ..engine.engine import PrefillOperands

    P, ps = econf.pages_per_seq, econf.page_size
    need = -(-(context + T) // ps)
    if need > P or n * need >= econf.num_pages:
        raise SystemExit(f"profile_decode: {n} rows of context {context} + {T} tokens "
                         f"need {need} pages each, of a {P}-entry table and "
                         f"{econf.num_pages - 1} pages")
    tables = np.zeros((n, P), np.int32)
    tables[:, :need] = 1 + np.arange(n * need).reshape(n, need)
    tokens = torch.randint(3, 259, (n, T), generator=gen, device=gen.device,
                           dtype=torch.int32).cpu().numpy()
    ops = PrefillOperands(n, T, P, torch.device("cuda"))
    i32 = dict(dtype=np.int32)
    ops.upload(tokens, np.full(n, context, **i32), np.full(n, T - 1, **i32), tables,
               np.zeros((n, 2), **i32), np.zeros(n, np.float32), np.ones(n, np.float32),
               np.zeros(n, **i32))
    torch.cuda.synchronize()
    return ops


def prefill_block(params, cfg, paged, ops, T: int, graph: bool = False):
    """`run()` dispatches one greedy prefill of width T over the rows in
    `ops` (prefill_inputs) and returns its sampled tokens on the device:
    eagerly (`engine._prefill_fn`) or, with `graph`, as the replay of a
    CUDA graph captured here the engine's way (engine/graphs.py, with every
    operand zeroed, so every table points at the garbage page, then the
    rows put back)."""
    from ..engine.engine import _prefill_fn
    from ..engine.graphs import CudaGraphs

    n, ps = ops.n, paged.k.shape[2]
    start = ops.views(T)[1]
    aligned = T % ps == 0 and not bool((start % ps).any())

    def body(width, n_pad, greedy, aligned):
        return _prefill_fn(params, cfg, paged, *ops.views(width), greedy=greedy,
                           aligned=aligned)[0]

    if not graph:
        return lambda: body(T, n, True, aligned)
    rows = ops.buf.clone()
    ops.buf.zero_()
    graphs = CudaGraphs(torch.device("cuda"),
                        {"prefill": (body, [(T, n, True, aligned)])})
    with torch.inference_mode():
        graphs.capture()
    ops.buf.copy_(rows)
    return lambda: graphs.run("prefill", T, n, True, aligned)


def device_kernels(prof) -> list:
    """The CUDA kernels a torch.profiler run recorded on the card (without
    the labelled ranges' annotation spans)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in _RANGES]


def _report(prof, wall_ms: float, steps: int, unit: str, prefill: bool,
            top_kernels: bool, tag: str = "") -> dict:
    """Print one measurement (labelled `tag`); returns its numbers per
    `unit`."""
    # A record_function range also shows on the device as an annotation
    # spanning its kernels (idle gaps included): kept apart, not a kernel.
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.name in _RANGES]
    kernels = device_kernels(prof)
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3 / steps
    decode_ms = sum(us for name, (us, _) in by_name.items()
                    if "paged_decode" in name) / 1e3 / steps
    ragged_ms = sum(us for name, (us, _) in by_name.items()
                    if "ragged" in name) / 1e3 / steps
    write_ms = sum(us for name, (us, _) in by_name.items()
                   if "paged_write" in name) / 1e3 / steps
    print(f"[profile_decode] {tag}per {unit}: wall {wall_ms:.3f} ms (host clock, "
          f"unprofiled block); device busy in kernels {busy_ms:.3f} ms "
          f"(profiled block); idle share {1 - busy_ms / wall_ms:.3f}; "
          f"{len(kernels) / steps:.0f} kernel launches; decode attention "
          f"{decode_ms:.3f} ms; ragged attention {ragged_ms:.3f} ms; paged write "
          f"kernel {write_ms:.4f} ms")
    if not kernels:
        print("[profile_decode] the profiler recorded no device kernels: "
              "device time not measured")
    if prefill:
        _print_breakdown(kernels, spans, busy_ms, unit)
    if top_kernels:
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for name, (us, n) in top:
            print(f"[profile_decode]   {us / 1e3 / steps:8.3f} ms/{unit} "
                  f"{n / steps:6.0f} launches/{unit}  {name[:110]}")
    return {"wall ms": wall_ms, "device busy ms": busy_ms,
            "idle share": 1 - busy_ms / wall_ms, "kernel launches": len(kernels) / steps,
            "decode attention ms": decode_ms,
            "ragged attention ms": ragged_ms, "paged write kernel ms": write_ms}

# Functions whose kernels the prefill breakdown counts under their own
# label: PyTorch's index kernels serve both the gather and the write, so
# their names alone cannot tell the two apart.
_RANGES = {
    "paged_gather_kv": "window gather",
    "dequantize_kv": "window gather",
    "paged_write": "KV write",
}


@contextlib.contextmanager
def _labelled_ranges():
    """Wrap each of _RANGES' functions of ops.paged_attention in a
    torch.profiler.record_function range named after it, for this run."""
    from ..ops import paged_attention as pa

    saved = {name: getattr(pa, name) for name in _RANGES}

    def wrap(name, fn):
        def labelled(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return labelled

    for name, fn in saved.items():
        setattr(pa, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(pa, name, fn)


def _is_gemm(name: str) -> bool:
    n = name.lower()
    return any(tag in n for tag in ("gemm", "nvjet", "cutlass", "xmma", "cublas"))


def _print_breakdown(kernels: list, spans: list, busy_ms: float, unit: str) -> None:
    """Device ms of one prefill by part: flash and GEMMs by kernel name; the
    gather and the write by the labelled range whose device span holds the
    kernel's start (one stream runs them in order); the rest elementwise."""
    parts = {p: [0.0, 0] for p in ("flash", "GEMMs", "window gather", "KV write",
                                   "elementwise and other")}
    for e in kernels:
        t = e.time_range
        if "flash_kernel" in e.name:
            part = "flash"
        elif _is_gemm(e.name):
            part = "GEMMs"
        else:
            part = next((_RANGES[s.name] for s in spans
                         if s.time_range.start <= t.start < s.time_range.end),
                        "elementwise and other")
        parts[part][0] += t.elapsed_us() / 1e3
        parts[part][1] += 1
    if not spans:
        print("[profile_decode] the profiler recorded no labelled device ranges: "
              "gather and write are counted under elementwise and other")
    for part, (ms, n) in parts.items():
        print(f"[profile_decode]   {part:22s} {ms:8.3f} ms/{unit} "
              f"({ms / busy_ms:.3f} of device busy, {n} launches)")


if __name__ == "__main__":
    main()
