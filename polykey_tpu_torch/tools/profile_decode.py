"""Where a decode step's (or a ragged dispatch's, or a prefill's) time goes, on the GPU.

    python -m polykey_tpu_torch.tools.profile_decode [--model M] [--quantize int8|int4]
        [--context 512] [--seed 0] [--ragged [--spec]]
        [--kv-dtype int8] [--prefill [T]] [--spec [--gamma 4] [--draft MODEL]] [--graph]
        [--repeat N]

Builds the 32-layer Llama-3-8B (or --model) with random bf16 weights, puts
16 live lanes (the default EngineConfig's slots) at `context` positions of the default
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
kernel over the gathered window (the window gather is `paged_gather_kv`,
with the int8 dequantize; the scales' own small gather counts as the
rest). Prints, per
step (per dispatch with --ragged, per prefill with --prefill):
the wall time, the time the device spent in kernels (the sum of the CUDA
kernel spans the profiler recorded), the device's idle share, the kernel
launches, the device time of decode attention (every kernel whose name
holds "paged_decode"), of ragged attention (every kernel whose name
holds "ragged") and of the paged write kernel (every kernel whose name
holds "paged_write"), its split into parts, and the kernels that took the
most device time. The parts: the attention kernels (flash, decode,
ragged, by name); the attention projections' GEMMs, a dense MLP's GEMMs,
the MoE expert einsums and the unembedding's GEMM; the dequantizing casts
of int8/int4 weights; the MoE router and the dispatch's slots, scatter and
gather; the window gather; the KV write; other GEMMs; the rest
(elementwise, norms, RoPE, copies). An eager run finds them by
record_function ranges around the functions that compute them; a graph
replay, which has no host ranges, takes the parts of the eager run's
kernels, matched in order by name (the same kernels in the same order
but for a few).
--model picks the model (llama-3-8b by default; mixtral-8x7b needs
--quantize), --quantize int8|int4 quantizes its weights as the engine does
(a layer at a time as they are drawn).
With --spec it runs one speculative draft/verify round instead
(`engine.spec_decode.spec_decode_fn`, greedy, at --gamma, 4 by default)
with the draft model --draft (llama-3.2-1b by default, random weights,
its own pool under the same tables): 16 lanes at `context`, each lane's
dial at gamma. --ragged --spec runs one ragged spec dispatch instead
(`engine.spec_decode.ragged_spec_fn`, the engine's dispatch of an
iteration that admits prompts while lanes speculate): the 16 lanes'
verify windows (gamma + 1 rows each, after the draft's gamma steps) and
the --ragged prefill stream, through both models' ragged forwards; its
ragged attention sums both models' ragged kernels. Each run prints the round's tokens (emitted over all
lanes) and its acceptance, from the packed stat columns; after each
repeat it measures the round's split, each part a CUDA graph of its own
timed by CUDA events (`spec_parts`): the draft steps, the verify forward
(and within it one layer's window gather, and one layer's attention with
its gather, each times the layers), the draft sync and the accept/merge.
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
    ap.add_argument("--model", default="llama-3-8b",
                    help="the model (random weights): llama-3-8b, mixtral-8x7b, ...")
    ap.add_argument("--quantize", choices=("int8", "int4"), default=None,
                    help="weight-only int8 or int4 weights (EngineConfig.quantize)")
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ragged", action="store_true",
                    help="profile one ragged mixed prefill+decode dispatch")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16",
                    help="KV pool: bf16, or int8 values with bf16 scales")
    ap.add_argument("--prefill", type=int, nargs="?", const=512, default=None,
                    metavar="T", help="profile one bucketed prefill of T tokens "
                    "(default 512) at positions context..context+T-1")
    ap.add_argument("--spec", action="store_true",
                    help="profile one speculative draft/verify round")
    ap.add_argument("--gamma", type=int, default=4, help="the round's gamma (--spec)")
    ap.add_argument("--draft", default="llama-3.2-1b", help="the draft model (--spec)")
    ap.add_argument("--graph", action="store_true",
                    help="measure the decode block (or with --prefill the prefill) "
                    "eagerly and as a CUDA graph replay, in turns")
    ap.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="measure N times and report the median and range")
    args = ap.parse_args()
    if args.ragged and (args.prefill is not None or args.graph):
        raise SystemExit("profile_decode: --ragged profiles its own dispatch, "
                         "alone (--graph takes the block or --prefill)")
    if args.spec and args.prefill is not None:
        raise SystemExit("profile_decode: --spec profiles its own round, alone")
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
    bits = {"int8": 8, "int4": 4}.get(args.quantize)
    econf = EngineConfig(model=args.model, quantize=bits is not None,
                         quantize_bits=bits or 8)
    cfg = get_config(econf.model)
    B, steps = econf.max_decode_slots, econf.decode_block_steps
    P, ps = econf.pages_per_seq, econf.page_size
    dev = torch.device("cuda")
    if bits is None and 2 * cfg.num_params() > torch.cuda.get_device_properties(dev).total_memory:
        raise SystemExit(f"profile_decode: {cfg.name} does not fit on the card in bf16 "
                         f"({2 * cfg.num_params() / 1e9:.1f} GB): add --quantize int8")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, torch.bfloat16, dev, gen, quantize_bits=bits)
    weights = f"{args.quantize} weights" if bits else "bf16"
    int8 = args.kv_dtype == "int8"
    paged, state = decode_lanes(econf, cfg, args.context, gen, int8)
    per = -(-(args.context + 3 * steps) // ps)
    lane_args = [state[k] for k in LANES]
    eager, reset = decode_block(params, cfg, paged, state, steps)
    blocks = {"eager": lambda: eager().cpu()}
    if args.graph and args.prefill is None and not args.spec:
        graph, _ = decode_block(params, cfg, paged, state, steps, graph=True)
        blocks["graph"] = lambda: graph().cpu()

    spec_split = None
    if args.ragged:
        # The engine's stream: W = the default 1024-token budget, padded so
        # B G1 + W is a multiple of TOKEN_TILE (G1 rows a lane: 1, or a
        # spec engine's gamma + 1 verify rows). Two prompts on fresh pages:
        # X prefills its first chunk (positions 0..511), Y its second
        # (512..1023, the final one, which samples Y's first token).
        chunk = max(econf.prefill_buckets)
        G1 = args.gamma + 1 if args.spec else 1
        W = 2 * chunk + (-(B * G1 + 2 * chunk)) % TOKEN_TILE
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

        def work(mc):
            return ragged_work(
                np.concatenate([np.arange(B) * G1, B * G1 + r_start]),
                np.concatenate([np.full(B, G1, np.int32), r_len]),
                np.concatenate([np.full(B, args.context + G1 - 1), r_kv]),
                B * G1 + W, mc.num_heads // mc.num_kv_heads, mc.num_kv_heads, dev,
            )

        pre_dev = [torch.from_numpy(a).to(dev) for a in pre]
        steps = 1

        def ragged():
            packed, *_, first, _ = _ragged_fn(
                params, cfg, paged, *lane_args, *pre_dev, greedy=True, eos_id=-1,
                work=work(cfg),
            )
            return torch.cat([packed.reshape(-1), first]).cpu()

        blocks = {"ragged": ragged}
        if args.spec:
            from ..engine.spec_decode import ragged_spec_fn

            d_cfg, d_params, d_paged = draft_parts(args, econf, paged, state, gen)
            t_work, d_work = work(cfg), work(d_cfg)
            live = {k: t.clone() for k, t in state.items()}

            def reset():
                for k, t in live.items():
                    state[k].copy_(t)

            def ragged_spec():
                packed, _first = ragged_spec_fn(
                    params, d_params, cfg, d_cfg, paged, d_paged,
                    *(state[k] for k in SPEC_LANES), *pre_dev, gamma=args.gamma,
                    eos_id=-1, greedy=True, t_work=t_work, d_work=d_work)
                return packed.cpu()

            blocks = {"ragged spec": ragged_spec}

    if args.prefill is not None:
        T = args.prefill
        ops = prefill_inputs(econf, cfg, T, args.context, 1, gen)
        runs = {"eager": prefill_block(params, cfg, paged, ops, T)}
        if args.graph:
            runs["graph"] = prefill_block(params, cfg, paged, ops, T, graph=True)
        steps = 1
        blocks = {name: (lambda run=run: run().cpu()) for name, run in runs.items()}

    if args.spec and not args.ragged:
        blocks, reset, spec_split = spec_round(params, cfg, econf, paged, state, args,
                                               gen, graph=args.graph)
        steps = 1

    pool = "int8 KV" if int8 else "bf16 KV"
    if args.spec and args.ragged:
        where = (f"{cfg.name} {cfg.num_layers} layers {weights} + draft {args.draft}, {pool}, "
                 f"one ragged spec dispatch: B={B} verify windows of {G1} rows at context "
                 f"{args.context} + {W}-token prefill stream (chunks at KV 512 and 1024), "
                 f"gamma {args.gamma}, greedy, on {card}")
    elif args.spec:
        where = (f"{cfg.name} {cfg.num_layers} layers {weights} + draft {args.draft}, {pool}, "
                 f"one speculative round: B={B} lanes at context {args.context}, "
                 f"gamma {args.gamma}, greedy"
                 f"{', eager and as its graph replay in turns' if args.graph else ''}, "
                 f"on {card}")
    elif args.prefill is not None:
        where = (f"{cfg.name} {cfg.num_layers} layers {weights}, {pool}, one bucketed prefill "
                 f"of {args.prefill} tokens at positions {args.context}.."
                 f"{args.context + args.prefill - 1}, greedy"
                 f"{', eager and as its graph replay in turns' if args.graph else ''}, "
                 f"on {card}")
    elif args.ragged:
        where = (f"{cfg.name} {cfg.num_layers} layers {weights}, {pool}, one ragged dispatch: "
                 f"B={B} decode lanes at context {args.context} + {W}-token prefill "
                 f"stream (chunks at KV 512 and 1024), greedy, on {card}")
    else:
        where = (f"{cfg.name} {cfg.num_layers} layers {weights}, {pool}, B={B}, context "
                 f"{args.context}, block of {steps} greedy steps, on {card}")
    print(f"[profile_decode] {where}")
    unit = ("prefill" if args.prefill is not None else "dispatch" if args.ragged
            else "round" if args.spec else "step")
    runs = collections.defaultdict(list)
    names = list(blocks)
    # The eager run's kernel names and parts: a graph replay launches the
    # same kernels in the same order, without the host's ranges.
    template: dict = {}
    with torch.inference_mode():
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
                with _labelled_ranges(), torch.profiler.profile(activities=acts) as prof:
                    out = fn()
                    torch.cuda.synchronize()
                tag = f"{name} " if len(names) > 1 else ""
                numbers = _report(prof, wall_ms, steps, unit, rep == args.repeat - 1, tag,
                                  template)
                if args.spec:
                    g1 = args.gamma + 1
                    tokens = int((out[:, :g1] >= 0).sum())
                    print(f"[profile_decode] {tag}round: {tokens} tokens over {B} lanes, "
                          f"acceptance {int(out[:, g1].sum())}/{int(out[:, g1 + 1].sum())}")
                    numbers["tokens a round"] = tokens
                for key, value in numbers.items():
                    runs[tag + key].append(value)
            if spec_split is not None:
                for part, ms in spec_split().items():
                    print(f"[profile_decode] round part {part}: {ms:.3f} ms (device, "
                          f"its own CUDA graph) on {card}")
                    runs[f"part {part} ms"].append(ms)
    if args.repeat > 1:
        for key, values in runs.items():
            print(f"[profile_decode] {key} over {args.repeat} runs: median "
                  f"{statistics.median(values):.3f}, range {min(values):.3f}-"
                  f"{max(values):.3f} on {card}")


LANES = ("last_tokens", "seq_lens", "page_tables", "active", "caps", "seeds",
         "temperature", "top_p", "top_k")
SPEC_LANES = LANES + ("accept_ewma", "gamma_lane")


def spec_round(params, cfg, econf, paged, state: dict, args, gen, graph: bool = False):
    """({"eager": run[, "graph": run]}, reset, parts) for one greedy
    speculative round over the lanes of `state`, each lane's dial at
    args.gamma: the draft (args.draft, random weights) gets a pool of its
    own under the same tables. `run()` returns the packed matrix on the
    host. The graph is captured the engine's way (idle lanes on the garbage
    page, then put back); `reset()` puts the lanes, the dials included,
    back where they were; `parts()` measures the round's split
    (`spec_parts`)."""
    from ..engine.graphs import CudaGraphs
    from ..engine.spec_decode import spec_decode_fn

    dev = torch.device("cuda")
    d_cfg, d_params, d_paged = draft_parts(args, econf, paged, state, gen)
    g = args.gamma
    live = {k: t.clone() for k, t in state.items()}

    def reset():
        for k, t in live.items():
            state[k].copy_(t)

    def body(gamma, greedy, cand):
        return spec_decode_fn(params, d_params, cfg, d_cfg, paged, d_paged,
                              *(state[k] for k in SPEC_LANES), gamma=gamma, eos_id=-1,
                              candidates=cand, greedy=greedy)

    runs = {"eager": lambda: body(g, True, 0).cpu()}
    if graph:
        for k in ("last_tokens", "seq_lens", "page_tables", "active"):
            state[k].zero_()
        graphs = CudaGraphs(dev, {"spec": (body, [(g, True, 0)])})
        with torch.inference_mode():
            graphs.capture()
        reset()
        print(f"[profile_decode] spec graph: capture {graphs.capture_seconds:.3f} s, "
              f"pool {graphs.pool_bytes / 2**20:.1f} MiB, draft pool "
              f"{d_paged.nbytes / 2**30:.4f} GiB")
        runs["graph"] = lambda: graphs.run("spec", g, True, 0).cpu()

    def parts():
        return spec_parts(params, cfg, paged, state, d_params, d_cfg, d_paged, g, reset)

    return runs, reset, parts


def draft_parts(args, econf, paged, state: dict, gen):
    """(d_cfg, d_params, d_paged): the draft args.draft with random weights
    and a pool of its own (the target pool's KV type) under the same
    tables; each lane of `state` gets its dial at args.gamma and an EWMA
    of 1."""
    from ..engine.kv_cache import init_paged_kv
    from ..models.config import get_config
    from ..models.transformer import init_params

    dev = torch.device("cuda")
    d_cfg = get_config(args.draft)
    d_params = init_params(d_cfg, torch.bfloat16, dev, gen)
    d_paged = init_paged_kv(d_cfg, econf.num_pages, econf.page_size, torch.bfloat16, dev,
                            kv_dtype=torch.int8 if paged.quantized else None)
    B = econf.max_decode_slots
    state["accept_ewma"] = torch.ones(B, device=dev)
    state["gamma_lane"] = torch.full((B,), args.gamma, dtype=torch.int32, device=dev)
    return d_cfg, d_params, d_paged


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
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in _PARTS]


def _report(prof, wall_ms: float, steps: int, unit: str, top_kernels: bool, tag: str,
            template: dict) -> dict:
    """Print one measurement (labelled `tag`) and its split by part
    (`_parts`); returns its numbers per `unit`. `template` keeps the last
    labelled run's kernel names and parts, for a run without ranges."""
    # A record_function range also shows on the device as an annotation
    # spanning its kernels (idle gaps included): kept apart, not a kernel.
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.name in _PARTS]
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
    numbers = {"wall ms": wall_ms, "device busy ms": busy_ms,
               "idle share": 1 - busy_ms / wall_ms, "kernel launches": len(kernels) / steps,
               "decode attention ms": decode_ms,
               "ragged attention ms": ragged_ms, "paged write kernel ms": write_ms}
    if not kernels:
        print("[profile_decode] the profiler recorded no device kernels: "
              "device time not measured")
        return numbers
    names = [e.name for e in kernels]
    parts = None
    if spans:
        parts = _parts(kernels, spans)
        template.update(names=names, parts=parts)
        how = "by the host's ranges"
    elif template:
        parts, matched = _align(template["names"], template["parts"], kernels)
        how = (f"from the eager run's ranges, {matched} of {len(names)} kernels matched "
               f"in order by name, the rest by name alone")
    else:
        print("[profile_decode] no ranges and no eager run yet: parts not measured")
    if parts is not None:
        split: dict = {p: [0.0, 0] for p in PART_ORDER}
        for e, part in zip(kernels, parts):
            split[part][0] += e.time_range.elapsed_us() / 1e3 / steps
            split[part][1] += 1
        print(f"[profile_decode] {tag}parts, {how}:")
        for part, (ms, n) in split.items():
            print(f"[profile_decode]   {part:24s} {ms:8.3f} ms/{unit} "
                  f"({ms / busy_ms:.3f} of device busy, {n / steps:.0f} launches)")
            numbers[f"part {part} ms"] = ms
    if top_kernels:
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for name, (us, n) in top:
            print(f"[profile_decode]   {us / 1e3 / steps:8.3f} ms/{unit} "
                  f"{n / steps:6.0f} launches/{unit}  {name[:110]}")
    return numbers


# The functions whose kernels count under a part of their own, by (module
# of polykey_tpu_torch, attribute): each is wrapped in a record_function
# range named after its part for a profiled run. The module is the one the
# caller looks the name up in.
_RANGES = {
    ("ops.paged_attention", "paged_gather_kv"): "window gather",
    ("ops.paged_attention", "dequantize_kv"): "window gather",
    ("ops.paged_attention", "paged_write"): "KV write",
    ("models.transformer", "qkv_project"): "attention GEMMs",
    ("models.transformer", "qdot"): "attention GEMMs",            # wo
    ("models.transformer", "mlp"): "MLP GEMMs",
    ("ops.moe", "qeinsum_expert"): "expert einsums",
    ("ops.moe", "_router_weights"): "router and dispatch",
    ("ops.moe", "_dispatch_slots"): "router and dispatch",
    ("ops.moe", "_scatter"): "router and dispatch",
    ("ops.moe", "_combine"): "router and dispatch",
    ("models.quant", "_cast_q"): "dequantizing casts",
    ("models.quant", "_deq_weight"): "dequantizing casts",
    ("engine.engine", "unembed"): "unembed GEMM",
}
_PARTS = set(_RANGES.values())
# Parts whose GEMM kernels count under them (their other kernels are
# elementwise work); every kernel of the other ranged parts counts.
_GEMM_PARTS = {"attention GEMMs", "MLP GEMMs", "expert einsums", "unembed GEMM"}
PART_ORDER = ("attention kernels", "attention GEMMs", "MLP GEMMs", "expert einsums",
              "dequantizing casts", "router and dispatch", "window gather", "KV write",
              "unembed GEMM", "other GEMMs", "elementwise and other")


def _parts(kernels: list, spans: list) -> list:
    """Each kernel's part: the attention kernels by name, else the
    innermost labelled range whose device span holds the kernel's start
    (one stream runs them in order), GEMMs by name."""
    out = []
    for e in kernels:
        t = e.time_range.start
        holding = [s for s in spans if s.time_range.start <= t < s.time_range.end]
        part = max(holding, key=lambda s: s.time_range.start).name if holding else None
        if _is_attention(e.name) or part is None:
            out.append(_by_name(e.name))
        elif part in _GEMM_PARTS:
            out.append(part if _is_gemm(e.name) else "elementwise and other")
        else:
            out.append(part)
    return out


def _is_attention(name: str) -> bool:
    return any(k in name for k in ("flash_kernel", "paged_decode", "ragged_kernel"))


def _by_name(name: str) -> str:
    """A kernel's part from its name alone."""
    if _is_attention(name):
        return "attention kernels"
    return "other GEMMs" if _is_gemm(name) else "elementwise and other"


def _align(t_names: list, t_parts: list, kernels: list, window: int = 16) -> tuple:
    """The parts of a run without ranges (a graph replay) from the eager
    run's (`t_names`, `t_parts`): both launch the same kernels in the same
    order but for a few (library calls may pick another kernel under
    capture). Walks both in step, resyncing within `window` kernels; an
    unmatched kernel takes its part by name alone. Returns (parts, number
    matched)."""
    out, i, matched = [], 0, 0
    for e in kernels:
        ahead = t_names[i:i + window]
        if e.name in ahead:
            i += ahead.index(e.name)
            out.append(t_parts[i])
            i += 1
            matched += 1
        else:
            out.append(_by_name(e.name))
    return out, matched


@contextlib.contextmanager
def _labelled_ranges():
    """Wrap each of _RANGES' functions in a torch.profiler.record_function
    range named after its part, for one run."""
    import importlib

    saved = []
    for (mod_name, attr), part in _RANGES.items():
        mod = importlib.import_module(f"polykey_tpu_torch.{mod_name}")
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def labelled(*args, _fn=fn, _part=part, **kwargs):
            with torch.profiler.record_function(_part):
                return _fn(*args, **kwargs)

        setattr(mod, attr, labelled)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _device_ms(fn, samples: int = 10) -> float:
    """Median device time of one call of `fn` over `samples` pairs of CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(samples)]
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def spec_parts(params, cfg, paged, state: dict, d_params, d_cfg, d_paged, gamma: int,
               reset) -> dict:
    """Device ms of each part of one greedy round, each captured as a CUDA
    graph of its own over the lanes of `state` and timed by CUDA events:
    the draft steps (`_draft_scan`), the verify forward (the target over
    the gamma + 1 window and its unembedding), within it one layer's window
    gather and one layer's attention (gather included) times the layers,
    the draft sync (the draft over the window) and the accept/merge. The
    parts' inputs are what an eager round computes; no part writes the
    lane state."""
    from ..engine import spec_decode as sd
    from ..engine.sampling import TaggedDraws
    from ..models.transformer import forward_paged, layer_window, unembed
    from ..ops.paged_attention import paged_attention, paged_gather_kv

    reset()
    st = {k: state[k] for k in SPEC_LANES}
    pos = torch.clamp(st["seq_lens"] - 1, min=0)
    greedy_row = st["temperature"] == 0.0
    temp = torch.clamp(st["temperature"], min=1e-6)
    draws = TaggedDraws(st["seeds"])
    dev = pos.device
    w_pos = (pos[:, None] + torch.arange(gamma + 1, dtype=torch.int32, device=dev)).to(
        torch.int32)
    held: dict = {}

    def draft():
        held["drafts"], _ = sd._draft_scan(
            d_params, d_cfg, d_paged, st["last_tokens"], pos, st["page_tables"],
            greedy_row, temp, st["top_p"], st["top_k"], draws, gamma, 0, True)
        held["window"] = torch.cat([st["last_tokens"][:, None], held["drafts"]], dim=1)

    def verify():
        hidden, _ = forward_paged(params, cfg, held["window"], w_pos, paged,
                                  st["page_tables"], aligned=False)
        held["t_logits"] = unembed(params, cfg, hidden)

    def sync():
        forward_paged(d_params, d_cfg, held["window"], w_pos, d_paged, st["page_tables"],
                      aligned=False)

    def merge():
        sd._accept_merge(held["t_logits"], held["drafts"], None, st["last_tokens"],
                         st["seq_lens"], st["active"], st["caps"], st["accept_ewma"],
                         st["gamma_lane"], pos, greedy_row, temp, st["top_p"], st["top_k"],
                         draws, gamma=gamma, gamma_low=gamma, gamma_max=gamma, eos_id=-1,
                         candidates=0, greedy=True)

    B, H = st["last_tokens"].shape[0], cfg.num_heads
    q = torch.randn((B, gamma + 1, H, cfg.head_dim), device=dev).to(torch.bfloat16)
    kc, vc = paged.layer(0)

    def gather():
        if paged.quantized:
            paged_gather_kv(kc[0], vc[0], st["page_tables"])
        else:
            paged_gather_kv(kc, vc, st["page_tables"])

    def attention():
        paged_attention(q, kc, vc, st["page_tables"], w_pos, scale=cfg.q_scale,
                        logit_softcap=cfg.attn_logit_softcap, window=layer_window(cfg, 0))

    out = {}
    with torch.inference_mode():
        for fn in (draft, verify, sync, merge):
            fn()                                  # the eager inputs of the next part
        for name, fn, times in (("draft steps", draft, 1), ("verify forward", verify, 1),
                                ("verify: window gather (one layer x layers)", gather,
                                 cfg.num_layers),
                                ("verify: attention incl. gather (one layer x layers)",
                                 attention, cfg.num_layers),
                                ("draft sync", sync, 1), ("accept/merge", merge, 1)):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            out[name] = times * _device_ms(graph.replay)
            del graph
    reset()
    return out


def _is_gemm(name: str) -> bool:
    n = name.lower()
    return any(tag in n for tag in ("gemm", "nvjet", "cutlass", "xmma", "cublas"))


if __name__ == "__main__":
    main()
