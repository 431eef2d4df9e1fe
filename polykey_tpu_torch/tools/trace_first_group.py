"""The first concurrent group after an engine starts, against the next ones
of the same shape, with and without the engine's start-up warm-up, on the
GPU.

    python -m polykey_tpu_torch.tools.trace_first_group [--seed 0] [--groups 2] [--profile]

Builds the 32-layer Llama-3-8B (random bf16 weights) behind bucketed
engines with the prefix cache on, as `chip_smoke.py`'s prefix phase does,
one engine per variant of the start-up warm-up: none; instead of it,
pinned host blocks of every readback size the pipeline copies into, held
at once and freed, so the caching host allocator has them; and the
engine's own, one replay of every graph
(`CudaGraphs.warm`). On each: a 1024-token header with a tail alone
(a miss), then `--groups` groups of four requests with the same header
and other tails at once (hits), 32 greedy tokens each, every group from an
idle card, and prints the TTFTs. With --profile each group runs under
torch.profiler (which slows a group down) and the CUDA runtime calls the
host made in it are printed (count, total and longest ms): a graph's first
launch, a pinned allocation (cudaHostAlloc) or a synchronizing call shows
there. Each line names the card and its power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import subprocess
import time

import numpy as np
import torch

HEADER = ("You are the tool-calling assistant of a ticketing service. Answer "
          "with one JSON object naming the tool and its arguments. ") * 8
HEADER = (HEADER * 2)[:1023]
TAILS = [f"Request {i}: the customer of order {1000 + 37 * i} asks whether it shipped "
         f"and when it arrives. Reply with the tool call." for i in range(16)]


def _pinned_blocks(config):
    """A stand-in for `CudaGraphs.warm`: pinned host blocks of every size
    the engine's readbacks and operand uploads use at `config` (8-step and
    1-step blocks of the lanes, a group pad's tokens, its operands at each
    bucket), four of each held at once, then freed."""
    from ..engine.engine import _GROUP_PADS, PrefillOperands

    B = config.max_decode_slots
    sizes = {config.decode_block_steps * B, B} | set(_GROUP_PADS)
    for n in _GROUP_PADS:
        ops = PrefillOperands(n, 1, config.pages_per_seq, "cpu")
        sizes |= {sum(int(np.prod(shape)) for shape, _ in ops.specs(w))
                  for w in config.prefill_buckets}

    def warm(graphs) -> None:
        held = [torch.empty(n, dtype=torch.int32, pin_memory=True)
                for n in sorted(sizes) for _ in range(4)]
        del held

    return warm


def _run(engine, prompts):
    from ..engine.engine import GenRequest

    reqs = [GenRequest(prompt=p, max_new_tokens=32) for p in prompts]
    for r in reqs:
        engine.submit(r)
    for r in reqs:
        while True:
            kind, value = r.out.get(timeout=600)
            if kind == "error":
                raise RuntimeError(value)
            if kind == "done":
                break
    return [r.timings.ttft_ms for r in reqs]


def _idle(engine):
    deadline = time.monotonic() + 60
    while (engine.busy or engine._inflight_q) and time.monotonic() < deadline:
        time.sleep(0.005)
    torch.cuda.synchronize()


def _calls(prof) -> list:
    """(name, count, total ms, longest ms) of the CUDA runtime calls."""
    calls: dict = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda"):
            ms = e.time_range.elapsed_us() / 1e3
            c = calls[e.name]
            c[0], c[1], c[2] = c[0] + 1, c[1] + ms, max(c[2], ms)
    return sorted(((n, *c) for n, c in calls.items()), key=lambda c: -c[2])[:10]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="run each group under torch.profiler and print its runtime calls")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_first_group: no CUDA device")

    from ..engine.config import EngineConfig
    from ..engine.engine import InferenceEngine
    from ..engine.graphs import CudaGraphs
    from ..models.config import get_config
    from ..models.transformer import init_params

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    config = EngineConfig(model="llama-3-8b", prefix_cache=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(get_config(config.model), torch.bfloat16, "cuda", gen)
    own = CudaGraphs.warm
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    variants = {
        "no warm-up": lambda graphs: None,
        "pinned host blocks instead": _pinned_blocks(config),
        "graph replays (the engine's)": None,
    }
    for label, warm in variants.items():
        CudaGraphs.warm = own if warm is None else warm
        try:
            engine = InferenceEngine(config, params=params, device="cuda", seed=args.seed)
        finally:
            CudaGraphs.warm = own
        try:
            _idle(engine)
            miss = _run(engine, [HEADER + TAILS[0]])
            print(f"[trace_first_group] {label}: miss TTFT {miss[0]:.1f} ms on {card}")
            for g in range(args.groups):
                _idle(engine)
                prompts = [HEADER + t for t in TAILS[1 + 4 * g: 5 + 4 * g]]
                prof = (torch.profiler.profile(activities=acts) if args.profile
                        else contextlib.nullcontext())
                with prof:
                    ttft = _run(engine, prompts)
                    _idle(engine)
                print(f"[trace_first_group] {label}, group {g + 1} of 4 hits: TTFT "
                      f"{', '.join(f'{t:.1f}' for t in ttft)} ms"
                      f"{' (profiled)' if args.profile else ''} on {card}")
                for name, n, total, most in (_calls(prof) if args.profile else []):
                    print(f"[trace_first_group]   {name:34s} {n:6d} calls, {total:9.3f} ms "
                          f"in all, longest {most:8.3f} ms")
        finally:
            engine.shutdown()
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
