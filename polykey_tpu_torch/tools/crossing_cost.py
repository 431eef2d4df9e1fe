"""What the engine's host-crossing scope costs served decode, on the GPU.

    python -m polykey_tpu_torch.tools.crossing_cost [--turns 5] [--seed 0]
        [--model llama-3-8b] [--max-new 128]

Draws the model's weights once (random bf16 from --seed; the 32-layer
Llama-3-8B by default) and builds, one after the other on them, an engine
of the default EngineConfig (the chip_smoke.py serve phase's: 16 slots,
buckets 128/512, depth 2) for each dispatch: "bucketed" (decode blocks
are graph replays) and "ragged" (`ragged_dispatch=True`: every iteration
with prefill work is one eager ragged dispatch, the path where
`ragged-upload` and each kernel launch's argument scan run). Each engine
serves the serve phase's five prompts (two ~100 byte tokens, two ~390,
one ~1500) three times over, all submitted at once, greedy, --max-new
tokens each, in turns: with the engine's `_host_crossing` as it is
("scope": the census count, one test of the open guards and a shared
no-op context at every crossing site), then with a stand-in that returns
the same no-op context and counts nothing ("bare"), --turns times each,
scope first. One warm-up request per bucket goes first. No guard is open
in either mode: this is the cost every serving run pays.

Per turn it prints the decode tok/s (the sum over the streams of
(completion - 1) / (finish - first token), as chip_smoke.py sums them),
the turn's wall and, on the ragged engine, the ragged dispatches and the
median host milliseconds of one `_dispatch_ragged` call (the host's issue
time: the call returns with the dispatch in flight). Then each mode's
median and range (on the ragged engine also the median over all of its
dispatches), the scope's share of the bare median, and one JSON
line with every turn, beside nvidia-smi's name and power limit.

On an engine without `_host_crossing` (a tree older than the scope, with
this file copied in) the one mode is "as-is", so two trees can be
compared in turns of processes on one machine.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


PROMPT = ("Tool-call log {i}: the client asked for the weather, the order status "
          "and a summary of the ticket thread; the service answered each in turn. ")


def _prompts(copies: int = 3) -> list:
    """`copies` times five prompts of about 100, 100, 390, 390 and 1500
    byte tokens (each copy's text differs)."""
    def text(i, n):
        body = "".join(PROMPT.format(i=i * 100 + k) for k in range(n // len(PROMPT) + 2))
        return body[:n]
    return [text(5 * c + i, n) for c in range(copies)
            for i, n in enumerate((100, 104, 390, 386, 1500))]


def _serve(engine, prompts: list, max_new: int) -> tuple:
    from ..engine.engine import GenRequest

    reqs = [GenRequest(prompt=p, max_new_tokens=max_new, temperature=0.0) for p in prompts]
    t0 = time.monotonic()
    for r in reqs:
        engine.submit(r)
    rates = []
    for r in reqs:
        while True:
            kind, value = r.out.get(timeout=600)
            if kind == "done":
                rates.append(value.tokens_per_sec)
                break
            if kind == "error":
                raise RuntimeError(f"request failed: {value}")
    return sum(rates), time.monotonic() - t0


def _time_ragged(engine) -> list:
    """Wrap the engine's `_dispatch_ragged` (an instance attribute the loop
    finds first): each call's host milliseconds go into the list returned."""
    inner, host_ms = engine._dispatch_ragged, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            host_ms.append((time.perf_counter() - t0) * 1e3)

    engine._dispatch_ragged = timed
    return host_ms


def _measure(engine, engine_mod, args, prompts: list, ragged: bool) -> dict:
    """Warm up, then serve the mix in turns of each mode; the turns by mode."""
    real = engine_mod.__dict__.get("_host_crossing")
    modes = ("scope", "bare") if real is not None else ("as-is",)
    bare = engine_mod.__dict__.get("_NO_GUARD")

    def no_scope(site: str = "unlabeled"):
        return bare

    host_ms = _time_ragged(engine) if ragged else None
    for p in (prompts[0], prompts[2]):          # one warm-up a bucket
        _serve(engine, [p], 4)
    turns = {m: [] for m in modes}
    for turn in range(args.turns):
        for mode in modes:
            if host_ms is not None:
                host_ms.clear()
            if mode == "bare":
                engine_mod._host_crossing = no_scope
            try:
                rate, wall = _serve(engine, prompts, args.max_new)
            finally:
                if real is not None:
                    engine_mod._host_crossing = real
            row = {"tok_s": rate, "wall_s": wall}
            if host_ms is not None:
                row.update(dispatches=len(host_ms), host_ms=list(host_ms),
                           host_ms_median=statistics.median(host_ms) if host_ms else None)
            turns[mode].append(row)
            extra = (f", {row['dispatches']} ragged dispatches, host ms median "
                     f"{row['host_ms_median']:.3f}" if host_ms else "")
            print(f"[crossing_cost] turn {turn + 1} {mode}: decode tok/s (sum of "
                  f"{len(prompts)} streams) {rate:.2f}, wall {wall:.3f} s{extra}",
                  flush=True)
    return turns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="llama-3-8b")
    ap.add_argument("--max-new", type=int, default=128)
    args = ap.parse_args(argv)
    if not args.turns > 0:
        ap.error("--turns must be positive")

    import torch

    from ..engine import engine as engine_mod
    from ..engine.config import EngineConfig
    from ..engine.engine import InferenceEngine
    from ..models.config import get_config
    from ..models.transformer import init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    params = init_params(get_config(args.model), torch.bfloat16, "cuda",
                         torch.Generator(device="cuda").manual_seed(args.seed))
    prompts = _prompts()
    results = {}
    for dispatch in ("bucketed", "ragged"):
        ragged = dispatch == "ragged"
        engine = InferenceEngine(
            EngineConfig(model=args.model, tokenizer="byte", ragged_dispatch=ragged),
            params=params, device="cuda", seed=args.seed)
        try:
            turns = _measure(engine, engine_mod, args, prompts, ragged)
        finally:
            engine.shutdown()
            engine.release_device_state()
        results[dispatch] = turns
        for mode, rows in turns.items():
            xs = [r["tok_s"] for r in rows]
            line = (f"[crossing_cost] {dispatch} {mode}: median {statistics.median(xs):.2f} "
                    f"tok/s (range {min(xs):.2f}-{max(xs):.2f}) over {len(xs)} turns")
            if ragged:
                hs = [r["host_ms_median"] for r in rows if r["host_ms_median"] is not None]
                every = [h for r in rows for h in r["host_ms"]]
                if hs:
                    line += (f"; host ms a ragged dispatch: median of all {len(every)} "
                             f"{statistics.median(every):.3f}, turns' medians "
                             f"{min(hs):.3f}-{max(hs):.3f}")
            print(line, flush=True)
        if "bare" in turns:
            share = (statistics.median(r["tok_s"] for r in turns["scope"])
                     / statistics.median(r["tok_s"] for r in turns["bare"]))
            print(f"[crossing_cost] {dispatch} scope / bare median tok/s: {share:.4f}",
                  flush=True)
    census = dict(engine_mod.__dict__.get("CROSSING_CENSUS", {}))
    print(json.dumps({"crossing_cost": results, "model": args.model,
                      "max_new": args.max_new, "streams": len(prompts),
                      "census": census, "card": smi}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
