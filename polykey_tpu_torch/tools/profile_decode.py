"""Where a decode step's time goes, on the GPU.

    python -m polykey_tpu_torch.tools.profile_decode [--context 512] [--seed 0]

Builds the 32-layer Llama-3-8B with random bf16 weights, puts 16 live lanes
(the default EngineConfig's slots) at `context` positions of the default
paged KV pool, and runs the engine's decode block (`engine._decode_fn`, the
default 8 greedy steps) once to warm up, once on the host clock, and once
under torch.profiler. Prints, per step:
the wall time, the time the device spent in kernels (the sum of the CUDA
kernel spans the profiler recorded), the device's idle share, the kernel
launches, and the kernels that took the most device time. Each line names
the card and its power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: no CUDA device")

    from ..engine.config import EngineConfig
    from ..engine.engine import _decode_fn
    from ..engine.kv_cache import init_paged_kv
    from ..models.config import get_config
    from ..models.transformer import init_params

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    econf = EngineConfig(model="llama-3-8b")
    cfg = get_config(econf.model)
    B, steps = econf.max_decode_slots, econf.decode_block_steps
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, torch.bfloat16, dev, gen)
    paged = init_paged_kv(cfg, econf.num_pages, econf.page_size, torch.bfloat16, dev)
    P, ps = econf.pages_per_seq, econf.page_size
    per = -(-(args.context + 3 * steps) // ps)
    if per > P:
        raise SystemExit(f"profile_decode: context {args.context} needs {per} "
                         f"pages of a {P}-entry table")
    # Distinct pages while the pool lasts; past it, lanes share pages
    # (the data is random either way; every id stays inside the pool).
    ids = 1 + torch.arange(B * per, device=dev) % (econf.num_pages - 1)
    tables = torch.zeros((B, P), dtype=torch.int32, device=dev)
    tables[:, :per] = ids.reshape(B, per).to(torch.int32)
    state = dict(
        last_tokens=torch.randint(3, 259, (B,), generator=gen, device=dev,
                                  dtype=torch.int32),
        seq_lens=torch.full((B,), args.context, dtype=torch.int32, device=dev),
        page_tables=tables,
        active=torch.ones(B, dtype=torch.bool, device=dev),
        caps=torch.full((B,), econf.max_seq_len, dtype=torch.int32, device=dev),
        seeds=torch.zeros((B, 2), dtype=torch.int32, device=dev),
        temperature=torch.zeros(B, device=dev),
        top_p=torch.ones(B, device=dev),
        top_k=torch.zeros(B, dtype=torch.int32, device=dev),
    )

    def block():
        nonlocal paged
        packed, *_, paged = _decode_fn(
            params, cfg, paged, state["last_tokens"], state["seq_lens"],
            state["page_tables"], state["active"], state["caps"], state["seeds"],
            state["temperature"], state["top_p"], state["top_k"],
            greedy=True, steps=steps, eos_id=-1,
        )
        return packed.cpu()

    with torch.inference_mode():
        block()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            block()
            torch.cuda.synchronize()

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3 / steps
    where = (f"{cfg.name} {cfg.num_layers} layers bf16, B={B}, context "
             f"{args.context}, block of {steps} greedy steps, on {card}")
    print(f"[profile_decode] {where}")
    print(f"[profile_decode] per step: wall {wall_ms:.3f} ms (host clock, "
          f"unprofiled block); device busy in kernels {busy_ms:.3f} ms "
          f"(profiled block); idle share {1 - busy_ms / wall_ms:.3f}; "
          f"{len(kernels) / steps:.0f} kernel launches")
    if not kernels:
        print("[profile_decode] the profiler recorded no device kernels: "
              "device time not measured")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        print(f"[profile_decode]   {us / 1e3 / steps:8.3f} ms/step "
              f"{n / steps:6.0f} launches/step  {name[:110]}")


if __name__ == "__main__":
    main()
