"""The K-step decode block as CUDA graphs: the port's counterpart of the
reference's jitted `_decode_fn` executable (polykey_tpu/engine/engine.py,
`self._jit_decode`, one compile per static (greedy, steps)).

`DecodeGraphs` captures one `torch.cuda.CUDAGraph` per (greedy, steps)
variant of a block body and replays it as one call. The body runs the
block on the engine's own tensors (weights, KV pools, the lane-state
buffers) and leaves its results in them in place, so a replay reads and
writes the same addresses the capture saw; its only fresh output is the
packed [steps, B] token array, which lives in the graph's memory until the
next replay of that graph overwrites it.

- **When.** `capture` runs once, at engine start, while every lane is
  inactive and points at the garbage page 0: the eager warm-up run before
  each capture then writes only page 0 and leaves the lane state at zero,
  as the reference's warm-up against the reserved garbage page does.
  Capturing while lanes are live would advance them and write their KV.
- **What is decided at capture.** Everything the body decides on the host
  is fixed in the graph, as a jit trace fixes it: the kill switches
  (POLYKEY_DISABLE_PAGED_KERNEL, POLYKEY_DISABLE_KV_KERNEL) are read while
  capturing, and setting them later changes nothing until a new engine
  captures again.
- **Streams.** The warm-up runs on the capture stream, so the decode
  kernels' arrival counters (keyed by device and stream,
  ops/paged_attention_kernel.py `arrival_counters`) are allocated before
  the capture begins, not from the graph's pool; every captured call and
  every replay then uses that one buffer, in stream order. A replay runs
  on the caller's current stream.
- **Launch counts.** A replay makes no Python call, so the kernels'
  `launches` would not move: the launches made while capturing are taken
  back out (`ops._build.uncounted`) and added again on every replay
  (`ops._build.count_replay`). Warm-up launches do not count.
- **Memory.** All graphs share one private pool. That is safe because
  replays run one at a time on one stream, every temporary of a replay is
  dead when it ends, and each graph's packed output stays referenced here,
  so no other graph's capture was given its memory. `pool_bytes` is what
  the captures added to the device memory PyTorch holds.
- **No fallback.** A failed capture or replay raises; nothing here runs
  the block eagerly on a CUDA device. On CPU tensors `run` calls the body
  itself: that is the CPU path, with nothing to capture.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import _build


class DecodeGraphs:
    """The block body `body(greedy=..., steps=...) -> packed` captured once
    per variant in `variants`, an iterable of (greedy, steps)."""

    def __init__(self, body: Callable[..., torch.Tensor], device: torch.device,
                 variants):
        self._body = body
        self._device = torch.device(device)
        self.variants = tuple(sorted(set(variants)))
        # (greedy, steps) -> (graph, packed output, launches made in capture)
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0
        self.pool_bytes = 0

    def capture(self) -> None:
        """Warm up and capture every variant (CUDA only; on the CPU there is
        nothing to capture). Call while every lane is inactive."""
        if self._device.type != "cuda":
            return
        dev = self._device
        main = torch.cuda.current_stream(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(main)
        pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        for greedy, steps in self.variants:
            with _build.uncounted(), torch.cuda.stream(stream):
                self._body(greedy=greedy, steps=steps)
            graph = torch.cuda.CUDAGraph()
            with _build.uncounted() as made:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    packed = self._body(greedy=greedy, steps=steps)
            self._graphs[(greedy, steps)] = (graph, packed, made)
            self.captures += 1
        main.wait_stream(stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def run(self, greedy: bool, steps: int) -> torch.Tensor:
        """One block: a graph replay on the current stream (CUDA), or the
        body itself (CPU). Returns the packed [steps, B] tokens; on CUDA
        they are the graph's own output, valid until its next replay."""
        if self._device.type != "cuda":
            return self._body(greedy=greedy, steps=steps)
        entry = self._graphs.get((greedy, steps))
        if entry is None:
            raise RuntimeError(
                f"no decode graph for greedy={greedy}, steps={steps}: captured "
                f"{sorted(self._graphs)}"
            )
        graph, packed, made = entry
        graph.replay()
        _build.count_replay(made)
        self.replays += 1
        return packed
