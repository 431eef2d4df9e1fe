"""The engine's static dispatch shapes as CUDA graphs: the port's counterpart
of the reference's jitted executables (polykey_tpu/engine/engine.py,
`self._jit_decode`, one compile per static (greedy, steps), and
`self._jit_prefill`, one per static prefill shape).

`CudaGraphs` holds one or more named bodies, each with the keys it is
captured for, and captures one `torch.cuda.CUDAGraph` per (name, key) into
one shared pool. A body is called as `body(*key)`; it runs on tensors
whose addresses never change (weights, KV pools, the lane-state buffers,
the prefill's static operand buffers) and leaves its results in them in
place, so a replay reads and writes the addresses the capture saw. Its one
fresh output (the decode block's packed [steps, B] tokens, a prefill's
sampled token vector, a speculative round's packed matrix) lives in the
graph's memory. The engine's keys: "decode" (greedy, steps), "prefill"
(width, n_pad, greedy, aligned) and, on a speculative engine, "spec"
(gamma, greedy, candidates).

- **When.** `capture` runs once, at engine start, while every lane is
  inactive and every table, the prefill's static ones too, points at the
  garbage page 0: the eager warm-up run before each capture then writes
  only page 0 and leaves the lane state at zero, as the reference's warm-up
  against the reserved garbage page does. A capture while lanes are live
  would advance them and write their KV.
- **What is decided at capture.** Everything a body decides on the host is
  fixed in the graph, as a jit trace fixes it: the kill switches
  (POLYKEY_DISABLE_FLASH, POLYKEY_DISABLE_PAGED_KERNEL,
  POLYKEY_DISABLE_KV_KERNEL) are read while capturing, and setting them
  later changes nothing until a new engine captures again. A body must
  read no tensor on the host (the prefill key fixes `aligned` for that).
- **Streams.** Warm-ups run on the capture stream, so the decode kernels'
  arrival counters (keyed by device and stream,
  ops/paged_attention_kernel.py `arrival_counters`) are allocated before
  the capture begins, not from the graph's pool; every captured call and
  every replay then uses that one buffer, in stream order. A replay runs
  on the caller's current stream.
- **Launch counts.** A replay makes no Python call, so the kernels'
  `launches` would not move: the launches made while capturing are taken
  back out (`ops._build.uncounted`) and added again on every replay
  (`ops._build.count_replay`). Warm-up launches do not count.
- **Memory, and the rule that keeps outputs alive.** All graphs share one
  private pool. Every temporary of a replay is dead when it ends, and each
  graph's output stays referenced here, so no LATER capture was given its
  memory; but a graph captured EARLIER may have used that memory for its
  temporaries. So a replay's output must be consumed before the engine
  replays any other graph: the decode block's tokens are copied to host
  memory, and a prefill's tokens merged into the lane state and copied to
  host memory, in stream order right after their replay. `pool_bytes` is
  what the captures added to the device memory PyTorch holds, and
  `pool_bytes_after[name]` that amount once the bodies up to `name`
  (in the order given) were captured.
- **First replays.** `warm` replays every graph once, uncounted, right
  after the capture and from the same idle state: a graph's first launch
  costs about one 8-step decode block at the 8B shape
  (tools/trace_first_group.py), which the first requests after start
  would otherwise wait for; the warm-up run before each capture never
  launched a graph.
- **No collection while capturing.** Destroying a CUDA graph while a
  stream captures invalidates the capture. An engine that was shut down
  and dropped holds its graphs in reference cycles until Python's cycle
  collector runs, which may be in the middle of a later engine's capture
  (`torch.cuda.graph` no longer collects on entry). So `capture` collects
  first and holds the automatic collector off until its last capture ends.
- **Other threads.** A capture's error mode is thread-local: only
  this thread's unsafe calls fail it. A supervised restart captures a
  fresh engine's graphs while the thread of the engine it replaces may
  still wake from a wedged call; that thread touches the device no more
  (engine/engine.py), but freeing its last pinned copies or events must
  not invalidate this capture as a global-mode capture would.
- **Release.** `release` destroys every graph and drops its output, so a
  dead engine's pool goes back to PyTorch's cache before its replacement
  captures (engine/supervisor.py).
- **No fallback.** A failed capture, a missing key or a failed replay
  raises; nothing here runs a body eagerly on a CUDA device but the
  capture's warm-up. On CPU tensors `run` calls the body itself: that is
  the CPU path, with nothing to capture (`eager` counts those calls).
"""

from __future__ import annotations

import gc
import time
from collections import Counter
from typing import Callable, Iterable

import torch

from ..ops import _build


class CudaGraphs:
    """`bodies` maps a name to (body, keys): `body(*key) -> output` is
    captured once per key (a tuple) in `keys`."""

    def __init__(self, device: torch.device,
                 bodies: dict[str, tuple[Callable[..., torch.Tensor], Iterable[tuple]]]):
        self._device = torch.device(device)
        self._bodies = {name: (body, tuple(sorted(set(keys))))
                        for name, (body, keys) in bodies.items()}
        # (name, key) -> (graph, output, launches made in capture)
        self._graphs: dict = {}
        self.captures: Counter = Counter()
        self.replays: Counter = Counter()
        self.eager: Counter = Counter()
        self.pool_bytes = 0
        self.pool_bytes_after: dict[str, int] = {}
        self.capture_seconds = 0.0
        # Monotonic start and end of the capture (0.0 until it ran).
        self.capture_window = (0.0, 0.0)

    def capture(self) -> None:
        """Warm up and capture every key of every body (CUDA only; on the
        CPU there is nothing to capture). Call while every lane is inactive
        and every static table points at the garbage page."""
        if self._device.type != "cuda":
            return
        t0 = time.monotonic()
        dev = self._device
        main = torch.cuda.current_stream(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(main)
        pool = torch.cuda.graph_pool_handle()
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        collecting = gc.isenabled()
        gc.disable()
        try:
            for name, (body, keys) in self._bodies.items():
                for key in keys:
                    with _build.uncounted(), torch.cuda.stream(stream):
                        body(*key)
                    graph = torch.cuda.CUDAGraph()
                    with _build.uncounted() as made:
                        with torch.cuda.graph(graph, pool=pool, stream=stream,
                                              capture_error_mode="thread_local"):
                            out = body(*key)
                    self._graphs[(name, key)] = (graph, out, made)
                    self.captures[name] += 1
                torch.cuda.synchronize(dev)
                self.pool_bytes_after[name] = torch.cuda.memory_reserved(dev) - reserved
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        t1 = time.monotonic()
        self.capture_seconds = t1 - t0
        self.capture_window = (t0, t1)

    def release(self) -> None:
        """Destroy every graph and drop its output: once no graph uses the
        pool, its memory is PyTorch's to reuse (`torch.cuda.empty_cache`
        returns it to the card). Counters stay."""
        for graph, _, _ in self._graphs.values():
            graph.reset()
        self._graphs.clear()

    def warm(self) -> None:
        """Replay every captured graph once, uncounted, and wait: call right
        after `capture`, in the same idle state (no lane live, every static
        table on the garbage page)."""
        for graph, _, _ in self._graphs.values():
            graph.replay()
        if self._graphs:
            torch.cuda.synchronize(self._device)

    def run(self, name: str, *key) -> torch.Tensor:
        """One dispatch: a graph replay on the current stream (CUDA), or the
        body itself (CPU). On CUDA the output is the graph's own, valid
        until the next replay of any graph (module docstring)."""
        if self._device.type != "cuda":
            self.eager[name] += 1
            return self._bodies[name][0](*key)
        entry = self._graphs.get((name, key))
        if entry is None:
            raise RuntimeError(
                f"no {name} graph for {key}: captured {list(self._bodies[name][1])}"
            )
        graph, out, made = entry
        graph.replay()
        _build.count_replay(made)
        self.replays[name] += 1
        return out
