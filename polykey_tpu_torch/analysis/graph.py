"""graphlint for the port: what the serving steps DO, checked against five
engine contracts (the reference's polykey_tpu/analysis/graph.py, whose
checks read jaxprs and jit caches; here they read the port's CUDA graphs,
its eager dispatches and the ops they run, through TorchDispatchModes).

| Check | Contract                                                          |
|-------|-------------------------------------------------------------------|
| GL001 | capture stability: every graph is captured at start; a serving    |
|       | sweep captures none, builds no kernel and runs declared keys only |
| GL002 | pools in place: no dispatch moves the KV pools, the scale pools,  |
|       | the lane state or the prefill operands, or makes a pool-sized copy|
| GL003 | dtype policy: no f64 anywhere; no f32 upcast of a bf16 weight     |
| GL004 | host-sync guard: the serving loop syncs only at sanctioned sites, |
|       | and each engine mode fires exactly its census of sites            |
| GL005 | kernel output contracts, gates against the instantiated .cu       |
|       | templates, sharding divisibility                                  |

The engines are the reference's: `tiny-llama` CPU engines of the same
`EngineConfig`s ("full", the gate; "smoke", for the tests), built lazily
and shared by the checks. Entry points run on the CPU; `device="cuda"`
runs them on the card (chip_smoke.py's graphlint phase, Llama-3-8B cut to
a few layers), and raises without CUDA. Deliberate exceptions are class
`SUPPRESSIONS` with their reason; pre-existing debt goes through the
content-hashed baseline (`torch-graphlint-baseline.json`); a broken probe
is a blocking GL000, never a clean result.

GL001's census maps the port's graph bodies to the reference's jitted
handles (`JAX_HANDLES`): a body's keys are the static arguments a handle
compiles one executable for, with these differences, each counted in the
census the tests hold against the reference's executables:

- "decode" (greedy, steps) is `_jit_decode`; the port captures the sampled
  variants always (the reference compiles them under
  `warm_sampled_variants`, a knob the port does not have);
- "prefill" (width, n_pad, greedy, aligned) is `_jit_prefill` (and on a
  speculative engine `_jit_spec_prefill`: the body fills both pools);
  `aligned` takes one value a width (`engine.prefill_graph_keys`), so it
  adds no graph; the port captures every group pad (1, 2, 4, 8), the
  reference the pads its slots can reach (1; 2 from 2 slots; 4 from 3; 8
  from 5);
- "spec" (gamma, greedy, candidates) is `_jit_spec_decode`;
- `_jit_merge`, `_jit_retire`, `_jit_kv_gather` and `_jit_kv_restore` are
  in-place writes and gathers in the port, eager, with no graph; so are
  `_jit_ragged` and `_jit_ragged_spec` (ROADMAP.md A.2).

Run::

    python -m polykey_tpu_torch.analysis graph            # the gate
    python -m polykey_tpu_torch.analysis graph --json     # machine-readable
"""

from __future__ import annotations

import argparse
import contextlib
import json
import queue
import re
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .core import (
    Finding,
    UsageError,
    apply_baseline,
    load_baseline,
    parse_only,
    prune_baseline,
    require_full_run,
    write_baseline,
)

GRAPH_BASELINE = "torch-graphlint-baseline.json"
CSRC = Path(__file__).resolve().parents[1] / "csrc"

# Raised for each collected stream before the engine is declared wedged.
_COLLECT_TIMEOUT_S = 180.0

JAX_HANDLES = {"decode": "_jit_decode", "prefill": "_jit_prefill",
               "spec": "_jit_spec_decode"}


# -- check registry -----------------------------------------------------------


class GraphCheck:
    """One contract. Subclasses set id/name/description and implement
    run(env) -> list[Finding]. SUPPRESSIONS maps a finding's key to the
    reason it is a deliberate, reviewed exception."""

    id: str = "GL000"
    name: str = "unnamed"
    description: str = ""
    SUPPRESSIONS: dict[str, str] = {}

    def run(self, env: "GraphEnv") -> list[Finding]:
        raise NotImplementedError


_GRAPH_REGISTRY: dict[str, GraphCheck] = {}


def register_graph(cls: type[GraphCheck]) -> type[GraphCheck]:
    inst = cls()
    if inst.id in _GRAPH_REGISTRY:
        raise ValueError(f"duplicate graph check id {inst.id}")
    _GRAPH_REGISTRY[inst.id] = inst
    return cls


def all_graph_checks() -> list[GraphCheck]:
    return [_GRAPH_REGISTRY[k] for k in sorted(_GRAPH_REGISTRY)]


def graph_finding(rule: str, path: str, key: str, message: str) -> Finding:
    """A graph-tier finding. `key` is its stable identity (the baseline's
    fingerprint and the SUPPRESSIONS lookup): no counters, addresses or
    timings in it."""
    return Finding(rule=rule, path=path, line=0, message=message, snippet=key)


# -- engine driving (GL001, GL002, GL004) -------------------------------------


def _collect_stream(request, timeout: float = _COLLECT_TIMEOUT_S):
    """Drain one GenRequest's out queue; returns (tokens, error)."""
    tokens: list[int] = []
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return tokens, "timed out waiting for engine output"
        try:
            kind, value = request.out.get(timeout=remaining)
        except queue.Empty:
            return tokens, "timed out waiting for engine output"
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens, None
        else:
            return tokens, str(value)


def drive_engine(engine, waves: list[list]) -> list[str]:
    """Submit requests wave by wave (later waves land while earlier ones
    decode: the occupancy variation GL001 needs) and drain every stream.
    Returns the error strings (empty: a clean run)."""
    errors: list[str] = []
    submitted = []
    for wave in waves:
        for request in wave:
            try:
                engine.submit(request)
            except Exception as e:      # a dead engine refuses: an error, not a crash
                errors.append(f"submit refused: {e}")
                continue
            submitted.append(request)
        time.sleep(0.05)
    for request in submitted:
        _, error = _collect_stream(request)
        if error is not None:
            errors.append(error)
    return errors


def graph_census(graphs) -> dict:
    """{body: (keys captured, captures, replays, eager calls)} of a
    `CudaGraphs`. On the CPU nothing is captured and a body's declared keys
    stand for its captures (what the card would capture)."""
    cuda = graphs.device.type == "cuda"
    return {
        name: (graphs.captures[name] if cuda else len(graphs.keys(name)),
               graphs.captures[name], graphs.replays[name], graphs.eager_calls(name))
        for name in graphs.names
    }


def recompile_findings(label: str, graphs, drive: Callable[[], list[str]]
                       ) -> tuple[list[Finding], dict]:
    """Core of GL001 for one engine: run `drive`; a body with no key
    captured before it is cold (its first dispatch on the card raises); a
    capture during it, a key refused as undeclared, or a kernel library
    built during it is a finding. Returns (findings, census {body: (before,
    after)})."""
    from ..ops import _build

    before = graph_census(graphs)
    refused = Counter(graphs.refused)
    loads = _build.loads
    errors = drive()
    after = graph_census(graphs)
    findings = [graph_finding(
        "GL000", f"graph:{label}", f"{label}:drive-error",
        f"GL001 sweep on {label} hit a request error: {error}",
    ) for error in errors]
    for name, (keys, captures, _, _) in before.items():
        if keys == 0:
            findings.append(graph_finding(
                "GL001", f"graph:{label}", f"{label}:{name}:cold",
                f"{name} has no key captured at start: its first dispatch on "
                "the card raises (no graph for the key), and the warm-up no "
                "longer covers this step",
            ))
        if after[name][1] > captures:
            findings.append(graph_finding(
                "GL001", f"graph:{label}", f"{label}:{name}:grew",
                f"{name} captured {after[name][1] - captures} graph(s) during "
                "the serving sweep: a capture at serving time stalls the loop "
                "and grows the pool",
            ))
    for (name, key), n in sorted((Counter(graphs.refused) - refused).items()):
        findings.append(graph_finding(
            "GL001", f"graph:{label}", f"{label}:{name}:undeclared",
            f"{name} was asked {n}x for key {key}, which it was never "
            f"declared for (declared {list(graphs.keys(name))}): a shape "
            "the warm-up does not cover reached serving",
        ))
    if _build.loads != loads:
        findings.append(graph_finding(
            "GL001", f"graph:{label}", f"{label}:kernel-built",
            "the kernel library was built or loaded during the serving "
            "sweep: the first request paid nvcc or the load",
        ))
    return findings, {name: (before[name], after[name]) for name in before}


# -- dispatch modes (GL002, GL003) --------------------------------------------


class PoolWatch(TorchDispatchMode):
    """Record every op that makes a tensor of page rows (its last three
    dims a page's, (page_size, kv heads, head_dim)) of at least `threshold`
    elements (the smallest KV value pool's), in fresh memory: a dispatch
    that copies or rebuilds a pool makes one. In-place ops and views,
    whose outputs share an input's storage, do not count; nor do
    activations, whose last dims are no page's. Entered on the engine
    thread (`loop_guard`)."""

    def __init__(self, threshold: int, page: tuple, seen: Counter):
        super().__init__()
        self.threshold = threshold
        self.page = tuple(page)
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        made = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                and t.numel() >= self.threshold and tuple(t.shape[-3:]) == self.page]
        if made:
            held = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)}
            for t in made:
                if t.untyped_storage().data_ptr() not in held:
                    self.seen[f"{func}{tuple(t.shape)}"] += 1
        return out


class DtypeWalk(TorchDispatchMode):
    """Record each op's input and output (dtype, shape): GL003's walk of
    one dispatch, as the reference walks a traced step's jaxpr."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func), _specs((args, kwargs)), _specs(out)))
        return out


def _specs(tree) -> list:
    return [(t.dtype, tuple(t.shape)) for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def dtype_findings(label: str, ops: list, weight_shapes: set, bf16_path: bool
                   ) -> list[Finding]:
    """Core of GL003 over a `DtypeWalk`'s ops: any op that makes a float64
    or complex128 value from inputs that hold none (the promotion point;
    the ops downstream of it are its consequences): with a bf16/f32 stack
    an f64 is an accident, and it doubles the bytes where it lands; and on
    a bf16 path, any op that turns a bf16 tensor shaped like a weight (a
    params leaf of ndim >= 2 and at least 1024 elements) into float32, by
    a cast, a copy or a promotion: the silent upcast that doubles a
    weight's read every step. fp32 norms, RoPE and logits on activations
    do not fire: only weight shapes do."""
    wide = (torch.float64, torch.complex128)
    findings: list[Finding] = []
    seen: set = set()
    for name, ins, outs in ops:
        made = [(d, shape) for d, shape in outs if d in wide]
        if made and not any(d in wide for d, _ in ins):
            key = f"{label}:f64:{name}"
            if key not in seen:
                seen.add(key)
                findings.append(graph_finding(
                    "GL003", f"graph:{label}", key,
                    f"{made[0][0]} value {made[0][1]} made by {name} in {label}: "
                    "the serving stack is bf16/f32; an f64 is an accidental "
                    "promotion",
                ))
        if not bf16_path or not any(d == torch.float32 for d, _ in outs):
            continue
        for dtype, shape in ins:
            if dtype == torch.bfloat16 and shape in weight_shapes:
                key = f"{label}:upcast:{shape}"
                if key not in seen:
                    seen.add(key)
                    findings.append(graph_finding(
                        "GL003", f"graph:{label}", key,
                        f"bf16 weight tensor {shape} made float32 by {name} "
                        f"inside {label}: doubles its read on every step; keep "
                        "weights bf16 into the matmul",
                    ))
    return findings


def weight_shapes(params) -> set:
    """Shapes of the params leaves a weight upcast would be read in."""
    return {tuple(t.shape) for t in tree_leaves(params)
            if isinstance(t, torch.Tensor) and t.dim() >= 2 and t.numel() >= 1024}


# -- shape/layout contracts (GL005) -------------------------------------------


def sharding_divisibility(label: str, shape: tuple, spec, mesh_shape: dict
                          ) -> list[Finding]:
    """Core of GL005's sharding half: every dimension a spec splits must
    divide by its axes' extent (`local_bounds` would raise on the rank, and
    the reference's GSPMD pads the remainder)."""
    findings = []
    for dim, (size, axes) in enumerate(zip(shape, tuple(spec))):
        if axes is None:
            continue
        extent = 1
        for axis in (axes if isinstance(axes, tuple) else (axes,)):
            extent *= mesh_shape.get(axis, 1)
        if extent > 1 and size % extent != 0:
            findings.append(graph_finding(
                "GL005", f"graph:{label}", f"{label}:dim{dim}:{size}%{extent}",
                f"{label}: dim {dim} (size {size}) is split over {axes!r} "
                f"(extent {extent}) but {size} % {extent} != 0",
            ))
    return findings


def instantiated_geometry(csrc: Path = CSRC) -> dict:
    """What the .cu templates are instantiated for, read from the sources:
    head dims per kernel, the decode kernels' query groups, and the
    compile-time limits the wrappers mirror."""
    flash = (csrc / "flash_attention.cu").read_text()
    decode = (csrc / "paged_attention_decode.cu").read_text()
    ragged = (csrc / "ragged_paged_attention.cu").read_text()

    def ints(pattern, text):
        return frozenset(int(x) for x in re.findall(pattern, text))

    def const(name, text):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        return int(found.group(1)) if found else None

    return {
        "flash_dims": ints(r"launch<(\d+)>\(", flash),
        "decode_dims": ints(r"case (\d+): PK_DECODE_G", decode),
        "decode_groups": ints(r"launch<DD, (\d+), KV>", decode),
        "ragged_dims": ints(r"launch<(\d+), KV>\(a", ragged),
        "kMaxSplitPages": const("kMaxSplitPages", decode),
        "kMaxSplitPagesInt8": const("kMaxSplitPagesInt8", decode),
        "BM": const("BM", ragged),
    }


def decode_admits(head_dim: int, groups: int) -> bool:
    """Whether the decode wrapper (`paged_decode_cuda`) takes this geometry
    rather than refusing it."""
    from ..ops import paged_attention_kernel as pak

    return head_dim in pak.DECODE_HEAD_DIMS and groups in pak.DECODE_GROUPS


def ragged_admits(head_dim: int, groups: int) -> bool:
    """Whether the ragged wrapper (`ragged_attention_cuda`) takes this
    geometry rather than refusing it."""
    from ..ops import ragged_paged_attention_kernel as rk

    return head_dim in rk.RAGGED_HEAD_DIMS and groups in rk.RAGGED_GROUPS


def gate_consistency_findings(configs, geometry: Optional[dict] = None,
                              page_sizes=(8, 16)) -> list[Finding]:
    """Core of GL005's gate half: a gate or a wrapper that admits a
    geometry the .cu template is not instantiated for sends the card into
    a mis-tiled launch; a wrapper constant that differs from its kernel's
    compile-time limit mis-sizes what it passes. The paged and ragged gates
    are kill switches alone: on the card their wrappers refuse (ValueError)
    a geometry outside their constants, which `_kernel_contracts` holds."""
    from ..ops import flash_attention as fa
    from ..ops import paged_attention_kernel as pak
    from ..ops import ragged_paged_attention_kernel as rk

    geo = geometry or instantiated_geometry()
    findings: list[Finding] = []

    def fire(key, message):
        findings.append(graph_finding("GL005", "graph:ops.gates", key, message))

    pairs = (("FLASH_HEAD_DIMS", fa.FLASH_HEAD_DIMS, geo["flash_dims"]),
             ("DECODE_HEAD_DIMS", pak.DECODE_HEAD_DIMS, geo["decode_dims"]),
             ("DECODE_GROUPS", pak.DECODE_GROUPS, geo["decode_groups"]),
             ("RAGGED_HEAD_DIMS", rk.RAGGED_HEAD_DIMS, geo["ragged_dims"]),
             ("MAX_SPLIT_PAGES", pak.MAX_SPLIT_PAGES, geo["kMaxSplitPages"]),
             ("MAX_SPLIT_PAGES_INT8", pak.MAX_SPLIT_PAGES_INT8, geo["kMaxSplitPagesInt8"]),
             ("TILE_ROWS", rk.TILE_ROWS, geo["BM"]))
    for name, wrapper, source in pairs:
        if wrapper != source:
            fire(f"constant:{name}", f"the wrapper's {name} {sorted(wrapper) if isinstance(wrapper, frozenset) else wrapper} "
                 f"differs from the .cu's {sorted(source) if isinstance(source, frozenset) else source}")
    for cfg in configs:
        D, G = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
        decode = decode_admits(D, G)
        checks = (
            ("flash", fa.use_flash(128, 128, D), D in geo["flash_dims"]),
            ("paged", pak.use_paged_kernel() and decode,
             D in geo["decode_dims"] and G in geo["decode_groups"]),
            ("paged-int8", pak.use_quantized_paged_kernel() and decode,
             D in geo["decode_dims"] and G in geo["decode_groups"]),
            ("ragged", rk.use_ragged_kernel() and ragged_admits(D, G),
             D in geo["ragged_dims"] and geo["BM"] % G == 0),
        )
        for gate, admits, instantiated in checks:
            if admits and not instantiated:
                fire(f"{gate}-gate:{cfg.name}",
                     f"{cfg.name}: the {gate} path admits head_dim {D}, {G} "
                     "query heads a kv head, which its .cu template is not "
                     "instantiated for: a mis-tiled launch on the card")
    for ps in page_sizes:
        for int8, limit in ((False, geo["kMaxSplitPages"]), (True, geo["kMaxSplitPagesInt8"])):
            if pak.split_pages(ps, int8) > limit:
                fire(f"split-pages:{ps}:{int8}",
                     f"page size {ps}: the wrapper's split of "
                     f"{pak.split_pages(ps, int8)} pages exceeds the kernel's "
                     f"table of {limit}")
    return findings


def abstract_contract(label: str, fn: Callable, args: tuple,
                      expected: list) -> list[Finding]:
    """Core of GL005's kernel half: call a kernel wrapper on `meta` tensors
    (its checks and allocations run, nothing launches: `ops._build.Kernel`)
    and compare its flattened outputs with [(shape, dtype name)]. A raise
    means the wrapper refuses a geometry it should take."""
    try:
        out = fn(*args)
    except Exception as e:
        return [graph_finding(
            "GL005", f"graph:{label}", f"{label}:abstract-eval",
            f"abstract evaluation of {label} failed: {type(e).__name__}: "
            f"{str(e).splitlines()[0][:160]}",
        )]
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    want = [(tuple(shape), dtype) for shape, dtype in expected]
    if got != want:
        return [graph_finding(
            "GL005", f"graph:{label}", f"{label}:out-contract",
            f"{label}: outputs {got} != contract {want}",
        )]
    return []


def refusal_findings(label: str, fn: Callable, args: tuple) -> list[Finding]:
    """A geometry no gate admits must be refused loudly by its wrapper
    (ValueError), never launched."""
    try:
        fn(*args)
    except ValueError:
        return []
    return [graph_finding(
        "GL005", f"graph:{label}", f"{label}:refusal-toothless",
        f"{label} took a geometry its kernel is not instantiated for without "
        "raising: a mis-tiled launch on the card",
    )]


# -- the fixture environment --------------------------------------------------


def _empty_lanes(B: int, P: int, device, gamma: int = 0) -> dict:
    """Idle lane state (every table on the garbage page 0)."""
    i32 = dict(dtype=torch.int32, device=device)
    lanes = dict(
        last_tokens=torch.zeros(B, **i32), seq_lens=torch.zeros(B, **i32),
        page_tables=torch.zeros((B, P), **i32),
        active=torch.zeros(B, dtype=torch.bool, device=device),
        caps=torch.zeros(B, **i32), seeds=torch.zeros((B, 2), **i32),
        temperature=torch.zeros(B, device=device), top_p=torch.ones(B, device=device),
        top_k=torch.zeros(B, **i32),
    )
    if gamma:
        lanes["accept_ewma"] = torch.ones(B, device=device)
        lanes["gamma_lane"] = torch.full((B,), gamma, **i32)
    return lanes


class GraphEnv:
    """Fixtures shared by the checks: warmed engines of the reference's
    modes (plain, spec, ragged, spec x ragged, host KV), built on first use
    and kept until `close`.

    profile="full" is the gate; "smoke" shrinks it for the tests (2 slots,
    one bucket, greedy only, the plain engine alone). `device` is "cpu"
    unless the caller asks for "cuda". `model`, `params` and `dtype` put
    another model on the engines (chip_smoke.py: Llama-3-8B cut to a few
    layers, one set of bf16 weights shared by every engine, the spec
    engines drafting with the target itself); `overrides` replace fields
    of the base config (the card's page size, pages and buckets)."""

    def __init__(self, profile: str = "full", device: str = "cpu",
                 model: str = "tiny-llama", params=None, dtype: str = "float32",
                 overrides: Optional[dict] = None):
        from ..device import resolve_device

        if profile not in ("full", "smoke"):
            raise ValueError(f"profile must be 'full' or 'smoke', got {profile!r}")
        self.profile = profile
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.dtype = dtype
        self.overrides = dict(overrides or {})
        self.logs: list[str] = []
        self.sweep_launches: Counter = Counter()
        self.trips: list = []
        self.census: dict = {}
        self._engines: dict = {}

    # -- configs -------------------------------------------------------------

    def _base_config(self):
        from ..engine.config import EngineConfig

        if self.profile == "smoke":
            cfg = dict(max_decode_slots=2, page_size=8, num_pages=64, max_seq_len=64,
                       prefill_buckets=(16,), max_new_tokens_cap=16,
                       default_max_new_tokens=6)
        else:
            cfg = dict(max_decode_slots=4, page_size=8, num_pages=64, max_seq_len=64,
                       prefill_buckets=(16, 32), max_new_tokens_cap=32,
                       default_max_new_tokens=8)
        cfg.update(self.overrides)
        return EngineConfig(model=self.model, tokenizer="byte", dtype=self.dtype, **cfg)

    _MODES = {
        "engine.plain": {},
        "engine.spec": {"spec": True},
        "engine.ragged": {"ragged_dispatch": True},
        "engine.spec_ragged": {"spec": True, "ragged_dispatch": True},
        "engine.hostkv": {"hostkv": True},
    }

    def config(self, label: str):
        import dataclasses

        base = self._base_config()
        mode = dict(self._MODES[label])
        extra = {}
        if mode.pop("spec", False):
            extra.update(draft_model=self.model, spec_gamma=2)
        if mode.pop("hostkv", False):
            # A deliberately tight pool and a high resident floor: the
            # sweep spills cold prefix pages at retire and, driven twice,
            # faults them back (the reference's 28 pages and floor of 24 at
            # 8 pages a sequence, scaled by the sequence's pages).
            P = base.pages_per_seq
            extra.update(prefix_cache=True, num_pages=(7 * P) // 2,
                         host_kv_bytes=64 << 20, host_kv_resident_pages=3 * P)
        return dataclasses.replace(base, **mode, **extra)

    # -- engines -------------------------------------------------------------

    def engine(self, label: str):
        if label not in self._engines:
            from ..engine.engine import InferenceEngine

            self.logs.append(f"building {label} on {self.device.type}")
            config = self.config(label)
            spec = config.draft_model is not None
            self._engines[label] = InferenceEngine(
                config, params=self.params, device=self.device, seed=0,
                draft_params=self.params if spec else None)
        return self._engines[label]

    def labels(self) -> list[str]:
        return ["engine.plain"] if self.profile == "smoke" else list(self._MODES)

    def engines(self) -> Iterator:
        for label in self.labels():
            yield label, self.engine(label)

    def request_mix(self, sampled: bool) -> list[list]:
        """The sweep: a slot-filling greedy burst (group widths 1/2/4), a
        mid-flight sampled wave (sampled variants, top-k/top-p), then a
        chunked long prompt plus a short chaser. Lengths follow the
        buckets: at (16, 32) they are the reference's."""
        from ..engine.engine import GenRequest

        buckets = self._base_config().prefill_buckets
        b0, b1 = buckets[0], buckets[-1]
        text = ("abcdefgh" * (b1 // 4 + 8))

        def req(n: int, temperature: float = 0.0, top_p: float = 1.0,
                top_k: int = 0) -> GenRequest:
            return GenRequest(prompt=text[:n], max_new_tokens=6,
                              temperature=temperature, top_p=top_p, top_k=top_k, seed=7)

        if self.profile == "smoke":
            return [[req(3), req(12 * b0 // 16)], [req(b1 + 24 * b1 // 16)], [req(7)]]
        waves = [[req(3), req(10 * b0 // 16), req(b0 + 4), req(b1 - 4)]]
        if sampled:
            waves.append([req(5, temperature=0.7, top_p=0.9, top_k=5),
                          req(b0 + 2, temperature=1.0)])
        waves.append([req(b1 + 8), req(6)])
        return waves

    def sweep(self, engine, waves: list, guard: Optional[Callable] = None) -> list[str]:
        """Drive `waves` at lookahead depths 1 and 2 (the synchronous shape
        and the overlapped one), each iteration inside `guard()` on the
        engine thread when given; the configured depth is restored. Kernel
        launches made are added to `sweep_launches`."""
        from ..engine.engine import KERNELS

        configured = engine._depth
        launches = {name: k.launches for name, k in KERNELS.items()}
        inside = [0]            # iterations inside a guard, on the engine thread

        @contextlib.contextmanager
        def tracked():
            inside[0] += 1
            try:
                with guard():
                    yield
            finally:
                inside[0] -= 1

        engine.loop_guard = tracked if guard is not None else None
        errors: list[str] = []
        try:
            for depth in (1, 2):
                engine.set_lookahead(depth)
                errors.extend(drive_engine(engine, waves))
        finally:
            engine.loop_guard = None
            engine._wake.set()
            deadline = time.monotonic() + 10.0
            while inside[0] and time.monotonic() < deadline:
                time.sleep(0.002)       # the iteration in flight leaves its guard
            if inside[0]:
                errors.append("the engine thread did not leave the guard in 10 s")
            engine.set_lookahead(configured)
            for name, k in KERNELS.items():
                self.sweep_launches[name] += k.launches - launches[name]
        return errors

    # -- GL003's dispatches --------------------------------------------------

    def step_walks(self) -> Iterator:
        """(label, DtypeWalk ops, weight shapes, bf16 path) for one dispatch
        of each step (prefill, decode block, ragged, spec round, ragged
        spec), run on weights and small pools of their own (every table on
        the garbage page, every lane idle): f32 and bf16 on the CPU, bf16 on
        the card."""
        from ..engine import engine as engine_mod
        from ..engine.kv_cache import init_paged_kv
        from ..engine.spec_decode import ragged_spec_fn, spec_decode_fn
        from ..models.config import get_config
        from ..models.transformer import init_params
        from ..ops.ragged_paged_attention_kernel import TOKEN_TILE

        cfg = get_config(self.model)
        base = self._base_config()
        B, P, ps = base.max_decode_slots, base.pages_per_seq, base.page_size
        dev = self.device
        dtypes = (("bf16", torch.bfloat16),) if dev.type == "cuda" else (
            ("bf16", torch.bfloat16), ("f32", torch.float32))
        for label, dtype in dtypes:
            params = self.params if self.params is not None else init_params(
                cfg, dtype, dev, torch.Generator(device=dev).manual_seed(0))
            shapes = weight_shapes(params)
            paged = init_paged_kv(cfg, 2 * P + 1, ps, dtype, dev)
            lanes = _empty_lanes(B, P, dev, gamma=2)
            lane_args = [lanes[k] for k in ("last_tokens", "seq_lens", "page_tables",
                                            "active", "caps", "seeds", "temperature",
                                            "top_p", "top_k")]
            bucket = base.prefill_buckets[0]
            i32 = dict(dtype=torch.int32, device=dev)
            window = (torch.zeros((1, bucket), **i32), torch.zeros(1, **i32),
                      torch.zeros(1, **i32), torch.zeros((1, P), **i32),
                      torch.zeros((1, 2), **i32), torch.zeros(1, device=dev),
                      torch.ones(1, device=dev), torch.zeros(1, **i32))
            G, Hk = cfg.num_heads // cfg.num_kv_heads, cfg.num_kv_heads

            def ragged(G1):
                """(prefill operands, work list) of an idle stream of B
                windows of G1 rows and 16 prefill rows, tile-padded."""
                W = 16 + (-(B * G1 + 16)) % TOKEN_TILE
                ops = [torch.from_numpy(a).to(dev)
                       for a in engine_mod.ragged_zero_operands(B, W, P)]
                return ops, _idle_work(B, G1, W, G, Hk, dev)

            common = dict(eos_id=2, candidates=0)
            spec = dict(gamma=2, gamma_low=1, gamma_max=2, greedy=False, **common)
            dial = (lanes["accept_ewma"], lanes["gamma_lane"])
            pre, work = ragged(1)
            spre, swork = ragged(3)
            steps = {
                "_prefill_fn": lambda: engine_mod._prefill_fn(
                    params, cfg, paged, *window, greedy=False, aligned=bucket % ps == 0),
                "_decode_fn": lambda: engine_mod._decode_fn(
                    params, cfg, paged, *lane_args, greedy=False, steps=2, **common),
                "_ragged_fn": lambda: engine_mod._ragged_fn(
                    params, cfg, paged, *lane_args, *pre, greedy=False, work=work, **common),
                "spec_decode_fn": lambda: spec_decode_fn(
                    params, params, cfg, cfg, paged, paged, *lane_args, *dial, **spec),
                "ragged_spec_fn": lambda: ragged_spec_fn(
                    params, params, cfg, cfg, paged, paged, *lane_args, *dial, *spre,
                    t_work=swork, d_work=swork, **spec),
            }
            for name, call in steps.items():
                walk = DtypeWalk()
                with torch.inference_mode(), walk:
                    call()
                yield f"engine.{label}.{name}", walk.ops, shapes, dtype == torch.bfloat16

    def close(self) -> None:
        for engine in self._engines.values():
            engine.shutdown()
            if engine.device.type == "cuda":
                engine.release_device_state()
        self._engines.clear()


def _idle_work(B: int, G1: int, W: int, groups: int, kv_heads: int, device):
    """The ragged kernel's work list for B idle windows of G1 rows and an
    empty W-row prefill stream (`engine._ragged_work_lists`' layout)."""
    from ..ops.ragged_paged_attention_kernel import ragged_work

    starts = list(range(0, B * G1, G1)) + [B * G1 + W] * B
    return ragged_work(starts, [G1] * B + [0] * B, [G1] * B + [0] * B,
                       B * G1 + W, groups, kv_heads, device)


def pool_pointers(engine) -> dict:
    """The addresses the graphs captured: every KV and scale pool (the
    draft's too), every lane-state buffer and every prefill operand
    buffer."""
    out = {}
    for prefix, paged in (("kv", engine.paged), ("draft_kv", getattr(engine, "d_paged", None))):
        if paged is not None:
            for i, t in enumerate(paged.pools):
                out[f"{prefix}[{i}]"] = t.data_ptr()
    for name, t in engine._dev.items():
        out[f"lanes.{name}"] = t.data_ptr()
    for n, ops in engine._prefill_ops.items():
        out[f"prefill_ops[{n}]"] = ops.buf.data_ptr()
    return out


def smallest_pool(engine) -> int:
    """Elements of the smallest KV value pool (the target's or the draft's)."""
    pools = [engine.paged.k, engine.paged.v]
    if engine._spec:
        pools += [engine.d_paged.k, engine.d_paged.v]
    return min(t.numel() for t in pools)


# -- GL001: capture stability -------------------------------------------------


@register_graph
class RecompileStability(GraphCheck):
    """After start, a mixed-occupancy sweep (bucketed and chunked prefill,
    greedy and sampled decode, admissions mid-decode, retires, spec rounds
    with the gamma dial) at lookahead depths 1 and 2 captures no graph,
    builds no kernel and asks every body only for keys it was declared
    (on the card: captured) for. The census logs each body's keys beside
    the reference's handle (module docstring)."""

    id = "GL001"
    name = "capture-stability"
    description = ("every graph is captured at start; a serving sweep at "
                   "lookahead depths 1 and 2 captures none and runs declared keys")

    def run(self, env: GraphEnv) -> list[Finding]:
        findings: list[Finding] = []
        census: dict = {}
        for label, engine in env.engines():
            mix = env.request_mix(sampled=env.profile != "smoke")
            found, sizes = recompile_findings(
                label, engine._graphs, lambda e=engine, m=mix: env.sweep(e, m))
            findings.extend(found)
            census[label] = sizes
            env.census[label] = {
                name: {"keys": before[0], "captures": after[1],
                       "replays": after[2] - before[2], "eager": after[3] - before[3],
                       "reference": JAX_HANDLES.get(name)}
                for name, (before, after) in sizes.items()}
            env.logs.append(f"GL001 {label} (depths 1+2): " + ", ".join(
                f"{name}[{JAX_HANDLES.get(name, '-')}] keys={b[0]} captures {b[1]}->{a[1]}"
                f" replays {a[2] - b[2]} eager {a[3] - b[3]}"
                for name, (b, a) in sorted(sizes.items())))
        findings.extend(self.census_findings(census, env))
        return findings

    @staticmethod
    def census_findings(census: dict, env) -> list[Finding]:
        """The ragged modes' census claim (the reference's): no prefill
        graph exists or runs there, and the mode holds strictly fewer keys
        than its bucketed twin at the same geometry."""
        findings: list[Finding] = []
        for ragged, plain in (("engine.ragged", "engine.plain"),
                              ("engine.spec_ragged", "engine.spec")):
            if ragged not in census or plain not in census:
                continue
            if "prefill" in census[ragged]:
                findings.append(graph_finding(
                    "GL001", f"graph:{ragged}", f"{ragged}:prefill:not-gone",
                    f"the {ragged} engine holds a prefill graph body: its "
                    "admissions ride the ragged stream, so a bucketed prefill "
                    "there means a path leaked back to the bucket table",
                ))
            totals = [sum(b[0] for b, _ in census[label].values())
                      for label in (ragged, plain)]
            if totals[0] >= totals[1]:
                findings.append(graph_finding(
                    "GL001", f"graph:{ragged}", f"{ragged}:census-not-smaller",
                    f"{ragged} holds {totals[0]} graph keys, not fewer than "
                    f"{plain}'s {totals[1]} at the same geometry",
                ))
            env.logs.append(f"GL001 census: {plain}={totals[1]} {ragged}={totals[0]}")
        return findings


# -- GL002: pools in place ----------------------------------------------------


@register_graph
class PoolsInPlace(GraphCheck):
    """The counterpart of the reference's donation audit: the graphs read
    and write fixed addresses, so no dispatch may reallocate the KV pools,
    the int8 scale pools, the lane-state buffers or the prefill's operand
    buffers (their data_ptr is the same after a sweep that spills,
    restores and hits the prefix cache), and no op inside a dispatch makes
    a tensor as large as the smallest KV value pool (a copy of one)."""

    id = "GL002"
    name = "pools-in-place"
    description = ("no dispatch reallocates a pool, the lane state or the "
                   "prefill operands, or makes a pool-sized tensor")

    def run(self, env: GraphEnv) -> list[Finding]:
        findings: list[Finding] = []
        for label, engine in env.engines():
            before = pool_pointers(engine)
            pool_bytes = engine._graphs.pool_bytes
            seen: Counter = Counter()
            threshold = smallest_pool(engine)
            page = tuple(engine.paged.k.shape[-3:])
            errors = env.sweep(engine, env.request_mix(sampled=False),
                               lambda: PoolWatch(threshold, page, seen))
            after = pool_pointers(engine)
            for error in errors:
                findings.append(graph_finding(
                    "GL000", f"graph:{label}", f"{label}:drive-error",
                    f"GL002 sweep on {label} hit a request error: {error}"))
            for name in sorted(before):
                if after.get(name) != before[name]:
                    findings.append(graph_finding(
                        "GL002", f"graph:{label}", f"{label}:moved:{name}",
                        f"{name} moved during the sweep: the graphs captured "
                        "its old address, so their replays read and write freed "
                        "memory",
                    ))
            for what in sorted(seen):
                findings.append(graph_finding(
                    "GL002", f"graph:{label}", f"{label}:pool-sized:{what.split('(')[0]}",
                    f"{what} made a tensor of page rows of at least {threshold} "
                    f"elements (the smallest KV value pool) {seen[what]}x inside "
                    "a dispatch: a pool copy costs its bytes every time",
                ))
            if engine._graphs.pool_bytes != pool_bytes:
                findings.append(graph_finding(
                    "GL002", f"graph:{label}", f"{label}:graph-pool-grew",
                    f"the graph pool went {pool_bytes} -> "
                    f"{engine._graphs.pool_bytes} bytes during the sweep"))
            if engine._host_kv is not None:
                m = engine.metrics
                hits = engine._prefix.hit_tokens + engine._prefix.host_hit_tokens
                if not (m.kv_pages_evicted and m.kv_pages_restored and hits):
                    findings.append(graph_finding(
                        "GL000", f"graph:{label}", f"{label}:hostkv-not-exercised",
                        f"GL002's host-KV sweep recorded {m.kv_pages_evicted} "
                        f"evictions, {m.kv_pages_restored} restores and {hits} "
                        "prefix-hit tokens: it no longer moves pages both ways"))
            env.logs.append(
                f"GL002 {label}: {len(before)} buffers in place "
                f"{sum(after.get(k) == v for k, v in before.items())}/{len(before)}, "
                f"pool-sized ops {sum(seen.values())}, graph pool "
                f"{engine._graphs.pool_bytes} bytes")
        return findings


# -- GL003: dtype policy ------------------------------------------------------


@register_graph
class DtypePolicy(GraphCheck):
    """One dispatch of each step obeys the dtype policy: no float64
    anywhere, and no f32 upcast of a weight-shaped bf16 tensor on a bf16
    path. fp32 norms, RoPE, softmax and logits are the design and do not
    fire."""

    id = "GL003"
    name = "dtype-policy"
    description = "no f64 anywhere; bf16 paths never upcast weight tensors to f32"

    def run(self, env: GraphEnv) -> list[Finding]:
        findings: list[Finding] = []
        for label, ops, shapes, bf16 in env.step_walks():
            found = dtype_findings(label, ops, shapes, bf16)
            findings.extend(found)
            env.logs.append(f"GL003 {label}: {len(ops)} ops, "
                            f"{'CLEAN' if not found else f'{len(found)} finding(s)'}")
        return findings


# -- GL004: host-sync guard ---------------------------------------------------

# The reference's census (polykey_tpu/analysis/graph.py SANCTIONED_CROSSINGS):
# the `_host_crossing` sites each engine mode may fire during the guarded
# sweep. Its own copy: the port imports nothing of the reference.
_BASE_CROSSINGS = frozenset({
    "merge-upload",         # lane merge scalar upload (admission)
    "first-token-resolve",  # cold-path first-token readback
    "retire-upload",        # retire scalar upload
})
REFERENCE_CROSSINGS: dict[str, frozenset] = {
    "engine.plain": _BASE_CROSSINGS | {"block-packed"},
    "engine.ragged": _BASE_CROSSINGS | {"block-packed"},
    "engine.spec": _BASE_CROSSINGS | {"spec-packed"},
    "engine.spec_ragged": _BASE_CROSSINGS | {"spec-packed"},
    "engine.hostkv": _BASE_CROSSINGS | {
        "block-packed", "kv-evict-gather", "kv-fault-restore",
    },
}
_RAGGED_UPLOAD = (
    "the ragged dispatch is eager (ROADMAP.md A.2): its host-built operands "
    "and kernel work lists go up by one pinned copy a dispatch, where the "
    "reference hands its jitted call explicit device_put arguments, which "
    "its transfer guard allows")
# The port's crossings beside the reference's, by mode, each with its reason.
CROSSING_DIFFERENCES: dict[str, dict[str, str]] = {
    "engine.ragged": {"ragged-upload": _RAGGED_UPLOAD},
    "engine.spec_ragged": {"ragged-upload": _RAGGED_UPLOAD},
}
SANCTIONED_CROSSINGS: dict[str, frozenset] = {
    mode: sites | frozenset(CROSSING_DIFFERENCES.get(mode, {}))
    for mode, sites in REFERENCE_CROSSINGS.items()
}


def crossing_census_findings(label: str, before: dict, after: dict,
                             expected: Optional[frozenset]) -> tuple[list, dict]:
    """The set of sites that fired (count delta > 0) must equal the mode's
    `SANCTIONED_CROSSINGS` entry: a new site is a host tax no one
    sanctioned (GL004); an expected site that never fired is a fixture
    that stopped exercising it (GL000). Returns (findings, deltas)."""
    deltas = {site: after.get(site, 0) - before.get(site, 0)
              for site in set(after) | set(before)}
    deltas = {site: n for site, n in deltas.items() if n > 0}
    findings: list[Finding] = []
    if expected is None:
        return findings, deltas
    for site in sorted(set(deltas) - expected):
        findings.append(graph_finding(
            "GL004", f"graph:{label}", f"{label}:census:{site}",
            f"unsanctioned host-crossing site '{site}' fired {deltas[site]}x "
            f"during {label}'s guarded sweep: sanction it in "
            "CROSSING_DIFFERENCES with its reason, or remove the crossing",
        ))
    for site in sorted(expected - set(deltas)):
        findings.append(graph_finding(
            "GL000", f"graph:{label}", f"{label}:census-not-exercised:{site}",
            f"sanctioned crossing site '{site}' never fired during {label}'s "
            "guarded sweep: the fixture no longer exercises it",
        ))
    return findings, deltas


@register_graph
class HostSyncGuardCheck(GraphCheck):
    """The serving loop runs under `engine.host_guard.HostSyncGuard`,
    entered on the engine thread each iteration: any host read or device
    copy outside an `engine._host_crossing` scope trips it (and on the card
    `torch.cuda.set_sync_debug_mode("error")` catches the synchronizing
    copies below dispatch). The sites that fired must be the mode's
    census. The CUDA graphs already refuse a sync while capturing
    (`capture_error_mode="thread_local"`); this guards the eager paths:
    admission, the ragged dispatches, the resolve points, the host tier."""

    id = "GL004"
    name = "host-sync-guard"
    description = ("the serving loop syncs only inside sanctioned crossings, "
                   "and each engine mode fires exactly its census of sites")

    def run(self, env: GraphEnv) -> list[Finding]:
        from ..engine import engine as engine_mod
        from ..engine.host_guard import HostSyncGuard

        findings: list[Finding] = []
        sync_debug = env.device.type == "cuda"
        for label, engine in env.engines():
            trips: list = []
            before = dict(engine_mod.CROSSING_CENSUS)
            errors = env.sweep(engine, env.request_mix(sampled=False),
                               lambda: HostSyncGuard(trips, sync_debug=sync_debug))
            found, deltas = crossing_census_findings(
                label, before, dict(engine_mod.CROSSING_CENSUS),
                SANCTIONED_CROSSINGS.get(label))
            findings.extend(found)
            env.trips.extend(f"{label}: {t}" for t in trips)
            for trip in sorted(set(trips)):
                findings.append(graph_finding(
                    "GL004", f"graph:{label}", f"{label}:trip:{trip.split(':')[0]}",
                    f"unsanctioned host sync in the serving loop: {trip[:200]} "
                    "(wrap a deliberate crossing in engine._host_crossing)",
                ))
            for error in errors:
                if "host sync" not in error and "synchroniz" not in error:
                    findings.append(graph_finding(
                        "GL000", f"graph:{label}", f"{label}:guarded-error",
                        f"GL004's guarded sweep hit a request error: {error}"))
                elif not trips:
                    findings.append(graph_finding(
                        "GL004", f"graph:{label}", f"{label}:sync-debug",
                        f"a synchronizing CUDA call in the serving loop: {error[:200]}"))
            if engine.dead is not None:
                findings.append(graph_finding(
                    "GL004", f"graph:{label}", f"{label}:guard-killed-engine",
                    f"the engine loop died under the guard "
                    f"({engine.dead.splitlines()[0][:200]})"))
            if engine._host_kv is not None and not (
                    engine.metrics.kv_pages_evicted and engine.metrics.kv_pages_restored):
                findings.append(graph_finding(
                    "GL000", f"graph:{label}", f"{label}:hostkv-not-exercised",
                    f"GL004's host-KV sweep recorded "
                    f"{engine.metrics.kv_pages_evicted} evictions, "
                    f"{engine.metrics.kv_pages_restored} restores"))
            env.census.setdefault(label, {})["crossings"] = deltas
            env.logs.append(f"GL004 {label}: trips {len(trips)}; crossing census: " + (
                ", ".join(f"{s}={n}" for s, n in sorted(deltas.items())) or "none"))
        return findings


# -- GL005: shape/layout contracts --------------------------------------------


@register_graph
class ShapeLayoutContracts(GraphCheck):
    """Kernel output contracts, gate consistency and sharding
    divisibility, all without a launch:

    - every kernel wrapper (flash, bf16 and int8 decode, bf16 and int8
      ragged, both writes) honors its output contract on `meta` tensors
      at the engine geometry of each model of MODELS it admits, and refuses
      (ValueError) one it does not, on the card too, where its gate is a
      kill switch alone; a ragged stream that is
      not a whole number of token tiles is refused;
    - the gates agree with the head dims, query groups and split limits
      the .cu templates are instantiated for;
    - every spec of `parallel/` divides its dims for tp, dp, sp, ep and pp
      over MODELS (params, KV and scale pools, the contiguous cache, token
      batches)."""

    id = "GL005"
    name = "shape-layout-contracts"
    description = ("kernel wrappers honor their output contracts; gates agree "
                   "with the .cu templates; specs divide their dims")

    MODELS = ("tiny-llama", "tiny-mixtral", "llama-3-8b", "mixtral-8x7b")

    def run(self, env: GraphEnv) -> list[Finding]:
        from ..models.config import get_config

        findings = self._kernel_contracts()
        findings.extend(gate_consistency_findings(get_config(m) for m in self.MODELS))
        findings.extend(self._sharding_contracts(env))
        return findings

    def _kernel_contracts(self) -> list[Finding]:
        from ..models.config import get_config
        from ..ops import flash_attention as fa
        from ..ops import paged_attention_kernel as pak
        from ..ops import paged_write_kernel as pw
        from ..ops import ragged_paged_attention_kernel as rk

        meta = dict(device="meta")
        bf16, f32, i32 = torch.bfloat16, "float32", torch.int32
        findings: list[Finding] = []
        for model in self.MODELS:
            cfg = get_config(model)
            Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            G, scale = Hq // Hk, D ** -0.5
            B, N, ps, P, T, S = 16, 64, 16, 16, 256, 512
            pool = torch.empty((N, ps, Hk, D), dtype=bf16, **meta)
            pool8 = (torch.empty((N, ps, Hk, D), dtype=torch.int8, **meta),
                     torch.empty((N, ps, Hk), dtype=bf16, **meta))
            tables = torch.empty((B, P), dtype=i32, **meta)
            pos = torch.empty((B,), dtype=i32, **meta)
            label = lambda kernel: f"ops.{kernel}[{model}]"  # noqa: E731

            def hold(kernel, admitted, fn, args, expected):
                if admitted:
                    findings.extend(abstract_contract(label(kernel), fn, args, expected))
                else:
                    findings.extend(refusal_findings(label(kernel), fn, args))

            hold("flash_attention", fa.use_flash(T, S, D),
                 lambda *a: fa.flash_attention_cuda(*a, scale=scale),
                 (torch.empty((1, T, Hq, D), dtype=bf16, **meta),
                  torch.empty((1, S, Hk, D), dtype=bf16, **meta),
                  torch.empty((1, S, Hk, D), dtype=bf16, **meta),
                  torch.empty((1, T), dtype=i32, **meta)),
                 [((1, T, Hq, D), "bfloat16")])
            q = torch.empty((B, Hq, D), dtype=bf16, **meta)
            state = [((B, Hq, D), f32), ((B, Hq, 1), f32), ((B, Hq, 1), f32)]
            for kernel, pools in (("paged_decode", (pool, pool)),
                                  ("paged_decode_int8", (pool8, pool8))):
                hold(kernel, decode_admits(D, G),
                     lambda *a: pak.paged_decode_cuda(*a, scale=scale),
                     (q, *pools, tables, pos), state)
            # The engine's ragged stream: 16 decode singles, then chunks.
            lens = [1] * B + [256, 256]
            starts = list(range(B)) + [B, B + 256]
            Tr = B + 512 + (-(B + 512)) % rk.TOKEN_TILE
            kvs = [ps * P // 2] * B + [256, 512]
            S_ = len(lens)
            rtables = torch.empty((S_, P), dtype=i32, **meta)
            rng = [torch.empty((S_,), dtype=i32, **meta) for _ in range(3)]
            qr = torch.empty((Tr, Hq, D), dtype=bf16, **meta)
            for kernel, pools in (("ragged_attention", (pool, pool)),
                                  ("ragged_attention_int8", (pool8, pool8))):
                work = (rk.ragged_work(starts, lens, kvs, Tr, G, Hk, "meta")
                        if G in rk.RAGGED_GROUPS else None)
                hold(kernel, ragged_admits(D, G),
                     lambda *a, w=work: rk.ragged_attention_cuda(*a, scale=scale, work=w),
                     (qr, *pools, rtables, *rng), [((Tr, Hq, D), f32)])
            rows = torch.empty((B, 1, Hk, D), dtype=bf16, **meta)
            pos2 = torch.empty((B, 1), dtype=i32, **meta)
            findings.extend(abstract_contract(
                label("paged_write"), pw.paged_write_decode_cuda,
                (pool, pool, rows, rows, tables, pos2),
                [((N, ps, Hk, D), "bfloat16")] * 2))
            findings.extend(abstract_contract(
                label("paged_write_int8"), pw.paged_write_int8_cuda,
                (pool8, pool8, rows, rows, tables, pos2),
                [((N, ps, Hk, D), "int8"), ((N, ps, Hk), "bfloat16")] * 2))
        # Token-tile teeth: a stream that is not a whole number of tiles is
        # refused, never silently mis-tiled.
        cfg = get_config("llama-3-8b")
        bad = torch.empty((rk.TOKEN_TILE + 3, cfg.num_heads, cfg.head_dim),
                          dtype=torch.bfloat16, **meta)
        pool = torch.empty((8, 16, cfg.num_kv_heads, cfg.head_dim),
                           dtype=torch.bfloat16, **meta)
        one = torch.empty((1,), dtype=i32, **meta)
        findings.extend(refusal_findings(
            "ops.ragged_paged_attention[tile]",
            lambda *a: rk.ragged_paged_attention(*a, scale=1.0),
            (bad, pool, pool, torch.empty((1, 4), dtype=i32, **meta), one, one, one)))
        return findings

    def _sharding_contracts(self, env: GraphEnv) -> list[Finding]:
        from ..engine.kv_cache import init_paged_kv
        from ..models.config import get_config
        from ..models.transformer import init_params
        from ..parallel import sharding

        findings: list[Finding] = []
        meshes = (("tp2", dict(tp=2)), ("dp2", dict(dp=2)), ("sp2", dict(sp=2)),
                  ("tp2dp2", dict(tp=2, dp=2)), ("ep2", dict(ep=2)), ("pp2", dict(pp=2)))
        for model in self.MODELS:
            cfg = get_config(model)
            params = init_params(cfg, torch.bfloat16, "meta")
            pool = init_paged_kv(cfg, 64, 16, torch.bfloat16, "meta")
            pool8 = init_paged_kv(cfg, 64, 16, torch.bfloat16, "meta", kv_dtype=torch.int8)
            specs = sharding.param_shardings(cfg, None, params)
            for mesh_name, axes in meshes:
                mesh = {"dp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": 1, **axes}
                if mesh["ep"] > 1 and not cfg.is_moe:
                    continue
                if cfg.num_kv_heads % mesh["tp"] != 0:
                    continue        # the engine refuses this geometry up front
                where = f"{model}/{mesh_name}"
                for i, layer in enumerate(params["layers"]):
                    for leaf, spec in zip(tree_leaves(layer), tree_leaves(
                            specs["layers"][i], is_leaf=lambda x: isinstance(x, sharding.P))):
                        findings.extend(sharding_divisibility(
                            f"params[{where}]", tuple(leaf.shape), spec[1:], mesh))
                    if i:
                        break       # every layer has the same shapes
                findings.extend(sharding_divisibility(
                    f"layers[{where}]", (cfg.num_layers,), ("pp",), mesh))
                for key in ("embed", "lm_head", "final_norm"):
                    if key in params:
                        findings.extend(sharding_divisibility(
                            f"params[{where}]", tuple(params[key].shape), specs[key], mesh))
                for t in pool.pools:
                    findings.extend(sharding_divisibility(
                        f"kv_pool[{where}]", tuple(t.shape), sharding.paged_kv_spec(), mesh))
                for t in pool8.pools:
                    spec = (sharding.paged_kv_spec() if t.dim() == 5
                            else sharding.paged_kv_scale_spec())
                    findings.extend(sharding_divisibility(
                        f"kv_scale_pool[{where}]", tuple(t.shape), spec, mesh))
                findings.extend(sharding_divisibility(
                    f"kv_cache[{where}]",
                    (cfg.num_layers, 16, 512, cfg.num_kv_heads, cfg.head_dim),
                    sharding.contiguous_kv_spec(), mesh))
                findings.extend(sharding_divisibility(
                    f"batch[{where}]", (16, 512), sharding.batch_spec(2, seq_axis=1), mesh))
        env.logs.append(f"GL005 sharding: {len(self.MODELS)} models x {len(meshes)} meshes")
        return findings


# -- runner + CLI -------------------------------------------------------------


def apply_check_suppressions(findings: list[Finding]) -> list[Finding]:
    """Mark findings whose key carries a class-level suppression (the
    reason is the dict's value)."""
    from dataclasses import replace

    by_id = {check.id: check for check in all_graph_checks()}
    out: list[Finding] = []
    for f in findings:
        reason = by_id.get(f.rule, GraphCheck).SUPPRESSIONS.get(f.snippet)
        out.append(replace(f, suppressed=True, reason=reason) if reason is not None else f)
    return out


def run_graph_checks(env: Optional[GraphEnv] = None,
                     only: Optional[set[str]] = None) -> tuple[list[Finding], GraphEnv]:
    if env is None:
        env = GraphEnv()
    findings: list[Finding] = []
    for check in all_graph_checks():
        if only is not None and check.id not in only:
            continue
        try:
            findings.extend(check.run(env))
        except Exception as e:  # a crashed check must not read as clean
            findings.append(graph_finding(
                "GL000", f"graph:{check.id}", f"{check.id}:crashed",
                f"check {check.id} ({check.name}) crashed: {type(e).__name__}: {e}",
            ))
    return apply_check_suppressions(findings), env


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m polykey_tpu_torch.analysis graph",
        description="graphlint for the port: the serving engine's step "
                    "contracts (CPU engines by default)")
    parser.add_argument("--root", default=".",
                        help="repo root the baseline file lives under (default: cwd)")
    parser.add_argument("--baseline", default=GRAPH_BASELINE, metavar="FILE",
                        help="grandfathering baseline file (missing: empty)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline file entirely")
    parser.add_argument("--write-baseline", action="store_true",
                        help="grandfather every current blocking finding into --baseline")
    parser.add_argument("--prune", action="store_true",
                        help="drop baseline entries whose finding no longer fires, "
                             "keep the rest, and exit (never adds entries)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings and a summary as one JSON object")
    parser.add_argument("--list-checks", action="store_true",
                        help="print the check table and exit")
    parser.add_argument("--only", default=None, metavar="GL001[,GL002...]",
                        help="run only the named checks")
    parser.add_argument("--profile", default="full", choices=("full", "smoke"),
                        help="the engines' configs: full (the gate) or smoke")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    if args.list_checks:
        for check in all_graph_checks():
            print(f"{check.id}  {check.name:<26} {check.description}")
        return 0
    root = Path(args.root).resolve()
    if not root.is_dir():
        print(f"graphlint: --root {args.root} is not a directory", file=sys.stderr)
        return 2
    try:
        only = parse_only(args.only, set(_GRAPH_REGISTRY), noun="check")
        require_full_run(partial=only is not None, prune=args.prune,
                         write_baseline=args.write_baseline)
    except UsageError as e:
        print(f"graphlint: {e}", file=sys.stderr)
        return 2

    t0 = time.monotonic()
    env = GraphEnv(profile=args.profile)
    try:
        findings, env = run_graph_checks(env, only=only)
    finally:
        env.close()
    elapsed = time.monotonic() - t0
    for line in env.logs:
        print(f"graphlint: {line}", file=sys.stderr)

    baseline_path = root / args.baseline
    infra = [f for f in findings if f.rule == "GL000"]
    if args.prune:
        # A crashed check is a partial run in disguise: its entries would
        # read "fixed" and be dropped while the debt is live.
        if infra:
            print(f"graphlint: refusing to prune with {len(infra)} GL000 "
                  "analyzer-infrastructure finding(s) present: fix the probe first",
                  file=sys.stderr)
            return 1
        kept, dropped = prune_baseline(baseline_path, findings)
        print(f"graphlint: pruned {dropped} stale baseline entr"
              f"{'y' if dropped == 1 else 'ies'} from {baseline_path} ({kept} kept)")
        return 0
    if args.write_baseline:
        # Grandfathering a GL000 would make the gate pass forever while
        # checking nothing; refuse before touching the file.
        if infra:
            print(f"graphlint: refusing to write the baseline with {len(infra)} GL000 "
                  "analyzer-infrastructure finding(s) present: fix the probe first",
                  file=sys.stderr)
            return 1
        count = write_baseline(baseline_path, findings)
        print(f"graphlint: wrote {count} baseline entr"
              f"{'y' if count == 1 else 'ies'} to {baseline_path}")
        return 0

    stale: list[str] = []
    if not args.no_baseline:
        findings, stale = apply_baseline(findings, load_baseline(baseline_path))
        if only is not None:
            stale = []      # a partial run cannot tell fixed from not checked
    blocking = [f for f in findings if f.blocking]
    suppressed = sum(1 for f in findings if f.suppressed)
    baselined = sum(1 for f in findings if f.baselined)
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "summary": {
                "blocking": len(blocking), "suppressed": suppressed,
                "baselined": baselined, "stale_baseline_entries": stale,
                "elapsed_s": round(elapsed, 1), "graph_clean": not blocking,
            },
        }, indent=2))
    else:
        for f in sorted(findings, key=lambda f: (f.path, f.rule, f.snippet)):
            if f.blocking:
                print(f.render())
        parts = [f"{len(blocking)} blocking"]
        if suppressed:
            parts.append(f"{suppressed} suppressed")
        if baselined:
            parts.append(f"{baselined} baselined")
        print(f"graphlint: {', '.join(parts)} ({elapsed:.1f}s)")
        if stale:
            print(f"graphlint: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (fixed findings): re-run "
                  "with --prune to drop them")
    return 1 if blocking else 0
