"""Engine configuration (the reference's engine/config.py, POLYKEY_* env).

The fields, their env names and their defaults are the reference's.
`validate` raises NotImplementedError for the knobs whose part of the port
has not landed yet, naming the ROADMAP.md item, so a deployment that asks
for them fails at startup instead of being served by something else: the
reference's spec A/B instrumentation. The mesh axes tp, dp, pp, ep, sp
and num_slices are served (engine/lockstep.py), with the reference's
geometry checks here and in the engine, and so is every knob over them:
the ragged dispatch on tp-at-most meshes (the reference's rule), a draft
model, the prefix cache, the host tier and its durable state dir,
replicas and the disaggregated tiers, each worker or replica a mesh.
Local
safetensors checkpoints (`checkpoint_path`, `draft_checkpoint_path`;
models/loader.py), weight-only int8/int4 (`quantize`,
`quantize_bits`), chunked prefill
(`prefill_chunk`, `prefill_budget`), ragged dispatch (`ragged_dispatch`),
the int8 KV cache (`kv_dtype="int8"`), the lookahead pipeline
(`lookahead_blocks`), the adaptive block (`adaptive_block`), and the
prefix cache with its host-KV tier and durable state dir (`prefix_cache`,
`host_kv_bytes`, `kv_state_dir`), speculative decoding (`draft_model`,
`spec_gamma`, `adaptive_gamma`; in either dispatch mode) and the top-p
candidate prefilter (`top_p_candidates`) are served, and so is the
serving shell's liveness: the watchdog window (`watchdog_timeout_s`),
supervised in-process restarts (`supervise`, `max_engine_restarts`,
`restart_window_s`), the engine timeline (`timeline_capacity`), the SLO
signal plane (`signals_interval_s`, `signals_windows`, `slo_policy`) and
the replica pool (`replicas`, `route_prefix_weight`, `route_delay_weight`,
`max_reroutes`), and the disaggregated prefill/decode tiers (`disagg`,
`disagg_tier`, `disagg_heartbeat_s`, `disagg_miss`,
`disagg_recovery_wait_s`, `blackbox_every`; engine/disagg_pool.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


# The ROADMAP.md item that the mesh engine's refusals name.
MESH_ITEM = ("A.17, the in-process restart of a mesh engine that failed "
             "inside a dispatch")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_bool(name: str, extra: tuple[str, ...] = ()) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", *extra)


@dataclass(frozen=True)
class EngineConfig:
    model: str = "tiny-llama"
    tokenizer: str = "byte"              # 'byte' or a local HF tokenizer path
    dtype: str = "bfloat16"
    checkpoint_path: Optional[str] = None  # None → random init from a seed
    # Weight-only quantization (models/quant.py): int8 per-output-channel,
    # or with quantize_bits=4 int4 group-wise block linears (embed and
    # lm_head stay int8). POLYKEY_QUANTIZE=int8|int4.
    quantize: bool = False
    quantize_bits: int = 8
    kv_dtype: str = ""                   # "" → follow `dtype`

    # Decode-batch geometry: 16 slots of up to 4k positions over 32k pooled
    # KV token slots; prompts prefill in padded length buckets.
    max_decode_slots: int = 16
    page_size: int = 16
    num_pages: int = 2048                # includes reserved garbage page 0
    max_seq_len: int = 4096              # per-request position cap
    prefill_buckets: tuple[int, ...] = (128, 512)
    prefill_chunk: int = 0
    max_new_tokens_cap: int = 1024
    default_max_new_tokens: int = 64
    prefill_budget: int = 0

    ragged_dispatch: bool = False
    # Automatic prefix caching (engine/prefix_cache.py): requests sharing a
    # page-aligned prompt prefix reuse its KV pages and prefill only the
    # suffix. prefix_cache_pages caps the cache's own page references
    # (LRU); 0 -> num_pages // 2.
    prefix_cache: bool = False
    prefix_cache_pages: int = 0
    # Host-memory KV tier: > 0 adds a pool of that many bytes in pinned
    # host RAM for cold prefix-cache pages, spilled from the device pool
    # under pressure and copied back in place when a lookup hits them.
    # Requires prefix_cache (from_env pairs them). 0 allocates nothing.
    host_kv_bytes: int = 0
    # Resident working set: when a retiring request leaves fewer free
    # device pages than this, LRU prefix pages spill to the host tier
    # until the floor holds again. 0 -> num_pages // 8.
    host_kv_resident_pages: int = 0
    # Faulting slots whose host-to-device restore may be issued per engine
    # loop iteration (at least one always is).
    host_kv_restore_slots: int = 2
    # Restart-durable prefix cache: spilled pages are also written here in
    # the KV wire format, and a new engine reloads matching ones into its
    # host tier at construction. "" disables it.
    kv_state_dir: str = ""

    # Decode steps per dispatch: K steps run back to back on the device
    # with device-side EOS/cap stopping; their tokens come back as one
    # packed [K, B] read.
    decode_block_steps: int = 8
    # Load-adaptive block: while ONE stream is active, dispatch blocks of
    # max(1, K // 8) steps, so a lone stream's tokens arrive one at a time
    # at the device's step rate; the output is the same either way.
    adaptive_block: bool = True
    # Dispatched-but-unprocessed decode blocks (pipeline depth): up to
    # `lookahead_blocks` full-K blocks stay queued on the device, so the
    # host's processing and the packed read hide behind device compute.
    # When the adaptive block shrinks K, the lookahead portion scales by
    # the same factor (1 + (depth - 1) x K / steps, at most 64 blocks).
    # 1 = dispatch, then read (exactly synchronous).
    lookahead_blocks: int = 2

    # Top-k prefilter of every sampled path: top-p / top-k within the
    # top-C scaled logits, with full-vocabulary probabilities (no sort);
    # a request's top_k clamps to C. Lets top_p < 1 rows speculate.
    top_p_candidates: int = 0
    # Speculative decoding: a draft model of the same vocabulary proposes
    # spec_gamma tokens a round in its own page pool; the target verifies
    # them in one forward. Greedy streams stay the target's.
    draft_model: Optional[str] = None
    draft_checkpoint_path: Optional[str] = None  # None → random init
    spec_gamma: int = 4
    # Per-lane gamma dial on the ladder {max(1, spec_gamma // 2),
    # spec_gamma}, driven by each lane's acceptance EWMA on the device;
    # off pins spec_gamma. Page slack always reserves spec_gamma.
    adaptive_gamma: bool = True
    # A/B instrumentation only: three timed blocking reads of the spec
    # round's packed result after its dispatch (metrics.on_spec_host_sync),
    # the reference's host tax of a round read back at dispatch time.
    # Programmatic only, as in the reference: no env knob.
    spec_host_sync: bool = False

    # Flight-deck timeline (obs/timeline.py): a bounded ring of engine
    # events exported as Perfetto JSON (/debug/timeline). 0 disables it:
    # no ring, every emission site one `is None` branch.
    timeline_capacity: int = 4096
    # Black-box checkpoint cadence (obs/postmortem.py): a disaggregated
    # pool member with a state dir flushes its timeline and flight-recorder
    # rings to `blackbox-<role>.json` every this many timeline appends
    # (plus forced flushes at control-plane op intake and on the
    # supervisor's trip path). 0 disables black boxes even when a state
    # dir exists. POLYKEY_BLACKBOX_EVERY.
    blackbox_every: int = 64

    # SLO signal plane (obs/signals.py): seconds between ring samples of
    # the engine's host counters and histograms, sampled at block
    # boundaries and on the idle tick. 0 disables the plane:
    # `metrics.signals is None`, one `is None` branch in the loop.
    # POLYKEY_SIGNALS_INTERVAL. The window widths (comma-separated seconds)
    # and the SLO policy spec (inline JSON, "@/path.json" or "default");
    # "" reads POLYKEY_SIGNALS_WINDOWS / POLYKEY_SLO at construction.
    signals_interval_s: float = 5.0
    signals_windows: str = ""
    slo_policy: str = ""

    # Liveness: the watchdog trips when the engine makes no progress for
    # this long with work pending. It must comfortably exceed the longest
    # legitimate step (an engine's graph capture happens before it serves).
    watchdog_timeout_s: float = 300.0
    request_timeout_s: float = 300.0
    max_queue_depth: int = 256
    # Supervised restarts (engine/supervisor.py): a watchdog trip or an
    # engine-loop crash triggers an in-process restart — fresh engine on
    # the same weights, re-armed watchdog, health back to SERVING — up to
    # `max_engine_restarts` times within `restart_window_s`, after which
    # the process stays NOT_SERVING for the platform to recycle.
    supervise: bool = True
    max_engine_restarts: int = 3
    restart_window_s: float = 600.0

    tp: int = 1
    dp: int = 1
    ep: int = 1
    sp: int = 1
    pp: int = 1
    num_slices: int = 1
    # Replica tier (engine/replica_pool.py): POLYKEY_REPLICAS > 1 serves
    # through a pool of independently supervised engines on one set of
    # weights behind a health- and load-aware router; 1 keeps the single
    # engine. `replica` is this engine's index in its pool (set by the
    # pool; fault targeting and metric labels key on it).
    replicas: int = 1
    replica: int = 0
    # Router score = prefix_weight x (cached-prefix fraction)
    #              - delay_weight x (estimated queue delay, s);
    # ties break on the lowest replica index.
    route_prefix_weight: float = 1.0
    route_delay_weight: float = 1.0
    # Re-routes one request may take after engine-lifecycle failures
    # (queued requests move losslessly; streams resume with the delivered
    # tokens suppressed). 0 disables failover.
    max_reroutes: int = 3
    # Disaggregated prefill/decode tiers (engine/disagg_pool.py):
    # POLYKEY_DISAGG="PxD" (e.g. "1x1") or "prefill=P,decode=D" serves
    # through P prefill-tier and D decode-tier worker PROCESSES on
    # localhost (engine/worker.py), each a supervised engine behind a
    # socket control plane; a finished prefill's KV ships to a decode
    # worker in the kv_cache wire format. "" builds no process and no
    # pool. Excludes POLYKEY_REPLICAS > 1 and a draft model.
    disagg: str = ""
    # This engine's tier inside a worker ("prefill" / "decode"; set by
    # engine/worker.py, not an env knob): scopes ":tier=" fault targeting.
    disagg_tier: str = ""
    # Worker liveness: the coordinator pings every worker's control plane
    # at this interval and declares death after `disagg_miss` misses in a
    # row (a process exit is seen at once). POLYKEY_DISAGG_HEARTBEAT /
    # POLYKEY_DISAGG_MISS.
    disagg_heartbeat_s: float = 0.5
    disagg_miss: int = 3
    # How long a re-route waits for a tier to regain a SERVING worker (a
    # worker process restart takes seconds). POLYKEY_DISAGG_RECOVERY_WAIT.
    disagg_recovery_wait_s: float = 30.0

    @property
    def pages_per_seq(self) -> int:
        return self.max_seq_len // self.page_size

    @classmethod
    def from_env(cls) -> "EngineConfig":
        buckets = os.environ.get("POLYKEY_PREFILL_BUCKETS")
        return cls(
            model=os.environ.get("POLYKEY_MODEL", cls.model),
            tokenizer=os.environ.get("POLYKEY_TOKENIZER", cls.tokenizer),
            dtype=os.environ.get("POLYKEY_DTYPE", cls.dtype),
            checkpoint_path=os.environ.get("POLYKEY_CHECKPOINT") or None,
            quantize=_env_bool("POLYKEY_QUANTIZE", extra=("int8", "int4")),
            quantize_bits=(
                4 if os.environ.get("POLYKEY_QUANTIZE", "").lower() == "int4"
                else cls.quantize_bits
            ),
            kv_dtype=os.environ.get("POLYKEY_KV_DTYPE", cls.kv_dtype),
            max_decode_slots=_env_int("POLYKEY_MAX_DECODE_SLOTS", cls.max_decode_slots),
            page_size=_env_int("POLYKEY_PAGE_SIZE", cls.page_size),
            num_pages=_env_int("POLYKEY_NUM_PAGES", cls.num_pages),
            max_seq_len=_env_int("POLYKEY_MAX_SEQ_LEN", cls.max_seq_len),
            prefill_buckets=tuple(
                int(x) for x in buckets.split(",")
            ) if buckets else cls.prefill_buckets,
            prefill_chunk=_env_int("POLYKEY_PREFILL_CHUNK", cls.prefill_chunk),
            prefill_budget=_env_int("POLYKEY_PREFILL_BUDGET", cls.prefill_budget),
            max_new_tokens_cap=_env_int(
                "POLYKEY_MAX_NEW_TOKENS_CAP", cls.max_new_tokens_cap
            ),
            default_max_new_tokens=_env_int(
                "POLYKEY_DEFAULT_MAX_NEW_TOKENS", cls.default_max_new_tokens
            ),
            ragged_dispatch=_env_bool("POLYKEY_RAGGED"),
            prefix_cache=(
                _env_bool("POLYKEY_PREFIX_CACHE")
                or _env_int("POLYKEY_HOST_KV_BYTES", 0) > 0
            ),
            prefix_cache_pages=_env_int(
                "POLYKEY_PREFIX_CACHE_PAGES", cls.prefix_cache_pages
            ),
            host_kv_bytes=_env_int("POLYKEY_HOST_KV_BYTES", cls.host_kv_bytes),
            host_kv_resident_pages=_env_int(
                "POLYKEY_KV_RESIDENT_PAGES", cls.host_kv_resident_pages
            ),
            host_kv_restore_slots=_env_int(
                "POLYKEY_KV_RESTORE_SLOTS", cls.host_kv_restore_slots
            ),
            kv_state_dir=os.environ.get("POLYKEY_KV_STATE_DIR", cls.kv_state_dir),
            decode_block_steps=_env_int("POLYKEY_DECODE_BLOCK", cls.decode_block_steps),
            # Default on; POLYKEY_ADAPTIVE_BLOCK=0 pins the static block.
            adaptive_block=os.environ.get(
                "POLYKEY_ADAPTIVE_BLOCK", "1"
            ).lower() in ("1", "true"),
            # POLYKEY_DISPATCH_LOOKAHEAD wins over the legacy
            # POLYKEY_LOOKAHEAD (the engine also reads it at construction).
            lookahead_blocks=_env_int(
                "POLYKEY_DISPATCH_LOOKAHEAD",
                _env_int("POLYKEY_LOOKAHEAD", cls.lookahead_blocks),
            ),
            top_p_candidates=_env_int(
                "POLYKEY_TOP_P_CANDIDATES", cls.top_p_candidates
            ),
            draft_model=os.environ.get("POLYKEY_DRAFT_MODEL") or None,
            draft_checkpoint_path=os.environ.get("POLYKEY_DRAFT_CHECKPOINT") or None,
            spec_gamma=_env_int("POLYKEY_SPEC_GAMMA", cls.spec_gamma),
            # Default on; POLYKEY_ADAPTIVE_GAMMA=0 pins spec_gamma.
            adaptive_gamma=os.environ.get(
                "POLYKEY_ADAPTIVE_GAMMA", "1"
            ).lower() in ("1", "true"),
            timeline_capacity=_env_int(
                "POLYKEY_TIMELINE_CAPACITY", cls.timeline_capacity
            ),
            blackbox_every=_env_int(
                "POLYKEY_BLACKBOX_EVERY", cls.blackbox_every
            ),
            signals_interval_s=_env_float(
                "POLYKEY_SIGNALS_INTERVAL", cls.signals_interval_s
            ),
            signals_windows=os.environ.get(
                "POLYKEY_SIGNALS_WINDOWS", cls.signals_windows
            ),
            slo_policy=os.environ.get("POLYKEY_SLO", cls.slo_policy),
            watchdog_timeout_s=_env_float(
                "POLYKEY_WATCHDOG_TIMEOUT", cls.watchdog_timeout_s
            ),
            request_timeout_s=_env_float(
                "POLYKEY_REQUEST_TIMEOUT", cls.request_timeout_s
            ),
            max_queue_depth=_env_int("POLYKEY_MAX_QUEUE", cls.max_queue_depth),
            # Default on; POLYKEY_SUPERVISE=0 pins the one-shot behavior
            # (process restart is then the only recovery path).
            supervise=os.environ.get(
                "POLYKEY_SUPERVISE", "1"
            ).lower() in ("1", "true"),
            max_engine_restarts=_env_int(
                "POLYKEY_MAX_RESTARTS", cls.max_engine_restarts
            ),
            restart_window_s=_env_float(
                "POLYKEY_RESTART_WINDOW", cls.restart_window_s
            ),
            tp=_env_int("POLYKEY_TP", cls.tp),
            dp=_env_int("POLYKEY_DP", cls.dp),
            ep=_env_int("POLYKEY_EP", cls.ep),
            sp=_env_int("POLYKEY_SP", cls.sp),
            pp=_env_int("POLYKEY_PP", cls.pp),
            num_slices=_env_int("POLYKEY_NUM_SLICES", cls.num_slices),
            replicas=_env_int("POLYKEY_REPLICAS", cls.replicas),
            route_prefix_weight=_env_float(
                "POLYKEY_ROUTE_W_PREFIX", cls.route_prefix_weight
            ),
            route_delay_weight=_env_float(
                "POLYKEY_ROUTE_W_DELAY", cls.route_delay_weight
            ),
            max_reroutes=_env_int("POLYKEY_MAX_REROUTES", cls.max_reroutes),
            disagg=os.environ.get("POLYKEY_DISAGG", cls.disagg),
            disagg_heartbeat_s=_env_float(
                "POLYKEY_DISAGG_HEARTBEAT", cls.disagg_heartbeat_s
            ),
            disagg_miss=_env_int("POLYKEY_DISAGG_MISS", cls.disagg_miss),
            disagg_recovery_wait_s=_env_float(
                "POLYKEY_DISAGG_RECOVERY_WAIT", cls.disagg_recovery_wait_s
            ),
        )

    def disagg_tiers(self) -> Optional[tuple[int, int]]:
        """Parse the `disagg` spec into (prefill_workers, decode_workers),
        or None when unset. Accepts "PxD" ("2x2") and "prefill=P,decode=D"
        (any order). Raises ValueError on a malformed spec: a typo must
        not silently serve single-process."""
        spec = self.disagg.strip().lower()
        if not spec:
            return None
        try:
            if "x" in spec and "=" not in spec:
                p_s, d_s = spec.split("x", 1)
                tiers = {"prefill": int(p_s), "decode": int(d_s)}
            else:
                tiers = {}
                for part in spec.split(","):
                    key, _, value = part.strip().partition("=")
                    tiers[key.strip()] = int(value)
                if set(tiers) != {"prefill", "decode"}:
                    raise ValueError(f"tiers {sorted(tiers)}")
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"malformed POLYKEY_DISAGG spec {self.disagg!r}: expected "
                f"'PxD' or 'prefill=P,decode=D' ({e})"
            ) from None
        if tiers["prefill"] < 1 or tiers["decode"] < 1:
            raise ValueError(
                "POLYKEY_DISAGG needs >= 1 worker per tier, got "
                f"{self.disagg!r}"
            )
        return tiers["prefill"], tiers["decode"]

    def validate(self) -> None:
        if self.max_seq_len % self.page_size != 0:
            raise ValueError("max_seq_len must be a multiple of page_size")
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if not self.prefill_buckets:
            raise ValueError("need at least one prefill bucket")
        for b in self.prefill_buckets:
            if b > self.max_seq_len:
                raise ValueError(
                    f"prefill bucket {b} exceeds max_seq_len {self.max_seq_len}"
                )
        if self.decode_block_steps < 1:
            raise ValueError("decode_block_steps must be >= 1")
        if self.lookahead_blocks < 1:
            raise ValueError("lookahead_blocks must be >= 1")
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 → max bucket)")
        if self.prefill_budget < 0:
            raise ValueError("prefill_budget must be >= 0 (0 → 2 x prefill chunk)")
        if self.timeline_capacity < 0:
            raise ValueError(
                "timeline_capacity must be >= 0 (0 disables the ring)"
            )
        if self.blackbox_every < 0:
            raise ValueError(
                "blackbox_every must be >= 0 (0 disables black boxes)"
            )
        if self.signals_interval_s < 0:
            raise ValueError(
                "signals_interval_s must be >= 0 (0 disables the plane)"
            )
        if self.max_queue_depth < 0:
            raise ValueError("max_queue_depth must be >= 0 (0 → unbounded)")
        if self.max_engine_restarts < 0:
            raise ValueError("max_engine_restarts must be >= 0")
        if self.restart_window_s <= 0:
            raise ValueError("restart_window_s must be > 0")
        if self.draft_model is not None and self.spec_gamma < 1:
            raise ValueError("spec_gamma must be >= 1")
        if self.top_p_candidates < 0:
            raise ValueError("top_p_candidates must be >= 0 (0 → exact)")
        if self.kv_dtype not in ("", "bfloat16", "float32", "int8"):
            raise ValueError(
                "kv_dtype must be '', bfloat16, float32, or int8; "
                f"got {self.kv_dtype!r}"
            )
        for name in ("tp", "dp", "ep", "sp", "pp", "num_slices", "replicas"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.sp > 1:
            chunk = self.prefill_chunk or max(self.prefill_buckets)
            for b in (*self.prefill_buckets, chunk):
                if b % self.sp != 0:
                    raise ValueError(
                        f"sp={self.sp} must divide every prefill bucket "
                        f"and the prefill chunk (got {b})"
                    )
        if self.replica < 0:
            raise ValueError("replica index must be >= 0")
        if self.max_reroutes < 0:
            raise ValueError("max_reroutes must be >= 0 (0 → no failover)")
        if self.route_prefix_weight < 0 or self.route_delay_weight < 0:
            raise ValueError("routing weights must be >= 0")
        if self.prefix_cache_pages < 0:
            raise ValueError(
                "prefix_cache_pages must be >= 0 (0 → num_pages // 2); "
                "negative would silently disable the LRU cap"
            )
        if self.host_kv_bytes < 0:
            raise ValueError(
                "host_kv_bytes must be >= 0 (0 disables the host KV tier)"
            )
        if self.host_kv_bytes > 0 and not self.prefix_cache:
            raise ValueError(
                "host_kv_bytes > 0 requires prefix_cache: the host tier's "
                "only spill source is the prefix cache (from_env pairs "
                "them automatically)"
            )
        if self.host_kv_resident_pages < 0:
            raise ValueError(
                "host_kv_resident_pages must be >= 0 (0 → num_pages // 8)"
            )
        if self.host_kv_bytes > 0 and \
                self.host_kv_resident_pages >= self.num_pages - 1:
            raise ValueError(
                f"host_kv_resident_pages={self.host_kv_resident_pages} "
                f"must stay below the usable device pool "
                f"({self.num_pages - 1} pages): a floor the pool can "
                "never satisfy turns every retire into a full cache "
                "spill and every turn into wall-to-wall page faults"
            )
        if self.host_kv_restore_slots < 1:
            raise ValueError(
                "host_kv_restore_slots must be >= 1 (a restore budget of "
                "0 would wedge every faulting lane forever)"
            )
        if self.quantize_bits not in (4, 8):
            raise ValueError("quantize_bits must be 4 or 8")
        self.disagg_tiers()      # raises on a malformed spec
        if self.disagg and self.replicas > 1:
            raise ValueError(
                "POLYKEY_DISAGG and POLYKEY_REPLICAS>1 are mutually "
                "exclusive: the disaggregated tier replaces the "
                "in-process replica pool (each tier already scales by "
                "worker count)"
            )
        if self.disagg and self.draft_model is not None:
            raise ValueError(
                "disaggregated tiers have no speculative formulation yet "
                "(the KV handoff ships one pool; the draft pool would "
                "need its own) — unset POLYKEY_DISAGG or the draft model"
            )
        if self.disagg_tier not in ("", "prefill", "decode"):
            raise ValueError(
                f"disagg_tier must be '', 'prefill', or 'decode'; got "
                f"{self.disagg_tier!r}"
            )
        if self.disagg_heartbeat_s <= 0:
            raise ValueError("disagg_heartbeat_s must be > 0")
        if self.disagg_miss < 1:
            raise ValueError("disagg_miss must be >= 1")
        if self.disagg_recovery_wait_s < 0:
            raise ValueError("disagg_recovery_wait_s must be >= 0")
        if self.ragged_dispatch and (
                self.dp * self.num_slices > 1 or self.sp > 1 or self.pp > 1):
            raise ValueError(
                "ragged_dispatch serves tp-at-most meshes: the flat "
                "token stream does not shard over dp/sp/pp (got "
                f"dp={self.dp}×slices={self.num_slices}, sp={self.sp}, "
                f"pp={self.pp})"
            )
