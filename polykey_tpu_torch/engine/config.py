"""Engine configuration (the reference's engine/config.py, POLYKEY_* env).

The fields and their env names are the reference's; the defaults are too,
except `lookahead_blocks` (1) and `adaptive_block` (off), the only values
this slice serves. `validate` raises NotImplementedError for the knobs
whose part of the port has not landed yet, naming the ROADMAP.md item, so
a deployment that asks for them fails at startup instead of being served
by something else: ragged dispatch, the prefix cache and host KV
tier, speculative decoding, int8 KV and int8/int4 weights, the lookahead
pipeline and adaptive block, the top-p prefilter, replica and disaggregated
pools, checkpoints, and mesh axes above 1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


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
    prefix_cache: bool = False
    prefix_cache_pages: int = 0
    host_kv_bytes: int = 0

    # Decode steps per dispatch: K steps run back to back on the device
    # with device-side EOS/cap stopping; their tokens come back as one
    # packed [K, B] read.
    decode_block_steps: int = 8
    adaptive_block: bool = False
    # Dispatched-but-unread decode blocks. 1 = dispatch, then read — the
    # exact-sync mode, the only one ported so far.
    lookahead_blocks: int = 1

    top_p_candidates: int = 0
    draft_model: Optional[str] = None
    spec_gamma: int = 4

    request_timeout_s: float = 300.0
    max_queue_depth: int = 256

    tp: int = 1
    dp: int = 1
    ep: int = 1
    sp: int = 1
    pp: int = 1
    num_slices: int = 1
    replicas: int = 1
    disagg: str = ""

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
            decode_block_steps=_env_int("POLYKEY_DECODE_BLOCK", cls.decode_block_steps),
            adaptive_block=_env_bool("POLYKEY_ADAPTIVE_BLOCK"),
            lookahead_blocks=_env_int(
                "POLYKEY_DISPATCH_LOOKAHEAD",
                _env_int("POLYKEY_LOOKAHEAD", cls.lookahead_blocks),
            ),
            top_p_candidates=_env_int(
                "POLYKEY_TOP_P_CANDIDATES", cls.top_p_candidates
            ),
            draft_model=os.environ.get("POLYKEY_DRAFT_MODEL") or None,
            spec_gamma=_env_int("POLYKEY_SPEC_GAMMA", cls.spec_gamma),
            request_timeout_s=_env_float(
                "POLYKEY_REQUEST_TIMEOUT", cls.request_timeout_s
            ),
            max_queue_depth=_env_int("POLYKEY_MAX_QUEUE", cls.max_queue_depth),
            tp=_env_int("POLYKEY_TP", cls.tp),
            dp=_env_int("POLYKEY_DP", cls.dp),
            ep=_env_int("POLYKEY_EP", cls.ep),
            sp=_env_int("POLYKEY_SP", cls.sp),
            pp=_env_int("POLYKEY_PP", cls.pp),
            num_slices=_env_int("POLYKEY_NUM_SLICES", cls.num_slices),
            replicas=_env_int("POLYKEY_REPLICAS", cls.replicas),
            disagg=os.environ.get("POLYKEY_DISAGG", cls.disagg),
        )

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
        if self.max_queue_depth < 0:
            raise ValueError("max_queue_depth must be >= 0 (0 → unbounded)")
        if self.kv_dtype not in ("", "bfloat16", "float32", "int8"):
            raise ValueError(
                "kv_dtype must be '', bfloat16, float32, or int8; "
                f"got {self.kv_dtype!r}"
            )
        for name in ("tp", "dp", "ep", "sp", "pp", "num_slices", "replicas"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        unported = [
            (self.ragged_dispatch, "ragged_dispatch (POLYKEY_RAGGED)",
             "kernel 4, ragged paged attention"),
            (self.prefix_cache or self.host_kv_bytes > 0,
             "prefix_cache / host_kv_bytes", "prefix cache and host-KV tier"),
            (self.draft_model is not None, "draft_model",
             "speculative decoding"),
            (self.kv_dtype == "int8", "kv_dtype=int8",
             "int8-KV variants of kernels 2 and 3"),
            (self.quantize, "quantize (POLYKEY_QUANTIZE)",
             "int8/int4 weights"),
            (self.lookahead_blocks > 1 or self.adaptive_block,
             "lookahead_blocks > 1 / adaptive_block",
             "lookahead pipeline on CUDA streams and adaptive block"),
            (self.top_p_candidates > 0, "top_p_candidates",
             "top-p candidate prefilter"),
            (self.replicas > 1 or bool(self.disagg), "replicas / disagg",
             "replica and disagg pools"),
            (self.checkpoint_path is not None, "checkpoint_path",
             "checkpoint loading"),
            (max(self.tp, self.dp, self.ep, self.sp, self.pp,
                 self.num_slices) > 1,
             "mesh axes above 1", "multi-GPU"),
        ]
        for refused, knob, item in unported:
            if refused:
                raise NotImplementedError(
                    f"{knob} is not ported to polykey_tpu_torch yet "
                    f"(ROADMAP.md queue A: {item})"
                )
