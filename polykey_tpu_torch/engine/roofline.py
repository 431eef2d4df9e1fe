"""Roofline accounting: grade measured serving numbers against the card
(the reference's engine/roofline.py, with the same functions, names and
arguments, over the port's models/config.py).

Decode is weight+KV *read*-bound, so a decode phase carries its model-
bandwidth utilization (MBU); prefill is matmul-bound, so it carries its
model-FLOP utilization (MFU). All byte/FLOP counts derive from the
architecture geometry in models/config.py (ModelConfig.num_params /
num_active_params); they are intentionally first-order (no norm or
activation traffic, no padding): good to a few percent for dense models,
which is enough to tell "at 6% of roofline" from "at 60%".

Decode, per engine step with B live lanes at average context C:
  step_bytes = dense_weights + experts_hit * expert_bytes
               + B * C * kv_bytes_per_token
  (weights amortize over lanes; for MoE the experts HIT per step is
  min(num_experts, B * top_k): at serving batch widths effectively every
  expert streams every step, so MoE weight traffic does NOT amortize the
  way dense does.)
  flops  = B * (2 * active_params + 4 * L * C * H * Dh)
  MBU    = achieved bytes/s / (n_chips * card memory bytes/s)
  MFU    = achieved flops/s / (n_chips * card peak flops)
Speculative decoding adds the draft model's step weight read; its extra
FLOPs are second-order for byte-bound decode and are not modeled.
Prefill FLOPs for a P-token prompt ~ P * (2 * active_params) +
  2 * L * P^2 * H * Dh (causal attention ~ half the dense 4x term).
`prefill_mfu_at_ttft` divides by the measured light-load TTFT, so it is
a LOWER bound on kernel MFU (TTFT includes host tokenize/queue/dispatch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..models.config import ModelConfig, get_config


@dataclass(frozen=True)
class ChipSpec:
    name: str
    # No int8 peak here: the int8 paths keep bf16 activations, so bf16
    # peak stays the honest MFU denominator (grade() below).
    peak_bf16_flops: float     # FLOP/s
    hbm_bytes_per_s: float
    hbm_bytes: float           # per-card capacity (drives hbm_weight_fraction)


# Public spec-sheet numbers.
CHIP_SPECS = {
    # NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU datasheet):
    # 989 dense bf16 TFLOP/s, 3.35 TB/s HBM3, 80 GB.
    "h100-sxm": ChipSpec("h100-sxm", 989e12, 3.35e12, 80e9),
}

# The device names that map to a spec: only what the card reports. The
# H100 PCIe (2.0 TB/s, 756 TFLOP/s) and every other kind return None.
_KINDS = {"NVIDIA H100 80GB HBM3": "h100-sxm"}


def detect_chip() -> Optional[ChipSpec]:
    """Map torch.cuda.get_device_name() to a ChipSpec; None on the CPU (a
    CPU run has no meaningful roofline: mbu/mfu stay null there, but the
    per-token byte/FLOP geometry is still emitted). Only kinds this table
    knows map to a spec: an unknown card returns None rather than being
    graded against a wrong roofline."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = _KINDS.get(torch.cuda.get_device_name(0))
    except Exception:
        # No devices / unqueryable runtime: the roofline annotation is
        # optional context, None disables it without failing the caller.
        return None
    return CHIP_SPECS[name] if name is not None else None


def _bytes_per_el(dtype: str) -> float:
    return {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0}.get(dtype, 2.0)


def _weight_bytes_split(cfg: ModelConfig, dtype: str,
                        quantize: bool, bits: int) -> tuple[float, float]:
    """(dense_bytes, per_expert_bytes) a decode step can stream from HBM.

    dense_bytes: everything read unconditionally each step — attention +
    norms + router (+ the dense MLP for non-MoE) + the LM head (full
    vocab x hidden matmul per step). The embedding table contributes only
    a row gather (negligible). per_expert_bytes: ONE expert's MLP; the
    caller decides how many experts a step hits. int4 keeps embed/lm_head
    at int8 (models/quant.py) — modeled as such."""
    embed = cfg.vocab_size * cfg.hidden_size
    head_params = embed  # lm head is read every step, tied or not
    total = cfg.num_params()
    table_params = embed + (0 if cfg.tie_embeddings else embed)
    block_params = total - table_params  # blocks + final norm
    expert_params = 0.0
    if cfg.is_moe:
        expert_params = 3.0 * cfg.hidden_size * cfg.intermediate_size
        block_params -= cfg.num_layers * cfg.num_experts * expert_params
    if not quantize:
        b = _bytes_per_el(dtype)
        return (block_params + head_params) * b, \
            cfg.num_layers * expert_params * b
    block_b = bits / 8.0
    # Quant scales: one fp32 per channel-group; second-order, ignored.
    # embed/lm_head stay int8 in the int4 scheme.
    return block_params * block_b + head_params * 1.0, \
        cfg.num_layers * expert_params * block_b


def weight_read_bytes(cfg: ModelConfig, dtype: str, quantize: bool,
                      bits: int, lanes: float = 1.0) -> float:
    """Weight bytes one decode step streams from HBM at `lanes` live
    lanes. Dense models: lane-independent. MoE: experts hit per step =
    min(num_experts, lanes * top_k) — the expected coverage; exact
    routing multinomials are second-order."""
    dense, per_expert = _weight_bytes_split(cfg, dtype, quantize, bits)
    if not cfg.is_moe:
        return dense
    hit = min(float(cfg.num_experts),
              max(lanes, 1.0) * cfg.num_experts_per_tok)
    return dense + hit * per_expert


def weight_resident_bytes(cfg: ModelConfig, dtype: str, quantize: bool,
                          bits: int) -> float:
    """HBM the model's weights OCCUPY (capacity, not per-step traffic):
    every expert is resident even though a step streams only the hit
    ones, and an untied embedding table sits in HBM even though decode
    only row-gathers it. Feeds grade()'s hbm_weight_fraction — the
    headroom number that decides how many KV pages (decode slots) a chip
    has left."""
    dense, per_expert = _weight_bytes_split(cfg, dtype, quantize, bits)
    resident = dense
    if cfg.is_moe:
        resident += cfg.num_experts * per_expert
    if not cfg.tie_embeddings:
        # The input table; the LM head copy is already in dense. Stays
        # int8 under quantization (models/quant.py).
        table = cfg.vocab_size * cfg.hidden_size
        resident += table * (1.0 if quantize else _bytes_per_el(dtype))
    return resident


def kv_bytes_per_token(cfg: ModelConfig, kv_dtype: str) -> float:
    """KV bytes one cached token occupies across all layers (K + V)."""
    return (2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim
            * _bytes_per_el(kv_dtype))


def kv_pool_bytes_split(cfg: ModelConfig, num_pages: int, page_size: int,
                        kv_dtype: str) -> tuple[float, float]:
    """(value_bytes, scale_bytes) the preallocated paged KV pool occupies
    in HBM. Mirrors engine/kv_cache.py's allocation of the pools: int8 pools carry a bf16 scale per
    (k|v, head, token slot) alongside the int8 values; wider dtypes have
    no scale plane. Pure model/geometry arithmetic."""
    slots = 2.0 * cfg.num_layers * num_pages * page_size  # k + v planes
    if kv_dtype == "int8":
        return (slots * cfg.num_kv_heads * cfg.head_dim * 1.0,
                slots * cfg.num_kv_heads * 2.0)
    return (slots * cfg.num_kv_heads * cfg.head_dim
            * _bytes_per_el(kv_dtype), 0.0)


def kv_pool_bytes_spec(cfg: ModelConfig, num_pages: int, page_size: int,
                       kv_dtype: str) -> float:
    """Total paged-pool bytes (values + int8 scale planes)."""
    values, scales = kv_pool_bytes_split(cfg, num_pages, page_size, kv_dtype)
    return values + scales


def decode_flops_per_token(cfg: ModelConfig, ctx: float) -> float:
    """MatMul FLOPs to decode one token at context length ctx."""
    attn_scores = 4.0 * cfg.num_layers * ctx * cfg.num_heads * cfg.head_dim
    return 2.0 * cfg.num_active_params() + attn_scores


def prefill_flops(cfg: ModelConfig, prompt_len: int) -> float:
    """MatMul FLOPs to prefill a prompt (causal attention ~ P^2/2)."""
    attn = 2.0 * cfg.num_layers * prompt_len**2 * cfg.num_heads * cfg.head_dim
    return prompt_len * 2.0 * cfg.num_active_params() + attn


def grade(model: str, dtype: str, quantize: bool, quantize_bits: int,
          kv_dtype: str, tok_s: float, avg_lanes: Optional[float],
          avg_ctx: float, p50_ttft_ms: Optional[float] = None,
          prompt_len: Optional[int] = None,
          chip: Optional[ChipSpec] = None,
          draft_model: Optional[str] = None,
          n_chips: int = 1, assumed_lanes: float = 1.0,
          kv_pool_bytes: Optional[float] = None) -> dict:
    """Physics scorecard for one measured phase.

    Always emits the per-token geometry (bytes_per_token, flops_per_token
    at the measured occupancy/context); emits mbu/mfu/prefill_mfu_at_ttft
    only when a chip roofline applies (None on CPU). avg_lanes is the
    measured mean live decode lanes per dispatched block (loop trace);
    pass None when unmeasured — the scorecard then assumes full occupancy
    of `assumed_lanes` and SAYS so (avg_lanes_source), rather than
    silently grading against an occupancy never observed. draft_model
    adds the speculative draft's weight stream. n_chips scales the
    roofline denominator for tp/ep/dp meshes."""
    cfg = get_config(model)
    kv_dt = kv_dtype or dtype
    measured = avg_lanes is not None
    lanes = max(avg_lanes, 1.0) if measured else max(assumed_lanes, 1.0)

    w_bytes = weight_read_bytes(cfg, dtype, quantize, quantize_bits, lanes)
    if draft_model:
        dcfg = get_config(draft_model)
        w_bytes += weight_read_bytes(
            dcfg, dtype, quantize, quantize_bits, lanes)
    kv_tok = kv_bytes_per_token(cfg, kv_dt)
    bytes_per_token = w_bytes / lanes + avg_ctx * kv_tok
    flops_per_token = decode_flops_per_token(cfg, avg_ctx)

    out = {
        "bytes_per_token": round(bytes_per_token),
        "flops_per_token": round(flops_per_token),
        "weight_read_bytes": round(w_bytes),
        "kv_bytes_per_cached_token": round(kv_tok),
        "avg_lanes": round(lanes, 2),
        "avg_lanes_source": "measured" if measured else "assumed_full",
        "avg_ctx": round(avg_ctx, 1),
        "chip": chip.name if chip else None,
        "n_chips": n_chips,
        "mbu": None,
        "mfu": None,
    }
    if draft_model:
        out["draft_model"] = draft_model
    if chip is not None:
        # Capacity headroom: what fraction of this chip set's HBM the
        # resident weights (draft included) consume — the complement is
        # the KV-page budget that caps decode slots.
        resident = weight_resident_bytes(cfg, dtype, quantize, quantize_bits)
        if draft_model:
            resident += weight_resident_bytes(
                get_config(draft_model), dtype, quantize, quantize_bits)
        out["hbm_weight_fraction"] = round(
            resident / (n_chips * chip.hbm_bytes), 4)
        if kv_pool_bytes is not None:
            # Full capacity statement: weights PLUS the preallocated
            # paged KV pool and its int8 scale planes.
            # hbm_weight_fraction keeps its weights-only meaning; the
            # extended accounting has keys of its own.
            out["hbm_kv_pool_bytes"] = round(kv_pool_bytes)
            out["hbm_resident_fraction"] = round(
                (resident + kv_pool_bytes) / (n_chips * chip.hbm_bytes), 4)
    if chip is not None and tok_s > 0:
        hbm_bw = n_chips * chip.hbm_bytes_per_s
        peak = n_chips * chip.peak_bf16_flops
        achieved_bw = tok_s * bytes_per_token
        out["mbu"] = round(achieved_bw / hbm_bw, 4)
        # MFU against the precision actually multiplying: int8 weights
        # are dequantized and multiplied in bf16, so bf16 peak is the
        # honest denominator.
        out["mfu"] = round(tok_s * flops_per_token / peak, 4)
        # Decode-side roofline ceiling: tokens/s if HBM were saturated.
        out["roofline_tok_s"] = round(hbm_bw / bytes_per_token, 1)
        if p50_ttft_ms and prompt_len:
            pf = prefill_flops(cfg, prompt_len)
            out["prefill_mfu_at_ttft"] = round(
                pf / (p50_ttft_ms / 1e3) / peak, 4)
    return out
