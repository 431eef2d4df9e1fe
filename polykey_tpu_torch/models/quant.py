"""The weight seam: every linear, embedding lookup and unembedding goes
through here, as in the reference's models/quant.py.

Only the unquantized paths are ported. Weight-only int8/int4
(`QuantizedTensor` trees, `POLYKEY_QUANTIZE`) are a later slice of the
port (ROADMAP.md, queue A: "int8/int4 weights"); any non-tensor weight
raises NotImplementedError naming that item rather than computing
something else.
"""

from __future__ import annotations

import torch

_QUANT_TODO = (
    "quantized weights (int8/int4 QuantizedTensor trees, POLYKEY_QUANTIZE) "
    "are not ported to polykey_tpu_torch yet — ROADMAP.md queue A, "
    "'int8/int4 weights'"
)


def _dense(w) -> torch.Tensor:
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(_QUANT_TODO)
    return w


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for [in, out] weights (the reference's layout)."""
    return x @ _dense(w)


def embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding row lookup: [V, H] gathered at tokens → [..., H]. Ids
    past the vocabulary clamp to its last row, as the reference's gather
    does (a byte tokenizer can emit ids above a small test vocabulary; on
    the GPU an out-of-range index would be a device-side fault)."""
    w = _dense(embed)
    return w[tokens.clamp(0, w.shape[0] - 1)]


def unembed_logits(hidden: torch.Tensor, embed_or_head, tied: bool) -> torch.Tensor:
    """fp32 vocab logits from a tied embedding ('...h,vh->...v') or an
    lm_head ('...h,hv->...v'). The product runs in the weights' dtype with
    fp32 accumulation inside the matmul; the result is returned as fp32."""
    w = _dense(embed_or_head)
    h = hidden.to(w.dtype)
    logits = h @ w.transpose(0, 1) if tied else h @ w
    return logits.float()
