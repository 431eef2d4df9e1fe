"""Weight-only int8 / int4 quantization, and the weight seam: every linear,
expert einsum, embedding lookup and unembedding goes through here (the
reference's models/quant.py).

int8 (`POLYKEY_QUANTIZE=int8`): symmetric per-output-channel scales, the
int8 values cast to the activation dtype inside the product and the scale
folded after it (`(x @ q) * s`). int4 (`POLYKEY_QUANTIZE=int4`): group-wise
scales along the contraction axis (`group_size`, shrunk to the whole axis
when it does not divide), two nibbles a uint8 byte packed in pairs along
the contraction axis (row 2i low, row 2i+1 high), dequantized on the
weight side (`x @ (q * s)`). The embedding and lm_head stay int8 under
int4. Norms and the MoE router stay in the weights' dtype.

On the GPU the casts are plain PyTorch: an int8 product reads the int8
weight, writes it back in bf16 and reads that again. A fused dequantizing
GEMM is a later item (ROADMAP.md A.13).

`quantize` matches the reference's byte for byte as its engine runs it
(eagerly): the same fp32 operations (`w / scale`, round half to even, the
1e-8 floor) and the nibble pairs wrapped through uint8. Under `jax.jit`
XLA turns `absmax / 127` into a product with the reciprocal, and a few
scales move by one ulp; the port follows the eager division.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass
class QuantizedTensor:
    """Int8/int4 weights with fp32 scales.

    q: bits=8: int8 [..., in, out] (the weight's shape); bits=4: uint8
       [..., in/2, out], nibble pairs packed along the contraction axis.
    s: fp32; bits=8: [..., out]; bits=4: [..., in/group, out].
    act_dtype: the weight's dtype before quantization, which dequantized
    products run in; `.dtype` reports it and `.shape` the logical weight
    shape, as for a tensor.
    """

    q: torch.Tensor
    s: torch.Tensor
    act_dtype: torch.dtype = torch.bfloat16
    bits: int = 8

    @property
    def shape(self) -> tuple:
        if self.bits == 4:
            return (*self.q.shape[:-2], self.q.shape[-2] * 2, self.q.shape[-1])
        return tuple(self.q.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.act_dtype


WeightLike = Union[torch.Tensor, QuantizedTensor]


def _int8(wf: torch.Tensor, absmax: torch.Tensor, dim: int) -> tuple:
    """(int8 q, fp32 scale) of fp32 `wf` with its absmax over `dim`."""
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale.unsqueeze(dim)).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize(w: torch.Tensor, bits: int = 8, group_size: int = 128) -> QuantizedTensor:
    """Symmetric quantization of [..., in, out]. bits=8: per-output-channel
    scales. bits=4: group-wise scales along the contraction axis."""
    wf = w.float()
    if bits == 8:
        q, scale = _int8(wf, wf.abs().amax(dim=-2), -2)
        return QuantizedTensor(q=q, s=scale, act_dtype=w.dtype)
    if bits != 4:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    cin, cout = w.shape[-2], w.shape[-1]
    if cin % 2:
        raise ValueError(f"int4 needs an even contraction axis to nibble-pack, got {cin}")
    g = int4_group(cin, group_size)
    lead = tuple(w.shape[:-2])
    grouped = wf.reshape(*lead, cin // g, g, cout)
    scale = grouped.abs().amax(dim=-2).clamp_min(1e-8) / 7.0       # [..., G, out]
    q = torch.round(grouped / scale.unsqueeze(-2)).clamp(-7, 7).reshape(w.shape)
    return QuantizedTensor(q=_pack_nibbles(q), s=scale, act_dtype=w.dtype, bits=4)


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Values in [-7, 7] of [..., in, out] as uint8 [..., in/2, out]:
    two's-complement nibbles through the uint8 wrap, row 2i low, 2i+1
    high."""
    *lead, cin, cout = q.shape
    pairs = q.to(torch.int8).reshape(*lead, cin // 2, 2, cout)
    return ((pairs[..., 0, :].to(torch.uint8) & 0xF)
            | ((pairs[..., 1, :].to(torch.uint8) & 0xF) << 4))


def quantize_rows(w: torch.Tensor, bits: int, absmax: torch.Tensor, first_row: int = 0,
                  group: int = 0) -> QuantizedTensor:
    """A run of rows (contraction-axis entries `first_row`, ...) of a
    [..., in, out] weight, quantized as `quantize` quantizes the whole:
    `absmax` is the whole weight's fp32 absmax over its contraction axis
    ([..., out]) for int8, or over each of its groups of `group` rows
    ([..., G, out]) for int4. The result's q is the whole q's rows and its
    s the whole s, bit for bit, as a tp rank holds a row-parallel leaf."""
    wf = w.float()
    if bits == 8:
        q, scale = _int8(wf, absmax, -2)
        return QuantizedTensor(q=q, s=scale, act_dtype=w.dtype)
    scale = absmax.clamp_min(1e-8) / 7.0                            # [..., G, out]
    rows = torch.arange(first_row, first_row + w.shape[-2], device=w.device) // group
    q = torch.round(wf / scale.index_select(-2, rows)).clamp(-7, 7)
    return QuantizedTensor(q=_pack_nibbles(q), s=scale, act_dtype=w.dtype, bits=4)


def int4_group(cin: int, group_size: int = 128) -> int:
    """The rows a group of `quantize(bits=4)` spans on a `cin`-row weight."""
    return group_size if cin % group_size == 0 else cin


def _cast_q(w: QuantizedTensor, dtype: torch.dtype) -> torch.Tensor:
    """An int8 weight's values in `dtype` (exact: |q| <= 127)."""
    return w.q.to(dtype)


def _deq_weight(w: QuantizedTensor, dtype: torch.dtype) -> torch.Tensor:
    """An int4 weight unpacked and scaled group-wise in `dtype`: the
    logical [..., in, out] weight."""
    p = w.q
    low = (p & 0xF).to(torch.int8)
    high = (p >> 4).to(torch.int8)
    low = torch.where(low > 7, low - 16, low)          # sign-extend the nibble
    high = torch.where(high > 7, high - 16, high)
    shape = w.shape
    q = torch.stack([low, high], dim=-2).reshape(shape)
    G, cin, cout = w.s.shape[-2], shape[-2], shape[-1]
    grouped = q.reshape(*shape[:-2], G, cin // G, cout).to(dtype)
    return (grouped * w.s.unsqueeze(-2).to(dtype)).reshape(shape)


def dequantize(w: QuantizedTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if w.bits == 4:
        return _deq_weight(w, torch.float32).to(dtype)
    return (w.q.float() * w.s.unsqueeze(-2)).to(dtype)


def qdot(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """x @ w for [in, out] weights: int8 scales fold after the product,
    int4 dequantizes on the weight side."""
    if isinstance(w, QuantizedTensor):
        if w.bits == 4:
            return x @ _deq_weight(w, x.dtype)
        return (x @ _cast_q(w, x.dtype)) * w.s.to(x.dtype)
    return x @ w


def qeinsum_expert(pattern: str, x: torch.Tensor, w: WeightLike, e_axis: int) -> torch.Tensor:
    """Expert-stacked einsum: int8 scales are [E, out], and `e_axis` names
    the expert axis in the OUTPUT (out is always last): 'bth,ehi->beti'
    (e_axis=1) and 'ech,ehi->eci' (e_axis=0). int4 dequantizes on the
    weight side."""
    if isinstance(w, QuantizedTensor):
        if w.bits == 4:
            return torch.einsum(pattern, x, _deq_weight(w, x.dtype))
        y = torch.einsum(pattern, x, _cast_q(w, x.dtype))
        shape = [1] * y.dim()
        shape[e_axis], shape[-1] = w.s.shape[0], w.s.shape[-1]
        return y * w.s.reshape(shape).to(y.dtype)
    return torch.einsum(pattern, x, w)


def embed_lookup(embed: WeightLike, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding row lookup: [V, H] gathered at tokens → [..., H]; a
    quantized embedding's scales are per hidden channel. Ids past the
    vocabulary clamp to its last row, as the reference's gather does (a
    byte tokenizer can emit ids above a small test vocabulary; on the GPU
    an out-of-range index would be a device-side fault)."""
    ids = tokens.clamp(0, embed.shape[0] - 1)
    if isinstance(embed, QuantizedTensor):
        return embed.q[ids].to(embed.dtype) * embed.s.to(embed.dtype)
    return embed[ids]


def unembed_logits(hidden: torch.Tensor, embed_or_head: WeightLike, tied: bool) -> torch.Tensor:
    """fp32 vocab logits from a tied embedding ('...h,vh->...v') or an
    lm_head ('...h,hv->...v'). The product runs in the weights' dtype with
    fp32 accumulation inside the matmul; the result is returned as fp32.
    Quantized: the int8 values are exact in the weights' dtype; a tied
    embedding's scales ([H], the contraction axis) fold into the
    activation before the product, an lm_head's ([V]) after it."""
    if isinstance(embed_or_head, QuantizedTensor):
        w, wdt = embed_or_head, embed_or_head.dtype
        if tied:
            scaled = (hidden.float() * w.s).to(wdt)
            return (scaled @ _cast_q(w, wdt).transpose(0, 1)).float()
        return (hidden.to(wdt) @ _cast_q(w, wdt)).float() * w.s
    w = embed_or_head
    h = hidden.to(w.dtype)
    logits = h @ w.transpose(0, 1) if tied else h @ w
    return logits.float()


_QUANT_LEAVES = ("wq", "wk", "wv", "wo", "gate", "up", "down", "lm_head")


def quantize_tree(node, bits: int = 8):
    """Every `_QUANT_LEAVES` tensor of a (nested dict / list) tree
    quantized, expert stacks included ([E, in, out]: scales reduce the
    contraction axis only); lm_head stays int8 under int4. Everything else
    (norms, router, the embedding) is returned as it is."""
    if isinstance(node, list):
        return [quantize_tree(child, bits) for child in node]
    if not isinstance(node, dict):
        return node
    out = {}
    for name, child in node.items():
        if name in _QUANT_LEAVES and isinstance(child, torch.Tensor):
            out[name] = quantize(child, bits=8 if name == "lm_head" else bits)
        else:
            out[name] = quantize_tree(child, bits)
    return out


def quantize_embed(embed: torch.Tensor, absmax: Optional[torch.Tensor] = None
                   ) -> QuantizedTensor:
    """The embedding in int8 with scales per hidden channel ([H], the axis
    the tied unembedding contracts), so one tensor serves both uses. A
    run of vocabulary rows passes the whole embedding's fp32 absmax over
    its rows (`absmax`, [H]) and gets the whole's rows and scales."""
    ef = embed.float()
    q, scale = _int8(ef, ef.abs().amax(dim=0) if absmax is None else absmax, 0)
    return QuantizedTensor(q=q, s=scale, act_dtype=embed.dtype)


def quantize_params(params: dict, cfg=None, bits: int = 8) -> dict:
    """Quantize every linear weight of the port's parameter tree (the
    reference's quantize_params): block linears in `bits`, lm_head and the
    embedding in int8. `cfg` is accepted for the reference's signature."""
    out = quantize_tree(params, bits)
    out["embed"] = quantize_embed(params["embed"])
    return out


def _leaves(node):
    if isinstance(node, dict):
        for child in node.values():
            yield from _leaves(child)
    elif isinstance(node, list):
        for child in node:
            yield from _leaves(child)
    elif isinstance(node, QuantizedTensor):
        yield node.q
        yield node.s
    else:
        yield node


def params_bytes(params) -> int:
    """Parameter storage in bytes; a quantized leaf counts q and s (int4 q
    is packed, so its size is already the memory's)."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))
