"""Carry the reference's weights into the port.

`params_from_numpy` takes the JAX `init_params` pytree after each leaf has
been brought to the host as a numpy array (`jax.device_get` or
`np.asarray`), with layers stacked on a leading [L, ...] axis, and returns
the port's parameter dict (models/transformer.py: one dict per layer).
A MoE layer's `router` [L, H, E] and `experts` gate/up/down [L, E, in, out]
split per layer like every other stacked leaf. A quantized leaf (the
reference's QuantizedTensor, read by its fields: int8 or uint8 `q`, fp32
`s`, `act_dtype`, `bits`) becomes the port's models.quant.QuantizedTensor
with the same bytes.
bf16 leaves (ml_dtypes bfloat16, which `torch.from_numpy` rejects) pass as
a uint16 view and come back with `.view(torch.bfloat16)`, bit for bit.
`paged_kv_from_numpy` does the same for the reference's PagedKV (int8
values and bf16 scales for int8 KV), so both packages can start from the
same pools. This module imports no JAX; it only reads numpy arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .quant import QuantizedTensor


def tensor_from_numpy(
    arr, device="cpu", dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) → torch, exact; then cast/move."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _convert(node, device, dtype):
    if isinstance(node, dict):
        return {k: _convert(v, device, dtype) for k, v in node.items()}
    if hasattr(node, "q") and hasattr(node, "bits"):
        # Values and scales keep their bytes; `dtype` sets the dtype the
        # products run in.
        return QuantizedTensor(
            q=tensor_from_numpy(node.q, device), s=tensor_from_numpy(node.s, device),
            act_dtype=dtype or _DTYPES[np.dtype(node.act_dtype).name], bits=int(node.bits))
    return tensor_from_numpy(node, device, dtype)


def params_from_numpy(tree: dict, device="cpu", dtype: Optional[torch.dtype] = None) -> dict:
    """Reference pytree (stacked layers) → port params (list of layers)."""
    stacked = _convert(tree["layers"], device, dtype)
    num_layers = stacked["ln1"].shape[0]

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(q=node.q[i].contiguous(), s=node.s[i].contiguous(),
                                   act_dtype=node.act_dtype, bits=node.bits)
        return node[i].contiguous()

    params = {
        k: _convert(v, device, dtype) for k, v in tree.items() if k != "layers"
    }
    params["layers"] = [pick(stacked, i) for i in range(num_layers)]
    return params


def paged_kv_from_numpy(paged, device="cpu"):
    """The reference's PagedKV with numpy leaves k, v and, for int8 KV, ks
    and vs (None for fp pools) -> the port's engine.kv_cache.PagedKV, bit
    for bit."""
    from ..engine.kv_cache import PagedKV

    return PagedKV(**{
        name: None if getattr(paged, name) is None
        else tensor_from_numpy(getattr(paged, name), device)
        for name in ("k", "v", "ks", "vs")
    })
