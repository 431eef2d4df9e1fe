"""Carry the reference's weights into the port.

`params_from_numpy` takes the JAX `init_params` pytree after each leaf has
been brought to the host as a numpy array (`jax.device_get` or
`np.asarray`), with layers stacked on a leading [L, ...] axis, and returns
the port's parameter dict (models/transformer.py: one dict per layer).
bf16 leaves (ml_dtypes bfloat16, which `torch.from_numpy` rejects) pass as
a uint16 view and come back with `.view(torch.bfloat16)`, bit for bit.
This module imports no JAX; it only reads numpy arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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


def _convert(node, device, dtype):
    if isinstance(node, dict):
        return {k: _convert(v, device, dtype) for k, v in node.items()}
    return tensor_from_numpy(node, device, dtype)


def params_from_numpy(tree: dict, device="cpu", dtype: Optional[torch.dtype] = None) -> dict:
    """Reference pytree (stacked layers) → port params (list of layers)."""
    if "experts" in tree["layers"] or "router" in tree["layers"]:
        raise NotImplementedError(
            "MoE parameter trees are not ported yet — ROADMAP.md queue A, "
            "'Gemma-2 and Mixtral families'"
        )
    stacked = _convert(tree["layers"], device, dtype)
    num_layers = stacked["ln1"].shape[0]

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i].contiguous()

    params = {
        k: _convert(v, device, dtype) for k, v in tree.items() if k != "layers"
    }
    params["layers"] = [pick(stacked, i) for i in range(num_layers)]
    return params
