"""Device selection: the GPU unless the caller asks for the CPU.

Entry points (the engine, the server) take `device=None` and resolve it
here. The CPU is reachable only by asking — `device="cpu"` or
`POLYKEY_DEVICE=cpu` — so a machine without a usable GPU fails loudly at
startup instead of quietly serving from the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DEVICE_ENV = "POLYKEY_DEVICE"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` if given, else $POLYKEY_DEVICE, else "cuda". Raises when
    the result is a CUDA device and CUDA is unavailable."""
    if device is None:
        # polylint: disable=ML003(the port's device switch, documented in README.md's port section and the verify skill; DEPLOY.md's knob tables cover the JAX package's deployment)
        device = os.environ.get(DEVICE_ENV, "").strip() or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch.cuda.is_available() is False). "
            f"The serving path runs on the GPU; pass device='cpu' or set "
            f"{DEVICE_ENV}=cpu to run it on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use cuda or cpu")
    return dev
