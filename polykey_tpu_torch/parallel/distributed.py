"""Multi-process bootstrap and hybrid meshes (the reference's
parallel/distributed.py), over torch.distributed.

Bootstrap env (the reference's contract):
    POLYKEY_COORDINATOR   host:port of process 0 (e.g. "10.0.0.1:8476")
    POLYKEY_NUM_PROCESSES total process count
    POLYKEY_PROCESS_ID    this process's rank
With none of them set `initialize_from_env` is a no-op; with some but not
all, or with counts that are not integers, it raises. Otherwise it brings
up the default process group over TCP at the coordinator: NCCL when the
process runs on the card (its device is `process_id % device_count`),
gloo on the CPU (`device="cpu"` or POLYKEY_DEVICE=cpu). It is idempotent.
The gateway server calls it before the engine starts.

Layout rule, as in the reference: only data parallelism crosses slices.
`create_hybrid_mesh` folds the slice dimension outermost into dp, so a
gradient all-reduce over dp is the one collective that spans slices;
pp/sp/ep/tp keep their full extent inside each slice (a slice is a
contiguous run of ranks: a host's cards, in order).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import AXIS_NAMES, Mesh, MeshConfig, build_mesh, create_mesh


def initialize_from_env(logger=None, device=None) -> bool:
    """Bring up the default process group if configured; returns True when
    it is up (idempotent; a no-op returning False without config)."""
    coordinator = os.environ.get("POLYKEY_COORDINATOR")
    num_procs = os.environ.get("POLYKEY_NUM_PROCESSES")
    proc_id = os.environ.get("POLYKEY_PROCESS_ID")

    if coordinator is None and num_procs is None and proc_id is None:
        return False

    def _int_ok(v):
        try:
            int(v)
            return True
        except (TypeError, ValueError):
            return False

    if not (coordinator and num_procs and proc_id
            and _int_ok(num_procs) and _int_ok(proc_id)):
        raise ValueError(
            "partial distributed config: POLYKEY_COORDINATOR, "
            "POLYKEY_NUM_PROCESSES and POLYKEY_PROCESS_ID must be set "
            "together, non-empty, with integer counts "
            f"(coordinator={coordinator!r}, "
            f"num_processes={num_procs!r}, process_id={proc_id!r})"
        )
    if dist.is_initialized():
        return True
    from ..device import resolve_device

    dev = resolve_device(device)
    rank, world = int(proc_id), int(num_procs)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", rank=rank, world_size=world,
    )
    if logger is not None:
        logger.info(
            "distributed runtime initialized",
            coordinator=coordinator,
            process_id=dist.get_rank(),
            num_processes=dist.get_world_size(),
            backend=dist.get_backend(),
        )
    return True


def create_hybrid_mesh(
    config: MeshConfig,
    num_slices: int,
    devices: Optional[Sequence[int]] = None,
    device=None,
) -> Optional[Mesh]:
    """Mesh spanning `num_slices` slices: dp becomes (num_slices x
    config.dp) with the slice dimension outermost; every other axis keeps
    its full extent inside a slice. `devices` (global ranks, default every
    rank) split into equal contiguous slices. Axis names are unchanged."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized() else 1)
    devices = list(devices)
    device_array = hybrid_device_array(config, num_slices, devices)
    if num_slices == 1:
        return create_mesh(config, devices, device)
    return build_mesh(device_array, device)


def hybrid_device_array(config: MeshConfig, num_slices: int,
                        devices: Sequence[int]) -> np.ndarray:
    """`create_hybrid_mesh`'s layout of `devices` (global ranks) in
    AXIS_NAMES order, without making any group."""
    devices = list(devices)
    per_slice = config.num_devices
    if per_slice * num_slices != len(devices):
        raise ValueError(
            f"hybrid mesh needs {per_slice} × {num_slices} devices, "
            f"have {len(devices)}"
        )
    device_array = np.asarray(devices).reshape((num_slices,) + config.shape)
    return device_array.reshape((num_slices * config.dp,) + config.shape[1:])


def mesh_from_env(devices: Optional[Sequence[int]] = None, device=None) -> Optional[Mesh]:
    """Mesh from POLYKEY_{DP,PP,SP,EP,TP,NUM_SLICES} (defaults: everything
    1 except dp, which absorbs the remaining ranks)."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized() else 1)
    devices = list(devices)
    axes = {
        name: int(os.environ.get(f"POLYKEY_{name.upper()}", "0") or 0)
        for name in AXIS_NAMES
    }
    # polylint: disable=ML004(mesh bootstrap runs before any EngineConfig exists; from_env later reads the same env)
    num_slices = int(os.environ.get("POLYKEY_NUM_SLICES", "1") or 1)
    known = 1
    for v in axes.values():
        known *= max(v, 1)
    if axes["dp"] == 0:
        axes["dp"] = len(devices) // (known * num_slices)
    config = MeshConfig(**{k: max(v, 1) for k, v in axes.items()})
    return create_hybrid_mesh(config, num_slices, devices, device)
