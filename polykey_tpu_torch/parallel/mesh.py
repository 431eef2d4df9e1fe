"""Process mesh: dp x pp x sp x ep x tp axes over torch.distributed (the
reference's parallel/mesh.py).

Axis meanings (an axis of size 1 stays declared, so the layout code is
the same for every configuration):

- ``dp``: data parallel, the batch's rows.
- ``pp``: pipeline parallel, runs of layers (parallel/pipeline.py).
- ``sp``: sequence parallel, the sequence's columns (ring or Ulysses
  attention, ops/ring_attention.py and ops/ulysses_attention.py).
- ``ep``: expert parallel, the MoE expert axis.
- ``tp``: tensor parallel, Megatron heads and MLP columns; the last,
  fastest-varying axis, so tp groups hold neighbouring ranks.

A rank is one process with one device. Ranks are laid out row-major over
`MeshConfig.shape`, as the reference reshapes its device list, and every
axis has one process group per line of ranks along it (its rank's group
is `Mesh.group(axis)`); collectives over an axis go to that group, a group
of one included. The backend is NCCL on the card and gloo on the CPU
(parallel/distributed.py brings the default group up).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXIS_NAMES = ("dp", "pp", "sp", "ep", "tp")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.ep, self.tp)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)


@dataclass
class Mesh:
    """This rank's view of the mesh: `devices`, the global ranks laid out
    over AXIS_NAMES; `rank`, this process's global rank; `device`, where
    its tensors live; `groups`, its process group on each axis (empty for
    a layout-only mesh, which can place shards but not communicate);
    `control`, a serving mesh's gloo group over all its ranks, which
    carries the lock-step records, and `pages`, a second one, which
    carries whole KV pages assembled from the ranks' shards
    (engine/lockstep.py)."""

    devices: np.ndarray
    rank: int
    device: torch.device = torch.device("cpu")
    groups: dict = field(default_factory=dict)
    axis_names: tuple = AXIS_NAMES
    control: Optional[object] = None
    pages: Optional[object] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        where = np.argwhere(self.devices == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    def ranks_along(self, axis: str) -> list[int]:
        """The global ranks of this rank's line along `axis`, in order."""
        where = list(np.argwhere(self.devices == self.rank)[0])
        where[self.axis_names.index(axis)] = slice(None)
        return [int(r) for r in self.devices[tuple(where)]]

    def group(self, axis: str):
        return self.groups[axis]


def _lines(devices: np.ndarray, i: int) -> list[list[int]]:
    """Every line of ranks along axis `i`, in a fixed order."""
    moved = np.moveaxis(devices, i, -1)
    return [[int(r) for r in line] for line in moved.reshape(-1, moved.shape[-1])]


def build_mesh(device_array: np.ndarray, device=None) -> Optional[Mesh]:
    """The mesh over `device_array` (global ranks in AXIS_NAMES order).
    Every rank of the default group must call it, in the same order as
    every other group it creates: a group is made collectively. Returns
    None on a rank outside `device_array`."""
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "parallel.distributed.initialize_from_env (or "
            "init_process_group) before building a mesh"
        )
    rank = dist.get_rank()
    world = dist.get_world_size()
    groups = {}
    for i, axis in enumerate(AXIS_NAMES):
        for line in _lines(device_array, i):
            if line != sorted(line):
                # A group's ranks are numbered in ascending order; the
                # gathers and exchanges rely on that order being the axis's.
                raise ValueError(f"ranks along {axis} must increase, got {line}")
            group = (dist.group.WORLD if sorted(line) == list(range(world))
                     else dist.new_group(line))
            if rank in line:
                groups[axis] = group
    if rank not in device_array:
        return None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(device_array, rank, torch.device(device), groups)


def create_mesh(
    config: MeshConfig = MeshConfig(),
    devices: Optional[Sequence[int]] = None,
    device=None,
) -> Optional[Mesh]:
    """Mesh of `config` over `devices` (global ranks; default every rank
    of the default group), laid out row-major with tp innermost."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized() else 1)
    devices = list(devices)
    if config.num_devices != len(devices):
        raise ValueError(
            f"mesh {dict(zip(AXIS_NAMES, config.shape))} needs "
            f"{config.num_devices} devices, have {len(devices)}"
        )
    return build_mesh(np.asarray(devices).reshape(config.shape), device)


def single_device_mesh(device=None) -> Mesh:
    """Mesh with every axis of size 1 over a one-rank group: shards are
    whole and every collective is one over a group of one. Brings the
    group up (in-process store, no network) when none is, on the backend
    for `device` (NCCL for CUDA, gloo for the CPU)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(
            f"single_device_mesh needs a one-rank group, have "
            f"{dist.get_world_size()} ranks"
        )
    return create_mesh(MeshConfig(), [0], dev)
