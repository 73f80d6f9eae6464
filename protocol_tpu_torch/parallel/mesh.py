"""The port's mesh: the ranks of a ``torch.distributed`` process group.

Counterpart of ``protocol_tpu/parallel/mesh.py``.  The reference runs
one controller over a 1-D ``jax.sharding.Mesh``; the port runs one
process a shard (SPMD), each on its own device, and the mesh is the
initialized process group seen from one rank: ``ShardGroup``.  Trust
convergence is one giant SpMV, so the one flat shard axis is the whole
layout: each rank's partial ``Cᵀt`` meets the others' in one all-reduce.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import resolve_device

#: The one axis the sharded trust kernels split the edges (or the window
#: rows) along: the ranks of the group.
SHARD_AXIS = "shard"


@dataclass(frozen=True)
class ShardGroup:
    """One rank's view of the process group its shard belongs to."""

    group: dist.ProcessGroup
    rank: int
    size: int
    #: The device this rank's shard and replicated vectors live on.
    device: torch.device
    #: The collective backend's name (``"gloo"``, ``"nccl"``).
    backend: str


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``None`` (or ``"cuda"`` without an index)
    means ``cuda:<local index>``, the local index being ``LOCAL_RANK``
    where it is set, else the rank, modulo the visible cards, and raises
    ``RuntimeError`` where there is no card (``resolve_device``);
    anything else is taken as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def default_mesh(n_devices: int | None = None, *, device=None) -> ShardGroup:
    """The initialized default process group as this rank's
    ``ShardGroup``, its device from ``rank_device(device, rank)``.

    Raises ``RuntimeError`` where no group is initialized: a sharded
    converge never makes a world of one behind the caller's back.
    ``n_devices``, where given, must be the group's size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized; start the ranks "
            "with protocol_tpu_torch.parallel.launch.run_ranks or init_process_group"
        )
    group = dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} shards, the process group has {size} ranks")
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    return ShardGroup(group, rank, size, rank_device(device, rank), backend)


def shard_count(mesh: ShardGroup) -> int:
    """Shards along ``SHARD_AXIS``: the group's ranks."""
    return mesh.size
