"""The mesh of the cluster axis (the port of
``multi_cluster_simulator_tpu/parallel/mesh.py``).

One mesh axis ("clusters"): the simulator's scale axis is clusters, the
analogue of the reference running one scheduler process per cluster
(cmd/scheduler). In the port a mesh is a ``torch.distributed`` process
group: one rank is one process holding one shard of the cluster axis on
its device, and the per-tick borrow/trade decisions ride the group's
collectives (``parallel/exchange.py MeshExchange``).

Rank ``r`` runs on ``cuda:(r % device_count)``, so on a machine with one
H100 every rank shares that card. As every entry point of the port, a mesh
runs on the card unless the caller names a device: without a card it
raises, and ``device="cpu"`` puts every rank on the CPU. The group is gloo:
NCCL will not put two ranks on one device, and gloo runs on the CPU too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

# subgroups of the first n ranks, made once per process (dist.new_group is
# a collective over the whole world: every rank must call it alike)
_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: this process's rank on it, the rank count, the
    axis name, the rank's device and its process group (None for a mesh
    of one process). ``member`` is False on a world rank outside a mesh
    over fewer ranks than the world holds."""

    rank: int
    size: int
    axis: str
    device: torch.device
    group: object = None
    member: bool = True

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def rank_device(rank: int, device=None) -> torch.device:
    """The device rank ``rank`` runs on: ``device`` where the caller names
    one, else ``cuda:(rank % device_count)``; raises when no card is
    present and no device is named (``core.state.resolve_device``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "mesh's ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, axis: str = "clusters",
              device=None) -> Mesh:
    """A mesh over the first ``n_devices`` ranks of the process group (all
    of them by default). Without an initialised group only a mesh of one
    process exists. A mesh over fewer ranks than the world makes its
    subgroup collectively: every rank of the world calls ``make_mesh``
    with the same count, and the ranks outside it get ``member=False``."""
    if not dist.is_available() or not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"need {n_devices} ranks, have 1 (no torch.distributed "
                "process group: parallel.multihost.global_mesh forms one)")
        return Mesh(0, 1, axis, rank_device(0, device))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    if n == world:
        group = dist.group.WORLD
    else:
        if n not in _GROUPS:
            _GROUPS[n] = dist.new_group(list(range(n)))
        group = _GROUPS[n]
    return Mesh(rank if rank < n else -1, n, axis, rank_device(rank, device),
                group, rank < n)


def nearest_divisible(c: int, n: int) -> tuple[int, int]:
    """The two cluster counts bracketing ``c`` that divide evenly over an
    ``n``-way mesh: ``(floor, ceil)`` multiples of ``n`` (floor can be 0).
    Shared by ShardedEngine.shard_inputs' failure message and the
    weak-scaling driver's sentinel auto-pad (tools/weak_scaling.py pads up
    to the ceil count)."""
    lo = (c // n) * n
    hi = lo if lo == c else lo + n
    return lo, hi
