"""Placement kernels: first-fit over the node axis, batched over clusters.

The port of ``multi_cluster_simulator_tpu/ops/placement.py`` (the parts the
FIFO and FFD paths run). The reference's placement is a linear first-fit
scan over nodes (ScheduleJob, pkg/scheduler/scheduler.go:127-139); here it
is a branch-free mask over the padded node axis. Node slots run physical
first, then virtual, so first-fit order matches Go's ``append`` of virtual
nodes. The FFD order (``best_fit_decreasing_order``) is a batched stable
lexsort.
"""

from __future__ import annotations

import torch

from multi_cluster_simulator_tpu_torch.core.spec import CORES, GPU, MEM
from multi_cluster_simulator_tpu_torch.ops.queues import I32, JobRec

NO_NODE = -1


def feasible(free: torch.Tensor, active: torch.Tensor, cores, mem,
             gpu) -> torch.Tensor:
    """[..., N] bool: ScheduleJob's ``>=`` feasibility (scheduler.go:131).

    ``free`` is [..., N, R], ``active`` [..., N] and the demands [...].
    With the gpu axis narrowed away (``R == 2``) a job that demands gpu
    fails closed."""
    ok = (free[..., CORES] >= cores[..., None]) \
        & (free[..., MEM] >= mem[..., None])
    if free.shape[-1] > GPU:
        ok = ok & (free[..., GPU] >= gpu[..., None])
    else:
        ok = ok & (gpu <= 0)[..., None]
    return ok & active


def first_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none) — what
    ``jnp.argmax`` gives on a bool mask. ``torch.argmax`` refuses bool, and
    also returns the first maximal index, so it runs on the int32 cast."""
    return torch.argmax(mask.to(I32), dim=-1).to(I32)


def first_fit(free: torch.Tensor, active: torch.Tensor,
              job: JobRec) -> torch.Tensor:
    """[...] lowest-index feasible node, or NO_NODE."""
    mask = feasible(free, active, job.cores, job.mem, job.gpu)
    return torch.where(mask.any(dim=-1), first_index(mask), NO_NODE)


def occupy(free: torch.Tensor, node: torch.Tensor, job: JobRec,
           do: torch.Tensor) -> torch.Tensor:
    """Subtract each cluster's job resources from ``free[c, node[c]]`` where
    ``do`` (RunJob's decrement half, cluster.go:144-148)."""
    res = job.res[..., : free.shape[-1]]  # [C, R]
    hot = (torch.arange(free.shape[1], dtype=I32, device=free.device)
           == node[:, None]) & do[:, None]  # [C, N]
    return free - hot.to(I32)[..., None] * res[:, None, :]


BIG = 2**31 - 1  # the sort key of an invalid slot: after every valid one


def lexsort(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((secondary, primary))`` along the last axis, batched:
    the stable order by ``primary``, ties broken by ``secondary``, then by
    position. Two stable sorts, the secondary key first. Returns int32."""
    by_sec = torch.sort(secondary, dim=-1, stable=True).indices
    by_pri = torch.sort(torch.gather(primary, -1, by_sec), dim=-1,
                        stable=True).indices
    return torch.gather(by_sec, -1, by_pri).to(I32)


def best_fit_decreasing_order(q_cores: torch.Tensor, q_mem: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """Slot processing order for the FFD policy: valid jobs by decreasing
    (cores, then mem), stable; invalid slots last. ``[C, Q]`` in,
    ``[C, Q]`` int32 slot indices out."""
    primary = torch.where(valid, -q_cores, BIG)
    secondary = torch.where(valid, -q_mem, BIG)
    return lexsort(secondary, primary)
