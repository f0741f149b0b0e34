"""Placement kernels: first-fit over the node axis, batched over clusters.

The port of ``multi_cluster_simulator_tpu/ops/placement.py`` (the parts the
FIFO, FFD, DELAY, scored and borrowing paths run). The reference's
placement is a linear first-fit scan over nodes (ScheduleJob,
pkg/scheduler/scheduler.go:127-139); here it is a branch-free mask over the
padded node axis. Node slots run physical first, then virtual, so
first-fit order matches Go's ``append`` of virtual nodes. The FFD order
(``best_fit_decreasing_order``) is a batched stable lexsort; the scored
pick (``best_scored_fit``) is an argmax over f32 node scores; the lender's
check (``can_lend``) is feasibility with Lend's strict inequalities,
reduced over the nodes.
"""

from __future__ import annotations

import torch

from multi_cluster_simulator_tpu_torch.core.spec import CORES, GPU, MEM
from multi_cluster_simulator_tpu_torch.ops.queues import I32, JobRec

NO_NODE = -1


def feasible(free: torch.Tensor, active: torch.Tensor, cores, mem,
             gpu, strict: bool = False) -> torch.Tensor:
    """[..., N] bool: ScheduleJob's ``>=`` feasibility (scheduler.go:131),
    or with ``strict`` Lend's ``>`` (scheduler.go:197) on cores and mem;
    the gpu axis is ``>=`` in both.

    ``free`` is [..., N, R], ``active`` [..., N] and the demands [...].
    With the gpu axis narrowed away (``R == 2``) a job that demands gpu
    fails closed."""
    if strict:
        ok = (free[..., CORES] > cores[..., None]) \
            & (free[..., MEM] > mem[..., None])
    else:
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


# The most elements can_lend's temporaries take at once (a block of nodes).
LEND_BLOCK = 1 << 24


def can_lend(free: torch.Tensor, active: torch.Tensor,
             job: JobRec) -> torch.Tensor:
    """[...] Lend() feasibility: any active node with strictly more free
    cores and mem than the job needs (and gpu >=; none demanded when the
    gpu axis is narrowed away). ``free`` is [..., N, R], ``active``
    [..., N], and the leading shapes broadcast against the job's: the
    borrow match asks it for every lender and borrower at once, [C, 1,
    N, R] against [C]. The node axis is reduced a block of nodes at a
    time, the block as wide as keeps each temporary under ``LEND_BLOCK``
    elements: the whole axis in one step for a few clusters, one node a
    step (C x C booleans, without a node axis) for thousands."""
    n_res, N = free.shape[-1], free.shape[-2]
    lead = torch.broadcast_shapes(active.shape[:-1], job.cores.shape)
    block = max(1, min(N, LEND_BLOCK // max(1, lead.numel())))
    # an inactive node's cores never exceed a demand
    planes = [torch.where(active, free[..., CORES],
                          torch.iinfo(free.dtype).min), free[..., MEM]]
    demands = [job.cores, job.mem]
    if n_res > GPU:
        planes.append(free[..., GPU])
        demands.append(job.gpu)
    if block > 1:
        demands = [d[..., None] for d in demands]
    ok = torch.zeros(lead, dtype=torch.bool, device=free.device)
    for n in range(0, N, block):
        node = (lambda x: x[..., n]) if block == 1 else \
            (lambda x: x[..., n:n + block])
        hit = node(planes[0]) > demands[0]
        hit &= node(planes[1]) > demands[1]
        if n_res > GPU:
            hit &= node(planes[2]) >= demands[2]
        ok |= hit if block == 1 else hit.any(dim=-1)
    if n_res <= GPU:
        ok &= job.gpu <= 0
    return ok


def best_scored_fit(free: torch.Tensor, active: torch.Tensor, job: JobRec,
                    scores: torch.Tensor) -> torch.Tensor:
    """[...] highest-scoring feasible node, or NO_NODE. ``scores`` [..., N]
    f32; infeasible nodes score ``-inf`` and the first maximum wins, so
    ties go to the lowest index (the reference's first-fit orientation)."""
    if scores.shape != active.shape:
        raise ValueError(f"best_scored_fit: scores of shape "
                         f"{tuple(scores.shape)}, nodes {tuple(active.shape)}")
    mask = feasible(free, active, job.cores, job.mem, job.gpu)
    sc = torch.where(mask, scores.to(torch.float32), -torch.inf)
    return torch.where(mask.any(dim=-1), torch.argmax(sc, dim=-1).to(I32),
                       NO_NODE)


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
