"""Running-job occupancy set — the wide layout, batched over clusters.

The port of ``multi_cluster_simulator_tpu/ops/runset.py`` (wide layout only;
the compact SoA form is ROADMAP A11). A running job is a row of a packed
int32 table ``data[C, S, RF]`` carrying its end time on the virtual clock,
with ``active[C, S]`` marking live slots; completion returns the row's
resources to ``node_free``. The reference's one-hot contractions become
an int32 broadcast-multiply-sum (release's scatter-add) and gathers
(start_many's slot assignment, the return pack) here — bit-identical, and
runnable on CUDA, which has no integer matmul.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops.queues import (
    I32, JobRec, icumsum, isum,
)
from multi_cluster_simulator_tpu_torch.utils.tree import Tree

NEVER = F.NEVER_I

RF = len(F.RUN_FIELDS)
REND, RNODE, RCORES, RMEM, RGPU, RID, ROWNER, RDUR, RENQ, RRETRIES = (
    F.RUN_INDEX[n] for n in F.RUN_FIELDS)


@functools.cache
def invalid_row(device: torch.device) -> torch.Tensor:
    """The [RF] int32 invalid running-set row on ``device``."""
    return torch.tensor(F.RUN_INVALID, dtype=I32, device=device)


@dataclasses.dataclass
class RunningSet(Tree):
    data: torch.Tensor  # [C, S, RF] int32
    active: torch.Tensor  # [C, S] bool

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def end_t(self):
        return self.data[..., REND]

    @property
    def node(self):
        return self.data[..., RNODE]

    @property
    def cores(self):
        return self.data[..., RCORES]

    @property
    def mem(self):
        return self.data[..., RMEM]

    @property
    def gpu(self):
        return self.data[..., RGPU]


def empty(n_clusters: int, capacity: int, device) -> RunningSet:
    row = invalid_row(torch.device(device))
    return RunningSet(
        data=row.expand(n_clusters, capacity, RF).clone(),
        active=torch.zeros(n_clusters, capacity, dtype=torch.bool,
                           device=device))


def make_row(end_t, node, cores, mem, gpu, id, owner, dur, enq_t,
             retries) -> torch.Tensor:
    """Stack [...]-shaped int32 fields into [..., RF] rows."""
    return torch.stack([end_t, node, cores, mem, gpu, id, owner, dur,
                        enq_t, retries], dim=-1).to(I32)


def row_from_job(job: JobRec, node: torch.Tensor, t: int) -> torch.Tensor:
    """The running row of ``job`` placed on ``node`` at clock ``t``
    (end = t + dur, in int32 like the reference)."""
    return make_row(job.dur + t, node, job.cores, job.mem, job.gpu, job.id,
                    job.owner, job.dur, job.enq_t, job.retries)


def start_many(rs: RunningSet, rows: torch.Tensor,
               n_take: torch.Tensor) -> RunningSet:
    """Insert ``rows[c, :n_take[c]]`` ([C, M, RF]) into each cluster's
    lowest inactive slots, ascending — the slot layout a sequence of
    single starts produces. Callers guarantee ``n_take <= free slots``.
    The reference's [S, M] one-hot contraction, as a gather: the j-th
    inactive slot takes row j."""
    M = rows.shape[1]
    if M == 0:
        return rs
    inactive = ~rs.active
    free_rank = icumsum(inactive.to(I32), 1) - 1  # [C, S]
    written = inactive & (free_rank < n_take[:, None]) & (free_rank < M)
    idx = free_rank.clamp(0, M - 1).long()[..., None].expand(-1, -1, RF)
    packed = torch.gather(rows, 1, idx)
    data = torch.where(written[..., None], packed, rs.data)
    return RunningSet(data=data, active=rs.active | written)


def gather_rows_along(rs: RunningSet, order: torch.Tensor) -> torch.Tensor:
    """[C, M, RF] rows selected along the slot axis by ``order`` [C, M]
    (the finished-foreign message pack, core/engine.py:_pack_returns)."""
    idx = order.long()[..., None].expand(-1, -1, RF)
    return torch.gather(rs.data, 1, idx)


def release(rs: RunningSet, free: torch.Tensor, t: int):
    """Complete every job with ``end_t <= t``: return its resources to
    ``free`` [C, N, R] and clear its slot. Returns (rs', free', done)."""
    done = rs.active & (rs.end_t <= t)  # [C, S]
    n_nodes, n_res = free.shape[1], free.shape[2]
    node_idx = torch.clamp(rs.node, 0, n_nodes - 1)
    res = rs.data[:, :, RCORES:RCORES + n_res]
    back = torch.where(done[..., None], res, 0)  # [C, S, R]
    hot = (node_idx[:, :, None]
           == torch.arange(n_nodes, dtype=I32, device=free.device))  # [C,S,N]
    free = free + isum(hot.to(I32)[..., None] * back[:, :, None, :], 1)
    data = torch.where(done[..., None], invalid_row(rs.data.device), rs.data)
    return RunningSet(data=data, active=rs.active & ~done), free, done


def kill(rs: RunningSet, dead: torch.Tensor) -> RunningSet:
    """Clear the active slots where ``dead`` [C, S] is set WITHOUT
    returning their resources to the free tensor: the fault plane's
    removal half (faults/apply.py). A killed job's node has just lost its
    whole capacity to the failure, so there is nothing to return; repair
    restores ``free = cap`` on the empty node."""
    dead = rs.active & dead
    data = torch.where(dead[..., None], invalid_row(rs.data.device), rs.data)
    return RunningSet(data=data, active=rs.active & ~dead)
