"""Running-job occupancy set — the wide layout, batched over clusters.

The port of ``multi_cluster_simulator_tpu/ops/runset.py`` (wide layout only;
the compact SoA form is ROADMAP A11). A running job is a row of a packed
int32 table ``data[C, S, RF]`` carrying its end time on the virtual clock,
with ``active[C, S]`` marking live slots; completion returns the row's
resources to ``node_free``. The reference's one-hot contractions
(release's scatter-add, start_many's slot assignment) become int32
broadcast-multiply-sums here — bit-identical, and runnable on CUDA, which
has no integer matmul.
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
    single starts produces. Callers guarantee ``n_take <= free slots``."""
    inactive = ~rs.active
    free_rank = icumsum(inactive.to(I32), 1) - 1  # [C, S]
    M = rows.shape[1]
    j = torch.arange(M, dtype=I32, device=rows.device)
    hot = ((free_rank[:, :, None] == j[None, None, :])
           & inactive[:, :, None]
           & (j[None, None, :] < n_take[:, None, None]))  # [C, S, M]
    written = hot.any(dim=2)
    packed = isum(hot.to(I32)[..., None] * rows[:, None, :, :], 2)
    data = torch.where(written[..., None], packed, rs.data)
    return RunningSet(data=data, active=rs.active | written)


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
