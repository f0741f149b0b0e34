"""Running-job occupancy set — wide (AoS) and compact (SoA) forms, batched
over clusters.

The port of ``multi_cluster_simulator_tpu/ops/runset.py``. A running job is
a row of a packed int32 table ``data[C, S, RF]`` (``RunningSet``) or of one
``[C, S]`` leaf per field in its storage dtype (``SoARunningSet``, with the
overflow counter ``ovf[C]``; core/compact.py), carrying its end time on
the virtual clock, with ``active[C, S]`` marking live slots; completion
returns the row's resources to ``node_free``. As in ops/queues.py, every
op computes in int32 and the compact layout stores back through
``fields.narrow_store``: checked where the reference's ``insert_row`` is
(the market's carve, ``start_many(..., checked=True)``), a plain cast
where it only moves stored values (the placements' ``start_many``,
release, kill). The reference's one-hot contractions become
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


class _Fields:
    """The int32 field views both layouts share."""

    @property
    def end_t(self):
        return field(self, "end_t")

    @property
    def node(self):
        return field(self, "node")

    @property
    def cores(self):
        return field(self, "cores")

    @property
    def mem(self):
        return field(self, "mem")

    @property
    def gpu(self):
        return field(self, "gpu")

    @property
    def id(self):
        return field(self, "id")

    @property
    def owner(self):
        return field(self, "owner")

    @property
    def dur(self):
        return field(self, "dur")

    @property
    def enq_t(self):
        return field(self, "enq_t")

    @property
    def retries(self):
        return field(self, "retries")

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.active.device


@dataclasses.dataclass
class RunningSet(_Fields, Tree):
    data: torch.Tensor  # [C, S, RF] int32
    active: torch.Tensor  # [C, S] bool


@dataclasses.dataclass
class SoARunningSet(_Fields, Tree):
    """The compact layout: one [C, S] leaf per field in its storage dtype,
    the active flags and the checked-narrow overflow counter."""

    f_end_t: torch.Tensor  # [C, S]
    f_node: torch.Tensor
    f_cores: torch.Tensor
    f_mem: torch.Tensor
    f_gpu: torch.Tensor
    f_id: torch.Tensor
    f_owner: torch.Tensor
    f_dur: torch.Tensor
    f_enq_t: torch.Tensor
    f_retries: torch.Tensor
    active: torch.Tensor  # [C, S] bool
    ovf: torch.Tensor  # [C] int32

    def leaf(self, name: str) -> torch.Tensor:
        return getattr(self, "f_" + name)


def field(rs, name: str) -> torch.Tensor:
    """[C, S] int32 values of one field, either layout."""
    if isinstance(rs, SoARunningSet):
        return F.widen(rs.leaf(name))
    return rs.data[..., F.RUN_INDEX[name]]


def rows_of(rs) -> torch.Tensor:
    """[C, S, RF] int32 packed rows of either layout."""
    if isinstance(rs, SoARunningSet):
        return torch.stack([F.widen(rs.leaf(n)) for n in F.RUN_FIELDS],
                           dim=-1)
    return rs.data


def _store_rows(rs, data: torch.Tensor, active: torch.Tensor, checked=None):
    """``rs`` holding the int32 rows ``data`` and ``active``; the compact
    layout narrows each column as ``queues._store_rows`` does."""
    if not isinstance(rs, SoARunningSet):
        return RunningSet(data=data, active=active)
    kw, ovf = {}, rs.ovf
    for i, n in enumerate(F.RUN_FIELDS):
        stored, bad = F.narrow_store(data[..., i], rs.leaf(n).dtype,
                                     do=checked, checked=checked is not None,
                                     dim=1)
        kw["f_" + n] = stored.contiguous()
        ovf = ovf + bad
    return rs.replace(active=active, ovf=ovf, **kw)


def empty(n_clusters: int, capacity: int, device) -> RunningSet:
    row = invalid_row(torch.device(device))
    return RunningSet(
        data=row.expand(n_clusters, capacity, RF).clone(),
        active=torch.zeros(n_clusters, capacity, dtype=torch.bool,
                           device=device))


def empty_soa(n_clusters: int, capacity: int, dtypes: dict,
              device) -> SoARunningSet:
    """A compact-layout empty set; ``dtypes`` maps each field to its
    storage dtype (``CompactPlan.run_dtypes()``)."""
    leaves = {"f_" + n: torch.full((n_clusters, capacity), F.RUN_INVALID[i],
                                   dtype=F.torch_dtype(dtypes[n]),
                                   device=device)
              for i, n in enumerate(F.RUN_FIELDS)}
    return SoARunningSet(
        active=torch.zeros(n_clusters, capacity, dtype=torch.bool,
                           device=device),
        ovf=torch.zeros(n_clusters, dtype=I32, device=device), **leaves)


def soa_to_wide(rs: SoARunningSet) -> RunningSet:
    """The wide layout of a compact set; ``ovf`` is dropped."""
    return RunningSet(data=rows_of(rs), active=rs.active)


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


def start_many(rs, rows: torch.Tensor, n_take: torch.Tensor,
               checked: bool = False):
    """Insert ``rows[c, :n_take[c]]`` ([C, M, RF]) into each cluster's
    lowest inactive slots, ascending — the slot layout a sequence of
    single starts produces. Callers guarantee ``n_take <= free slots``.
    The reference's [S, M] one-hot contraction, as a gather: the j-th
    inactive slot takes row j. The compact layout stores the placements'
    rows unchecked, as the reference's ``start_many`` does (their fields
    come from checked queue leaves and config-bounded node indices);
    ``checked`` is the reference's ``insert_row``, the market carve's
    store, counted on the slots written."""
    M = rows.shape[1]
    if M == 0:
        return rs
    inactive = ~rs.active
    free_rank = icumsum(inactive.to(I32), 1) - 1  # [C, S]
    written = inactive & (free_rank < n_take[:, None]) & (free_rank < M)
    idx = free_rank.clamp(0, M - 1).long()[..., None].expand(-1, -1, RF)
    packed = torch.gather(rows, 1, idx)
    data = torch.where(written[..., None], packed, rows_of(rs))
    return _store_rows(rs, data, rs.active | written,
                       checked=written if checked else None)


def gather_rows_along(rs, order: torch.Tensor) -> torch.Tensor:
    """[C, M, RF] rows selected along the slot axis by ``order`` [C, M]
    (the finished-foreign message pack, core/engine.py:_pack_returns)."""
    idx = order.long()[..., None].expand(-1, -1, RF)
    return torch.gather(rows_of(rs), 1, idx)


def release(rs, free: torch.Tensor, t: int):
    """Complete every job with ``end_t <= t``: return its resources to
    ``free`` [C, N, R] and clear its slot. Returns (rs', free', done)."""
    done = rs.active & (rs.end_t <= t)  # [C, S]
    n_nodes, n_res = free.shape[1], free.shape[2]
    node_idx = torch.clamp(rs.node, 0, n_nodes - 1)
    data = rows_of(rs)
    res = data[:, :, RCORES:RCORES + n_res]
    back = torch.where(done[..., None], res, 0)  # [C, S, R]
    hot = (node_idx[:, :, None]
           == torch.arange(n_nodes, dtype=I32, device=free.device))  # [C,S,N]
    free = free + isum(hot.to(I32)[..., None] * back[:, :, None, :], 1)
    data = torch.where(done[..., None], invalid_row(rs.device), data)
    return _store_rows(rs, data, rs.active & ~done), free, done


def next_end_t(rs) -> torch.Tensor:
    """[C] earliest completion time in each cluster's set (NEVER when
    empty), either layout: the event-compressed driver folds the minimum
    into its next-event time (core/engine.py ``_next_event_t``), since no
    release fires before the first tick whose clock reaches it."""
    return torch.where(rs.active, rs.end_t, NEVER).amin(dim=1)


def kill(rs, dead: torch.Tensor):
    """Clear the active slots where ``dead`` [C, S] is set WITHOUT
    returning their resources to the free tensor: the fault plane's
    removal half (faults/apply.py). A killed job's node has just lost its
    whole capacity to the failure, so there is nothing to return; repair
    restores ``free = cap`` on the empty node."""
    dead = rs.active & dead
    data = torch.where(dead[..., None], invalid_row(rs.device), rows_of(rs))
    return _store_rows(rs, data, rs.active & ~dead)
