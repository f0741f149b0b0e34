"""Padded, mask-disciplined job queues — the wide layout, batched over clusters.

The port of ``multi_cluster_simulator_tpu/ops/queues.py`` (wide layout only;
the compact SoA layout is ROADMAP A11). A queue is ONE packed int32 tensor
``data[C, Q, NF]`` plus ``count[C]``: cluster ``c``'s valid entries occupy
rows ``[0, count[c])`` in FIFO order, so "head" is row 0 and append writes
row ``count``. Rows at or past ``count`` hold ``QUEUE_INVALID``.

The JAX package writes each op for one cluster and ``vmap``s it; torch has
no ``vmap`` this code needs, so every op here takes the cluster axis
explicitly. The JAX ops express scatters and gathers as integer one-hot
contractions because scatters serialise on the TPU; integer matmuls do not
exist on CUDA, so these use ``where``/``gather`` and int32
broadcast-multiply-sum instead — a layout choice, not semantics: the
results are bit-identical (tests/test_torch_ops.py).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.utils.tree import Tree

I32 = torch.int32
OWN = -1  # owner value for "my own job" (Ownership == "")

NF = len(F.QUEUE_FIELDS)
(FID, FCORES, FMEM, FGPU, FDUR, FENQ, FOWNER, FREC, FJCLASS, FRETRIES) = (
    F.QUEUE_INDEX[n]
    for n in ("id", "cores", "mem", "gpu", "dur", "enq_t", "owner",
              "rec_wait", "jclass", "retries"))


@functools.cache
def invalid_row(device: torch.device) -> torch.Tensor:
    """The [NF] int32 invalid queue row on ``device`` (made once per
    device: building it from a Python list on every call would be a
    host-to-device copy inside the tick)."""
    return torch.tensor(F.QUEUE_INVALID, dtype=I32, device=device)


def isum(x: torch.Tensor, dim) -> torch.Tensor:
    """Sum as int32 — ``torch.sum`` of int32 or bool returns int64, the
    JAX reference stays int32."""
    return x.sum(dim=dim, dtype=I32)


def icumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum as int32 (``torch.cumsum`` of ints returns int64)."""
    return torch.cumsum(x, dim=dim, dtype=I32)


@dataclasses.dataclass
class JobRec(Tree):
    """Jobs as packed [..., NF] int32 rows (one per cluster when batched)."""

    vec: torch.Tensor

    @property
    def id(self):
        return self.vec[..., FID]

    @property
    def cores(self):
        return self.vec[..., FCORES]

    @property
    def mem(self):
        return self.vec[..., FMEM]

    @property
    def gpu(self):
        return self.vec[..., FGPU]

    @property
    def dur(self):
        return self.vec[..., FDUR]

    @property
    def enq_t(self):
        return self.vec[..., FENQ]

    @property
    def owner(self):
        return self.vec[..., FOWNER]

    @property
    def rec_wait(self):
        return self.vec[..., FREC]

    @property
    def jclass(self):
        return self.vec[..., FJCLASS]

    @property
    def retries(self):
        return self.vec[..., FRETRIES]

    @property
    def res(self):
        """[..., RES] (cores, mem, gpu) — matches the node free/cap layout."""
        return self.vec[..., FCORES:FGPU + 1]


@dataclasses.dataclass
class JobQueue(Tree):
    data: torch.Tensor  # [C, Q, NF] int32
    count: torch.Tensor  # [C] int32

    @property
    def capacity(self) -> int:
        return self.data.shape[-2]

    @property
    def cores(self):
        return self.data[..., FCORES]

    @property
    def mem(self):
        return self.data[..., FMEM]

    @property
    def enq_t(self):
        return self.data[..., FENQ]

    @property
    def rec_wait(self):
        return self.data[..., FREC]

    def slot_valid(self) -> torch.Tensor:
        """[C, Q] bool: which slots hold live jobs."""
        return _arange(self.capacity, self)[None, :] < self.count[:, None]


def empty(n_clusters: int, capacity: int, device) -> JobQueue:
    row = invalid_row(torch.device(device))
    return JobQueue(data=row.expand(n_clusters, capacity, NF).clone(),
                    count=torch.zeros(n_clusters, dtype=I32, device=device))


def _arange(n: int, q: JobQueue) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=q.data.device)


def head(q: JobQueue) -> JobRec:
    return JobRec(vec=q.data[:, 0])


def select_row(q: JobQueue, hot: torch.Tensor) -> JobRec:
    """The row whose one-hot mask is ``hot`` [C, Q] (a zero row where
    ``hot`` is all False) — the reference's one-hot contraction, as an
    int32 broadcast-multiply-sum."""
    return JobRec(vec=isum(hot.to(I32)[..., None] * q.data, 1))


def rows_prefix(q: JobQueue, n: int) -> torch.Tensor:
    """The first ``n`` slots as packed [C, n, NF] int32 rows."""
    return q.data[:, :n]


def gather_rows(q: JobQueue, sel: torch.Tensor) -> torch.Tensor:
    """Packed [C, K, NF] rows selected by a [C, K, Q] one-hot mask (a zero
    row where a mask row is all False) — the reference's ``[K, Q] @ [Q, NF]``
    integer contraction, as an int32 broadcast-multiply-sum."""
    return isum(sel.to(I32)[..., None] * q.data[:, None, :, :], 2)


def compact_rows(rows: torch.Tensor, keep: torch.Tensor,
                 fill: torch.Tensor) -> torch.Tensor:
    """Move the rows of ``rows`` [C, K, F] where ``keep`` [C, K] to the
    front, in order, with ``fill`` [F] behind them. A stable sort of the
    keep mask and a gather: the reference's rank one-hot contraction and
    its argsort form give the same rows, and this one needs no [K, K]
    operand (Level0 runs to K = 768)."""
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    packed = torch.gather(rows, 1, order[..., None].expand(-1, -1,
                                                           rows.shape[2]))
    live = (torch.arange(keep.shape[1], device=rows.device)[None, :]
            < keep.sum(dim=1)[:, None])
    return torch.where(live[..., None], packed, fill)


def compact(q: JobQueue, keep: torch.Tensor) -> JobQueue:
    """Stable-remove every valid slot where ``keep`` [C, Q] is False (the
    Go in-place slice deletions, scheduler.go:319,165,184); slots from the
    new count on become INVALID."""
    keep = keep & q.slot_valid()
    data = compact_rows(q.data, keep, invalid_row(q.data.device))
    return q.replace(data=data, count=isum(keep, 1))


def set_field(q: JobQueue, name: str, values: torch.Tensor) -> JobQueue:
    """Overwrite one field column (e.g. rec_wait) for all slots (wide
    layout)."""
    data = q.data.clone()
    data[..., F.QUEUE_INDEX[name]] = values.to(I32)
    return q.replace(data=data)


def set_field_elem(q: JobQueue, name: str, i: int,
                   value: torch.Tensor) -> JobQueue:
    """Overwrite one field of slot ``i`` in every cluster with ``value``
    [C] (e.g. the head's rec_wait; wide layout)."""
    data = q.data.clone()
    data[:, i, F.QUEUE_INDEX[name]] = value.to(I32)
    return q.replace(data=data)


def push_back(q: JobQueue, job: JobRec, do: torch.Tensor) -> JobQueue:
    """Append one job per cluster where ``do`` [C] (and capacity allows)."""
    ok = do & (q.count < q.capacity)
    hot = (_arange(q.capacity, q) == q.count[:, None]) & ok[:, None]
    data = torch.where(hot[..., None], job.vec[:, None, :], q.data)
    return q.replace(data=data, count=q.count + ok.to(I32))


def push_many(q: JobQueue, jobs: JobQueue, take: torch.Tensor) -> JobQueue:
    """Append the rows of ``jobs`` where ``take`` [C, K] is set, in order;
    overflowing rows are dropped. ``jobs.data`` is [C, K, NF], or [K, NF]
    when every cluster draws from one batch (the borrow path's lender
    push).

    Slot ``count + r`` gets the r-th taken row — the reference's stable
    argsort of ``~take`` and scatter — found by a search of each slot's
    rank in the running count of ``take``: [C, Q] work and no [C, Q, K]
    operand (the lender push has K = C = 4,096 and Q = 1,024). A prefix
    ``take`` (time-sorted arrival ingest) is the case where the r-th taken
    row is row r."""
    n_take = isum(take, 1)
    added = torch.minimum(n_take, q.capacity - q.count)
    src = jobs.data
    K = take.shape[1]
    csum = icumsum(take.to(I32), 1)  # [C, K] taken rows up to k
    rank = _arange(q.capacity, q)[None, :] - q.count[:, None]  # [C, Q]
    new = (rank >= 0) & (rank < n_take[:, None])
    # the first k whose running count reaches rank + 1: the rank-th taken
    k = torch.searchsorted(csum, (rank + 1).clamp(min=1)).clamp(max=K - 1)
    if src.dim() == 2:
        rows = src[k]
    else:
        rows = torch.gather(src, 1, k[..., None].expand(-1, -1, NF))
    data = torch.where(new[..., None], rows, q.data)
    return q.replace(data=data, count=q.count + added)


def push_back_dropped(q: JobQueue, do: torch.Tensor) -> torch.Tensor:
    """[C] 0/1: whether push_back(q, ., do) would overflow."""
    return (do & (q.count >= q.capacity)).to(I32)


def push_many_dropped(q: JobQueue, take: torch.Tensor) -> torch.Tensor:
    """[C] how many of ``take`` push_many(q, ., take) would overflow."""
    n_take = isum(take, 1)
    return torch.clamp(n_take - (q.capacity - q.count), min=0)


def pop_front(q: JobQueue, do: torch.Tensor) -> JobQueue:
    """Drop the head job where ``do`` [C], shifting everything left."""
    count = torch.clamp(q.count - do.to(I32), min=0)
    shifted = torch.cat(
        [q.data[:, 1:],
         invalid_row(q.data.device).expand(q.data.shape[0], 1, NF)], dim=1)
    data = torch.where(do[:, None, None], shifted, q.data)
    return q.replace(data=data, count=count)


def pop_front_n(q: JobQueue, n: torch.Tensor) -> JobQueue:
    """Drop the first ``n[c]`` jobs of each cluster. The reference rolls
    by a per-cluster shift; ``torch.roll`` takes one shift, so this is a
    gather from ``(i + n) % Q``."""
    n = torch.minimum(torch.clamp(n, min=0), q.count)
    newcount = q.count - n
    cap = q.capacity
    i = _arange(cap, q)
    live = i[None, :] < newcount[:, None]
    src = ((i[None, :] + n[:, None]) % cap).long()
    rolled = torch.gather(q.data, 1, src[..., None].expand(-1, -1, NF))
    data = torch.where(live[..., None], rolled, invalid_row(q.data.device))
    return q.replace(data=data, count=newcount)
