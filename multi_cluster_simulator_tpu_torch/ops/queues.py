"""Padded, mask-disciplined job queues — wide (AoS) and compact (SoA)
forms, batched over clusters.

The port of ``multi_cluster_simulator_tpu/ops/queues.py``. A queue is either

- ``JobQueue`` (wide): ONE packed int32 tensor ``data[C, Q, NF]`` plus
  ``count[C]``: cluster ``c``'s valid entries occupy rows ``[0, count[c])``
  in FIFO order, so "head" is row 0 and append writes row ``count``. Rows
  at or past ``count`` hold ``QUEUE_INVALID``;
- ``SoAJobQueue`` (compact): the same queue as one ``[C, Q]`` leaf per
  field (``f_<field>``, the reference's leaf names) in the storage dtypes
  of a ``CompactPlan`` (core/compact.py), plus the overflow counter
  ``ovf[C]``. Every op computes in int32 on widened rows and stores back
  through ``fields.narrow_store``: checked (clamped and counted into
  ``ovf``) where the reference checks — ``push_back``, ``push_many``,
  ``set_field``, ``set_field_elem`` — and a plain cast where it only
  permutes stored values (``compact``, the pops).

Every op below takes either layout; the two give the same rows
(tests/test_torch_compact.py). The JAX package writes each op for one
cluster and ``vmap``s it; torch has no ``vmap`` this code needs, so every
op here takes the cluster axis explicitly. The JAX ops express scatters
and gathers as integer one-hot contractions because scatters serialise on
the TPU; integer matmuls do not exist on CUDA, so these use
``where``/``gather`` and int32 broadcast-multiply-sum instead — a layout
choice, not semantics: the results are bit-identical
(tests/test_torch_ops.py).
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


class _Fields:
    """The int32 field views both layouts share (``q.cores`` is always int32
    compute values, whatever the storage width)."""

    @property
    def id(self):
        return field(self, "id")

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
    def dur(self):
        return field(self, "dur")

    @property
    def enq_t(self):
        return field(self, "enq_t")

    @property
    def owner(self):
        return field(self, "owner")

    @property
    def rec_wait(self):
        return field(self, "rec_wait")

    @property
    def jclass(self):
        return field(self, "jclass")

    @property
    def retries(self):
        return field(self, "retries")

    def slot_valid(self) -> torch.Tensor:
        """[C, Q] bool: which slots hold live jobs."""
        i = torch.arange(self.capacity, dtype=I32, device=self.device)
        return i[None, :] < self.count[:, None]


@dataclasses.dataclass
class JobQueue(_Fields, Tree):
    data: torch.Tensor  # [C, Q, NF] int32
    count: torch.Tensor  # [C] int32

    @property
    def capacity(self) -> int:
        return self.data.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.data.device


@dataclasses.dataclass
class SoAJobQueue(_Fields, Tree):
    """The compact layout: one [C, Q] leaf per field in its storage dtype,
    the count, and the checked-narrow overflow counter (a ``Drops``-style
    counter: parity and bench runs assert it stays zero)."""

    f_id: torch.Tensor  # [C, Q]
    f_cores: torch.Tensor
    f_mem: torch.Tensor
    f_gpu: torch.Tensor
    f_dur: torch.Tensor
    f_enq_t: torch.Tensor
    f_owner: torch.Tensor
    f_rec_wait: torch.Tensor
    f_jclass: torch.Tensor
    f_retries: torch.Tensor
    count: torch.Tensor  # [C] int32
    ovf: torch.Tensor  # [C] int32

    @property
    def capacity(self) -> int:
        return self.f_id.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.f_id.device

    def leaf(self, name: str) -> torch.Tensor:
        return getattr(self, "f_" + name)


def field(q, name: str) -> torch.Tensor:
    """[C, Q] int32 values of one field, either layout."""
    if isinstance(q, SoAJobQueue):
        return F.widen(q.leaf(name))
    return q.data[..., F.QUEUE_INDEX[name]]


def rows_of(q) -> torch.Tensor:
    """[C, Q, NF] int32 packed rows of either layout (the wide layout's
    own tensor; the compact one's leaves widened and stacked)."""
    if isinstance(q, SoAJobQueue):
        return torch.stack([F.widen(q.leaf(n)) for n in F.QUEUE_FIELDS],
                           dim=-1)
    return q.data


def _store_rows(q, data: torch.Tensor, count=None, checked=None):
    """``q`` holding the int32 rows ``data`` [C, Q, NF] (and ``count``).
    The compact layout narrows each column into its leaf: where
    ``checked`` ([C, Q] bool, the slots the op wrote) is given, through
    the checked store with the count masked to it — the slots it did not
    write hold stored values, which fit — else by a plain cast."""
    count = q.count if count is None else count
    if not isinstance(q, SoAJobQueue):
        return q.replace(data=data, count=count)
    kw, ovf = {}, q.ovf
    for i, n in enumerate(F.QUEUE_FIELDS):
        leaf = q.leaf(n)
        stored, bad = F.narrow_store(data[..., i], leaf.dtype, do=checked,
                                     checked=checked is not None, dim=1)
        kw["f_" + n] = stored.contiguous()
        ovf = ovf + bad
    return q.replace(count=count, ovf=ovf, **kw)


def empty(n_clusters: int, capacity: int, device) -> JobQueue:
    row = invalid_row(torch.device(device))
    return JobQueue(data=row.expand(n_clusters, capacity, NF).clone(),
                    count=torch.zeros(n_clusters, dtype=I32, device=device))


def empty_soa(n_clusters: int, capacity: int, dtypes: dict,
              device) -> SoAJobQueue:
    """A compact-layout empty queue; ``dtypes`` maps each field to its
    storage dtype (``CompactPlan.queue_dtypes()``)."""
    leaves = {"f_" + n: torch.full((n_clusters, capacity),
                                   F.QUEUE_INVALID[i],
                                   dtype=F.torch_dtype(dtypes[n]),
                                   device=device)
              for i, n in enumerate(F.QUEUE_FIELDS)}
    z = torch.zeros(n_clusters, dtype=I32, device=device)
    return SoAJobQueue(count=z, ovf=z.clone(), **leaves)


def soa_to_wide(q: SoAJobQueue) -> JobQueue:
    """The wide layout of a compact queue (widen + restack): the form
    compact-against-wide equality checks compare in. ``ovf`` is dropped;
    assert it separately."""
    return JobQueue(data=rows_of(q), count=q.count)


def _arange(n: int, q) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=q.device)


def head(q) -> JobRec:
    if isinstance(q, SoAJobQueue):
        return JobRec(vec=torch.stack(
            [F.widen(q.leaf(n)[:, 0]) for n in F.QUEUE_FIELDS], dim=-1))
    return JobRec(vec=q.data[:, 0])


def select_row(q, hot: torch.Tensor) -> JobRec:
    """The row whose one-hot mask is ``hot`` [C, Q] (a zero row where
    ``hot`` is all False) — the reference's one-hot contraction, as an
    int32 broadcast-multiply-sum."""
    return JobRec(vec=isum(hot.to(I32)[..., None] * rows_of(q), 1))


def rows_prefix(q, n: int) -> torch.Tensor:
    """The first ``n`` slots as packed [C, n, NF] int32 rows."""
    if isinstance(q, SoAJobQueue):
        return torch.stack([F.widen(q.leaf(f)[:, :n])
                            for f in F.QUEUE_FIELDS], dim=-1)
    return q.data[:, :n]


def gather_rows(q, sel: torch.Tensor) -> torch.Tensor:
    """Packed [C, K, NF] rows selected by a [C, K, Q] one-hot mask (a zero
    row where a mask row is all False) — the reference's ``[K, Q] @ [Q, NF]``
    integer contraction, as an int32 broadcast-multiply-sum."""
    return isum(sel.to(I32)[..., None] * rows_of(q)[:, None, :, :], 2)


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


def compact(q, keep: torch.Tensor):
    """Stable-remove every valid slot where ``keep`` [C, Q] is False (the
    Go in-place slice deletions, scheduler.go:319,165,184); slots from the
    new count on become INVALID. A permutation of stored values: the
    compact layout stores it unchecked, as the reference does."""
    keep = keep & q.slot_valid()
    data = compact_rows(rows_of(q), keep, invalid_row(q.device))
    return _store_rows(q, data, isum(keep, 1))


def remove_matching(q, job: JobRec,
                    match_fields=("id", "cores", "mem", "dur")):
    """Remove every valid slot equal to ``job`` [C, NF] on the given fields
    (the reference's whole-struct-equality dequeues, server.go:131-135);
    matching on (id, cores, mem, dur) is the reference's determinization:
    the Go structs' other fields survive the borrow round trip unchanged."""
    m = torch.ones(q.count.shape + (q.capacity,), dtype=torch.bool,
                   device=q.device)
    for f in match_fields:
        m = m & (field(q, f) == job.vec[..., F.QUEUE_INDEX[f]][..., None])
    return compact(q, ~m)


def set_field(q, name: str, values: torch.Tensor):
    """Overwrite one field column (e.g. rec_wait) for all slots; the
    compact layout's store is checked over every slot."""
    if isinstance(q, SoAJobQueue):
        stored, bad = F.narrow_store(values.to(I32), q.leaf(name).dtype,
                                     dim=1)
        return q.replace(ovf=q.ovf + bad, **{"f_" + name: stored})
    data = q.data.clone()
    data[..., F.QUEUE_INDEX[name]] = values.to(I32)
    return q.replace(data=data)


def set_field_elem(q, name: str, i: int, value: torch.Tensor):
    """Overwrite one field of slot ``i`` in every cluster with ``value``
    [C] (e.g. the head's rec_wait), checked in the compact layout."""
    if isinstance(q, SoAJobQueue):
        stored, bad = F.narrow_store(value.to(I32)[:, None],
                                     q.leaf(name).dtype, dim=1)
        leaf = q.leaf(name).clone()
        leaf[:, i] = stored[:, 0]
        return q.replace(ovf=q.ovf + bad, **{"f_" + name: leaf})
    data = q.data.clone()
    data[:, i, F.QUEUE_INDEX[name]] = value.to(I32)
    return q.replace(data=data)


def push_back(q, job: JobRec, do: torch.Tensor):
    """Append one job per cluster where ``do`` [C] (and capacity allows);
    the compact layout's store is checked where it happens."""
    ok = do & (q.count < q.capacity)
    hot = (_arange(q.capacity, q) == q.count[:, None]) & ok[:, None]
    data = torch.where(hot[..., None], job.vec[:, None, :], rows_of(q))
    return _store_rows(q, data, q.count + ok.to(I32), checked=hot)


def push_many(q, jobs: JobQueue, take: torch.Tensor):
    """Append the rows of ``jobs`` where ``take`` [C, K] is set, in order;
    overflowing rows are dropped. ``jobs.data`` is [C, K, NF], or [K, NF]
    when every cluster draws from one batch (the borrow path's lender
    push). The compact layout's store is checked on the slots written.

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
    data = torch.where(new[..., None], rows, rows_of(q))
    return _store_rows(q, data, q.count + added, checked=new)


def push_back_dropped(q, do: torch.Tensor) -> torch.Tensor:
    """[C] 0/1: whether push_back(q, ., do) would overflow."""
    return (do & (q.count >= q.capacity)).to(I32)


def push_many_dropped(q, take: torch.Tensor) -> torch.Tensor:
    """[C] how many of ``take`` push_many(q, ., take) would overflow."""
    n_take = isum(take, 1)
    return torch.clamp(n_take - (q.capacity - q.count), min=0)


def pop_front(q, do: torch.Tensor):
    """Drop the head job where ``do`` [C], shifting everything left."""
    count = torch.clamp(q.count - do.to(I32), min=0)
    data = rows_of(q)
    shifted = torch.cat(
        [data[:, 1:], invalid_row(q.device).expand(data.shape[0], 1, NF)],
        dim=1)
    return _store_rows(q, torch.where(do[:, None, None], shifted, data),
                       count)


def pop_front_n(q, n: torch.Tensor):
    """Drop the first ``n[c]`` jobs of each cluster. The reference rolls
    by a per-cluster shift; ``torch.roll`` takes one shift, so this is a
    gather from ``(i + n) % Q``."""
    n = torch.minimum(torch.clamp(n, min=0), q.count)
    newcount = q.count - n
    cap = q.capacity
    i = _arange(cap, q)
    live = i[None, :] < newcount[:, None]
    src = ((i[None, :] + n[:, None]) % cap).long()
    rolled = torch.gather(rows_of(q), 1, src[..., None].expand(-1, -1, NF))
    data = torch.where(live[..., None], rolled, invalid_row(q.device))
    return _store_rows(q, data, newcount)
