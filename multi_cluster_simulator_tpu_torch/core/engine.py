"""The virtual-time simulation engine (the port of
``multi_cluster_simulator_tpu/core/engine.py``: the FIFO, FFD, DELAY and
scored-zoo slices, cross-cluster borrowing, the trader market, the fault
plane and the device metrics plane).

One tick is the reference's tick on the paths the port carries: the
per-cluster prefix ``faults -> release (with the return pack) -> vnode
expiry -> ingest -> schedule`` (the fault phase where ``cfg.faults``
engages it), then, with ``cfg.borrowing``, the cross-cluster
phases — return delivery and borrow matching — then, with the trader, the
snapshot on the 5 s stream cadence and the market round on the monitor
cadence (market/trader.py), and the clock advance. The schedule
slot runs the member of the engine's ``PolicySet`` that ``params.idx``
selects (FIFO, whose arrivals go to the ReadyQueue; or DELAY, FFD, gavel,
tesserae or rl, whose arrivals go to Level0); the index is read once at a
run's entry. The prefix runs as one hand-written CUDA kernel per span on
the card and as the plain PyTorch ops on the CPU (kernels/fused_tick.py);
the cross-cluster phases and the market are PyTorch ops on both, as the
reference runs them as XLA ops outside its kernel. The two market cadences
are host branches on the host's clock: a tick off them launches nothing.
Without borrowing and the trader the prefix is the whole tick (it is
terminal).

Arrivals come in two forms, as in the reference: pre-bucketed
``TickArrivals`` (each tick its own rows) or a windowed ``Arrivals``
stream, packed once per run and copied to the device once, from which
each tick ingests the due rows at its arrival cursor, at most
``max_ingest_per_tick`` of them (``drops.ingest`` counts the rest).

The metrics plane (obs/device.py) rides any run given a ``MetricsBuffer``
(``mbuf``): on a terminal prefix the tap is the kernel's epilogue,
otherwise it runs as PyTorch ops after the tick. ``record_metrics``
stacks a ``MetricSample`` per tick.

The run loops replace the reference's ``lax.scan``: ``run`` loops over the
ticks of a ``TickArrivals`` bucket or an ``Arrivals`` stream,
``run_chunks`` does what ``bench._engine_run`` does for the headline and
the Borg-like replay — a list of ragged-K chunks, each chunk's rows copied
to the device once, the clock kept on the host, and no host
synchronisation inside a chunk — and ``run_io`` is the serving tier's
dispatch unit: one staged chunk, with every tick's ``TickIO`` stacked.
``run_compressed`` is the event-compressed driver over one staged chunk:
it executes a tick only where something can happen and leaps the clock
over the quiescent ticks between, bitwise the dense run (one small
device-to-host read per executed tick without arrivals decides each
leap). ``run_prefix`` is the profile plane's ablation driver: ``run`` with
the tick truncated after its first ``phase_limit`` phases
(obs.profile.TICK_PHASES order).

A lane-stacked state (every leaf with a leading lane axis [L], the clock
``t`` [L]; ``lanes_of``) runs L independent constellations — tenants,
envs — in lockstep through ``run``, ``run_chunks``, ``run_io`` and
``step_tick``, with batched params (``params.idx`` [L] selecting each
lane's member; leaves of one member's shape serve every lane): the prefix
is one launch a kernel source over all L C clusters, each lane reading
its own parameters (``fused_tick.fused_prefix_lanes``), and the phases
after it run per lane on the lane's [C] views, so nothing crosses lanes.
``run_compressed`` drives a lane-stacked state lane by lane, each lane
leaping its own gaps.

Configurations outside the slice raise ``NotImplementedError`` naming the
ROADMAP item that ports them; nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import MatchKind, SimConfig
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.compact import ovf_per_cluster
from multi_cluster_simulator_tpu_torch.core.state import (
    Arrivals, SimState, TickIO, empty_io, resolve_device,
)
from multi_cluster_simulator_tpu_torch.faults import apply as faults_apply
from multi_cluster_simulator_tpu_torch.kernels import fused_tick
from multi_cluster_simulator_tpu_torch.market import trader as market
from multi_cluster_simulator_tpu_torch.obs import device as obs_device
from multi_cluster_simulator_tpu_torch.obs.profile import (
    annotate_dispatch, phase_scope,
)
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops import placement as P
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.ops.queues import I32, isum
from multi_cluster_simulator_tpu_torch.parallel.exchange import LocalExchange
from multi_cluster_simulator_tpu_torch.policies.base import (
    PolicyParams, PolicySet, _zero_io, params_digest,
)
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

_QUEUE_INVALID = np.asarray(F.QUEUE_INVALID, np.int32)


# --------------------------------------------------------------------------
# time compression: quiescence predicate, next-event probe, leap accrual
# (the event-compressed driver, Engine.run_compressed)
# --------------------------------------------------------------------------

def _quiescence_sig(state: SimState) -> torch.Tensor:
    """Fixed-point fingerprint for the leap driver, the reference's int32
    vector of sums: it changes whenever a tick changes anything the NEXT
    tick's decisions read. Queue membership, placements, completions,
    arrivals, node activations, every drop counter with the compact
    layout's overflow counters (``ovf_per_cluster``) and the fault plane's
    terms (``faults.apply.sig_parts``) are covered; the clock, the wait
    accounting (``wait_total``, the queues' ``rec_wait``) and the trader's
    snapshot, cooldown and lock columns are not: they evolve in closed
    form over a leap or are read only on cadence boundaries the driver
    never skips (``next_cadence_t``). The per-cluster counters are summed
    in one reduction over a stack, so the vector costs a few launches; a
    new tensor, which a later in-place tick leaves as it was."""
    d = state.drops
    sums = isum(torch.stack([
        state.placed_total, state.arr_ptr, state.l0.count, state.l1.count,
        state.ready.count, state.wait.count, state.lent.count,
        state.borrowed.count, d.queue, d.msgs, d.run_full, d.vslot, d.carve,
        d.ingest, d.failed, ovf_per_cluster(state)]), 1)
    return torch.stack([
        sums[0], sums[1], isum(state.run.active, None), *sums[2:8],
        isum(state.node_active, None), isum(sums[8:], 0),
        *faults_apply.sig_parts(state)])


def _next_event_t(state: SimState, t: int, cfg: SimConfig, params,
                  member) -> torch.Tensor:
    """Earliest future virtual time (0-d int32 on the state's device) at
    which a quiescent constellation can change again: the first
    completion (``R.next_end_t``); for a DELAY member the head's Level0 ->
    Level1 promotion at ``enq_t + params.max_wait_ms``; with the trader
    the next market cadence boundary (``next_cadence_t`` of the host
    clock ``t``) and, with expiry, the first virtual-node expiry; with the
    fault plane the next failure or repair. The next non-empty arrival
    tick is the driver's (from the host counts). Raw event times: the
    driver rounds them up to the tick grid."""
    ev = R.next_end_t(state.run).min()
    if member.kind == "delay":
        promote = torch.where(
            state.l0.count > 0,
            state.l0.enq_t[:, 0] + params.max_wait_ms.to(I32), R.NEVER)
        ev = torch.minimum(ev, promote.min())
    if cfg.trader.enabled:
        ev = torch.clamp(ev, max=market.next_cadence_t(t, cfg.trader))
        if cfg.trader.expire_virtual_nodes:
            ev = torch.minimum(ev, torch.where(
                state.node_active, state.node_expire, R.NEVER).min())
    if cfg.faults.enabled:
        ev = torch.minimum(ev, faults_apply.next_fault_event_t(state.faults))
    return ev


def _leap_local(s: SimState, new_t: int, cfg: SimConfig, pset: PolicySet,
                params, member):
    """Advance every cluster's wait accounting to the clock ``new_t`` (a
    host int) in closed form: the per-tick wait records of a quiescent gap
    (TotalTime -= map[id]; map[id] = since(enqueue); TotalTime += map[id],
    scheduler.go:309-312) telescope to ``new_cur - old_rec`` per processed
    slot. Returns ``(state', rate)``, ``rate`` [C] f32 the per-tick
    accrual (processed slots x tick_ms) the series reconstruction uses.

    The driver calls it only after a tick the quiescence vote passed:
    after a busy tick the masks, computed from the post-tick state, can
    cover slots the pass did not process (a successor rotated into the
    Level0 head), whose stale ``rec_wait`` would accrue what the dense
    driver records a tick later. The closed form adds the telescoped sum
    once where the dense pass adds one f32 per tick; both are exact, so
    bitwise equal, while the accrued values are integer-valued f32 below
    2^24 ms (PARITY.md §time compression). Which slots accrue is the
    member's kernel family's (``PolicySet.leap_masks``)."""
    l0_mask, l1_mask = pset.leap_masks(s, cfg, params, member)

    def accrue(q, mask, total):
        cur = new_t - q.enq_t
        frec = q.rec_wait
        delta = torch.where(mask, (cur - frec).to(torch.float32), 0.0)
        q = Q.set_field(q, "rec_wait", torch.where(mask, cur, frec))
        return q, total + delta.sum(dim=1)

    # dense tick order: the Level1 sweep records before the Level0 head
    l1, total = accrue(s.l1, l1_mask, s.wait_total)
    l0, total = accrue(s.l0, l0_mask, total)
    rate = (isum(l0_mask, 1) + isum(l1_mask, 1)).to(torch.float32) \
        * cfg.tick_ms
    return s.replace(l0=l0, l1=l1, wait_total=total), rate


def _next_arrival_ticks(counts: np.ndarray) -> np.ndarray:
    """[T + 1] host int64: entry i is the first tick index >= i with
    arrivals on any cluster (T where none), one reverse cumulative
    minimum over the chunk's counts [T, C]."""
    T = counts.shape[0]
    idx = np.where(np.asarray(counts).any(axis=1), np.arange(T), T)
    out = np.full(T + 1, T, np.int64)
    if T:
        out[:T] = np.minimum.accumulate(idx[::-1])[::-1]
    return out


# --------------------------------------------------------------------------
# phase 1: completions and lent returns
# --------------------------------------------------------------------------

def _release_local(s: SimState, t: int):
    run, free, done = R.release(s.run, s.node_free, t)
    return s.replace(run=run, node_free=free), done


def _expire_vnodes_local(s: SimState, t: int) -> SimState:
    """Virtual nodes whose contract ended (``node_expire <= t``) go
    inactive, with zero capacity and free, and never expire again (the
    trader's ``expire_virtual_nodes``; the reference keeps them forever,
    cluster.go:65-85). Jobs still running on one keep their rows, and
    their completion returns resources to the inactive slot."""
    expired = s.node_active & (s.node_expire <= t)  # [C, N]
    return s.replace(
        node_active=s.node_active & ~expired,
        node_cap=torch.where(expired[..., None], 0, s.node_cap),
        node_free=torch.where(expired[..., None], 0, s.node_free),
        node_expire=torch.where(expired, R.NEVER, s.node_expire))


def _pack_returns(run: R.RunningSet, done: torch.Tensor, M: int):
    """First M finished-foreign-job slots per cluster as packed rows.

    ``run`` is the running set *before* release cleared the completed
    slots. Returns (rows [C, M', RF], take [C, M'], dropped [C]) with
    M' = min(M, S): the outbound JobFinished -> ReturnToBorrower messages
    (scheduler.go:158-191). The order is the reference's stable argsort of
    ``~is_ret``: the returning slots in slot order, then the others, so
    rows past the returns are the pre-release rows of the first
    non-returning slots. owner >= 0 is a borrower index; FOREIGN (-2)
    trader placeholders are returned to nobody (Go posts to the literal
    URL "Foreign" and gives up). ``dropped`` counts returns beyond M."""
    is_ret = done & (run.owner >= 0)  # [C, S]
    order = torch.sort((~is_ret).to(torch.uint8), dim=1,
                       stable=True).indices[:, :M]
    take = torch.gather(is_ret, 1, order)
    rows = R.gather_rows_along(run, order)
    return rows, take, isum(is_ret, 1) - isum(take, 1)


_MATCH = ((R.RID, "id"), (R.RCORES, "cores"), (R.RMEM, "mem"),
          (R.RDUR, "dur"))


def _deliver_returns(state: SimState, rows: torch.Tensor,
                     take: torch.Tensor, ex) -> SimState:
    """Cross-cluster half of JobFinished: finished foreign jobs (owner >=
    0) are posted back to their borrower, which removes every row equal
    to one on (id, cores, mem, dur) from its BorrowedQueue
    (server.go:115-137, 260-290). ``rows``/``take`` come from
    ``_pack_returns``.

    The reference compares every message with every cluster's queue
    ([C, C*M, Q], 34 G elements at 4,096 clusters). Here each of the C*M
    message slots is compared only with the queue of its destination
    ([C*M, Q]), the hits are OR-ed into [C, Q] by a scatter-add, and one
    stable compaction removes them. The removed set is the union of the
    messages' matches, so the order of the messages does not matter.
    Slots that carry no message add their (all-False) rows to spare
    accumulator rows, spread so that the adds do not contend."""
    C_loc, M = take.shape
    q = state.borrowed
    dev = q.device
    msg_dst = ex.gather(torch.where(take, rows[..., R.ROWNER], -1)).reshape(-1)
    msg_rows = ex.gather(rows).reshape(-1, R.RF)
    n = msg_dst.shape[0]
    local = msg_dst - ex.offset(C_loc)
    mine = (msg_dst >= 0) & (local >= 0) & (local < C_loc)
    dst = torch.where(mine, local, 0).long()
    hit = mine[:, None]
    for rf, qf in _MATCH:
        hit = hit & (Q.field(q, qf)[dst] == msg_rows[:, rf, None])
    spare = C_loc + torch.arange(n, device=dev) % max(C_loc, 1)
    acc = torch.zeros((2 * C_loc, q.capacity), dtype=I32, device=dev)
    acc.index_add_(0, torch.where(mine, dst, spare), hit.to(I32))
    matched = (acc[:C_loc] > 0) & q.slot_valid()
    return state.replace(borrowed=Q.compact(q, ~matched))


# --------------------------------------------------------------------------
# phase 3: arrivals (host-side bucketing, then the per-tick ingest)
# --------------------------------------------------------------------------

def _bucket_arrivals_host(arr: Arrivals, n_ticks: int, tick_ms: int):
    """The host-side bucketing core behind ``pack_arrivals_by_tick`` and
    ``pack_arrivals_chunks``: each arrival's destination tick and
    rank-in-tick. Returns ``(fields [C, A, NF], dest [C, A], ok [C, A],
    rank [C, A], counts [T, C])``; ``dest`` parks arrivals beyond the
    horizon on a virtual overflow tick ``n_ticks``."""
    t = np.asarray(arr.t)
    C, A = t.shape
    n = np.asarray(arr.n)
    valid = np.arange(A)[None, :] < n[:, None]
    if A > 1 and not np.all(np.diff(t, axis=1)[valid[:, 1:]] >= 0):
        raise ValueError("pack_arrivals_by_tick requires per-cluster "
                         "time-sorted arrivals")
    # tick k has clock (k+1)*tick_ms; int64 so arrivals near 2^31 park on
    # the overflow tick instead of wrapping into tick 0
    dest = np.maximum((t.astype(np.int64) + tick_ms - 1) // tick_ms, 1) - 1
    ok = valid & (dest < n_ticks)
    dest = np.where(ok, dest, n_ticks)
    counts2d = np.zeros((C, n_ticks + 1), np.int32)
    np.add.at(counts2d, (np.arange(C)[:, None], dest), 1)
    firsts = np.zeros((C, n_ticks + 1), np.int64)
    firsts[:, 1:] = np.cumsum(counts2d, axis=1)[:, :-1]
    rank = np.arange(A)[None, :] - firsts[np.arange(C)[:, None], dest]
    fields = pack_arrivals(arr)[0]
    return fields, dest, ok, rank, counts2d.T[:n_ticks].copy()


def pack_arrivals_by_tick(arr: Arrivals, n_ticks: int,
                          tick_ms: int) -> st.TickArrivals:
    """Bucket the stream by destination tick: a job arriving at ``ta`` is
    ingested at the first tick whose clock ``(k+1)*tick_ms >= ta``. Rows
    pad to the stream-global max arrivals per tick; arrivals beyond the
    horizon are dropped."""
    fields, dest, ok, rank, counts = _bucket_arrivals_host(arr, n_ticks,
                                                           tick_ms)
    C = fields.shape[0]
    K = max(int(counts.max(initial=1)), 1)
    rows = np.broadcast_to(_QUEUE_INVALID, (n_ticks, C, K, Q.NF)).copy()
    cc, aa = np.nonzero(ok)
    rows[dest[cc, aa], cc, rank[cc, aa]] = fields[cc, aa]
    return st.TickArrivals(rows=rows, counts=counts)


def round_up_pow2(k: int) -> int:
    """Smallest power of two >= k (>= 1)."""
    return 1 << max(int(k) - 1, 0).bit_length()


def pack_arrivals_chunks(arr: Arrivals, chunk_sizes: Sequence[int],
                         tick_ms: int, start: int = 0,
                         k_bucket=round_up_pow2) -> list[st.TickArrivals]:
    """Ragged per-chunk bucketing: ``pack_arrivals_by_tick`` for a chunked
    run, each chunk's ``[ticks, C, K_chunk, NF]`` rows padded to that
    chunk's own max arrivals per tick, rounded up by ``k_bucket`` and
    clamped at the stream-global max. Chunk ``i`` covers ticks
    ``[start + sum(chunk_sizes[:i]), start + sum(chunk_sizes[:i+1]))``."""
    n_ticks = start + sum(chunk_sizes)
    fields, dest, ok, rank, counts = _bucket_arrivals_host(arr, n_ticks,
                                                           tick_ms)
    C = fields.shape[0]
    cc, aa = np.nonzero(ok)
    d, r = dest[cc, aa], rank[cc, aa]
    order = np.argsort(d, kind="stable")
    d, cc, aa, r = d[order], cc[order], aa[order], r[order]
    bounds = np.searchsorted(d, np.cumsum([start] + list(chunk_sizes)))
    k_global = max(int(counts.max(initial=1)), 1)
    out = []
    off = start
    for i, nt in enumerate(chunk_sizes):
        kc = int(counts[off:off + nt].max(initial=0))
        K = max(min(int(k_bucket(max(kc, 1))), k_global), kc, 1)
        rows = np.broadcast_to(_QUEUE_INVALID, (nt, C, K, Q.NF)).copy()
        sl = slice(bounds[i], bounds[i + 1])
        rows[d[sl] - off, cc[sl], r[sl]] = fields[cc[sl], aa[sl]]
        out.append(st.TickArrivals(rows=rows,
                                   counts=counts[off:off + nt].copy()))
        off += nt
    return out


def _ingest_packed_local(s: SimState, rows: torch.Tensor, cnt: torch.Tensor,
                         to_delay: bool):
    """Enqueue one tick's pre-bucketed arrivals (``rows`` [C, K, NF],
    ``cnt`` [C]): into Level0 for the queue-sweep policies (``to_delay``),
    else into the FIFO ReadyQueue. The drop count reads the target before
    the push, and ``arr_ptr`` advances by ``cnt`` even for dropped rows;
    the Level0 path adds ``cnt`` (not the pushed count) to ``wait_jobs``
    and ``jobs_in_queue``, as the reference does
    (core/engine.py:_ingest_packed_local there)."""
    K = rows.shape[1]
    valid = torch.arange(K, dtype=Q.I32, device=rows.device)[None, :] \
        < cnt[:, None]
    batch = Q.JobQueue(data=rows, count=cnt)
    tgt = s.l0 if to_delay else s.ready
    dropped = Q.push_many_dropped(tgt, valid)
    s = s.replace(drops=s.drops.replace(queue=s.drops.queue + dropped))
    if to_delay:
        s = s.replace(l0=Q.push_many(s.l0, batch, valid),
                      wait_jobs=s.wait_jobs + cnt,
                      jobs_in_queue=s.jobs_in_queue + cnt)
    else:
        s = s.replace(ready=Q.push_many(s.ready, batch, valid))
    return s.replace(arr_ptr=s.arr_ptr + cnt)


def pack_arrivals(arr: Arrivals) -> tuple[np.ndarray, np.ndarray]:
    """The stream as ready-made queue rows ``[C, A, NF]`` and its valid
    counts ``arr.n`` [C] (host numpy, int32), made once per run; the
    per-tick ingest takes its window from them (``_ingest_local``).
    Column order is the field schema's (ops/fields.py)."""
    t = np.asarray(arr.t)
    vals = {"id": arr.id, "cores": arr.cores, "mem": arr.mem,
            "gpu": arr.gpu, "dur": arr.dur, "enq_t": t,
            "owner": np.full(t.shape, Q.OWN), "rec_wait": np.zeros(t.shape),
            "jclass": F.job_class(np.asarray(arr.cores), np.asarray(arr.gpu)),
            "retries": np.zeros(t.shape)}
    rows = np.stack([np.asarray(vals[n]) for n in F.QUEUE_FIELDS],
                    axis=-1).astype(np.int32)
    return rows, np.asarray(arr.n, np.int32)


def _ingest_local(s: SimState, arr_rows: torch.Tensor, arr_n: torch.Tensor,
                  t: int, cfg: SimConfig, to_delay: bool):
    """Enqueue the stream's arrivals with ``enq_t <= t`` (the reference's
    windowed ingest): into Level0 for the queue-sweep policies
    (``to_delay``; the /delay handler, server.go:53-78, which also grows
    ``wait_jobs`` and ``jobs_in_queue``), else into the FIFO ReadyQueue
    (the / handler, server.go:23-51).

    ``arr_rows`` [C, A, NF] are ``pack_arrivals``' rows and ``arr_n`` [C]
    their counts. The window is ``[arr_ptr, arr_ptr + K)`` with ``K =
    min(max_ingest_per_tick, A)``; due arrivals beyond it slip to the next
    tick and count into ``drops.ingest`` (a timing divergence from Go,
    which parity runs assert never happens). The reference extracts the
    window with a one-hot matmul; a gather gives the same rows."""
    C, A = arr_rows.shape[0], arr_rows.shape[1]
    K = min(cfg.max_ingest_per_tick, A)
    dev = arr_rows.device
    a = torch.arange(A, dtype=I32, device=dev)[None, :]
    ptr = s.arr_ptr[:, None]
    in_window = (a >= ptr) & (a < ptr + K)
    due = ((a >= ptr) & (a < arr_n[:, None])
           & (arr_rows[..., Q.FENQ] <= t))  # everything Go ingests now
    n = isum(due & in_window, 1)
    s = s.replace(drops=s.drops.replace(
        ingest=s.drops.ingest + (isum(due, 1) - n)))
    k = torch.arange(K, dtype=I32, device=dev)[None, :]
    idx = torch.clamp(ptr + k, max=max(A - 1, 0)).long()
    rows = torch.gather(arr_rows, 1, idx[..., None].expand(C, K, Q.NF))
    valid = k < n[:, None]
    batch = Q.JobQueue(data=rows, count=n)
    tgt = s.l0 if to_delay else s.ready
    dropped = Q.push_many_dropped(tgt, valid)
    s = s.replace(drops=s.drops.replace(queue=s.drops.queue + dropped))
    if to_delay:
        s = s.replace(l0=Q.push_many(s.l0, batch, valid),
                      wait_jobs=s.wait_jobs + n,
                      jobs_in_queue=s.jobs_in_queue + n)
    else:
        s = s.replace(ready=Q.push_many(s.ready, batch, valid))
    return s.replace(arr_ptr=s.arr_ptr + n)


# --------------------------------------------------------------------------
# phase 5: borrow matching
# --------------------------------------------------------------------------

_INF = 2**31 - 1


def _borrow_match(state: SimState, want: torch.Tensor, jobs: Q.JobRec,
                  cfg: SimConfig, ex) -> SimState:
    """Global borrow phase: BorrowResources' broadcast + first win
    (server.go:160-248), determinised to the lowest lender index.

    ``want`` [C] bool and ``jobs`` (a JobRec of [C, NF] rows: each
    cluster's failing wait-head). Feasibility is Lend()'s strict check
    (scheduler.go:194-202) against the lender's state after this tick's
    scheduling pass, and no reservation is made, as in the Go handler.
    The [lender, borrower] feasibility is built by ``can_lend`` a block of
    nodes at a time (C x C booleans a node at 4,096 clusters); the lender
    push is ``push_many`` over the borrowers, in
    borrower-index order."""
    C_loc = want.shape[0]
    dev = want.device
    gidx = ex.global_index(C_loc, dev)  # my lenders, global indices
    g_want = ex.gather(want)  # [C_tot]
    g_vec = ex.gather(jobs.vec)  # [C_tot, NF]
    C_tot = g_want.shape[0]
    bidx = torch.arange(C_tot, dtype=I32, device=dev)

    # feas[l_local, b_global]: can my lender l host borrower b's job? As
    # the reference asks it, of the job's cores and mem alone (its JobRec
    # is made of those two, its core/engine.py:540-543): a gpu demand
    # never blocks a lend
    lend_vec = g_vec.clone()
    lend_vec[:, Q.FGPU] = 0
    feas = P.can_lend(state.node_free[:, None], state.node_active[:, None],
                      Q.JobRec(vec=lend_vec))
    feas &= gidx[:, None] != bidx[None, :]  # no self-lend
    feas &= g_want[None, :]
    local_best = torch.where(feas, gidx[:, None], _INF).amin(dim=0)
    winner = ex.allmin(local_best)  # lowest feasible lender, global
    matched_g = winner < _INF  # [C_tot]

    # Borrower side (local): j.Ownership = own URL (server.go:166), push to
    # BorrowedQueue, pop WaitQueue (scheduler.go:239-242).
    matched = matched_g[gidx.long()] & want
    owned = Q.JobRec(vec=_with_owner(jobs.vec, gidx))
    wait = Q.pop_front(state.wait, matched)
    borrowed = Q.push_back(state.borrowed, owned, matched)
    bdrop = Q.push_back_dropped(state.borrowed, matched)

    # Lender side (local): append to LentQueue (server.go:94-107). Several
    # borrowers may win one lender in a tick (the Go handler takes them
    # all); they arrive in global borrower-index order.
    send = Q.JobQueue(data=_with_owner(g_vec, bidx),
                      count=isum(matched_g, 0))
    take = matched_g[None, :] & (winner[None, :] == gidx[:, None])
    lent = Q.push_many(state.lent, send, take)
    ldrop = Q.push_many_dropped(state.lent, take)
    return state.replace(wait=wait, borrowed=borrowed, lent=lent,
                         drops=state.drops.replace(
                             queue=state.drops.queue + bdrop + ldrop))


# --------------------------------------------------------------------------
# phase 7: the trader-visible state snapshot
# --------------------------------------------------------------------------

def _snapshot(state: SimState) -> SimState:
    """Refresh each trader's cached cluster state (trader_server.go:24-47:
    the 5 s ClusterState stream; trader.go:71-108). The engine calls it on
    the stream cadence only."""
    cu, mu = st.snapshot_utilization(state)
    return state.replace(trader=state.trader.replace(
        snap_core_util=cu, snap_mem_util=mu,
        snap_avg_wait=st.avg_wait_ms(state)))


def _widen_nodes(state: SimState) -> SimState:
    """The span-entry widen of narrow node columns (core/compact.py): every
    phase computes on int32 as on the wide layout. Nothing is checked: the
    values were stored through the checked exit narrow."""
    if state.node_free.dtype == I32:
        return state
    return state.replace(node_free=F.widen(state.node_free),
                         node_cap=F.widen(state.node_cap))


def _narrow_nodes(state: SimState, dtype) -> SimState:
    """The CHECKED exit narrow of the node columns into ``dtype``: a value
    the plan did not size for (a contract total beyond its node bound, a
    hand-built state) clamps to the dtype minimum and counts. As in the
    reference, whose narrow runs on the whole batch, the count is ONE total
    over every cluster's free and capacity words, added to every cluster's
    ``run.ovf`` (the node columns have no counter of their own)."""
    free_n, bad_f = F.narrow_store(state.node_free, dtype)
    cap_n, bad_c = F.narrow_store(state.node_cap, dtype)
    return state.replace(node_free=free_n, node_cap=cap_n,
                         run=state.run.replace(ovf=state.run.ovf + bad_f
                                               + bad_c))


def _phase_on(phase_limit):
    """Does phase k (obs.profile.TICK_PHASES, from 1) run under
    ``phase_limit``? Every phase where it is None."""
    if phase_limit is None:
        return lambda k: True
    return lambda k: k <= phase_limit


def _with_owner(vec: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    out = vec.clone()
    out[..., Q.FOWNER] = owner
    return out


def _write_back(dst: SimState, src: SimState) -> SimState:
    """Copy into ``dst``'s tensors every leaf ``src`` holds anew (the
    cross-cluster phases return new tensors), so that a run updates the
    caller's state in place; a leaf that already lies where ``dst``'s does
    (the same tensor, or a view of a batch's lane taken twice) is not
    copied onto itself. Returns ``dst``."""
    if dst is src:
        return dst
    for (_, d), (_, s_) in zip(leaves_with_keys(dst), leaves_with_keys(src)):
        if d is not s_ and not (d.data_ptr() == s_.data_ptr()
                                and d.dtype == s_.dtype
                                and d.stride() == s_.stride()
                                and d.shape == s_.shape):
            d.copy_(s_)
    return dst


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

def _check_slice(cfg: SimConfig) -> None:
    """Refuse, by name, every configuration this slice does not carry."""
    if cfg.n_res not in (2, 3):
        raise ValueError(f"n_res must be 2 or 3, got {cfg.n_res}")
    for field in ("fifo_drain", "ffd_sweep", "delay_sweep"):
        v = getattr(cfg, field)
        if v not in ("wave", "serial"):
            raise ValueError(
                f"{field} must be 'wave' or 'serial', got {v!r}")
    if cfg.trader.enabled and cfg.n_res != 3:
        raise ValueError("the trader market carves 3-dim resources; "
                         "set n_res=3 when trader.enabled")


class Engine:
    """Runs ticks of ``cfg`` on ``device`` — the card unless the caller
    names another device (``device="cpu"`` runs the plain PyTorch path).
    ``policies`` is the ``PolicySet`` to run (the singleton set of
    ``cfg.policy`` by default). ``run`` and ``run_chunks`` advance the
    state IN PLACE and return it; clone a state first
    (``core.state.clone_state``) to keep the original. ``ex`` is the
    cross-cluster exchange: ``LocalExchange`` (the whole cluster axis on
    this device) by default, a ``parallel.MeshExchange`` for one shard of a
    mesh (``parallel.ShardedEngine``)."""

    def __init__(self, cfg: SimConfig, device=None, policies=None, ex=None):
        self.pset = policies if policies is not None else \
            PolicySet.from_config(cfg)
        _check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ex = ex if ex is not None else LocalExchange()
        self._default_params = self.pset.params_for(cfg, device=self.device)
        self._jitter = {}
        # the lane plans fused_tick.host_params caches, per (members,
        # device): a run over the same lanes copies nothing to the device
        self._lane_plans = {}
        # host reads of the compressed driver's leap probe, one per
        # executed tick without arrivals (run_compressed); a caller resets
        # it to count a run
        self.probe_reads = 0

    def prefix_terminal(self) -> bool:
        """Does the tick END with the per-cluster prefix? True when no
        post-span phase runs: no return delivery or borrow matching
        (``cfg.borrowing``) and no trader snapshot or market round."""
        return not self.cfg.borrowing and not self.cfg.trader.enabled

    def fused_active(self) -> bool:
        """Does this engine run the per-cluster prefix as a hand-written
        kernel? On the card always, on the CPU never (the port has no
        interpret mode: the CPU runs the plain version)."""
        return self.device.type == "cuda"

    def fused_provenance(self) -> dict:
        """What a recorded number ran: the engaged span, the member and the
        kernel that carries it (``kernels.fused_tick.provenance``)."""
        return fused_tick.provenance(self)

    def prefix_phases(self) -> tuple[str, ...]:
        """The tick phases this config's per-cluster prefix engages, in
        obs.profile.TICK_PHASES order (``fused_tick.engaged_span``)."""
        return fused_tick.engaged_span(self.cfg)

    def policy_provenance(self, params=None) -> dict:
        """(registered policy name(s), params digest) for detail dicts:
        the singleton policy with the default params, else the set."""
        if params is None and len(self.pset.names) == 1:
            return self.pset.provenance(self.cfg)
        p = params if params is not None else self._default_params
        return {"name": "|".join(self.pset.names),
                "params_digest": params_digest(p)}

    def market_provenance(self, params=None) -> dict:
        """Which matching priced this run's trade rounds, at what solver
        depth, under which parameter leaves (the params digest covers the
        ``mkt_*`` leaves)."""
        tc = self.cfg.trader
        out = {"enabled": bool(tc.enabled),
               "matching": tc.matching.value if tc.enabled else None}
        if tc.enabled:
            out["params_digest"] = params_digest(
                params if params is not None else self._default_params)
            if tc.matching is MatchKind.SINKHORN:
                out.update(iters=tc.sinkhorn_iters, eps=tc.sinkhorn_eps)
            elif tc.matching is MatchKind.CVX:
                out.update(iters=tc.cvx_iters, step=tc.cvx_step,
                           rho=tc.cvx_rho, smooth=tc.cvx_smooth)
        return out

    def jitter(self, c_loc: int):
        """The sinkhorn/cvx tie-break table [c_loc sellers, C_tot buyers]
        of this shard (its sellers' global indices from the exchange's
        offset; ``C_tot = c_loc`` on one device) on the engine's device,
        made on the host once per (offset, c_loc, C_tot)
        (``market.trader.pair_jitter``); None for the greedy market."""
        mcfg = self.cfg.trader
        if not mcfg.enabled or mcfg.matching == MatchKind.GREEDY:
            return None
        key = (self.ex.offset(c_loc), c_loc, self.ex.total(c_loc))
        if key not in self._jitter:
            self._jitter[key] = market.pair_jitter(*key, self.device)
        return self._jitter[key]

    def n_msgs(self) -> int:
        """Return-message slots per cluster and tick: ``cfg.max_msgs``,
        at most the running set's slots (the pack takes that many)."""
        return min(self.cfg.max_msgs, self.cfg.max_running)

    def member(self, params=None):
        """The ``PolicySpec`` that ``params.idx`` selects (the default
        params' member when None): a host read of the index."""
        params = self._default_params if params is None else params
        return self.pset.member(params.idx)

    def _span_prefix(self, state: SimState, rows: torch.Tensor,
                     counts: torch.Tensor, t: int, params: PolicyParams,
                     member=None, emit_returns: bool = False, obs=None,
                     windowed: bool = False, phase_limit=None):
        """Phases 1-5 of the tick on this slice's paths, as plain PyTorch
        ops: the fault phase where ``cfg.faults`` engages it (its requeues
        into the member's ingest target), completions (and, with
        ``emit_returns``, the pack of the finished foreign jobs' return
        messages, whose overflow counts into ``drops.msgs``), vnode expiry
        where the config engages it, arrival ingest into the member's
        queue, the member's pass. ``member`` is the ``PolicySpec``
        ``params.idx`` selects (read from the index when None). The
        arrivals are one tick's ``rows`` [C, K, NF] and ``counts`` [C], or
        with ``windowed`` the whole packed stream [C, A, NF] and its
        counts (``_ingest_local``). ``obs``, a ``(pc, cursor)`` pair
        (``obs.device.tap_pc`` form), runs the metrics tap's per-cluster
        half after the pass, as the span's epilogue: legal only on a
        terminal prefix. Returns ``(state, want, bjob_vec, ret_rows,
        ret_valid, obs_out)``, the return rows None when ``emit_returns``
        is off and ``obs_out = (pc', cursor', placed_d, depth)`` or None,
        as the reference's. The CUDA kernels are held against exactly this
        function. On the compact layout the node columns are widened at
        entry, and on a terminal prefix narrowed back through the checked
        exit narrow before the tap (``_narrow_nodes``); a non-terminal
        tick narrows them after its last phase instead (``_tick``).
        ``phase_limit`` (the ablation's, ``run_prefix``) runs only phases
        ``1..phase_limit`` of obs.profile.TICK_PHASES; the widen and the
        narrow run regardless, as in the reference."""
        member = self.member(params) if member is None else member
        on = _phase_on(phase_limit)
        node_dt = state.node_free.dtype
        state = _widen_nodes(state)
        if self.cfg.faults.enabled and on(1):
            state = faults_apply.fault_phase_local(state, t, self.cfg,
                                                   member.to_delay)
        ret_rows = ret_valid = None
        if on(2):
            run_before = state.run
            state, done = _release_local(state, t)
            if emit_returns:
                ret_rows, ret_valid, dropped = _pack_returns(
                    run_before, done, self.cfg.max_msgs)
                state = state.replace(drops=state.drops.replace(
                    msgs=state.drops.msgs + dropped))
        if fused_tick.expires(self.cfg) and on(3):
            state = _expire_vnodes_local(state, t)
        if on(4) and windowed:
            state = _ingest_local(state, rows, counts, t, self.cfg,
                                  member.to_delay)
        elif on(4):
            state = _ingest_packed_local(state, rows, counts,
                                         member.to_delay)
        if on(5):
            state, want, bjob_vec = self.pset.dispatch(state, t, params,
                                                       self.cfg, member)
        else:
            want, bjob_vec = _zero_io(state)
        if node_dt != I32 and self.prefix_terminal():
            state = _narrow_nodes(state, node_dt)
        obs_out = None
        if obs is not None:
            if not self.prefix_terminal():
                raise ValueError(
                    "epilogue tap requested on a non-terminal prefix: the "
                    "phases after the span would move the counters after "
                    "the tap (obs belongs to the post-tick tap)")
            obs_out = obs_device.tap_tick_local(obs[0], obs[1], state)
        return state, want, bjob_vec, ret_rows, ret_valid, obs_out

    def _tick(self, state: SimState, rows: torch.Tensor,
              counts: torch.Tensor, t: int, params: PolicyParams,
              host: dict, out: TickIO = None, obs=None,
              windowed: bool = False, phase_limit=None):
        """One tick ending at clock ``t`` (a host int): the prefix, then
        with borrowing return delivery and borrow matching, then with the
        trader the snapshot and the market round on their cadences, then
        the clock. ``out`` (TickIO buffers) receives the tick's events; the
        prefix emits them whenever borrowing or ``out`` asks, into
        ``host["io"]`` when ``out`` is None. ``obs`` is the run's
        ``(MetricsBuffer, TapCursor)``: on a terminal prefix the prefix's
        epilogue updates both in place; otherwise ``tap_tick`` runs after
        the clock and returns new ones. Returns ``(state, obs)``; the
        cross-cluster phases rebuild the state (``run_chunks`` writes it
        back). On the compact layout a non-terminal tick widens the node
        columns before the prefix and narrows them, checked, after the
        market round, so the phases after the prefix compute on int32 as
        the reference's do; a terminal prefix narrows them itself.
        ``phase_limit`` truncates the tick after its first ``phase_limit``
        phases (``run_prefix``; the clock advances at any limit): from 5
        up the prefix is the kernel as always; below 5 it is the plain
        span truncated, as in the reference, where a half-span is a
        diagnostic and not a kernel."""
        if host["stacked"]:
            return self._tick_lanes(state, rows, counts, t, params, host,
                                    out, obs, windowed)
        emit = self.cfg.borrowing or out is not None
        terminal = self.prefix_terminal()
        node_dt = state.node_free.dtype
        if not terminal:
            state = _widen_nodes(state)
        if phase_limit is not None and phase_limit < 5:
            state, *io, _ = self._span_prefix(
                state, rows, counts, t, params, host["member"], emit,
                windowed=windowed, phase_limit=phase_limit)
        else:
            with phase_scope("fused_prefix"):
                state, *io, _ = fused_tick.fused_prefix(
                    self, state, rows, counts, t, params, host,
                    emit_returns=emit,
                    out=out if out is not None else host.get("io"),
                    obs=obs if terminal else None, windowed=windowed)
        state = self._cross_cluster(state, *io, phase_limit=phase_limit)
        state = self._market(state, t, params, host["jitter"], phase_limit)
        if node_dt != I32 and not terminal:
            state = _narrow_nodes(state, node_dt)
        state.t.fill_(t)
        if obs is not None and not terminal:
            obs = obs_device.tap_tick(obs[0], obs[1], state,
                                      self.cfg.tick_ms)
        return state, obs

    def _tick_lanes(self, state: SimState, rows: torch.Tensor,
                    counts: torch.Tensor, t: int, params: PolicyParams,
                    host: dict, out: TickIO = None, obs=None,
                    windowed: bool = False):
        """``_tick`` over a lane-stacked state, the lanes in lockstep on the
        host clock ``t``: the prefix as ONE launch a kernel source over
        every lane (``fused_tick.fused_prefix_lanes``; the plain per-lane
        loop on the CPU), then, where the tick does not end there, each
        lane's cross-cluster phases, market, exit narrow and tap as PyTorch
        ops on that lane's [C] views: borrowing and the market never cross
        lanes, and the node exit narrow counts per lane. The state, the
        buffer and the cursor are updated in place; returns ``(state,
        obs)``."""
        emit = self.cfg.borrowing or out is not None
        terminal = self.prefix_terminal()
        node_dt = state.node_free.dtype
        cur = state if terminal else _widen_nodes(state)
        with phase_scope("fused_prefix"):
            cur, *io, _ = fused_tick.fused_prefix_lanes(
                self, cur, rows, counts, t, params, host, emit_returns=emit,
                out=out if out is not None else host.get("io"),
                obs=obs if terminal else None, windowed=windowed)
        if not terminal:
            for i in range(host["L"]):
                s_i = fused_tick.lane(cur, i)
                s_i = self._cross_cluster(
                    s_i, *(None if x is None else x[i] for x in io))
                s_i = self._market(s_i, t, fused_tick.lane(params, i),
                                   host["jitter"])
                if node_dt != I32:
                    s_i = _narrow_nodes(s_i, node_dt)
                _write_back(fused_tick.lane(state, i), s_i)
        state.t.fill_(t)
        if obs is not None and not terminal:
            for i in range(host["L"]):
                mb_i = fused_tick.lane(obs[0], i)
                cur_i = fused_tick.lane(obs[1], i)
                mb, c = obs_device.tap_tick(mb_i, cur_i,
                                            fused_tick.lane(state, i),
                                            self.cfg.tick_ms)
                _write_back(mb_i, mb)
                _write_back(cur_i, c)
        return state, obs

    def snapshot_due(self, t: int) -> bool:
        """Does phase 7, the trader's snapshot, run in the tick ending at
        clock ``t``? On the stream cadence: a host branch on the host
        clock."""
        mcfg = self.cfg.trader
        return mcfg.enabled and t % mcfg.state_cadence_ms == 0

    def round_due(self, t: int) -> bool:
        """Does phase 8, the market round, run in the tick ending at clock
        ``t``? On the monitor cadence: a host branch on the host clock."""
        mcfg = self.cfg.trader
        return mcfg.enabled and t % mcfg.monitor_period_ms == 0

    def _market(self, state: SimState, t: int, params, jitter,
                phase_limit=None) -> SimState:
        """Phases 7 and 8 where due (and within ``phase_limit``): the
        snapshot before any trade in the same tick (MARKET.md §clock),
        then the market round."""
        on = _phase_on(phase_limit)
        if self.snapshot_due(t) and on(7):
            with phase_scope("snapshot"):
                state = _snapshot(state)
        if self.round_due(t) and on(8):
            with phase_scope("trade"):
                state = market.trade_round(state, t, self.cfg, self.ex,
                                           params, jitter)
        return state

    def _cross_cluster(self, state: SimState, want, bjob_vec, ret_rows,
                       ret_valid, phase_limit=None) -> SimState:
        """The phases after the prefix (none without borrowing), on the
        prefix's outputs: return delivery (with phase 2), then borrow
        matching (phase 6), within ``phase_limit``."""
        if not self.cfg.borrowing:
            return state
        on = _phase_on(phase_limit)
        # 2b. return delivery: after the whole prefix, bitwise the same as
        # before it, because it touches only ``state.borrowed``, which no
        # prefix phase reads
        if on(2):
            with phase_scope("release"):
                state = _deliver_returns(state, ret_rows, ret_valid, self.ex)
        # 6. borrow matching (want is all False for non-FIFO members)
        if self.pset.has_fifo and on(6):
            with phase_scope("borrow"):
                state = _borrow_match(state, want, Q.JobRec(vec=bjob_vec),
                                      self.cfg, self.ex)
        return state

    def _params(self, params) -> PolicyParams:
        params = self._default_params if params is None else params
        bad = sorted({str(v.device) for _, v in leaves_with_keys(params)}
                     - {str(self.device)})
        if bad:
            raise ValueError(f"params live on {bad}, the engine on "
                             f"{self.device}")
        return params

    def _check_state(self, state: SimState) -> None:
        if state.device != self.device:
            raise ValueError(f"state lives on {state.device}, the engine "
                             f"on {self.device}")

    def lanes_of(self, state: SimState, params=None):
        """The lane count of a lane-stacked run, None for one
        constellation. A state is lane-stacked when its clock has a lane
        axis (``t`` [L], every other leaf [L, C, ...]); params are batched
        when ``idx`` is [L]. A batched ``idx`` needs a lane-stacked state
        of as many lanes; shared params serve every lane."""
        params = self._default_params if params is None else params
        idx = params.idx
        if state.t.dim() == 0:
            if idx.dim() != 0:
                raise ValueError(
                    f"a batched params.idx of shape {tuple(idx.shape)} needs "
                    f"a lane-stacked state (t of shape [L], every leaf with "
                    f"a leading [L]); this state's t has shape ()")
            return None
        L = state.t.shape[0]
        if state.t.dim() != 1 or state.arr_ptr.dim() != 2 or \
                state.arr_ptr.shape[0] != L:
            raise ValueError(f"a lane-stacked state has t [L] and [L, C] "
                             f"counters; got t {tuple(state.t.shape)}, "
                             f"arr_ptr {tuple(state.arr_ptr.shape)}")
        if idx.dim() == 1 and idx.shape[0] != L:
            raise ValueError(f"params.idx of shape {tuple(idx.shape)} for a "
                             f"state of {L} lanes")
        return L

    def lane_params(self, params, L: int) -> PolicyParams:
        """``params`` with every leaf on the lane axis [L, ...]: leaves of
        one member's shape are broadcast (views), batched ones checked."""
        ref = dict(leaves_with_keys(self._default_params))

        def lift(key, x):
            if x.dim() == ref[key].dim():
                return x.expand(L, *x.shape)
            if x.dim() != ref[key].dim() + 1 or x.shape[0] != L:
                raise ValueError(f"params{key} of shape {tuple(x.shape)} for "
                                 f"{L} lanes")
            return x
        return PolicyParams(**{k[1:]: lift(k, x)
                               for k, x in leaves_with_keys(params)})

    def _clock(self, state: SimState) -> int:
        """The run's host clock, read once at its entry: a lane-stacked
        state's lanes must share it (they run in lockstep)."""
        if state.t.dim() == 0:
            return int(state.t)
        ts = set(state.t.tolist())
        if len(ts) != 1:
            raise ValueError(f"lanes out of lockstep: clocks {sorted(ts)}; "
                             f"run, run_chunks, run_io and step_tick step "
                             f"every lane on one clock (run_compressed "
                             f"drives each lane on its own)")
        return ts.pop()

    def _entry(self, state: SimState, params, clock=None, members=None):
        """What a run reads once at its entry: the checked params (every
        leaf on the lane axis for a lane-stacked state), the kernels' host
        parameters (with a scratch TickIO when borrowing emits every tick)
        and the clock. ``clock`` (a host int) and ``members`` (the lanes'
        member indices) spare the two host reads."""
        self._check_state(state)
        params = self._params(params)
        L = self.lanes_of(state, params)
        if L is not None:
            params = self.lane_params(params, L)
        host = fused_tick.host_params(self, params, members)
        C = state.arr_ptr.shape[-1]
        host["jitter"] = self.jitter(C)
        if self.cfg.borrowing:
            host["io"] = empty_io((C,) if L is None else (L, C),
                                  self.n_msgs(), self.device)
        t = self._clock(state) if clock is None else int(clock)
        return params, host, t

    def _obs_entry(self, state: SimState, mbuf):
        """The run's ``(MetricsBuffer, TapCursor)`` (None without a
        buffer): the cursor re-derived from the state at every run entry,
        as the reference does at every chunk."""
        if mbuf is None:
            return None
        if mbuf.placed.shape != state.arr_ptr.shape or \
                mbuf.placed.device != state.device:
            raise ValueError(
                f"metrics buffer of {tuple(mbuf.placed.shape)} clusters on "
                f"{mbuf.placed.device}, the state "
                f"{tuple(state.arr_ptr.shape)} on {state.device}")
        return mbuf, obs_device.cursor_of(state)

    def _drive(self, state: SimState, params, mbuf, feeds):
        """The tick loop every run shares: ``feeds`` yields each tick's
        ``(rows, counts, windowed)``. The state and the caller's buffer
        are updated in place; returns the state, then the stacked
        ``MetricSample`` series where ``cfg.record_metrics``, then the
        buffer where one was given (the reference's ``run`` tuple)."""
        params, host, t = self._entry(state, params)
        obs = self._obs_entry(state, mbuf)
        series = []
        cur = state
        for rows, counts, windowed in feeds:
            t += self.cfg.tick_ms
            cur, obs = self._tick(cur, rows, counts, t, params, host,
                                  obs=obs, windowed=windowed)
            if self.cfg.record_metrics:
                series.append(st.metric_sample(cur))
        state = _write_back(state, cur)
        out = (state,)
        if self.cfg.record_metrics:
            ser = st.stack_samples(series, state)
            if host["stacked"]:  # [T, L, ...] -> the lanes' [L, T, ...]
                ser = st.MetricSample(**{
                    k[1:]: x.movedim(0, 1) for k, x in leaves_with_keys(ser)})
            out += (ser,)
        if mbuf is not None:
            out += (_write_back(mbuf, obs[0]),)
        return out if len(out) > 1 else out[0]

    def run(self, state: SimState, arrivals, n_ticks: int, params=None,
            mbuf=None):
        """Advance ``n_ticks`` over a pre-bucketed ``TickArrivals`` (its
        rows go to the device once) or a windowed ``Arrivals`` stream
        (packed and copied to the device once; each tick ingests its due
        window). ``params`` (PolicyParams on the engine's device) defaults
        to the policy's own. ``mbuf`` (``obs.device.metrics_init``) engages
        the metrics plane. Returns the state — or, as the reference's, a
        tuple of the state, the [T] / [T, C] ``MetricSample`` series when
        ``cfg.record_metrics`` is set, and the buffer when ``mbuf`` was
        given. The state and the buffer are updated in place.

        A lane-stacked state (``lanes_of``) runs its lanes in lockstep over
        a lane-stacked ``TickArrivals`` (rows [L, T, C, K, NF], counts [L,
        T, C]; ``tenancy.stack_tick_arrivals``) with lane-stacked or shared
        params; its series come back [L, T, ...] and the buffer is the
        lanes' stacked buffers."""
        lanes = state.t.dim() == 1
        if isinstance(arrivals, Arrivals):
            if lanes:
                raise ValueError("a lane-stacked run takes a lane-stacked "
                                 "TickArrivals, not a windowed Arrivals "
                                 "stream")
            rows, n = (torch.from_numpy(x).to(self.device)
                       for x in pack_arrivals(arrivals))
            feeds = ((rows, n, True) for _ in range(n_ticks))
            return self._drive(state, params, mbuf, feeds)
        T = arrivals.rows.shape[1 if lanes else 0]
        if T < n_ticks:
            raise ValueError(
                f"TickArrivals covers {T} ticks, run asked for {n_ticks}")
        cut = (slice(None), slice(n_ticks)) if lanes else slice(n_ticks)
        part = st.TickArrivals(rows=arrivals.rows[cut],
                               counts=arrivals.counts[cut])
        return self.run_chunks(state, [part], params, mbuf)

    def _chunk_feeds(self, chunks: Sequence[st.TickArrivals]):
        for chunk in chunks:
            rows, counts = chunk.rows, chunk.counts
            if np.ndim(counts) == 3:  # lane-stacked: tick-major, once
                rows, counts = (np.swapaxes(x, 0, 1) for x in (rows, counts))
            with annotate_dispatch("chunk"):
                rows = torch.from_numpy(
                    np.ascontiguousarray(rows)).to(self.device)
                counts = torch.from_numpy(
                    np.ascontiguousarray(counts)).to(self.device)
            for k in range(rows.shape[0]):
                yield rows[k], counts[k], False

    def run_prefix(self, state: SimState, arrivals: st.TickArrivals,
                   n_ticks: int, phase_limit: int, params=None) -> SimState:
        """``run`` over a pre-bucketed stream with every tick truncated
        after its first ``phase_limit`` phases (obs.profile.TICK_PHASES
        order; the clock still advances at 0): the profile plane's
        ablation driver, phase k's cost at a shape being wall(prefix k) -
        wall(prefix k-1) on the real tick (tools/profile_capture.py).
        From 5 up each tick launches the kernel once, as ``run`` does;
        below 5 the truncated span runs as the plain ops on the engine's
        device. Diagnostic only: a truncated tick is not a simulation. The
        state is updated in place and returned."""
        if state.t.dim() != 0:
            raise ValueError("run_prefix drives one constellation; run a "
                             "lane of a batch (fused_tick.lane)")
        if arrivals.rows.shape[0] < n_ticks:
            raise ValueError(
                f"TickArrivals covers {arrivals.rows.shape[0]} ticks, "
                f"run_prefix asked for {n_ticks}")
        params, host, t = self._entry(state, params)
        part = st.TickArrivals(rows=arrivals.rows[:n_ticks],
                               counts=arrivals.counts[:n_ticks])
        cur = state
        for rows, counts, _ in self._chunk_feeds([part]):
            t += self.cfg.tick_ms
            cur, _ = self._tick(cur, rows, counts, t, params, host,
                                phase_limit=phase_limit)
        return _write_back(state, cur)

    def step_tick(self, state: SimState, rows, counts, params=None,
                  clock=None, members=None) -> SimState:
        """One tick of one tick's pre-bucketed arrivals (``rows [C, K,
        NF]``, ``counts [C]``, numpy or tensors; [L, C, ...] for a
        lane-stacked state): ``run`` over one tick, the environment mode's
        step (the reference's ``step_tick``). ``params`` selects and
        parameterizes the pass. ``clock`` (the state's clock as a host
        int) and ``members`` (each lane's member index) spare the entry's
        host reads: with both, and the rows on the device, the step never
        synchronises the host. The state is updated in place and
        returned."""
        params, host, t = self._entry(state, params, clock, members)
        rows, counts = (torch.as_tensor(x).to(self.device).contiguous()
                        for x in (rows, counts))
        cur, _ = self._tick(state, rows, counts, t + self.cfg.tick_ms,
                            params, host)
        return _write_back(state, cur)

    def run_chunks(self, state: SimState, chunks: Sequence[st.TickArrivals],
                   params=None, mbuf=None):
        """The chunked run of the headline: each chunk's rows and
        counts move to the device in one copy each, then its ticks run
        back to back with no host synchronisation. The clock, the member
        ``params.idx`` selects and every parameter the kernels take from
        the host are read once at entry; the clock is then tracked on the
        host and handed to each tick. ``mbuf`` carries the metrics plane
        over the chunks; returns as ``run`` does."""
        return self._drive(state, params, mbuf, self._chunk_feeds(chunks))

    def _windowed_tick(self, state: SimState, arrivals: Arrivals,
                       out) -> SimState:
        if state.t.dim() != 0:
            raise ValueError("tick and tick_io drive one constellation; a "
                             "lane-stacked state steps through step_tick")
        params, host, t = self._entry(state, None)
        rows, n = (torch.from_numpy(x).to(self.device)
                   for x in pack_arrivals(arrivals))
        cur, _ = self._tick(state, rows, n, t + self.cfg.tick_ms, params,
                            host, out, windowed=True)
        return _write_back(state, cur)

    def tick(self, state: SimState, arrivals: Arrivals) -> SimState:
        """One tick over a windowed ``Arrivals`` stream; the state is
        updated in place and returned."""
        return self._windowed_tick(state, arrivals, None)

    def tick_io(self, state: SimState,
                arrivals: Arrivals) -> tuple[SimState, TickIO]:
        """One tick over a windowed ``Arrivals`` stream, also returning the
        host-visible ``TickIO`` (the return messages and the borrow
        request)."""
        io = empty_io((state.arr_ptr.shape[0],), self.n_msgs(), self.device)
        return self._windowed_tick(state, arrivals, io), io

    def run_io(self, state: SimState, rows, counts, params=None, mbuf=None):
        """Advance one staged TickArrivals chunk (``rows [T, C, K, NF]``,
        ``counts [T, C]``, numpy or tensors) and return the state and the
        ``TickIO`` of every tick, stacked over the leading axis — the
        serving tier's dispatch unit (the reference's ``run_io``) — and
        the buffer when ``mbuf`` was given. The rows move to the device in
        one copy; no host synchronisation inside. Chunk composition is
        exact: ``run_io`` over consecutive chunks equals ``run`` over their
        concatenation. Every tick emits its returns, so ``drops.msgs``
        counts returns beyond ``cfg.max_msgs`` here even without
        borrowing, as in the reference.

        A lane-stacked state takes ``rows [L, T, C, K, NF]`` and ``counts
        [L, T, C]`` and returns the ``TickIO`` stack [L, T, C, ...]."""
        params, host, t = self._entry(state, params)
        obs = self._obs_entry(state, mbuf)
        rows, counts = (torch.as_tensor(x).to(self.device)
                        for x in (rows, counts))
        if host["stacked"]:  # tick-major, so each tick's rows are contiguous
            rows, counts = rows.transpose(0, 1), counts.transpose(0, 1)
        rows, counts = rows.contiguous(), counts.contiguous()
        T, lead = counts.shape[0], tuple(counts.shape[1:])
        io = empty_io((T, *lead), self.n_msgs(), self.device)
        cur = state
        for k in range(T):
            t += self.cfg.tick_ms
            out = TickIO(borrow_want=io.borrow_want[k],
                         borrow_job=io.borrow_job[k],
                         ret_rows=io.ret_rows[k], ret_valid=io.ret_valid[k])
            cur, obs = self._tick(cur, rows[k], counts[k], t, params, host,
                                  out, obs=obs)
        state = _write_back(state, cur)
        if host["stacked"]:
            io = TickIO(**{k[1:]: x.transpose(0, 1).contiguous()
                           for k, x in leaves_with_keys(io)})
        if mbuf is None:
            return state, io
        return state, io, _write_back(mbuf, obs[0])

    def run_compressed(self, state: SimState, arrivals: st.TickArrivals,
                       n_ticks: int, params=None, mbuf=None):
        """``run`` with event-compressed virtual time over one
        ``TickArrivals`` chunk: a tick executes only where something can
        happen, and the clock otherwise leaps to the tick before the next
        event in one step, bitwise the dense run.

        After each executed tick the driver compares the state's
        fingerprint (``_quiescence_sig``) with the one before the tick:
        unchanged, the constellation is at a fixed point, so every tick
        before the next event — the next tick with arrivals (from the
        chunk's host counts), the first completion, DELAY promotion,
        market cadence boundary, vnode expiry or fault event
        (``_next_event_t``) — is a no-op but for the wait accrual, which
        ``_leap_local`` applies in closed form. The vote and the event
        time leave the card as ONE packed int32 pair, a host read per
        executed tick (``probe_reads`` counts them), since the host holds
        the clock and needs the landing tick before it launches the next;
        a tick with arrivals is never quiet (it moves ``arr_ptr``), so it
        skips the probe and its read. A busy tick pays no mask work. A
        leap never passes the chunk's end, so consecutive calls compose
        like ``run_chunks``.

        Returns ``(state, LeapStats)``, or ``(state, series, LeapStats)``
        with ``cfg.record_metrics`` (the dense per-tick series: executed
        ticks sample as the dense run does; skipped ticks replicate the
        fixed point with the accrual folded into ``avg_wait_ms``), with
        the buffer last when ``mbuf`` is given (executed ticks tap as in
        ``run``; ``obs.device.tap_leap`` adds the skipped ticks' samples
        in closed form). The state and the buffer are updated in place."""
        cfg = self.cfg
        if not isinstance(arrivals, st.TickArrivals):
            raise ValueError("time compression requires pre-bucketed "
                             "TickArrivals (pack_arrivals_by_tick / "
                             "pack_arrivals_chunks)")
        if state.t.dim() == 1:
            return self._run_compressed_lanes(state, arrivals, n_ticks,
                                              params, mbuf)
        if arrivals.rows.shape[0] < n_ticks:
            raise ValueError(
                f"TickArrivals covers {arrivals.rows.shape[0]} ticks, "
                f"run asked for {n_ticks}")
        params, host, t0 = self._entry(state, params)
        obs = self._obs_entry(state, mbuf)
        member = host["member"]
        C, dev = state.arr_ptr.shape[0], self.device
        tick = cfg.tick_ms
        record = cfg.record_metrics
        executed = 0
        leaps = np.zeros(st.LEAP_BUCKETS, np.int32)
        if record:
            ser_t = torch.zeros((n_ticks,), dtype=I32, device=dev)
            ser_jq = torch.zeros((n_ticks, C), dtype=I32, device=dev)
            ser_avg = torch.zeros((n_ticks, C), dtype=torch.float32,
                                  device=dev)
        counts_host = np.asarray(arrivals.counts[:n_ticks])
        with annotate_dispatch("chunk"):
            rows = torch.from_numpy(np.ascontiguousarray(
                arrivals.rows[:n_ticks])).to(dev)
            counts = torch.from_numpy(
                np.ascontiguousarray(counts_host)).to(dev)
        # a tick with arrivals moves arr_ptr, so it is never quiet: the
        # host skips its vote and read, and the fingerprint before the next
        # tick is taken only where that tick may be quiet. On a mesh a tick
        # has arrivals where any shard's has (one allmax at entry), so that
        # every rank votes on the same ticks and leaps to the same clock
        has_arr = counts_host.any(axis=1)
        if self.ex.size > 1:
            has_arr = self.ex.allmax(
                torch.from_numpy(has_arr.astype(np.int32))).numpy() > 0
        next_arr = _next_arrival_ticks(has_arr[:, None])
        t_end = t0 + n_ticks * tick
        inf_t = t_end + tick  # "no event inside this chunk"
        cur, t, sig = state, t0, None
        while t < t_end:
            i = (t - t0) // tick
            t += tick
            if sig is None and not has_arr[i]:
                sig = _quiescence_sig(cur)
            cur, obs = self._tick(cur, rows[i], counts[i], t, params, host,
                                  obs=obs)
            executed += 1
            if record:
                samp = st.metric_sample(cur)
                ser_t[i] = t
                ser_jq[i] = samp.jobs_in_queue
                ser_avg[i] = samp.avg_wait_ms
            if has_arr[i]:
                sig = None
                continue
            sig_before, sig = sig, _quiescence_sig(cur)
            probe = torch.stack([
                self.ex.alland((sig == sig_before).all()).to(I32),
                self.ex.allmin(_next_event_t(cur, t, cfg, params, member))])
            quiet, ev = probe.tolist()
            self.probe_reads += 1
            if not quiet:
                continue
            ev_clock = (min(ev, inf_t) + tick - 1) // tick * tick
            arr_clock = t0 + (int(next_arr[i + 1]) + 1) * tick
            new_t = max(min(ev_clock, arr_clock, inf_t) - tick, t)
            n_skip = (new_t - t) // tick
            if member.kind != "fifo":  # FIFO's pass records no wait
                leapt, rate = _leap_local(cur, new_t, cfg, self.pset,
                                          params, member)
                if record and n_skip:  # the skipped samples' accrual
                    k = torch.arange(1, n_skip + 1, device=dev,
                                     dtype=torch.float32)[:, None]
                    totals = cur.wait_total[None, :] + k * rate[None, :]
                    ser_avg[i + 1:i + 1 + n_skip] = torch.where(
                        cur.wait_jobs[None, :] > 0,
                        totals / cur.wait_jobs.clamp(min=1)[None, :], 0.0)
                cur = _write_back(cur, leapt)
            elif record and n_skip:
                ser_avg[i + 1:i + 1 + n_skip] = ser_avg[i]
            if record and n_skip:
                ser_t[i + 1:i + 1 + n_skip] = torch.arange(
                    t + tick, new_t + tick, tick, dtype=I32, device=dev)
                ser_jq[i + 1:i + 1 + n_skip] = ser_jq[i]
            cur.t.fill_(new_t)
            t = new_t
            if obs is not None:  # in place: the tap form keeps its operands
                mb, cur_obs = obs_device.tap_leap(obs[0], obs[1], cur,
                                                  n_skip, tick)
                obs = (_write_back(obs[0], mb), _write_back(obs[1], cur_obs))
            if n_skip:
                leaps[obs_device.leap_bucket(n_skip)] += 1
        state = _write_back(state, cur)
        stats = st.leap_stats_init(dev)
        stats.ticks_executed.fill_(executed)
        stats.leaps.copy_(torch.from_numpy(leaps))
        out = (state,)
        if record:
            out += (st.MetricSample(t=ser_t, jobs_in_queue=ser_jq,
                                    avg_wait_ms=ser_avg),)
        out += (stats,)
        if mbuf is not None:
            out += (_write_back(mbuf, obs[0]),)
        return out

    def _run_compressed_lanes(self, state: SimState,
                              arrivals: st.TickArrivals, n_ticks: int,
                              params=None, mbuf=None):
        """``run_compressed`` over a lane-stacked state, lane by lane: each
        lane leaps its own quiescent gaps, as the reference's batched
        ``while_loop`` masks finished lanes, so the lanes leave lockstep.
        Each lane is the standalone compressed run on the lane's views
        (its kernel launched once per executed tick over that lane's C
        clusters). Returns what ``run_compressed`` does, every part
        stacked on the lane axis."""
        params = self._params(params)
        L = self.lanes_of(state, params)
        params = self.lane_params(params, L)
        outs = []
        for i in range(L):
            ta = st.TickArrivals(rows=arrivals.rows[i],
                                 counts=arrivals.counts[i])
            outs.append(self.run_compressed(
                fused_tick.lane(state, i), ta, n_ticks,
                fused_tick.lane(params, i),
                None if mbuf is None else fused_tick.lane(mbuf, i)))
        out = (state,)
        for k in range(1, len(outs[0])):
            if mbuf is not None and k == len(outs[0]) - 1:
                out += (mbuf,)  # the lanes' views, updated in place
                continue
            parts = [o[k] for o in outs]
            out += (type(parts[0])(**{
                f.name: torch.stack([getattr(x, f.name) for x in parts])
                for f in dataclasses.fields(parts[0])}),)
        return out
