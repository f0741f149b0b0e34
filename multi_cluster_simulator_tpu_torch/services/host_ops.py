"""Device-boundary state ops for the live service hosts (the port of
``multi_cluster_simulator_tpu/services/host_ops.py``).

A live scheduler host owns a C=1 ``SimState`` on the device and advances it
with ``Engine.tick_io``. Between ticks, HTTP/gRPC handlers must mutate that
state the way the reference's handlers mutate the Go scheduler's queues —
append to LentQueue on ``/borrow`` (pkg/scheduler/server.go:94-107), remove
from BorrowedQueue on ``/lent`` (server.go:115-137), carve lender capacity on
``ProvideVirtualNode`` (cluster.go:87-125), attach a virtual node on
``ReceiveVirtualNode`` (cluster.go:65-85). Each such mutation is one small
function of PyTorch ops here, on the state's device: host threads hold a
lock, call the op, and swap the state reference.

Every op is pure: it returns a new ``SimState`` whose changed leaves are new
tensors and leaves its input as it was, so a handler's op never writes into
a state a tick is reading (the engine's ticks advance a state in place; the
live host ticks a clone). The ops act on cluster 0 (the live host's only
cluster), the ``*_at`` forms on cluster ``c`` of a multi-cluster serving
state. Job vectors are packed ``[NF]`` int32 rows (``job_vec``).
"""

from __future__ import annotations

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.core.spec import CORES, GPU, MEM
from multi_cluster_simulator_tpu_torch.core.state import SimState
from multi_cluster_simulator_tpu_torch.market.trader import (
    FOREIGN, PLACEHOLDER_ID,
)
from multi_cluster_simulator_tpu_torch.ops import carve as carve_ops
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops import placement as P
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R

I32 = torch.int32


def job_vec(id=-1, cores=0, mem=0, gpu=0, dur=0, enq_t=0, owner=Q.OWN,
            rec_wait=0, jclass=None, retries=0) -> np.ndarray:
    """One job as a packed [NF] int32 row in the canonical field order
    (the reference's ``JobRec.make(...).vec``)."""
    if jclass is None:
        jclass = int(F.job_class(int(cores), int(gpu)))
    return np.array([id, cores, mem, gpu, dur, enq_t, owner, rec_wait,
                     jclass, retries], np.int32)


def _vec(state: SimState, vec) -> torch.Tensor:
    """``vec`` [NF] as a [C, NF] int32 tensor on the state's device."""
    v = torch.as_tensor(np.array(vec, np.int32), device=state.device)
    return v.expand(state.arr_ptr.shape[0], Q.NF)


def _at(state: SimState, c: int) -> torch.Tensor:
    """[C] bool, True at cluster ``c`` only."""
    C = state.arr_ptr.shape[0]
    return torch.arange(C, device=state.device) == int(c)


def lend_feasible(state: SimState, cores, mem) -> torch.Tensor:
    """The /borrow handler's Lend() probe (scheduler.go:194-202): any node
    with strictly more free cores AND memory."""
    job = Q.JobRec(vec=torch.as_tensor(job_vec(cores=cores, mem=mem),
                                       device=state.device))
    return P.can_lend(state.node_free[0], state.node_active[0], job)


def push_lent(state: SimState, job) -> SimState:
    """Append a foreign job to the LentQueue (server.go:94-107). The host
    sets the row's owner field to its borrower-table index beforehand."""
    return state.replace(lent=Q.push_back(
        state.lent, Q.JobRec(vec=_vec(state, job)), _at(state, 0)))


def push_ready_at(state: SimState, job, c: int) -> SimState:
    """POST / under a non-FIFO algorithm, at cluster ``c``: the reference's
    handler appends to the ReadyQueue regardless of the configured
    algorithm (server.go:23-51), and the Delay() loop then never drains it
    — the job sits forever. A full queue counts into ``drops.queue``."""
    do = _at(state, c)
    dropped = Q.push_back_dropped(state.ready, do)
    return state.replace(
        ready=Q.push_back(state.ready, Q.JobRec(vec=_vec(state, job)), do),
        drops=state.drops.replace(queue=state.drops.queue + dropped))


def push_l0_at(state: SimState, job, c: int) -> SimState:
    """POST /delay under FIFO, at cluster ``c``: Level0 append + wait-timer
    start + jobs_in_queue increment (server.go:53-78 runs for any
    algorithm); the Fifo() loop never drains Level0 — the job sits
    forever, but its counters still move exactly as in Go."""
    do = _at(state, c)
    dropped = Q.push_back_dropped(state.l0, do)
    took = do.to(I32) - dropped
    return state.replace(
        l0=Q.push_back(state.l0, Q.JobRec(vec=_vec(state, job)), do),
        wait_jobs=state.wait_jobs + took,
        jobs_in_queue=state.jobs_in_queue + took,
        drops=state.drops.replace(queue=state.drops.queue + dropped))


def push_ready(state: SimState, job) -> SimState:
    """``push_ready_at`` on the live host's cluster 0."""
    return push_ready_at(state, job, 0)


def push_l0(state: SimState, job) -> SimState:
    """``push_l0_at`` on the live host's cluster 0."""
    return push_l0_at(state, job, 0)


def remove_borrowed(state: SimState, job) -> SimState:
    """The /lent handler (server.go:115-137): a returned finished job is
    removed from the BorrowedQueue by field equality (cluster 0; the C=1
    host has no other)."""
    return state.replace(borrowed=Q.remove_matching(
        state.borrowed, Q.JobRec(vec=_vec(state, job))))


def commit_borrow(state: SimState, job) -> SimState:
    """Borrower side of a successful /borrow round (scheduler.go:239-242):
    pop the wait head (gated on it still being the same job) and append it
    to the BorrowedQueue."""
    rec = Q.JobRec(vec=_vec(state, job))
    do = _at(state, 0) & (state.wait.count > 0) \
        & (Q.head(state.wait).id == rec.id)
    return state.replace(wait=Q.pop_front(state.wait, do),
                         borrowed=Q.push_back(state.borrowed, rec, do))


def carve_occupy(state: SimState, cores, mem, dur_ms,
                 mode: str = "asbuilt") -> tuple[SimState, torch.Tensor]:
    """Lender side of ApproveContract: AllocateVirtualNodeResources
    (cluster.go:87-125) — plan per-node carve amounts, subtract them from
    free, and occupy them as Foreign placeholder running jobs for the
    contract duration, node by node into the first inactive running slot
    (a node whose slot search finds none keeps its free decrement, as in
    the reference). Returns (state', ok) with ``ok`` a 0-d bool."""
    dev = state.device
    C = state.arr_ptr.shape[0]
    req = lambda v: torch.full((C,), int(v), dtype=I32, device=dev)  # noqa
    amounts, ok = carve_ops.carve_plan(
        state.node_free, state.node_active, req(cores), req(mem), req(0),
        mode=mode)
    on = _at(state, 0) & ok
    free = state.node_free - torch.where(on[:, None, None], amounts, 0)
    t = state.t.to(I32)
    dur = torch.tensor(int(dur_ms), dtype=I32, device=dev)
    run = state.run
    S = run.active.shape[1]
    slots = torch.arange(S, device=dev)
    for n in range(amounts.shape[1]):
        a = amounts[:, n]  # [C, R]
        occ = on & (a > 0).any(-1)
        slot = run.active.to(torch.uint8).argmin(1)  # first inactive
        okk = occ & ~run.active.gather(1, slot[:, None])[:, 0]
        hot = (slots[None, :] == slot[:, None]) & okk[:, None]
        row = R.make_row(
            (t + dur).expand(C), torch.full((C,), n, dtype=I32, device=dev),
            a[:, CORES], a[:, MEM], a[:, GPU] if a.shape[1] > GPU
            else torch.zeros(C, dtype=I32, device=dev),
            req(PLACEHOLDER_ID), req(FOREIGN), dur.expand(C), t.expand(C),
            req(0))
        run = R.insert_row(run, hot, row)
    return state.replace(node_free=free, run=run), ok[0]


def add_virtual_node(state: SimState, cores, mem, dur_ms, vstart: int,
                     expire: bool = False) -> tuple[SimState, torch.Tensor]:
    """Borrower side: AddVirtualNode (cluster.go:65-85) — activate the
    first free virtual node slot of cluster 0 with the contract's capacity.
    The reference never removes virtual nodes; ``expire=True`` arms the
    engine's expiry phase instead (config.trader.expire_virtual_nodes).
    A DOWN slot (fault plane: inactive but unhealthy) is parked for
    repair, not vacant. Returns (state', ok) with ``ok`` a 0-d bool."""
    dev = state.device
    N = state.node_cap.shape[1]
    nidx = torch.arange(N, device=dev)
    slot_free = (nidx >= vstart)[None, :] & ~state.node_active \
        & state.faults.health & _at(state, 0)[:, None]
    slot = slot_free.to(torch.uint8).argmax(1)  # the first free slot
    ok = slot_free.any(1)
    hot = (nidx[None, :] == slot[:, None]) & ok[:, None]  # [C, N]
    newcap = torch.tensor([int(cores), int(mem), 0][:state.node_cap.shape[2]],
                          dtype=state.node_cap.dtype, device=dev)
    exp_val = (state.t.to(I32) + int(dur_ms)) if expire else \
        torch.tensor(R.NEVER, dtype=I32, device=dev)
    return state.replace(
        node_cap=torch.where(hot[..., None], newcap, state.node_cap),
        node_free=torch.where(hot[..., None], newcap.to(state.node_free.dtype),
                              state.node_free),
        node_active=state.node_active | hot,
        node_expire=torch.where(hot, exp_val.to(state.node_expire.dtype),
                                state.node_expire)), ok[0]


def rebase_arrivals(state: SimState, shift) -> SimState:
    """Shift the arrival cursor left by ``shift`` — the host compacted its
    arrival ring by dropping ``shift`` consumed entries from the front."""
    return state.replace(arr_ptr=(state.arr_ptr - int(shift)).clamp(min=0))
