"""The scheduling passes of the policy zoo as plain PyTorch ops, batched
over clusters.

The port of ``multi_cluster_simulator_tpu/policies/kernels.py``: the
wait-head / ready-drain / lent best-effort pass of Fifo()
(pkg/scheduler/scheduler.go:216-296); Delay() (scheduler.go:298-369), its
serial Level1 sweep with the parity-mode remove-then-skip quirk and its
speculative-wave form, both followed by the Level0-head attempt and
promotion; and the serial Level0 sweep ``_scored_sweep_local`` behind the
first-fit-decreasing bin-pack (``_ffd_local``, and its wave form
``_ffd_wave_local``) and the scored kinds gavel, tesserae and rl, which
pick each job's node by an f32 score (``P.best_scored_fit``). The
reference writes each function for one cluster and ``vmap``s it; here
every function takes the cluster axis [C] explicitly.

Two rewrites keep the batched form exact:

- ``jax.lax.while_loop`` under ``vmap`` runs until no cluster's condition
  holds, leaving the carry of finished clusters untouched. The drains and
  waves here run a FIXED ``QC`` iterations with each cluster's carry
  updated only while its own condition holds. That is the same function:
  every serial step consumes one queue position, and every wave either
  resolves at least one row or stops the cluster (``_fifo_drain_wave``),
  so no cluster needs more than ``QC`` iterations. The wave drain stops
  early, with one host read a pass, once no cluster's condition holds:
  every later pass would change nothing (parity mode's 256-deep ready
  queues make ``QC`` passes dear). The serial Level0 and Level1 sweeps,
  whose ``QC`` is the whole queue in parity mode, run the largest sweep
  length over the clusters instead, as the reference's loop does (one
  host read of it per sweep).
- one-hot integer contractions become ``where``/``gather``/``scatter`` and
  int32 broadcast-multiply-sums, which CUDA supports (it has no integer
  matmul) and which give the same integers; the one-hot f32 lookups of a
  score matrix become a gather, exact for finite scores.

The floats. ``wait_total`` (f32): the serial sweeps add each processed
job's wait delta in sweep order, as the reference does. The wave forms add
the tick's deltas once, as the reference's ``delta.sum()``; here the sum
is taken exactly in int64 and rounded once, which equals the reference's
f32 reduction whenever its partial sums stay below 2^24 ms (4.6 hours of
wait in one tick), and makes the sum independent of reduction order. The
tesserae score is a three-term f32 dot product; XLA's CPU dot rounds the
first product and adds each later one by a fused multiply-add, and
``_tesserae_scores`` takes exactly that order (``fma_f32``).

These are the plain versions the CUDA kernels (kernels/csrc/
fused_prefix_*.cu) are held against, and what the port runs on the CPU.
"""

from __future__ import annotations

import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.state import SimState, Trace
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops.floats import fma_f32
from multi_cluster_simulator_tpu_torch.ops import placement as P
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.ops.queues import I32, icumsum, isum


def _trace_append(tr: Trace, do: torch.Tensor, t: int, job_id: torch.Tensor,
                  node: torch.Tensor, src: int) -> Trace:
    """Per-cluster capped event append: cluster ``c`` writes slot
    ``n[c]`` where ``do[c]`` and the ring has room."""
    cap = tr.t.shape[-1]
    ok = do & (tr.n < cap)
    i = torch.clamp(tr.n, 0, cap - 1).long()[:, None]  # [C, 1]

    def w(a, v):
        old = torch.gather(a, 1, i)[:, 0]
        return a.scatter(1, i, torch.where(ok, v, old)[:, None])

    t_v = torch.full_like(job_id, t)
    src_v = torch.full_like(job_id, src)
    return Trace(t=w(tr.t, t_v), job=w(tr.job, job_id), node=w(tr.node, node),
                 src=w(tr.src, src_v), n=tr.n + ok.to(I32))


def _trace_append_many(tr: Trace, take: torch.Tensor, t: int,
                       job_ids: torch.Tensor, nodes: torch.Tensor,
                       src: int) -> Trace:
    """Append events for positions where ``take`` [C, K], in position
    order: the k-th taken event of cluster ``c`` lands at ``n[c] + k`` while
    that is inside the ring, as appending them one by one does. One
    scatter per field; events past the ring go to a spare column that is
    cut off."""
    C, cap = tr.t.shape
    take_i = take.to(I32)
    pos = tr.n[:, None] + icumsum(take_i, 1) - take_i
    ok = take & (pos < cap)
    idx = torch.where(ok, pos, cap).long()

    def w(a, v):
        wide = torch.cat([a, a.new_zeros(C, 1)], dim=1)
        return wide.scatter(1, idx, v)[:, :cap].contiguous()

    return Trace(t=w(tr.t, torch.full_like(job_ids, t)),
                 job=w(tr.job, job_ids), node=w(tr.node, nodes),
                 src=w(tr.src, torch.full_like(job_ids, src)),
                 n=tr.n + isum(ok, 1))


def _attempt(s: SimState, job: Q.JobRec, t: int, do: torch.Tensor, src: int,
             record_trace: bool):
    """One ScheduleJob(j) attempt per cluster (scheduler.go:127-139):
    ``_attempt_deferred`` with a one-row buffer flushed at once."""
    n_active = isum(s.run.active, 1)
    C = job.vec.shape[0]
    buf = torch.zeros((C, 1, R.RF), dtype=I32, device=job.vec.device)
    cnt = torch.zeros((C,), dtype=I32, device=job.vec.device)
    s, success, buf, cnt, node = _attempt_deferred(s, job, t, do, buf, cnt,
                                                   n_active)
    if record_trace:
        s = s.replace(trace=_trace_append(s.trace, success, t, job.id, node,
                                          src))
    return s.replace(run=R.start_many(s.run, buf, cnt)), success


def _attempt_deferred(s: SimState, job: Q.JobRec, t: int, do: torch.Tensor,
                      buf: torch.Tensor, cnt: torch.Tensor,
                      n_active: torch.Tensor, node=None):
    """``_attempt`` for the sweep loops: the placed row lands in ``buf``
    [C, SW, RF] at position ``cnt`` and the caller flushes the batch with
    ``R.start_many``; ``n_active + cnt`` reproduces the sequential
    has-slot check. ``node`` [C] overrides the first-fit pick (the scored
    kinds pass ``P.best_scored_fit``'s). The caller traces the placement:
    it gets ``(state, success, buf, cnt, node)``, and a sweep appends its
    events once, after the loop (``_trace_events``)."""
    if node is None:
        node = P.first_fit(s.node_free, s.node_active, job)
    has_slot = (n_active + cnt) < s.run.capacity
    success = do & has_slot & (node >= 0)
    free = P.occupy(s.node_free, node, job, success)
    row = R.row_from_job(job, node, t)  # [C, RF]
    hot = (torch.arange(buf.shape[1], dtype=I32, device=buf.device)
           == cnt[:, None]) & success[:, None]
    buf = torch.where(hot[..., None], row[:, None, :], buf)
    cnt = cnt + success.to(I32)
    run_full = do & (node >= 0) & ~has_slot
    drops = s.drops.replace(run_full=s.drops.run_full + run_full.to(I32))
    s = s.replace(node_free=free, drops=drops,
                  placed_total=s.placed_total + success.to(I32))
    return s, success, buf, cnt, node


def _trace_events(s: SimState, cfg: SimConfig, events: list, t: int,
                  src: int) -> SimState:
    """Trace a sweep's attempts, ``events`` a list of (success, job id,
    node) [C] per step, in step order — what tracing each attempt as it
    happened gives, since nothing else traces inside a sweep."""
    if not cfg.record_trace or not events:
        return s
    success, ids, nodes = (torch.stack(x, dim=1) for x in zip(*events))
    return s.replace(trace=_trace_append_many(s.trace, success, t, ids,
                                              nodes, src))


def _sweep_len(cfg: SimConfig) -> int:
    """Per-tick placement-sweep length: the whole queue in parity mode, the
    fast-mode cap otherwise."""
    if cfg.parity:
        return cfg.queue_capacity
    return min(cfg.queue_capacity, cfg.max_placements_per_tick)


def _record_wait(total, rec_wait, enq_t, t: int, do):
    """JobsMap bookkeeping on a scheduling attempt (scheduler.go:309-312):
    TotalTime -= map[id]; map[id] = since(enqueue); TotalTime += map[id].
    All [C]; ``total`` f32, the rest int32."""
    cur = t - enq_t
    delta = torch.where(do, (cur - rec_wait).to(torch.float32), 0.0)
    return total + delta, torch.where(do, cur, rec_wait)


def _bfd_order(q, params) -> torch.Tensor:
    """Best-fit-decreasing slot order [C, Q] with the FFD tie-break as
    data: ``params.ffd_mem_first`` (a 0-d tensor, read without a host
    sync) swaps the (cores, mem) sort-key priority. ``params=None`` is
    ``P.best_fit_decreasing_order``."""
    valid = q.slot_valid()
    if params is None:
        return P.best_fit_decreasing_order(q.cores, q.mem, valid)
    mem_first = params.ffd_mem_first > 0
    primary = torch.where(valid, torch.where(mem_first, -q.mem, -q.cores),
                          P.BIG)
    secondary = torch.where(valid, torch.where(mem_first, -q.cores, -q.mem),
                            P.BIG)
    return P.lexsort(secondary, primary)


def _max_wait_ms(cfg: SimConfig, params):
    """The DELAY Level0->Level1 promotion threshold: the policy parameter
    (a 0-d int32 tensor) when params are given, the config's otherwise, so
    ``delay-eager`` and ``delay-patient`` are data, not code."""
    if params is None:
        return cfg.max_wait_ms
    return params.max_wait_ms


# --------------------------------------------------------------------------
# DELAY — the reference's live algorithm
# --------------------------------------------------------------------------

def _delay_local(s: SimState, t: int, cfg: SimConfig, params=None):
    """Delay() (scheduler.go:298-369), the serial Level1 sweep: the first
    ``min(|L1|, QC)`` slots in queue order, each recording its wait and
    making one deferred attempt; in parity mode a success skips the next
    slot (Go removes L1[i] in place and ``i++`` passes over the element
    that slid into position i, scheduler.go:319). Then the processed
    slots' rec_wait is rewritten, the placed slots are compacted out, the
    placements flushed into the running set, and the Level0 head runs."""
    QC = _sweep_len(cfg)
    C = s.l1.count.shape[0]
    dev = s.l1.device
    n_sweep = torch.clamp(s.l1.count, max=QC)
    n_active = isum(s.run.active, 1)
    rows = Q.rows_of(s.l1)  # the loop changes no Level1 row but rec_wait
    rec = s.l1.rec_wait.clone()
    placed = torch.zeros((C, s.l1.capacity), dtype=torch.bool, device=dev)
    skip_next = torch.zeros((C,), dtype=torch.bool, device=dev)
    buf = torch.zeros((C, QC, R.RF), dtype=I32, device=dev)
    cnt = torch.zeros((C,), dtype=I32, device=dev)
    events = []
    for i in range(int(n_sweep.max()) if C else 0):
        process = (i < n_sweep) & ~skip_next
        vec = rows[:, i].clone()
        vec[:, Q.FREC] = rec[:, i]
        job = Q.JobRec(vec=vec)
        total, rec[:, i] = _record_wait(s.wait_total, rec[:, i], job.enq_t,
                                        t, process)
        s = s.replace(wait_total=total)
        s, success, buf, cnt, node = _attempt_deferred(
            s, job, t, process, buf, cnt, n_active)
        s = s.replace(jobs_in_queue=s.jobs_in_queue - success.to(I32))
        placed[:, i] |= success
        events.append((success, job.id, node))
        if cfg.parity:
            skip_next = success
    s = _trace_events(s, cfg, events, t, st.SRC_L1)
    l1 = Q.compact(Q.set_field(s.l1, "rec_wait", rec), ~placed)
    s = s.replace(l1=l1, run=R.start_many(s.run, buf, cnt))
    return _delay_l0_head(s, t, cfg, params)


def _delay_l0_head(s: SimState, t: int, cfg: SimConfig, params=None):
    """The Level0-head half of Delay() (scheduler.go:332-366): record the
    head's wait and make one immediate attempt; on failure promote it to
    Level1 once ``t - enq_t >= max_wait_ms``. The head is popped on success
    or promotion; a promotion into a full Level1 counts into
    ``drops.queue`` and the job is popped anyway."""
    process = s.l0.count > 0
    head = Q.head(s.l0)
    total, new_rec = _record_wait(s.wait_total, head.rec_wait, head.enq_t, t,
                                  process)
    s = s.replace(wait_total=total,
                  l0=Q.set_field_elem(s.l0, "rec_wait", 0, new_rec))
    vec = head.vec.clone()
    vec[:, Q.FREC] = new_rec
    job = Q.JobRec(vec=vec)
    s, success = _attempt(s, job, t, process, st.SRC_L0, cfg.record_trace)
    s = s.replace(jobs_in_queue=s.jobs_in_queue - success.to(I32))
    promote = (process & ~success
               & ((t - job.enq_t) >= _max_wait_ms(cfg, params)))
    return s.replace(
        l0=Q.pop_front(s.l0, success | promote),
        l1=Q.push_back(s.l1, job, promote),
        drops=s.drops.replace(
            queue=s.drops.queue + Q.push_back_dropped(s.l1, promote)))


def _delay_wave_local(s: SimState, t: int, cfg: SimConfig, params=None):
    """Fast-mode Delay(): the Level1 sweep as speculative waves
    (``_wave_place``; the same placements as the serial sweep without the
    parity skip), its wait accounting once per tick at the slot level (an
    exact integer sum, rounded once: see the module docstring), then the
    Level0 head."""
    QC = min(cfg.queue_capacity, cfg.max_placements_per_tick)
    cap = s.l1.capacity
    dev = s.l1.device
    n_sweep = torch.clamp(s.l1.count, max=QC)
    n_active = isum(s.run.active, 1)
    act0 = torch.arange(QC, dtype=I32, device=dev)[None, :] < n_sweep[:, None]
    jobs = Q.JobRec(vec=Q.rows_prefix(s.l1, QC))  # sweep order: queue order

    processed_slot = (torch.arange(cap, dtype=I32, device=dev)[None, :]
                      < n_sweep[:, None])
    cur = t - s.l1.enq_t
    frec = s.l1.rec_wait
    delta = torch.where(processed_slot, cur - frec, 0)
    wait_total = s.wait_total + delta.sum(dim=1).to(torch.float32)
    l1 = Q.set_field(s.l1, "rec_wait", torch.where(processed_slot, cur, frec))
    s = s.replace(wait_total=wait_total, l1=l1)

    free, node_sel, cnt, run_full = _wave_place(
        s.node_free, s.node_active, s.run.capacity, n_active, jobs, act0)
    placed_pos = node_sel >= 0  # [C, QC]: position == slot
    buf = _placed_buffer(jobs, node_sel, t)
    trace = s.trace
    if cfg.record_trace:
        trace = _trace_append_many(trace, placed_pos, t, jobs.id, node_sel,
                                   st.SRC_L1)
    placed_slot = torch.nn.functional.pad(placed_pos, (0, cap - QC))
    s = s.replace(
        node_free=free, trace=trace,
        drops=s.drops.replace(run_full=s.drops.run_full + run_full),
        placed_total=s.placed_total + cnt,
        jobs_in_queue=s.jobs_in_queue - cnt,
        l1=Q.compact(s.l1, ~placed_slot),
        run=R.start_many(s.run, buf, cnt))
    return _delay_l0_head(s, t, cfg, params)


# --------------------------------------------------------------------------
# speculative-wave machinery
# --------------------------------------------------------------------------

def _wave_probe(free, node_active, jobs: Q.JobRec, active):
    """First-fit targets and cumulative same-target overflow for the active
    rows under the current ``free`` (the reference's docstring has the
    equivalence argument). ``free`` [C, N, R], ``node_active`` [C, N],
    ``jobs`` [C, QC, NF], ``active`` [C, QC]. Returns ``(feas_any, tgt,
    tgt_hot, overflow)`` with ``tgt_hot`` an int32 [C, QC, N] one-hot."""
    feas = P.feasible(free[:, None], node_active[:, None], jobs.cores,
                      jobs.mem, jobs.gpu)  # [C, QC, N]
    feas = feas & active[..., None]
    feas_any = feas.any(dim=-1)
    tgt = P.first_index(feas)
    n_nodes = feas.shape[-1]
    tgt_hot = (feas_any[..., None]
               & (tgt[..., None] == torch.arange(n_nodes, dtype=I32,
                                                 device=feas.device))
               ).to(I32)
    res = jobs.res[..., : free.shape[-1]]  # [C, QC, R]
    cum = icumsum(tgt_hot[..., None] * res[:, :, None, :], 1)  # [C,QC,N,R]
    group_dem = isum(tgt_hot[..., None] * cum, 2)  # [C, QC, R]
    tgt_free = isum(tgt_hot[..., None] * free[:, None], 2)
    overflow = feas_any & (group_dem > tgt_free).any(dim=-1)
    return feas_any, tgt, tgt_hot, overflow


def _wave_occupy(free, tgt_hot, place, jobs: Q.JobRec):
    """Subtract the accepted rows' resources from ``free``."""
    res = jobs.res[..., : free.shape[-1]]  # [C, QC, R]
    used = isum((tgt_hot * place[..., None].to(I32))[..., None]
                * res[:, :, None, :], 1)  # [C, N, R]
    return free - used


def _placed_buffer(jobs: Q.JobRec, node_sel: torch.Tensor, t: int):
    """The running rows of the placed positions (``node_sel >= 0``), in
    position order at the front of a [C, QC, RF] buffer, zeros behind."""
    all_rows = R.row_from_job(jobs, node_sel, t)  # [C, QC, RF]
    return Q.compact_rows(all_rows, node_sel >= 0,
                          all_rows.new_zeros(R.RF))


def _fifo_drain_wave(s: SimState, t: int, cfg: SimConfig,
                     wait_active: torch.Tensor, n_active: torch.Tensor,
                     QC: int):
    """The FIFO ready drain (place from the head until the first failure)
    as speculative waves, ``QC`` masked iterations. Returns
    ``(s, n_taken, fail_job, stopped, buf, cnt)``."""
    ready = s.ready
    C = ready.count.shape[0]
    dev = ready.device
    n_sweep = torch.where(wait_active, 0, torch.clamp(ready.count, max=QC))
    pos = torch.arange(QC, dtype=I32, device=dev)
    act0 = pos[None, :] < n_sweep[:, None]
    rows = Q.rows_prefix(ready, QC)  # queue order: position == slot
    jobs = Q.JobRec(vec=rows)
    S = s.run.capacity

    free = s.node_free
    resolved = ~act0
    node_sel = torch.full((C, QC), P.NO_NODE, dtype=I32, device=dev)
    cnt = torch.zeros((C,), dtype=I32, device=dev)
    run_full = torch.zeros((C,), dtype=I32, device=dev)
    stopped = torch.zeros((C,), dtype=torch.bool, device=dev)
    fail_idx = torch.full((C,), -1, dtype=I32, device=dev)
    for _ in range(QC):
        go = ~stopped & (act0 & ~resolved).any(dim=1)  # the loop's cond
        if not bool(go.any()):  # a host read: every later pass is a no-op
            break
        active = act0 & ~resolved
        feas_any, tgt, tgt_hot, overflow = _wave_probe(free, s.node_active,
                                                       jobs, active)
        infeas = active & ~feas_any
        cand = feas_any & ~overflow
        cand_i = cand.to(I32)
        r = icumsum(cand_i, 1) - cand_i
        cap_left = S - n_active - cnt
        slotviol = cand & (r >= cap_left[:, None])
        breaker = overflow | infeas | slotviol
        before_break = icumsum(breaker.to(I32), 1) == 0
        place = cand & before_break & go[:, None]
        any_break = breaker.any(dim=1)
        b = P.first_index(breaker)
        b_hot = (pos[None, :] == b[:, None]) & any_break[:, None]
        failed = any_break & ((b_hot & infeas).any(dim=1)
                              | (b_hot & slotviol).any(dim=1)) & go
        run_full = run_full + ((b_hot & slotviol).any(dim=1) & go).to(I32)
        resolved = resolved | place | (b_hot & failed[:, None])
        free = _wave_occupy(free, tgt_hot, place, jobs)
        node_sel = torch.where(place, tgt, node_sel)
        cnt = cnt + isum(place, 1)
        stopped = stopped | failed
        fail_idx = torch.where(failed, b, fail_idx)

    placed_pos = node_sel >= 0
    n_taken = cnt + stopped.to(I32)  # pops include the failure
    fhot = pos[None, :] == fail_idx[:, None]
    fail_job = Q.JobRec(vec=isum(fhot.to(I32)[..., None] * rows, 1))
    buf = _placed_buffer(jobs, node_sel, t)
    trace = s.trace
    if cfg.record_trace:
        trace = _trace_append_many(trace, placed_pos, t, jobs.id, node_sel,
                                   st.SRC_READY)
    s = s.replace(node_free=free, trace=trace,
                  drops=s.drops.replace(run_full=s.drops.run_full + run_full),
                  placed_total=s.placed_total + cnt)
    return s, n_taken, fail_job, stopped, buf, cnt


def _fifo_drain_serial(s: SimState, t: int, cfg: SimConfig,
                       wait_active: torch.Tensor, n_active: torch.Tensor,
                       QC: int):
    """The one-job-per-step ready drain (the reference's ``dstep`` loop),
    ``QC`` masked steps. Same return shape as ``_fifo_drain_wave``."""
    C = s.ready.count.shape[0]
    dev = s.ready.device
    stopped = torch.zeros((C,), dtype=torch.bool, device=dev)
    n_taken = torch.zeros((C,), dtype=I32, device=dev)
    fail_job = Q.invalid_row(dev).expand(C, Q.NF).clone()
    any_fail = torch.zeros((C,), dtype=torch.bool, device=dev)
    buf = torch.zeros((C, QC, R.RF), dtype=I32, device=dev)
    cnt = torch.zeros((C,), dtype=I32, device=dev)
    slots = torch.arange(s.ready.capacity, dtype=I32, device=dev)
    limit = torch.clamp(s.ready.count, max=QC)
    events = []
    for i in range(QC):
        process = ~wait_active & (i < limit) & ~stopped
        job = Q.select_row(s.ready, (slots == i)[None, :].expand(C, -1))
        s, success, buf, cnt, node = _attempt_deferred(
            s, job, t, process, buf, cnt, n_active)
        events.append((success, job.id, node))
        fail = process & ~success
        n_taken = n_taken + process.to(I32)  # pops regardless of outcome
        fail_job = torch.where(fail[:, None], job.vec, fail_job)
        stopped = stopped | fail
        any_fail = any_fail | fail
    s = _trace_events(s, cfg, events, t, st.SRC_READY)
    return s, n_taken, Q.JobRec(vec=fail_job), any_fail, buf, cnt


def _fifo_local(s: SimState, t: int, cfg: SimConfig):
    """Fifo() (scheduler.go:216-296) as ordered masked phases, every
    cluster at once. Returns ``(state, borrow_want, borrow_job)``."""
    QC = _sweep_len(cfg)
    wait_active = s.wait.count > 0

    # ---- ready drain (only when the wait queue is empty): place from the
    # head until the first failure; the failing job moves to WaitQueue ----
    n_active = isum(s.run.active, 1)
    drain = (_fifo_drain_wave if cfg.fifo_drain == "wave"
             else _fifo_drain_serial)
    s, n_taken, fail_job, any_fail, buf, cnt = drain(s, t, cfg, wait_active,
                                                     n_active, QC)
    # the drain consumes a strict prefix of the ready queue; its placements
    # flush into the set before the wait-head attempt reads occupancy. The
    # drop count reads the wait queue BEFORE the push.
    s = s.replace(run=R.start_many(s.run, buf, cnt),
                  ready=Q.pop_front_n(s.ready, n_taken),
                  wait=Q.push_back(s.wait, fail_job, any_fail),
                  drops=s.drops.replace(
                      queue=s.drops.queue
                      + Q.push_back_dropped(s.wait, any_fail)))

    # ---- wait-head attempt (the branch at scheduler.go:219-252) ----
    process_w = s.wait.count > 0
    wjob = Q.head(s.wait)
    s, wsuccess = _attempt(s, wjob, t, process_w, st.SRC_WAIT,
                           cfg.record_trace)
    s = s.replace(wait=Q.pop_front(s.wait, wsuccess))
    borrow_want = process_w & ~wsuccess
    if not cfg.borrowing:
        borrow_want = torch.zeros_like(process_w)

    # ---- lent best-effort (scheduler.go:277-291): reached only in a tick
    # where wait was empty and ready drained clean ----
    lent_ok = (~wait_active & ~any_fail & (s.ready.count == 0)
               & (s.lent.count > 0))
    ljob = Q.head(s.lent)
    s, lsuccess = _attempt(s, ljob, t, lent_ok, st.SRC_LENT, cfg.record_trace)
    s = s.replace(lent=Q.pop_front(s.lent, lsuccess))
    return s, borrow_want, wjob


# --------------------------------------------------------------------------
# FFD — first-fit-decreasing bin-pack over Level0
# --------------------------------------------------------------------------

def _scored_sweep_local(s: SimState, t: int, cfg: SimConfig, params,
                        order: torch.Tensor, score_fn=None):
    """The serial Level0 placement sweep over ``order`` [C, Q] behind FFD,
    gavel, tesserae and rl: per position, record the job's wait, pick a
    node, defer the RunningSet insertion; then compact Level0 and flush
    the placements. ``QC`` masked steps, each cluster active for its first
    ``min(|L0|, QC)`` positions (the reference's vmapped while loop).
    ``score_fn(state, job) -> [C, N] f32`` swaps the first-fit pick for
    ``P.best_scored_fit``; ``None`` keeps first fit."""
    QC = _sweep_len(cfg)
    C, cap = s.l0.count.shape[0], s.l0.capacity
    dev = s.l0.device
    n_sweep = torch.clamp(s.l0.count, max=QC)  # order puts valid slots first
    n_active = isum(s.run.active, 1)
    slots = torch.arange(cap, dtype=I32, device=dev)
    placed = torch.zeros((C, cap), dtype=torch.bool, device=dev)
    buf = torch.zeros((C, QC, R.RF), dtype=I32, device=dev)
    cnt = torch.zeros((C,), dtype=I32, device=dev)
    events = []
    for k in range(int(n_sweep.max()) if C else 0):
        process = k < n_sweep
        hot = slots[None, :] == order[:, k:k + 1]
        job = Q.select_row(s.l0, hot)
        total, new_rec = _record_wait(s.wait_total, job.rec_wait,
                                      job.enq_t, t, process)
        frec = torch.where(hot & process[:, None], new_rec[:, None],
                           s.l0.rec_wait)
        s = s.replace(wait_total=total,
                      l0=Q.set_field(s.l0, "rec_wait", frec))
        node = None if score_fn is None else P.best_scored_fit(
            s.node_free, s.node_active, job, score_fn(s, job))
        s, success, buf, cnt, node = _attempt_deferred(
            s, job, t, process, buf, cnt, n_active, node=node)
        s = s.replace(jobs_in_queue=s.jobs_in_queue - success.to(I32))
        placed = placed | (hot & success[:, None])
        events.append((success, job.id, node))
    s = _trace_events(s, cfg, events, t, st.SRC_L0)
    return s.replace(l0=Q.compact(s.l0, ~placed),
                     run=R.start_many(s.run, buf, cnt))


def _ffd_local(s: SimState, t: int, cfg: SimConfig, params=None):
    """First-fit-decreasing bin-pack over Level0: the BFD order and the
    shared serial sweep. Fast mode caps the sweep at
    ``max_placements_per_tick`` (largest jobs first)."""
    return _scored_sweep_local(s, t, cfg, params, _bfd_order(s.l0, params))


def _wave_place(free0, node_active, run_cap: int, n_active, jobs: Q.JobRec,
                act0):
    """Place ``jobs`` ([C, QC] rows in sweep order, active where ``act0``)
    by speculative conflict-free-prefix waves (the reference's
    ``_ffd_wave_local`` docstring has the equivalence argument). Every
    wave resolves at least the earliest unresolved row, so ``QC`` waves
    suffice, and a wave with nothing active changes nothing. Returns
    ``(free', node_sel [C, QC], cnt [C], run_full [C])``."""
    C, QC = act0.shape
    free = free0
    resolved = ~act0
    node_sel = torch.full((C, QC), P.NO_NODE, dtype=I32, device=act0.device)
    cnt = torch.zeros((C,), dtype=I32, device=act0.device)
    run_full = torch.zeros((C,), dtype=I32, device=act0.device)
    for _ in range(QC):
        active = act0 & ~resolved
        feas_any, tgt, tgt_hot, overflow = _wave_probe(free, node_active,
                                                       jobs, active)
        blocked = icumsum(overflow.to(I32), 1) > 0  # self included
        place_try = feas_any & ~blocked
        rank = icumsum(place_try.to(I32), 1) - 1
        has_slot = ((n_active + cnt)[:, None] + rank) < run_cap
        place = place_try & has_slot
        slot_full = place_try & ~has_slot
        # infeasible now is infeasible forever (free only shrinks); slot-
        # exhausted rows resolve too, counted as the serial sweep counts
        resolved = resolved | place | slot_full | (active & ~feas_any)
        free = _wave_occupy(free, tgt_hot, place, jobs)
        node_sel = torch.where(place, tgt, node_sel)
        cnt = cnt + isum(place, 1)
        run_full = run_full + isum(slot_full, 1)
    return free, node_sel, cnt, run_full


def _ffd_wave_local(s: SimState, t: int, cfg: SimConfig, params=None):
    """``_ffd_local`` as speculative placement waves: the same placements
    (the reference pins wave == serial, tests/test_kernel_equiv.py), with
    the wait accounting done once per tick at the slot level."""
    QC = min(cfg.queue_capacity, cfg.max_placements_per_tick)
    cap = s.l0.capacity
    dev = s.l0.device
    order = _bfd_order(s.l0, params)[:, :QC]  # [C, QC]
    n_sweep = torch.clamp(s.l0.count, max=QC)
    n_active = isum(s.run.active, 1)
    act0 = torch.arange(QC, dtype=I32, device=dev)[None, :] < n_sweep[:, None]
    sel = order[..., None] == torch.arange(cap, dtype=I32, device=dev)
    rows = Q.gather_rows(s.l0, sel)  # [C, QC, NF]
    jobs = Q.JobRec(vec=rows)

    # every processed job is recorded once per tick; the deltas add as one
    # exact integer sum, rounded to f32 once (see the module docstring)
    processed_slot = (sel & act0[..., None]).any(dim=1)  # [C, Q]
    cur = t - s.l0.enq_t
    frec = s.l0.rec_wait
    delta = torch.where(processed_slot, cur - frec, 0)
    wait_total = s.wait_total + delta.sum(dim=1).to(torch.float32)
    l0 = Q.set_field(s.l0, "rec_wait", torch.where(processed_slot, cur, frec))
    s = s.replace(wait_total=wait_total, l0=l0)

    free, node_sel, cnt, run_full = _wave_place(
        s.node_free, s.node_active, s.run.capacity, n_active, jobs, act0)
    placed_pos = node_sel >= 0  # [C, QC], in FFD order
    buf = _placed_buffer(jobs, node_sel, t)
    trace = s.trace
    if cfg.record_trace:
        trace = _trace_append_many(trace, placed_pos, t, jobs.id, node_sel,
                                   st.SRC_L0)
    placed_slot = (sel & placed_pos[..., None]).any(dim=1)
    return s.replace(
        node_free=free, trace=trace,
        drops=s.drops.replace(run_full=s.drops.run_full + run_full),
        placed_total=s.placed_total + cnt,
        jobs_in_queue=s.jobs_in_queue - cnt,
        l0=Q.compact(s.l0, ~placed_slot),
        run=R.start_many(s.run, buf, cnt))


# --------------------------------------------------------------------------
# the scored Level0 sweeps: gavel, tesserae, rl
# --------------------------------------------------------------------------

def _class_device_scores(node_type: torch.Tensor, jclass: torch.Tensor,
                         matrix: torch.Tensor) -> torch.Tensor:
    """[C, N] per-node score for each cluster's job of class ``jclass``
    [C]: entry ``[jclass, node_type]`` of the [N_JOB_CLASSES,
    N_DEVICE_TYPES] f32 ``matrix``, both indices clipped into range. The
    reference's one-hot f32 contractions are this lookup, exactly, for
    finite scores."""
    jc = torch.clamp(jclass, 0, F.N_JOB_CLASSES - 1).long()
    nt = torch.clamp(node_type, 0, F.N_DEVICE_TYPES - 1).long()
    return matrix.to(torch.float32)[jc[:, None], nt]


def _gavel_scores(node_type, jclass, params):
    """Gavel's node scores: the throughput matrix row of the job's class."""
    return _class_device_scores(node_type, jclass, params.gavel_tput)


def _tesserae_scores(node_free: torch.Tensor, job: Q.JobRec, params):
    """[C, N] packing-alignment score: ``sum_r f32(free[n, r]) *
    (f32(res[r]) * w[r])`` under ``params.tess_w``, in the order XLA's CPU
    dot takes it — the first product rounded, each later resource added
    by a fused multiply-add (tests/test_torch_scored.py holds this bitwise
    against the reference)."""
    n_res = node_free.shape[-1]
    rw = job.res[..., :n_res].to(torch.float32) \
        * params.tess_w[:n_res].to(torch.float32)  # [C, R]
    free = node_free.to(torch.float32)  # [C, N, R]
    score = free[..., 0] * rw[:, None, 0]
    for r in range(1, n_res):
        score = fma_f32(free[..., r], rw[:, None, r].expand_as(score), score)
    return score


def _queue_order(q) -> torch.Tensor:
    C = q.count.shape[0]
    return torch.arange(q.capacity, dtype=I32,
                        device=q.device)[None, :].expand(C, -1)


def _gavel_local(s: SimState, t: int, cfg: SimConfig, params):
    """Gavel-style round: Level0 in queue order, each job on the feasible
    node whose device type maximises its class's throughput
    (``params.gavel_tput``; ties to the lowest node index)."""
    def score(s2, job):
        return _gavel_scores(s2.node_type, job.jclass, params)

    return _scored_sweep_local(s, t, cfg, params, _queue_order(s.l0), score)


def _tesserae_local(s: SimState, t: int, cfg: SimConfig, params):
    """Tesserae-style packing: Level0 in the BFD order (always cores
    first: ``params=None``), each job on the feasible node with the
    highest weighted demand-free alignment."""
    def score(s2, job):
        return _tesserae_scores(s2.node_free, job, params)

    return _scored_sweep_local(s, t, cfg, params, _bfd_order(s.l0, None),
                               score)


def _rl_local(s: SimState, t: int, cfg: SimConfig, params):
    """The learned-scheduler kind: Level0 in queue order, the node pick
    scored by ``params.rl_scores`` through the same class/device-type
    lookup as gavel; the all-zero default is first fit in queue order."""
    def score(s2, job):
        return _class_device_scores(s2.node_type, job.jclass,
                                    params.rl_scores)

    return _scored_sweep_local(s, t, cfg, params, _queue_order(s.l0), score)


# --------------------------------------------------------------------------
# leap-accrual masks (the event-compressed driver's closed-form wait)
# --------------------------------------------------------------------------

def leap_wait_masks(kind: str, s: SimState, cfg: SimConfig, params=None):
    """Queue slots whose wait clock the scheduling pass advances every
    tick at a placement fixed point: exactly the slots the dense pass
    records a wait on when nothing places. Returns ``(l0_mask [C, Q],
    l1_mask [C, Q])``. FIFO records no wait in its pass; DELAY processes
    the first ``min(|L1|, QC)`` Level1 slots and the Level0 head; gavel
    and rl sweep the first ``min(|L0|, QC)`` slots in queue order; FFD and
    tesserae the slots at the first ``min(|L0|, QC)`` positions of the BFD
    order (FFD's tie-break from ``params``, tesserae's the default).
    ``kind`` is the policy kind (``PolicySet.leap_masks`` dispatches
    it)."""
    C, cap0 = s.l0.count.shape[0], s.l0.capacity
    dev = s.l0.device
    zl1 = torch.zeros((C, s.l1.capacity), dtype=torch.bool, device=dev)
    if kind == "fifo":
        return torch.zeros((C, cap0), dtype=torch.bool, device=dev), zl1
    QC = _sweep_len(cfg)
    pos0 = torch.arange(cap0, dtype=I32, device=dev)[None, :]
    if kind == "delay":
        pos1 = torch.arange(s.l1.capacity, dtype=I32, device=dev)[None, :]
        l1_mask = s.l1.slot_valid() & (
            pos1 < torch.clamp(s.l1.count, max=QC)[:, None])
        l0_mask = (pos0 == 0) & (s.l0.count > 0)[:, None]
        return l0_mask, l1_mask
    n_sweep = torch.clamp(s.l0.count, max=QC)[:, None]
    if kind in ("gavel", "rl"):  # queue-order sweeps: positions are slots
        return s.l0.slot_valid() & (pos0 < n_sweep), zl1
    # ffd / tesserae: the slots at the BFD order's first n_sweep positions
    order = _bfd_order(s.l0, params if kind == "ffd" else None)
    l0_mask = torch.zeros((C, cap0), dtype=torch.bool, device=dev)
    l0_mask.scatter_(1, order.long(), (pos0 < n_sweep).expand(C, -1))
    return l0_mask, zl1
