"""The fault phase: kill, requeue, mask, repair (the port of
``multi_cluster_simulator_tpu/faults/apply.py``), batched over the
cluster axis.

It opens the tick's per-cluster prefix, before completions (core/engine.py
``Engine._span_prefix``); the CUDA kernels run it as the ``kFaults`` step
of every prefix kernel (kernels/csrc/prefix_common.cuh
``Cluster::faults``). The reference's order and semantics:

- **Failures before completions.** A job whose ``end_t`` falls on the
  tick its node fails is killed, not completed.
- **Failures before repairs.** Every due failure applies, then every due
  repair, so a same-tick fail and repair is a zero-length outage that
  still kills and still counts one ``n_fails``.
- **Kill = requeue with a bumped retry budget.** Killed rows with
  ``retries < max_retries`` re-enter a queue in slot order with
  ``enq_t = t``, ``rec_wait = 0`` and ``retries + 1``, owner kept: own
  jobs go to the member's ingest target (Level0 with ``to_delay``, else
  the FIFO ReadyQueue), jobs a peer lent (``owner >= 0``) to the
  LentQueue; overflow counts into ``drops.queue``, rows at the budget into
  ``drops.failed``. Trader carve placeholders (``owner == -2``) die with
  the node and are not requeued. With ``to_delay`` the ingest requeues
  also count into ``wait_jobs`` and ``jobs_in_queue``.
- **Capacity masks out, repair restores an empty node.** A failed node's
  ``node_free`` zeroes and ``node_active`` drops (``was_active`` keeps the
  activation); repair restores ``free = cap``, the activation, closes
  ``down_ms`` and draws or looks up the next failure.
"""

from __future__ import annotations

import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.faults import schedule as fsched
from multi_cluster_simulator_tpu_torch.faults.schedule import NEVER, FaultState
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.ops.queues import I32, isum

FOREIGN = -2  # market/trader.py's carve-placeholder owner


def next_fault_event_t(fs: FaultState) -> torch.Tensor:
    """Earliest future fault event over the clusters: an up node's next
    failure or a down node's repair (0-d int32). Time compression folds it
    into its leap bound (core/engine.py ``_next_event_t``)."""
    return torch.where(fs.health, fs.next_fail, fs.down_until).min()


def sig_parts(state) -> list:
    """The fault plane's terms of the quiescence fingerprint (core/engine.py
    ``_quiescence_sig``): health membership, completed outages, and the
    kill and requeue counters."""
    fs = state.faults
    return [isum(fs.health, None), isum(fs.n_fails, None),
            isum(fs.kills, None) + isum(fs.requeues, None)]


def _requeue_rows(run, t: int) -> torch.Tensor:
    """[C, S, NF] queue rows of the running rows: identity and demand kept,
    the wait clock restarted at ``t``, the retry budget bumped."""
    d = R.rows_of(run)
    zeros = torch.zeros_like(d[..., R.RID])
    cores, gpu = d[..., R.RCORES], d[..., R.RGPU]
    vals = {"id": d[..., R.RID], "cores": cores, "mem": d[..., R.RMEM],
            "gpu": gpu, "dur": d[..., R.RDUR],
            "enq_t": torch.full_like(zeros, t), "owner": d[..., R.ROWNER],
            "rec_wait": zeros, "jclass": F.job_class(cores, gpu).to(I32),
            "retries": d[..., R.RRETRIES] + 1}
    return torch.stack([vals[n] for n in F.QUEUE_FIELDS], -1).to(I32)


def fault_phase_local(s, t: int, cfg: SimConfig, to_delay: bool):
    """The fault phase of tick ``t`` (a host int) on every cluster of
    ``s``; ``to_delay`` is the member's ingest target. Returns the new
    state."""
    fc = cfg.faults
    fs = s.faults
    N = fs.health.shape[1]
    trace_mode = fc.mode == "trace"

    # ---- failures due this tick ----
    fail_now = fs.health & (fs.next_fail <= t)  # [C, N]
    run = s.run
    node = run.node
    on_node = (node >= 0) & (node < N)
    on_failed = on_node & torch.gather(
        fail_now, 1, node.clamp(0, N - 1).long())
    killed = run.active & on_failed  # [C, S]
    owner = run.owner
    retries = run.retries
    is_job = killed & (owner != FOREIGN)
    retryable = is_job & (retries < fc.max_retries)
    exhausted = isum(is_job & (retries >= fc.max_retries), 1)
    to_lent = retryable & (owner >= 0)
    to_ingest = retryable & (owner < 0)
    n_req = isum(retryable, 1)
    n_ing = isum(to_ingest, 1)

    batch = Q.JobQueue(data=_requeue_rows(run, t), count=n_req)
    tgt = s.l0 if to_delay else s.ready
    dropped = Q.push_many_dropped(tgt, to_ingest)
    tgt = Q.push_many(tgt, batch, to_ingest)
    ldropped = Q.push_many_dropped(s.lent, to_lent)
    lent = Q.push_many(s.lent, batch, to_lent)
    s = s.replace(
        run=R.kill(run, killed), lent=lent,
        drops=s.drops.replace(queue=s.drops.queue + dropped + ldropped,
                              failed=s.drops.failed + exhausted))
    if to_delay:
        s = s.replace(l0=tgt, wait_jobs=s.wait_jobs + n_ing,
                      jobs_in_queue=s.jobs_in_queue + n_ing)
    else:
        s = s.replace(ready=tgt)

    # node bookkeeping: capacity out, activation parked, outage opened
    free = torch.where(fail_now[..., None], 0, s.node_free)
    was_active = torch.where(fail_now, s.node_active, fs.was_active)
    active = s.node_active & ~fail_now
    if trace_mode:
        du_new = fsched.gather_event(fs.repair_t, fs.n_fails)
    else:
        du_new = t + fsched._exp_draws(fs.key, fs.n_fails, 1, fc.mttr_ms)
    down_until = torch.where(fail_now, du_new, fs.down_until)
    next_fail = torch.where(fail_now, NEVER, fs.next_fail)
    down_since = torch.where(fail_now, t, fs.down_since)
    health = fs.health & ~fail_now
    kills = fs.kills + isum(is_job, 1)
    requeues = fs.requeues + n_req

    # ---- repairs due this tick (after failures) ----
    rep_now = ~health & (down_until <= t)
    active = torch.where(rep_now, was_active, active)
    free = torch.where(rep_now[..., None], s.node_cap, free)
    down_ms = fs.down_ms + isum(torch.where(rep_now, t - down_since, 0), 1)
    n_fails = fs.n_fails + rep_now.to(I32)
    if trace_mode:
        nf_new = fsched.gather_event(fs.fail_t, n_fails)
    else:
        nf_new = t + fsched._exp_draws(fs.key, n_fails, 0, fc.mttf_ms)
    next_fail = torch.where(rep_now, nf_new, next_fail)
    down_until = torch.where(rep_now, NEVER, down_until)
    health = health | rep_now

    return s.replace(
        node_free=free, node_active=active,
        faults=fs.replace(health=health, was_active=was_active,
                          next_fail=next_fail, down_until=down_until,
                          down_since=down_since, n_fails=n_fails,
                          kills=kills, requeues=requeues, down_ms=down_ms))
