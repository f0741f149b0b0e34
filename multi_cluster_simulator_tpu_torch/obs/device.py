"""The device metrics plane: per-tick telemetry without host syncs (the
port of ``multi_cluster_simulator_tpu/obs/device.py``).

A ``MetricsBuffer`` of fixed-shape tensors rides a run next to the
``SimState``; a tap after every tick READS the state and accumulates
deltas, depths and a histogram into the buffer, which the caller harvests
once per chunk (``harvest``). Taps never write a state leaf, so a run with
the plane on leaves the state bitwise as it does with the plane off.

The per-tick deltas are differences of CUMULATIVE state counters
(``placed_total``, ``arr_ptr``, ``wait_total``, ...) against a
``TapCursor`` of their previous values. The cursor lives only inside a
run and is re-derived from the state at every run entry (``cursor_of``):
the counters move only inside ticks, so at a chunk boundary that is the
cursor the previous chunk's last tick left behind. The port updates
states in place, so a cursor holds copies of the counters, never the
state's own tensors.

``tap_tick`` is recomposed from two halves, as in the reference: the
per-cluster half (``tap_tick_local``), which the hand-written prefix
kernels run as an epilogue on a terminal prefix, and the cross-cluster
half (``tap_tick_global``: the tick count, the depth histogram and the
ring rows). These functions are the plain PyTorch versions, what the CPU
runs and what each kernel's tap form is held against on the card
(kernels/fused_tick.py). The kernels fold the cross-cluster half in too,
with integer atomics, whose sums are exact in any order.

``tap_leap`` is the event-compressed driver's half: the samples of the
ticks a leap skipped, in closed form, bitwise what the dense taps over the
fixed point accumulate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.core.compact import ovf_per_cluster
from multi_cluster_simulator_tpu_torch.core.state import LEAP_BUCKETS, SimState
from multi_cluster_simulator_tpu_torch.faults.schedule import xla_log_f32
from multi_cluster_simulator_tpu_torch.ops.queues import I32
from multi_cluster_simulator_tpu_torch.utils.tree import Tree

# ring slots: the last OBS_RING ticks' per-tick samples (slot = tick
# ordinal mod OBS_RING, so chunked runs address the ring by the clock)
OBS_RING = 64
# log2 histogram of per-(tick, cluster) queue depth: bucket 0 = empty,
# bucket b >= 1 = depth in [2^(b-1), 2^b), as XLA's CPU f32 log2 rounds it
OBS_DEPTH_BUCKETS = 16
# 1 / log(2) as the compiled reference computes it: jnp.log2(x) is
# log(x) / log(2.0), and XLA turns the division by that constant into a
# product with its f32 reciprocal
INV_LN2 = float(np.float32(1.0) / np.float32(np.log(np.float32(2.0))))


@dataclasses.dataclass
class MetricsBuffer(Tree):
    """Fixed-shape telemetry accumulators; the reference's leaves, shapes
    and dtypes. Leaves with a leading axis of 1 are shard-local partials
    (the global view is their axis-0 sum: ``reduce_metrics``,
    ``harvest``)."""

    ticks: torch.Tensor  # [] i32 — ticks observed
    placed: torch.Tensor  # [C] i32 — placements this window
    arrived: torch.Tensor  # [C] i32 — arrivals ingested
    borrows: torch.Tensor  # [C] i32 — jobs newly hosted for peers
    wait_accrued: torch.Tensor  # [C] f32 — wait time accrued (ms)
    ovf: torch.Tensor  # [C] i32 — narrow-store overflows surfaced
    depth_sum: torch.Tensor  # [C] i32 — sum of per-tick queue depth
    depth_max: torch.Tensor  # [C] i32
    kills: torch.Tensor  # [C] i32 — jobs killed by node failures
    requeues: torch.Tensor  # [C] i32 — killed jobs granted a retry
    fail_drops: torch.Tensor  # [C] i32 — kills past the retry budget
    node_down_ms: torch.Tensor  # [C] i32 — node downtime closed
    depth_hist: torch.Tensor  # [1, B] i32 — log2 depth histogram
    ring_placed: torch.Tensor  # [1, R] i32 — per-tick placed (sum)
    ring_depth: torch.Tensor  # [1, R] i32 — per-tick depth (sum)
    ring_t: torch.Tensor  # [R] i32 — tick clock per slot (0 = unwritten)
    leap_hist: torch.Tensor  # [LEAP_BUCKETS] i32 — log2 leap sizes


@dataclasses.dataclass
class TapCursor(Tree):
    """The previous cumulative counters a tap differences against."""

    placed: torch.Tensor  # [C] i32 (placed_total)
    arrived: torch.Tensor  # [C] i32 (arr_ptr)
    lent: torch.Tensor  # [C] i32 (lent.count)
    wait: torch.Tensor  # [C] f32 (wait_total)
    ovf: torch.Tensor  # [C] i32 (narrow-store overflow total)
    kills: torch.Tensor  # [C] i32 (faults.kills)
    requeues: torch.Tensor  # [C] i32 (faults.requeues)
    fail_drops: torch.Tensor  # [C] i32 (drops.failed)
    down_ms: torch.Tensor  # [C] i32 (faults.down_ms)


def queue_depth(state: SimState) -> torch.Tensor:
    """[C] total queued jobs (l0 + l1 + ready + wait; lent and borrowed
    track ownership, not local backlog)."""
    return (state.l0.count + state.l1.count + state.ready.count
            + state.wait.count)


def _ovf_total(state: SimState) -> torch.Tensor:
    """[C] checked-narrow overflow total: every queue's and the running
    set's ``ovf`` (zeros on the wide layout, which carries no counters)."""
    return ovf_per_cluster(state)


def metrics_init(state: SimState) -> MetricsBuffer:
    """A zeroed buffer shaped for ``state``'s cluster axis, on its
    device."""
    C, dev = state.arr_ptr.shape[0], state.device

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return MetricsBuffer(
        ticks=z(), placed=z(C), arrived=z(C), borrows=z(C),
        wait_accrued=z(C, dtype=torch.float32), ovf=z(C), depth_sum=z(C),
        depth_max=z(C), kills=z(C), requeues=z(C), fail_drops=z(C),
        node_down_ms=z(C), depth_hist=z(1, OBS_DEPTH_BUCKETS),
        ring_placed=z(1, OBS_RING), ring_depth=z(1, OBS_RING),
        ring_t=z(OBS_RING), leap_hist=z(LEAP_BUCKETS))


def cursor_of(state: SimState) -> TapCursor:
    """The tap cursor for a run starting at ``state``: copies of its
    counters (the state changes in place under the run)."""
    return TapCursor(placed=state.placed_total.clone(),
                     arrived=state.arr_ptr.clone(),
                     lent=state.lent.count.clone(),
                     wait=state.wait_total.clone(), ovf=_ovf_total(state),
                     kills=state.faults.kills.clone(),
                     requeues=state.faults.requeues.clone(),
                     fail_drops=state.drops.failed.clone(),
                     down_ms=state.faults.down_ms.clone())


def _depth_buckets(depth: torch.Tensor) -> torch.Tensor:
    """log2 bucket per cluster: 0 for empty, else 1 + floor(log2(depth))
    in XLA's CPU f32 steps (``xla_log_f32`` times ``INV_LN2``), which put
    depth 8192 in bucket 13 (not ``bit_length``'s 14); clipped to the
    last bucket."""
    x = torch.clamp(depth, min=1).to(torch.float32)
    b = 1 + torch.floor(xla_log_f32(x) * INV_LN2).to(I32)
    return torch.clamp(torch.where(depth > 0, b, 0), 0, OBS_DEPTH_BUCKETS - 1)


# The buffer leaves the per-cluster tap half owns: every [C] accumulator.
PC_LEAVES = ("placed", "arrived", "borrows", "wait_accrued", "ovf",
             "depth_sum", "depth_max", "kills", "requeues", "fail_drops",
             "node_down_ms")


def tap_pc(mbuf: MetricsBuffer) -> dict:
    """The buffer's per-cluster slice as a dict; splice back with
    ``mbuf.replace(**pc)``."""
    return {k: getattr(mbuf, k) for k in PC_LEAVES}


def tap_tick_local(pc: dict, cur: TapCursor, state: SimState):
    """The per-cluster half of ``tap_tick``: differences the cumulative
    counters against the cursor and accumulates into the [C] leaves. Reads
    the state and writes nothing of it; does not read ``state.t`` (inside
    a kernel epilogue the clock has not advanced yet). Returns ``(pc',
    cur', placed_d, depth)``, new tensors."""
    placed_d = state.placed_total - cur.placed
    arrived_d = state.arr_ptr - cur.arrived
    lent_d = torch.clamp(state.lent.count - cur.lent, min=0)
    ovf_now = _ovf_total(state)
    depth = queue_depth(state)
    fs = state.faults
    pc = dict(
        placed=pc["placed"] + placed_d,
        arrived=pc["arrived"] + arrived_d,
        borrows=pc["borrows"] + lent_d,
        wait_accrued=pc["wait_accrued"] + (state.wait_total - cur.wait),
        ovf=pc["ovf"] + (ovf_now - cur.ovf),
        depth_sum=pc["depth_sum"] + depth,
        depth_max=torch.maximum(pc["depth_max"], depth),
        kills=pc["kills"] + (fs.kills - cur.kills),
        requeues=pc["requeues"] + (fs.requeues - cur.requeues),
        fail_drops=pc["fail_drops"] + (state.drops.failed - cur.fail_drops),
        node_down_ms=pc["node_down_ms"] + (fs.down_ms - cur.down_ms),
    )
    return pc, cursor_of(state), placed_d, depth


def tap_tick_global(mbuf: MetricsBuffer, placed_d: torch.Tensor,
                    depth: torch.Tensor, t, tick_ms: int) -> MetricsBuffer:
    """The cross-cluster half of ``tap_tick``: the tick count, the depth
    histogram and the ring rows at slot ``(t // tick_ms) % OBS_RING``.
    ``t`` is the post-tick clock (a host int or a 0-d int32 tensor on the
    buffer's device; nothing here syncs with the host). ``mbuf`` already
    carries the spliced-back per-cluster leaves."""
    dev = mbuf.ring_t.device
    t = torch.as_tensor(t, dtype=I32) if isinstance(t, torch.Tensor) else \
        torch.full((), t, dtype=I32, device=dev)
    slot = torch.remainder(torch.div(t, tick_ms, rounding_mode="floor"),
                           OBS_RING)
    hot = torch.arange(OBS_RING, device=dev) == slot
    b = _depth_buckets(depth).long()
    hist = torch.zeros(OBS_DEPTH_BUCKETS, dtype=I32, device=dev).index_add_(
        0, b, torch.ones_like(b, dtype=I32))
    return mbuf.replace(
        ticks=mbuf.ticks + 1,
        depth_hist=mbuf.depth_hist + hist[None, :],
        ring_placed=torch.where(hot[None, :], placed_d.sum().to(I32),
                                mbuf.ring_placed),
        ring_depth=torch.where(hot[None, :], depth.sum().to(I32),
                               mbuf.ring_depth),
        ring_t=torch.where(hot, t, mbuf.ring_t),
    )


def tap_tick(mbuf: MetricsBuffer, cur: TapCursor, state: SimState,
             tick_ms: int) -> tuple[MetricsBuffer, TapCursor]:
    """Accumulate one executed tick's sample: reads the post-tick state
    (its clock ``state.t`` included), writes only the buffer and cursor,
    which it returns new."""
    pc, cur, placed_d, depth = tap_tick_local(tap_pc(mbuf), cur, state)
    mbuf = tap_tick_global(mbuf.replace(**pc), placed_d, depth, state.t,
                           tick_ms)
    return mbuf, cur


def leap_bucket(n_skip: int) -> int:
    """The log2 bucket of a leap of ``n_skip`` >= 1 ticks: floor(log2) in
    XLA's CPU f32 steps (``xla_log_f32`` times ``INV_LN2``), clipped to
    the last bucket. Those steps round some powers of two down (a leap of
    exactly 2^k ticks can land in bucket k - 1); the leap histograms of
    both ``LeapStats`` and the buffer use this one rule."""
    x = torch.tensor([max(n_skip, 1)], dtype=torch.float32)
    b = int(torch.floor(xla_log_f32(x) * INV_LN2).to(I32))
    return min(max(b, 0), LEAP_BUCKETS - 1)


def tap_leap(mbuf: MetricsBuffer, cur: TapCursor, state: SimState,
             n_skip: int, tick_ms: int) -> tuple[MetricsBuffer, TapCursor]:
    """The samples of the ``n_skip`` ticks a quiescent leap skipped, in
    closed form: exactly what ``n_skip`` dense ``tap_tick`` calls over the
    fixed point accumulate. ``state`` is the POST-leap state (its clock at
    the landing tick, the wait accrual applied); ``n_skip`` a host int,
    0 the identity. At a fixed point the per-tick deltas (placed, arrived,
    borrows, overflow and the fault counters: a leap never jumps a fault
    event) are zero, so only the wait cursor moves; the levels replicate:
    ``depth_sum += n_skip * depth``, the fixed depth's histogram bucket
    gains ``n_skip``, and each ring slot a skipped tick maps to takes the
    LATEST such tick (slot j keeps ordinal q = m + n_skip - ((m + n_skip -
    j) mod R), covered iff q > m, m the executed tick's ordinal). Reads
    the clock on the device: no host sync. Returns new tensors."""
    depth = queue_depth(state)
    dev = mbuf.ring_t.device
    m = torch.div(state.t, tick_ms, rounding_mode="floor") - n_skip
    j = torch.arange(OBS_RING, dtype=I32, device=dev)
    q = m + n_skip - torch.remainder(m + n_skip - j, OBS_RING)
    covered = (q > m) & (n_skip > 0)
    hist = torch.zeros(OBS_DEPTH_BUCKETS, dtype=I32, device=dev).index_add_(
        0, _depth_buckets(depth).long(),
        torch.full_like(depth, n_skip, dtype=I32))
    mbuf = mbuf.replace(
        ticks=mbuf.ticks + n_skip,
        wait_accrued=mbuf.wait_accrued + (state.wait_total - cur.wait),
        depth_sum=mbuf.depth_sum + n_skip * depth,
        depth_max=torch.maximum(mbuf.depth_max, depth),
        depth_hist=mbuf.depth_hist + hist[None, :],
        ring_placed=torch.where(covered[None, :], 0, mbuf.ring_placed),
        ring_depth=torch.where(covered[None, :], depth.sum().to(I32),
                               mbuf.ring_depth),
        ring_t=torch.where(covered, (q * tick_ms).to(I32), mbuf.ring_t),
        leap_hist=mbuf.leap_hist.clone(),
    )
    if n_skip > 0:
        mbuf.leap_hist[leap_bucket(n_skip)] += 1
    return mbuf, dataclasses.replace(cur, wait=state.wait_total.clone())


def reduce_metrics(mbuf: MetricsBuffer, ex) -> MetricsBuffer:
    """Cross-shard reduction of the shard-local partials through the
    exchange (parallel/exchange.py): one ``allsum`` each for the histogram
    and the ring value rows; an identity on ``LocalExchange``."""
    return mbuf.replace(
        depth_hist=ex.allsum(mbuf.depth_hist),
        ring_placed=ex.allsum(mbuf.ring_placed),
        ring_depth=ex.allsum(mbuf.ring_depth),
    )


def harvest(mbuf: MetricsBuffer) -> dict:
    """Host-side readout of one buffer, as the reference's: numpy copies
    of the leaves (one coercion per chunk boundary), JSON-ready totals and
    the raw per-cluster rows under ``per_cluster``. The f32 sum is numpy's,
    as there."""
    leaves = {f.name: np.array(getattr(mbuf, f.name).detach().cpu())
              for f in dataclasses.fields(mbuf)}
    ticks = int(leaves["ticks"])
    depth_sum = int(leaves["depth_sum"].sum())
    hist = leaves["depth_hist"].sum(axis=0)
    nz = np.flatnonzero(hist)
    lh = leaves["leap_hist"]
    lnz = np.flatnonzero(lh)
    # ring rows in clock order, unwritten slots dropped
    order = np.argsort(leaves["ring_t"], kind="stable")
    rt = leaves["ring_t"][order]
    valid = rt > 0
    return {
        "ticks": ticks,
        "placed": int(leaves["placed"].sum()),
        "arrived": int(leaves["arrived"].sum()),
        "borrows": int(leaves["borrows"].sum()),
        "wait_accrued_ms": round(float(leaves["wait_accrued"].sum()), 3),
        "narrow_ovf": int(leaves["ovf"].sum()),
        "fault_kills": int(leaves["kills"].sum()),
        "fault_requeues": int(leaves["requeues"].sum()),
        "fault_drops": int(leaves["fail_drops"].sum()),
        "node_down_ms": int(leaves["node_down_ms"].sum()),
        "queue_depth_mean": round(depth_sum / max(ticks, 1), 3),
        "queue_depth_max": int(leaves["depth_max"].max(initial=0)),
        "depth_hist_log2": hist[:nz[-1] + 1].tolist() if len(nz) else [],
        "leap_hist_log2": lh[:lnz[-1] + 1].tolist() if len(lnz) else [],
        "ring": {
            "t_ms": rt[valid].tolist(),
            "placed": leaves["ring_placed"].sum(axis=0)[order][valid].tolist(),
            "queue_depth":
                leaves["ring_depth"].sum(axis=0)[order][valid].tolist(),
        },
        "per_cluster": {
            "placed": leaves["placed"].tolist(),
            "queue_depth_max": leaves["depth_max"].tolist(),
        },
    }
