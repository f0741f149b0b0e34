#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root with ``python3 chip_smoke.py``; it needs one
CUDA card and exits non-zero without one (or without the repository around
it). It drives the port's paths on the card — the headline FIFO run, the
FFD bin-pack of the Borg-like replay, DELAY and the scored zoo (gavel,
tesserae) on the market shape, and cross-cluster borrowing on BASELINE
config 2 — through the entry points a user calls, and holds each path's
hand-written kernel against its plain PyTorch version:

1. device: the card's name and power limit;
2. build: every CUDA kernel, from ``kernels/csrc/`` (one nvcc per source,
   all started together);
3. kernel against plain, every leaf bitwise (``wait_total`` included):
   a. FIFO at the headline's full width (4096 clusters), on ticks the
      headline run reaches and on heavier streams that fill the queues;
      the emit form (``run_io``'s) timed on the first 400 headline ticks;
   b. the first 800 ticks of a 256-cluster headline run through each;
   c. FFD at bench_borg4k's full width: 16 ticks sampled as the kernel
      reaches them (the diurnal peak included), 2 x 30 heavy ticks that
      fire drops.queue, drops.run_full and the per-tick placement cap, the
      serial form, the ``ffd-memfirst`` variant, parity mode and the trace,
      and the first 800 ticks of a run at bench_borg4k(quick=True)'s shape;
   d. DELAY at the market's full width (sinkhorn_market_setup, bench.py:
      979-1029, trader off): ticks of runs (a) and (d) sampled as the
      kernel reaches them, heavy ticks on an 8-deep queue that fire the
      promotion, a full Level1, drops.run_full and the parity skip, in the
      wave, serial and parity forms, ``delay-eager`` and the trace, and a
      whole run at the market's quick shape;
   e. the scored sweep the same way: runs (b) gavel and (c) tesserae
      sampled, heavy ticks (gavel; tesserae with the trace; gavel and rl
      with seeded scores on clusters of mixed device types), and the first
      400 ticks of quick-shape runs of tesserae and of the seeded rl;
   f. tools/tournament.py's lineup as one multi-member PolicySet at 256
      clusters: each params.idx launches its member's kernel, and only
      that, and equals the plain version;
   g. the FIFO kernel's emit form (the return pack, ``want``,
      ``bjob_vec``, ``drops.msgs``) on the borrowing path of config 2
      (bench.py:898-933, trader off): ticks of run (b) sampled as the
      kernel reaches them; heavy ticks on small queues that fire returns
      past the message slots, lent-head placements, LentQueue overflow and
      wants; a whole run (a) and a whole 64-cluster tiled run of 600 ticks
      with delivery and matching; the DELAY, FFD and gavel kernels' emit
      form with foreign rows running;
   h. ``Engine.run_io`` over 40 ticks of run (b) from the state it reached
      at tick 800: the state and the stacked TickIO equal the plain
      path's;
4. the main paths, each with every launch count set to 0 just before and
   read just after:
   a. headline: 4096 clusters x 250 jobs, 1,570 ticks — zero drops, at
      least 99% placed, conservation, 1,570 FIFO launches; jobs/s over the
      min and median of 3 timed runs after 1 warm-up;
   b. borg4k (bench.py:1213-1263): 4096 clusters x 750 Borg-like jobs,
      4,600 ticks — at least 95% placed, zero drops, conservation, 4,600
      FFD launches; jobs/s over the min and median of 3 timed runs after 1
      warm-up;
   c. ffd64 (bench.py:936-976): 64 clusters x 60,000 jobs, Level0 768
      deep, 6,100 ticks — kernel == plain on 8 sampled ticks, then one
      full run with the reference's asserts;
   d-g. the market shape, 4096 clusters x 400 jobs, 700 ticks, four runs
      of one world and stream: (a) DELAY in the wave form, (b) gavel, (c)
      tesserae, (d) DELAY parity (the serial sweep with the skip quirk) —
      conservation, every arrived job placed, queued or counted as
      dropped, 700 launches of the run's kernel; for the DELAY runs also
      zero drops and at least 85% of the jobs that can place without the
      market placed (bench.py:1081); jobs/s over the min and median of 3
      timed runs after 1 warm-up;
   h-i. config 2 with the trader cut, 1,800 ticks: (a) at its own two
      clusters — zero drops (bench.py:925), conservation, 1,800 launches
      of the emit form; (b) tiled to 4,096 clusters — conservation, 1,800
      launches, drops and the job count printed (the reference's herding
      onto the lowest lender drops jobs there by design); ticks/s and
      placed jobs/s over the min and median of 3 timed runs after the
      counted run, which is the warm-up (run (a)'s goes through
      ``run_io`` and counts its wants and returns), and per tick the
      kernel, return delivery and borrow matching each timed by CUDA
      events.

Every number is printed beside the card's name and power limit. The last
lines are a JSON record of each kernel (its time per launch, the plain
version's, the least time the card allows for the bytes and operations
its path's own data needs), the ``nvidia-smi`` name and power-limit line,
and the result line. No phase catches an error: any failure ends the
script non-zero.
"""

from __future__ import annotations

import bisect
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), the
# rate the FFD kernel's integer compares are counted against
SCALAR_OPS_PER_S = 67e12
HEADLINE_C, JOBS, HORIZON_MS, CHUNK = 4096, 250, 1_500_000, 400
RUN_C = 256  # the width of the FIFO whole-run kernel-vs-plain comparison
TIMED_RUNS, WARMUPS = 3, 1
SPIN_CYCLES = 1_000_000  # ~0.5 ms of card time ahead of each timed launch
# bench_borg4k (bench.py:1213-1263), full and quick shapes
BORG_C, BORG_JOBS, BORG_HORIZON_MS = 4096, 750, 4_500_000
BORG_QUICK = (256, 250, 1_500_000)
BORG_TIMED, BORG_WARMUPS, BORG_SAMPLES = 3, 1, 16
# bench_ffd64 (bench.py:936-976)
FFD64_C, FFD64_JOBS, FFD64_HORIZON_MS, FFD64_SAMPLES = 64, 60_000, \
    6_000_000, 8
# the market shape, bench.py:979-1029 sinkhorn_market_setup(4096, 400,
# 600_000) with the trader off, and its quick shape (64, 200, quick=True)
MARKET_C, MARKET_JOBS, MARKET_HORIZON_MS = 4096, 400, 600_000
MARKET_QUICK = (64, 200)
MARKET_TIMED, MARKET_WARMUPS, MARKET_SAMPLES = 3, 1, 12
MARKET_FLOOR = 0.85  # bench.py:1081, of the jobs that can place unaided
# the four full-shape runs: name -> (policy, config changes, gated)
MARKET_RUNS = {"a": ("delay", {}, True), "b": ("gavel", {}, False),
               "c": ("tesserae", {}, False),
               "d": ("delay", {"parity": True}, True)}
# tools/tournament.py DEFAULT_POLICIES, dispatched as one PolicySet
LINEUP = ("fifo", "delay", "delay-eager", "delay-patient", "ffd",
          "ffd-memfirst", "gavel", "tesserae")
LINEUP_C, LINEUP_TICKS = 256, 40
# BASELINE config 2 (bench.py:898-933) with the trader cut: run (a) at its
# own two clusters, run (b) tiled to 4,096; 3g's whole tiled run; 3h's
# run_io chunk
BORROW_C, BORROW_TICKS, BORROW_HORIZON_MS = 4096, 1_800, 1_800_000
BORROW_TILED_C, BORROW_TILED_TICKS = 64, 600
BORROW_SAMPLES, BORROW_IO_TICKS, BORROW_PROFILE_TICKS = 12, 40, 50
# chunks (400 ticks each) of the earlier paths' whole-run comparisons
# (3b, 3c): their first 800 ticks, to keep the script's time
WHOLE_RUN_CHUNKS = 2


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def headline_cfg(P, **kw):
    """bench.py's headline config (_fifo_parity_scale), as the port's."""
    base = dict(policy=P.PolicyKind.FIFO, queue_capacity=8, max_running=32,
                max_arrivals=JOBS, max_ingest_per_tick=8, parity=True,
                n_res=2, max_nodes=5, max_virtual_nodes=0)
    base.update(kw)
    return P.SimConfig(**base)


def borg_cfg(P, jobs=BORG_JOBS, **kw):
    """bench_borg4k's config (bench.py:1236), as the port's."""
    base = dict(policy=P.PolicyKind.FFD, parity=False,
                max_placements_per_tick=16, queue_capacity=32,
                max_running=96, max_arrivals=jobs, max_ingest_per_tick=8,
                max_nodes=5, max_virtual_nodes=0, n_res=2)
    base.update(kw)
    return P.SimConfig(**base)


def ffd64_cfg(P):
    """bench_ffd64's config (bench.py:955), as the port's."""
    return P.SimConfig(policy=P.PolicyKind.FFD, parity=False,
                       max_placements_per_tick=32, queue_capacity=768,
                       max_running=1024, max_arrivals=FFD64_JOBS,
                       max_ingest_per_tick=64, max_nodes=10,
                       max_virtual_nodes=0, n_res=2)


def market_cfg(P, quick=False, jobs=MARKET_JOBS, **kw):
    """sinkhorn_market_setup's config (bench.py:993) with the trader off,
    as the port's."""
    base = dict(policy=P.PolicyKind.DELAY, parity=False,
                max_placements_per_tick=8,
                queue_capacity=512 if quick else 256,
                max_running=256 if quick else 128, max_arrivals=jobs,
                max_ingest_per_tick=16, max_nodes=5, max_virtual_nodes=4,
                delay_sweep="wave", n_res=3,
                trader=P.TraderConfig(enabled=False))
    base.update(kw)
    return P.SimConfig(**base)


def market_specs(P, C):
    """Half the clusters gpu-rich (8 gpus a node), half gpu-poor."""
    return [P.uniform_cluster(c + 1, 5, gpus=8 if c % 2 == 0 else 0)
            for c in range(C)]


def mixed_specs(P, C):
    """Clusters with nodes of all four device types, where the class
    tables of gavel and rl choose between nodes."""
    nodes = ((32, 24_000, 0, 0), (16, 12_000, 0, 2), (64, 48_000, 4, 3),
             (32, 24_000, 8, 1), (32, 24_000, 0, 0))
    return [P.ClusterSpec(id=c + 1, nodes=tuple(
        P.NodeSpec(id=i + 1, cores=k, memory=m, gpus=g, device_type=d)
        for i, (k, m, g, d) in enumerate(nodes))) for c in range(C)]


def market_stream(E, C, jobs, quick=False, seed=7):
    """The market's stream, its 400-tick ragged-K chunks, and how many of
    its jobs can never place without the market: the gpu jobs of the
    gpu-poor clusters."""
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    arr = uniform_stream(C, jobs, MARKET_HORIZON_MS, max_cores=24,
                         max_mem=18_000,
                         max_dur_ms=300_000 if quick else 40_000, seed=seed,
                         max_gpus=2, gpu_frac=0.1)
    n_ticks = MARKET_HORIZON_MS // 1_000 + 100
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), 1_000)
    valid = np.arange(arr.t.shape[1])[None, :] < arr.n[:, None]
    poor = (np.arange(C) % 2 == 1)[:, None]
    unplaceable = int(((arr.gpu > 0) & valid & poor).sum())
    return chunks, n_ticks, unplaceable


def chunk_sizes(n_ticks: int) -> list[int]:
    sizes = [CHUNK] * (n_ticks // CHUNK)
    return sizes + ([n_ticks % CHUNK] if n_ticks % CHUNK else [])


def max_abs_diff(a, b) -> float:
    """Largest |a - b| over every leaf of two states (a float leaf counts
    any difference in its bits); raises on a leaf whose dtype or shape
    differs."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    worst = 0.0
    for (k, x), (_, y) in zip(leaves_with_keys(a), leaves_with_keys(b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{k}: {x.dtype}{tuple(x.shape)} vs "
                                 f"{y.dtype}{tuple(y.shape)}")
        if not x.numel():
            continue
        if x.dtype == torch.bool:
            d = float((x != y).sum())
        elif x.dtype.is_floating_point:  # f32 leaves: compare the bits
            d = 0.0
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                d = float((x.double() - y.double()).abs().max())
                d = d if d > 0 else math.inf  # -0.0 against 0.0, or NaN
        else:
            d = float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
        worst = max(worst, d)
    return worst


def written_bytes(before, after):
    """Bytes of every state element the tick changed (0-d int64 tensor),
    and the same for the rows of Level0 and Level1 together."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    written = sum((x != y).sum() * x.element_size() for (_, x), (_, y)
                  in zip(leaves_with_keys(before), leaves_with_keys(after)))
    queues = ((before.l0.data != after.l0.data).sum()
              + (before.l1.data != after.l1.data).sum()) * 4
    return written, queues


def fixed_reads(s, n_counters: int):
    """Per-tick reads every cluster needs whatever its data: the arrival
    count and the counters the tick updates, the node free and active
    vectors, the running set's active flags."""
    C, N, n_res = s.node_free.shape
    S = s.run.active.shape[1]
    return C * (4 * (1 + n_counters) + N * n_res * 4 + N + S)


def run_reads(s, t: int):
    """Running-set reads: the end_t of each active slot, and the node and
    resources of each slot the tick releases."""
    n_res = s.node_free.shape[2]
    due = s.run.active & (s.run.data[..., 0] <= t)  # end_t is field 0
    return 4 * s.run.active.sum() + 4 * (1 + n_res) * due.sum()


def tick_bytes(before, after, rows, counts, t: int, trace: bool):
    """The least bytes a FIFO tick ``t`` must move on this tick's data, as
    (read, written) 0-d int64 tensors on the card (no host sync).

    Written: every state element the tick changed. Read, per cluster: the
    arrival count and the seven counters the tick updates (the trace count
    too when the trace is on), the node free and active vectors, the
    running set's active flags, the end_t of each active slot and the node
    and resources of each slot it releases, every live queue row, and the
    valid arrival rows. Rows that did not change, and queue slots past a
    queue's count, need not move at all."""
    s = before
    row_b = rows.shape[2] * rows.element_size()
    written, _ = written_bytes(before, after)
    live = sum(q.count.clamp(0, q.data.shape[1]).sum()
               for q in (s.ready, s.wait, s.lent))
    valid = counts.clamp(0, rows.shape[1]).sum()
    read = (fixed_reads(s, 7 + int(trace)) + run_reads(s, t)
            + row_b * (live + valid))
    return read, written


def tick_cost_ffd(before, after, rows, counts, t: int, trace: bool, QC: int):
    """The least bytes and operations an FFD tick ``t`` needs on this
    tick's data, as (read, written, ops) 0-d int64 tensors on the card.

    Written: every state element the tick changed. Read, per cluster: the
    arrival count and the eight counters the tick updates (the trace count
    too), the node vectors, the running set's active flags, the end_t of
    each active slot and the node and resources of each released slot, the
    two sort keys of every live Level0 row (after the ingest), the rest of
    the row of each of the first min(|L0|, QC) jobs the sweep processes,
    each Level0 element the tick rewrote (read from its source slot; this
    counts the processed rows' rec_wait twice, at most 4 B a job), and the
    valid arrival rows. Operations: per cluster, |L0| + n log2(|L0|)
    compares to select the sweep's n jobs in order, and N*(R+1) compares
    of first fit per processed job."""
    s = before
    n_res = s.node_free.shape[2]
    N = s.node_free.shape[1]
    Qc = s.l0.data.shape[1]
    row_b = rows.shape[2] * rows.element_size()
    written, l0_written = written_bytes(before, after)
    n_take = counts.clamp(0, rows.shape[1])
    live = (s.l0.count + n_take).clamp(0, Qc)  # [C] Level0 after ingest
    n_sweep = live.clamp(max=QC)
    read = (fixed_reads(s, 8 + int(trace)) + run_reads(s, t)
            + 8 * live.sum() + (row_b - 8) * n_sweep.sum() + l0_written
            + row_b * n_take.sum())
    log2 = torch.log2(live.clamp(min=1).double()).ceil().long()
    ops = (live + n_sweep * log2 + n_sweep * N * (n_res + 1)).sum()
    return read, written, ops


def tick_cost_delay(before, after, rows, counts, t: int, trace: bool,
                    QC: int):
    """The least bytes and operations a DELAY tick ``t`` needs on this
    tick's data, as (read, written, ops) 0-d int64 tensors on the card.

    Written: every state element the tick changed. Read, per cluster: the
    arrival count and the nine counters the tick updates (the trace count
    too), the node vectors, the running set's active flags, the end_t of
    each active slot and the node and resources of each released slot, the
    whole row of each of the first min(|L1|, QC) Level1 jobs the sweep
    processes and of the Level0 head, each Level0 and Level1 element the
    tick rewrote (read from its source slot), and the valid arrival rows.
    Operations: N*(R+1) compares of first fit per attempted job."""
    s = before
    n_res, N = s.node_free.shape[2], s.node_free.shape[1]
    Qc = s.l0.data.shape[1]
    row_b = rows.shape[2] * rows.element_size()
    written, q_written = written_bytes(before, after)
    n_take = counts.clamp(0, rows.shape[1])
    head = ((s.l0.count + n_take).clamp(0, Qc) > 0).long()
    n_sweep = s.l1.count.clamp(max=QC).long()
    read = (fixed_reads(s, 9 + int(trace)) + run_reads(s, t)
            + row_b * (n_sweep + head).sum() + q_written
            + row_b * n_take.sum())
    ops = ((n_sweep + head) * N * (n_res + 1)).sum()
    return read, written, ops


def tick_cost_scored(before, after, rows, counts, t: int, trace: bool,
                     QC: int, tesserae: bool):
    """``tick_cost_ffd`` for the scored sweeps. tesserae sweeps the BFD
    order as FFD does and scores each node of each processed job with R
    multiplies and R adds besides first fit's R+1 compares; gavel and rl
    sweep in queue order (no keys to select by: each processed row is
    read whole) and look each node's score up in a table, reading the
    node types."""
    s = before
    n_res, N = s.node_free.shape[2], s.node_free.shape[1]
    n_take = counts.clamp(0, rows.shape[1])
    n_sweep = (s.l0.count + n_take).clamp(0, s.l0.data.shape[1]).clamp(
        max=QC)
    if tesserae:
        read, written, ops = tick_cost_ffd(before, after, rows, counts, t,
                                           trace, QC)
        return read, written, ops + (n_sweep * N * 2 * n_res).sum()
    row_b = rows.shape[2] * rows.element_size()
    written, q_written = written_bytes(before, after)
    read = (fixed_reads(s, 8 + int(trace)) + run_reads(s, t)
            + row_b * n_sweep.sum() + q_written + row_b * n_take.sum()
            + 4 * s.node_type.numel())
    return read, written, (n_sweep * N * (n_res + 2)).sum()


def io_diff(a, b) -> float:
    """Largest |a - b| over two tuples of emit outputs (want, bjob_vec,
    ret_rows, ret_valid); a bool counts its differing elements."""
    worst = 0.0
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"emit output {x.dtype}{tuple(x.shape)} vs "
                                 f"{y.dtype}{tuple(y.shape)}")
        if x.dtype == torch.bool:
            d = float((x != y).sum())
        else:
            d = float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
        worst = max(worst, d)
    return worst


class Checker:
    """Runs kernel-vs-plain comparisons on copies of one state and keeps
    the worst difference and the plain version's times."""

    def __init__(self, engine, params=None):
        from multi_cluster_simulator_tpu_torch.core.state import clone_state
        from multi_cluster_simulator_tpu_torch.kernels import fused_tick

        self.ft, self.clone, self.engine = fused_tick, clone_state, engine
        self.params = engine._default_params if params is None else params
        self.host = fused_tick.host_params(engine, self.params)
        self.worst, self.n, self.plain_ms = 0.0, 0, []

    def compare(self, state, rows, counts, t, lent_rows=False, emit=False):
        """Run kernel and plain on copies of ``state`` and require every
        leaf equal — and with ``emit`` (the emit form) every output:
        ``want``, ``bjob_vec``, ``ret_rows``, ``ret_valid``; returns the
        kernel's state (and its outputs with ``emit``). ``lent_rows``
        first loads the tick's arrival rows into the lent queue too, so
        the FIFO lent-head attempt runs (the lent queue stays empty on
        the paths without borrowing)."""
        if lent_rows:
            state = self.clone(state)
            K = min(rows.shape[1], state.lent.capacity)
            state.lent.data[:, :K] = rows[:, :K]
            state.lent.count.copy_(counts.clamp(max=K))
        ref_in = self.clone(state)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ref, *ref_io = self.ft.fused_prefix_reference(
            self.engine, ref_in, rows, counts, t, self.params,
            self.host["member"], emit_returns=emit)
        ev[1].record()
        out, *io = self.ft.fused_prefix(self.engine, self.clone(state), rows,
                                        counts, t, self.params, self.host,
                                        emit_returns=emit)
        torch.cuda.synchronize()
        self.plain_ms.append(ev[0].elapsed_time(ev[1]))
        d = max_abs_diff(ref, out)
        if emit:
            d = max(d, io_diff(ref_io, io))
        if d:
            kernel = self.host["emit_kernel" if emit else "kernel"].name
            raise AssertionError(f"{kernel} differs from plain at t={t}: "
                                 f"max |diff| {d}")
        self.worst, self.n = max(self.worst, d), self.n + 1
        return (out, io) if emit else out


def timed_launch(fused_tick, engine, state, rows, counts, t, params, host,
                 emit=False, out=None):
    """One kernel launch between a CUDA event pair, with the card kept
    busy ahead of it so the pair times the kernel and not the host;
    ``emit`` launches the emit form into ``out``."""
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(SPIN_CYCLES)
    ev[0].record()
    fused_tick.fused_prefix(engine, state, rows, counts, t, params, host,
                            emit_returns=emit, out=out)
    ev[1].record()
    return ev


def phase_kernel_vs_plain(P, E, card, dev):
    """Phases 3a and 3b: the FIFO kernel against its plain version."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, empty_io, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = headline_cfg(P)
    engine = E.Engine(cfg, device=dev)
    params = engine._default_params
    host = fused_tick.host_params(engine, params)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(HEADLINE_C)]
    n_ticks = HORIZON_MS // cfg.tick_ms + 70
    arr = uniform_stream(HEADLINE_C, JOBS, HORIZON_MS, max_cores=8,
                         max_mem=6_000, max_dur_ms=60_000, seed=9)
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), cfg.tick_ms)
    chk = Checker(engine)

    # (a) the headline run, driven tick by tick through the kernel with a
    # CUDA event pair around every launch; at sampled ticks (the chunk
    # edges, the busiest tick of each chunk, spread points) kernel and
    # plain run on copies of the state the run has reached.
    state = init_state(cfg, specs, device=dev)
    evs, read_b, written_b, t, k_glob = [], 0, 0, 0, 0
    max_wait, max_k, n_sampled = 0, 0, 0
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(dev)
        counts_all = torch.from_numpy(ch.counts).to(dev)
        busiest = int(np.argmax(ch.counts.max(axis=1)))
        sample = {0, busiest, ch.rows.shape[0] - 1, ch.rows.shape[0] // 2}
        for k in range(ch.rows.shape[0]):
            t += cfg.tick_ms
            rows, counts = rows_all[k], counts_all[k]
            if k in sample:
                chk.compare(state, rows, counts, t)
                chk.compare(state, rows, counts, t, lent_rows=True)
                max_wait = max(max_wait, int(state.wait.count.max()))
                max_k = max(max_k, int(ch.counts[k].max()))
                n_sampled += 1
            before = clone_state(state)
            evs.append(timed_launch(fused_tick, engine, state, rows, counts,
                                    t, params, host))
            r, w = tick_bytes(before, state, rows, counts, t, cfg.record_trace)
            read_b, written_b = read_b + r, written_b + w
            state.t.fill_(t)
            k_glob += 1
    torch.cuda.synchronize()
    kernel_ms = [a.elapsed_time(b) for a, b in evs]
    read_b, written_b = int(read_b) / k_glob, int(written_b) / k_glob
    print(f"phase 3a: FIFO kernel == plain bitwise on {n_sampled} sampled "
          f"headline ticks at C={HEADLINE_C}, each as reached and with the "
          f"lent queue loaded ({chk.n} comparisons; max arrivals/tick "
          f"{max_k}, max wait depth {max_wait}) [{card}]")

    # the emit form (run_io's) on the headline's first chunk again: every
    # launch timed, kernel == plain on state and outputs at two ticks
    ch = chunks[0]
    rows_all = torch.from_numpy(ch.rows).to(dev)
    counts_all = torch.from_numpy(ch.counts).to(dev)
    io = empty_io((HEADLINE_C,), engine.n_msgs(), dev)
    state, t, evs = init_state(cfg, specs, device=dev), 0, []
    busiest = int(np.argmax(ch.counts.max(axis=1)))
    for k in range(ch.rows.shape[0]):
        t += cfg.tick_ms
        if k in (0, busiest):
            chk.compare(state, rows_all[k], counts_all[k], t, emit=True)
        evs.append(timed_launch(fused_tick, engine, state, rows_all[k],
                                counts_all[k], t, params, host, emit=True,
                                out=io))
        state.t.fill_(t)
    torch.cuda.synchronize()
    emit_ms = [a.elapsed_time(b) for a, b in evs]
    print(f"phase 3a: emit form == plain bitwise at 2 headline ticks; "
          f"{np.mean(emit_ms) * 1e3:.2f} us/launch mean over the first "
          f"{len(emit_ms)} headline ticks, the terminal form "
          f"{np.mean(kernel_ms[:len(emit_ms)]) * 1e3:.2f} on the same ticks "
          f"[{card}]")

    # heavier streams at the same width and shapes, every tick compared:
    # many small long jobs fill the running set (run_full), big jobs stop
    # the drain on a job no node fits, and both overflow the ready queue
    # (drops.queue). Without borrowing the wait queue holds at most the
    # one job the drain stopped on.
    seen = {"queue": 0, "run_full": 0, "wait": 0}
    for seed, max_cores, max_mem in ((11, 4, 3_000), (12, 32, 24_000)):
        heavy = uniform_stream(HEADLINE_C, 300, 30_000, max_cores=max_cores,
                               max_mem=max_mem, max_dur_ms=60_000, seed=seed)
        ch = E.pack_arrivals_chunks(heavy, [30], cfg.tick_ms)[0]
        state = init_state(cfg, specs, device=dev)
        rows_all = torch.from_numpy(ch.rows).to(dev)
        counts_all = torch.from_numpy(ch.counts).to(dev)
        t = 0
        for k in range(ch.rows.shape[0]):
            t += cfg.tick_ms
            state = chk.compare(state, rows_all[k], counts_all[k], t)
            state.t.fill_(t)
            seen["wait"] += int((state.wait.count > 0).sum())
        seen["queue"] += int(state.drops.queue.sum())
        seen["run_full"] += int(state.drops.run_full.sum())
    print(f"phase 3a: FIFO kernel == plain bitwise on 2 x 30 heavy ticks at "
          f"C={HEADLINE_C}: drops.queue {seen['queue']}, drops.run_full "
          f"{seen['run_full']}, cluster-ticks with a waiting job "
          f"{seen['wait']} [{card}]")
    if not all(seen.values()):
        raise AssertionError(f"the heavy streams missed a branch: {seen}")

    # (b) a whole 256-cluster headline run (with the placement trace on):
    # the kernel through Engine.run_chunks, the plain version tick by tick.
    cfg_t = headline_cfg(P, record_trace=True, max_trace_events=512)
    eng_t = E.Engine(cfg_t, device=dev)
    specs_t = [P.uniform_cluster(c + 1, 5) for c in range(RUN_C)]
    arr_t = uniform_stream(RUN_C, JOBS, HORIZON_MS, max_cores=8, max_mem=6_000,
                           max_dur_ms=60_000, seed=9)
    ch_t = E.pack_arrivals_chunks(arr_t, chunk_sizes(n_ticks),
                                  cfg.tick_ms)[:WHOLE_RUN_CHUNKS]
    plain_run_s, kernel_run_s, out = whole_run_against_plain(
        E, eng_t, init_state(cfg_t, specs_t, device=dev), ch_t, "FIFO")
    placed = int(out.placed_total.sum())
    print(f"phase 3b: {RUN_C}-cluster headline run, its first "
          f"{sum(c.rows.shape[0] for c in ch_t)} ticks, FIFO kernel == plain "
          f"on every leaf and the trace ({placed} placements); run wall "
          f"plain {plain_run_s:.3f} s, kernel {kernel_run_s:.3f} s [{card}]")
    return dict(worst=chk.worst, kernel_ms=kernel_ms, plain_ms=chk.plain_ms,
                read_per_launch=read_b, written_per_launch=written_b,
                emit_ms=emit_ms)


def whole_run_against_plain(E, engine, s0, chunks, what, params=None):
    """A whole run through ``engine.run_chunks`` (the kernel) and through
    the plain version tick by tick — with borrowing, the plain prefix's
    emit form and the engine's delivery and matching after it — from
    copies of ``s0``; every leaf of the two final states must be equal.
    Returns the two walls and the kernel's final state."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    params = engine._default_params if params is None else params
    member = engine.member(params)
    ref = clone_state(s0)
    t = 0
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(s0.device)
        counts_all = torch.from_numpy(ch.counts).to(s0.device)
        for k in range(ch.rows.shape[0]):
            t += engine.cfg.tick_ms
            ref, *io = fused_tick.fused_prefix_reference(
                engine, ref, rows_all[k], counts_all[k], t, params, member,
                emit_returns=engine.cfg.borrowing)
            ref = engine._cross_cluster(ref, *io)
            ref.t.fill_(t)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - w0
    w0 = time.perf_counter()
    out = engine.run_chunks(clone_state(s0), chunks, params)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - w0
    d = max_abs_diff(ref, out)
    if d:
        raise AssertionError(f"whole {what} run: kernel differs from plain "
                             f"(max |diff| {d})")
    return plain_s, kernel_s, out


def counted_run(engine, s0, chunks, kernel, io=None):
    """The main path's counted run: every launch count set to 0 just
    before ``engine.run_chunks``, read just after. ``kernel`` must have
    launched once per tick and no other kernel at all. With ``io`` (a
    dict of counters) the run goes through ``engine.run_io`` chunk by
    chunk instead, and adds every tick's wants and returns to ``io``.
    Returns the final state, the wall and the counts."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    state = clone_state(s0)
    n_ticks = sum(ch.rows.shape[0] for ch in chunks)
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    w0 = time.perf_counter()
    if io is None:
        out = engine.run_chunks(state, chunks)
    else:
        out = state
        for ch in chunks:
            out, tio = engine.run_io(out, ch.rows, ch.counts)
            io["want"] = io["want"] + tio.borrow_want.sum()
            io["returns"] = io["returns"] + tio.ret_valid.sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    counts = fused_tick.launch_counts()
    want = {k: (n_ticks if k == kernel else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, want {want}")
    return out, wall, counts


def check_gates(out, n_ticks, tick_ms, n_jobs, min_placed, what):
    """The reference's asserts on a main-path run: zero drops on every
    counter, enough placed, conservation, and the clock."""
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )

    drops = total_drops(out)
    if any(drops.values()):
        raise AssertionError(f"{what}: static bounds bound: {drops}")
    placed = int(out.placed_total.sum())
    if placed < min_placed * n_jobs:
        raise AssertionError(f"{what}: only {placed}/{n_jobs} placed")
    check_conservation(out)
    if int(out.t) != n_ticks * tick_ms:
        raise AssertionError(f"{what}: clock {int(out.t)} after {n_ticks} "
                             f"ticks")
    return placed, drops


def timed_runs(engine, s0, chunks, warmups, runs):
    """Walls of ``runs`` whole runs after ``warmups``, the chunks'
    host->device copies alone (run_chunks makes the same copies from the
    same pageable numpy arrays, one per chunk), and the last run's final
    state."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for ch in chunks:
        torch.from_numpy(ch.rows).to(s0.device)
        torch.from_numpy(ch.counts).to(s0.device)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - w0
    walls = []
    for i in range(warmups + runs):
        state = clone_state(s0)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        state = engine.run_chunks(state, chunks)
        torch.cuda.synchronize()
        if i >= warmups:
            walls.append(time.perf_counter() - w0)
    return walls, h2d_s, state


def print_run(label, what, placed, walls, first_s, n_ticks, chunks, h2d_s,
              card):
    wmin, wmed = min(walls), float(np.median(walls))
    print(f"{label}: {what} jobs/s {placed / wmin:.1f} (min of {len(walls)}), "
          f"{placed / wmed:.1f} (median); wall min {wmin:.4f} s, median "
          f"{wmed:.4f} s, first run {first_s:.4f} s; walls "
          f"{[round(w, 4) for w in walls]}; us/tick {1e6 * wmin / n_ticks:.1f}"
          f" [{card}]")
    print(f"{label}: host->device copies of the {len(chunks)} chunks alone "
          f"{h2d_s:.4f} s for {sum(ch.nbytes() for ch in chunks)} B (K per "
          f"chunk {[ch.rows.shape[2] for ch in chunks]}) [{card}]")
    return wmin, wmed


def phase_headline(P, E, card, dev):
    """Phase 4a: the full headline through the port's entry points."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = headline_cfg(P)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(HEADLINE_C)]
    n_ticks = HORIZON_MS // cfg.tick_ms + 70
    arr = uniform_stream(HEADLINE_C, JOBS, HORIZON_MS, max_cores=8,
                         max_mem=6_000, max_dur_ms=60_000, seed=9)
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), cfg.tick_ms)
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, specs, device=dev)

    out, first_s, counts = counted_run(engine, s0, chunks,
                                       "fused_prefix_fifo")
    placed, drops = check_gates(out, n_ticks, cfg.tick_ms, HEADLINE_C * JOBS,
                                0.99, "headline")
    walls, h2d_s, _ = timed_runs(engine, s0, chunks, WARMUPS, TIMED_RUNS)
    print(f"phase 4a: headline {HEADLINE_C} clusters x {JOBS} jobs, "
          f"{n_ticks} ticks: placed {placed}, drops {drops}, launches "
          f"{counts}, conservation ok [{card}]")
    wmin, wmed = print_run("phase 4a", "headline", placed, walls, first_s,
                           n_ticks, chunks, h2d_s, card)
    return dict(launches=counts["fused_prefix_fifo"], placed=placed,
                wall_min_s=wmin, wall_median_s=wmed, n_ticks=n_ticks,
                h2d_s=h2d_s)


def borg_stream(E, C, jobs, horizon_ms, tick_ms):
    """bench_borg4k's stream and its 400-tick ragged-K chunks."""
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        borg_like_stream,
    )

    arr = borg_like_stream(C, jobs, horizon_ms, max_cores=32, max_mem=24_000,
                           seed=19)
    n_ticks = horizon_ms // tick_ms + 100
    return E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), tick_ms), n_ticks


def sampled_kernel_pass(fused_tick, chk, engine, s0, chunks, picks, QC,
                        cost=None):
    """Drive a whole run tick by tick through the kernel, a CUDA event
    pair around every launch and the tick's bytes and operations counted
    (by ``cost(before, after, rows, counts, t)``, FFD's by default); at
    the global ticks in ``picks`` compare kernel and plain on the state
    the run has reached. Returns the per-launch times, the mean bytes read
    and written and the mean operations per launch, the worst Level0 and
    Level1 depths seen, and the final state."""
    if cost is None:
        def cost(before, after, rows, counts, t):
            return tick_cost_ffd(before, after, rows, counts, t,
                                 engine.cfg.record_trace, QC)
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    params, host = chk.params, chk.host
    dev = s0.device
    state = clone_state(s0)
    evs, read_b, written_b, ops, t, k_glob = [], 0, 0, 0, 0, 0
    max_l0 = torch.zeros((), dtype=torch.int32, device=dev)
    max_l1 = torch.zeros((), dtype=torch.int32, device=dev)
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(dev)
        counts_all = torch.from_numpy(ch.counts).to(dev)
        for k in range(ch.rows.shape[0]):
            t += engine.cfg.tick_ms
            rows, counts = rows_all[k], counts_all[k]
            if k_glob in picks:
                chk.compare(state, rows, counts, t)
            before = clone_state(state)
            evs.append(timed_launch(fused_tick, engine, state, rows, counts,
                                    t, params, host))
            r, w, o = cost(before, state, rows, counts, t)
            read_b, written_b, ops = read_b + r, written_b + w, ops + o
            max_l0 = torch.maximum(max_l0, state.l0.count.max())
            max_l1 = torch.maximum(max_l1, state.l1.count.max())
            state.t.fill_(t)
            k_glob += 1
    torch.cuda.synchronize()
    return dict(kernel_ms=[a.elapsed_time(b) for a, b in evs],
                read=int(read_b) / k_glob, written=int(written_b) / k_glob,
                ops=int(ops) / k_glob, max_l0=int(max_l0),
                max_l1=int(max_l1), ticks=k_glob, state=state)


def pick_ticks(chunks, n):
    """``n`` global ticks spread over a run: the diurnal peak (the tick
    with the most arrivals over all clusters), the busiest single
    cluster's tick, and evenly spaced others. Returns (picks, peak)."""
    counts = np.concatenate([ch.counts for ch in chunks])  # [T, C]
    T = counts.shape[0]
    peak = int(np.argmax(counts.sum(axis=1)))
    picks = {peak, int(np.argmax(counts.max(axis=1)))}
    for x in np.linspace(0, T - 1, n):
        if len(picks) == n:
            break
        picks.add(int(x))
    return picks, peak


def phase_ffd_kernel_vs_plain(P, E, card, dev):
    """Phase 3c: the FFD kernel against its plain version at borg4k's
    width and shapes."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies import kernels as K
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        borg_like_stream, uniform_stream,
    )

    cfg = borg_cfg(P)
    QC = K._sweep_len(cfg)
    engine = E.Engine(cfg, device=dev)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(BORG_C)]
    chunks, n_ticks = borg_stream(E, BORG_C, BORG_JOBS, BORG_HORIZON_MS,
                                  cfg.tick_ms)
    chk = Checker(engine)
    picks, peak = pick_ticks(chunks, BORG_SAMPLES)
    s0 = init_state(cfg, specs, device=dev)
    sp = sampled_kernel_pass(fused_tick, chk, engine, s0, chunks, picks, QC)
    print(f"phase 3c: FFD kernel == plain bitwise on {chk.n} borg4k ticks "
          f"sampled as the kernel reached them (ticks {sorted(picks)}, the "
          f"diurnal peak {peak} included), C={BORG_C}; max Level0 depth "
          f"{sp['max_l0']} [{card}]")

    # heavier streams at the same width and bounds, every tick compared:
    # a dense Borg-like stream overflows Level0 (drops.queue) and keeps
    # more than QC jobs queued (the cap binds); many small long jobs fill
    # the running set (run_full).
    seen = {"queue": 0, "run_full": 0, "capped": 0}
    heavy = [borg_like_stream(BORG_C, 400, 30_000, max_cores=32,
                              max_mem=24_000, seed=23),
             uniform_stream(BORG_C, 300, 30_000, max_cores=2, max_mem=1_000,
                            max_dur_ms=600_000, seed=24)]
    variants = [("wave", cfg, "ffd"),
                ("serial", borg_cfg(P, ffd_sweep="serial"), "ffd"),
                ("ffd-memfirst", cfg, "ffd-memfirst"),
                ("parity", borg_cfg(P, parity=True), "ffd"),
                ("trace", borg_cfg(P, record_trace=True,
                                   max_trace_events=512), "ffd")]
    for name, vcfg, policy in variants:
        veng = E.Engine(vcfg, device=dev, policies=PolicySet((policy,)))
        vchk = Checker(veng)
        for arr in heavy if name == "wave" else heavy[:1]:
            ch = E.pack_arrivals_chunks(arr, [30], vcfg.tick_ms)[0]
            state = init_state(vcfg, specs, device=dev)
            rows_all = torch.from_numpy(ch.rows).to(dev)
            counts_all = torch.from_numpy(ch.counts).to(dev)
            t = 0
            for k in range(ch.rows.shape[0]):
                t += vcfg.tick_ms
                pre = (state.l0.count + counts_all[k]).clamp(
                    max=vcfg.queue_capacity)
                seen["capped"] += int((pre > K._sweep_len(vcfg)).sum())
                state = vchk.compare(state, rows_all[k], counts_all[k], t)
                state.t.fill_(t)
            if name == "wave":
                seen["queue"] += int(state.drops.queue.sum())
                seen["run_full"] += int(state.drops.run_full.sum())
        chk.worst = max(chk.worst, vchk.worst)
        print(f"phase 3c: FFD kernel == plain bitwise, {name} form, "
              f"{vchk.n} heavy ticks at C={BORG_C} [{card}]")
    print(f"phase 3c: the heavy streams fired drops.queue {seen['queue']}, "
          f"drops.run_full {seen['run_full']}, capped cluster-ticks "
          f"{seen['capped']} [{card}]")
    if not all(seen.values()):
        raise AssertionError(f"the heavy streams missed a branch: {seen}")

    # a whole run at bench_borg4k(quick=True)'s shape, the trace on
    qc_, qj, qh = BORG_QUICK
    cfg_q = borg_cfg(P, jobs=qj, record_trace=True, max_trace_events=512)
    eng_q = E.Engine(cfg_q, device=dev)
    ch_q, _ = borg_stream(E, qc_, qj, qh, cfg_q.tick_ms)
    ch_q = ch_q[:WHOLE_RUN_CHUNKS]
    nq = sum(c.rows.shape[0] for c in ch_q)
    specs_q = [P.uniform_cluster(c + 1, 5) for c in range(qc_)]
    plain_s, kernel_s, out = whole_run_against_plain(
        E, eng_q, init_state(cfg_q, specs_q, device=dev), ch_q, "FFD")
    print(f"phase 3c: borg4k quick run ({qc_} clusters x {qj} jobs, its "
          f"first {nq} ticks), FFD kernel == plain on every leaf and the "
          f"trace ({int(out.placed_total.sum())} placements); run wall "
          f"plain {plain_s:.3f} s, kernel {kernel_s:.3f} s [{card}]")
    return dict(worst=chk.worst, plain_ms=chk.plain_ms, sampled=sp,
                chunks=chunks, n_ticks=n_ticks, specs=specs)


def phase_borg4k(P, E, card, dev, borg):
    """Phase 4b: bench_borg4k at full shape through the entry points."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state

    cfg = borg_cfg(P)
    engine = E.Engine(cfg, device=dev)
    chunks, n_ticks = borg["chunks"], borg["n_ticks"]
    s0 = init_state(cfg, borg["specs"], device=dev)
    out, first_s, counts = counted_run(engine, s0, chunks,
                                       "fused_prefix_ffd")
    n_jobs = BORG_C * BORG_JOBS
    placed, drops = check_gates(out, n_ticks, cfg.tick_ms, n_jobs, 0.95,
                                "borg4k")
    walls, h2d_s, _ = timed_runs(engine, s0, chunks, BORG_WARMUPS,
                                 BORG_TIMED)
    print(f"phase 4b: borg4k {BORG_C} clusters x {BORG_JOBS} jobs, "
          f"{n_ticks} ticks: placed {placed} of {n_jobs} "
          f"({100 * placed / n_jobs:.3f}%), drops {drops}, launches "
          f"{counts}, conservation ok [{card}]")
    wmin, wmed = print_run("phase 4b", "borg4k", placed, walls, first_s,
                           n_ticks, chunks, h2d_s, card)
    return dict(launches=counts["fused_prefix_ffd"], placed=placed,
                wall_min_s=wmin, wall_median_s=wmed, n_ticks=n_ticks,
                h2d_s=h2d_s)


def phase_ffd64(P, E, card, dev):
    """Phase 4c: bench_ffd64, Level0 768 deep: 8 sampled ticks compared,
    then one full run with the reference's asserts."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies import kernels as K
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = ffd64_cfg(P)
    engine = E.Engine(cfg, device=dev)
    specs = [P.uniform_cluster(c + 1, 10) for c in range(FFD64_C)]
    arr = uniform_stream(FFD64_C, FFD64_JOBS, FFD64_HORIZON_MS, max_cores=4,
                         max_mem=3_000, max_dur_ms=30_000, seed=3)
    n_ticks = FFD64_HORIZON_MS // cfg.tick_ms + 100
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), cfg.tick_ms)
    s0 = init_state(cfg, specs, device=dev)
    chk = Checker(engine)
    picks, _ = pick_ticks(chunks, FFD64_SAMPLES)
    sp = sampled_kernel_pass(fused_tick, chk, engine, s0, chunks, picks,
                             K._sweep_len(cfg))
    out, first_s, counts = counted_run(engine, s0, chunks,
                                       "fused_prefix_ffd")
    n_jobs = FFD64_C * FFD64_JOBS
    placed, drops = check_gates(out, n_ticks, cfg.tick_ms, n_jobs, 0.95,
                                "ffd64")
    kms = float(np.mean(sp["kernel_ms"]))
    print(f"phase 4c: ffd64 {FFD64_C} clusters x {FFD64_JOBS} jobs, {n_ticks}"
          f" ticks: FFD kernel == plain bitwise on {chk.n} sampled ticks "
          f"(max Level0 depth {sp['max_l0']} of {cfg.queue_capacity}); placed "
          f"{placed} of {n_jobs}, drops {drops}, launches {counts}, "
          f"conservation ok; jobs/s {placed / first_s:.1f} (one run, wall "
          f"{first_s:.4f} s); kernel {kms * 1e3:.2f} us/launch mean over "
          f"{len(sp['kernel_ms'])} launches, plain "
          f"{np.mean(chk.plain_ms):.3f} ms [{card}]")
    return dict(worst=chk.worst)


def heavy_ticks(E, chk, cfg, specs, arr, dev, seen, watch):
    """30 ticks of ``arr`` at ``cfg``, every tick compared kernel against
    plain from the state the last tick reached; ``watch`` adds each
    tick's firings (before, after, rows, counts) into ``seen``."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )

    ch = E.pack_arrivals_chunks(arr, [30], cfg.tick_ms)[0]
    state = init_state(cfg, specs, device=dev)
    rows_all = torch.from_numpy(ch.rows).to(dev)
    counts_all = torch.from_numpy(ch.counts).to(dev)
    t = 0
    for k in range(ch.rows.shape[0]):
        t += cfg.tick_ms
        before = clone_state(state)
        state = chk.compare(state, rows_all[k], counts_all[k], t)
        watch(seen, before, state, rows_all[k], counts_all[k])
        state.t.fill_(t)
    return state


def delay_firings(QC):
    """A ``watch`` for DELAY: promotions (Level1 grows only by them),
    promotions dropped by a full Level1 (the tick's drops.queue less the
    ingest's), run_full, and the parity skip (a Level1 slot placed while
    a later slot was still inside the sweep; needs the trace)."""
    from multi_cluster_simulator_tpu_torch.core.state import SRC_L1

    def watch(seen, before, after, rows, counts):
        room = before.l0.data.shape[1] - before.l0.count
        ingest_drops = (counts.clamp(0, rows.shape[1]) - room).clamp(min=0)
        seen["promoted"] += int((after.l1.count > before.l1.count).sum())
        seen["l1_full"] += int((after.drops.queue - before.drops.queue
                                - ingest_drops).sum())
        seen["run_full"] += int((after.drops.run_full
                                 - before.drops.run_full).sum())
        if after.trace.t.shape[1] == 1:
            return
        n0, n1 = before.trace.n.cpu().numpy(), after.trace.n.cpu().numpy()
        ids = before.l1.data[..., 0].cpu().numpy()
        l1n = before.l1.count.cpu().numpy()
        job = after.trace.job.cpu().numpy()
        src = after.trace.src.cpu().numpy()
        for c in np.nonzero(n1 > n0)[0]:
            n_sweep = min(int(l1n[c]), QC)
            new = slice(int(n0[c]), int(n1[c]))
            placed = set(job[c, new][src[c, new] == SRC_L1].tolist())
            seen["skips"] += sum(1 for i in range(n_sweep - 1)
                                 if ids[c, i] in placed)
    return watch


def level0_firings(QC):
    """A ``watch`` for the Level0 sweeps: drops.queue, run_full, and the
    per-tick cap binding."""
    def watch(seen, before, after, rows, counts):
        pre = (before.l0.count + counts.clamp(0, rows.shape[1])).clamp(
            max=before.l0.data.shape[1])
        seen["queue"] += int((after.drops.queue - before.drops.queue).sum())
        seen["run_full"] += int((after.drops.run_full
                                 - before.drops.run_full).sum())
        seen["capped"] += int((pre > QC).sum())
    return watch


def phase_delay_kernel_vs_plain(P, E, card, dev, market):
    """Phase 3d: the DELAY kernel against its plain version."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies import kernels as K
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    out = {}
    # the sampled passes of runs (a) and (d) at full width: every launch
    # timed, kernel == plain at the picked ticks
    for name, n_picks in (("a", MARKET_SAMPLES), ("d", 4)):
        policy, kw, _ = MARKET_RUNS[name]
        cfg = market_cfg(P, **kw)
        QC = K._sweep_len(cfg)
        engine = E.Engine(cfg, device=dev, policies=PolicySet((policy,)))
        chk = Checker(engine)
        picks, peak = pick_ticks(market["chunks"], n_picks)

        def cost(b, a, r, c, t, cfg=cfg, QC=QC):
            return tick_cost_delay(b, a, r, c, t, cfg.record_trace, QC)

        sp = sampled_kernel_pass(fused_tick, chk, engine,
                                 init_state(cfg, market["specs"], device=dev),
                                 market["chunks"], picks, QC, cost)
        out[name] = dict(sampled=sp, worst=chk.worst, plain_ms=chk.plain_ms)
        print(f"phase 3d: DELAY kernel == plain bitwise on {chk.n} ticks of "
              f"run ({name}) sampled as the kernel reached them (ticks "
              f"{sorted(picks)}, the peak {peak} included), C={MARKET_C}; "
              f"max Level0 depth {sp['max_l0']}, Level1 {sp['max_l1']} "
              f"[{card}]")

    # heavier streams at the same width, every tick compared, on an
    # 8-deep queue so that 30 ticks fill Level1: a dense stream fires
    # promotion (delay-eager: after 2 s), a full Level1 and drops.queue;
    # many small long jobs fill the running set (run_full)
    C = MARKET_C
    specs = market_specs(P, C)
    heavy = [uniform_stream(C, 300, 30_000, max_cores=24, max_mem=18_000,
                            max_dur_ms=40_000, seed=31, max_gpus=2,
                            gpu_frac=0.1),
             uniform_stream(C, 300, 30_000, max_cores=2, max_mem=1_000,
                            max_dur_ms=600_000, seed=32)]
    tight = dict(queue_capacity=8, max_running=24)
    trace = dict(record_trace=True, max_trace_events=512)
    variants = [("wave", market_cfg(P, **tight), "delay-eager"),
                ("serial", market_cfg(P, delay_sweep="serial", **tight),
                 "delay-eager"),
                ("parity", market_cfg(P, parity=True, **tight, **trace),
                 "delay-eager"),
                ("delay", market_cfg(P, **tight, **trace), "delay")]
    seen = dict(promoted=0, l1_full=0, run_full=0, skips=0)
    worst = max(o["worst"] for o in out.values())
    for name, vcfg, policy in variants:
        veng = E.Engine(vcfg, device=dev, policies=PolicySet((policy,)))
        vchk = Checker(veng)
        watch = delay_firings(K._sweep_len(vcfg))
        for arr in heavy if name in ("wave", "parity") else heavy[:1]:
            heavy_ticks(E, vchk, vcfg, specs, arr, dev, seen, watch)
        worst = max(worst, vchk.worst)
        print(f"phase 3d: DELAY kernel == plain bitwise, {name} form "
              f"({policy}), {vchk.n} heavy ticks at C={C} [{card}]")
    print(f"phase 3d: the heavy streams fired promotion {seen['promoted']} "
          f"cluster-ticks, full-Level1 drops {seen['l1_full']}, "
          f"drops.run_full {seen['run_full']}, parity skips "
          f"{seen['skips']} [{card}]")
    if not all(seen.values()):
        raise AssertionError(f"the heavy streams missed a branch: {seen}")

    # a whole run at sinkhorn_market_setup(quick=True)'s shape, trace on
    qc_, qj = MARKET_QUICK
    cfg_q = market_cfg(P, quick=True, jobs=qj, **trace)
    eng_q = E.Engine(cfg_q, device=dev)
    ch_q, nq, _ = market_stream(E, qc_, qj, quick=True)
    plain_s, kernel_s, fin = whole_run_against_plain(
        E, eng_q, init_state(cfg_q, market_specs(P, qc_), device=dev), ch_q,
        "DELAY")
    print(f"phase 3d: whole quick market run ({qc_} clusters x {qj} jobs, "
          f"{nq} ticks), DELAY kernel == plain on every leaf and the trace "
          f"({int(fin.placed_total.sum())} placements); run wall plain "
          f"{plain_s:.3f} s, kernel {kernel_s:.3f} s [{card}]")
    out["worst"] = worst
    return out


def rl_seeded(engine):
    """The engine's params with seeded non-zero rl scores."""
    scores = np.random.default_rng(17).normal(size=(4, 4)).astype(np.float32)
    p = engine._default_params
    return p.replace(rl_scores=torch.from_numpy(scores).to(p.rl_scores.device))


def phase_scored_kernel_vs_plain(P, E, card, dev, market):
    """Phase 3e: the scored kernel against its plain version."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies import kernels as K
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    out = {}
    cfg = market_cfg(P)
    QC = K._sweep_len(cfg)
    for name, n_picks in (("b", MARKET_SAMPLES // 2),
                          ("c", MARKET_SAMPLES // 2)):
        policy = MARKET_RUNS[name][0]
        engine = E.Engine(cfg, device=dev, policies=PolicySet((policy,)))
        chk = Checker(engine)
        picks, peak = pick_ticks(market["chunks"], n_picks)

        def cost(b, a, r, c, t, tess=policy == "tesserae"):
            return tick_cost_scored(b, a, r, c, t, cfg.record_trace, QC,
                                    tess)

        sp = sampled_kernel_pass(fused_tick, chk, engine,
                                 init_state(cfg, market["specs"], device=dev),
                                 market["chunks"], picks, QC, cost)
        out[name] = dict(sampled=sp, worst=chk.worst, plain_ms=chk.plain_ms)
        print(f"phase 3e: scored kernel ({policy}) == plain bitwise on "
              f"{chk.n} ticks of run ({name}) sampled as the kernel reached "
              f"them (ticks {sorted(picks)}), C={MARKET_C}; max Level0 "
              f"depth {sp['max_l0']} [{card}]")

    # heavier streams at the same width, every tick compared: a dense
    # stream overflows Level0 and keeps more than QC jobs queued; many
    # small long jobs fill the running set (run_full)
    C = MARKET_C
    heavy = [uniform_stream(C, 300, 30_000, max_cores=24, max_mem=18_000,
                            max_dur_ms=40_000, seed=33, max_gpus=2,
                            gpu_frac=0.1),
             uniform_stream(C, 300, 30_000, max_cores=2, max_mem=1_000,
                            max_dur_ms=600_000, seed=34)]
    tight = dict(queue_capacity=16, max_running=24)
    trace = dict(record_trace=True, max_trace_events=512)
    variants = [("gavel", market_specs, "gavel", {}),
                ("tesserae", market_specs, "tesserae", trace),
                ("gavel, mixed nodes", mixed_specs, "gavel", {}),
                ("rl, seeded scores, mixed nodes", mixed_specs, "rl", trace)]
    seen = dict(queue=0, run_full=0, capped=0)
    worst = max(o["worst"] for o in out.values())
    for name, mk_specs, policy, kw in variants:
        vcfg = market_cfg(P, **tight, **kw)
        veng = E.Engine(vcfg, device=dev, policies=PolicySet((policy,)))
        vchk = Checker(veng, rl_seeded(veng) if policy == "rl" else None)
        for arr in heavy if mk_specs is market_specs else heavy[:1]:
            heavy_ticks(E, vchk, vcfg, mk_specs(P, C), arr, dev, seen,
                        level0_firings(K._sweep_len(vcfg)))
        worst = max(worst, vchk.worst)
        print(f"phase 3e: scored kernel == plain bitwise, {name}, {vchk.n} "
              f"heavy ticks at C={C} [{card}]")
    print(f"phase 3e: the heavy streams fired drops.queue {seen['queue']}, "
          f"drops.run_full {seen['run_full']}, capped cluster-ticks "
          f"{seen['capped']} [{card}]")
    if not all(seen.values()):
        raise AssertionError(f"the heavy streams missed a branch: {seen}")

    # runs at the quick market shape, the trace on, over its first chunk
    # (400 of 700 ticks): tesserae on the market's clusters, rl with
    # seeded scores on mixed nodes
    qc_, qj = MARKET_QUICK
    cfg_q = market_cfg(P, quick=True, jobs=qj, **trace)
    ch_q = market_stream(E, qc_, qj, quick=True)[0][:1]
    nq = ch_q[0].rows.shape[0]
    for policy, mk_specs in (("tesserae", market_specs), ("rl", mixed_specs)):
        eng_q = E.Engine(cfg_q, device=dev, policies=PolicySet((policy,)))
        params = rl_seeded(eng_q) if policy == "rl" else None
        plain_s, kernel_s, fin = whole_run_against_plain(
            E, eng_q, init_state(cfg_q, mk_specs(P, qc_), device=dev), ch_q,
            policy, params)
        print(f"phase 3e: quick market run ({policy}, {qc_} clusters x "
              f"{qj} jobs, its first {nq} ticks), scored kernel == plain on "
              f"every leaf and the trace ({int(fin.placed_total.sum())} "
              f"placements); run wall plain {plain_s:.3f} s, kernel "
              f"{kernel_s:.3f} s [{card}]")
    out["worst"] = worst
    return out


def phase_dispatch(P, E, card, dev):
    """Phase 3f: tools/tournament.py's lineup as one PolicySet at small
    width; each params.idx launches its member's kernel and no other, and
    the run equals the plain version."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        TickArrivals, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    cfg = market_cfg(P, record_trace=True, max_trace_events=512)
    pset = PolicySet(LINEUP)
    engine = E.Engine(cfg, device=dev, policies=pset)
    chunks, _, _ = market_stream(E, LINEUP_C, MARKET_JOBS)
    part = [TickArrivals(rows=chunks[0].rows[:LINEUP_TICKS],
                         counts=chunks[0].counts[:LINEUP_TICKS])]
    s0 = init_state(cfg, market_specs(P, LINEUP_C), device=dev)
    for idx, name in enumerate(LINEUP):
        params = pset.params_for(cfg, name, device=dev)
        want = fused_tick.host_params(engine, params)["kernel"].name
        fused_tick.reset_launches()
        _, _, fin = whole_run_against_plain(E, engine, s0, part, name,
                                            params)
        counts = fused_tick.launch_counts()
        expect = {k: (LINEUP_TICKS if k == want else 0) for k in counts}
        if counts != expect:
            raise AssertionError(f"idx {idx} ({name}): launches {counts}, "
                                 f"want {expect}")
        print(f"phase 3f: idx {idx} ({name}) ran {want} x {LINEUP_TICKS}, "
              f"== plain on every leaf ({int(fin.placed_total.sum())} "
              f"placements) [{card}]")


def phase_market(P, E, card, dev, market, name):
    """Phases 4d-4g: one full-shape market run through the entry points."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    policy, kw, gated = MARKET_RUNS[name]
    cfg = market_cfg(P, **kw)
    engine = E.Engine(cfg, device=dev, policies=PolicySet((policy,)))
    kernel = fused_tick.kernel_for(engine.member()).name
    chunks, n_ticks = market["chunks"], market["n_ticks"]
    s0 = init_state(cfg, market["specs"], device=dev)
    state_b = sum(x.numel() * x.element_size()
                  for _, x in leaves_with_keys(s0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, first_s, counts = counted_run(engine, s0, chunks, kernel)
    peak_b = torch.cuda.max_memory_allocated()
    n_jobs = MARKET_C * MARKET_JOBS
    placeable = n_jobs - market["unplaceable"]
    drops = total_drops(out)
    placed = int(out.placed_total.sum())
    check_conservation(out)
    if int(out.t) != n_ticks * cfg.tick_ms:
        raise AssertionError(f"run ({name}): clock {int(out.t)}")
    # every arrived job is placed, queued, or counted as dropped
    queued = int(out.l0.count.sum() + out.l1.count.sum())
    arrived = int(out.arr_ptr.sum())
    if placed + queued + drops["queue"] != arrived or arrived != n_jobs:
        raise AssertionError(f"run ({name}): {arrived} arrived, {placed} "
                             f"placed, {queued} queued, {drops['queue']} "
                             f"dropped")
    share = placed / placeable
    if gated and (any(drops.values()) or share < MARKET_FLOOR):
        raise AssertionError(f"run ({name}): drops {drops}, placed "
                             f"{share:.4f} of the placeable jobs")
    walls, h2d_s, _ = timed_runs(engine, s0, chunks, MARKET_WARMUPS,
                              MARKET_TIMED)
    label = f"phase 4{'defg'['abcd'.index(name)]}"
    print(f"{label}: market run ({name}) {policy} {kw or ''}: {MARKET_C} "
          f"clusters x {MARKET_JOBS} jobs, {n_ticks} ticks: placed {placed} "
          f"of {n_jobs}, unplaceable without the market "
          f"{market['unplaceable']}, placed share of the rest "
          f"{share:.4f} (gate {MARKET_FLOOR if gated else 'not applied'}), "
          f"queued at the end {queued}, drops {drops}, launches {counts}, "
          f"conservation ok; state {state_b} B, peak device memory "
          f"{peak_b} B [{card}]")
    wmin, wmed = print_run(label, f"market ({name})", placed, walls, first_s,
                           n_ticks, chunks, h2d_s, card)
    return dict(launches=counts[kernel], placed=placed, wall_min_s=wmin,
                wall_median_s=wmed, n_ticks=n_ticks, h2d_s=h2d_s,
                share=share, drops=drops)


def borrow_cfg(P, **kw):
    """bench_fifo_two_trader's config (bench.py:898-933, BASELINE config 2)
    with the trader off, as the port's."""
    base = dict(policy=P.PolicyKind.FIFO, borrowing=True,
                queue_capacity=1024, max_running=512, max_arrivals=4096,
                max_nodes=10,
                workload=P.WorkloadConfig(poisson_lambda_per_min=30.0),
                trader=P.TraderConfig(enabled=False))
    base.update(kw)
    return P.SimConfig(**base)


def borrow_specs(P, C):
    """Config 2's pair, tiled: cluster_small (5 nodes) even, cluster_big
    (10 nodes) odd."""
    return [P.uniform_cluster(c + 1, 5 if c % 2 == 0 else 10)
            for c in range(C)]


def borrow_stream(P, E, C, n_ticks=None):
    """Config 2's stream for C clusters (every cluster loaded), the
    400-tick ragged-K chunks of its first ``n_ticks``, and its number of
    jobs."""
    from multi_cluster_simulator_tpu_torch.workload.generator import (
        generate_arrivals,
    )

    arr = generate_arrivals(P.WorkloadConfig(poisson_lambda_per_min=30.0),
                            C, 4096, BORROW_HORIZON_MS, 32, 24_000, seed=9)
    chunks = chunk_sizes(BORROW_TICKS if n_ticks is None else n_ticks)
    return E.pack_arrivals_chunks(arr, chunks, 1_000), int(arr.n.sum())


def tick_cost_borrow(before, after, rows, counts, t: int, trace: bool,
                     M: int):
    """The least bytes an emit-form FIFO tick ``t`` must move on this
    tick's data, as (read, written) 0-d int64 tensors on the card.

    Written: every state element the tick changed, and per cluster the M
    return rows and flags and the borrow request (M*RF*4 + M + NF*4 + 1
    B). Read, per cluster: the arrival count and the eight counters the
    tick updates (drops.msgs among them; the trace count too), the node
    vectors, the running set's active flags, the end_t of each active
    slot and the node and resources of each released slot, the M rows the
    pack copies, the head row of each non-empty queue the pass reads
    (ready after the ingest, wait, lent), each ready row the drain
    attempted, each queue element the tick rewrote (read from its source
    slot), and the valid arrival rows. The deep queues' other live rows
    need not move."""
    s = before
    C, Qc = s.arr_ptr.shape[0], s.ready.data.shape[1]
    row_b = rows.shape[2] * rows.element_size()
    written, _ = written_bytes(before, after)
    moved = sum((q0.data != q1.data).sum() * 4 for q0, q1 in (
        (before.ready, after.ready), (before.wait, after.wait),
        (before.lent, after.lent)))
    n_take = counts.clamp(0, rows.shape[1])
    pre = (s.ready.count + n_take).clamp(max=Qc)
    drained = (pre - after.ready.count).clamp(min=0)
    heads = (pre > 0).long() + (s.wait.count > 0) + (s.lent.count > 0)
    rf = s.run.data.shape[2]
    read = (fixed_reads(s, 8 + int(trace)) + run_reads(s, t) + moved
            + row_b * (n_take.sum() + drained.sum() + heads.sum())
            + C * M * rf * 4)
    written = written + C * (M * rf * 4 + M + row_b + 1)
    return read, written


def timed_span(fn):
    """``fn()`` between a CUDA event pair, the card kept busy ahead of it
    so that the pair times the card's work and not the host's enqueue.
    Returns (fn's result, the event pair)."""
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(SPIN_CYCLES)
    ev[0].record()
    out = fn()
    ev[1].record()
    return out, ev


def borrow_pass(E, chk, s0, chunks, picks, until=None):
    """Drive a borrowing run tick by tick as ``Engine._tick`` does — the
    emit kernel, return delivery, borrow matching — each between a CUDA
    event pair; count the kernel's bytes and what fired; at the global
    ticks in ``picks`` compare kernel and plain on copies of the state the
    run has reached. Stops after ``until`` ticks when given. Returns the
    per-tick times, the mean bytes, the counts, the final state and the
    clock."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, empty_io,
    )
    from multi_cluster_simulator_tpu_torch.ops import queues as Q

    engine, params, host = chk.engine, chk.params, chk.host
    cfg, dev = engine.cfg, s0.device
    C, M = s0.arr_ptr.shape[0], engine.n_msgs()
    io = empty_io((C,), M, dev)
    state = clone_state(s0)
    evs = {"kernel": [], "deliver": [], "match": []}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fired = dict.fromkeys(("want", "returns", "msgs_dropped", "matched",
                           "lent_placed", "lent_push_dropped"), zero)
    read_b = written_b = zero
    t = k_glob = 0
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(dev)
        counts_all = torch.from_numpy(ch.counts).to(dev)
        for k in range(ch.rows.shape[0]):
            if until is not None and k_glob == until:
                break
            t += cfg.tick_ms
            rows, counts = rows_all[k], counts_all[k]
            if k_glob in picks:
                chk.compare(state, rows, counts, t, emit=True)
            before = clone_state(state)
            evs["kernel"].append(timed_launch(
                chk.ft, engine, state, rows, counts, t, params, host,
                emit=True, out=io))
            r, w = tick_cost_borrow(before, state, rows, counts, t,
                                    cfg.record_trace, M)
            read_b, written_b = read_b + r, written_b + w
            lent0 = state.lent.count.clone()
            wait0, drop0 = state.wait.count.clone(), state.drops.queue.clone()
            state, ev = timed_span(lambda: E._deliver_returns(
                state, io.ret_rows, io.ret_valid, engine.ex))
            evs["deliver"].append(ev)
            state, ev = timed_span(lambda: E._borrow_match(
                state, io.borrow_want, Q.JobRec(vec=io.borrow_job), cfg,
                engine.ex))
            evs["match"].append(ev)
            state.t.fill_(t)
            matched = (wait0 - state.wait.count).sum()
            fired["want"] = fired["want"] + io.borrow_want.sum()
            fired["returns"] = fired["returns"] + io.ret_valid.sum()
            fired["msgs_dropped"] = fired["msgs_dropped"] + (
                state.drops.msgs - before.drops.msgs).sum()
            fired["matched"] = fired["matched"] + matched
            fired["lent_placed"] = fired["lent_placed"] + (
                before.lent.count - lent0).clamp(min=0).sum()
            # the match's drops: LentQueue pushes past capacity, and
            # BorrowedQueue bookkeeping rows past it (the job still goes)
            fired["lent_push_dropped"] = fired["lent_push_dropped"] + (
                state.drops.queue - drop0).sum()
            k_glob += 1
    torch.cuda.synchronize()
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in evs.items()}
    return dict(ms=ms, read=int(read_b) / k_glob,
                written=int(written_b) / k_glob,
                fired={k: int(v) for k, v in fired.items()}, state=state,
                t=t, ticks=k_glob)


def plain_borrow_io(engine, s0, rows, counts, t0, params):
    """The plain path's ``run_io``: each tick's plain prefix in the emit
    form, the engine's delivery and matching; returns the final state and
    the stacked outputs."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    state, t, outs = clone_state(s0), t0, []
    member = engine.member(params)
    for k in range(rows.shape[0]):
        t += engine.cfg.tick_ms
        state, *io = engine._span_prefix(state, rows[k], counts[k], t,
                                         params, member, emit_returns=True)
        outs.append([x.clone() for x in io])
        state = engine._cross_cluster(state, *io)
        state.t.fill_(t)
    return state, [torch.stack(x) for x in zip(*outs)]


def phase_borrow_kernel_vs_plain(P, E, card, dev):
    """Phases 3g and 3h: the FIFO kernel's emit form against its plain
    version on the borrowing path, and ``run_io`` on the card."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        TickArrivals, clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.ops import runset as R
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.workload.generator import (
        silence_clusters,
    )
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = borrow_cfg(P)
    engine = E.Engine(cfg, device=dev)
    chk = Checker(engine)
    out = {}
    # (b): sampled ticks as the kernel reaches them, every tick timed
    chunks_b, jobs_b = borrow_stream(P, E, BORROW_C)
    s0_b = init_state(cfg, borrow_specs(P, BORROW_C), device=dev)
    picks, peak = pick_ticks(chunks_b, BORROW_SAMPLES)
    io_at = CHUNK * 2  # 3h starts from the state this tick reaches
    w0 = time.perf_counter()
    half = borrow_pass(E, chk, s0_b, chunks_b, picks, until=io_at)
    rest = borrow_pass(E, chk, half["state"], chunks_b[2:],
                       {p - io_at for p in picks if p >= io_at})
    sp = dict(ms={k: half["ms"][k] + rest["ms"][k] for k in half["ms"]},
              read=(half["read"] * io_at + rest["read"] * rest["ticks"])
              / BORROW_TICKS,
              written=(half["written"] * io_at
                       + rest["written"] * rest["ticks"]) / BORROW_TICKS,
              fired={k: half["fired"][k] + rest["fired"][k]
                     for k in half["fired"]},
              ticks=half["ticks"] + rest["ticks"])
    out["b"] = dict(sampled=sp, plain_ms=list(chk.plain_ms),
                    chunks=chunks_b, jobs=jobs_b, s0=s0_b)
    print(f"phase 3g: FIFO emit kernel == plain bitwise (state, want, "
          f"bjob_vec, ret_rows, ret_valid) on {chk.n} ticks of run (b) "
          f"sampled as the kernel reached them (ticks {sorted(picks)}, the "
          f"peak {peak} included), C={BORROW_C}; fired over the run: "
          f"{sp['fired']}; pass {time.perf_counter() - w0:.1f} s [{card}]")

    # heavy ticks at the same width: short jobs on small queues, the odd
    # clusters idle lenders, one message slot — returns past it, lent-head
    # placements, LentQueue overflow and wants all fire
    heavy_cfg = borrow_cfg(P, queue_capacity=16, max_running=24, max_msgs=1)
    heng = E.Engine(heavy_cfg, device=dev)
    hchk = Checker(heng)
    arr = silence_clusters(uniform_stream(
        BORROW_C, 300, 30_000, max_cores=16, max_mem=12_000,
        max_dur_ms=6_000, seed=41), slice(1, None, 2))
    hch = E.pack_arrivals_chunks(arr, [30], heavy_cfg.tick_ms)
    hp = borrow_pass(E, hchk, init_state(heavy_cfg, borrow_specs(
        P, BORROW_C), device=dev), hch, set(range(30)))
    print(f"phase 3g: FIFO emit kernel == plain bitwise on {hchk.n} heavy "
          f"ticks at C={BORROW_C} (queue 16, running 24, max_msgs 1): fired "
          f"{hp['fired']} [{card}]")
    if not all(hp["fired"].values()):
        raise AssertionError(f"the heavy ticks missed a branch: "
                             f"{hp['fired']}")

    # whole runs: (a), and config 2's pair tiled to 64 clusters
    for C, n_ticks in ((2, BORROW_TICKS),
                       (BORROW_TILED_C, BORROW_TILED_TICKS)):
        ch, _ = borrow_stream(P, E, C, n_ticks)
        plain_s, kernel_s, fin = whole_run_against_plain(
            E, engine, init_state(cfg, borrow_specs(P, C), device=dev), ch,
            f"borrowing ({C} clusters)")
        print(f"phase 3g: whole run, {C} clusters x {n_ticks} ticks, FIFO "
              f"emit kernel + delivery + matching == plain on every leaf "
              f"(placed {int(fin.placed_total.sum())}, borrowed rows "
              f"{int(fin.borrowed.count.sum())}, lent rows "
              f"{int(fin.lent.count.sum())}); run wall plain {plain_s:.3f} "
              f"s, kernel {kernel_s:.3f} s [{card}]")

    # 3h: run_io over one chunk of (b), from the state run (b) reached at
    # tick io_at, against the plain path's stacked TickIO
    ch = chunks_b[2]
    rows = torch.from_numpy(ch.rows[:BORROW_IO_TICKS]).to(dev)
    counts = torch.from_numpy(ch.counts[:BORROW_IO_TICKS]).to(dev)
    s_at = half["state"]
    ref_s, ref_io = plain_borrow_io(engine, s_at, rows, counts, half["t"],
                                    engine._default_params)
    fused_tick.reset_launches()
    got_s, got_io = engine.run_io(clone_state(s_at), rows, counts)
    torch.cuda.synchronize()
    launches = fused_tick.launch_counts()
    d = max(max_abs_diff(ref_s, got_s), io_diff(
        ref_io, fused_tick._outputs(got_io)))
    want = {k: (BORROW_IO_TICKS if k == "fused_prefix_fifo_emit" else 0)
            for k in launches}
    if d or launches != want:
        raise AssertionError(f"run_io: max |diff| {d}, launches {launches}")
    print(f"phase 3h: run_io over {BORROW_IO_TICKS} ticks of run (b) from "
          f"tick {io_at}, C={BORROW_C}: state and stacked TickIO == the "
          f"plain path's (wants {int(got_io.borrow_want.sum())}, returns "
          f"{int(got_io.ret_valid.sum())}), launches {launches} [{card}]")

    # the Level0 kernels' emit form: DELAY, FFD and gavel with borrowing on
    # and foreign jobs in the running sets, so that their pack carries
    # returns
    chunks_m, _, _ = market_stream(E, LINEUP_C, MARKET_JOBS)
    lead = [TickArrivals(rows=chunks_m[0].rows[:30],
                         counts=chunks_m[0].counts[:30])]
    for policy in ("delay", "ffd", "gavel"):
        mcfg = market_cfg(P, borrowing=True, max_msgs=2)
        meng = E.Engine(mcfg, device=dev, policies=PolicySet((policy,)))
        mchk = Checker(meng)
        state = init_state(mcfg, market_specs(P, LINEUP_C), device=dev)
        rows_all = torch.from_numpy(lead[0].rows).to(dev)
        counts_all = torch.from_numpy(lead[0].counts).to(dev)
        n_ret, t = 0, 0
        for k in range(30):
            t += mcfg.tick_ms
            owner = state.run.data[..., R.ROWNER]  # every third row lent
            third = (torch.arange(owner.shape[1], device=dev) % 3 == 0)
            owner.copy_(torch.where(state.run.active & third[None, :],
                                    (torch.arange(LINEUP_C, device=dev)[
                                        :, None] + 1) % LINEUP_C, owner))
            state, io = mchk.compare(state, rows_all[k], counts_all[k], t,
                                     emit=True)
            n_ret += int(io[3].sum())
            state.t.fill_(t)
        if not n_ret:
            raise AssertionError(f"{policy}: no return was packed")
        chk.worst = max(chk.worst, mchk.worst)
        print(f"phase 3g: {policy} emit form == plain bitwise on 30 ticks "
              f"at C={LINEUP_C} with foreign running rows ({n_ret} returns "
              f"packed) [{card}]")
    out["worst"] = max(chk.worst, hchk.worst)
    return out


def device_profile(E, engine, s0, chunks, n):
    """The card's time per tick on the borrowing path, by torch.profiler:
    the run to the start of its second chunk, then ``n`` ticks as
    ``Engine._tick`` runs them, each phase in a ``record_function`` range.
    Returns the card's kernel ms per tick by phase and in all
    ("kernels"), and the kernels that take most ("top")."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.ops import queues as Q

    state = engine.run_chunks(clone_state(s0), chunks[:1])
    params, host, t = engine._entry(state, None)
    rows = torch.from_numpy(chunks[1].rows[:n]).to(s0.device)
    counts = torch.from_numpy(chunks[1].counts[:n]).to(s0.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(n):
            t += engine.cfg.tick_ms
            with record_function("prefix"):
                state, *io = fused_tick.fused_prefix(
                    engine, state, rows[k], counts[k], t, params, host,
                    emit_returns=True, out=host["io"])
            with record_function("delivery"):
                state = E._deliver_returns(state, io[2], io[3], engine.ex)
            with record_function("matching"):
                state = E._borrow_match(state, io[0], Q.JobRec(vec=io[1]),
                                        engine.cfg, engine.ex)
            state.t.fill_(t)
        torch.cuda.synchronize()

    # On the card's timeline each record_function range also appears as
    # a span over its kernels; the kernels are the card's work, and each
    # counts into the phase whose span it starts in.
    phases = ("prefix", "delivery", "matching")
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in on_card if e.name in phases)
    starts = [sp[0] for sp in spans]
    out = dict.fromkeys(phases, 0.0)
    by_name, total = {}, 0.0
    for e in on_card:
        if e.name in phases:
            continue
        us = e.time_range.elapsed_us()
        total += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            out[spans[i][2]] += us
    out = {k: v / 1e3 / n for k, v in out.items()}
    out["kernels"] = total / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["top"] = "; ".join(f"{k[:60]} {v / n:.1f} us" for k, v in top)
    return out


def phase_borrow_run(P, E, card, dev, name, C, chunks, n_jobs, sampled):
    """Phases 4h and 4i: a borrowing run at full shape through the entry
    points, counted, then 3 timed runs; ``sampled`` is its tick-by-tick
    pass (per-phase times and what fired)."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    cfg = borrow_cfg(P)
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, borrow_specs(P, C), device=dev)
    state_b = sum(x.numel() * x.element_size()
                  for _, x in leaves_with_keys(s0))
    # where the sampled pass saw only part of the run, the counted run goes
    # through run_io and counts every tick's wants and returns
    io = (dict(want=0, returns=0) if sampled["ticks"] < BORROW_TICKS
          else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, first_s, counts = counted_run(engine, s0, chunks,
                                       "fused_prefix_fifo_emit", io)
    peak_b = torch.cuda.max_memory_allocated()
    drops = total_drops(out)
    check_conservation(out)
    if int(out.t) != BORROW_TICKS * cfg.tick_ms:
        raise AssertionError(f"run ({name}): clock {int(out.t)}")
    if name == "a" and any(drops.values()):  # bench.py:925
        raise AssertionError(f"run (a): static bounds bound: {drops}")
    placed = int(out.placed_total.sum())
    arrived = int(out.arr_ptr.sum())
    held = {k: int(getattr(out, k).count.sum())
            for k in ("ready", "wait", "lent", "borrowed")}
    balance = placed + held["ready"] + held["wait"] + held["lent"] \
        + drops["queue"] - arrived
    fired = (sampled["fired"] if io is None
             else {k: int(v) for k, v in io.items()})
    # the counted run just before is the warm-up
    walls, h2d_s, last = timed_runs(engine, s0, chunks, 0, TIMED_RUNS)
    d = 0 if io is None else max_abs_diff(last, out)
    if d:
        raise AssertionError(f"run ({name}): run_chunks differs from "
                             f"run_io over the chunks ({d})")
    prof = device_profile(E, engine, s0, chunks, BORROW_PROFILE_TICKS)
    label = "phase 4h" if name == "a" else "phase 4i"
    print(f"{label}: run ({name}) config 2, trader off, {C} clusters, "
          f"{BORROW_TICKS} ticks: {n_jobs} jobs, arrived {arrived}, placed "
          f"{placed}, held {held}, drops {drops}; job count placed + ready "
          f"+ wait + lent + drops.queue - arrived = {balance} (BorrowedQueue "
          f"overflow drops count a bookkeeping row, not a job), launches "
          f"{counts}, conservation ok; state {state_b} B, peak device memory "
          f"{peak_b} B [{card}]")
    wmin, wmed = print_run(label, f"run ({name})", placed, walls, first_s,
                           BORROW_TICKS, chunks, h2d_s, card)
    ms = {k: float(np.mean(v)) for k, v in sampled["ms"].items()}
    busy = prof["kernels"] * BORROW_TICKS / 1e3
    metric = ("fifo_two_cluster_borrow_ticks_per_sec" if name == "a"
              else "borrow_4k ticks/s")
    print(f"{label}: {metric} "
          f"{BORROW_TICKS / wmin:.1f} (min), {BORROW_TICKS / wmed:.1f} "
          f"(median); per tick, CUDA event spans over "
          f"{len(sampled['ms']['kernel'])} ticks, the card kept busy ahead "
          f"of each (a span holds host time where the host enqueues "
          f"slower than the card runs): kernel {ms['kernel'] * 1e3:.2f} us, "
          f"delivery {ms['deliver'] * 1e3:.2f} us, matching "
          f"{ms['match'] * 1e3:.2f} us; the card's own time per tick "
          f"(torch.profiler over {BORROW_PROFILE_TICKS} ticks from tick "
          f"{CHUNK}): prefix {prof['prefix'] * 1e3:.2f} us, delivery "
          f"{prof['delivery'] * 1e3:.2f} us, matching "
          f"{prof['matching'] * 1e3:.2f} us, all kernels "
          f"{prof['kernels'] * 1e3:.2f} us; card busy "
          f"{100 * busy / wmin:.1f}% of the min wall, idle "
          f"{100 - 100 * busy / wmin:.1f}%; fired {fired} [{card}]")
    print(f"{label}: the card's kernels per tick by name: {prof['top']} "
          f"[{card}]")
    return dict(launches=counts["fused_prefix_fifo_emit"], placed=placed,
                wall_min_s=wmin, wall_median_s=wmed, n_ticks=BORROW_TICKS,
                h2d_s=h2d_s, drops=drops, balance=balance, profile=prof)


def bound(read, written, ops=0.0):
    """The least time (ms) for a launch's bytes and operations, and which
    of the two bounds it."""
    b_ms = 1e3 * (read + written) / HBM_BYTES_PER_S
    o_ms = 1e3 * ops / SCALAR_OPS_PER_S
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def breakdown(label, run, kernel_ms, card):
    """run_chunks copies a chunk synchronously, then enqueues its ticks;
    the kernels run while the host enqueues the next ones, so the wall is
    the copies plus the tick loop, and the kernel share is how busy the
    card is."""
    kernel_s = float(np.sum(kernel_ms)) / 1e3
    loop_s = run["wall_min_s"] - run["h2d_s"]
    print(f"breakdown of the fastest {label} run ({run['wall_min_s']:.4f} s):"
          f" host->device copies {run['h2d_s']:.4f} s, tick loop "
          f"{loop_s:.4f} s ({1e6 * loop_s / run['n_ticks']:.1f} us/tick) of "
          f"which kernel {kernel_s:.4f} s; card busy with the kernel "
          f"{100 * kernel_s / run['wall_min_s']:.1f}% of the wall [{card}]")


def main(device: str = "cuda") -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import multi_cluster_simulator_tpu_torch as P
    from multi_cluster_simulator_tpu_torch.core import engine as E
    from multi_cluster_simulator_tpu_torch.kernels import build, fused_tick

    kind, card = torch.cuda.get_device_name(0), smi_line()
    print(f"phase 1: device {kind}; nvidia-smi: {card}")
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    w0 = time.perf_counter()
    reports = build.build_all()
    print(f"phase 2: built {sorted(reports)} in "
          f"{time.perf_counter() - w0:.2f} s")
    for kernel, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 2: {kernel}: {line.strip()}")

    dev = torch.device(device)
    w0 = time.perf_counter()
    check = phase_kernel_vs_plain(P, E, card, dev)
    head = phase_headline(P, E, card, dev)
    borg = phase_ffd_kernel_vs_plain(P, E, card, dev)
    b4k = phase_borg4k(P, E, card, dev, borg)
    f64 = phase_ffd64(P, E, card, dev)
    print(f"phases 3a-c, 4a-c: {time.perf_counter() - w0:.1f} s")

    w1 = time.perf_counter()
    chunks, n_ticks, unplaceable = market_stream(E, MARKET_C, MARKET_JOBS)
    market = dict(chunks=chunks, n_ticks=n_ticks, unplaceable=unplaceable,
                  specs=market_specs(P, MARKET_C))
    print(f"market stream: {MARKET_C * MARKET_JOBS} jobs in {len(chunks)} "
          f"chunks, {sum(ch.nbytes() for ch in chunks)} B of rows (K per "
          f"chunk {[ch.rows.shape[2] for ch in chunks]}), unplaceable "
          f"without the market {unplaceable}; built in "
          f"{time.perf_counter() - w1:.1f} s")
    delay = phase_delay_kernel_vs_plain(P, E, card, dev, market)
    scored = phase_scored_kernel_vs_plain(P, E, card, dev, market)
    phase_dispatch(P, E, card, dev)
    runs = {name: phase_market(P, E, card, dev, market, name)
            for name in MARKET_RUNS}
    print(f"phases 3d-f, 4d-g: {time.perf_counter() - w1:.1f} s")

    w2 = time.perf_counter()
    borrow = phase_borrow_kernel_vs_plain(P, E, card, dev)
    bb = borrow["b"]
    chunks_a, jobs_a = borrow_stream(P, E, 2)
    chk_a = Checker(E.Engine(borrow_cfg(P), device=dev))
    sp_a = borrow_pass(E, chk_a, P.init_state(borrow_cfg(P), borrow_specs(
        P, 2), device=dev), chunks_a[:1], set())
    run_a = phase_borrow_run(P, E, card, dev, "a", 2, chunks_a, jobs_a,
                             sp_a)
    run_b = phase_borrow_run(P, E, card, dev, "b", BORROW_C, bb["chunks"],
                             bb["jobs"], bb["sampled"])
    print(f"phases 3g-h, 4h-i: {time.perf_counter() - w2:.1f} s")

    records = []
    kms = float(np.mean(check["kernel_ms"]))
    per_launch = check["read_per_launch"] + check["written_per_launch"]
    b_ms, b_by = bound(check["read_per_launch"], check["written_per_launch"])
    print(f"kernel fused_prefix_fifo: {kms * 1e3:.2f} us/launch mean over "
          f"{len(check['kernel_ms'])} headline launches (CUDA events), "
          f"plain {np.mean(check['plain_ms']):.3f} ms, bound "
          f"{b_ms * 1e3:.4f} us ({per_launch:.1f} B per launch, mean of "
          f"{check['read_per_launch']:.1f} read and "
          f"{check['written_per_launch']:.1f} written, at 3.35 TB/s); "
          f"kernel / bound {kms / b_ms:.1f} [{card}]")
    breakdown("headline", head, check["kernel_ms"], card)
    records.append(dict(kernel=fused_tick.KERNELS["fused_prefix_fifo"],
                        launches=head["launches"], worst=check["worst"],
                        ms=kms, plain=check["plain_ms"], bound=(b_ms, b_by)))

    sp = borg["sampled"]
    kms = float(np.mean(sp["kernel_ms"]))
    b_ms, b_by = bound(sp["read"], sp["written"], sp["ops"])
    bytes_us = 1e6 * (sp["read"] + sp["written"]) / HBM_BYTES_PER_S
    print(f"kernel fused_prefix_ffd: {kms * 1e3:.2f} us/launch mean over "
          f"{len(sp['kernel_ms'])} borg4k launches (CUDA events), plain "
          f"{np.mean(borg['plain_ms']):.3f} ms, bound {b_ms * 1e3:.4f} us by "
          f"{b_by} ({sp['read'] + sp['written']:.1f} B per launch, mean of "
          f"{sp['read']:.1f} read and {sp['written']:.1f} written, at "
          f"3.35 TB/s: {bytes_us:.4f} us; {sp['ops']:.1f} compares per launch at 67 T/s: "
          f"{1e6 * sp['ops'] / SCALAR_OPS_PER_S:.4f} us); kernel / bound "
          f"{kms / b_ms:.1f} [{card}]")
    breakdown("borg4k", b4k, sp["kernel_ms"], card)
    records.append(dict(kernel=fused_tick.KERNELS["fused_prefix_ffd"],
                        launches=b4k["launches"],
                        worst=max(borg["worst"], f64["worst"]), ms=kms,
                        plain=borg["plain_ms"], bound=(b_ms, b_by)))

    # the market runs: the record of each kernel is its first run's, (a)
    # for DELAY and (b) for the scored sweep; every run is printed
    for kernel, group, first in (("fused_prefix_delay", delay, "a"),
                                 ("fused_prefix_scored", scored, "b")):
        for run in [n for n in MARKET_RUNS if n in group]:
            sp = group[run]["sampled"]
            kms = float(np.mean(sp["kernel_ms"]))
            b_ms, b_by = bound(sp["read"], sp["written"], sp["ops"])
            print(f"kernel {kernel}, run ({run}): {kms * 1e3:.2f} us/launch "
                  f"mean over {len(sp['kernel_ms'])} launches (CUDA events), "
                  f"plain {np.mean(group[run]['plain_ms']):.3f} ms, bound "
                  f"{b_ms * 1e3:.4f} us by {b_by} "
                  f"({sp['read'] + sp['written']:.1f} B per launch, mean of "
                  f"{sp['read']:.1f} read and {sp['written']:.1f} written, "
                  f"at 3.35 TB/s: "
                  f"{1e6 * (sp['read'] + sp['written']) / HBM_BYTES_PER_S:.4f}"
                  f" us; {sp['ops']:.1f} operations per launch at 67 T/s: "
                  f"{1e6 * sp['ops'] / SCALAR_OPS_PER_S:.4f} us); kernel / "
                  f"bound {kms / b_ms:.1f} [{card}]")
            breakdown(f"market ({run})", runs[run], sp["kernel_ms"], card)
            if run == first:
                records.append(dict(
                    kernel=fused_tick.KERNELS[kernel],
                    launches=runs[run]["launches"], worst=group["worst"],
                    ms=kms, plain=group[run]["plain_ms"],
                    bound=(b_ms, b_by)))

    sp = bb["sampled"]
    kms = float(np.mean(sp["ms"]["kernel"]))
    b_ms, b_by = bound(sp["read"], sp["written"])
    print(f"kernel fused_prefix_fifo_emit: {kms * 1e3:.2f} us/launch mean "
          f"over {len(sp['ms']['kernel'])} launches of run (b) (CUDA "
          f"events), {float(np.mean(sp_a['ms']['kernel'])) * 1e3:.2f} at run "
          f"(a), {float(np.mean(check['emit_ms'])) * 1e3:.2f} at the "
          f"headline; plain {np.mean(bb['plain_ms']):.3f} ms at (b); bound "
          f"{b_ms * 1e3:.4f} us at (b) ({sp['read'] + sp['written']:.1f} B "
          f"per launch, mean of {sp['read']:.1f} read and "
          f"{sp['written']:.1f} written, at 3.35 TB/s); kernel / bound "
          f"{kms / b_ms:.1f} [{card}]")
    breakdown("borrowing (a)", run_a, sp_a["ms"]["kernel"], card)
    breakdown("borrowing (b)", run_b, sp["ms"]["kernel"], card)
    records.append(dict(kernel=fused_tick.KERNELS["fused_prefix_fifo_emit"],
                        launches=run_b["launches"], worst=borrow["worst"],
                        ms=kms, plain=bb["plain_ms"], bound=(b_ms, b_by)))

    print(json.dumps({"kernels": [{
        "name": r["kernel"].name, "route": "cuda",
        "source": r["kernel"].source, "replaces": fused_tick.REPLACES,
        "launches": r["launches"], "max_abs_err": r["worst"],
        "ms": r["ms"], "plain_ms": float(np.mean(r["plain"])),
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
