#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root with ``python3 chip_smoke.py``; it needs one
CUDA card and exits non-zero without one (or without the repository around
it). It drives the port's two paths on the card — the headline FIFO run and
the FFD bin-pack of the Borg-like replay — through the entry points a user
calls, and holds each path's hand-written kernel against its plain PyTorch
version:

1. device: the card's name and power limit;
2. build: every CUDA kernel, from ``kernels/csrc/`` (one nvcc per source,
   all started together);
3. kernel against plain, every leaf bitwise (``wait_total`` included):
   a. FIFO at the headline's full width (4096 clusters), on ticks the
      headline run reaches and on heavier streams that fill the queues;
   b. a whole 256-cluster headline run through each;
   c. FFD at bench_borg4k's full width: 16 ticks sampled as the kernel
      reaches them (the diurnal peak included), 2 x 30 heavy ticks that
      fire drops.queue, drops.run_full and the per-tick placement cap, the
      serial form, the ``ffd-memfirst`` variant, parity mode and the trace,
      and a whole run at bench_borg4k(quick=True)'s shape;
4. the main paths, each with every launch count set to 0 just before and
   read just after:
   a. headline: 4096 clusters x 250 jobs, 1,570 ticks — zero drops, at
      least 99% placed, conservation, 1,570 FIFO launches; jobs/s over the
      min and median of 5 timed runs after 2 warm-ups;
   b. borg4k (bench.py:1213-1263): 4096 clusters x 750 Borg-like jobs,
      4,600 ticks — at least 95% placed, zero drops, conservation, 4,600
      FFD launches; jobs/s over the min and median of 3 timed runs after 1
      warm-up;
   c. ffd64 (bench.py:936-976): 64 clusters x 60,000 jobs, Level0 768
      deep, 6,100 ticks — kernel == plain on 8 sampled ticks, then one
      full run with the reference's asserts.

Every number is printed beside the card's name and power limit. The last
lines are a JSON record of each kernel (its time per launch, the plain
version's, the least time the card allows for the bytes and operations
its path's own data needs), the ``nvidia-smi`` name and power-limit line,
and the result line. No phase catches an error: any failure ends the
script non-zero.
"""

from __future__ import annotations

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
TIMED_RUNS, WARMUPS = 5, 2
SPIN_CYCLES = 1_000_000  # ~0.5 ms of card time ahead of each timed launch
# bench_borg4k (bench.py:1213-1263), full and quick shapes
BORG_C, BORG_JOBS, BORG_HORIZON_MS = 4096, 750, 4_500_000
BORG_QUICK = (256, 250, 1_500_000)
BORG_TIMED, BORG_WARMUPS, BORG_SAMPLES = 3, 1, 16
# bench_ffd64 (bench.py:936-976)
FFD64_C, FFD64_JOBS, FFD64_HORIZON_MS, FFD64_SAMPLES = 64, 60_000, \
    6_000_000, 8


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
    and the same for Level0's rows alone."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    written = sum((x != y).sum() * x.element_size() for (_, x), (_, y)
                  in zip(leaves_with_keys(before), leaves_with_keys(after)))
    l0 = (before.l0.data != after.l0.data).sum() * 4
    return written, l0


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


class Checker:
    """Runs kernel-vs-plain comparisons on copies of one state and keeps
    the worst difference and the plain version's times."""

    def __init__(self, engine):
        from multi_cluster_simulator_tpu_torch.core.state import clone_state
        from multi_cluster_simulator_tpu_torch.kernels import fused_tick

        self.ft, self.clone, self.engine = fused_tick, clone_state, engine
        self.params = engine._default_params
        self.host = fused_tick.host_params(self.params)
        self.worst, self.n, self.plain_ms = 0.0, 0, []

    def compare(self, state, rows, counts, t, lent_rows=False):
        """Run kernel and plain on copies of ``state`` and require every
        leaf equal; returns the kernel's output. ``lent_rows`` first loads
        the tick's arrival rows into the lent queue too, so the FIFO
        lent-head attempt runs (the lent queue stays empty on this path
        without borrowing)."""
        if lent_rows:
            state = self.clone(state)
            K = min(rows.shape[1], state.lent.capacity)
            state.lent.data[:, :K] = rows[:, :K]
            state.lent.count.copy_(counts.clamp(max=K))
        ref_in = self.clone(state)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ref = self.ft.fused_prefix_reference(self.engine, ref_in, rows,
                                             counts, t, self.params)
        ev[1].record()
        out = self.ft.fused_prefix(self.engine, self.clone(state), rows,
                                   counts, t, self.params, self.host)
        torch.cuda.synchronize()
        self.plain_ms.append(ev[0].elapsed_time(ev[1]))
        d = max_abs_diff(ref, out)
        if d:
            raise AssertionError(
                f"{self.ft.kernel_for(self.engine).name} differs from plain "
                f"at t={t}: max |diff| {d}")
        self.worst, self.n = max(self.worst, d), self.n + 1
        return out


def timed_launch(fused_tick, engine, state, rows, counts, t, params, host):
    """One kernel launch between a CUDA event pair, with the card kept
    busy ahead of it so the pair times the kernel and not the host."""
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(SPIN_CYCLES)
    ev[0].record()
    fused_tick.fused_prefix(engine, state, rows, counts, t, params, host)
    ev[1].record()
    return ev


def phase_kernel_vs_plain(P, E, card, dev):
    """Phases 3a and 3b: the FIFO kernel against its plain version."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = headline_cfg(P)
    engine = E.Engine(cfg, device=dev)
    params = engine._default_params
    host = fused_tick.host_params(params)
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
    ch_t = E.pack_arrivals_chunks(arr_t, chunk_sizes(n_ticks), cfg.tick_ms)
    plain_run_s, kernel_run_s, out = whole_run_against_plain(
        E, eng_t, init_state(cfg_t, specs_t, device=dev), ch_t, "FIFO")
    placed = int(out.placed_total.sum())
    print(f"phase 3b: {RUN_C}-cluster headline run, FIFO kernel == plain on "
          f"every leaf and the trace ({placed} placements); run wall plain "
          f"{plain_run_s:.3f} s, kernel {kernel_run_s:.3f} s [{card}]")
    return dict(worst=chk.worst, kernel_ms=kernel_ms, plain_ms=chk.plain_ms,
                read_per_launch=read_b, written_per_launch=written_b)


def whole_run_against_plain(E, engine, s0, chunks, what):
    """A whole run through ``engine.run_chunks`` (the kernel) and through
    the plain version tick by tick, from copies of ``s0``; every leaf of
    the two final states must be equal. Returns the two walls and the
    kernel's final state."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    params = engine._default_params
    ref = clone_state(s0)
    t = 0
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(s0.device)
        counts_all = torch.from_numpy(ch.counts).to(s0.device)
        for k in range(ch.rows.shape[0]):
            t += engine.cfg.tick_ms
            ref = fused_tick.fused_prefix_reference(engine, ref, rows_all[k],
                                                    counts_all[k], t, params)
            ref.t.fill_(t)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - w0
    w0 = time.perf_counter()
    out = engine.run_chunks(clone_state(s0), chunks)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - w0
    d = max_abs_diff(ref, out)
    if d:
        raise AssertionError(f"whole {what} run: kernel differs from plain "
                             f"(max |diff| {d})")
    return plain_s, kernel_s, out


def counted_run(engine, s0, chunks, kernel):
    """The main path's counted run: every launch count set to 0 just
    before ``engine.run_chunks``, read just after. ``kernel`` must have
    launched once per tick and no other kernel at all. Returns the final
    state, the wall and the counts."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    state = clone_state(s0)
    n_ticks = sum(ch.rows.shape[0] for ch in chunks)
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    w0 = time.perf_counter()
    out = engine.run_chunks(state, chunks)
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
    """Walls of ``runs`` whole runs after ``warmups``, and the chunks'
    host->device copies alone (run_chunks makes the same copies from the
    same pageable numpy arrays, one per chunk)."""
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
        engine.run_chunks(state, chunks)
        torch.cuda.synchronize()
        if i >= warmups:
            walls.append(time.perf_counter() - w0)
    return walls, h2d_s


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
    walls, h2d_s = timed_runs(engine, s0, chunks, WARMUPS, TIMED_RUNS)
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


def sampled_kernel_pass(fused_tick, chk, engine, s0, chunks, picks, QC):
    """Drive a whole run tick by tick through the kernel, a CUDA event
    pair around every launch and the tick's bytes and operations counted;
    at the global ticks in ``picks`` compare kernel and plain on the state
    the run has reached (and take the plain's output, which is equal).
    Returns the per-launch times, the mean bytes read and written and the
    mean operations per launch, and the worst Level0 depth seen."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    params, host = chk.params, chk.host
    dev = s0.device
    state = clone_state(s0)
    evs, read_b, written_b, ops, t, k_glob = [], 0, 0, 0, 0, 0
    max_l0 = torch.zeros((), dtype=torch.int32, device=dev)
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
            r, w, o = tick_cost_ffd(before, state, rows, counts, t,
                                    engine.cfg.record_trace, QC)
            read_b, written_b, ops = read_b + r, written_b + w, ops + o
            max_l0 = torch.maximum(max_l0, state.l0.count.max())
            state.t.fill_(t)
            k_glob += 1
    torch.cuda.synchronize()
    return dict(kernel_ms=[a.elapsed_time(b) for a, b in evs],
                read=int(read_b) / k_glob, written=int(written_b) / k_glob,
                ops=int(ops) / k_glob, max_l0=int(max_l0), ticks=k_glob)


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
    ch_q, nq = borg_stream(E, qc_, qj, qh, cfg_q.tick_ms)
    specs_q = [P.uniform_cluster(c + 1, 5) for c in range(qc_)]
    plain_s, kernel_s, out = whole_run_against_plain(
        E, eng_q, init_state(cfg_q, specs_q, device=dev), ch_q, "FFD")
    print(f"phase 3c: whole borg4k quick run ({qc_} clusters x {qj} jobs, "
          f"{nq} ticks), FFD kernel == plain on every leaf and the trace "
          f"({int(out.placed_total.sum())} placements); run wall plain "
          f"{plain_s:.3f} s, kernel {kernel_s:.3f} s [{card}]")
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
    walls, h2d_s = timed_runs(engine, s0, chunks, BORG_WARMUPS, BORG_TIMED)
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

    name, card = torch.cuda.get_device_name(0), smi_line()
    print(f"phase 1: device {name}; nvidia-smi: {card}")
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
    print(f"phases 3-4: {time.perf_counter() - w0:.1f} s")

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
    records.append(dict(kernel=fused_tick.KERNELS["fifo"],
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
    records.append(dict(kernel=fused_tick.KERNELS["ffd"],
                        launches=b4k["launches"],
                        worst=max(borg["worst"], f64["worst"]), ms=kms,
                        plain=borg["plain_ms"], bound=(b_ms, b_by)))

    print(json.dumps({"kernels": [{
        "name": r["kernel"].name, "route": "cuda",
        "source": r["kernel"].source, "replaces": fused_tick.REPLACES,
        "launches": r["launches"], "max_abs_err": r["worst"],
        "ms": r["ms"], "plain_ms": float(np.mean(r["plain"])),
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
