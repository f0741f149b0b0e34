#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root with ``python3 chip_smoke.py``; it needs one
CUDA card and exits non-zero without one (or without the repository around
it). It drives the port's main path — the headline FIFO run — on the card:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the path, from ``kernels/csrc/`` (nvcc);
3. kernel against plain: at the headline's full width (4096 clusters) the
   hand-written kernel and its plain PyTorch version run on copies of the
   same CUDA state, on ticks the headline run reaches and on a heavier
   stream that fills the queues, and every leaf must be equal bitwise; then
   a whole 256-cluster headline run through each is compared leaf by leaf;
4. headline: 4096 clusters x 250 jobs, 1,570 ticks in 400-tick ragged-K
   chunks, through ``Engine(cfg).run_chunks`` — zero drops, at least 99%
   placed, conservation, one kernel launch per tick — with jobs/s over the
   min and median of 5 timed runs after warm-up.

Every number is printed beside the card's name and power limit. The last
lines are a JSON record of each kernel (its time per launch, the plain
version's, the least time the card's memory rate allows for the bytes the
headline's own data needs moved), the ``nvidia-smi`` name and power-limit
line, and the result line.
No phase catches an error: any failure ends the script non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
HEADLINE_C, JOBS, HORIZON_MS, CHUNK = 4096, 250, 1_500_000, 400
RUN_C = 256  # the width of the whole-run kernel-vs-plain comparison
TIMED_RUNS, WARMUPS = 5, 2
SPIN_CYCLES = 1_000_000  # ~0.5 ms of card time ahead of each timed launch


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


def chunk_sizes(n_ticks: int) -> list[int]:
    sizes = [CHUNK] * (n_ticks // CHUNK)
    return sizes + ([n_ticks % CHUNK] if n_ticks % CHUNK else [])


def max_abs_diff(a, b) -> int:
    """Largest |a - b| over every leaf of two states; raises on a leaf
    whose dtype or shape differs."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    worst = 0
    for (k, x), (_, y) in zip(leaves_with_keys(a), leaves_with_keys(b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{k}: {x.dtype}{tuple(x.shape)} vs "
                                 f"{y.dtype}{tuple(y.shape)}")
        if x.dtype == torch.bool:
            d = int((x != y).sum())
        else:
            d = int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) \
                if x.numel() else 0
        worst = max(worst, d)
    return worst


def tick_bytes(before, after, rows, counts, t: int, trace: bool):
    """The least bytes tick ``t``'s prefix must move on this tick's data,
    as (read, written) 0-d int64 tensors on the card (no host sync).

    Written: every state element the tick changed. Read, per cluster: the
    arrival count and the seven counters the tick updates (the trace count
    too when the trace is on), the node free and active vectors, the
    running set's active flags, the end_t of each active slot and the node
    and resources of each slot it releases, every live queue row, and the
    valid arrival rows. Rows that did not change, and queue slots past a
    queue's count, need not move at all."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    s = before
    C, N, n_res = s.node_free.shape
    S = s.run.active.shape[1]
    row_b = rows.shape[2] * rows.element_size()
    written = sum((x != y).sum() * x.element_size() for (_, x), (_, y)
                  in zip(leaves_with_keys(before), leaves_with_keys(after)))
    due = s.run.active & (s.run.data[..., 0] <= t)  # end_t is field 0
    live = sum(q.count.clamp(0, q.data.shape[1]).sum()
               for q in (s.ready, s.wait, s.lent))
    valid = counts.clamp(0, rows.shape[1]).sum()
    read = (C * (4 * (8 + int(trace)) + N * n_res * 4 + N + S)
            + 4 * s.run.active.sum() + 4 * (1 + n_res) * due.sum()
            + row_b * (live + valid))
    return read, written


class Checker:
    """Runs kernel-vs-plain comparisons on copies of one state and keeps
    the worst difference and the plain version's times."""

    def __init__(self, P, engine):
        from multi_cluster_simulator_tpu_torch.core.state import clone_state
        from multi_cluster_simulator_tpu_torch.kernels import fused_tick

        self.ft, self.clone, self.engine = fused_tick, clone_state, engine
        self.worst, self.n, self.plain_ms = 0, 0, []

    def compare(self, state, rows, counts, t, lent_rows=False):
        """Run kernel and plain on copies of ``state`` and require every
        leaf equal. ``lent_rows`` first loads the tick's arrival rows into
        the lent queue too, so the lent-head attempt runs (the lent queue
        stays empty on this path without borrowing)."""
        if lent_rows:
            state = self.clone(state)
            K = min(rows.shape[1], state.lent.capacity)
            state.lent.data[:, :K] = rows[:, :K]
            state.lent.count.copy_(counts.clamp(max=K))
        ref_in = self.clone(state)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ref = self.ft.fused_prefix_reference(self.engine, ref_in, rows,
                                             counts, t)
        ev[1].record()
        out = self.ft.fused_prefix(self.engine, self.clone(state), rows,
                                   counts, t)
        torch.cuda.synchronize()
        self.plain_ms.append(ev[0].elapsed_time(ev[1]))
        d = max_abs_diff(ref, out)
        if d:
            raise AssertionError(f"kernel differs from plain at t={t}: "
                                 f"max |diff| {d}")
        self.worst, self.n = max(self.worst, d), self.n + 1


def phase_kernel_vs_plain(P, E, card, dev):
    """Phase 3: the kernel against its plain version at full width."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = headline_cfg(P)
    engine = E.Engine(cfg, device=dev)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(HEADLINE_C)]
    n_ticks = HORIZON_MS // cfg.tick_ms + 70
    arr = uniform_stream(HEADLINE_C, JOBS, HORIZON_MS, max_cores=8,
                         max_mem=6_000, max_dur_ms=60_000, seed=9)
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), cfg.tick_ms)
    chk = Checker(P, engine)

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
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            # keep the card busy while the host enqueues the event pair and
            # the launch, so the pair times the kernel and not the host
            torch.cuda._sleep(SPIN_CYCLES)
            ev[0].record()
            fused_tick.fused_prefix(engine, state, rows, counts, t)
            ev[1].record()
            evs.append(ev)
            r, w = tick_bytes(before, state, rows, counts, t, cfg.record_trace)
            read_b, written_b = read_b + r, written_b + w
            state.t.fill_(t)
            k_glob += 1
    torch.cuda.synchronize()
    kernel_ms = [a.elapsed_time(b) for a, b in evs]
    read_b, written_b = int(read_b) / k_glob, int(written_b) / k_glob
    print(f"phase 3a: kernel == plain bitwise on {n_sampled} sampled "
          f"headline ticks at C={HEADLINE_C}, each as reached and with the "
          f"lent queue loaded ({chk.n} comparisons; max arrivals/tick "
          f"{max_k}, max wait depth {max_wait}) [{card}]")

    # (b) heavier streams at the same width and shapes, every tick
    # compared: many small long jobs fill the running set (run_full), big
    # jobs stop the drain on a job no node fits, and both overflow the
    # ready queue (drops.queue). Without borrowing the wait queue holds at
    # most the one job the drain stopped on.
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
            chk.compare(state, rows_all[k], counts_all[k], t)
            fused_tick.fused_prefix(engine, state, rows_all[k],
                                    counts_all[k], t)
            state.t.fill_(t)
            seen["wait"] += int((state.wait.count > 0).sum())
        seen["queue"] += int(state.drops.queue.sum())
        seen["run_full"] += int(state.drops.run_full.sum())
    print(f"phase 3b: kernel == plain bitwise on 2 x 30 heavy ticks at "
          f"C={HEADLINE_C}: drops.queue {seen['queue']}, drops.run_full "
          f"{seen['run_full']}, cluster-ticks with a waiting job "
          f"{seen['wait']} [{card}]")
    if not all(seen.values()):
        raise AssertionError(f"the heavy streams missed a branch: {seen}")

    # (c) a whole 256-cluster headline run (with the placement trace on):
    # the kernel through Engine.run_chunks, the plain version tick by tick.
    cfg_t = headline_cfg(P, record_trace=True, max_trace_events=512)
    eng_t = E.Engine(cfg_t, device=dev)
    specs_t = [P.uniform_cluster(c + 1, 5) for c in range(RUN_C)]
    arr_t = uniform_stream(RUN_C, JOBS, HORIZON_MS, max_cores=8, max_mem=6_000,
                           max_dur_ms=60_000, seed=9)
    ch_t = E.pack_arrivals_chunks(arr_t, chunk_sizes(n_ticks), cfg.tick_ms)
    s0 = init_state(cfg_t, specs_t, device=dev)
    ref = clone_state(s0)
    t = 0
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for ch in ch_t:
        rows_all = torch.from_numpy(ch.rows).to(dev)
        counts_all = torch.from_numpy(ch.counts).to(dev)
        for k in range(ch.rows.shape[0]):
            t += cfg.tick_ms
            ref = fused_tick.fused_prefix_reference(eng_t, ref, rows_all[k],
                                                    counts_all[k], t)
            ref.t.fill_(t)
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - w0
    w0 = time.perf_counter()
    out = eng_t.run_chunks(clone_state(s0), ch_t)
    torch.cuda.synchronize()
    kernel_run_s = time.perf_counter() - w0
    d = max_abs_diff(ref, out)
    if d:
        raise AssertionError(f"{RUN_C}-cluster run: kernel differs from plain "
                             f"(max |diff| {d})")
    placed = int(out.placed_total.sum())
    print(f"phase 3c: {RUN_C}-cluster headline run, kernel == plain on every "
          f"leaf and the trace ({placed} placements); run wall plain "
          f"{plain_run_s:.3f} s, kernel {kernel_run_s:.3f} s [{card}]")
    return dict(worst=chk.worst, kernel_ms=kernel_ms, plain_ms=chk.plain_ms,
                read_per_launch=read_b, written_per_launch=written_b)


def phase_headline(P, E, card, dev):
    """Phase 4: the full headline through the port's entry points."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )
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

    # the counted run: every launch count to 0 just before, read just after
    state = clone_state(s0)
    torch.cuda.synchronize()
    fused_tick.fused_prefix.launches = 0
    w0 = time.perf_counter()
    out = engine.run_chunks(state, chunks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - w0
    launches = fused_tick.fused_prefix.launches
    if launches != n_ticks:
        raise AssertionError(f"{launches} kernel launches, want {n_ticks}")
    drops = total_drops(out)
    if any(drops.values()):
        raise AssertionError(f"static bounds bound: {drops}")
    placed = int(out.placed_total.sum())
    if placed < 0.99 * HEADLINE_C * JOBS:
        raise AssertionError(f"only {placed}/{HEADLINE_C * JOBS} placed")
    check_conservation(out)
    if int(out.t) != n_ticks * cfg.tick_ms:
        raise AssertionError(f"clock {int(out.t)} after {n_ticks} ticks")

    # the chunks' host->device copies alone (run_chunks makes the same
    # copies from the same pageable numpy arrays, one per chunk)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for ch in chunks:
        torch.from_numpy(ch.rows).to(dev)
        torch.from_numpy(ch.counts).to(dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - w0
    h2d_bytes = sum(ch.nbytes() for ch in chunks)

    walls = []
    for i in range(WARMUPS + TIMED_RUNS):
        state = clone_state(s0)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        engine.run_chunks(state, chunks)
        torch.cuda.synchronize()
        if i >= WARMUPS:
            walls.append(time.perf_counter() - w0)
    wmin, wmed = min(walls), float(np.median(walls))
    print(f"phase 4: headline {HEADLINE_C} clusters x {JOBS} jobs, "
          f"{n_ticks} ticks: placed {placed}, drops {drops}, launches "
          f"{launches}, conservation ok [{card}]")
    print(f"phase 4: jobs/s {placed / wmin:.1f} (min of {TIMED_RUNS}), "
          f"{placed / wmed:.1f} (median); wall min {wmin:.4f} s, median "
          f"{wmed:.4f} s, first run {first_s:.4f} s; walls "
          f"{[round(w, 4) for w in walls]}; us/tick {1e6 * wmin / n_ticks:.1f}"
          f" [{card}]")
    print(f"phase 4: host->device copies of the {len(chunks)} chunks alone "
          f"{h2d_s:.4f} s for {h2d_bytes} B (K per chunk "
          f"{[ch.rows.shape[2] for ch in chunks]}) [{card}]")
    return dict(launches=launches, placed=placed, wall_min_s=wmin,
                wall_median_s=wmed, n_ticks=n_ticks, h2d_s=h2d_s)


def main() -> int:
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

    dev = torch.device("cuda")
    check = phase_kernel_vs_plain(P, E, card, dev)
    head = phase_headline(P, E, card, dev)

    kms = float(np.mean(check["kernel_ms"]))
    per_launch = check["read_per_launch"] + check["written_per_launch"]
    bound_ms = 1e3 * per_launch / HBM_BYTES_PER_S
    print(f"kernel fused_prefix_fifo: {kms * 1e3:.2f} us/launch mean over "
          f"{len(check['kernel_ms'])} headline launches (CUDA events), "
          f"plain {np.mean(check['plain_ms']):.3f} ms, bound "
          f"{bound_ms * 1e3:.4f} us ({per_launch:.1f} B per launch, mean of "
          f"{check['read_per_launch']:.1f} read and "
          f"{check['written_per_launch']:.1f} written, at 3.35 TB/s); "
          f"kernel / bound {kms / bound_ms:.1f} [{card}]")
    # run_chunks copies a chunk synchronously, then enqueues its ticks; the
    # kernels run while the host enqueues the next ones, so the wall is
    # the copies plus the tick loop, and the kernel share is how busy the
    # card is
    kernel_s = float(np.sum(check["kernel_ms"])) / 1e3
    loop_s = head["wall_min_s"] - head["h2d_s"]
    print(f"breakdown of the fastest headline run ({head['wall_min_s']:.4f}"
          f" s): host->device copies {head['h2d_s']:.4f} s, tick loop "
          f"{loop_s:.4f} s ({1e6 * loop_s / head['n_ticks']:.1f} us/tick) "
          f"of which kernel {kernel_s:.4f} s; card busy with the kernel "
          f"{100 * kernel_s / head['wall_min_s']:.1f}% of the wall [{card}]")
    record = {"kernels": [{
        "name": fused_tick.KERNEL, "route": "cuda",
        "source": fused_tick.SOURCE, "replaces": fused_tick.REPLACES,
        "launches": head["launches"], "max_abs_err": check["worst"],
        "ms": kms, "plain_ms": float(np.mean(check["plain_ms"])),
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
