#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root with ``python3 chip_smoke.py``; it needs one
CUDA card and exits non-zero without one (or without the repository around
it). It drives the port's paths on the card — the headline FIFO run, the
FFD bin-pack of the Borg-like replay, DELAY and the scored zoo on the
market shape, the trader market (BASELINE config 4 with the sinkhorn
market, with and without vnode expiry), cross-cluster borrowing with
the greedy market on BASELINE config 2, and the fault plane (bench.py
bench_faults's churn) — through the entry points a user calls, and
holds each path's hand-written kernel against its plain PyTorch version:

1. device: the card's name and power limit;
2. build: every CUDA kernel, from ``kernels/csrc/`` (one nvcc per source,
   all started together);
3. kernel against plain, every leaf bitwise (``wait_total`` included):
   a. FIFO at the headline's full width (4096 clusters), on ticks the
      headline run reaches and on heavier streams that fill the queues;
      the emit form (``run_io``'s) timed on the first 400 headline ticks;
   b. the first 40 ticks of a 256-cluster headline run through each;
   c. FFD at bench_borg4k's full width: 16 ticks sampled as the kernel
      reaches them (the diurnal peak included), 2 x 8 heavy ticks that
      fire drops.queue, drops.run_full and the per-tick placement cap, the
      serial form, the ``ffd-memfirst`` variant, parity mode and the trace,
      and the first 40 ticks of a run at bench_borg4k(quick=True)'s shape;
   d. DELAY at the market's full width (sinkhorn_market_setup, bench.py:
      979-1029): ticks of runs (a) (the sinkhorn market on, its rounds
      timed) and (d) sampled as the kernel reaches them, heavy ticks on an
      8-deep queue that fire the promotion, a full Level1, drops.run_full
      and the parity skip, in the wave, serial and parity forms,
      ``delay-eager`` and the trace, and the first 40 ticks of a run at
      the market's quick shape;
   e. the scored sweep the same way: runs (b) gavel and (c) tesserae
      sampled, heavy ticks (gavel; tesserae with the trace; gavel and rl
      with seeded scores on clusters of mixed device types), and the first
      40 ticks of quick-shape runs of tesserae and of the seeded rl;
   f. tools/tournament.py's lineup as one multi-member PolicySet at 256
      clusters: each params.idx launches its member's kernel, and only
      that, and equals the plain version;
   g. the FIFO kernel's emit form (the return pack, ``want``,
      ``bjob_vec``, ``drops.msgs``) on the borrowing path of config 2
      (bench.py:898-933): the first 800 ticks of run (b) (trader cut)
      sampled as the kernel reaches them; heavy ticks on small queues that
      fire returns past the message slots, lent-head placements, LentQueue
      overflow and wants; the first 600 ticks of run (a) with the greedy
      market and the first 200 of a 64-cluster tiled run, with delivery
      and matching; the DELAY, FFD and gavel kernels' emit form with
      foreign rows running;
   h. ``Engine.run_io`` over 40 ticks of run (b) from the state it reached
      at tick 800: the state and the stacked TickIO equal the plain
      path's;
   i. every kernel's expire form (vnode expiry between release and
      ingest): run (e), the market with expiry at full width, sampled,
      its expiries and attaches counted; 3 heavy ticks for each form on
      run (a)'s final state with nine in ten virtual nodes set to expire
      (~1,300 expiries a launch); the first 150 ticks of quick-shape runs
      (DELAY, FFD, gavel) and the first 600 ticks of config 2 with the trader and
      expiry on, with and without borrowing, each counting its launches
      through ``Engine.run_chunks``;
   j. short runs of the greedy and the cvx market at the quick shape;
   k. every kernel's faults form (the fault phase opening the span, its
      generative draws on the card): heavy ticks with a third of the
      healthy nodes failing and every down one repairing, in generative
      (16 retries) and trace mode (no retries, same-tick outages), on
      market run (a)'s final state (carve placeholders, virtual nodes) for
      the Level0 forms and the expire forms, on borrowing run (b)'s state
      at tick 800 (foreign rows, full LentQueues) for the FIFO forms; runs
      with churn from the start, their launches counted through
      ``run_chunks``: the first 30 ticks of DELAY, FFD and gavel at the
      quick market shape with and without the sinkhorn market and expiry
      and of FIFO borrowing at 64 clusters, and
      tests/test_faults.py:299 (a failed slot hosting a traded virtual
      node) tiled to 64 clusters with the greedy market and expiry, with
      and without borrowing;
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
      deep, 6,100 ticks — kernel == plain on 8 ticks sampled from the
      first 1,200, then one full run with the reference's asserts;
   d-h. the market shape, 4096 clusters x 400 jobs, 700 ticks, five runs
      of one world and stream: (a) config 4 itself (bench.py:1032-1093
      bench_sinkhorn: DELAY wave, the sinkhorn market, sane carve) — zero
      drops, at least 85% of all jobs placed, at least 1,000 virtual nodes
      (the bench's gates), jobs/s over the min and median of 3 timed runs
      after 1 warm-up, and the card's time per round and snapshot by
      torch.profiler; (b) gavel, (c) tesserae, (d) DELAY parity with the
      trader cut; (e) config 4 with vnode expiry — zero drops, at least
      85% of the jobs that place without the market, at least 1,000
      virtual nodes attached, expiries; conservation, every arrived job
      placed, queued or counted as dropped, 700 launches of the run's
      kernel, each run equal to its sampled pass;
   i-j. config 2: (a) at its own two clusters with the greedy market,
      1,800 ticks — zero drops (bench.py:922), conservation, 1,800
      launches of the emit form, the rounds and snapshots timed; (b)
      tiled to 4,096 clusters with the trader cut, its first 1,200 ticks
      — conservation, 1,200 launches, drops and the job count printed (the reference's herding
      onto the lowest lender drops jobs there by design); ticks/s and
      placed jobs/s over the min and median of the timed runs after the
      counted run (1 each), which goes through ``run_io``
      and counts every tick's wants and returns, and per tick the kernel,
      return delivery and borrow matching each timed by CUDA events;
   k, m. bench_faults's churn config (bench.py:2927-2945: FIFO parity,
      queue 128, running 128, generative churn, mttf 100 s, mttr 10 s,
      seed 29, 16 retries, 490 ticks): (k) at its own 32 clusters x 200
      jobs, (m) at the headline's 4,096 clusters (819,200 jobs; the port's
      width, not the bench's) — the bench's gates (an enabled trace plane
      with an empty schedule leaves every non-fault leaf as the faults-off
      run; kills and requeues; zero drops; conservation), 490 launches of
      the faults form, kernel == plain on 12 sampled ticks, every launch
      timed beside the same kernel without the faults step,
      ``fault_plane_churn_jobs_per_sec`` over the min and median of 3
      timed runs after 1 warm-up, and at 4,096 a torch.profiler window;
   n-q. the metrics plane (obs/device.py), the tap forms == plain on the
      state, the buffer and the cursor: (n) the headline with the plane
      on, every launch of the tap form timed tick by tick, kernel == plain
      on 12 sampled ticks, the first 400 ticks of the 256-cluster run ==
      plain, the counted run's state bitwise the plane-off run's and its
      harvest tied back to the state, jobs/s off and on over 3 interleaved
      pairs with the overhead printed beside bench.py's 3% bound, and the
      emit form's tap over 400 ``run_io`` ticks, and the kernel's depth
      bucket on every depth below 2^24; (o) bench_faults's churn
      at 4,096 with the plane on (the tap's faults form; kills and
      requeues harvested equal the state's) and its emit form over 40
      ``run_io`` ticks; (p) BASELINE config 1 (bench.py:839-895
      bench_fifo_small: FIFO on one cluster_small, the windowed ingest,
      3,600 ticks in 900-tick chunks, record_metrics, the plane on) — zero
      drops, the series at the 5 s marks equal to the committed
      bench_metrics.json (zero under FIFO), its first 150 ticks' run == its
      plain run, 12 of its ticks compared and every launch timed beside
      the untapped form, ``fifo_cluster_small_ticks_per_sec`` over 3
      timed runs after 1 warm-up with the plane off and on — then the
      same world under DELAY, whose series moves; (q) the Level0 kernels'
      tap forms on borg4k and market runs (b)-(d) (counted runs with the
      plane bitwise the plane-off runs, kernel == plain and the tap timed
      beside the untapped form at 12 ticks each run reaches, the emit
      form's tap at 2) and their faults forms' taps on the first 30
      ticks of DELAY, FFD and gavel at the quick market shape with churn;
5. the compact state layout (core/compact.py: one narrow leaf per field,
   the checked narrow store counting into ``ovf``), every kernel reading
   and writing it through its column views:
   a. this slice's main path, its counts set to 0 just before and read
      just after: the headline on the compact layout, its plan from
      ``derive_plan`` — the headline's gates with a narrow overflow total
      of 0, 1,570 launches, ``to_wide`` of the final state bitwise 4a's,
      the state's bytes in both layouts, the whole run tick by tick with
      the untapped and the tap form == plain at 12 sampled ticks and
      every launch timed against a bound at the narrow leaves' sizes,
      wide and compact walls in 3 interleaved pairs, and the counted run
      with the plane (its harvested overflow total the state's);
   b. plans the checked store counts against: tests/test_kernels.py:283
      (int8 cores, 500-core jobs) tiled to 4,096 clusters — kernel ==
      plain, overflows counted, -128 stored and never 500 % 256; a denser
      stream through the FIFO wave drain and the FFD and DELAY waves (the
      kernels replay the waves where a demand is negative); the node exit
      narrow on a hand-built plan (int8 node columns) through FIFO, its
      tap form, DELAY, FFD, gavel and tesserae;
   c. the FFD, scored and DELAY kernels and their tap forms on borg4k and
      market runs (b)-(d), kernel == plain at sampled ticks of their first
      ticks;
   d. the FIFO emit form on borrowing run (b) (int16 node columns, widened
      before the prefix and narrowed after the phases) and DELAY's expire
      form on market run (e);
   e. bench_faults's compact cell (retries int8) with the bench's gates
      and ``to_wide`` bitwise 4k's run; the faults form and its tap form
      at 4,096; DELAY, FFD and gavel with churn at the quick market shape;
   f. BASELINE config 4 on the compact layout: the bench's gates, 700
      launches, ``to_wide`` bitwise run (a)'s final state;
6. event-compressed time and the Borg replay (6a-6e, their docstrings);
7. checkpoints, preemption and the phase-prefix ablation:
   a. the headline saved through ``AsyncCheckpointer`` at its inner chunk
      boundaries (ticks 400, 800, 1,200) and resumed from each file on the
      same engine, bitwise 4a's final state; the file's bytes, the µs a
      submit holds the dispatching thread, the writer's seconds a save,
      the walls without and with a save at every boundary;
   b. 5a's compact headline with the metrics plane cut at tick 800: state,
      buffer and harvest bitwise; a wide template refused by the header;
   c. 6a's sparse bursts compressed, cut in a quiet stretch: the state
      bitwise, the executed ticks and the leap histogram folded over the
      cut equal to the uninterrupted run's;
   d. a child process (``chip_smoke.py --preempt-child PATH``) running the
      headline under ``PreemptionGuard``, sent SIGTERM after its first
      save: exit 75 and the ``# preempted:`` line; a second child
      (``--resume``) ends bitwise at 7a's state; a checkpoint the plain
      path writes on the CPU at 64 clusters resumes on the kernel,
      bitwise the card's uninterrupted run;
   e. ``Engine.run_prefix`` on the headline's first 150 ticks at every
      phase limit (tools/profile_capture.py ``phase_table``): the kernel
      launched once a tick from limit 5 and never below, the whole tick
      bitwise ``run``; a ``start_trace`` session holding the
      ``tick.fused_prefix`` range and the kernel; and the checkpoint bytes
      of config 4's and config 5's final states;
8. the lane axis: a batch of L constellations as one lane-stacked run,
   each kernel source launched once a tick over all L C clusters, its
   parameters read per lane (the launch counts set to 0 just before each
   main-path drive and read just after):
   a. bench.py bench_tenants' full shape (256 tenants x 2 clusters, 32
      ticks, 262,144 jobs, a fault seed and a threshold a tenant): one
      FIFO launch a tick; every job placed, no drops; tenants {0, 85,
      170, 255} == their standalone ``Engine.run``; the whole batch ==
      the plain per-lane loop on the card over its first 2 ticks with the
      metrics plane on (each tenant's buffer its own); every launch of a
      run timed, 2 held against the plain loop; the batch's wall against
      the serial loop of 256 standalone runs; the lane form's launch
      beside the one-lane launch over the same 512 clusters;
   b. tools/tournament.py's lineup plus rl (a seeded action) as one
      PolicySet, two tenants a member under a batched ``params.idx``, on
      the tournament's world (64 clusters, its first 60 ticks): one launch
      a kernel source a tick (DELAY's variants in one, gavel, tesserae
      and rl in one), every lane == its standalone run, the masked lane
      forms == the plain loop at sampled ticks, each source timed on its
      own lanes;
   c. tests/test_tenancy.py's compact, compressed and generative-fault
      worlds tiled to 32 tenants (sampled tenants == standalone), and 4
      tenants of config 2's pair with borrowing and the greedy market,
      200 ticks, each == its standalone run;
   d. bench.py bench_env's full shape (1,024 envs x 8 clusters, episodes
      of 50 ticks, 125 steps, the rl action port): every episode counter
      reads 2, no drops, one scored launch a step, the timed step loop
      under ``torch.cuda.set_sync_debug_mode("error")``, envs x steps a
      second against a serial loop of single-env steps, the scored lane
      form beside its one-lane launch over the same 8,192 clusters;
   e. the env at 8d's shape, 50 steps, a distinct seeded action a env:
      the scored lane form == the plain per-lane loop at sampled steps,
      every leaf; a batch-1 replay env == ``Engine.run`` over the same
      bucketed arrivals;
9. the services tier (``services/``), every service's logger watched for
   ERROR records and every live service's health and loop threads
   checked before each gate (a failed dispatch ends the serving drive
   thread, a failed tick is logged by the live loop: both the reference's
   semantics, neither passed over here):
   a. bench.py bench_serving's parity A/B at its full shape (16 clusters
      of 10 nodes, FIFO parity, queue 256, running 512, 160 ticks of the
      seed-11 trace, 1 in 20 jobs at the mismatched endpoint) over
      localhost HTTP: window 1 (a POST a job) == window 8 (a /submitBatch
      a tick) == window 8 on the CPU (the plain version), every leaf;
      without the mismatched jobs window 8 == ``Engine.run`` over the
      bucketed stream; the FIFO emit+tap form launched once a tick and no
      other kernel; both walls; the form timed at every launch of a
      deterministic run and held against the plain version at 12;
   b. bench_serving's throughput phase, once: 60,000 jobs from 4 clients
      in /submitBatch of 128 with retry on 503, speed 100, window 8, the
      pacer and drive threads on — zero drops, every job placed; jobs/s,
      dispatches, launches, snapshot ages and the card's busy share
      (torch.profiler);
   c. 8 tenants on 9a's world in one tenant front door: the lane form
      once a tick over all lanes, each tenant == its standalone front
      door; the lane form timed and held against the per-lane loop;
   d. a child process (``chip_smoke.py --serve-child DIR``) serving with
      a WAL and checkpoints, killed with SIGKILL after acking 110 ticks
      and dispatching 104; a fresh front door recovers it: every acked
      job placed once, the state == an uninterrupted run, and the same
      files recover on the CPU to the same state;
   e. bench.py bench_live's constellation without its traders (no gRPC
      on the card's machine): a registry, 2 DELAY hosts, 2 workload
      clients of 250 jobs at speed 100 and a log sink — at least 90%
      placed, no drops, a launch a tick; then 40 ticks of a DELAY host
      and of a FIFO host with borrowing, driven by hand, == the same on
      the CPU, each windowed C=1 launch timed;
10. the reference's single-device drivers, each through its port in
   ``multi_cluster_simulator_tpu_torch/tools/``:
   a. the tournament (tools/tournament.py): bench.py's full sweep (48
      variants x 4 seeds x 8 clusters, 192 lanes, one DELAY and one
      scored launch a tick) and the tool's default (8 members x 4 seeds x
      64 clusters, 32 lanes, one launch a source a tick) as one
      lane-stacked run each, every cell == its standalone run, the grid
      wall against the serial loop, each source's lane form == the plain
      per-lane loop at two ticks and timed on its own lanes; a resume
      cache with one variant deleted reruns only its lanes, rows equal;
   b. the ES trainer (tools/train_env_demo.py): its defaults (one scored
      lane launch a step, the lane form == plain at two steps) and its
      world at bench_env's batch shape (1,024 envs x 8 clusters, 50-tick
      episodes, 2 iterations), the wall split into draws, steps and
      update, cut after iteration 1 and resumed bitwise;
   c. the chaos harness on serving (tools/chaos.py): one kill -9 cycle
      of a serving child on the card under live HTTP traffic, recovery
      bitwise the in-process reference on the card, no acked job lost;
   d. the chaos harness on a batch run: churn_bursts quick's first 600
      ticks (compact, compressed, trace churn) killed with SIGKILL at one chunk
      boundary and stopped with SIGTERM (exit 75) at one, the final
      checkpoint bitwise the uninterrupted child's;
   e. the matcher A/B (tools/market_ab.py): greedy and sinkhorn at 1,024
      and 4,096 clusters (cvx at 3j's quick shape only), one timed run
      each (config 4's three), the DELAY form's launches counted and the
      kernel == plain at two ticks a cell; the sinkhorn row at 4,096
      (BASELINE config 4) keeps bench.py's gates;
   f. the observability gate (tools/metrics_smoke.py) on the card: exit 0;
11. the Go-semantics oracle and the mesh (``oracle/``, ``parallel/``), with
   4 rank processes (``parallel.launch.RankGroup``: one gloo group, every
   rank on the one card, every collective staged through the host):
   a. bench.py:1266 bench_parity_tpu's eight scenarios at their full
      horizons through the kernels (the windowed stream, the trace on):
      every cluster's trace == the port's copy of the Go-semantics oracle,
      zero drops, each scenario's mechanism fired, more than 100 events
      compared, each final state == the plain version's (run on the CPU
      by a process started at the script's entry);
   b. ``ShardedEngine`` cells, each rank's kernel launched once a tick over
      its shard, the gathered state == the one-process run on the card:
      the headline over 2 ranks (== 4a's state), config 2's pair tiled to
      64 clusters with borrowing and the greedy market (50 ticks over 2
      ranks, 12 over 4), tests/test_sharded.py:86's DELAY + trader world
      at 64 clusters over 4, the sinkhorn market at 256 clusters over 2
      (floats within 1e-5), sparse_bursts_1k compressed over 2 (6a's
      executed ticks), test_sharded.py:257's FFD wave over 4, the headline
      with the metrics plane (``collect_metrics`` == 4n's buffer) and the
      mesh cut (the headline cut at 800 over 2 ranks into one file,
      resumed in this process == 4a's state); the walls, collectives a
      tick and one staged collective's host time over 2 and 4 ranks;
   c. the tools: weak_scaling's parity cells and its curve at 1 and 2
      ranks x 4,096 clusters (ranks sharing one card: no scaling figure),
      the tournament's seed axis over 2 ranks with its device A/B, chaos
      ``--batch`` over 2 ranks (its first 300 ticks, one kill -9, the
      uninterrupted 2-rank run held against the one-process run too; it
      runs beside 10c and 10d, its three chaos cells waiting mostly on
      their children's start-ups).
  12. the sinkhorn round's kernel (``kernels/csrc/sinkhorn_round.cu``,
      ``market/sinkhorn.py``): every sinkhorn market run counts its rounds
      through it (4d, 4h, 5f, 10e); a. config 4's run again, three of its
      rounds kept and each held bitwise against the plain version (K,
      ``u`` and ``vc`` after every iteration, the plan) and timed beside
      the plain version and a ``torch.matmul`` round; b. one round of
      config 4's world at 1,024 clusters (10e's width); c. 11b's sinkhorn
      cell's 128 x 256 shard (the second half of a round's sellers)
      through the mesh's launches; d. config 4's world at 64 and 256
      clusters on the card, each final state's digest equal to the
      reference engine's, pinned in ``tools/market_ab.py``.

Every number is printed beside the card's name and power limit. The last
lines are a JSON record of each kernel (its time per launch, the plain
version's, the least time the card allows for the bytes and operations
its path's own data needs), the ``nvidia-smi`` name and power-limit line,
and the result line. No phase catches an error: any failure ends the
script non-zero.
"""

from __future__ import annotations

import bisect
import ctypes
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
FFD_HEAVY_TICKS = 8  # 3c's heavy ticks a stream (wave; other forms half)
# bench_ffd64 (bench.py:936-976)
FFD64_C, FFD64_JOBS, FFD64_HORIZON_MS, FFD64_SAMPLES = 64, 60_000, \
    6_000_000, 8
FFD64_PASS_CHUNKS = 3  # 4c's pass tick by tick: its first 1,200 ticks
# the market shape: BASELINE config 4, bench.py:1032-1093 bench_sinkhorn,
# sinkhorn_market_setup(4096, 400, 600_000, matching="sinkhorn"), and its
# quick shape (64, 200, quick=True)
MARKET_C, MARKET_JOBS, MARKET_HORIZON_MS = 4096, 400, 600_000
MARKET_QUICK = (64, 200)
MARKET_TIMED, MARKET_WARMUPS, MARKET_SAMPLES = 3, 1, 12
# bench.py:1075-1082: placed, of all the jobs with the market; of the jobs
# that can place unaided where a run has no market (or loses its nodes)
MARKET_FLOOR = 0.85
VNODE_FLOOR = 1_000  # bench.py:1060-1073, virtual nodes traded
SINKHORN = {"matching": "sinkhorn", "carve_mode": "sane"}
EXPIRE = dict(SINKHORN, expire_virtual_nodes=True)
# the five full-shape runs: name -> (policy, config changes, gate): the
# bench's own ("market"), the unaided floor ("placeable"), the expire-on
# run's ("expire": the unaided floor, attaches and expiries), or none
MARKET_RUNS = {"a": ("delay", {"trader": SINKHORN}, "market"),
               "b": ("gavel", {}, None), "c": ("tesserae", {}, None),
               "d": ("delay", {"parity": True}, "placeable"),
               "e": ("delay", {"trader": EXPIRE}, "expire")}
MARKET_PROFILE_TICKS = 30  # a torch.profiler window: three market rounds
HEAVY_EXPIRE_TICKS = 3  # 3i's heavy ticks per expire form
HEAVY_EXPIRE_REPS = 5  # 3i's timed launches per heavy tick, each on a copy
MATCHER_TICKS = 300  # 3j's short greedy and cvx runs: 30 rounds each
# 3f: tools/tournament.py's DEFAULT_POLICIES as one PolicySet
LINEUP_C, LINEUP_TICKS = 256, 40
# BASELINE config 2 (bench.py:898-933): run (a) at its own two clusters
# with the trader on, run (b) tiled to 4,096 with the trader cut; 3g's
# whole tiled run; 3h's run_io chunk
BORROW_C, BORROW_TICKS, BORROW_HORIZON_MS = 4096, 1_800, 1_800_000
BORROW_TILED_C, BORROW_TILED_TICKS = 64, 200
BORROW_A_TICKS = 600  # 3g's whole run (a): the first trade falls near 500
BORROW_SAMPLES, BORROW_IO_TICKS, BORROW_PROFILE_TICKS = 12, 40, 50
# the timed runs after the counted run: run (a) ~7 s a run, run (b) ~10 s
BORROW_A_TIMED, BORROW_B_TIMED = 1, 1
BORROW_B_CHUNKS = 3  # 4j's run (b): its first 1,200 of 1,800 ticks
# bench_faults (bench.py:2869-3040): its churn config at its own 32
# clusters (4k) and at the headline's 4,096 (4m, the port's width)
FAULTS_C, FAULTS_WIDE_C, FAULTS_JOBS, FAULTS_HORIZON_MS = 32, 4096, 200, \
    400_000
FAULTS_TIMED, FAULTS_SAMPLES, FAULTS_PROFILE_TICKS = 3, 12, 50
FAULT_HEAVY_TICKS = 2  # 3k's heavy ticks per form and mode
FAULT_VNODE_C, FAULT_VNODE_TICKS = 64, 20  # 3k's tests/test_faults.py:299
FAULT_RUN_TICKS = 30  # 3k's other whole runs: their first 30 ticks
# the metrics plane (4n-4q): sampled ticks a run, 4n's on/off pairs, and
# bench.py's bound on the plane's overhead (bench.py:122, :671); 4q's
# churn runs with the plane cover their first 30 ticks
PLANE_SAMPLES, PLANE_TIMED, OBS_OVERHEAD_BOUND = 12, 3, 0.03
PLANE_CHURN_TICKS = 30
# the compact layout (5a-5f): 5a's wide/compact wall pairs; the other
# forms' passes cover their first ticks, compared at a few of them
COMPACT_PAIRS, COMPACT_PASS_TICKS, COMPACT_SAMPLES = 3, 100, 4
COMPACT_CHURN_TICKS = 60
# BASELINE config 1 (bench.py:839-895 bench_fifo_small): its ticks, its
# chunk, its arrival slots, its timed runs after its warm-ups
CONFIG1_TICKS, CONFIG1_CHUNK, CONFIG1_ARRIVALS = 3_600, 900, 2_048
CONFIG1_TIMED, CONFIG1_WARMUPS = 3, 1
CONFIG1_PLAIN_TICKS = 150  # 4p's kernel run == its plain run over these
# the earlier paths' whole-run comparisons (3b, 3c, 3d and 3e's quick
# runs) cover their first 40 ticks, to keep the script's time
WHOLE_RUN_TICKS = 40
EXPIRE_RUN_TICKS = 150  # 3i's quick-shape runs with expiry
# event-compressed time (6a-6e): bench_sparse_bursts (bench.py:2510-2575)
# at its full shape, churn_bursts_setup (:2467-2507), the leap classes of
# tests/test_pipeline.py:245-291 tiled, and bench_borg_replay (:1431-1520)
SPARSE_C, SPARSE_BURSTS, SPARSE_PER_BURST = 1024, 12, 24
SPARSE_INTERVAL_MS, SPARSE_WINDOW_MS = 300_000, 20_000
SPARSE_TIMED, SPARSE_WARMUPS = 3, 1
CHURN_BURSTS_CHUNK = 100
LEAP_CLASS_C, LEAP_CLASS_TICKS = 1024, 80
REPLAY_TIMED, REPLAY_WARMUPS, REPLAY_SAMPLES = 3, 1, 12
COMPRESS_SAMPLES = 12  # kernel == plain at this many executed ticks
PROBE_REPS = 500  # 6a's timed probes, each way
# where the sample's process leaves the joined jobs, and how long 6e waits
# phases 8a-8e, the lane axis: bench.py bench_tenants' full shape (8a),
# the tournament's lineup with rl as a mixed batch on its world (8b, cut
# to its first ticks), tests/test_tenancy.py's worlds tiled (8c; config
# 2's pair with borrowing and the greedy market at 4 tenants), bench.py
# bench_env's full shape (8d, 8e)
TENANTS_T, TENANTS_C, TENANTS_TICKS, TENANTS_JOBS = 256, 2, 32, 512
TENANTS_PLAIN_TICKS = 2  # 8a's whole batch against the plain per-lane loop
TENANTS_WALLS = 3
LANE_REPS = 20  # timed launches of a lane form and of its one-lane twin
MIXED_C, MIXED_TICKS = 64, 60
COMPOSED_T, COMPOSED_BORROW_TICKS = 32, 200
ENV_B, ENV_C, ENV_EP, ENV_STEPS = 1024, 8, 50, 125
ENV_WALLS, ENV_SERIAL = 2, 16
ENV_LANE_STEPS, ENV_PLAIN_STEPS = 50, (30,)
# phases 9a-9e, the services tier: bench.py bench_serving's full shape
# (bench.py:1700-2010; 9a-9c), 9a's world under a WAL and checkpoints with
# a child killed mid-run (9d), bench.py bench_live's constellation without
# its traders (bench.py:1523-1697; 9e)
SERVE_C, SERVE_T, SERVE_WINDOW = 16, 160, 8  # bench_serving's first 160 of its 320 ticks
SERVE_JOBS, SERVE_CLIENTS, SERVE_BATCH = 60_000, 4, 128
SERVE_TENANTS = 8
SERVE_CKPT_WINDOW, SERVE_CKPT_EVERY = 4, 8  # a checkpoint every 32 ticks
SERVE_KILL_STAGED, SERVE_KILL_DISPATCHED = 110, 104
SERVE_DIR = "build/phase9"
LIVE_JOBS, LIVE_HAND_TICKS = 250, 40
BORG_JOBS_NPZ = "build/borg_jobs.npz"
BORG_SAMPLE_TIMEOUT_S = 600


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


def trader_cfg(P, trader=None):
    """The port's TraderConfig: off when ``trader`` is None, else on with
    the given settings (``matching`` by name)."""
    if trader is None:
        return P.TraderConfig(enabled=False)
    kw = dict(trader)
    kw["matching"] = P.MatchKind(kw.get("matching", "greedy"))
    return P.TraderConfig(enabled=True, **kw)


def market_cfg(P, quick=False, jobs=MARKET_JOBS, trader=None, **kw):
    """sinkhorn_market_setup's config (bench.py:993; the port's copy,
    tools/market_ab.py), with the trader off unless ``trader`` gives its
    settings (``SINKHORN`` is the bench's own)."""
    import dataclasses

    from multi_cluster_simulator_tpu_torch.tools.market_ab import (
        sinkhorn_market_cfg,
    )

    return dataclasses.replace(sinkhorn_market_cfg(jobs, quick=quick),
                               trader=trader_cfg(P, trader), **kw)


def market_specs(P, C):
    """Half the clusters gpu-rich (8 gpus a node), half gpu-poor."""
    from multi_cluster_simulator_tpu_torch.tools.market_ab import (
        sinkhorn_market_specs,
    )

    return sinkhorn_market_specs(C)


def mixed_specs(P, C):
    """Clusters with nodes of all four device types, where the class
    tables of gavel and rl choose between nodes."""
    nodes = ((32, 24_000, 0, 0), (16, 12_000, 0, 2), (64, 48_000, 4, 3),
             (32, 24_000, 8, 1), (32, 24_000, 0, 0))
    return [P.ClusterSpec(id=c + 1, nodes=tuple(
        P.NodeSpec(id=i + 1, cores=k, memory=m, gpus=g, device_type=d)
        for i, (k, m, g, d) in enumerate(nodes))) for c in range(C)]


def market_stream(E, C, jobs, quick=False, seed=7, arrivals=False):
    """The market's stream, its 400-tick ragged-K chunks, and how many of
    its jobs can never place without the market: the gpu jobs of the
    gpu-poor clusters; and with ``arrivals`` the stream itself (the
    compact plan's audit reads it)."""
    from multi_cluster_simulator_tpu_torch.tools.market_ab import (
        sinkhorn_market_stream,
    )

    arr = sinkhorn_market_stream(C, jobs, MARKET_HORIZON_MS, quick=quick,
                                 seed=seed)
    n_ticks = MARKET_HORIZON_MS // 1_000 + 100
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), 1_000)
    valid = np.arange(arr.t.shape[1])[None, :] < arr.n[:, None]
    poor = (np.arange(C) % 2 == 1)[:, None]
    unplaceable = int(((arr.gpu > 0) & valid & poor).sum())
    if arrivals:
        return chunks, n_ticks, unplaceable, arr
    return chunks, n_ticks, unplaceable


def first_ticks(chunks, n: int = WHOLE_RUN_TICKS):
    """The first ``n`` ticks of a chunked stream (``n`` at most its first
    chunk's), as a one-chunk stream."""
    from multi_cluster_simulator_tpu_torch.core.state import TickArrivals

    return [TickArrivals(rows=chunks[0].rows[:n],
                         counts=chunks[0].counts[:n])]


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


def row_bytes(x) -> int:
    """Bytes of one row of a queue or the running set in its layout: the
    wide row's 40, or the sum of the compact leaves' value sizes."""
    if hasattr(x, "data"):
        return x.data.shape[-1] * x.data.element_size()
    return sum(leaf.element_size() for k, leaf in vars(x).items()
               if k.startswith("f_"))


def value_bytes(x, name: str) -> int:
    """Bytes of one value of field ``name`` of a queue or the running set."""
    if hasattr(x, "data"):
        return x.data.element_size()
    return x.leaf(name).element_size()


def rows_changed_bytes(a, b):
    """Bytes of the row elements of a table (queue or running set) that
    differ between ``a`` and ``b`` (0-d int64 tensor), in its layout."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    return sum((x != y).sum() * x.element_size() for (_, x), (_, y)
               in zip(leaves_with_keys(a), leaves_with_keys(b))
               if x.dim() >= 2)


def set_field_(x, name: str, values) -> None:
    """Overwrite field ``name`` of a queue or the running set in place
    (a plain cast into a compact leaf)."""
    from multi_cluster_simulator_tpu_torch.ops import fields as F

    if hasattr(x, "data"):
        index = (F.QUEUE_INDEX if hasattr(x, "count") else F.RUN_INDEX)[name]
        x.data[..., index].copy_(values)
    else:
        x.leaf(name).copy_(values)


def load_queue(q, rows, count) -> None:
    """Put the int32 rows ``rows`` [C, K, NF] at the front of queue ``q``
    and set its count, in place, in either layout."""
    from multi_cluster_simulator_tpu_torch.ops import fields as F

    K = rows.shape[1]
    if hasattr(q, "data"):
        q.data[:, :K] = rows
    else:
        for i, n in enumerate(F.QUEUE_FIELDS):
            q.leaf(n)[:, :K] = rows[..., i]
    q.count.copy_(count)


def written_bytes(before, after):
    """Bytes of every state element the tick changed (0-d int64 tensor),
    and the same for the rows of Level0 and Level1 together."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    written = sum((x != y).sum() * x.element_size() for (_, x), (_, y)
                  in zip(leaves_with_keys(before), leaves_with_keys(after)))
    queues = (rows_changed_bytes(before.l0, after.l0)
              + rows_changed_bytes(before.l1, after.l1))
    return written, queues


def fixed_reads(s, n_counters: int):
    """Per-tick reads every cluster needs whatever its data: the arrival
    count and the counters the tick updates, the node free and active
    vectors, the running set's active flags."""
    C, N, n_res = s.node_free.shape
    S = s.run.active.shape[1]
    return C * (4 * (1 + n_counters) + N * n_res * s.node_free.element_size()
                + N + S)


def run_reads(s, t: int):
    """Running-set reads: the end_t of each active slot, and the node and
    resources of each slot the tick releases."""
    n_res = s.node_free.shape[2]
    due = s.run.active & (s.run.end_t <= t)
    per_due = value_bytes(s.run, "node") + sum(
        value_bytes(s.run, f) for f in ("cores", "mem", "gpu")[:n_res])
    return value_bytes(s.run, "end_t") * s.run.active.sum() \
        + per_due * due.sum()


def expire_reads(s) -> int:
    """The expire forms' further reads per tick: each node slot's expiry
    word, the one the expiry step reads beyond ``fixed_reads`` (which
    holds its active flag). It writes the flag, the capacity and free
    words and the expiry of the slots that expire, and reads none of them
    first: ``written_bytes`` counts those writes."""
    C, N, _ = s.node_free.shape
    return C * N * 4


def tick_bytes(before, after, rows, counts, t: int, trace: bool):
    """The least bytes a FIFO tick ``t`` must move on this tick's data, as
    (read, written) 0-d int64 tensors on the card (no host sync).

    Written: every state element the tick changed. Read, per cluster: the
    arrival count and the seven counters the tick updates (the trace count
    too when the trace is on), the node free and active vectors, the
    running set's active flags, the end_t of each active slot and the node
    and resources of each slot it releases, every live queue row, and the
    valid arrival rows. Rows that did not change, and queue slots past a
    queue's count, need not move at all. Every state element counts at its
    storage size (the compact layout's narrow leaves)."""
    s = before
    row_b = rows.shape[2] * rows.element_size()
    written, _ = written_bytes(before, after)
    live = sum(q.count.clamp(0, q.capacity).sum()
               for q in (s.ready, s.wait, s.lent))
    valid = counts.clamp(0, rows.shape[1]).sum()
    read = (fixed_reads(s, 7 + int(trace)) + run_reads(s, t)
            + row_bytes(s.ready) * live + row_b * valid)
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
    Qc = s.l0.capacity
    row_b = rows.shape[2] * rows.element_size()
    q_row = row_bytes(s.l0)
    keys = value_bytes(s.l0, "cores") + value_bytes(s.l0, "mem")
    written, l0_written = written_bytes(before, after)
    n_take = counts.clamp(0, rows.shape[1])
    live = (s.l0.count + n_take).clamp(0, Qc)  # [C] Level0 after ingest
    n_sweep = live.clamp(max=QC)
    read = (fixed_reads(s, 8 + int(trace)) + run_reads(s, t)
            + keys * live.sum() + (q_row - keys) * n_sweep.sum()
            + l0_written + row_b * n_take.sum())
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
    Qc = s.l0.capacity
    row_b = rows.shape[2] * rows.element_size()
    written, q_written = written_bytes(before, after)
    n_take = counts.clamp(0, rows.shape[1])
    head = ((s.l0.count + n_take).clamp(0, Qc) > 0).long()
    n_sweep = s.l1.count.clamp(max=QC).long()
    read = (fixed_reads(s, 9 + int(trace)) + run_reads(s, t)
            + row_bytes(s.l1) * (n_sweep + head).sum() + q_written
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
    n_sweep = (s.l0.count + n_take).clamp(0, s.l0.capacity).clamp(max=QC)
    if tesserae:
        read, written, ops = tick_cost_ffd(before, after, rows, counts, t,
                                           trace, QC)
        return read, written, ops + (n_sweep * N * 2 * n_res).sum()
    row_b = rows.shape[2] * rows.element_size()
    written, q_written = written_bytes(before, after)
    read = (fixed_reads(s, 8 + int(trace)) + run_reads(s, t)
            + row_bytes(s.l0) * n_sweep.sum() + q_written
            + row_b * n_take.sum() + 4 * s.node_type.numel())
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
    the worst difference and the plain version's times; the tap form's
    comparisons also keep its launch time and the untapped form's on the
    same state (``tap_ms``, ``untap_ms``; the emit form's tap in
    ``emit_tap_ms``; CUDA events)."""

    def __init__(self, engine, params=None):
        from multi_cluster_simulator_tpu_torch.core.state import clone_state
        from multi_cluster_simulator_tpu_torch.kernels import fused_tick

        self.ft, self.clone, self.engine = fused_tick, clone_state, engine
        self.params = engine._default_params if params is None else params
        self.host = fused_tick.host_params(engine, self.params)
        self.worst, self.n, self.plain_ms = 0.0, 0, []
        self.tap_ms, self.untap_ms, self.emit_tap_ms = [], [], []

    def compare(self, state, rows, counts, t, lent_rows=False, emit=False,
                obs=None, windowed=False):
        """Run kernel and plain on copies of ``state`` and require every
        leaf equal — and with ``emit`` (the emit form) every output:
        ``want``, ``bjob_vec``, ``ret_rows``, ``ret_valid``; returns the
        kernel's state (and its outputs with ``emit``). ``lent_rows``
        first loads the tick's arrival rows into the lent queue too, so
        the FIFO lent-head attempt runs (the lent queue stays empty on
        the paths without borrowing). ``obs``, a ``(MetricsBuffer,
        TapCursor)`` pair, runs the tap form against the plain prefix and
        ``tap_tick``: the buffer, the cursor and the tick's placements and
        depths must be equal too; it returns ``(state, mbuf, cursor)``
        (then the outputs with ``emit``). ``windowed``: ``rows`` and
        ``counts`` are the packed stream and its counts."""
        from multi_cluster_simulator_tpu_torch.obs import device as D

        if lent_rows:
            state = self.clone(state)
            K = min(rows.shape[1], state.lent.capacity)
            load_queue(state.lent, rows[:, :K], counts.clamp(max=K))
        ref_in = self.clone(state)
        ref_obs = tap_in = None
        if obs is not None:
            ref_obs = (self.clone(obs[0]), self.clone(obs[1]))
            tap_in = (D.tap_pc(ref_obs[0]), ref_obs[1])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ref, *ref_io, ref_tap = self.ft.fused_prefix_reference(
            self.engine, ref_in, rows, counts, t, self.params,
            self.host["member"], emit, tap_in, windowed)
        if obs is not None:
            pc, cur, placed_d, depth = ref_tap
            ref_mb = D.tap_tick_global(ref_obs[0].replace(**pc), placed_d,
                                       depth, t, self.engine.cfg.tick_ms)
        ev[1].record()
        k_obs = uev = None
        if obs is not None:
            k_obs = (self.clone(obs[0]), self.clone(obs[1]))
            uev = timed_launch(self.ft, self.engine, self.clone(state), rows,
                               counts, t, self.params, self.host, emit=emit,
                               windowed=windowed)
        k_in = self.clone(state)
        # its operands checked outside the timed pair
        self.ft.prepare(self.engine, k_in, self.host, emit, k_obs)
        kev = timed_launch_events()
        kev[0].record()
        out, *io, k_tap = self.ft.fused_prefix(
            self.engine, k_in, rows, counts, t, self.params, self.host,
            emit_returns=emit, obs=k_obs, windowed=windowed)
        kev[1].record()
        torch.cuda.synchronize()
        self.plain_ms.append(ev[0].elapsed_time(ev[1]))
        d = max_abs_diff(ref, out)
        if emit:
            d = max(d, io_diff(ref_io, io))
        if obs is not None:
            if emit:
                self.emit_tap_ms.append(kev[0].elapsed_time(kev[1]))
            else:
                self.tap_ms.append(kev[0].elapsed_time(kev[1]))
                self.untap_ms.append(uev[0].elapsed_time(uev[1]))
            d = max(d, max_abs_diff(ref_mb, k_obs[0]),
                    max_abs_diff(cur, k_obs[1]),
                    io_diff((placed_d, depth), k_tap[2:]))
        if d:
            kernel = self.host[("emit_" if emit else "")
                               + ("tap_kernel" if obs else "kernel")].name
            raise AssertionError(f"{kernel} differs from plain at t={t}: "
                                 f"max |diff| {d}")
        self.worst, self.n = max(self.worst, d), self.n + 1
        if obs is not None:
            out = (out, *k_obs)
            return (*out, io) if emit else out
        return (out, io) if emit else out


def timed_launch_events():
    """A CUDA event pair, with the card kept busy ahead of the first so
    that the pair times the launch between them and not the host."""
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(SPIN_CYCLES)
    return ev


def timed_launch(fused_tick, engine, state, rows, counts, t, params, host,
                 emit=False, out=None, obs=None, windowed=False):
    """One kernel launch between a CUDA event pair, with the card kept
    busy ahead of it so the pair times the kernel and not the host;
    ``emit`` launches the emit form into ``out``, ``obs`` the tap form;
    what the launch reads from the host is checked before the pair."""
    fused_tick.prepare(engine, state, host, emit, obs)
    ev = timed_launch_events()
    ev[0].record()
    fused_tick.fused_prefix(engine, state, rows, counts, t, params, host,
                            emit_returns=emit, out=out, obs=obs,
                            windowed=windowed)
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
    emit_read = emit_written = 0
    busiest = int(np.argmax(ch.counts.max(axis=1)))
    for k in range(ch.rows.shape[0]):
        t += cfg.tick_ms
        if k in (0, busiest):
            chk.compare(state, rows_all[k], counts_all[k], t, emit=True)
        before = clone_state(state)
        evs.append(timed_launch(fused_tick, engine, state, rows_all[k],
                                counts_all[k], t, params, host, emit=True,
                                out=io))
        r, w = tick_cost_borrow(before, state, rows_all[k], counts_all[k],
                                t, cfg.record_trace, engine.n_msgs())
        emit_read, emit_written = emit_read + r, emit_written + w
        state.t.fill_(t)
    torch.cuda.synchronize()
    emit_ms = [a.elapsed_time(b) for a, b in evs]
    emit_read = int(emit_read) / len(emit_ms)
    emit_written = int(emit_written) / len(emit_ms)
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
    ch_t = first_ticks(E.pack_arrivals_chunks(arr_t, chunk_sizes(n_ticks),
                                              cfg.tick_ms))
    plain_run_s, kernel_run_s, out = whole_run_against_plain(
        E, eng_t, init_state(cfg_t, specs_t, device=dev), ch_t, "FIFO")
    placed = int(out.placed_total.sum())
    print(f"phase 3b: {RUN_C}-cluster headline run, its first "
          f"{sum(c.rows.shape[0] for c in ch_t)} ticks, FIFO kernel == plain "
          f"on every leaf and the trace ({placed} placements); run wall "
          f"plain {plain_run_s:.3f} s, kernel {kernel_run_s:.3f} s [{card}]")
    return dict(worst=chk.worst, kernel_ms=kernel_ms, plain_ms=chk.plain_ms,
                read_per_launch=read_b, written_per_launch=written_b,
                emit_ms=emit_ms, emit_read=emit_read,
                emit_written=emit_written)


def whole_run_against_plain(E, engine, s0, chunks, what, params=None,
                            counts=None):
    """A whole run through ``engine.run_chunks`` (the kernel) and through
    the plain version tick by tick — with borrowing, the plain prefix's
    emit form and the engine's delivery and matching after it, with the
    trader its snapshot and market round — from copies of ``s0``; every
    leaf of the two final states must be equal. Returns the two walls and
    the kernel's final state; with ``counts`` (a dict) every launch count
    is set to 0 just before the kernel run and read into it just after."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    params = engine._default_params if params is None else params
    member = engine.member(params)
    jitter = engine.jitter(s0.arr_ptr.shape[0])
    ref = clone_state(s0)
    t = 0
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(s0.device)
        counts_all = torch.from_numpy(ch.counts).to(s0.device)
        for k in range(ch.rows.shape[0]):
            t += engine.cfg.tick_ms
            ref, *io, _ = fused_tick.fused_prefix_reference(
                engine, ref, rows_all[k], counts_all[k], t, params, member,
                emit_returns=engine.cfg.borrowing)
            ref = engine._cross_cluster(ref, *io)
            ref = engine._market(ref, t, params, jitter)
            ref.t.fill_(t)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - w0
    s1 = clone_state(s0)
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    w0 = time.perf_counter()
    out = engine.run_chunks(s1, chunks, params)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - w0
    if counts is not None:
        counts.update(fused_tick.launch_counts())
    d = max_abs_diff(ref, out)
    if d:
        raise AssertionError(f"whole {what} run: kernel differs from plain "
                             f"(max |diff| {d})")
    return plain_s, kernel_s, out


def counted_run(engine, s0, chunks, kernel, io=None):
    """The main path's counted run: every launch count set to 0 just
    before ``engine.run_chunks``, read just after. ``kernel`` must have
    launched once per tick and no other prefix kernel at all; a sinkhorn
    market's rounds each ran the round kernel (``counts
    ["sinkhorn_round"]``), no other run did. With ``io`` (a
    dict of counters) the run goes through ``engine.run_io`` chunk by
    chunk instead, and adds every tick's wants and returns to ``io``.
    Returns the final state, the wall and the counts."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.market import sinkhorn

    state = clone_state(s0)
    n_ticks = sum(ch.rows.shape[0] for ch in chunks)
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    sinkhorn.reset_launches()
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
    check_launches(counts, kernel, n_ticks, kernel)
    # the sinkhorn round's kernel: one round a round tick of a sinkhorn
    # market's run, none elsewhere
    trader = engine.cfg.trader
    sink = trader.enabled and trader.matching.value == "sinkhorn"
    rounds = sinkhorn.LAUNCHES["sinkhorn_round"]
    if sink != (rounds > 0) or (sink and sinkhorn.LAUNCHES[
            "sinkhorn_product"] != 2 * trader.sinkhorn_iters * rounds):
        raise AssertionError(f"{kernel}: sinkhorn launches "
                             f"{dict(sinkhorn.LAUNCHES)}")
    counts["sinkhorn_round"] = rounds
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
                h2d_s=h2d_s, final=out, chunks=chunks, arr=arr, specs=specs)


def borg_stream(E, C, jobs, horizon_ms, tick_ms, arrivals=False):
    """bench_borg4k's stream and its 400-tick ragged-K chunks (and with
    ``arrivals`` the stream itself)."""
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        borg_like_stream,
    )

    arr = borg_like_stream(C, jobs, horizon_ms, max_cores=32, max_mem=24_000,
                           seed=19)
    n_ticks = horizon_ms // tick_ms + 100
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), tick_ms)
    return (chunks, n_ticks, arr) if arrivals else (chunks, n_ticks)


def market_step(E, engine, state, t, params, jitter, spans, fired):
    """Phases 7 and 8 as ``Engine._market`` runs them, each where the
    engine says it is due and between a CUDA event pair
    (``spans["snapshot"]``, ``spans["trade"]``), adding the virtual nodes
    the round attaches to ``fired["attached"]``; with expiry, also those
    attached on a contract of 0 s (``fired["zero_s"]``: the as-built
    sizing's time reset, or an empty Level1) and those whose contract
    ends within a tick (``fired["one_tick"]``, the 0 s ones included):
    both expire at the next tick. Returns the state."""
    from multi_cluster_simulator_tpu_torch.market import trader as market

    mcfg = engine.cfg.trader
    if engine.snapshot_due(t):
        state, ev = timed_span(lambda: E._snapshot(state))
        spans["snapshot"].append(ev)
    if engine.round_due(t):
        active = state.node_active
        state, ev = timed_span(lambda: market.trade_round(
            state, t, engine.cfg, engine.ex, params, jitter))
        spans["trade"].append(ev)
        new = state.node_active & ~active
        fired["attached"] = fired["attached"] + new.sum()
        if mcfg.expire_virtual_nodes:
            ends = state.node_expire - t  # the contract's time_ms
            fired["zero_s"] = fired.get("zero_s", 0) + (
                new & (ends == 0)).sum()
            fired["one_tick"] = fired.get("one_tick", 0) + (
                new & (ends <= engine.cfg.tick_ms)).sum()
    return state


def sampled_kernel_pass(E, chk, engine, s0, chunks, picks, QC, cost=None):
    """Drive a whole run tick by tick through the kernel, a CUDA event
    pair around every launch and the tick's bytes and operations counted
    (by ``cost(before, after, rows, counts, t)``, FFD's by default, plus
    ``expire_reads`` where the kernel is an expire form), and, with the
    trader, the snapshot and the market round on their cadences each
    between a CUDA event pair; at the global ticks in ``picks`` compare
    kernel and plain on the state the run has reached. Counts the virtual
    nodes the kernel expires and the rounds attach. Returns the per-launch
    times, the mean bytes read and written and the mean operations per
    launch, the market's span times, the worst Level0 and Level1 depths
    seen, the counts and the final state."""
    if cost is None:
        def cost(before, after, rows, counts, t):
            return tick_cost_ffd(before, after, rows, counts, t,
                                 engine.cfg.record_trace, QC)
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    params, host = chk.params, chk.host
    dev = s0.device
    jitter = engine.jitter(s0.arr_ptr.shape[0])
    extra = expire_reads(s0) if host["expire"] else 0
    vstart = engine.cfg.max_nodes
    state = clone_state(s0)
    node_dt = s0.node_free.dtype
    narrow = node_dt != torch.int32 and not engine.prefix_terminal()
    evs, read_b, written_b, ops, t, k_glob = [], 0, 0, 0, 0, 0
    spans = {"snapshot": [], "trade": []}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fired = {"expired": zero, "attached": zero}
    max_l0 = torch.zeros((), dtype=torch.int32, device=dev)
    max_l1 = torch.zeros((), dtype=torch.int32, device=dev)
    swept_max = torch.zeros((), dtype=torch.int32, device=dev)
    swept_sum = torch.zeros((), dtype=torch.int64, device=dev)
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(dev)
        counts_all = torch.from_numpy(ch.counts).to(dev)
        for k in range(ch.rows.shape[0]):
            t += engine.cfg.tick_ms
            rows, counts = rows_all[k], counts_all[k]
            if narrow:
                state = E._widen_nodes(state)
            if k_glob in picks:
                chk.compare(state, rows, counts, t)
            if host["expire"]:
                fired["expired"] = fired["expired"] + (
                    state.node_active & (state.node_expire <= t))[
                        :, vstart:].sum()
            before = clone_state(state)
            swept = before.l1.count.clamp(max=QC)  # DELAY's Level1 sweep
            swept_max = torch.maximum(swept_max, swept.max())
            swept_sum = swept_sum + swept.sum()
            evs.append(timed_launch(chk.ft, engine, state, rows, counts,
                                    t, params, host))
            r, w, o = cost(before, state, rows, counts, t)
            read_b, written_b, ops = read_b + r + extra, written_b + w, \
                ops + o
            max_l0 = torch.maximum(max_l0, state.l0.count.max())
            max_l1 = torch.maximum(max_l1, state.l1.count.max())
            state = market_step(E, engine, state, t, params, jitter, spans,
                                fired)
            if narrow:
                state = E._narrow_nodes(state, node_dt)
            state.t.fill_(t)
            k_glob += 1
    torch.cuda.synchronize()
    return dict(kernel_ms=[a.elapsed_time(b) for a, b in evs],
                read=int(read_b) / k_glob, written=int(written_b) / k_glob,
                ops=int(ops) / k_glob, max_l0=int(max_l0),
                max_l1=int(max_l1), l1_swept_max=int(swept_max),
                l1_swept_mean=int(swept_sum) / (k_glob * swept.numel()),
                ticks=k_glob, state=state,
                spans={k: [a.elapsed_time(b) for a, b in v]
                       for k, v in spans.items()},
                fired={k: int(v) for k, v in fired.items()})


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
    sp = sampled_kernel_pass(E, chk, engine, s0, chunks, picks, QC)
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
            ch = E.pack_arrivals_chunks(
                arr, [FFD_HEAVY_TICKS if name == "wave"
                      else FFD_HEAVY_TICKS // 2], vcfg.tick_ms)[0]
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
    ch_q = first_ticks(ch_q)
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
    """Phase 4c: bench_ffd64, Level0 768 deep: 8 ticks of the first 1,200
    compared, every launch of those timed, then one full run with the
    reference's asserts."""
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
    lead = chunks[:FFD64_PASS_CHUNKS]
    picks, _ = pick_ticks(lead, FFD64_SAMPLES)
    sp = sampled_kernel_pass(E, chk, engine, s0, lead, picks,
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
    b_ms, b_by = bound(sp["read"], sp["written"], sp["ops"])
    print(f"phase 4c: ffd64 bound {b_ms * 1e3:.4f} us by {b_by} "
          f"({sp['read'] + sp['written']:.1f} B per launch, mean of "
          f"{sp['read']:.1f} read and {sp['written']:.1f} written; "
          f"{sp['ops']:.1f} compares per launch) over the first "
          f"{sp['ticks']} ticks; kernel / bound {kms / b_ms:.1f} [{card}]")
    return dict(worst=chk.worst, record=dict(
        name="fused_prefix_ffd (ffd64)",
        kernel=fused_tick.KERNELS["fused_prefix_ffd"],
        launches=counts["fused_prefix_ffd"], worst=chk.worst, ms=kms,
        plain=chk.plain_ms, bound=(b_ms, b_by)))


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
        room = before.l0.capacity - before.l0.count
        ingest_drops = (counts.clamp(0, rows.shape[1]) - room).clamp(min=0)
        seen["promoted"] += int((after.l1.count > before.l1.count).sum())
        seen["l1_full"] += int((after.drops.queue - before.drops.queue
                                - ingest_drops).sum())
        seen["run_full"] += int((after.drops.run_full
                                 - before.drops.run_full).sum())
        if after.trace.t.shape[1] == 1:
            return
        n0, n1 = before.trace.n.cpu().numpy(), after.trace.n.cpu().numpy()
        ids = before.l1.id.cpu().numpy()
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
            max=before.l0.capacity)
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

        sp = sampled_kernel_pass(E, chk, engine,
                                 init_state(cfg, market["specs"], device=dev),
                                 market["chunks"], picks, QC, cost)
        out[name] = dict(sampled=sp, worst=chk.worst, plain_ms=chk.plain_ms)
        print(f"phase 3d: DELAY kernel == plain bitwise on {chk.n} ticks of "
              f"run ({name}) sampled as the kernel reached them (ticks "
              f"{sorted(picks)}, the peak {peak} included), C={MARKET_C}; "
              f"max Level0 depth {sp['max_l0']}, Level1 {sp['max_l1']}; "
              f"Level1 rows the sweep took a tick (min(|L1|, {QC})) max "
              f"{sp['l1_swept_max']}, mean {sp['l1_swept_mean']:.4f} per "
              f"cluster-tick{market_note(sp)} [{card}]")

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

    # a run at sinkhorn_market_setup(quick=True)'s shape, trace on
    qc_, qj = MARKET_QUICK
    cfg_q = market_cfg(P, quick=True, jobs=qj, **trace)
    eng_q = E.Engine(cfg_q, device=dev)
    ch_q = first_ticks(market_stream(E, qc_, qj, quick=True)[0])
    nq = sum(c.rows.shape[0] for c in ch_q)
    plain_s, kernel_s, fin = whole_run_against_plain(
        E, eng_q, init_state(cfg_q, market_specs(P, qc_), device=dev), ch_q,
        "DELAY")
    print(f"phase 3d: quick market run ({qc_} clusters x {qj} jobs, its "
          f"first {nq} ticks), DELAY kernel == plain on every leaf and the "
          f"trace ({int(fin.placed_total.sum())} placements); run wall plain "
          f"{plain_s:.3f} s, kernel {kernel_s:.3f} s [{card}]")
    out["worst"] = worst
    return out


def market_note(sp) -> str:
    """What a sampled pass saw of the market: its spans' mean times and
    counts, the nodes it attached and expired (empty without it)."""
    spans = sp["spans"]
    if not spans["trade"]:
        return ""
    return (f"; market: {len(spans['trade'])} rounds at "
            f"{np.mean(spans['trade']):.3f} ms and {len(spans['snapshot'])}"
            f" snapshots at {np.mean(spans['snapshot']):.3f} ms (CUDA-event "
            f"spans, the card kept busy ahead of each: a span holds host "
            f"time where the host enqueues slower than the card runs), "
            f"virtual nodes attached {sp['fired']['attached']}, expired "
            f"{sp['fired']['expired']}")


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

        sp = sampled_kernel_pass(E, chk, engine,
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

    # runs at the quick market shape, the trace on, over its first
    # WHOLE_RUN_TICKS ticks: tesserae on the market's clusters, rl with
    # seeded scores on mixed nodes
    qc_, qj = MARKET_QUICK
    cfg_q = market_cfg(P, quick=True, jobs=qj, **trace)
    ch_q = first_ticks(market_stream(E, qc_, qj, quick=True)[0])
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
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.tools.tournament import (
        DEFAULT_POLICIES,
    )

    cfg = market_cfg(P, record_trace=True, max_trace_events=512)
    pset = PolicySet(DEFAULT_POLICIES)
    engine = E.Engine(cfg, device=dev, policies=pset)
    chunks, _, _ = market_stream(E, LINEUP_C, MARKET_JOBS)
    part = first_ticks(chunks, LINEUP_TICKS)
    s0 = init_state(cfg, market_specs(P, LINEUP_C), device=dev)
    for idx, name in enumerate(DEFAULT_POLICIES):
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


def phase_market(P, E, card, dev, market, name, sampled):
    """Phases 4d-4h: one full-shape market run through the entry points;
    ``sampled`` is its tick-by-tick pass (the attaches and expiries it
    counted, on the same trajectory)."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    policy, kw, gate = MARKET_RUNS[name]
    cfg = market_cfg(P, **kw)
    engine = E.Engine(cfg, device=dev, policies=PolicySet((policy,)))
    kernel = fused_tick.host_params(engine, engine._default_params)[
        "kernel"].name
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
    vnodes = int(out.node_active[:, cfg.max_nodes:].sum())
    fired = sampled["fired"] if sampled else {"attached": 0, "expired": 0}
    if sampled and max_abs_diff(sampled["state"], out):
        raise AssertionError(f"run ({name}): run_chunks differs from its "
                             f"sampled pass")
    share, frac = placed / placeable, placed / n_jobs
    bad = {"market": bool(any(drops.values()) or frac < MARKET_FLOOR
                          or vnodes < VNODE_FLOOR),
           "placeable": bool(any(drops.values()) or share < MARKET_FLOOR),
           "expire": bool(any(drops.values()) or share < MARKET_FLOOR
                          or fired["attached"] < VNODE_FLOOR
                          or not fired["expired"]),
           None: False}[gate]
    if bad:
        raise AssertionError(f"run ({name}): drops {drops}, placed {frac:.4f}"
                             f" of all, {share:.4f} of the placeable jobs, "
                             f"vnodes {vnodes}, {fired}")
    trader = cfg.trader
    walls, h2d_s, _ = timed_runs(engine, s0, chunks, MARKET_WARMUPS,
                                 MARKET_TIMED if trader.enabled else 1)
    label = f"phase 4{'defgh'['abcde'.index(name)]}"
    short = (f" ({fired['zero_s']} on contracts of 0 s, {fired['one_tick']}"
             f" on contracts that end within a tick, 0 s included: these "
             f"expire at the next tick)" if "zero_s" in fired else "")
    what = (f"{policy}, trader on ({trader.matching.value}, carve "
            f"{trader.carve_mode}, expiry {trader.expire_virtual_nodes})"
            if trader.enabled else f"{policy} {kw or ''}, trader cut")
    print(f"{label}: market run ({name}) {what}: {MARKET_C} clusters x "
          f"{MARKET_JOBS} jobs, {n_ticks} ticks: placed {placed} of {n_jobs}"
          f" ({frac:.4f} of all; bench floor {MARKET_FLOOR} "
          f"{'applied' if gate == 'market' else 'not applied'}), "
          f"unplaceable without the market {market['unplaceable']}, placed "
          f"share of the rest {share:.4f} (floor {MARKET_FLOOR} "
          f"{'applied' if gate in ('placeable', 'expire') else 'not applied'}"
          f"), virtual nodes at the end {vnodes}, attached over the run "
          f"{fired['attached']}{short}, expired {fired['expired']}, queued "
          f"at the end {queued}, drops {drops}, launches {counts}, "
          f"conservation ok; state {state_b} B, peak device memory {peak_b} "
          f"B [{card}]")
    metric = ("sinkhorn_market_jobs_per_sec_4k_clusters_3res"
              if gate == "market" else f"market ({name})")
    wmin, wmed = print_run(label, metric, placed, walls, first_s,
                           n_ticks, chunks, h2d_s, card)
    prof = None
    if trader.enabled:
        prof = device_profile(E, engine, s0, chunks, MARKET_PROFILE_TICKS)
        print(f"{label}: the card's own time (torch.profiler over "
              f"{MARKET_PROFILE_TICKS} ticks from tick {CHUNK}): prefix "
              f"{prof['prefix'] * 1e3:.2f} us/tick, snapshot "
              f"{prof['per_snapshot'] * 1e3:.2f} us each, trade round "
              f"{prof['per_round'] * 1e3:.2f} us each; kernels by name: "
              f"{prof['top']} [{card}]")
    return dict(launches=counts[kernel], placed=placed, wall_min_s=wmin,
                sinkhorn_rounds=counts["sinkhorn_round"],
                wall_median_s=wmed, n_ticks=n_ticks, h2d_s=h2d_s,
                share=share, frac=frac, drops=drops, vnodes=vnodes,
                fired=fired, profile=prof,
                final=out if gate == "market" else None)


def expire_heavy(E, dev, engine, state, rows, counts, t0, n, cost, seen):
    """``n`` heavy ticks for an expire form on ``state``: before each, the
    expiry of nine in ten active virtual slots is set to at most the
    tick's clock, so that thousands of nodes expire in one launch; kernel
    == plain on every tick (and every emit output), and each tick's launch
    timed ``HEAVY_EXPIRE_REPS`` times, each on its own copy, after one
    untimed launch of the form; bytes counted on the first copy. Adds the
    expiries to ``seen``; returns the Checker, the per-launch times and
    the mean bytes."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    chk = Checker(engine)
    emit = engine.cfg.borrowing
    vstart = engine.cfg.max_nodes
    gen = torch.Generator(device=dev).manual_seed(5)
    # one untimed launch first, on a copy: a form's first launch on the
    # card loads its module and can cost many times its work
    chk.ft.fused_prefix(engine, clone_state(state), rows[0], counts[0],
                        t0 + engine.cfg.tick_ms, chk.params, chk.host,
                        emit_returns=emit)
    evs, read_b, written_b, t = [], 0, 0, t0
    seen.setdefault("per_launch", [])
    for k in range(n):
        t += engine.cfg.tick_ms
        slots = state.node_active.clone()
        slots[:, :vstart] = False
        hit = slots & (torch.rand(slots.shape, generator=gen, device=dev)
                       < 0.9)
        back = torch.randint(0, 5_000, slots.shape, generator=gen,
                             device=dev, dtype=torch.int32)
        state.node_expire.copy_(torch.where(hit, t - back,
                                            state.node_expire))
        hits = int((state.node_active & (state.node_expire <= t)).sum())
        seen["expired"] += hits
        seen["per_launch"].append(hits)
        before = clone_state(state)
        copies = [clone_state(state) for _ in range(HEAVY_EXPIRE_REPS)]
        for timed in copies:
            evs.append(timed_launch(chk.ft, engine, timed, rows[k],
                                    counts[k], t, chk.params, chk.host,
                                    emit=emit))
        r, w = cost(before, copies[0], rows[k], counts[k], t)
        read_b, written_b = read_b + r + expire_reads(before), written_b + w
        out = chk.compare(state, rows[k], counts[k], t, emit=emit)
        state = out[0] if emit else out
        if any(max_abs_diff(timed, state) for timed in copies):
            raise AssertionError("a timed launch differs from the compared "
                                 "one")
        state.t.fill_(t)
    torch.cuda.synchronize()
    return chk, [a.elapsed_time(b) for a, b in evs], int(read_b) / n, \
        int(written_b) / n


def phase_expire_kernel_vs_plain(P, E, card, dev, market, state_a):
    """Phase 3i: every expire form against its plain version.
    (a) run (e), the market with expiry at full width: every launch timed,
    kernel == plain at sampled ticks, the nodes expired and attached
    counted; (b) heavy ticks on the state run (a) reached (its thousands
    of virtual nodes), nine in ten set to expire, for each kernel's expire
    form; (c) the first 150 ticks of quick-shape runs (DELAY, FFD,
    gavel) with the trader and expiry; (d) the first 600 ticks of config 2 with expiry (the FIFO
    emit form) and (e) the same without borrowing (the FIFO state-only
    form). The runs count their launches through ``Engine.run_chunks``."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies import kernels as K
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )

    out = {}
    # (a) run (e) at full width
    policy, kw, _ = MARKET_RUNS["e"]
    cfg = market_cfg(P, **kw)
    QC = K._sweep_len(cfg)
    engine = E.Engine(cfg, device=dev, policies=PolicySet((policy,)))
    chk = Checker(engine)
    picks, peak = pick_ticks(market["chunks"], MARKET_SAMPLES)

    def cost_delay(b, a, r, c, t):
        return tick_cost_delay(b, a, r, c, t, cfg.record_trace, QC)

    sp = sampled_kernel_pass(E, chk, engine,
                             init_state(cfg, market["specs"], device=dev),
                             market["chunks"], picks, QC, cost_delay)
    out["e"] = dict(sampled=sp, worst=chk.worst, plain_ms=chk.plain_ms)
    print(f"phase 3i: DELAY expire kernel == plain bitwise on {chk.n} ticks "
          f"of run (e) sampled as the kernel reached them (ticks "
          f"{sorted(picks)}), C={MARKET_C}{market_note(sp)} [{card}]")

    # (b) heavy ticks on run (a)'s final state, for every expire form
    ch = market["chunks"][0]
    rows = torch.from_numpy(ch.rows[:HEAVY_EXPIRE_TICKS]).to(dev)
    counts = torch.from_numpy(ch.counts[:HEAVY_EXPIRE_TICKS]).to(dev)
    t0 = market["n_ticks"] * cfg.tick_ms
    variants = [("delay", "delay", {}), ("ffd", "ffd", {}),
                ("gavel", "gavel", {}), ("tesserae", "tesserae", {}),
                ("fifo", "fifo", {}), ("fifo emit", "fifo",
                                       {"borrowing": True})]
    seen = {"expired": 0}
    heavy = {}
    for name, pol, extra in variants:
        vcfg = market_cfg(P, trader=EXPIRE, **extra)
        veng = E.Engine(vcfg, device=dev, policies=PolicySet((pol,)))
        vQC = K._sweep_len(vcfg)
        kind = pol if pol in ("ffd", "delay", "fifo") else "scored"

        def cost(b, a, r, c, t, kind=kind, pol=pol, vQC=vQC, vcfg=vcfg,
                 veng=veng):
            if kind == "ffd":
                rd, wr, _ = tick_cost_ffd(b, a, r, c, t, False, vQC)
            elif kind == "delay":
                rd, wr, _ = tick_cost_delay(b, a, r, c, t, False, vQC)
            elif kind == "scored":
                rd, wr, _ = tick_cost_scored(b, a, r, c, t, False, vQC,
                                             pol == "tesserae")
            elif vcfg.borrowing:
                rd, wr = tick_cost_borrow(b, a, r, c, t, False,
                                          veng.n_msgs())
            else:
                rd, wr = tick_bytes(b, a, r, c, t, False)
            return rd, wr

        n0, k0 = seen["expired"], len(seen.get("per_launch", []))
        vchk, ms, rd, wr = expire_heavy(
            E, dev, veng, clone_state(state_a), rows, counts, t0,
            HEAVY_EXPIRE_TICKS, cost, seen)
        kname = vchk.host["emit_kernel" if vcfg.borrowing
                        else "kernel"].name
        heavy[kname] = heavy.get(kname, []) + [dict(
            ms=ms, read=rd, written=wr, worst=vchk.worst,
            plain_ms=vchk.plain_ms)]
        print(f"phase 3i: {kname} ({name}) == plain bitwise on "
              f"{vchk.n} heavy ticks at C={MARKET_C}, "
              f"{seen['expired'] - n0} virtual nodes expired "
              f"({seen['per_launch'][k0:]} by launch), "
              f"{np.mean(ms) * 1e3:.2f} us/launch [{card}]")
    out["heavy"] = heavy

    # (c)-(e) whole runs with expiry, their launches counted
    qc_, qj = MARKET_QUICK
    ch_q = first_ticks(market_stream(E, qc_, qj, quick=True)[0],
                       EXPIRE_RUN_TICKS)
    c2_short, _ = borrow_stream(P, E, 2, BORROW_A_TICKS)
    runs = [(f"quick {pol}", market_cfg(P, quick=True, jobs=qj,
                                        trader=EXPIRE),
             pol, market_specs(P, qc_), ch_q)
            for pol in ("delay", "ffd", "gavel")]
    runs += [("config 2", borrow_cfg(P, {"expire_virtual_nodes": True}),
              "fifo", borrow_specs(P, 2), c2_short),
             ("config 2, no borrowing", borrow_cfg(
                 P, {"expire_virtual_nodes": True}, borrowing=False),
              "fifo", borrow_specs(P, 2), c2_short)]
    out["launches"] = {}
    for name, rcfg, pol, specs, chunks in runs:
        reng = E.Engine(rcfg, device=dev, policies=PolicySet((pol,)))
        counts_run = {}
        plain_s, kernel_s, fin = whole_run_against_plain(
            E, reng, init_state(rcfg, specs, device=dev), chunks, name,
            counts=counts_run)
        n_ticks = sum(c.rows.shape[0] for c in chunks)
        host = fused_tick.host_params(reng, reng._default_params)
        kname = host["emit_kernel" if rcfg.borrowing else "kernel"].name
        want = {k: (n_ticks if k == kname else 0) for k in counts_run}
        if counts_run != want:
            raise AssertionError(f"{name}: launches {counts_run}")
        drops = total_drops(fin)
        if any(drops.values()):
            raise AssertionError(f"{name}: drops {drops}")
        check_conservation(fin)
        out["launches"][kname] = n_ticks
        print(f"phase 3i: whole run, {name} ({len(specs)} clusters x "
              f"{n_ticks} ticks), trader and expiry on: {kname} + the "
              f"phases after it == plain on every leaf (placed "
              f"{int(fin.placed_total.sum())}, virtual nodes at the end "
              f"{int(fin.node_active[:, rcfg.max_nodes:].sum())}, contract "
              f"requests {int(fin.trader.next_contract_id.sum()) - len(specs)}"
              f"), zero drops, conservation ok, launches {kname} x "
              f"{n_ticks}; run wall plain {plain_s:.3f} s, kernel "
              f"{kernel_s:.3f} s [{card}]")
    out["worst"] = max([chk.worst] + [h["worst"] for v in heavy.values()
                                       for h in v])
    return out


def phase_matchers(P, E, card, dev):
    """Phase 3j: short runs of the greedy and the cvx market at the quick
    market shape through ``Engine.run_chunks``: conservation, zero drops,
    one DELAY launch a tick, and the virtual nodes each traded."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )

    qc_, qj = MARKET_QUICK
    chunks = first_ticks(market_stream(E, qc_, qj, quick=True)[0],
                         MATCHER_TICKS)
    n_ticks = MATCHER_TICKS
    for matching in ("greedy", "cvx"):
        cfg = market_cfg(P, quick=True, jobs=qj,
                         trader=dict(SINKHORN, matching=matching))
        engine = E.Engine(cfg, device=dev)
        fin, wall, counts = counted_run(
            engine, init_state(cfg, market_specs(P, qc_), device=dev),
            chunks, "fused_prefix_delay")
        drops = total_drops(fin)
        if any(drops.values()):
            raise AssertionError(f"{matching}: drops {drops}")
        check_conservation(fin)
        print(f"phase 3j: {matching} market, quick shape ({qc_} clusters x "
              f"{qj} jobs, {n_ticks} ticks, carve sane): placed "
              f"{int(fin.placed_total.sum())}, virtual nodes traded "
              f"{int(fin.node_active[:, cfg.max_nodes:].sum())}, closing "
              f"prices sum {float(fin.trader.mkt_price.sum()):.4f}, zero "
              f"drops, conservation ok, launches fused_prefix_delay x "
              f"{counts['fused_prefix_delay']}; wall {wall:.3f} s [{card}]")


def borrow_cfg(P, trader=None, **kw):
    """bench_fifo_two_trader's config (bench.py:898-933, BASELINE config 2)
    as the port's, with the trader off unless ``trader`` gives its
    settings (``{}``: the bench's own, the greedy market)."""
    base = dict(policy=P.PolicyKind.FIFO, borrowing=True,
                queue_capacity=1024, max_running=512, max_arrivals=4096,
                max_nodes=10,
                workload=P.WorkloadConfig(poisson_lambda_per_min=30.0),
                trader=trader_cfg(P, trader))
    base.update(kw)
    return P.SimConfig(**base)


def borrow_specs(P, C):
    """Config 2's pair, tiled: cluster_small (5 nodes) even, cluster_big
    (10 nodes) odd."""
    return [P.uniform_cluster(c + 1, 5 if c % 2 == 0 else 10)
            for c in range(C)]


def borrow_stream(P, E, C, n_ticks=None, arrivals=False):
    """Config 2's stream for C clusters (every cluster loaded), the
    400-tick ragged-K chunks of its first ``n_ticks``, and its number of
    jobs (and with ``arrivals`` the stream itself)."""
    from multi_cluster_simulator_tpu_torch.workload.generator import (
        generate_arrivals,
    )

    arr = generate_arrivals(P.WorkloadConfig(poisson_lambda_per_min=30.0),
                            C, 4096, BORROW_HORIZON_MS, 32, 24_000, seed=9)
    chunks = chunk_sizes(BORROW_TICKS if n_ticks is None else n_ticks)
    out = E.pack_arrivals_chunks(arr, chunks, 1_000), int(arr.n.sum())
    return (*out, arr) if arrivals else out


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
    C, Qc = s.arr_ptr.shape[0], s.ready.capacity
    row_b = rows.shape[2] * rows.element_size()
    written, _ = written_bytes(before, after)
    moved = sum(rows_changed_bytes(q0, q1) for q0, q1 in (
        (before.ready, after.ready), (before.wait, after.wait),
        (before.lent, after.lent)))
    n_take = counts.clamp(0, rows.shape[1])
    pre = (s.ready.count + n_take).clamp(max=Qc)
    drained = (pre - after.ready.count).clamp(min=0)
    heads = (pre > 0).long() + (s.wait.count > 0) + (s.lent.count > 0)
    out_row = 4 * len(("end_t", "node", "cores", "mem", "gpu", "id",
                       "owner", "dur", "enq_t", "retries"))
    read = (fixed_reads(s, 8 + int(trace)) + run_reads(s, t) + moved
            + row_b * n_take.sum()
            + row_bytes(s.ready) * (drained.sum() + heads.sum())
            + C * M * row_bytes(s.run))
    written = written + C * (M * out_row + M + row_b + 1)
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
    emit kernel, return delivery, borrow matching, and with the trader the
    snapshot and the market round on their cadences — each between a CUDA
    event pair; count the kernel's bytes and what fired; at the global
    ticks in ``picks`` compare kernel and plain on copies of the state the
    run has reached. Stops after ``until`` ticks when given. Returns the
    per-tick (per-span for the market) times, the mean bytes, the counts,
    the final state and the clock."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, empty_io,
    )
    from multi_cluster_simulator_tpu_torch.ops import queues as Q

    engine, params, host = chk.engine, chk.params, chk.host
    cfg, dev = engine.cfg, s0.device
    C, M = s0.arr_ptr.shape[0], engine.n_msgs()
    io = empty_io((C,), M, dev)
    state = clone_state(s0)
    node_dt = s0.node_free.dtype  # compact: widened for the tick's phases
    jitter = engine.jitter(C)
    extra = expire_reads(s0) if host["expire"] else 0
    evs = {"kernel": [], "deliver": [], "match": [], "snapshot": [],
           "trade": []}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fired = dict.fromkeys(("want", "returns", "msgs_dropped", "matched",
                           "lent_placed", "lent_push_dropped"), zero)
    if cfg.trader.enabled:
        fired["attached"] = zero
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
            state = E._widen_nodes(state)
            if k_glob in picks:
                chk.compare(state, rows, counts, t, emit=True)
            before = clone_state(state)
            evs["kernel"].append(timed_launch(
                chk.ft, engine, state, rows, counts, t, params, host,
                emit=True, out=io))
            r, w = tick_cost_borrow(before, state, rows, counts, t,
                                    cfg.record_trace, M)
            read_b, written_b = read_b + r + extra, written_b + w
            lent0 = state.lent.count.clone()
            wait0, drop0 = state.wait.count.clone(), state.drops.queue.clone()
            state, ev = timed_span(lambda: E._deliver_returns(
                state, io.ret_rows, io.ret_valid, engine.ex))
            evs["deliver"].append(ev)
            state, ev = timed_span(lambda: E._borrow_match(
                state, io.borrow_want, Q.JobRec(vec=io.borrow_job), cfg,
                engine.ex))
            evs["match"].append(ev)
            state = market_step(E, engine, state, t, params, jitter, evs,
                                fired)
            if node_dt != torch.int32:
                state = E._narrow_nodes(state, node_dt)
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
        state, *io, _ = engine._span_prefix(state, rows[k], counts[k], t,
                                            params, member,
                                            emit_returns=True)
        outs.append([x.clone() for x in io])
        state = engine._cross_cluster(state, *io)
        state.t.fill_(t)
    return state, [torch.stack(x) for x in zip(*outs)]


def phase_borrow_kernel_vs_plain(P, E, card, dev):
    """Phases 3g and 3h: the FIFO kernel's emit form against its plain
    version on the borrowing path, and ``run_io`` on the card."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
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
    io_at = CHUNK * 2  # the pass's depth; 3h starts from its state
    picks, peak = pick_ticks(chunks_b[:2], BORROW_SAMPLES)
    w0 = time.perf_counter()
    half = borrow_pass(E, chk, s0_b, chunks_b, picks, until=io_at)
    out["b"] = dict(sampled=half, plain_ms=list(chk.plain_ms),
                    chunks=chunks_b, jobs=jobs_b, s0=s0_b)
    print(f"phase 3g: FIFO emit kernel == plain bitwise (state, want, "
          f"bjob_vec, ret_rows, ret_valid) on {chk.n} ticks of run (b) "
          f"sampled as the kernel reached them over its first {io_at} "
          f"ticks (ticks {sorted(p for p in picks if p < io_at)}, the "
          f"peak {peak}), C={BORROW_C}; fired: {half['fired']}; pass "
          f"{time.perf_counter() - w0:.1f} s [{card}]")

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

    # runs from the start: (a) with the trader on, and config 2's pair
    # tiled to 64 clusters with the trader cut
    for C, n_ticks, trader in ((2, BORROW_A_TICKS, {}),
                               (BORROW_TILED_C, BORROW_TILED_TICKS, None)):
        wcfg = borrow_cfg(P, trader)
        ch, _ = borrow_stream(P, E, C, n_ticks)
        plain_s, kernel_s, fin = whole_run_against_plain(
            E, E.Engine(wcfg, device=dev),
            init_state(wcfg, borrow_specs(P, C), device=dev), ch,
            f"borrowing ({C} clusters)")
        plus = " + market" if trader is not None else ""
        print(f"phase 3g: run, {C} clusters x {n_ticks} ticks, trader "
              f"{'on' if trader is not None else 'cut'}: FIFO emit kernel "
              f"+ delivery + matching{plus} == plain on every leaf (placed "
              f"{int(fin.placed_total.sum())}, borrowed rows "
              f"{int(fin.borrowed.count.sum())}, lent rows "
              f"{int(fin.lent.count.sum())}, contract requests "
              f"{int(fin.trader.next_contract_id.sum()) - C}); run wall "
              f"plain {plain_s:.3f} s, kernel {kernel_s:.3f} s [{card}]")

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
    lead = first_ticks(chunks_m, 30)
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
    """The card's time per tick by phase, by torch.profiler: the run to
    the start of its second chunk, then ``n`` ticks as ``Engine._tick``
    runs them, each phase in a ``record_function`` range — the prefix;
    with borrowing, delivery and matching; with the trader, the snapshot
    and the market round on their cadences. Returns the card's kernel ms
    per tick by phase and in all ("kernels"), per snapshot and per round,
    and the kernels that take most ("top")."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.market import trader as market
    from multi_cluster_simulator_tpu_torch.ops import queues as Q

    cfg = engine.cfg
    state = engine.run_chunks(clone_state(s0), chunks[:1])
    params, host, t = engine._entry(state, None)
    rows = torch.from_numpy(chunks[1].rows[:n]).to(s0.device)
    counts = torch.from_numpy(chunks[1].counts[:n]).to(s0.device)
    n_snap = n_round = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(n):
            t += cfg.tick_ms
            with record_function("prefix"):
                state, *io, _ = fused_tick.fused_prefix(
                    engine, state, rows[k], counts[k], t, params, host,
                    emit_returns=cfg.borrowing, out=host.get("io"))
            if cfg.borrowing:
                with record_function("delivery"):
                    state = E._deliver_returns(state, io[2], io[3],
                                               engine.ex)
                with record_function("matching"):
                    state = E._borrow_match(state, io[0],
                                            Q.JobRec(vec=io[1]), cfg,
                                            engine.ex)
            if engine.snapshot_due(t):
                with record_function("snapshot"):
                    state = E._snapshot(state)
                n_snap += 1
            if engine.round_due(t):
                with record_function("trade"):
                    state = market.trade_round(state, t, cfg, engine.ex,
                                               params, host["jitter"])
                n_round += 1
            state.t.fill_(t)
        torch.cuda.synchronize()

    # On the card's timeline each record_function range also appears as
    # a span over its kernels; the kernels are the card's work, and each
    # counts into the phase whose span it starts in.
    phases = ("prefix", "delivery", "matching", "snapshot", "trade")
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
    out["per_snapshot"] = out["snapshot"] / 1e3 / max(n_snap, 1)
    out["per_round"] = out["trade"] / 1e3 / max(n_round, 1)
    out = {k: (v / 1e3 / n if k in phases else v) for k, v in out.items()}
    out["kernels"] = total / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["top"] = "; ".join(f"{k[:60]} {v / n:.1f} us" for k, v in top)
    return out


def phase_borrow_run(P, E, card, dev, name, C, chunks, n_jobs, sampled):
    """Phases 4i and 4j: a borrowing run at full shape through the entry
    points, counted, then timed runs; ``sampled`` is its tick-by-tick pass
    (per-phase times and what fired). Run (a) is config 2 itself, the
    trader on; run (b) the tiled federation with the trader cut."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    n_ticks = sum(c.rows.shape[0] for c in chunks)
    cfg = borrow_cfg(P, {} if name == "a" else None)
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, borrow_specs(P, C), device=dev)
    state_b = sum(x.numel() * x.element_size()
                  for _, x in leaves_with_keys(s0))
    # where the sampled pass saw only part of the run, the counted run goes
    # through run_io and counts every tick's wants and returns
    io = (dict(want=0, returns=0) if sampled["ticks"] < n_ticks
          else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, first_s, counts = counted_run(engine, s0, chunks,
                                       "fused_prefix_fifo_emit", io)
    peak_b = torch.cuda.max_memory_allocated()
    drops = total_drops(out)
    check_conservation(out)
    if int(out.t) != n_ticks * cfg.tick_ms:
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
    vnodes = int(out.node_active[:, cfg.max_nodes:].sum())
    rounds = n_ticks * cfg.tick_ms // cfg.trader.monitor_period_ms \
        if cfg.trader.enabled else 0
    # the counted run just before is the warm-up
    walls, h2d_s, last = timed_runs(engine, s0, chunks, 0,
                                    BORROW_A_TIMED if name == "a"
                                    else BORROW_B_TIMED)
    d = 0 if io is None else max_abs_diff(last, out)
    if d:
        raise AssertionError(f"run ({name}): run_chunks differs from "
                             f"run_io over the chunks ({d})")
    prof = device_profile(E, engine, s0, chunks, BORROW_PROFILE_TICKS)
    label = "phase 4i" if name == "a" else "phase 4j"
    trader = (f"trader on (greedy, carve {cfg.trader.carve_mode}): "
              f"{rounds} trade rounds, virtual nodes traded {vnodes}, "
              f"contract requests "
              f"{int(out.trader.next_contract_id.sum()) - C}"
              if cfg.trader.enabled else "trader cut")
    print(f"{label}: run ({name}) config 2, {trader}, {C} clusters, "
          f"{n_ticks} ticks: {n_jobs} jobs, arrived {arrived}, placed "
          f"{placed}, borrowed rows {held['borrowed']}, held {held}, drops "
          f"{drops}; job count placed + ready "
          f"+ wait + lent + drops.queue - arrived = {balance} (BorrowedQueue "
          f"overflow drops count a bookkeeping row, not a job), launches "
          f"{counts}, conservation ok; state {state_b} B, peak device memory "
          f"{peak_b} B [{card}]")
    wmin, wmed = print_run(label, f"run ({name})", placed, walls, first_s,
                           n_ticks, chunks, h2d_s, card)
    ms = {k: float(np.mean(v)) for k, v in sampled["ms"].items() if v}
    busy = prof["kernels"] * n_ticks / 1e3
    metric = ("fifo_two_cluster_trader_ticks_per_sec" if name == "a"
              else "borrow_4k ticks/s")
    if cfg.trader.enabled:
        print(f"{label}: market: CUDA-event spans (the card kept busy ahead "
              f"of each) {np.mean(sampled['ms']['trade']) * 1e3:.2f} us per "
              f"round over {len(sampled['ms']['trade'])} rounds, "
              f"{np.mean(sampled['ms']['snapshot']) * 1e3:.2f} us per "
              f"snapshot over {len(sampled['ms']['snapshot'])}; the card's "
              f"own time (torch.profiler over {BORROW_PROFILE_TICKS} ticks "
              f"from tick {CHUNK}) {prof['per_round'] * 1e3:.2f} us per "
              f"round, {prof['per_snapshot'] * 1e3:.2f} us per snapshot "
              f"[{card}]")
    print(f"{label}: {metric} "
          f"{n_ticks / wmin:.1f} (min), {n_ticks / wmed:.1f} "
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
                wall_min_s=wmin, wall_median_s=wmed, n_ticks=n_ticks,
                h2d_s=h2d_s, drops=drops, balance=balance, profile=prof)


# --------------------------------------------------------------------------
# the fault plane: 3k (every faults form == plain), 4k and 4m (churn)
# --------------------------------------------------------------------------

def churn_faults(P, **kw):
    """bench_faults's churn (bench.py:2935-2937) at its full horizon:
    generative, mttf 100 s, mttr 10 s, seed 29, 16 retries."""
    base = dict(enabled=True, mode="generative",
                mttf_ms=FAULTS_HORIZON_MS // 4,
                mttr_ms=FAULTS_HORIZON_MS // 40, seed=29, max_retries=16)
    base.update(kw)
    return P.FaultConfig(**base)


def faults_cfg(P, **kw):
    """bench_faults's config (bench.py:2927-2945), as the port's."""
    base = dict(policy=P.PolicyKind.FIFO, parity=True, n_res=2,
                queue_capacity=128, max_running=128,
                max_arrivals=FAULTS_JOBS, max_ingest_per_tick=16,
                max_nodes=5, max_virtual_nodes=0, faults=churn_faults(P))
    base.update(kw)
    return P.SimConfig(**base)


def faults_stream(E, C, arrivals=False):
    """bench_faults's stream for C clusters (seed 13), its 400-tick
    ragged-K chunks and its tick count (T = 490), and with ``arrivals``
    the stream itself."""
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    arr = uniform_stream(C, FAULTS_JOBS, FAULTS_HORIZON_MS, max_cores=8,
                         max_mem=6_000, max_dur_ms=30_000, seed=13)
    n_ticks = FAULTS_HORIZON_MS // 1_000 + 90
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), 1_000)
    return (chunks, n_ticks, arr) if arrivals else (chunks, n_ticks)


def fault_reads(before, after, t: int):
    """The faults step's further reads per tick, beyond the span's own
    (``tick_bytes`` and the like; ``written_bytes`` counts its writes):
    each node slot's health flag, and its next_fail when up or its
    down_until when down; at each node that fails or repairs, its outage
    count, parked activation, outage start and one trace entry or the
    cluster's key words, and its capacity where it repairs; on each
    cluster where a node fails, the node of each active running slot, the
    whole row of each killed slot and the two queue counts."""
    fs0, fs1 = before.faults, after.faults
    n_res = before.node_free.shape[2]
    up = fs0.health
    fails = up & (fs0.next_fail <= t)
    reps = fs1.n_fails > fs0.n_fails
    events = fails | reps
    failing = fails.any(1)
    node = before.run.node.clamp(0, up.shape[1] - 1).long()
    killed = before.run.active & torch.gather(fails, 1, node)
    node_b = before.node_cap.element_size()
    return (up.numel() + 4 * up.numel() + 13 * events.sum()
            + 8 * events.any(1).sum() + node_b * n_res * reps.sum()
            + value_bytes(before.run, "node")
            * (before.run.active & failing[:, None]).sum()
            + row_bytes(before.run) * killed.sum() + 8 * failing.sum())


def tick_cost_faults(before, after, rows, counts, t: int, trace: bool):
    """The FIFO faults form's least bytes a tick (read, written, ops): the
    FIFO span's ``tick_bytes`` and the faults step's ``fault_reads``."""
    read, written = tick_bytes(before, after, rows, counts, t, trace)
    return read + fault_reads(before, after, t), written, 0


def fault_events(dev, state, t, gen, mode, same_tick):
    """Make failures and repairs due at clock ``t`` in ``state``: about
    one in three healthy node slots fails, every down one repairs; in
    trace mode the failing slots' next repair is ``t`` (a same-tick
    outage) on about ``same_tick`` of them and later on the rest."""
    fs = state.faults
    up = fs.health.clone()
    pick = up & (torch.rand(up.shape, generator=gen, device=dev) < 0.34)
    fs.next_fail.copy_(torch.where(pick, t, fs.next_fail))
    fs.down_until.copy_(torch.where(~up, t, fs.down_until))
    if mode == "trace":
        E_ = fs.repair_t.shape[-1]
        k = fs.n_fails.clamp(0, E_ - 1).long()[..., None]
        now = torch.rand(up.shape, generator=gen, device=dev) < same_tick
        rep = torch.where(now, t, t + 2_000).to(torch.int32)
        fs.repair_t.scatter_(-1, k, torch.where(
            pick, rep, torch.gather(fs.repair_t, -1, k)[..., 0])[..., None])
        fs.fail_t.scatter_(-1, (k + 1).clamp(max=E_ - 1), torch.full_like(
            k, t + 30_000, dtype=torch.int32))


def fault_firings(engine, before, t, seen):
    """What the fault phase does on ``before`` at ``t``, by its plain
    version alone: kills of jobs and of carve placeholders, requeues into
    the LentQueue, requeues dropped by a full queue, jobs past their
    budget, and same-tick outages (a node that fails and repairs at t)."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.faults import apply as fa

    after = fa.fault_phase_local(clone_state(before), t, engine.cfg,
                                 engine.member().to_delay)
    f0, f1 = before.faults, after.faults
    gone = before.run.active & ~after.run.active
    owner = before.run.owner
    seen["kills"] += int((f1.kills - f0.kills).sum())
    seen["placeholders"] += int((gone & (owner == -2)).sum())
    seen["lent"] += int((after.lent.count - before.lent.count).sum())
    seen["queue_full"] += int((after.drops.queue - before.drops.queue).sum())
    seen["failed"] += int((after.drops.failed - before.drops.failed).sum())
    seen["same_tick"] += int(((f1.n_fails > f0.n_fails)
                              & (f1.down_since == t)).sum())


def load_rows(state, rows, counts, dev, gen):
    """Give the heavy ticks' running sets and LentQueues the rows the fault
    phase treats apart: every fifth active running row becomes a carve
    placeholder (owner -2) and every fifth another a peer's job (owner
    the next cluster); every other cluster's LentQueue is filled to
    capacity with the tick's arrival rows as the next cluster's jobs, so
    that requeues into it overflow."""
    C, S = state.run.active.shape
    nxt = ((torch.arange(C, device=dev) + 1) % C).to(torch.int32)[:, None]
    slot = torch.arange(S, device=dev)[None, :]
    owner = state.run.owner
    set_field_(state.run, "owner", torch.where(
        state.run.active & (slot % 5 == 0), -2,
        torch.where(state.run.active & (slot % 5 == 2), nxt, owner)))
    q = state.lent
    cap, K = q.capacity, rows.shape[1]
    full = torch.rand(C, generator=gen, device=dev) < 0.5
    full &= counts.clamp(max=K) > 0
    src = torch.arange(cap, device=dev)[None, :] % counts.clamp(
        1, K)[:, None]
    fill = torch.gather(rows, 1, src[..., None].expand(-1, -1, rows.shape[2]))
    fill[..., 6] = nxt
    live = torch.arange(cap, device=dev)[None, :] < q.count[:, None]
    from multi_cluster_simulator_tpu_torch.ops import queues as Q

    load_queue(q, torch.where(full[:, None, None] & ~live[..., None], fill,
                              Q.rows_of(q)), torch.where(full, cap, q.count))


def faults_heavy(dev, engine, state, rows, counts, t0, n, cost, seen, mode):
    """``n`` heavy ticks for a faults form on ``state`` (its fault leaves
    set up for ``mode``: per-cluster keys, or trace tables; its rows
    loaded by ``load_rows``; with expiry, nine in ten virtual nodes set
    to expire), each with failures and repairs made due by
    ``fault_events``; kernel == plain on every tick (and every emit
    output), each launch timed on a copy with its bytes counted (``cost``
    plus ``fault_reads``). Returns the Checker, the per-launch times and
    the mean bytes."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.faults import schedule as fsched
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    chk = Checker(engine)
    emit = engine.cfg.borrowing
    C = state.arr_ptr.shape[0]
    vstart = engine.cfg.max_nodes
    fs = state.faults
    if mode == "generative":
        fs.key.copy_(fsched.cluster_keys(engine.cfg.faults.seed, C).to(dev))
    gen = torch.Generator(device=dev).manual_seed(6)
    # one untimed launch first, on a copy: a form's first launch on the
    # card can cost several times its work (FFD's faults form's did)
    chk.ft.fused_prefix(engine, clone_state(state), rows[0], counts[0],
                        t0 + engine.cfg.tick_ms, chk.params, chk.host,
                        emit_returns=emit)
    evs, read_b, written_b, t = [], 0, 0, t0
    for k in range(n):
        t += engine.cfg.tick_ms
        load_rows(state, rows[k], counts[k], dev, gen)
        fault_events(dev, state, t, gen, mode, 0.5)
        if fused_tick.expires(engine.cfg):
            slots = state.node_active.clone()
            slots[:, :vstart] = False
            hit = slots & (torch.rand(slots.shape, generator=gen,
                                      device=dev) < 0.9)
            state.node_expire.copy_(torch.where(hit, t, state.node_expire))
            seen["expired"] += int(hit.sum())
        fault_firings(engine, state, t, seen)
        before = clone_state(state)
        timed = clone_state(state)
        evs.append(timed_launch(chk.ft, engine, timed, rows[k], counts[k], t,
                                chk.params, chk.host, emit=emit))
        r, w = cost(before, timed, rows[k], counts[k], t)
        read_b = read_b + r + fault_reads(before, timed, t)
        written_b = written_b + w
        out = chk.compare(state, rows[k], counts[k], t, emit=emit)
        state = out[0] if emit else out
        if max_abs_diff(timed, state):
            raise AssertionError("a timed launch differs from the compared "
                                 "one")
        state.t.fill_(t)
    torch.cuda.synchronize()
    return chk, [a.elapsed_time(b) for a, b in evs], int(read_b) / n, \
        int(written_b) / n


def churn_pass(chk, engine, shadow, s0, chunks, picks):
    """Drive the churn run tick by tick through the faults form, a CUDA
    event pair around every launch and the tick's bytes counted; before
    each, time the same kernel without the faults step (``shadow``, an
    engine of the faults-off config) on a copy of the state; at the
    global ticks in ``picks`` compare kernel and plain. Returns the two
    kernels' per-launch times, which ticks were quiet (no node failed or
    repaired), the mean bytes, the nodes failed and repaired, and the
    final state."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    params, host = chk.params, chk.host
    s_host = fused_tick.host_params(shadow, shadow._default_params)
    dev = s0.device
    state = clone_state(s0)
    evs, sevs, read_b, written_b, t, k_glob = [], [], 0, 0, 0, 0
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fired = {"failed": zero, "repaired": zero}
    quiet = []
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(dev)
        counts_all = torch.from_numpy(ch.counts).to(dev)
        for k in range(ch.rows.shape[0]):
            t += engine.cfg.tick_ms
            rows, counts = rows_all[k], counts_all[k]
            if k_glob in picks:
                chk.compare(state, rows, counts, t)
            sevs.append(timed_launch(fused_tick, shadow, clone_state(state),
                                     rows, counts, t,
                                     shadow._default_params, s_host))
            before = clone_state(state)
            evs.append(timed_launch(fused_tick, engine, state, rows, counts,
                                    t, params, host))
            r, w, _ = tick_cost_faults(before, state, rows, counts, t,
                                       engine.cfg.record_trace)
            read_b, written_b = read_b + r, written_b + w
            failed = (before.faults.health & ~state.faults.health).sum()
            repaired = (state.faults.n_fails - before.faults.n_fails).sum()
            fired["failed"] = fired["failed"] + failed
            fired["repaired"] = fired["repaired"] + repaired
            quiet.append((failed + repaired) == 0)
            state.t.fill_(t)
            k_glob += 1
    torch.cuda.synchronize()
    return dict(kernel_ms=[a.elapsed_time(b) for a, b in evs],
                shadow_ms=[a.elapsed_time(b) for a, b in sevs],
                quiet=torch.stack(quiet).cpu().numpy(),
                read=int(read_b) / k_glob, written=int(written_b) / k_glob,
                fired={k: int(v) for k, v in fired.items()}, state=state,
                ticks=k_glob)


def vnode_world(P, E, dev, borrowing):
    """tests/test_faults.py:299 (a failed node hosting a traded virtual
    node) tiled to ``FAULT_VNODE_C`` clusters, with the greedy market and
    expiry on: each cluster one 2-core physical node and two virtual
    slots, the first attached at start as the reference's AddVirtualNode
    does (8 cores, 4,000 MB; its contract ends at 60 s, at 15 s on the
    odd clusters), one 4-core job that fits only there, and a trace
    schedule that fails that slot from 5 s to 9 s. Returns the config,
    the initial state and the stream's chunk."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        Arrivals, init_state,
    )

    C, T = FAULT_VNODE_C, FAULT_VNODE_TICKS
    fc = churn_faults(P, mode="trace", max_retries=3, max_events=4)
    cfg = P.SimConfig(policy=P.PolicyKind.FIFO, parity=True, n_res=3,
                      queue_capacity=64, max_running=64, max_arrivals=40,
                      max_ingest_per_tick=16, max_nodes=1,
                      max_virtual_nodes=2, borrowing=borrowing, faults=fc,
                      trader=trader_cfg(P, {"expire_virtual_nodes": True}))
    vslot = cfg.max_nodes
    specs = [P.uniform_cluster(c + 1, 1, cores=2, memory=500)
             for c in range(C)]
    s0 = init_state(cfg, specs, fault_events=[(c, vslot, 5_000, 9_000)
                                              for c in range(C)],
                    device=dev)
    s0.node_cap[:, vslot] = torch.tensor([8, 4_000, 0], dtype=torch.int32,
                                         device=dev)
    s0.node_free[:, vslot] = s0.node_cap[:, vslot]
    s0.node_active[:, vslot] = True
    s0.node_expire[:, vslot] = torch.where(
        torch.arange(C, device=dev) % 2 == 0, 60_000, 15_000).to(
            torch.int32)
    one = np.ones((C, 1), np.int32)
    arr = Arrivals(t=500 * one, id=np.arange(C, dtype=np.int32)[:, None],
                   cores=4 * one, mem=2_000 * one, gpu=0 * one,
                   dur=50_000 * one, n=one[:, 0])
    return cfg, specs, s0, E.pack_arrivals_chunks(arr, [T], cfg.tick_ms)


def phase_faults_kernel_vs_plain(P, E, card, dev, market, state_a, state_b):
    """Phase 3k: every faults form against its plain version.
    (a) heavy ticks on states with full running sets — the Level0 and
    FIFO expire forms on market run (a)'s final state (its carve
    placeholders, its virtual nodes), the FIFO forms on borrowing run
    (b)'s (its foreign rows, its full LentQueues) — in generative mode
    (16 retries) and trace mode (0 retries, same-tick outages);
    (b) runs with churn from the start, their launches counted through
    ``Engine.run_chunks``: the first 30 ticks of DELAY, FFD and gavel at
    the quick market shape, without and with the sinkhorn trader and
    expiry, and of FIFO with borrowing at 64 clusters; config
    2 with the greedy trader and expiry, with and without borrowing, its
    virtual nodes failing on a trace schedule."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies import kernels as K
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )

    out = {"heavy": {}, "launches": {}}
    seen = dict(kills=0, placeholders=0, lent=0, queue_full=0, failed=0,
                same_tick=0, expired=0)
    ch = market["chunks"][0]
    rows = torch.from_numpy(ch.rows[:FAULT_HEAVY_TICKS]).to(dev)
    counts = torch.from_numpy(ch.counts[:FAULT_HEAVY_TICKS]).to(dev)
    t_a = market["n_ticks"] * 1_000
    b_state, b_t = state_b
    b_ch = borrow_stream(P, E, BORROW_C)[0][2]
    b_rows = torch.from_numpy(b_ch.rows[:FAULT_HEAVY_TICKS]).to(dev)
    b_counts = torch.from_numpy(b_ch.counts[:FAULT_HEAVY_TICKS]).to(dev)
    variants = [(pol, "market", {}) for pol in
                ("delay", "ffd", "gavel", "tesserae", "rl")]
    variants += [(pol, "market", {"trader": EXPIRE}) for pol in
                 ("delay", "ffd", "gavel", "fifo")]
    variants += [("fifo", "market", {"trader": EXPIRE, "borrowing": True}),
                 ("fifo", "borrow", {"borrowing": False}),
                 ("fifo", "borrow", {})]
    for pol, base, extra in variants:
        for mode in ("generative", "trace"):
            fc = churn_faults(P, mode=mode, max_retries=(
                16 if mode == "generative" else 0))
            if base == "market":
                vcfg = market_cfg(P, faults=fc, **extra)
                s, r_, c_, t0 = state_a, rows, counts, t_a
            else:
                vcfg = borrow_cfg(P, faults=fc, **extra)
                s, r_, c_, t0 = b_state, b_rows, b_counts, b_t
            veng = E.Engine(vcfg, device=dev, policies=PolicySet((pol,)))
            vQC = K._sweep_len(vcfg)
            kind = pol if pol in ("ffd", "delay", "fifo") else "scored"

            def cost(b, a, r, c, t, kind=kind, pol=pol, vQC=vQC, vcfg=vcfg,
                     veng=veng):
                if kind == "ffd":
                    rd, wr, _ = tick_cost_ffd(b, a, r, c, t, False, vQC)
                elif kind == "delay":
                    rd, wr, _ = tick_cost_delay(b, a, r, c, t, False, vQC)
                elif kind == "scored":
                    rd, wr, _ = tick_cost_scored(b, a, r, c, t, False, vQC,
                                                 pol == "tesserae")
                elif vcfg.borrowing:
                    rd, wr = tick_cost_borrow(b, a, r, c, t, False,
                                              veng.n_msgs())
                else:
                    rd, wr = tick_bytes(b, a, r, c, t, False)
                if fused_tick.expires(vcfg):
                    rd = rd + expire_reads(b)
                return rd, wr

            k0 = dict(seen)
            vchk, ms, rd, wr = faults_heavy(
                dev, veng, clone_state(s), r_, c_, t0, FAULT_HEAVY_TICKS,
                cost, seen, mode)
            kname = vchk.host["emit_kernel" if vcfg.borrowing
                              else "kernel"].name
            out["heavy"].setdefault(kname, []).append(dict(
                ms=ms, read=rd, written=wr, worst=vchk.worst,
                plain_ms=vchk.plain_ms, mode=mode, policy=pol))
            print(f"phase 3k: {kname} ({pol}, {mode}) == plain bitwise on "
                  f"{vchk.n} heavy ticks at C={s.arr_ptr.shape[0]}: "
                  f"{ {k: seen[k] - k0[k] for k in seen} }, "
                  f"{np.mean(ms) * 1e3:.2f} us/launch [{card}]")
    print(f"phase 3k: the heavy ticks fired {seen} [{card}]")
    need = ("kills", "placeholders", "lent", "queue_full", "failed",
            "same_tick", "expired")
    if not all(seen[k] for k in need):
        raise AssertionError(f"the heavy ticks missed a branch: {seen}")

    # (b) whole runs with churn, their launches counted
    qc_, qj = MARKET_QUICK
    ch_q = first_ticks(market_stream(E, qc_, qj, quick=True)[0],
                       FAULT_RUN_TICKS)
    quick_fc = churn_faults(P, mttf_ms=60_000, mttr_ms=8_000)
    runs = [(f"quick {pol}{' + market, expiry' if tr else ''}",
             market_cfg(P, quick=True, jobs=qj, faults=quick_fc,
                        trader=EXPIRE if tr else None),
             pol, market_specs(P, qc_), ch_q, None)
            for tr in (False, True) for pol in ("delay", "ffd", "gavel")]
    tiled, _ = borrow_stream(P, E, BORROW_TILED_C, FAULT_RUN_TICKS)
    runs.append((f"FIFO borrowing ({BORROW_TILED_C} clusters)",
                 borrow_cfg(P, faults=quick_fc), "fifo",
                 borrow_specs(P, BORROW_TILED_C), tiled, None))
    for borrowing in (True, False):
        rcfg, specs, s0, chunks = vnode_world(P, E, dev, borrowing)
        runs.append((f"tests/test_faults.py:299 tiled, greedy market and "
                     f"expiry{'' if borrowing else ', no borrowing'}", rcfg,
                     "fifo", specs, chunks, s0))
    for name, rcfg, pol, specs, chunks, s0 in runs:
        reng = E.Engine(rcfg, device=dev, policies=PolicySet((pol,)))
        counts_run = {}
        if s0 is None:
            s0 = init_state(rcfg, specs, device=dev)
        plain_s, kernel_s, fin = whole_run_against_plain(
            E, reng, s0, chunks, name, counts=counts_run)
        n_ticks = sum(c.rows.shape[0] for c in chunks)
        host = fused_tick.host_params(reng, reng._default_params)
        kname = host["emit_kernel" if rcfg.borrowing else "kernel"].name
        want = {k: (n_ticks if k == kname else 0) for k in counts_run}
        if counts_run != want:
            raise AssertionError(f"{name}: launches {counts_run}")
        check_conservation(fin)
        fs = fin.faults
        kills = int(fs.kills.sum())
        vdown = int(fs.n_fails[:, rcfg.max_nodes:].sum())
        if not kills:
            raise AssertionError(f"{name}: no job was killed")
        if rcfg.max_nodes == 1:  # test 299's own asserts, every cluster
            vs = rcfg.max_nodes
            on = (fin.run.data[..., 1] == vs) & fin.run.active
            even = torch.arange(len(specs), device=dev) % 2 == 0
            if not (kills == len(specs) == vdown and bool(fs.health.all())
                    and bool((fin.node_active[:, vs] == even).all())
                    and bool(on.any(1).all())):
                raise AssertionError(f"{name}: {kills} kills, {vdown} "
                                     f"outages of the virtual slot")
        out["launches"][kname] = n_ticks
        print(f"phase 3k: whole run, {name} ({len(specs)} clusters x "
              f"{n_ticks} ticks) with churn: {kname} + the phases after it "
              f"== plain on every leaf (placed {int(fin.placed_total.sum())}"
              f", kills {kills}, requeues {int(fs.requeues.sum())}, outages "
              f"{int(fs.n_fails.sum())} ({vdown} on virtual slots), down_ms "
              f"{int(fs.down_ms.sum())}, virtual nodes at the end "
              f"{int(fin.node_active[:, rcfg.max_nodes:].sum())}, drops "
              f"{total_drops(fin)}), conservation ok, launches {kname} x "
              f"{n_ticks}; run wall plain {plain_s:.3f} s, kernel "
              f"{kernel_s:.3f} s [{card}]")
    out["worst"] = max(h["worst"] for v in out["heavy"].values() for h in v)
    return out


def phase_faults_run(P, E, card, dev, C, label):
    """Phases 4k and 4m: bench_faults's churn config at ``C`` clusters
    through the entry points, with the bench's gates (bench.py:2952-2984):
    an enabled trace plane with an empty schedule leaves every non-fault
    leaf as the faults-off run does; the churn run kills and requeues,
    drops nothing and conserves; 490 launches of the faults form. Then a
    pass tick by tick (kernel == plain at sampled ticks, every launch
    timed beside the same kernel without the faults step), the timed
    runs, and at 4,096 clusters a torch.profiler window."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    cfg = faults_cfg(P)
    off_cfg = faults_cfg(P, faults=P.FaultConfig())
    empty_cfg = faults_cfg(P, faults=churn_faults(P, mode="trace"))
    specs = [P.uniform_cluster(c + 1, 5) for c in range(C)]
    chunks, n_ticks = faults_stream(E, C)
    n_jobs = C * FAULTS_JOBS
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, specs, device=dev)
    out, first_s, counts = counted_run(engine, s0, chunks,
                                       "fused_prefix_fifo_faults")
    # gate 1: the empty schedule is a no-op on every shared leaf
    off, _, _ = counted_run(E.Engine(off_cfg, device=dev),
                            init_state(off_cfg, specs, device=dev), chunks,
                            "fused_prefix_fifo")
    empty, _, _ = counted_run(E.Engine(empty_cfg, device=dev),
                              init_state(empty_cfg, specs, fault_events=[],
                                         device=dev), chunks,
                              "fused_prefix_fifo_faults")
    for (k, x), (_, y) in zip(leaves_with_keys(off), leaves_with_keys(empty)):
        if not k.startswith(".faults") and not torch.equal(x, y):
            raise AssertionError(f"{label}: the empty trace schedule changed "
                                 f"{k}")
    # gates 2-3: the plane engages, nothing drops, conservation
    fs = out.faults
    kills, requeues = int(fs.kills.sum()), int(fs.requeues.sum())
    down_ms = int(fs.down_ms.sum())
    drops = total_drops(out)
    if not (kills > 0 and requeues > 0):
        raise AssertionError(f"{label}: {kills} kills, {requeues} requeues")
    if any(drops.values()):
        raise AssertionError(f"{label}: drops moved under churn: {drops}")
    check_conservation(out)
    if int(out.t) != n_ticks * cfg.tick_ms:
        raise AssertionError(f"{label}: clock {int(out.t)}")
    placed = int(out.placed_total.sum())
    arrived = int(out.arr_ptr.sum())
    # the sampled pass: kernel == plain, each launch timed beside the same
    # kernel without the faults step
    chk = Checker(engine)
    picks, peak = pick_ticks(chunks, FAULTS_SAMPLES)
    sp = churn_pass(chk, engine, E.Engine(off_cfg, device=dev), s0, chunks,
                    picks)
    if max_abs_diff(sp["state"], out):
        raise AssertionError(f"{label}: the sampled pass differs from the "
                             f"counted run")
    walls, h2d_s, _ = timed_runs(engine, s0, chunks, WARMUPS, FAULTS_TIMED)
    wmin, wmed = min(walls), float(np.median(walls))
    width = ("bench_faults's own" if C == FAULTS_C else
             "the headline's width: the port's, not the bench's")
    print(f"{label}: bench_faults churn, {C} clusters x {FAULTS_JOBS} jobs "
          f"({width}), {n_ticks} ticks, mttf {cfg.faults.mttf_ms} ms, mttr "
          f"{cfg.faults.mttr_ms} ms, max_retries {cfg.faults.max_retries}: "
          f"arrived {arrived} of {n_jobs}, placed {placed} (re-placements "
          f"of requeued jobs included, as the bench counts), kills {kills}, "
          f"requeues {requeues}, down_ms {down_ms}, drops {drops}, launches "
          f"{counts}, conservation ok, the empty trace schedule a no-op on "
          f"every shared leaf [{card}]")
    print(f"{label}: kernel == plain bitwise on {chk.n} ticks sampled as the "
          f"kernel reached them (ticks {sorted(picks)}, the peak {peak}); "
          f"nodes failed {sp['fired']['failed']}, repaired "
          f"{sp['fired']['repaired']} over the pass [{card}]")
    print(f"{label}: fault_plane_churn_jobs_per_sec {placed / wmin:.1f} "
          f"(min of {len(walls)}), {placed / wmed:.1f} (median); wall min "
          f"{wmin:.4f} s, median {wmed:.4f} s, first run {first_s:.4f} s; "
          f"walls {[round(w, 4) for w in walls]}; us/tick "
          f"{1e6 * wmin / n_ticks:.1f} [{card}]")
    kms = float(np.mean(sp["kernel_ms"]))
    sms = float(np.mean(sp["shadow_ms"]))
    b_ms, b_by = bound(sp["read"], sp["written"])
    print(f"{label}: kernel fused_prefix_fifo_faults {kms * 1e3:.2f} "
          f"us/launch mean over {len(sp['kernel_ms'])} launches (CUDA "
          f"events), the same kernel without the faults step "
          f"{sms * 1e3:.2f} us on the same states; plain "
          f"{np.mean(chk.plain_ms):.3f} ms; bound {b_ms * 1e3:.4f} us by "
          f"{b_by} ({sp['read'] + sp['written']:.1f} B per launch, mean of "
          f"{sp['read']:.1f} read and {sp['written']:.1f} written) [{card}]")
    q = sp["quiet"]
    for name, sel in (("quiet", q), ("busy", ~q)):
        if sel.any():
            print(f"{label}: on the {int(sel.sum())} {name} ticks (a node "
                  f"failed or repaired on {'none' if name == 'quiet' else 'each'}"
                  f"): the faults form "
                  f"{np.mean(np.asarray(sp['kernel_ms'])[sel]) * 1e3:.2f} "
                  f"us/launch, without the step "
                  f"{np.mean(np.asarray(sp['shadow_ms'])[sel]) * 1e3:.2f} us "
                  f"[{card}]")
    run = dict(launches=counts["fused_prefix_fifo_faults"], placed=placed,
               wall_min_s=wmin, wall_median_s=wmed, n_ticks=n_ticks,
               h2d_s=h2d_s, kills=kills, requeues=requeues, down_ms=down_ms,
               sampled=sp, plain_ms=chk.plain_ms, worst=chk.worst,
               final=out if C == FAULTS_C else None)
    breakdown(f"churn ({C})", run, sp["kernel_ms"], card)
    if C == FAULTS_WIDE_C:
        prof = device_profile(E, engine, s0, chunks, FAULTS_PROFILE_TICKS)
        busy = prof["kernels"] * n_ticks / 1e3
        print(f"{label}: the card's own time per tick (torch.profiler over "
              f"{FAULTS_PROFILE_TICKS} ticks from tick {CHUNK}): prefix "
              f"{prof['prefix'] * 1e3:.2f} us, all kernels "
              f"{prof['kernels'] * 1e3:.2f} us; card busy "
              f"{100 * busy / wmin:.1f}% of the min wall, idle "
              f"{100 - 100 * busy / wmin:.1f}%; kernels by name: "
              f"{prof['top']} [{card}]")
        run["profile"] = prof
    return run


# --------------------------------------------------------------------------
# the metrics plane: 4n (the headline), 4o (churn at 4,096), 4p (BASELINE
# config 1, the windowed ingest), 4q (the Level0 tap forms)
# --------------------------------------------------------------------------

def changed_bytes(a, b):
    """Bytes of every element that differs between two trees of tensors
    (0-d int64 tensor)."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    return sum((x != y).sum() * x.element_size() for (_, x), (_, y)
               in zip(leaves_with_keys(a), leaves_with_keys(b)))


def tap_cost(shared: int, mb0, cur0, mb1, cur1, n_ovf: int = 0):
    """The tap's bytes beyond its span's, as (read, written): per cluster
    it reads the buffer's eleven per-cluster leaves, the cursor's nine and
    the twelve state counters it differences less the ``shared`` ones its
    span's cost already reads, and the compact layout's ``n_ovf``
    overflow counters; it writes every buffer and cursor element that
    changed (the histogram and the ring slot included) and the tick's
    placements and depths."""
    C = cur0.placed.shape[0]
    return (C * 4 * (11 + 9 + 12 - shared + n_ovf),
            8 * C + changed_bytes(mb0, mb1) + changed_bytes(cur0, cur1))


def n_ovf_tables(state) -> int:
    """How many of a state's tables carry an overflow counter (the compact
    layout's seven; none on the wide layout)."""
    return sum(hasattr(getattr(state, n), "ovf") for n in
               ("l0", "l1", "ready", "wait", "lent", "borrowed", "run"))


def cost_of(kind: str, engine, QC: int = 0):
    """The span's cost function for ``tap_pass`` and ``Checker.compare``:
    (before, after, rows, counts, t) -> (read, written, ops), and how many
    of the tap's counters it reads (``tap_cost``'s ``shared``). ``kind``:
    fifo, fifo_emit, fifo_faults, ffd, delay, gavel or tesserae."""
    cfg = engine.cfg
    trace = cfg.record_trace

    def fn(b, a, r, c, t):
        if kind == "fifo":
            return (*tick_bytes(b, a, r, c, t, trace), 0)
        if kind == "fifo_emit":
            return (*tick_cost_borrow(b, a, r, c, t, trace,
                                      engine.n_msgs()), 0)
        if kind == "fifo_faults":
            return tick_cost_faults(b, a, r, c, t, trace)
        if kind == "ffd":
            rd, wr, op = tick_cost_ffd(b, a, r, c, t, trace, QC)
        elif kind == "delay":
            rd, wr, op = tick_cost_delay(b, a, r, c, t, trace, QC)
        else:
            rd, wr, op = tick_cost_scored(b, a, r, c, t, trace, QC,
                                          kind == "tesserae")
        if cfg.faults.enabled:
            rd = rd + fault_reads(b, a, t)
        return rd, wr, op
    return fn, (5 if kind.startswith("fifo") or kind == "delay" else 4)


def window_feed(rows, counts, before, after):
    """A windowed tick's arrival slice for the cost functions: the stream's
    row layout, with the rows the tick took (the cursor's advance) as its
    count; plus the due checks' reads (each taken row's enq_t and the
    first not due, and the stream's count), per cluster."""
    taken = after.arr_ptr - before.arr_ptr
    return rows, taken, 4 * (taken.sum() + 2 * taken.shape[0])


def tap_pass(chk, engine, s0, feeds, picks, cost, shared, emit=False,
             windowed=False, both=False, l1_cap=None):
    """Drive a run tick by tick through the tap form with the run's own
    buffer and cursor, a CUDA event pair around every launch and the
    tick's bytes counted (the span's ``cost`` plus ``tap_cost``); at the
    global ticks in ``picks`` compare kernel and plain on copies of the
    state, buffer and cursor the run reached. ``feeds`` yields each tick's
    (rows, counts). Before each launch the untapped form runs on a copy
    of the state, timed the same way; with ``both`` it is compared at the
    picks too. Returns both forms' per-launch times, the mean bytes and
    operations (``span_read``, ``span_written``: the untapped form's), the
    final state and buffer; with ``l1_cap`` (DELAY's sweep length) also the
    Level1 rows the sweep took a tick, min(|L1|, l1_cap): their max and
    their mean per cluster-tick."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, empty_io,
    )
    from multi_cluster_simulator_tpu_torch.obs import device as D

    params, host = chk.params, chk.host
    state = clone_state(s0)
    mb, cur = D.metrics_init(state), D.cursor_of(state)
    out = (empty_io((state.arr_ptr.shape[0],), engine.n_msgs(),
                    state.device) if emit else None)
    evs, sevs, read_b, written_b, ops = [], [], 0, 0, 0
    span_r = span_w = 0
    n_ovf = n_ovf_tables(state)
    swept_max = torch.zeros((), dtype=torch.int32, device=state.device)
    swept_sum = torch.zeros((), dtype=torch.int64, device=state.device)
    t, k_glob = int(s0.t), 0
    for rows, counts in feeds:
        t += engine.cfg.tick_ms
        if l1_cap is not None:
            swept = state.l1.count.clamp(max=l1_cap)
            swept_max = torch.maximum(swept_max, swept.max())
            swept_sum = swept_sum + swept.sum()
        if k_glob in picks:
            chk.compare(state, rows, counts, t, emit=emit, obs=(mb, cur),
                        windowed=windowed)
            if both:
                chk.compare(state, rows, counts, t, emit=emit,
                            windowed=windowed)
        before = (clone_state(state), chk.clone(mb), chk.clone(cur))
        sevs.append(timed_launch(chk.ft, engine, clone_state(state), rows,
                                 counts, t, params, host, emit=emit,
                                 windowed=windowed))
        evs.append(timed_launch(chk.ft, engine, state, rows, counts, t,
                                params, host, emit=emit, out=out,
                                obs=(mb, cur), windowed=windowed))
        extra = 0
        if windowed:
            rows_c, counts_c, extra = window_feed(rows, counts, before[0],
                                                  state)
        else:
            rows_c, counts_c = rows, counts
        r, w, o = cost(before[0], state, rows_c, counts_c, t)
        tr, tw = tap_cost(shared, *before[1:], mb, cur, n_ovf)
        read_b, written_b = read_b + r + tr + extra, written_b + w + tw
        span_r, span_w = span_r + r + extra, span_w + w
        ops = ops + o
        state.t.fill_(t)
        k_glob += 1
    torch.cuda.synchronize()
    return dict(kernel_ms=[a.elapsed_time(b) for a, b in evs],
                untapped_ms=[a.elapsed_time(b) for a, b in sevs],
                read=int(read_b) / k_glob, written=int(written_b) / k_glob,
                span_read=int(span_r) / k_glob,
                span_written=int(span_w) / k_glob,
                ops=int(ops) / k_glob, state=state, mbuf=mb, ticks=k_glob,
                l1_swept_max=int(swept_max),
                l1_swept_mean=int(swept_sum) / (k_glob
                                                * state.l1.count.numel()))


def chunk_feeds(chunks, dev, n=None):
    """Each tick's (rows, counts) of a chunked stream, on the card, the
    first ``n`` ticks only where given."""
    k = 0
    for ch in chunks:
        rows_all = torch.from_numpy(ch.rows).to(dev)
        counts_all = torch.from_numpy(ch.counts).to(dev)
        for i in range(ch.rows.shape[0]):
            if n is not None and k >= n:
                return
            yield rows_all[i], counts_all[i]
            k += 1


def check_launches(counts, kernel, n_ticks, what):
    want = {k: (n_ticks if k == kernel else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: kernel launches {counts}, want "
                             f"{want}")


def counted_plane_run(engine, s0, chunks, kernel):
    """A main path's counted run with the metrics plane: every launch
    count set to 0 just before ``engine.run_chunks`` with a fresh buffer,
    read just after; ``kernel`` (the tap form) must have launched once a
    tick and no other kernel. Returns the state, the buffer, the wall and
    the counts."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D

    state = clone_state(s0)
    mb = D.metrics_init(state)
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    w0 = time.perf_counter()
    out, mb = engine.run_chunks(state, chunks, None, mb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    counts = fused_tick.launch_counts()
    check_launches(counts, kernel, sum(ch.rows.shape[0] for ch in chunks),
                   kernel)
    return out, mb, wall, counts


def plane_gates(out, mb, n_ticks, tick_ms, what):
    """The harvest ties back to the state: placed and arrived are the
    counters' totals, the histogram holds every (tick, cluster), the ring's
    last clock is the run's, the fault counters are the state's."""
    from multi_cluster_simulator_tpu_torch.obs import device as D

    h = D.harvest(mb)
    C = out.arr_ptr.shape[0]
    want = dict(ticks=n_ticks, placed=int(out.placed_total.sum()),
                arrived=int(out.arr_ptr.sum()), hist=n_ticks * C,
                last_t=n_ticks * tick_ms,
                kills=int(out.faults.kills.sum()),
                requeues=int(out.faults.requeues.sum()))
    got = dict(ticks=h["ticks"], placed=h["placed"], arrived=h["arrived"],
               hist=sum(h["depth_hist_log2"]), last_t=h["ring"]["t_ms"][-1],
               kills=h["fault_kills"], requeues=h["fault_requeues"])
    if got != want:
        raise AssertionError(f"{what}: the harvest {got} does not tie back "
                             f"to the state {want}")
    return h


def whole_plane_run_against_plain(E, engine, s0, chunks, what):
    """``whole_run_against_plain`` with the metrics plane: the kernel's tap
    form through ``engine.run_chunks`` with a buffer, the plain prefix and
    ``tap_tick`` tick by tick; every state, buffer and cursor leaf must be
    equal. Returns the two walls, the state, the buffer and the counts."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D

    params = engine._default_params
    member = engine.member(params)
    ref = clone_state(s0)
    mb_ref, cur_ref = D.metrics_init(ref), D.cursor_of(ref)
    t = 0
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for rows, counts in chunk_feeds(chunks, s0.device):
        t += engine.cfg.tick_ms
        ref, *_, tap = fused_tick.fused_prefix_reference(
            engine, ref, rows, counts, t, params, member,
            obs=(D.tap_pc(mb_ref), cur_ref))
        pc, cur_ref, placed_d, depth = tap
        mb_ref = D.tap_tick_global(mb_ref.replace(**pc), placed_d, depth, t,
                                   engine.cfg.tick_ms)
        ref.t.fill_(t)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - w0
    kernel = fused_tick.host_params(engine, params)["tap_kernel"].name
    out, mb, kernel_s, counts = counted_plane_run(engine, s0, chunks, kernel)
    d = max(max_abs_diff(ref, out), max_abs_diff(mb_ref, mb))
    if d:
        raise AssertionError(f"whole {what} run with the metrics plane: "
                             f"kernel differs from plain (max |diff| {d})")
    return plain_s, kernel_s, out, mb, counts


def plane_walls(engine, s0, chunks, pairs):
    """Interleaved walls of whole runs with the plane off and on (off
    first in each pair), as bench.py's ``--obs ab`` times them
    (bench.py:629-660); the counted runs before are the warm-ups."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.obs import device as D

    off, on = [], []
    for _ in range(pairs):
        for walls, plane in ((off, False), (on, True)):
            state = clone_state(s0)
            mb = D.metrics_init(state) if plane else None
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            engine.run_chunks(state, chunks, None, mb)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - w0)
    return off, on


def record_of(name, launches, worst, ms, plain, read, written, ops=0.0):
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    return dict(kernel=fused_tick.KERNELS[name], launches=launches,
                worst=worst, ms=ms, plain=plain,
                bound=bound(read, written, ops))


def tap_records(chk, name, launches, cost_lists):
    """A record of a tap form timed at its comparisons (``Checker``'s
    ``tap_ms``) with the mean bytes of those ticks."""
    rd, wr, op = (float(np.mean(x)) for x in zip(*cost_lists))
    return record_of(name, launches, chk.worst, float(np.mean(chk.tap_ms)),
                     chk.plain_ms, rd, wr, op)


def phase_plane_headline(P, E, card, dev, check, head):
    """Phase 4n: the headline with the metrics plane on: (a) the whole run
    tick by tick through the tap form, every launch timed, kernel == plain
    on 12 sampled ticks; (b) the first 400 ticks at 256 clusters, the trace
    on, run == plain with the plane; (c) the counted run with the plane,
    its state bitwise the plane-off run's, its harvest tied back; (d)
    jobs/s with the plane off and on, 3 interleaved pairs, the overhead
    printed against bench.py's 3% bound; (e) the emit form's tap (a
    ``run_io`` tick) over the first 400 ticks."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D
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
    chk = Checker(engine)
    picks, peak = pick_ticks(chunks, PLANE_SAMPLES)
    cost, shared = cost_of("fifo", engine)
    sp = tap_pass(chk, engine, s0, chunk_feeds(chunks, dev), picks, cost,
                  shared)
    kms, ums = np.mean(sp["kernel_ms"]), np.mean(sp["untapped_ms"])
    print(f"phase 4n: fused_prefix_fifo_tap == plain bitwise on {chk.n} "
          f"headline ticks sampled as the kernel reached them (ticks "
          f"{sorted(picks)}, the peak {peak}), state, buffer, cursor, "
          f"placements and depths; {kms * 1e3:.2f} us/launch mean over "
          f"{len(sp['kernel_ms'])} launches, the untapped form "
          f"{ums * 1e3:.2f} on copies of the same states, launched just "
          f"before (3a's pass: {np.mean(check['kernel_ms']) * 1e3:.2f}) "
          f"[{card}]")

    # (b) the 256-cluster run with the trace on
    cfg_t = headline_cfg(P, record_trace=True, max_trace_events=512)
    eng_t = E.Engine(cfg_t, device=dev)
    specs_t = [P.uniform_cluster(c + 1, 5) for c in range(RUN_C)]
    arr_t = uniform_stream(RUN_C, JOBS, HORIZON_MS, max_cores=8,
                           max_mem=6_000, max_dur_ms=60_000, seed=9)
    ch_t = first_ticks(E.pack_arrivals_chunks(arr_t, chunk_sizes(n_ticks),
                                              cfg.tick_ms))
    plain_s, kernel_s, out_t, mb_t, _ = whole_plane_run_against_plain(
        E, eng_t, init_state(cfg_t, specs_t, device=dev), ch_t, "FIFO")
    print(f"phase 4n: {RUN_C}-cluster headline run, its first "
          f"{sum(c.rows.shape[0] for c in ch_t)} "
          f"ticks, the trace on: the tap form == plain on every state, "
          f"buffer and cursor leaf ({D.harvest(mb_t)['placed']} placements "
          f"harvested); run wall plain {plain_s:.3f} s, kernel "
          f"{kernel_s:.3f} s [{card}]")

    # (c) the counted run, against the plane-off run
    off, _, _ = counted_run(engine, s0, chunks, "fused_prefix_fifo")
    on, mb, first_s, counts = counted_plane_run(engine, s0, chunks,
                                                "fused_prefix_fifo_tap")
    d = max(max_abs_diff(off, on), max_abs_diff(sp["state"], on),
            max_abs_diff(sp["mbuf"], mb))
    if d:
        raise AssertionError(f"the headline with the plane differs from "
                             f"the plane-off run or its pass ({d})")
    h = plane_gates(on, mb, n_ticks, cfg.tick_ms, "phase 4n")
    print(f"phase 4n: headline with the plane on, {n_ticks} ticks: every "
          f"state leaf bitwise as with it off; harvest placed {h['placed']} "
          f"= sum of placed_total, arrived {h['arrived']} = sum of arr_ptr, "
          f"histogram {h['depth_hist_log2']} = ticks x clusters, ring last "
          f"t_ms {h['ring']['t_ms'][-1]}, queue depth max "
          f"{h['queue_depth_max']}, mean {h['queue_depth_mean']}; launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]")

    # (d) on and off interleaved
    w_off, w_on = plane_walls(engine, s0, chunks, PLANE_TIMED)
    placed = head["placed"]
    over = min(w_on) / min(w_off) - 1
    print(f"phase 4n: headline jobs/s with the plane off "
          f"{placed / min(w_off):.1f} (min of {len(w_off)}), "
          f"{placed / np.median(w_off):.1f} (median); on "
          f"{placed / min(w_on):.1f}, {placed / np.median(w_on):.1f}; "
          f"walls off {[round(w, 4) for w in w_off]}, on "
          f"{[round(w, 4) for w in w_on]}; the plane's overhead "
          f"{100 * over:.2f}% of the min wall (bench.py's bound "
          f"{100 * OBS_OVERHEAD_BOUND:.0f}%, printed, not gated: walls of "
          f"~0.3 s on a shared host vary more than that) [{card}]")

    # (e) the emit form's tap: run_io over the first chunk
    ch0 = chunks[0]
    echk = Checker(engine)
    ecost, eshared = cost_of("fifo_emit", engine)
    esp = tap_pass(echk, engine, s0, chunk_feeds(chunks[:1], dev), {0, 199},
                   ecost, eshared, emit=True)
    state = clone_state(s0)
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    state, io, mb_io = engine.run_io(state, ch0.rows, ch0.counts, None,
                                     D.metrics_init(state))
    torch.cuda.synchronize()
    ecounts = fused_tick.launch_counts()
    check_launches(ecounts, "fused_prefix_fifo_emit_tap", ch0.rows.shape[0],
                   "run_io with the plane")
    if max_abs_diff(esp["state"], state) or \
            max_abs_diff(esp["mbuf"], mb_io):
        raise AssertionError("run_io with the plane differs from its pass")
    print(f"phase 4n: run_io over the first {ch0.rows.shape[0]} headline "
          f"ticks with the plane: fused_prefix_fifo_emit_tap == plain "
          f"bitwise at {echk.n} ticks (state, outputs, buffer), "
          f"{np.mean(esp['kernel_ms']) * 1e3:.2f} us/launch [{card}]")
    swept = depth_bucket_sweep(P, E, dev)
    print(f"phase 4n: the tap's depth bucket in the kernel == the plain "
          f"version's on every depth below 2^24 ({swept} depths, "
          f"{swept // HEADLINE_C} launches; 8192 in bucket 13, as XLA's CPU "
          f"log2 puts it) [{card}]")
    return dict(
        records=[record_of("fused_prefix_fifo_tap",
                           counts["fused_prefix_fifo_tap"], chk.worst, kms,
                           chk.plain_ms, sp["read"], sp["written"]),
                 record_of("fused_prefix_fifo_emit_tap",
                           ecounts["fused_prefix_fifo_emit_tap"],
                           echk.worst, float(np.mean(esp["kernel_ms"])),
                           echk.plain_ms, esp["read"], esp["written"])],
        kernel_ms=sp["kernel_ms"], w_off=w_off, w_on=w_on, over=over,
        wall_min_s=min(w_on), h2d_s=head["h2d_s"], n_ticks=n_ticks,
        mbuf=mb)


def depth_bucket_sweep(P, E, dev, n_depths=1 << 24):
    """The tap's depth bucket in the kernel against the plain version's
    (``obs.device._depth_buckets``, itself held to ``jax.jit`` on every
    depth below 2^24 by tests/test_torch_obs.py) on every depth below
    2^24: 4,096 launches of the FIFO tap form on an empty headline state
    whose Level0 counts — which the FIFO span never touches and the tap
    adds into the depth — hold 4,096 consecutive depths a launch; each
    launch's histogram increments must equal the plain buckets' counts of
    its depths. Returns the number of depths swept."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D

    cfg = headline_cfg(P)
    C = HEADLINE_C
    engine = E.Engine(cfg, device=dev)
    state = init_state(cfg, [P.uniform_cluster(c + 1, 5) for c in range(C)],
                       device=dev)
    host = fused_tick.host_params(engine, engine._default_params)
    mb, cur = D.metrics_init(state), D.cursor_of(state)
    rows = torch.full((C, 1, 10), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(C, dtype=torch.int32, device=dev)
    n_launch = n_depths // C
    hists = torch.empty((n_launch + 1, D.OBS_DEPTH_BUCKETS),
                        dtype=torch.int32, device=dev)
    hists[0] = mb.depth_hist[0]
    depths = torch.arange(n_launch * C, dtype=torch.int32,
                          device=dev).view(n_launch, C)
    for k in range(n_launch):
        state.l0.count.copy_(depths[k])
        fused_tick.fused_prefix(engine, state, rows, counts, 1_000, None,
                                host, obs=(mb, cur))
        hists[k + 1] = mb.depth_hist[0]
    got = hists[1:] - hists[:-1]
    want = torch.zeros_like(got)
    for k0 in range(0, n_launch, 512):
        b = D._depth_buckets(depths[k0:k0 + 512].reshape(-1)).long()
        want[k0:k0 + 512].view(-1).index_add_(
            0, (torch.arange(b.numel(), device=dev) // C) * D.OBS_DEPTH_BUCKETS
            + b, torch.ones_like(b, dtype=torch.int32))
    if not torch.equal(got, want):
        bad = (got != want).any(1).nonzero()[:4].flatten().tolist()
        raise AssertionError(f"the kernel's depth bucket differs from the "
                             f"plain one at the launches {bad}")
    return n_launch * C


def phase_plane_churn(P, E, card, dev, churn_wide):
    """Phase 4o: bench_faults's churn at 4,096 clusters with the plane on:
    the tap's faults form tick by tick, every launch timed, kernel ==
    plain on 12 sampled ticks; the counted run with the plane, its state
    bitwise 4m's, its harvested kills and requeues the state's; the emit
    form's tap over 40 ``run_io`` ticks."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D

    cfg = faults_cfg(P)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(FAULTS_WIDE_C)]
    chunks, n_ticks = faults_stream(E, FAULTS_WIDE_C)
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, specs, device=dev)
    chk = Checker(engine)
    picks, peak = pick_ticks(chunks, FAULTS_SAMPLES)
    cost, shared = cost_of("fifo_faults", engine)
    sp = tap_pass(chk, engine, s0, chunk_feeds(chunks, dev), picks, cost,
                  shared)
    on, mb, _, counts = counted_plane_run(engine, s0, chunks,
                                          "fused_prefix_fifo_tap_faults")
    if max(max_abs_diff(churn_wide["sampled"]["state"], on),
           max_abs_diff(sp["state"], on), max_abs_diff(sp["mbuf"], mb)):
        raise AssertionError("churn with the plane differs from 4m's run "
                             "or its pass")
    h = plane_gates(on, mb, n_ticks, cfg.tick_ms, "phase 4o")
    kms = float(np.mean(sp["kernel_ms"]))
    ums = float(np.mean(sp["untapped_ms"]))
    print(f"phase 4o: churn at {FAULTS_WIDE_C} clusters with the plane on: "
          f"fused_prefix_fifo_tap_faults == plain bitwise on {chk.n} ticks "
          f"sampled as reached (ticks {sorted(picks)}); state bitwise 4m's; "
          f"harvested kills {h['fault_kills']}, requeues "
          f"{h['fault_requeues']}, fail drops {h['fault_drops']}, node "
          f"down {h['node_down_ms']} ms = the state's; {kms * 1e3:.2f} "
          f"us/launch over {len(sp['kernel_ms'])} launches, the untapped "
          f"faults form {ums * 1e3:.2f} on copies of the same states (4m's "
          f"pass: {np.mean(churn_wide['sampled']['kernel_ms']) * 1e3:.2f});"
          f" launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    # the emit form's tap: run_io over 40 ticks
    n_io = min(BORROW_IO_TICKS, chunks[0].rows.shape[0])
    echk = Checker(engine)
    ecost, eshared = cost_of("fifo_faults", engine)
    esp = tap_pass(echk, engine, s0, chunk_feeds(chunks, dev, n_io),
                   {0, n_io - 1}, ecost, eshared, emit=True)
    state = clone_state(s0)
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    state, _, mb_io = engine.run_io(state, chunks[0].rows[:n_io],
                                    chunks[0].counts[:n_io], None,
                                    D.metrics_init(state))
    torch.cuda.synchronize()
    ecounts = fused_tick.launch_counts()
    check_launches(ecounts, "fused_prefix_fifo_emit_tap_faults", n_io,
                   "churn run_io with the plane")
    if max_abs_diff(esp["state"], state) or \
            max_abs_diff(esp["mbuf"], mb_io):
        raise AssertionError("churn run_io with the plane differs from its "
                             "pass")
    print(f"phase 4o: run_io over the first {n_io} churn ticks with the "
          f"plane: fused_prefix_fifo_emit_tap_faults == plain bitwise at "
          f"{echk.n} ticks, {np.mean(esp['kernel_ms']) * 1e3:.2f} us/launch "
          f"[{card}]")
    return dict(records=[
        record_of("fused_prefix_fifo_tap_faults",
                  counts["fused_prefix_fifo_tap_faults"], chk.worst, kms,
                  chk.plain_ms, sp["read"], sp["written"]),
        record_of("fused_prefix_fifo_emit_tap_faults",
                  ecounts["fused_prefix_fifo_emit_tap_faults"], echk.worst,
                  float(np.mean(esp["kernel_ms"])), echk.plain_ms,
                  esp["read"], esp["written"])])


def config1_cfg(P, policy):
    """bench.py:839-895 bench_fifo_small's config (BASELINE config 1), as
    the port's; ``policy`` DELAY gives the reference's live scheduler on
    the same world."""
    return P.SimConfig(policy=policy, queue_capacity=768, max_running=512,
                       max_arrivals=CONFIG1_ARRIVALS, max_nodes=5, n_res=2,
                       record_metrics=True)


def config1_run(engine, s0, arr, plane=True):
    """Config 1's run: 3,600 ticks as four 900-tick ``run`` calls over the
    windowed stream, the buffer carried. Returns the state, the series of
    every tick and the buffer (None with the plane off)."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.obs import device as D

    state = clone_state(s0)
    mb = D.metrics_init(state) if plane else None
    series = []
    for _ in range(CONFIG1_TICKS // CONFIG1_CHUNK):
        res = engine.run(state, arr, CONFIG1_CHUNK, None, mb)
        state, ser = res[0], res[1]
        mb = res[2] if plane else None
        series.append(ser)
    return state, series, mb


def series_at_marks(series):
    """The series at the reference's 5 s marks, as bench_fifo_small writes
    bench_metrics.json."""
    t = torch.cat([s.t for s in series]).cpu().numpy()
    jq = torch.cat([s.jobs_in_queue for s in series]).cpu().numpy()
    aw = torch.cat([s.avg_wait_ms for s in series]).cpu().numpy()
    at = t % 5_000 == 0
    return {"t_ms": t[at].tolist(), "jobs_in_queue": jq[at, 0].tolist(),
            "avg_wait_ms": [round(float(x), 2) for x in aw[at, 0]]}


def plain_windowed_run(engine, s0, rows, n, n_ticks):
    """The plain version of a windowed run with the plane and the series:
    the plain prefix, its tap and ``tap_tick_global``, tick by tick.
    Returns the state, the stacked series and the buffer."""
    from multi_cluster_simulator_tpu_torch.core import state as st
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D

    params = engine._default_params
    member = engine.member(params)
    ref = st.clone_state(s0)
    mb, cur = D.metrics_init(ref), D.cursor_of(ref)
    series, t = [], int(s0.t)
    for _ in range(n_ticks):
        t += engine.cfg.tick_ms
        ref, *_, tap = fused_tick.fused_prefix_reference(
            engine, ref, rows, n, t, params, member,
            obs=(D.tap_pc(mb), cur), windowed=True)
        pc, cur, placed_d, depth = tap
        mb = D.tap_tick_global(mb.replace(**pc), placed_d, depth, t,
                               engine.cfg.tick_ms)
        ref.t.fill_(t)
        series.append(st.metric_sample(ref))
    return ref, st.stack_samples(series, ref), mb


def phase_config1(P, E, card, dev):
    """Phase 4p: BASELINE config 1 (bench.py:839-895 bench_fifo_small) at
    its own shape: FIFO on one cluster_small, the windowed ingest of
    generate_arrivals(..., 1, 2048, 3_600_000, 32, 24_000, seed=9), 3,600
    ticks in 900-tick chunks, record_metrics and the plane on. Zero drops;
    the series at the 5 s marks equal to the committed bench_metrics.json;
    the first chunk's kernel run == its plain run (state, series, buffer);
    the first chunk's launches timed beside the untapped form's, kernel
    == plain at 12 of its ticks; fifo_cluster_small_ticks_per_sec over 3
    timed runs after 1 warm-up, the plane off and on interleaved. Then
    the same world under DELAY, the reference's live scheduler, whose
    series moves (kernel == plain at 12 ticks of its first chunk)."""
    import json as _json
    import os

    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D
    from multi_cluster_simulator_tpu_torch.policies import kernels as K
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )
    from multi_cluster_simulator_tpu_torch.workload.generator import (
        generate_arrivals,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "bench_metrics.json")) as f:
        committed = _json.load(f)
    out = {"records": []}
    picks = {int(x) for x in np.linspace(0, CONFIG1_CHUNK - 1, 12)}
    for policy in (P.PolicyKind.FIFO, P.PolicyKind.DELAY):
        cfg = config1_cfg(P, policy)
        engine = E.Engine(cfg, device=dev)
        arr = generate_arrivals(cfg.workload, 1, cfg.max_arrivals,
                                CONFIG1_TICKS * cfg.tick_ms, 32, 24_000,
                                seed=9)
        s0 = init_state(cfg, [P.uniform_cluster(1, 5)], device=dev)
        kernel = fused_tick.host_params(engine,
                                        engine._default_params)["tap_kernel"]
        rows, n = (torch.from_numpy(x).to(dev) for x in E.pack_arrivals(arr))
        name = policy.value
        # the first chunk tick by tick: every launch timed beside the
        # untapped form's, kernel == plain at 12 ticks
        chk = Checker(engine)
        cost, shared = cost_of(
            "fifo" if policy == P.PolicyKind.FIFO else "delay", engine,
            K._sweep_len(cfg))
        delay = policy == P.PolicyKind.DELAY
        sp = tap_pass(chk, engine, s0, ((rows, n) for _ in range(
            CONFIG1_CHUNK)), picks, cost, shared, windowed=True,
            l1_cap=K._sweep_len(cfg) if delay else None)
        # the main path, counted
        torch.cuda.synchronize()
        fused_tick.reset_launches()
        w0 = time.perf_counter()
        fin, series, mb = config1_run(engine, s0, arr)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - w0
        counts = fused_tick.launch_counts()
        wcounts = fused_tick.windowed_launch_counts()
        check_launches(counts, kernel.name, CONFIG1_TICKS, "config 1")
        check_launches(wcounts, kernel.name, CONFIG1_TICKS,
                       "config 1, windowed")
        # the first chunk through the entry point equals the pass
        s1 = init_state(cfg, [P.uniform_cluster(1, 5)], device=dev)
        first = engine.run(s1, arr, CONFIG1_CHUNK, None, D.metrics_init(s1))
        if max(max_abs_diff(sp["state"], first[0]),
               max_abs_diff(sp["mbuf"], first[2])):
            raise AssertionError("config 1: the first chunk's run differs "
                                 "from its pass")
        drops = total_drops(fin)
        check_conservation(fin)
        h = plane_gates(fin, mb, CONFIG1_TICKS, cfg.tick_ms, "config 1")
        marks = series_at_marks(series)
        if policy == P.PolicyKind.FIFO:
            # the first CONFIG1_PLAIN_TICKS ticks through the entry point
            # and through the plain version
            s2 = init_state(cfg, [P.uniform_cluster(1, 5)], device=dev)
            part = engine.run(s2, arr, CONFIG1_PLAIN_TICKS, None,
                              D.metrics_init(s2))
            w0 = time.perf_counter()
            ref, ref_ser, ref_mb = plain_windowed_run(engine, s0, rows, n,
                                                      CONFIG1_PLAIN_TICKS)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - w0
            d = max(max_abs_diff(ref, part[0]), max_abs_diff(ref_mb, part[2]),
                    max_abs_diff(ref_ser, part[1]))
            if d:
                raise AssertionError(f"config 1: the first "
                                     f"{CONFIG1_PLAIN_TICKS} ticks differ "
                                     f"from their plain run ({d})")
            if any(drops.values()):
                raise AssertionError(f"config 1: drops {drops}")
            if marks != {k: committed[k] for k in marks}:
                raise AssertionError("config 1: the series at the 5 s marks "
                                     "differs from bench_metrics.json")
            off, on = [], []
            for i in range(CONFIG1_WARMUPS + CONFIG1_TIMED):
                for walls, plane in ((off, False), (on, True)):
                    torch.cuda.synchronize()
                    w0 = time.perf_counter()
                    config1_run(engine, s0, arr, plane)
                    torch.cuda.synchronize()
                    if i >= CONFIG1_WARMUPS:
                        walls.append(time.perf_counter() - w0)
            print(f"phase 4p: config 1 (FIFO, cluster_small, queue 768, "
                  f"running 512, {CONFIG1_ARRIVALS} arrivals, the windowed "
                  f"ingest, record_metrics, the plane on), {CONFIG1_TICKS} "
                  f"ticks in {CONFIG1_CHUNK}-tick chunks: placed "
                  f"{int(fin.placed_total.sum())}, arrived "
                  f"{int(fin.arr_ptr.sum())}, drops {drops}, conservation "
                  f"ok; the series at the {len(marks['t_ms'])} 5 s marks "
                  f"equals bench_metrics.json (jobs_in_queue max "
                  f"{max(marks['jobs_in_queue'])}, avg_wait_ms max "
                  f"{max(marks['avg_wait_ms'])}: zero, since under FIFO no "
                  f"handler moves jobs_in_queue or the wait counters); "
                  f"harvest queue depth max {h['queue_depth_max']}, mean "
                  f"{h['queue_depth_mean']}, histogram "
                  f"{h['depth_hist_log2']}; launches "
                  f"{ {k: v for k, v in counts.items() if v} }, windowed "
                  f"{ {k: v for k, v in wcounts.items() if v} } [{card}]")
            print(f"phase 4p: the first {CONFIG1_PLAIN_TICKS} ticks: kernel "
                  f"run == plain run on every state, series and buffer "
                  f"leaf; run wall plain {plain_s:.3f} s [{card}]")
            print(f"phase 4p: fifo_cluster_small_ticks_per_sec (virtual-s/s)"
                  f" with the plane on {CONFIG1_TICKS / min(on):.1f} (min "
                  f"of {len(on)}), {CONFIG1_TICKS / np.median(on):.1f} "
                  f"(median); off {CONFIG1_TICKS / min(off):.1f}, "
                  f"{CONFIG1_TICKS / np.median(off):.1f}; walls on "
                  f"{[round(w, 4) for w in on]}, off "
                  f"{[round(w, 4) for w in off]}; first run "
                  f"{first_s:.4f} s; us/tick "
                  f"{1e6 * min(on) / CONFIG1_TICKS:.1f} [{card}]")
            out.update(on=on, off=off)
        else:
            jq = max(marks["jobs_in_queue"])
            aw = max(marks["avg_wait_ms"])
            if not (jq > 0 and aw > 0):
                raise AssertionError(f"config 1 under DELAY: a flat series "
                                     f"({jq}, {aw})")
            print(f"phase 4p: the same world under DELAY (the reference's "
                  f"live scheduler): placed {int(fin.placed_total.sum())}, "
                  f"drops {drops}, conservation ok; the series moves: "
                  f"jobs_in_queue max {jq}, avg_wait_ms max {aw} at the 5 s "
                  f"marks, final {marks['avg_wait_ms'][-1]}; harvest wait "
                  f"accrued {h['wait_accrued_ms']} ms, depth max "
                  f"{h['queue_depth_max']}; launches "
                  f"{ {k: v for k, v in counts.items() if v} }; Level1 rows "
                  f"the sweep took a tick over the first {CONFIG1_CHUNK} "
                  f"ticks (min(|L1|, {K._sweep_len(cfg)})) max "
                  f"{sp['l1_swept_max']}, mean {sp['l1_swept_mean']:.4f} "
                  f"[{card}]")
        print(f"phase 4p: {kernel.name} (windowed ingest) == plain bitwise "
              f"at {chk.n} ticks of the first chunk under {name} (state, "
              f"buffer, cursor), {np.mean(sp['kernel_ms']) * 1e3:.2f} "
              f"us/launch over its {len(sp['kernel_ms'])} ticks, the "
              f"untapped form {np.mean(sp['untapped_ms']) * 1e3:.2f}, plain "
              f"{np.mean(chk.plain_ms):.3f} ms [{card}]")
        rec = record_of(kernel.name, wcounts[kernel.name], chk.worst,
                        float(np.mean(sp["kernel_ms"])), chk.plain_ms,
                        sp["read"], sp["written"], sp["ops"])
        rec["name"] = f"{kernel.name}_windowed"
        out["records"].append(rec)
    return out


def tap_segments(chk, engine, s0, chunks, picks, cost, shared, costs):
    """Through ``engine.run_chunks`` with a buffer, chunk by chunk, the
    cursor re-derived at each call's entry; at each tick in ``picks`` a
    one-tick run after the tap form and the untapped form were compared
    and timed (``Checker``) on copies, the emit form's tap too at the
    first two; the tick's bytes appended to ``costs``. Returns the final
    state and buffer."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        TickArrivals, clone_state,
    )
    from multi_cluster_simulator_tpu_torch.obs import device as D

    state = clone_state(s0)
    mb = D.metrics_init(state)
    k_glob, t = 0, 0
    for ch in chunks:
        T = ch.rows.shape[0]
        cuts = sorted({0, T} | {p - k_glob for p in picks
                               if k_glob <= p < k_glob + T})
        for a, b in zip(cuts, cuts[1:]):
            if a + k_glob in picks:
                rows = torch.from_numpy(ch.rows[a]).to(state.device)
                counts = torch.from_numpy(ch.counts[a]).to(state.device)
                cur = D.cursor_of(state)
                before = (clone_state(state), chk.clone(mb), cur)
                k_state, k_mb, k_cur = chk.compare(
                    state, rows, counts, t + engine.cfg.tick_ms,
                    obs=(mb, cur))
                r, w, o = cost(before[0], k_state, rows, counts,
                               t + engine.cfg.tick_ms)
                tr, tw = tap_cost(shared, before[1], cur, k_mb, k_cur)
                costs.append((int(r + tr), int(w + tw), int(o)))
                if len(costs) <= 2:
                    chk.compare(state, rows, counts, t + engine.cfg.tick_ms,
                                emit=True, obs=(mb, cur))
            part = TickArrivals(rows=ch.rows[a:b], counts=ch.counts[a:b])
            state, mb = engine.run_chunks(state, [part], None, mb)
            t += (b - a) * engine.cfg.tick_ms
        k_glob += T
    return state, mb


def phase_plane_level0(P, E, card, dev, borg, market, sampled):
    """Phase 4q: the Level0 kernels' tap forms on the terminal runs they
    ride: borg4k (FFD), market (b) gavel, (c) tesserae, (d) DELAY parity —
    the counted run with the plane (its state bitwise the plane-off run's,
    the harvest tied back), kernel == plain and the tap form timed beside
    the untapped one at ticks the run reaches, the emit form's tap at two;
    then the faults forms' taps: the first 30 ticks of DELAY, FFD and
    gavel at the quick market shape with churn, run == plain with the
    plane."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.policies import kernels as K
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    # the terminal Level0 runs: each world, stream, plane-off final state
    # and cost kind
    runs = [("borg4k", borg_cfg(P), "ffd", borg["specs"], borg["chunks"],
             borg["sampled"]["state"], "ffd")]
    for name in "bcd":
        policy, kw, _ = MARKET_RUNS[name]
        runs.append((f"market ({name})", market_cfg(P, **kw), policy,
                     market["specs"], market["chunks"],
                     sampled[name]["sampled"]["state"], policy))
    records = {}
    for label, cfg, policy, specs, chunks, off_state, kind in runs:
        engine = E.Engine(cfg, device=dev, policies=PolicySet((policy,)))
        QC = K._sweep_len(cfg)
        cost, shared = cost_of(kind, engine, QC)
        kernel = Checker(engine).host["tap_kernel"].name
        s0 = init_state(cfg, specs, device=dev)
        n_ticks = sum(ch.rows.shape[0] for ch in chunks)
        on, mb, wall, counts = counted_plane_run(engine, s0, chunks, kernel)
        if max_abs_diff(off_state, on):
            raise AssertionError(f"{label} with the plane differs from its "
                                 f"plane-off run")
        h = plane_gates(on, mb, n_ticks, cfg.tick_ms, label)
        chk = Checker(engine)
        picks, _ = pick_ticks(chunks, PLANE_SAMPLES)
        costs = []
        seg_state, seg_mb = tap_segments(chk, engine, s0, chunks, picks,
                                         cost, shared, costs)
        if max(max_abs_diff(seg_state, on), max_abs_diff(seg_mb, mb)):
            raise AssertionError(f"{label}: the segmented run differs")
        rec = tap_records(chk, kernel, counts[kernel], costs)
        print(f"phase 4q: {label} with the plane on, {n_ticks} ticks: state "
              f"bitwise the plane-off run's; harvest placed {h['placed']}, "
              f"depth max {h['queue_depth_max']}, histogram "
              f"{h['depth_hist_log2']}; {kernel} == plain bitwise at "
              f"{chk.n} ticks it reached (the emit form's tap at 2), "
              f"{np.mean(chk.tap_ms) * 1e3:.2f} us/launch (median "
              f"{np.median(chk.tap_ms) * 1e3:.2f}, max "
              f"{np.max(chk.tap_ms) * 1e3:.2f}), the untapped form "
              f"{np.mean(chk.untap_ms) * 1e3:.2f} (median "
              f"{np.median(chk.untap_ms) * 1e3:.2f}) on the same states; "
              f"bound {rec['bound'][0] * 1e3:.4f} us by {rec['bound'][1]}; "
              f"run wall {wall:.4f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} } [{card}]")
        records.setdefault(kernel, rec)

    # the faults forms' taps at the quick market shape, with churn
    qc_, qj = MARKET_QUICK
    ch_q = first_ticks(market_stream(E, qc_, qj, quick=True)[0],
                       PLANE_CHURN_TICKS)
    quick_fc = churn_faults(P, mttf_ms=60_000, mttr_ms=8_000)
    for policy, kind in (("delay", "delay"), ("ffd", "ffd"),
                         ("gavel", "gavel")):
        cfg = market_cfg(P, quick=True, jobs=qj, faults=quick_fc)
        engine = E.Engine(cfg, device=dev, policies=PolicySet((policy,)))
        s0 = init_state(cfg, market_specs(P, qc_), device=dev)
        plain_s, kernel_s, out, mb, counts = whole_plane_run_against_plain(
            E, engine, s0, ch_q, f"quick {policy} with churn")
        kernel = Checker(engine).host["tap_kernel"].name
        n_q = sum(ch.rows.shape[0] for ch in ch_q)
        h = plane_gates(out, mb, n_q, cfg.tick_ms,
                        f"quick {policy} with churn")
        if not h["fault_kills"]:
            raise AssertionError(f"quick {policy}: no kill reached the tap")
        chk = Checker(engine)
        costs = []
        cost, shared = cost_of(kind, engine, K._sweep_len(cfg))
        tap_segments(chk, engine, s0, ch_q, {5, 25, 45}, cost, shared,
                     costs)
        print(f"phase 4q: quick {policy} with churn ({qc_} clusters x "
              f"{n_q} ticks), the plane on: {kernel} + tap == "
              f"plain on every state and buffer leaf; harvested kills "
              f"{h['fault_kills']}, requeues {h['fault_requeues']}; "
              f"{np.mean(chk.tap_ms) * 1e3:.2f} us/launch at 3 ticks (the "
              f"untapped form {np.mean(chk.untap_ms) * 1e3:.2f}); run wall "
              f"plain {plain_s:.3f} s, kernel {kernel_s:.3f} s [{card}]")
        if kernel not in records:
            records[kernel] = tap_records(chk, kernel, counts[kernel], costs)
    return dict(records=list(records.values()))



# --------------------------------------------------------------------------
# the compact layout (core/compact.py) and its checked narrow store: 5a (the
# headline, this slice's main path), 5b (undersized plans, the waves
# replayed, the node exit narrow), 5c (the Level0 forms), 5d (the emit and
# expire forms), 5e (the faults forms), 5f (BASELINE config 4)
# --------------------------------------------------------------------------

def compact_record(name, launches, worst, ms, plain, read, written, ops=0.0):
    """A kernel record of a compact-layout form, named ``<form>/compact``."""
    return dict(record_of(name, launches, worst, ms, plain, read, written,
                          ops), name=f"{name}/compact")


def tap_pair_records(chk, name, launches, sp, tap_launches=None):
    """The untapped and the tap form's compact records from one
    ``tap_pass(..., both=True)``."""
    tap = name.replace("fused_prefix_", "").split("_faults")[0]
    tap_name = ("fused_prefix_" + tap + "_tap"
                + ("_faults" if name.endswith("_faults") else ""))
    return [compact_record(name, launches, chk.worst,
                           float(np.mean(sp["untapped_ms"])), chk.plain_ms,
                           sp["span_read"], sp["span_written"], sp["ops"]),
            compact_record(tap_name, tap_launches or sp["ticks"], chk.worst,
                           float(np.mean(sp["kernel_ms"])), chk.plain_ms,
                           sp["read"], sp["written"], sp["ops"])]


def layout_walls(engine, s_wide, s_compact, chunks, pairs):
    """Interleaved walls of whole runs on the wide and the compact layout
    (wide first in each pair); the counted runs before are the warm-ups."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    wide, compact = [], []
    for _ in range(pairs):
        for walls, s0 in ((wide, s_wide), (compact, s_compact)):
            state = clone_state(s0)
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            engine.run_chunks(state, chunks)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - w0)
    return wide, compact


def phase_compact_headline(P, E, card, dev, head):
    """Phase 5a, this slice's main path: the headline (4,096 clusters x 250
    jobs, 1,570 ticks) on the compact layout, its plan from
    ``derive_plan(cfg, specs, arrivals)``: (a) the whole run tick by tick
    through the tap form and, on a copy of each state, the untapped form,
    every launch timed, both == plain at 12 sampled ticks, the bytes
    counted at the narrow leaves' sizes; (b) the counted run through
    ``run_chunks``: the headline's gates (zero drops, the narrow overflow
    total among them; 99% placed; conservation; one launch a tick) and
    ``to_wide`` of its final state bitwise the wide run's (4a); (c) the
    state's bytes in both layouts; (d) wide and compact walls, 5
    interleaved pairs; (e) the counted run with the plane, bitwise the
    plane-off run, its harvested overflow total the state's."""
    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.obs import device as D

    cfg = headline_cfg(P)
    chunks, specs, n_ticks = head["chunks"], head["specs"], head["n_ticks"]
    engine = E.Engine(cfg, device=dev)
    plan = CC.derive_plan(cfg, specs, head["arr"])
    s0 = init_state(cfg, specs, device=dev, plan=plan)
    w0 = init_state(cfg, specs, device=dev)
    nb_c, nb_w = CC.state_nbytes(s0), CC.state_nbytes(w0)
    print(f"phase 5a: compact plan {plan.describe()}; state {nb_c} B "
          f"against {nb_w} B wide ({nb_c / nb_w:.4f}) [{card}]")
    chk = Checker(engine)
    picks, peak = pick_ticks(chunks, PLANE_SAMPLES)
    cost, shared = cost_of("fifo", engine)
    sp = tap_pass(chk, engine, s0, chunk_feeds(chunks, dev), picks, cost,
                  shared, both=True)
    out, first_s, counts = counted_run(engine, s0, chunks,
                                       "fused_prefix_fifo")
    placed, drops = check_gates(out, n_ticks, cfg.tick_ms, HEADLINE_C * JOBS,
                                0.99, "phase 5a")
    ovf = CC.overflow_total(out)
    d = max(max_abs_diff(CC.to_wide(out), head["final"]),
            max_abs_diff(sp["state"], out))
    if ovf or d:
        raise AssertionError(f"phase 5a: overflow {ovf}; the compact run "
                             f"against the wide one or its pass: {d}")
    w_wide, w_comp = layout_walls(engine, w0, s0, chunks, COMPACT_PAIRS)
    on, mb, _, pcounts = counted_plane_run(engine, s0, chunks,
                                           "fused_prefix_fifo_tap")
    if max_abs_diff(on, out) or max_abs_diff(sp["mbuf"], mb):
        raise AssertionError("phase 5a: the compact headline with the plane "
                             "differs from the plane-off run or its pass")
    h = plane_gates(on, mb, n_ticks, cfg.tick_ms, "phase 5a")
    if h["narrow_ovf"] != CC.overflow_total(on):
        raise AssertionError(f"phase 5a: harvested narrow_ovf "
                             f"{h['narrow_ovf']}, the state's "
                             f"{CC.overflow_total(on)}")
    ums, kms = np.mean(sp["untapped_ms"]), np.mean(sp["kernel_ms"])
    b_ms, b_by = bound(sp["span_read"], sp["span_written"])
    print(f"phase 5a: compact headline, {n_ticks} ticks: the FIFO kernel "
          f"and its tap form == plain bitwise at {chk.n} comparisons on "
          f"{len(picks)} ticks sampled as the kernel reached them (the peak "
          f"{peak}); placed {placed}, drops {drops} (narrow overflow total "
          f"{ovf}), conservation ok, launches {counts['fused_prefix_fifo']}"
          f"; to_wide(final) bitwise the wide run's final state; the plane "
          f"on: bitwise the plane-off run, harvested narrow_ovf "
          f"{h['narrow_ovf']}, launches {pcounts['fused_prefix_fifo_tap']} "
          f"[{card}]")
    print(f"phase 5a: kernel fused_prefix_fifo on the compact layout "
          f"{ums * 1e3:.2f} us/launch (the tap form {kms * 1e3:.2f}) mean "
          f"over {len(sp['untapped_ms'])} launches; bound "
          f"{b_ms * 1e3:.4f} us by {b_by} ({sp['span_read']:.1f} B read, "
          f"{sp['span_written']:.1f} written a launch at the narrow leaves' "
          f"sizes); plain {np.mean(chk.plain_ms):.3f} ms [{card}]")
    print(f"phase 5a: headline jobs/s wide {placed / min(w_wide):.1f} (min "
          f"of {len(w_wide)}), {placed / np.median(w_wide):.1f} (median); "
          f"compact {placed / min(w_comp):.1f}, "
          f"{placed / np.median(w_comp):.1f}; walls wide "
          f"{[round(w, 4) for w in w_wide]}, compact "
          f"{[round(w, 4) for w in w_comp]}; compact / wide min wall "
          f"{min(w_comp) / min(w_wide):.4f} [{card}]")
    return dict(records=tap_pair_records(
        chk, "fused_prefix_fifo", counts["fused_prefix_fifo"], sp,
        pcounts["fused_prefix_fifo_tap"]), nbytes=(nb_c, nb_w),
        kernel_ms=sp["untapped_ms"], wall_min_s=min(w_comp),
        h2d_s=head["h2d_s"], n_ticks=n_ticks)


def undersized(CC, plan):
    """``plan`` with int8 queue cores (tests/test_kernels.py:283)."""
    import dataclasses

    return dataclasses.replace(plan, queue=tuple(
        (n, "int8" if n == "cores" else dt) for n, dt in plan.queue))


def mixed_rows_tick(dev, chk, s0, qname, seed):
    """One tick on a queue ``qname`` loaded with 12 rows a cluster mixing
    -128-core jobs (a clamped store's value, counted in the queue's
    ``ovf`` as the store that made it would) with jobs too big for any
    node until one of them placed: the waves and the serial form differ
    there. Kernel == plain."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.ops import queues as Q

    C = s0.arr_ptr.shape[0]
    gen = np.random.default_rng(seed)
    n = 12
    rows = np.zeros((C, n, Q.NF), np.int32)
    rows[..., Q.FID] = np.arange(n)
    rows[..., Q.FCORES] = gen.choice([-128, 70, 20, 5, 127], (C, n))
    rows[..., Q.FMEM] = gen.integers(100, 20_000, (C, n))
    rows[..., Q.FDUR] = 50_000
    rows[..., Q.FOWNER] = -1
    state = clone_state(s0)
    q = getattr(state, qname)
    load_queue(q, torch.from_numpy(rows).to(dev),
               torch.full((C,), n, dtype=torch.int32, device=dev))
    q.ovf.fill_(1)
    arr = torch.zeros((C, 1, Q.NF), dtype=torch.int32, device=dev)
    return chk.compare(state, arr, torch.zeros(C, dtype=torch.int32,
                                               device=dev), 1_000)


def phase_compact_undersized(P, E, card, dev):
    """Phase 5b: plans the checked store must count against, at 4,096
    clusters. (a) tests/test_kernels.py:283's case (int8 cores, 500-core
    jobs) tiled: the FIFO kernel's whole run == plain, overflows counted,
    the dtype minimum stored and never 500 % 256; (b) a denser stream on
    that plan through the FIFO wave drain, the FFD and the DELAY waves
    (the kernels replay the waves where a demand is negative) and one
    tick of -128-core jobs mixed with big ones in Level1 (DELAY wave) and
    Level0 (FFD wave, ffd-memfirst); (c) the terminal node exit narrow on
    a hand-built plan (int8 node columns on 100-core nodes, which a
    placed -128-core job lifts past 127): FIFO and its tap form, DELAY,
    FFD, gavel, tesserae == plain, every cluster's run.ovf the same
    nonzero total."""
    import dataclasses

    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core.state import (
        Arrivals, init_state,
    )
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    C = HEADLINE_C
    cfg = headline_cfg(P)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(C)]
    tile = lambda v: np.tile(np.asarray([v], np.int32), (C, 1))  # noqa
    arr = Arrivals(t=tile([1_500, 2_500, 3_500, 4_500]),
                   id=np.arange(4 * C, dtype=np.int32).reshape(C, 4),
                   cores=tile([500, 2, 500, 2]), mem=tile([100] * 4),
                   gpu=tile([0] * 4), dur=tile([5_000] * 4),
                   n=np.full((C,), 4, np.int32))
    under = undersized(CC, CC.derive_plan(cfg, specs, None))
    chunks = E.pack_arrivals_chunks(arr, [10], cfg.tick_ms)
    engine = E.Engine(cfg, device=dev)
    _, _, out = whole_run_against_plain(
        E, engine, init_state(cfg, specs, device=dev, plan=under), chunks,
        "undersized")
    ovf = CC.overflow_total(out)
    # at tick 4 the first 500-core job runs, stored as the dtype minimum
    _, _, mid = whole_run_against_plain(
        E, engine, init_state(cfg, specs, device=dev, plan=under),
        [first_ticks(chunks, 4)[0]], "undersized, 4 ticks")
    held = int((mid.run.f_cores == -128).sum())
    wrapped = sum(int((x.f_cores == 500 % 256).sum()) for x in
                  (out.run, out.ready, mid.run, mid.ready))
    if not ovf or wrapped or held < C:
        raise AssertionError(f"phase 5b: overflow {ovf}, wrapped {wrapped}, "
                             f"-128 rows {held}")
    print(f"phase 5b: tests/test_kernels.py:283 tiled to {C} clusters: FIFO "
          f"kernel == plain over its 10 ticks (and its first 4), overflows "
          f"counted {ovf}; at tick 4 every cluster runs its 500-core jobs "
          f"stored as -128 ({held} rows), none wrapped to 500 % 256 "
          f"[{card}]")
    big = uniform_stream(C, 20, 20_000, max_cores=600, max_mem=6_000,
                         max_dur_ms=60_000, seed=3)
    ch_big = E.pack_arrivals_chunks(big, [30], cfg.tick_ms)
    wave = dataclasses.replace(borg_cfg(P), delay_sweep="wave",
                               ffd_sweep="wave")
    seen = {}
    for what, c_, pol in (("FIFO wave drain", cfg, None),
                          ("FFD wave", wave, "ffd"),
                          ("DELAY wave", wave, "delay")):
        eng = E.Engine(c_, device=dev, policies=None if pol is None
                       else PolicySet((pol,)))
        _, _, o = whole_run_against_plain(
            E, eng, init_state(c_, specs, device=dev, plan=under), ch_big,
            what)
        seen[what] = CC.overflow_total(o)
    for pol, qname in (("delay", "l1"), ("ffd", "l0"),
                       ("ffd-memfirst", "l0")):
        eng = E.Engine(wave, device=dev, policies=PolicySet((pol,)))
        mixed_rows_tick(dev, Checker(eng),
                        init_state(wave, specs, device=dev, plan=under),
                        qname, 5)
    print(f"phase 5b: the denser 600-core stream on the undersized plan, 30 "
          f"ticks each, kernel == plain with overflows {seen}; one tick of "
          f"-128-core jobs mixed with 70-core ones in Level1 (DELAY wave) "
          f"and Level0 (FFD wave, ffd-memfirst) == plain [{card}]")
    specs2 = [P.uniform_cluster(c + 1, 2, cores=100, memory=100)
              for c in range(C)]
    arr2 = uniform_stream(C, 4, 4_000, max_cores=600, max_mem=50,
                          max_dur_ms=60_000, seed=4)
    hand = undersized(CC, CC.derive_plan(cfg, specs2, None))
    ch2 = E.pack_arrivals_chunks(arr2, [8], cfg.tick_ms)
    totals = {}
    for pol in ("fifo", "delay", "ffd", "gavel", "tesserae"):
        eng = E.Engine(cfg, device=dev, policies=PolicySet((pol,)))
        s2 = init_state(cfg, specs2, device=dev, plan=hand)
        _, _, o = whole_run_against_plain(E, eng, s2, ch2, f"node exit "
                                          f"{pol}")
        run_ovf = o.run.ovf
        if int(run_ovf.min()) <= 0 or not bool((run_ovf
                                                == run_ovf[0]).all()):
            raise AssertionError(f"phase 5b: node exit {pol}: run.ovf "
                                 f"{run_ovf[:4].tolist()}")
        totals[pol] = int(run_ovf[0])
        if pol == "fifo":
            _, _, o2, mb, _ = whole_plane_run_against_plain(
                E, eng, s2, ch2, "node exit, the tap form")
            from multi_cluster_simulator_tpu_torch.obs import device as D
            if D.harvest(mb)["narrow_ovf"] != CC.overflow_total(o2):
                raise AssertionError("phase 5b: the tap's ovf")
    print(f"phase 5b: node exit narrow on a hand-built plan ({hand.node} "
          f"node columns on 100-core nodes) at {C} clusters, 8 ticks: "
          f"kernel == plain (FIFO and its tap form, DELAY, FFD, gavel, "
          f"tesserae); the cross-cluster count added to every cluster's "
          f"run.ovf, equal in all (after the run: {totals}) [{card}]")


def phase_compact_level0(P, E, card, dev, market):
    """Phase 5c: the Level0 kernels on the compact layout, kernel == plain
    (the untapped and the tap form) at sampled ticks of the first 250
    ticks of bench_borg4k (FFD) and the first 150 of market runs (b)
    gavel, (c) tesserae and (d) DELAY parity (trader cut), every launch
    timed."""
    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    records = []
    cfg = borg_cfg(P)
    chunks, _, arr = borg_stream(E, BORG_C, BORG_JOBS, BORG_HORIZON_MS,
                                 cfg.tick_ms, arrivals=True)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(BORG_C)]
    runs = [("borg4k", "fused_prefix_ffd", cfg, "ffd", specs, chunks, arr,
             COMPACT_PASS_TICKS + 100)]
    for name, kernel in (("b", "fused_prefix_scored"),
                         ("c", "fused_prefix_scored"),
                         ("d", "fused_prefix_delay")):
        policy, kw, _ = MARKET_RUNS[name]
        runs.append((f"market ({name})", kernel, market_cfg(P, **kw), policy,
                     market["specs"], market["chunks"], market["arr"],
                     COMPACT_PASS_TICKS))
    for what, kernel, c_, policy, specs_, chunks_, arr_, n in runs:
        engine = E.Engine(c_, device=dev, policies=PolicySet((policy,)))
        plan = CC.derive_plan(c_, specs_, arr_)
        s0 = init_state(c_, specs_, device=dev, plan=plan)
        chk = Checker(engine)
        QC = min(c_.queue_capacity, c_.max_placements_per_tick) \
            if not c_.parity else c_.queue_capacity
        cost, shared = cost_of({"gavel": "gavel", "tesserae": "tesserae",
                                "ffd": "ffd"}.get(policy, "delay"), engine,
                               QC)
        picks = set(np.linspace(0, n - 1, COMPACT_SAMPLES).astype(int)
                    .tolist())
        sp = tap_pass(chk, engine, s0, chunk_feeds(chunks_, dev, n), picks,
                      cost, shared, both=True)
        print(f"phase 5c: {what} on the compact layout ({policy}), first "
              f"{n} ticks: {kernel} and its tap form == plain bitwise at "
              f"{chk.n} comparisons; {np.mean(sp['untapped_ms']) * 1e3:.2f}"
              f" us/launch (tap {np.mean(sp['kernel_ms']) * 1e3:.2f}); "
              f"bound {bound(sp['span_read'], sp['span_written'], sp['ops'])[0] * 1e3:.4f}"
              f" us; plain {np.mean(chk.plain_ms):.3f} ms [{card}]")
        if what in ("borg4k", "market (b)", "market (d)"):
            records += tap_pair_records(chk, kernel, sp["ticks"], sp)
    return dict(records=records)


def phase_compact_emit_expire(P, E, card, dev, market):
    """Phase 5d: the non-terminal forms on the compact layout, where the
    engine widens the node columns before the prefix and narrows them,
    checked, after its last phase: the FIFO emit form on borrowing run
    (b) (config 2 tiled to 4,096, trader cut: int16 node columns) and
    DELAY's expire form on market run (e) (config 4 with expiry), their
    first 150 ticks tick by tick with delivery, matching and the market,
    kernel == plain at sampled ticks, every launch timed."""
    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    n = COMPACT_PASS_TICKS
    picks = set(np.linspace(0, n - 1, COMPACT_SAMPLES).astype(int).tolist())
    cfg = borrow_cfg(P)
    specs = borrow_specs(P, BORROW_C)
    chunks, _, arr = borrow_stream(P, E, BORROW_C, n, arrivals=True)
    plan = CC.derive_plan(cfg, specs, arr)
    engine = E.Engine(cfg, device=dev)
    chk = Checker(engine)
    bp = borrow_pass(E, chk, init_state(cfg, specs, device=dev, plan=plan),
                     chunks, picks, until=n)
    if CC.overflow_total(bp["state"]):
        raise AssertionError("phase 5d: borrowing overflowed")
    print(f"phase 5d: borrowing run (b) on the compact layout (node columns "
          f"{plan.node}), first {n} ticks: fused_prefix_fifo_emit == plain "
          f"bitwise at {chk.n} ticks (state and outputs); "
          f"{np.mean(bp['ms']['kernel']) * 1e3:.2f} us/launch; fired "
          f"{bp['fired']} [{card}]")
    records = [compact_record("fused_prefix_fifo_emit", bp["ticks"],
                              chk.worst, float(np.mean(bp["ms"]["kernel"])),
                              chk.plain_ms, bp["read"], bp["written"])]
    policy, kw, _ = MARKET_RUNS["e"]
    mcfg = market_cfg(P, **kw)
    mplan = CC.derive_plan(mcfg, market["specs"], market["arr"])
    meng = E.Engine(mcfg, device=dev, policies=PolicySet((policy,)))
    mchk = Checker(meng)
    QC = min(mcfg.queue_capacity, mcfg.max_placements_per_tick)

    def cost(before, after, rows, counts, t):
        return tick_cost_delay(before, after, rows, counts, t,
                               mcfg.record_trace, QC)
    sp = sampled_kernel_pass(E, mchk, meng, init_state(
        mcfg, market["specs"], device=dev, plan=mplan),
        first_ticks(market["chunks"], n), picks, QC, cost)
    print(f"phase 5d: market run (e) on the compact layout (node columns "
          f"{mplan.node}: the trader's contract totals), first {n} ticks: "
          f"fused_prefix_delay_expire == plain bitwise at {mchk.n} ticks; "
          f"{np.mean(sp['kernel_ms']) * 1e3:.2f} us/launch; attached "
          f"{sp['fired']['attached']}, expired {sp['fired']['expired']} "
          f"[{card}]")
    records.append(compact_record(
        "fused_prefix_delay_expire", sp["ticks"], mchk.worst,
        float(np.mean(sp["kernel_ms"])), mchk.plain_ms, sp["read"],
        sp["written"], sp["ops"]))
    return dict(records=records)


def phase_compact_faults(P, E, card, dev, churn, market):
    """Phase 5e: the faults forms on the compact layout. bench_faults's
    compact cell (bench.py:2990-3001) at its own 32 clusters, through
    ``run_chunks``: retries narrowed to int8, the bench's gates (kills and
    requeues, zero drops with the narrow overflow total, conservation, 490
    launches) and ``to_wide`` bitwise the wide churn run (4k); at 4,096
    clusters the first 60 ticks through the faults form and its tap form,
    == plain at sampled ticks, every launch timed; and the first 30 ticks
    of DELAY, FFD and gavel with churn at the quick market shape, whole
    runs == plain."""
    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation,
    )

    cfg = faults_cfg(P)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(FAULTS_C)]
    chunks, n_ticks, arr = faults_stream(E, FAULTS_C, arrivals=True)
    plan = CC.derive_plan(cfg, specs, arr)
    if dict(plan.queue)["retries"] != "int8":
        raise AssertionError(f"phase 5e: retries stored as "
                             f"{dict(plan.queue)['retries']}")
    engine = E.Engine(cfg, device=dev)
    out, _, counts = counted_run(engine, init_state(cfg, specs, device=dev,
                                                    plan=plan), chunks,
                                 "fused_prefix_fifo_faults")
    kills, requeues = int(out.faults.kills.sum()), int(
        out.faults.requeues.sum())
    drops = check_gates(out, n_ticks, cfg.tick_ms, FAULTS_C * FAULTS_JOBS,
                        0.0, "phase 5e")[1]
    check_conservation(out)
    if not (kills and requeues) or max_abs_diff(CC.to_wide(out),
                                                churn["final"]):
        raise AssertionError(f"phase 5e: {kills} kills, {requeues} "
                             f"requeues; to_wide against the wide run")
    print(f"phase 5e: bench_faults's compact cell, {FAULTS_C} clusters, "
          f"{n_ticks} ticks: kills {kills}, requeues {requeues}, drops "
          f"{drops}, conservation ok, launches "
          f"{counts['fused_prefix_fifo_faults']}, to_wide bitwise the wide "
          f"churn run (4k) [{card}]")
    wide_chunks, _, warr = faults_stream(E, FAULTS_WIDE_C, arrivals=True)
    wspecs = [P.uniform_cluster(c + 1, 5) for c in range(FAULTS_WIDE_C)]
    wplan = CC.derive_plan(cfg, wspecs, warr)
    chk = Checker(engine)
    cost, shared = cost_of("fifo_faults", engine)
    n = COMPACT_CHURN_TICKS
    picks = set(np.linspace(0, n - 1, COMPACT_SAMPLES).astype(int).tolist())
    sp = tap_pass(chk, engine, init_state(cfg, wspecs, device=dev,
                                          plan=wplan),
                  chunk_feeds(wide_chunks, dev, n), picks, cost, shared,
                  both=True)
    print(f"phase 5e: churn at {FAULTS_WIDE_C} clusters on the compact "
          f"layout, first {n} ticks: fused_prefix_fifo_faults and its tap "
          f"form == plain bitwise at {chk.n} comparisons; "
          f"{np.mean(sp['untapped_ms']) * 1e3:.2f} us/launch (tap "
          f"{np.mean(sp['kernel_ms']) * 1e3:.2f}) [{card}]")
    qc_, qj = MARKET_QUICK
    ch_q = first_ticks(market_stream(E, qc_, qj, quick=True)[0],
                       PLANE_CHURN_TICKS)
    qarr = market_stream(E, qc_, qj, quick=True, arrivals=True)[3]
    for policy in ("delay", "ffd", "gavel"):
        qcfg = market_cfg(P, quick=True, faults=churn_faults(P))
        qspecs = market_specs(P, qc_)
        eng = E.Engine(qcfg, device=dev, policies=PolicySet((policy,)))
        whole_run_against_plain(E, eng, init_state(
            qcfg, qspecs, device=dev, plan=CC.derive_plan(qcfg, qspecs,
                                                          qarr)),
            ch_q, f"{policy} with churn, compact")
    print(f"phase 5e: DELAY, FFD and gavel with churn at the quick market "
          f"shape on the compact layout, {PLANE_CHURN_TICKS} ticks each: "
          f"kernel == plain [{card}]")
    return dict(records=tap_pair_records(chk, "fused_prefix_fifo_faults",
                                         sp["ticks"], sp))


def phase_compact_config4(P, E, card, dev, market, run_a):
    """Phase 5f: BASELINE config 4 (bench_sinkhorn's world, 4,096 x 400,
    700 ticks) on the compact layout through ``run_chunks``: non-terminal,
    its node columns in the plan's dtype for the trader's contract
    totals. The bench's gates (zero drops, the narrow overflow total
    among them; 85% of all jobs placed; 1,000 virtual nodes), 700
    launches, and ``to_wide`` bitwise run (a)'s final state (4d)."""
    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        check_conservation, total_drops,
    )

    policy, kw, _ = MARKET_RUNS["a"]
    cfg = market_cfg(P, **kw)
    plan = CC.derive_plan(cfg, market["specs"], market["arr"])
    engine = E.Engine(cfg, device=dev, policies=PolicySet((policy,)))
    s0 = init_state(cfg, market["specs"], device=dev, plan=plan)
    kernel = fused_tick.host_params(engine, engine._default_params)[
        "kernel"].name
    out, first_s, counts = counted_run(engine, s0, market["chunks"], kernel)
    drops = total_drops(out)
    placed = int(out.placed_total.sum())
    n_jobs = MARKET_C * MARKET_JOBS
    vnodes = int(out.node_active[:, cfg.max_nodes:].sum())
    check_conservation(out)
    if any(drops.values()) or placed < MARKET_FLOOR * n_jobs or \
            vnodes < VNODE_FLOOR:
        raise AssertionError(f"phase 5f: drops {drops}, placed {placed}, "
                             f"vnodes {vnodes}")
    d = max_abs_diff(CC.to_wide(out), run_a["final"])
    if d:
        raise AssertionError(f"phase 5f: to_wide differs from run (a) ({d})")
    walls, h2d_s, _ = timed_runs(engine, s0, market["chunks"], 0, 1)
    print(f"phase 5f: config 4 on the compact layout (plan "
          f"{plan.describe()}): placed {placed} of {n_jobs} "
          f"({placed / n_jobs:.4f}), virtual nodes {vnodes}, drops {drops}, "
          f"conservation ok, launches {counts[kernel]}, to_wide bitwise run "
          f"(a)'s final state; state {CC.state_nbytes(s0)} B against "
          f"{CC.state_nbytes(init_state(cfg, market['specs'], device=dev))} "
          f"B wide; wall {walls[0]:.4f} s ({placed / walls[0]:.1f} jobs/s; "
          f"run (a) min {run_a['wall_min_s']:.4f} s), first run "
          f"{first_s:.4f} s [{card}]")


# --------------------------------------------------------------------------
# 6: event-compressed time (Engine.run_compressed) and the Borg replay
# --------------------------------------------------------------------------

def drive(engine, state, chunks, leap, mbuf=None):
    """``state`` through ``chunks``, chunk ``i`` by ``run_compressed`` where
    ``leap[i]`` and by ``run_chunks`` otherwise (the buffer carried over);
    returns the state, the buffer, the ticks executed (a dense chunk's
    every tick), the probe reads the compressed chunks should make (one
    an executed tick without arrivals: every tick with arrivals executes
    and skips its probe), the leap histogram and the series chunk by
    chunk."""
    from multi_cluster_simulator_tpu_torch.core.state import LEAP_BUCKETS

    res = dict(executed=0, probed=0, series=[],
               leaps=np.zeros(LEAP_BUCKETS, np.int64))
    record = engine.cfg.record_metrics
    for ch, comp in zip(chunks, leap):
        n = ch.rows.shape[0]
        if comp:
            out = engine.run_compressed(state, ch, n, None, mbuf)
            stats = out[2 if record else 1]
            res["executed"] += int(stats.ticks_executed)
            res["probed"] += int(stats.ticks_executed) - int(
                ch.counts[:n].any(axis=1).sum())
            res["leaps"] += stats.leaps.cpu().numpy()
        else:
            out = engine.run_chunks(state, [ch], None, mbuf)
            res["executed"] += n
        out = out if isinstance(out, tuple) else (out,)
        state = out[0]
        if record:
            res["series"].append(out[1])
    res.update(state=state, mbuf=mbuf)
    return res


def counted_drive(engine, s0, chunks, leap, kernel, plane=False):
    """A counted run through ``drive`` from a copy of ``s0`` (with a fresh
    buffer with ``plane``): every launch count and the engine's probe
    reads set to 0 just before, read just after; ``kernel`` must have
    launched once an executed tick and no other kernel at all, and the
    probe read once an executed tick without arrivals of the compressed
    chunks."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D

    state = clone_state(s0)
    mb = D.metrics_init(state) if plane else None
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    engine.probe_reads = 0
    w0 = time.perf_counter()
    res = drive(engine, state, chunks, leap, mb)
    torch.cuda.synchronize()
    res["wall"] = time.perf_counter() - w0
    res["counts"] = fused_tick.launch_counts()
    res["reads"] = engine.probe_reads
    check_launches(res["counts"], kernel, res["executed"], kernel)
    if res["reads"] != res["probed"]:
        raise AssertionError(f"{kernel}: {res['reads']} probe reads, "
                             f"{res['probed']} expected")
    return res


def drive_walls(engine, s0, chunks, leap, warmups, runs):
    """Walls of ``runs`` runs through ``drive`` after ``warmups``, each from
    a copy of ``s0``."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    walls = []
    for i in range(warmups + runs):
        state = clone_state(s0)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        drive(engine, state, chunks, leap)
        torch.cuda.synchronize()
        if i >= warmups:
            walls.append(time.perf_counter() - w0)
    return walls


class LaunchProbe:
    """Stands in for ``fused_tick.fused_prefix`` during one run on the card:
    each launch between a CUDA event pair with the card kept busy ahead of
    it, the tick's least bytes and operations counted by ``cost(before,
    after, rows, counts, t)``, and at the launches whose ordinal is in
    ``picks`` the kernel held against its plain version (``Checker``) on
    the state the run reached. Install it with ``with probe:``."""

    def __init__(self, chk, cost, picks):
        from multi_cluster_simulator_tpu_torch.core.state import clone_state
        from multi_cluster_simulator_tpu_torch.kernels import fused_tick

        self.ft, self.clone, self.chk = fused_tick, clone_state, chk
        self.cost, self.picks = cost, set(picks)
        self.real = fused_tick.fused_prefix
        self.evs, self.read, self.written, self.ops = [], 0, 0, 0

    def __enter__(self):
        self.ft.fused_prefix = self
        return self

    def __exit__(self, *exc):
        self.ft.fused_prefix = self.real

    def __call__(self, engine, state, rows, counts, t, params, host,
                 emit_returns=False, out=None, obs=None, windowed=False):
        if len(self.evs) in self.picks:  # compare launches the real one
            self.ft.fused_prefix = self.real
            try:
                self.chk.compare(state, rows, counts, t)
            finally:
                self.ft.fused_prefix = self
        before = self.clone(state)
        self.ft.prepare(engine, state, host, emit_returns, obs)
        ev = timed_launch_events()
        ev[0].record()
        res = self.real(engine, state, rows, counts, t, params, host,
                        emit_returns, out, obs, windowed)
        ev[1].record()
        self.evs.append(ev)
        r, w, o = self.cost(before, state, rows, counts, t)
        self.read, self.written, self.ops = (self.read + r,
                                             self.written + w, self.ops + o)
        return res

    def summary(self):
        torch.cuda.synchronize()
        n = max(len(self.evs), 1)
        return dict(kernel_ms=[a.elapsed_time(b) for a, b in self.evs],
                    read=int(self.read) / n, written=int(self.written) / n,
                    ops=int(self.ops) / n)


def probe_costs(E, engine, state, t: int, n: int):
    """The compressed driver's per-tick probe on ``state`` (the fingerprint,
    the next-event time, the vote and the packed pair, as ``run_compressed``
    enqueues them): microseconds a probe over ``n`` probes enqueued back to
    back with one synchronise at the end, and over ``n`` each followed by
    its host read. Their difference is what the read adds."""
    params = engine._default_params
    member = engine.member(params)
    sig0 = E._quiescence_sig(state)

    def probe():
        sig = E._quiescence_sig(state)
        return torch.stack([
            engine.ex.alland((sig == sig0).all()).to(torch.int32),
            engine.ex.allmin(E._next_event_t(state, t, engine.cfg, params,
                                             member))])
    out = []
    for read in (False, True):
        probe().tolist()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(n):
            p = probe()
            if read:
                p.tolist()
        torch.cuda.synchronize()
        out.append(1e6 * (time.perf_counter() - w0) / n)
    return out


def spread(n_exec: int, k: int) -> list[int]:
    """``k`` launch ordinals spread over ``n_exec`` launches."""
    return sorted({int(x) for x in np.linspace(0, max(n_exec - 1, 0), k)})


def leap_line(leaps) -> str:
    nz = np.flatnonzero(leaps)
    return str(leaps[:nz[-1] + 1].tolist() if len(nz) else [])


def walls_line(walls) -> str:
    return (f"min {min(walls):.4f} s, median {float(np.median(walls)):.4f} s"
            f" (walls {[round(w, 4) for w in walls]})")


def sparse_cfg(P, **kw):
    """bench_sparse_bursts' config (bench.py:2548-2552), as the port's."""
    base = dict(policy=P.PolicyKind.FIFO, queue_capacity=32, max_running=64,
                max_arrivals=SPARSE_BURSTS * SPARSE_PER_BURST,
                max_ingest_per_tick=16, parity=True, n_res=2, max_nodes=5,
                max_virtual_nodes=0)
    base.update(kw)
    return P.SimConfig(**base)


def sparse_stream(C):
    """bench_sparse_bursts' stream (bench.py:2554-2556): 12 bursts of 24
    jobs each 300 s, each within 20 s, and its tick count."""
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        bursty_stream,
    )

    arr = bursty_stream(C, SPARSE_BURSTS, SPARSE_PER_BURST,
                        SPARSE_INTERVAL_MS, SPARSE_WINDOW_MS, max_cores=8,
                        max_mem=6_000, max_dur_ms=60_000, seed=11)
    return arr, SPARSE_BURSTS * SPARSE_INTERVAL_MS // 1_000 + 70


def phase_sparse_bursts(P, E, card, dev):
    """Phases 6a and 6b: bench_sparse_bursts (bench.py:2510-2575) at its
    full shape, dense, compressed and by the ``auto`` choice, then with the
    metrics plane."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D
    from multi_cluster_simulator_tpu_torch.utils.trace import assert_no_drops

    cfg = sparse_cfg(P)
    arr, n_ticks = sparse_stream(SPARSE_C)
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), cfg.tick_ms)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(SPARSE_C)]
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, specs, device=dev)
    n_jobs = SPARSE_C * SPARSE_BURSTS * SPARSE_PER_BURST
    dense = [False] * len(chunks)
    comp = [True] * len(chunks)
    from multi_cluster_simulator_tpu_torch.tools.weak_scaling import (
        leapable,
    )

    auto = [leapable(ch.counts) for ch in chunks]
    kernel = "fused_prefix_fifo"

    d_out, d_first, _ = counted_run(engine, s0, chunks, kernel)
    placed, drops = check_gates(d_out, n_ticks, cfg.tick_ms, n_jobs, 0.99,
                                "6a dense")
    runs = {}
    for name, leap in (("compressed", comp), ("auto", auto)):
        res = counted_drive(engine, s0, chunks, leap, kernel)
        check_gates(res["state"], n_ticks, cfg.tick_ms, n_jobs, 0.99,
                    f"6a {name}")
        assert_no_drops(res["state"])
        d = max_abs_diff(d_out, res["state"])
        if d:
            raise AssertionError(f"6a: the {name} run differs from the "
                                 f"dense run (max |diff| {d})")
        runs[name] = res
    c = runs["compressed"]
    if not c["executed"] < n_ticks:
        raise AssertionError(f"6a: executed {c['executed']} of {n_ticks}")
    walls = {"dense": drive_walls(engine, s0, chunks, dense, SPARSE_WARMUPS,
                                  SPARSE_TIMED)}
    for name, leap in (("compressed", comp), ("auto", auto)):
        walls[name] = drive_walls(engine, s0, chunks, leap, SPARSE_WARMUPS,
                                  SPARSE_TIMED)
    chk = Checker(engine)
    cost = lambda b, a, r, k, t: (*tick_bytes(b, a, r, k, t, False), 0)  # noqa: E731
    with LaunchProbe(chk, cost, spread(c["executed"],
                                       COMPRESS_SAMPLES)) as probe:
        drive(engine, clone_state(s0), chunks, comp)
    sp = probe.summary()
    kms = float(np.mean(sp["kernel_ms"]))
    b_ms, b_by = bound(sp["read"], sp["written"])
    print(f"phase 6a: sparse bursts {SPARSE_C} clusters x "
          f"{SPARSE_BURSTS} x {SPARSE_PER_BURST} jobs, {n_ticks} ticks in "
          f"{len(chunks)} chunks: placed {placed} of {n_jobs} "
          f"({100 * placed / n_jobs:.3f}%), drops {drops}, conservation ok; "
          f"compressed and auto final states bitwise the dense run's "
          f"[{card}]")
    print(f"phase 6a: compressed: ticks executed {c['executed']} of "
          f"{n_ticks} simulated ({100 * c['executed'] / n_ticks:.2f}%), "
          f"host probe reads {c['reads']}, leap histogram (log2 buckets) "
          f"{leap_line(c['leaps'])}, launches {c['counts'][kernel]}; auto: "
          f"chunks compressed {sum(auto)} of {len(chunks)}, ticks executed "
          f"{runs['auto']['executed']}, probe reads {runs['auto']['reads']}")
    for name in ("dense", "compressed", "auto"):
        w = walls[name]
        print(f"phase 6a: {name} wall {walls_line(w)}; jobs/s "
              f"{placed / min(w):.1f} (min), "
              f"{placed / float(np.median(w)):.1f} (median); us per "
              f"simulated tick {1e6 * min(w) / n_ticks:.1f} [{card}]")
    ex = c["executed"]
    enq_us, read_us = probe_costs(E, engine, d_out, n_ticks * cfg.tick_ms,
                                  PROBE_REPS)
    arrival_ticks = int(sum(ch.counts.any(axis=1).sum() for ch in chunks))
    print(f"phase 6a: the probe of an executed tick without arrivals "
          f"({ex - arrival_ticks} of the {ex}; the {arrival_ticks} ticks "
          f"with arrivals skip it): {enq_us:.1f} us enqueued back to back, "
          f"{read_us:.1f} us with its host read ({read_us - enq_us:.1f} us "
          f"the read), over {PROBE_REPS} probes on the final state "
          f"[{card}]")
    print(f"phase 6a: compressed us per executed tick "
          f"{1e6 * min(walls['compressed']) / ex:.1f} against dense "
          f"{1e6 * min(walls['dense']) / n_ticks:.1f} per tick; kernel "
          f"fused_prefix_fifo on the executed ticks {kms * 1e3:.2f} us/launch"
          f" mean over {len(sp['kernel_ms'])} launches (CUDA events), "
          f"median {float(np.median(sp['kernel_ms'])) * 1e3:.2f}, == plain "
          f"at {chk.n} of them (plain {np.mean(chk.plain_ms):.3f} ms), "
          f"bound {b_ms * 1e3:.4f} us by {b_by} "
          f"({sp['read'] + sp['written']:.1f} B per launch) [{card}]")
    record = dict(kernel=fused_tick.KERNELS[kernel],
                  name="fused_prefix_fifo (6a, compressed)",
                  launches=c["counts"][kernel], worst=chk.worst, ms=kms,
                  plain=chk.plain_ms, bound=(b_ms, b_by))

    # 6b: the plane under compression
    dp = counted_drive(engine, s0, chunks, dense, kernel + "_tap",
                       plane=True)
    cp = counted_drive(engine, s0, chunks, comp, kernel + "_tap",
                       plane=True)
    d = max(max_abs_diff(d_out, dp["state"]), max_abs_diff(d_out,
                                                           cp["state"]))
    mb_d, mb_c = dp["mbuf"], cp["mbuf"]
    d = max(d, max_abs_diff(mb_d, mb_c.replace(leap_hist=mb_d.leap_hist)))
    if d:
        raise AssertionError(f"6b: the plane under compression differs "
                             f"(max |diff| {d})")
    if not np.array_equal(mb_c.leap_hist.cpu().numpy(), cp["leaps"]):
        raise AssertionError("6b: the buffer's leap histogram is not the "
                             "driver's")
    h = D.harvest(mb_c)
    if h["ticks"] != n_ticks or h["placed"] != placed:
        raise AssertionError(f"6b: harvest {h['ticks']} ticks, "
                             f"{h['placed']} placed")
    print(f"phase 6b: the plane on: compressed buffer bitwise the dense "
          f"run's (leap_hist aside: {leap_line(cp['leaps'])}, the driver's "
          f"own), both states bitwise the plane-off run's; harvest "
          f"{h['ticks']} ticks, {h['placed']} placed; tap form launches "
          f"dense {dp['counts'][kernel + '_tap']}, compressed "
          f"{cp['counts'][kernel + '_tap']}; walls of the counted runs "
          f"dense {dp['wall']:.4f} s, compressed {cp['wall']:.4f} s "
          f"[{card}]")
    return dict(record=record, executed=c["executed"], n_ticks=n_ticks,
                final=d_out)


def phase_churn_bursts(P, E, card, dev):
    """Phase 6c: churn_bursts_setup (bench.py:2467-2507; the port's copy in
    tools/chaos.py) at its full shape:
    the sparse bursts at 256 clusters, trace-mode churn in every burst,
    compressed on the derived compact plan, against the dense wide run."""
    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        assert_no_drops, check_conservation,
    )

    from multi_cluster_simulator_tpu_torch.tools.chaos import (
        churn_bursts_setup,
    )

    cfg, specs, arr, n_ticks, events = churn_bursts_setup(quick=False)
    C = len(specs)
    sizes = [CHURN_BURSTS_CHUNK] * (n_ticks // CHURN_BURSTS_CHUNK)
    sizes += [n_ticks % CHURN_BURSTS_CHUNK] if n_ticks % CHURN_BURSTS_CHUNK \
        else []
    chunks = E.pack_arrivals_chunks(arr, sizes, cfg.tick_ms)
    engine = E.Engine(cfg, device=dev)
    kernel = "fused_prefix_fifo_faults"
    s_wide = init_state(cfg, specs, fault_events=events, device=dev)
    plan = CC.derive_plan(cfg, specs, arr)
    s_comp = init_state(cfg, specs, plan=plan, fault_events=events,
                        device=dev)
    dense, d_wall, _ = counted_run(engine, s_wide, chunks, kernel)
    comp = [True] * len(chunks)
    res = counted_drive(engine, s_comp, chunks, comp, kernel)
    out = res["state"]
    d = max_abs_diff(dense, CC.to_wide(out))
    if d:
        raise AssertionError(f"6c: compact compressed differs from the "
                             f"dense wide run (max |diff| {d})")
    n_jobs = C * SPARSE_BURSTS * SPARSE_PER_BURST
    kills = int(dense.faults.kills.sum())
    placed = int(dense.placed_total.sum())
    if kills <= 0 or not res["executed"] < n_ticks:
        raise AssertionError(f"6c: kills {kills}, executed "
                             f"{res['executed']} of {n_ticks}")
    if placed < 0.99 * n_jobs:
        raise AssertionError(f"6c: only {placed}/{n_jobs} placed")
    assert_no_drops(dense)
    assert_no_drops(out)
    check_conservation(dense)
    chk = Checker(engine)
    cost = lambda b, a, r, k, t: tick_cost_faults(b, a, r, k, t, False)  # noqa: E731
    with LaunchProbe(chk, cost, spread(res["executed"],
                                       COMPRESS_SAMPLES)) as probe:
        drive(engine, clone_state(s_comp), chunks, comp)
    sp = probe.summary()
    kms = float(np.mean(sp["kernel_ms"]))
    b_ms, b_by = bound(sp["read"], sp["written"])
    print(f"phase 6c: churn bursts {C} clusters, {len(events)} trace "
          f"outages, {n_ticks} ticks in {len(chunks)} chunks of "
          f"{CHURN_BURSTS_CHUNK}: placed {placed} of {n_jobs}, kills "
          f"{kills}, requeues {int(dense.faults.requeues.sum())}, drops 0, "
          f"narrow overflow {CC.overflow_total(out)}; to_wide(compressed "
          f"compact) bitwise the dense wide run; ticks executed "
          f"{res['executed']} ({100 * res['executed'] / n_ticks:.2f}%), "
          f"probe reads {res['reads']}, leaps {leap_line(res['leaps'])}; "
          f"walls dense wide {d_wall:.4f} s, compressed compact "
          f"{res['wall']:.4f} s (one counted run each) [{card}]")
    print(f"phase 6c: kernel {kernel} (compact) on the executed ticks "
          f"{kms * 1e3:.2f} us/launch mean over {len(sp['kernel_ms'])}, == "
          f"plain at {chk.n} (plain {np.mean(chk.plain_ms):.3f} ms), bound "
          f"{b_ms * 1e3:.4f} us by {b_by} [{card}]")
    return dict(record=dict(
        kernel=fused_tick.KERNELS[kernel],
        name=f"{kernel} (6c, compact, compressed)",
        launches=res["counts"][kernel], worst=chk.worst, ms=kms,
        plain=chk.plain_ms, bound=(b_ms, b_by)))


def leap_classes(P, C):
    """tests/test_pipeline.py:245-291 ``_tc_scenarios``, each cluster
    pattern tiled to ``C`` clusters, as the port's: name -> (cfg,
    arrivals, specs). A sixth, the trader scenario with vnode expiry,
    puts the expire form and the expiry event under the driver."""
    from multi_cluster_simulator_tpu_torch.core.state import Arrivals

    base = dict(n_res=2, queue_capacity=16, max_running=32, max_arrivals=4,
                max_ingest_per_tick=8, max_nodes=5, max_virtual_nodes=0,
                record_metrics=True)
    t4 = [2_500, 3_500, 40_000, 60_500]

    def arrivals(t_rows, cores_rows, dur_rows, n=None):
        reps = C // len(t_rows)
        t = np.tile(np.asarray(t_rows, np.int32), (reps, 1))
        A = t.shape[1]
        n = [A] * len(t_rows) if n is None else n
        return Arrivals(
            t=t, id=np.arange(C * A, dtype=np.int32).reshape(C, A),
            cores=np.tile(np.asarray(cores_rows, np.int32), (reps, 1)),
            mem=np.full((C, A), 500, np.int32),
            gpu=np.zeros((C, A), np.int32),
            dur=np.tile(np.asarray(dur_rows, np.int32), (reps, 1)),
            n=np.tile(np.asarray(n, np.int32), reps))

    def tiled(*make):
        return [make[c % len(make)](c + 1) for c in range(C)]

    five = lambda i: P.uniform_cluster(i, 5)  # noqa: E731
    trader = dict(base, n_res=3, max_virtual_nodes=2)
    out = {
        "delay_parity": (
            P.SimConfig(policy=P.PolicyKind.DELAY, parity=True, **base),
            arrivals([t4], [[8, 2, 8, 2]], [[5_000] * 4]), tiled(five)),
        "delay_blocked": (
            P.SimConfig(policy=P.PolicyKind.DELAY, parity=True, **base),
            arrivals([t4], [[64, 2, 64, 2]], [[5_000] * 4]), tiled(five)),
        "ffd": (
            P.SimConfig(policy=P.PolicyKind.FFD, parity=False, **base),
            arrivals([t4], [[8, 2, 8, 2]], [[5_000] * 4]), tiled(five)),
        "fifo_borrowing": (
            P.SimConfig(policy=P.PolicyKind.FIFO, parity=True,
                        borrowing=True, **dict(base, max_nodes=10)),
            arrivals([[2_500, 2_600, 2_700, 40_000], [0] * 4],
                     [[14, 14, 14, 2], [1] * 4],
                     [[20_000, 20_000, 20_000, 5_000], [1_000] * 4],
                     n=[4, 0]),
            tiled(lambda i: P.uniform_cluster(i, 2, cores=16, memory=8_000),
                  lambda i: P.uniform_cluster(i, 10))),
    }
    for name, expire in (("delay_wave_trader", False),
                         ("delay_wave_trader_expire", True)):
        out[name] = (
            P.SimConfig(policy=P.PolicyKind.DELAY, parity=False,
                        delay_sweep="wave", trader=P.TraderConfig(
                            enabled=True, expire_virtual_nodes=expire),
                        **trader),
            arrivals([t4] * 2, [[8, 2, 8, 2]] * 2, [[5_000] * 4] * 2),
            tiled(five))
    return out


def phase_leap_classes(P, E, card, dev):
    """Phase 6d: the five leap classes (and the trader's with expiry),
    tiled to LEAP_CLASS_C clusters: compressed bitwise dense, the
    record_metrics series included."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    for name, (cfg, arr, specs) in leap_classes(P, LEAP_CLASS_C).items():
        ta = E.pack_arrivals_by_tick(arr, LEAP_CLASS_TICKS, cfg.tick_ms)
        engine = E.Engine(cfg, device=dev)
        s0 = init_state(cfg, specs, device=dev)
        fused_tick.reset_launches()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        d_state, d_ser = engine.run_chunks(clone_state(s0), [ta])
        torch.cuda.synchronize()
        d_wall = time.perf_counter() - w0
        d_counts = {k: v for k, v in fused_tick.launch_counts().items() if v}
        fused_tick.reset_launches()
        engine.probe_reads = 0
        w0 = time.perf_counter()
        c_state, c_ser, stats = engine.run_compressed(
            clone_state(s0), ta, LEAP_CLASS_TICKS)
        torch.cuda.synchronize()
        c_wall = time.perf_counter() - w0
        c_counts = {k: v for k, v in fused_tick.launch_counts().items() if v}
        executed = int(stats.ticks_executed)
        d = max(max_abs_diff(d_state, c_state), max_abs_diff(d_ser, c_ser))
        if d:
            raise AssertionError(f"6d {name}: compressed differs from dense "
                                 f"(max |diff| {d})")
        arrival_ticks = int(ta.counts.any(axis=1).sum())
        if sum(c_counts.values()) != executed or \
                sum(d_counts.values()) != LEAP_CLASS_TICKS or \
                engine.probe_reads != executed - arrival_ticks:
            raise AssertionError(f"6d {name}: launches {d_counts} dense, "
                                 f"{c_counts} compressed, {executed} "
                                 f"executed, {engine.probe_reads} reads")
        if int(c_state.placed_total.sum()) <= 0:
            raise AssertionError(f"6d {name}: nothing placed")
        print(f"phase 6d: {name} x {LEAP_CLASS_C} clusters, "
              f"{LEAP_CLASS_TICKS} ticks: compressed == dense bitwise, the "
              f"series too; executed {executed}, leaps "
              f"{leap_line(stats.leaps.cpu().numpy())}, placed "
              f"{int(c_state.placed_total.sum())}, vnodes "
              f"{int(c_state.node_active[:, cfg.max_nodes:].sum())}; "
              f"launches {c_counts} (dense {d_counts}); walls dense "
              f"{d_wall:.4f} s, compressed {c_wall:.4f} s [{card}]")


def start_borg_sample():
    """Start BASELINE config 5's sample in a process of its own, beside the
    build and the earlier phases: tools/make_borg_sample.py ``ensure()``
    generates it from a fixed seed (nothing is fetched), the port's
    ``workload/borg.py load_borg`` parses it, and the joined jobs go to
    ``BORG_JOBS_NPZ``; its one line of output gives the seconds of each.
    Phase 6e waits for it; ``main`` stops it on every way out."""
    code = (
        "import json, os, time\n"
        "import numpy as np\n"
        "t0 = time.perf_counter()\n"
        "from tools.make_borg_sample import ensure\n"
        "path = ensure()\n"
        "t1 = time.perf_counter()\n"
        "from multi_cluster_simulator_tpu_torch.workload.borg import "
        "load_borg\n"
        "jobs = load_borg(path)\n"
        "t2 = time.perf_counter()\n"
        f"os.makedirs(os.path.dirname({BORG_JOBS_NPZ!r}), exist_ok=True)\n"
        f"np.savez({BORG_JOBS_NPZ!r}, t_us=jobs.t_us, cpus=jobs.cpus, "
        "mem=jobs.mem, dur_us=jobs.dur_us, n_events=jobs.n_events)\n"
        "print(json.dumps({'build_s': t1 - t0, 'parse_s': t2 - t1, "
        "'path': path}))\n")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def phase_borg_replay(P, E, card, dev, sample):
    """Phase 6e: BASELINE config 5, bench_borg_replay (bench.py:1431-1520)
    at its bench shape: the generated sample's jobs dealt over the
    clusters, FFD serial, each 400-tick chunk dense or compressed by the
    ``auto`` choice."""
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        assert_no_drops, check_conservation,
    )
    from multi_cluster_simulator_tpu_torch.workload.borg import (
        BorgJobs, to_arrivals,
    )

    w0 = time.perf_counter()
    out, err = sample.communicate(timeout=BORG_SAMPLE_TIMEOUT_S)
    if sample.returncode != 0:
        raise RuntimeError(f"6e: the sample's build failed:\n{err[-4000:]}")
    waited = time.perf_counter() - w0
    times = json.loads(out.strip().splitlines()[-1])
    z = np.load(BORG_JOBS_NPZ)
    jobs = BorgJobs(t_us=z["t_us"], cpus=z["cpus"], mem=z["mem"],
                    dur_us=z["dur_us"], n_events=int(z["n_events"]))
    if len(jobs) < 48:
        raise AssertionError(f"6e: {len(jobs)} replayable jobs")
    C = 4096
    while C > 1 and len(jobs) // C < 48:
        C //= 2
    jobs_per = min(len(jobs) // C, 4096)
    native_span_ms = max(int(jobs.t_us[-1] - jobs.t_us[0]) // 1000, 1)
    time_scale = max(native_span_ms / 750_000.0, 1.0)
    w1 = time.perf_counter()
    arr, meta = to_arrivals(jobs, C, jobs_per, max_cores=32, max_mem=24_000,
                            time_scale=time_scale)
    cfg = P.SimConfig(policy=P.PolicyKind.FFD, parity=False,
                      max_placements_per_tick=32, queue_capacity=128,
                      max_running=max(jobs_per + 8, 64),
                      max_arrivals=jobs_per, max_ingest_per_tick=32,
                      max_nodes=5, max_virtual_nodes=0, n_res=2,
                      ffd_sweep="serial")
    specs = [P.uniform_cluster(c + 1, 5) for c in range(C)]
    n_ticks = meta["span_ms"] // cfg.tick_ms + 200
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), cfg.tick_ms)
    pack_s = time.perf_counter() - w1
    from multi_cluster_simulator_tpu_torch.tools.weak_scaling import (
        leapable,
    )

    auto = [leapable(ch.counts) for ch in chunks]
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, specs, device=dev)
    kernel = "fused_prefix_ffd"
    res = counted_drive(engine, s0, chunks, auto, kernel)
    out_s = res["state"]
    total = meta["rows_used"]
    placed = int(out_s.placed_total.sum())
    if placed < 0.95 * total:
        raise AssertionError(f"6e: only {placed}/{total} replayed jobs "
                             "placed")
    assert_no_drops(out_s)
    check_conservation(out_s)
    dense = [False] * len(chunks)
    if any(auto):  # the compressed chunks bitwise the dense run
        d_res = counted_drive(engine, s0, chunks, dense, kernel)
        d = max_abs_diff(d_res["state"], out_s)
        if d:
            raise AssertionError(f"6e: auto differs from dense (max |diff| "
                                 f"{d})")
    walls = drive_walls(engine, s0, chunks, auto, REPLAY_WARMUPS,
                        REPLAY_TIMED)
    chk = Checker(engine)
    picks, peak = pick_ticks(chunks, REPLAY_SAMPLES)
    sp = sampled_kernel_pass(E, chk, engine, s0, chunks, picks,
                             cfg.max_placements_per_tick)
    if max_abs_diff(sp["state"], out_s):
        raise AssertionError("6e: the sampled pass's final state differs "
                             "from the counted run's")
    kms = float(np.mean(sp["kernel_ms"]))
    b_ms, b_by = bound(sp["read"], sp["written"], sp["ops"])
    print(f"phase 6e: Borg replay (BASELINE config 5): sample built in "
          f"{times['build_s']:.1f} s and parsed in {times['parse_s']:.1f} s "
          f"(its own process, beside the earlier phases; waited "
          f"{waited:.1f} s for it here), {jobs.n_events} events, "
          f"{len(jobs)} jobs; dealt over {C} clusters x {jobs_per} "
          f"(rows used {total}), time_scale {time_scale:.3f}, span "
          f"{meta['span_ms']} ms, {n_ticks} ticks in {len(chunks)} chunks "
          f"(K {[ch.rows.shape[2] for ch in chunks]}), packed in "
          f"{pack_s:.1f} s; chunks compressed by auto {sum(auto)} of "
          f"{len(chunks)} [{card}]")
    print(f"phase 6e: placed {placed} of {total} "
          f"({100 * placed / total:.3f}%), drops 0, conservation ok, "
          f"launches {res['counts'][kernel]}, ticks executed "
          f"{res['executed']}, probe reads {res['reads']}; jobs/s "
          f"{placed / min(walls):.1f} (min of {len(walls)}), "
          f"{placed / float(np.median(walls)):.1f} (median); wall "
          f"{walls_line(walls)} [{card}]")
    print(f"phase 6e: kernel {kernel} (serial) {kms * 1e3:.2f} us/launch "
          f"mean over {len(sp['kernel_ms'])} launches (CUDA events), == "
          f"plain at {chk.n} sampled ticks (the peak {peak} among them; "
          f"plain {np.mean(chk.plain_ms):.3f} ms), bound (tick_cost_ffd) "
          f"{b_ms * 1e3:.4f} us by {b_by} ({sp['read'] + sp['written']:.1f}"
          f" B, {sp['ops']:.1f} operations per launch) [{card}]")
    return dict(record=dict(
        kernel=fused_tick.KERNELS[kernel],
        name=f"{kernel} (6e, serial, Borg replay)",
        launches=res["counts"][kernel], worst=chk.worst, ms=kms,
        plain=chk.plain_ms, bound=(b_ms, b_by)), cfg=cfg, final=out_s)


# --------------------------------------------------------------------------
# phase 7: checkpoint and preemption (core/checkpoint.py, core/preempt.py),
# and the phase-prefix ablation (Engine.run_prefix, tools/profile_capture)
# --------------------------------------------------------------------------

CKPT_DIR = "build/phase7"  # the phase's checkpoint files and trace
CKPT_CUTS = (400, 800, 1200)  # 7a's inner chunk boundaries of the headline
CKPT_PAIRS = 3  # 7a's interleaved walls without and with a save a boundary
CKPT_COMPACT_CUT = 800  # 7b
CKPT_SPARSE_CUT = 400  # 7c: between bursts 2 and 3 (300 s apart)
CHILD_HOLD_S = 300  # 7d: how long the child waits for the signal
CKPT_CPU_C = 64  # 7d: the width of the checkpoint the CPU writes
PREFIX_TICKS, PREFIX_TIMED, PREFIX_WARMUPS = 150, 2, 1  # 7e's ablation
TRACE_TICKS = 50  # 7e's trace session


def headline_world(P, E, C=None):
    """The headline's config, specs, stream and tick count (4a's) at
    ``C`` clusters (the headline's own by default)."""
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    C = HEADLINE_C if C is None else C
    cfg = headline_cfg(P)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(C)]
    arr = uniform_stream(C, JOBS, HORIZON_MS, max_cores=8, max_mem=6_000,
                         max_dur_ms=60_000, seed=9)
    return cfg, specs, arr, HORIZON_MS // cfg.tick_ms + 70


def chunks_from(E, arr, cfg, n_ticks: int, start: int = 0):
    """The chunks of ticks ``[start, n_ticks)`` (``start`` a chunk
    boundary), bucketed from the cut as a resuming driver buckets them."""
    sizes = chunk_sizes(n_ticks)[start // CHUNK:]
    return E.pack_arrivals_chunks(arr, sizes, cfg.tick_ms, start=start)


def ckpt_path(name: str) -> str:
    import os

    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, name)
    for p in (path, path + ".tmp", path + ".final"):
        if os.path.exists(p):
            os.remove(p)
    return path


def timed_saves(preempt, log: list):
    """A ``save_fn`` for AsyncCheckpointer that times each save on the
    writer thread (serialize, write, fsync, rename) into ``log``."""
    def save(path, state, **kw):
        w0 = time.perf_counter()
        preempt.save_run(path, state, **kw)
        log.append(time.perf_counter() - w0)
    return save


def saved_run(engine, state, chunks, cks: dict, done: int = 0):
    """``state`` through ``chunks`` chunk by chunk, submitting the state at
    every boundary before the last to ``cks[tick]`` (or to ``cks[None]``
    for every boundary); returns the state and the µs each submit held the
    dispatching thread."""
    submit_us = []
    for i, ch in enumerate(chunks):
        state = engine.run_chunks(state, [ch])
        done += ch.rows.shape[0]
        if i == len(chunks) - 1:
            break
        ck = cks.get(done, cks.get(None))
        if ck is not None:
            w0 = time.perf_counter()
            ck.submit(state, meta={"chunk_idx": i + 1, "dense_ticks": done})
            submit_us.append(1e6 * (time.perf_counter() - w0))
    return state, submit_us


def phase_ckpt_headline(P, E, card, dev, head):
    """Phase 7a: the headline cut at each inner chunk boundary (400, 800,
    1200 ticks): one counted run saving through an AsyncCheckpointer at
    every boundary, each file loaded by ``load_run`` into a fresh template
    and resumed on the same engine over the chunks re-bucketed from the
    cut, bitwise 4a's uninterrupted run; the bytes, the µs a submit costs
    the dispatching thread, the writer's seconds a save, and the wall
    without and with a save at every boundary (interleaved pairs)."""
    import os

    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    cfg, specs, arr = headline_cfg(P), head["specs"], head["arr"]
    chunks, final, n_ticks = head["chunks"], head["final"], head["n_ticks"]
    engine = E.Engine(cfg, device=dev)
    pd = preempt.policy_digest_for(cfg)
    s0 = init_state(cfg, specs, device=dev)
    saves = []
    cks = {b: preempt.AsyncCheckpointer(
        ckpt_path(f"headline_{b}.ckpt"), cfg=cfg, plan=None,
        policy_digest=pd, tick_ms=cfg.tick_ms,
        save_fn=timed_saves(preempt, saves)) for b in CKPT_CUTS}
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    out, submit_us = saved_run(engine, clone_state(s0), chunks, cks)
    torch.cuda.synchronize()
    check_launches(fused_tick.launch_counts(), "fused_prefix_fifo", n_ticks,
                   "phase 7a")
    for ck in cks.values():
        ck.close()
    if max_abs_diff(out, final):
        raise AssertionError("phase 7a: the run with saves differs from 4a")
    nbytes = {}
    for b in CKPT_CUTS:
        path = cks[b].path
        nbytes[b] = os.path.getsize(path)
        rc = preempt.load_run(path, init_state(cfg, specs, device=dev),
                              cfg=cfg, plan=None, policy_digest=pd)
        if rc.tick != b or rc.meta["ticks_executed"] != b:
            raise AssertionError(f"phase 7a: cursors {rc.meta} at {b}")
        rest = chunks_from(E, arr, cfg, n_ticks, b)
        fused_tick.reset_launches()
        res = engine.run_chunks(rc.state, rest)
        torch.cuda.synchronize()
        check_launches(fused_tick.launch_counts(), "fused_prefix_fifo",
                       n_ticks - b, f"phase 7a resumed at {b}")
        d = max_abs_diff(res, final)
        if d:
            raise AssertionError(f"phase 7a: resumed at tick {b}, the final "
                                 f"state differs (max |diff| {d})")
    walls = {"without": [], "with": []}
    wall_saves = []
    ck = preempt.AsyncCheckpointer(
        ckpt_path("headline_every.ckpt"), cfg=cfg, plan=None,
        policy_digest=pd, tick_ms=cfg.tick_ms,
        save_fn=timed_saves(preempt, wall_saves))
    pair_submit = []
    for _ in range(CKPT_PAIRS):
        for name, cks_ in (("without", {}), ("with", {None: ck})):
            state = clone_state(s0)
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            state, us = saved_run(engine, state, chunks, cks_)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - w0)
            ck.flush()  # outside the timer, as bench.py's overhead run
            pair_submit += us
    ck.close()
    wo, wi = min(walls["without"]), min(walls["with"])
    print(f"phase 7a: headline {HEADLINE_C} clusters, {n_ticks} ticks, "
          f"saved through AsyncCheckpointer at ticks {list(CKPT_CUTS)}, "
          f"launches {n_ticks} in the saving run; each file loaded into a "
          f"fresh template and resumed on the same engine: final state "
          f"bitwise 4a's at every cut [{card}]")
    print(f"phase 7a: checkpoint bytes (wide headline state, header "
          f"included) {nbytes[CKPT_CUTS[0]]}; submit (one packing copy and "
          f"an event on the dispatching thread) {np.mean(submit_us):.1f} us "
          f"mean of {len(submit_us)}, {np.mean(pair_submit):.1f} us over "
          f"the timed runs' {len(pair_submit)}; writer thread (serialize, "
          f"write, fsync, rename) {np.mean(saves):.4f} s a save, mean of "
          f"{len(saves)} (max {max(saves):.4f}) [{card}]")
    print(f"phase 7a: headline wall without saves "
          f"{walls_line(walls['without'])}; with a save at every boundary "
          f"{walls_line(walls['with'])}; "
          f"with / without (min) {wi / wo:.4f} ({100 * (wi / wo - 1):+.2f}%;"
          f" bench.py records this overhead and does not gate it) [{card}]")
    return dict(nbytes=nbytes[CKPT_CUTS[0]], submit_us=submit_us,
                pair_submit_us=pair_submit, save_s=saves + wall_saves,
                walls=walls)


def phase_ckpt_compact(P, E, card, dev, head):
    """Phase 7b: 5a's compact headline with the metrics plane, cut at tick
    800: the resumed state and buffer (and their harvest) bitwise the
    uninterrupted run's; a wide template is refused with the reference's
    layout message."""
    import os

    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.obs import device as D

    cfg, specs, arr = headline_cfg(P), head["specs"], head["arr"]
    n_ticks = head["n_ticks"]
    plan = CC.derive_plan(cfg, specs, arr)
    engine = E.Engine(cfg, device=dev)
    pd = preempt.policy_digest_for(cfg)
    chunks = head["chunks"]
    s = init_state(cfg, specs, device=dev, plan=plan)
    straight, mb_s = engine.run_chunks(s, chunks, None, D.metrics_init(s))
    path = ckpt_path("compact_800.ckpt")
    ck = preempt.AsyncCheckpointer(path, cfg=cfg, plan=plan,
                                   policy_digest=pd, tick_ms=cfg.tick_ms)
    cut = CKPT_COMPACT_CUT // CHUNK
    s = init_state(cfg, specs, device=dev, plan=plan)
    s, mb = engine.run_chunks(s, chunks[:cut], None, D.metrics_init(s))
    ck.submit(s, mbuf=mb, meta={"chunk_idx": cut,
                                "dense_ticks": CKPT_COMPACT_CUT})
    ck.close()
    try:
        preempt.load_run(path, init_state(cfg, specs, device=dev), cfg=cfg,
                         plan=None, policy_digest=pd)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("phase 7b: a wide template loaded a compact "
                             "checkpoint")
    if "checkpoint layout: compact, expected: wide" not in refusal:
        raise AssertionError(f"phase 7b: refusal {refusal!r}")
    rc = preempt.load_run(path, init_state(cfg, specs, device=dev, plan=plan),
                          cfg=cfg, plan=plan, policy_digest=pd)
    if rc.mbuf is None:
        raise AssertionError("phase 7b: the buffer did not ride the file")
    out, mb_r = engine.run_chunks(
        rc.state, chunks_from(E, arr, cfg, n_ticks, CKPT_COMPACT_CUT), None,
        rc.mbuf)
    d = max(max_abs_diff(out, straight), max_abs_diff(mb_r, mb_s))
    if d or D.harvest(mb_r) != D.harvest(mb_s):
        raise AssertionError(f"phase 7b: the resumed compact run differs "
                             f"(max |diff| {d})")
    nbytes = os.path.getsize(path)
    print(f"phase 7b: compact headline with the plane cut at tick "
          f"{CKPT_COMPACT_CUT}: resumed state, buffer and harvest bitwise "
          f"the uninterrupted run's (placed {D.harvest(mb_r)['placed']}); "
          f"checkpoint bytes (compact state and buffer) {nbytes} against "
          f"{CC.state_nbytes(out)} B of state; a wide template refused: "
          f"{refusal.split(' — ', 1)[-1]!r} [{card}]")
    return dict(nbytes=nbytes)


def phase_ckpt_sparse(P, E, card, dev):
    """Phase 7c: 6a's sparse bursts under ``run_compressed``, cut at the
    chunk boundary at tick 400, inside the quiet stretch between bursts:
    the resumed state bitwise the uninterrupted compressed run's, and
    ``ticks_executed`` and the leap histogram folded over the cut
    (``fold_cursors``) equal to the uninterrupted run's."""
    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )

    cfg = sparse_cfg(P)
    arr, n_ticks = sparse_stream(SPARSE_C)
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), cfg.tick_ms)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(SPARSE_C)]
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, specs, device=dev)
    cut = CKPT_SPARSE_CUT // CHUNK
    around = np.concatenate([chunks[cut - 1].counts[-10:],
                             chunks[cut].counts[:10]])
    if around.any():
        raise AssertionError("phase 7c: the cut is not in a quiet stretch")
    comp = [True] * len(chunks)
    whole = drive(engine, clone_state(s0), chunks, comp)
    path = ckpt_path("sparse_400.ckpt")
    ck = preempt.AsyncCheckpointer(path, cfg=cfg, plan=None,
                                   tick_ms=cfg.tick_ms)
    s, stats = engine.run_compressed(clone_state(s0), chunks[0],
                                     chunks[0].rows.shape[0])
    ck.submit(s, meta={"chunk_idx": cut, "leap_stats": [stats]})
    ck.close()
    rc = preempt.load_run(path, init_state(cfg, specs, device=dev), cfg=cfg,
                          plan=None)
    rest = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks)[cut:],
                                  cfg.tick_ms, start=CKPT_SPARSE_CUT)
    res = drive(engine, rc.state, rest, comp[cut:])
    d = max_abs_diff(res["state"], whole["state"])
    executed = rc.meta["ticks_executed"] + res["executed"]
    hist = np.zeros_like(whole["leaps"])
    hist[:len(rc.meta["leap_hist"])] += rc.meta["leap_hist"]
    hist += res["leaps"]
    if d or executed != whole["executed"] or not np.array_equal(
            hist, whole["leaps"]):
        raise AssertionError(f"phase 7c: resumed state |diff| {d}, executed "
                             f"{executed} against {whole['executed']}, "
                             f"leaps {hist} against {whole['leaps']}")
    print(f"phase 7c: sparse bursts {SPARSE_C} clusters compressed, cut at "
          f"tick {CKPT_SPARSE_CUT} (no arrivals within 10 ticks of it): "
          f"resumed state bitwise the uninterrupted run's; ticks executed "
          f"{rc.meta['ticks_executed']} before the cut + {res['executed']} "
          f"after = {executed}, the uninterrupted run's; leap histogram "
          f"{leap_line(hist)} folded equal [{card}]")


def child_cmd(path: str, dev, *extra: str) -> list:
    import os

    return [sys.executable, os.path.abspath(__file__), "--preempt-child",
            path, "--device", str(dev), *extra]


def phase_ckpt_preempt(P, E, card, dev, head):
    """Phase 7d: a child process (``chip_smoke.py --preempt-child``) runs
    7a's headline under ``PreemptionGuard`` and is sent SIGTERM once
    ``peek_checkpoint_t`` shows its first boundary saved: it must exit 75
    with the ``# preempted:`` line; a second child resumes the file to the
    end, bitwise 7a's uninterrupted run. Then a checkpoint the plain path
    writes on the CPU at 64 clusters resumes on the card's kernel,
    bitwise the card's uninterrupted run."""
    import os
    import signal

    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.checkpoint import (
        peek_checkpoint_t,
    )
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    root = os.path.dirname(os.path.abspath(__file__))
    path = ckpt_path("child.ckpt")
    w0 = time.perf_counter()
    child = subprocess.Popen(child_cmd(path, dev), cwd=root, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        seen = 0
        while child.poll() is None and time.perf_counter() - w0 < 600:
            if os.path.exists(path):
                seen = peek_checkpoint_t(path)
                if seen > 0:
                    break
            time.sleep(0.05)
        if not seen:
            raise AssertionError(f"phase 7d: the child saved nothing "
                                 f"(exit {child.poll()})")
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=CHILD_HOLD_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != preempt.EXIT_PREEMPTED or \
            "# preempted:" not in err:
        raise AssertionError(f"phase 7d: the child exited "
                             f"{child.returncode}: {err[-2000:]}")
    line = next(ln for ln in err.splitlines() if ln.startswith("# preempted:"))
    first_s = time.perf_counter() - w0
    w1 = time.perf_counter()
    res = subprocess.run(child_cmd(path, dev, "--resume"), cwd=root,
                         text=True,
                         capture_output=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"phase 7d: the resuming child exited "
                             f"{res.returncode}: {res.stderr[-2000:]}")
    cfg, specs, arr, n_ticks = headline_world(P, E)
    rc = preempt.load_run(path + ".final", init_state(cfg, specs,
                                                      device=dev), cfg=cfg)
    d = max_abs_diff(rc.state, head["final"])
    if d or rc.meta["ticks_executed"] != n_ticks:
        raise AssertionError(f"phase 7d: the resumed child's final state "
                             f"differs (max |diff| {d}; cursors {rc.meta})")
    print(f"phase 7d: child under PreemptionGuard saw SIGTERM after its "
          f"save at t={seen} ms and exited {child.returncode}: {line!r} "
          f"({first_s:.1f} s); the resuming child ran ticks "
          f"{seen // cfg.tick_ms}..{n_ticks} ({time.perf_counter() - w1:.1f}"
          f" s): final state bitwise 7a's uninterrupted run, ticks_executed "
          f"{rc.meta['ticks_executed']} [{card}]")

    # a checkpoint the plain path writes on the CPU resumes on the kernel
    cfg, specs, arr, n_ticks = headline_world(P, E, CKPT_CPU_C)
    chunks = E.pack_arrivals_chunks(arr, chunk_sizes(n_ticks), cfg.tick_ms)
    cpu = E.Engine(cfg, device="cpu")
    s = cpu.run_chunks(init_state(cfg, specs, device="cpu"), chunks[:1])
    path = ckpt_path("cpu_256.ckpt")
    preempt.save_run(path, s, meta={"chunk_idx": 1, "dense_ticks": CHUNK},
                     cfg=cfg, plan=None,
                     policy_digest=preempt.policy_digest_for(cfg))
    engine = E.Engine(cfg, device=dev)
    straight = engine.run_chunks(init_state(cfg, specs, device=dev), chunks)
    rc = preempt.load_run(path, init_state(cfg, specs, device=dev), cfg=cfg,
                          plan=None,
                          policy_digest=preempt.policy_digest_for(cfg))
    if rc.state.device.type != dev.type:
        raise AssertionError("phase 7d: load_run left the state off the card")
    torch.cuda.synchronize()
    fused_tick.reset_launches()
    out = engine.run_chunks(rc.state, chunks_from(E, arr, cfg, n_ticks,
                                                  CHUNK))
    torch.cuda.synchronize()
    check_launches(fused_tick.launch_counts(), "fused_prefix_fifo",
                   n_ticks - CHUNK, "phase 7d (CPU checkpoint)")
    d = max_abs_diff(out, straight)
    if d:
        raise AssertionError(f"phase 7d: the CPU checkpoint resumed on the "
                             f"card differs (max |diff| {d})")
    print(f"phase 7d: a checkpoint the plain path wrote on the CPU at "
          f"{CKPT_CPU_C} clusters, tick {CHUNK}, resumed on the card: "
          f"{n_ticks - CHUNK} launches of fused_prefix_fifo, final state "
          f"bitwise the card's uninterrupted run [{card}]")


def phase_prefix_ablation(P, E, card, dev, head):
    """Phase 7e: ``run_prefix`` on the headline's first 150 ticks at every
    phase limit k = 0..8 (1 warm-up, 2 timed: tools/profile_capture.py's
    ``phase_table``): the table with its routes; the FIFO kernel launched
    once a tick for k >= 5 and never below; k = 8 bitwise ``run``; and one
    ``start_trace`` session over 50 ticks whose artifact holds the
    ``tick.fused_prefix`` range and the kernel's name."""
    import json as _json
    import os
    import shutil

    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.tools import profile_capture as pc

    cfg, specs = headline_cfg(P), head["specs"]
    engine = E.Engine(cfg, device=dev)
    s0 = init_state(cfg, specs, device=dev)
    ta = E.pack_arrivals_by_tick(head["arr"], PREFIX_TICKS, cfg.tick_ms)
    table = pc.phase_table(engine, s0, ta, PREFIX_TICKS,
                           repeats=PREFIX_TIMED, warmups=PREFIX_WARMUPS)
    rows = table["rows"]
    kernel = engine.fused_provenance()["kernel"]
    for k, r in enumerate([rows[-1]] + rows[:-1]):
        want_route, want_launch = ((kernel, 1.0) if k >= 5 else ("plain", 0))
        if r["route"] != want_route or r["launches_per_tick"] != want_launch:
            raise AssertionError(f"phase 7e: prefix {k}: route "
                                 f"{r['route']}, launches a tick "
                                 f"{r['launches_per_tick']}")
        if not math.isfinite(r["ms_per_tick"]):
            raise AssertionError(f"phase 7e: prefix {k} timed {r}")
    full = engine.run(clone_state(s0), ta, PREFIX_TICKS)
    if max_abs_diff(full, table["last"]):
        raise AssertionError("phase 7e: run_prefix at 8 differs from run")
    for r in rows:
        print(f"phase 7e: {r['phase']:13s} {r['ms_per_tick']:8.4f} ms/tick "
              f"(cum {r['cum_ms_per_tick']:.4f}, {r['fraction']:.1%}), "
              f"bytes delta {r['prefix_bytes_delta']}, route {r['route']}, "
              f"launches a tick {r['launches_per_tick']:g} [{card}]")
    out_dir = os.path.join(CKPT_DIR, "trace")
    shutil.rmtree(out_dir, ignore_errors=True)
    arts = pc.capture_trace(engine, s0, ta, TRACE_TICKS, out_dir)
    text = "".join(open(a).read() for a in arts)
    if "tick.fused_prefix" not in text or kernel + "_kernel" not in text:
        raise AssertionError(f"phase 7e: the trace {arts} lacks the prefix "
                             f"range or the kernel {kernel}_kernel")
    events = _json.loads(text) if len(arts) == 1 else {}
    n_kern = sum(1 for e in events.get("traceEvents", [])
                 if kernel + "_kernel" in str(e.get("name", "")))
    print(f"phase 7e: run_prefix on the headline's first {PREFIX_TICKS} "
          f"ticks, min of {PREFIX_TIMED} after {PREFIX_WARMUPS} warm-up: "
          f"whole tick {table['full_ms']:.4f} ms; the kernel once a tick "
          f"from k = 5, never below; k = 8 bitwise run; trace over "
          f"{TRACE_TICKS} ticks {arts} ({len(text)} B) holds "
          f"tick.fused_prefix and {n_kern} events of {kernel}_kernel "
          f"[{card}]")
    return dict(rows=rows, full_ms=table["full_ms"])


def phase_ckpt_bytes(P, E, card, dev, states: dict):
    """The checkpoint bytes of the other configs' final states (config 4,
    config 5), each read back bitwise."""
    import os

    from multi_cluster_simulator_tpu_torch.core import checkpoint as ck

    for name, (cfg, state) in states.items():
        path = ckpt_path(f"{name}.ckpt")
        ck.save_state(state, path, cfg=cfg)
        back = ck.load_state(path, state, cfg=cfg)
        if max_abs_diff(back, state):
            raise AssertionError(f"phase 7: {name} did not round-trip")
        print(f"phase 7: checkpoint bytes of {name}'s final state "
              f"{os.path.getsize(path)} (read back bitwise) [{card}]")


def preempt_child(argv) -> int:
    """7d's child: the headline on the card under ``PreemptionGuard``,
    saving at every chunk boundary through an AsyncCheckpointer to PATH;
    at the first boundary it waits (up to ``CHILD_HOLD_S``) for the signal,
    so the parent's SIGTERM lands mid-run. ``--resume`` continues from
    PATH's cut to the end and saves the final state to PATH.final."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --preempt-child")
    ap.add_argument("path")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import multi_cluster_simulator_tpu_torch as P
    from multi_cluster_simulator_tpu_torch.core import engine as E
    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.state import init_state

    dev = torch.device(args.device)
    cfg, specs, arr, n_ticks = headline_world(P, E)
    engine = E.Engine(cfg, device=dev)
    pd = preempt.policy_digest_for(cfg)
    start, prior = 0, {}
    state = init_state(cfg, specs, device=dev)
    if args.resume:
        rc = preempt.load_run(args.path, state, cfg=cfg, plan=None,
                              policy_digest=pd)
        state, start, prior = rc.state, rc.tick, rc.meta
    ck = preempt.AsyncCheckpointer(args.path, cfg=cfg, plan=None,
                                   policy_digest=pd, tick_ms=cfg.tick_ms)
    done = start
    with preempt.PreemptionGuard() as guard:
        for ch in chunks_from(E, arr, cfg, n_ticks, start):
            state = engine.run_chunks(state, [ch])
            done += ch.rows.shape[0]
            meta = {"chunk_idx": done // CHUNK, "dense_ticks": done - start,
                    "prior": prior}
            if guard.triggered:
                guard.save_and_exit(ck, state, meta=meta)
            if done == n_ticks:
                break
            ck.submit(state, meta=meta)
            if not args.resume and done == CHUNK:
                ck.flush()
                w0 = time.perf_counter()
                while not guard.triggered and \
                        time.perf_counter() - w0 < CHILD_HOLD_S:
                    time.sleep(0.01)
                if guard.triggered:
                    guard.save_and_exit(ck, state, meta=meta)
    ck.close()
    preempt.save_run(args.path + ".final", state, meta=meta, cfg=cfg,
                     plan=None, policy_digest=pd, tick_ms=cfg.tick_ms)
    print(f"# preempt child: ran ticks {start}..{done}")
    return 0


# ---------------------------------------------------------------------------
# phases 8a-8e: the lane axis — tenant batches and env batches, each kernel
# launched once a tick over every lane, its parameters read per lane
# ---------------------------------------------------------------------------

def lane_flat(state):
    """A lane-stacked state's clusters end to end ([L C, ...] views) as one
    constellation, with lane 0's clock."""
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    return fused_tick._flat(state, (".t",)).replace(t=state.t[0])


def lane_sync():
    torch.cuda.synchronize()
    return time.perf_counter()


class LaneProbe:
    """Stands in for ``fused_tick.fused_prefix_lanes`` during one run on
    the card: each launch between a CUDA event pair with the card kept
    busy ahead of it, the tick's least bytes and operations counted by
    ``cost(before, after, rows, counts, t)`` on the batch's clusters end
    to end, and at the ticks whose ordinal is in ``picks`` the launch held
    against the plain per-lane loop (``fused_prefix_lanes_reference`` on
    the card, timed) on copies of the state the run reached, every leaf
    (and with the plane, every buffer and cursor leaf) bitwise. Install it
    with ``with probe:``."""

    def __init__(self, cost, picks):
        from multi_cluster_simulator_tpu_torch.core.state import clone_state
        from multi_cluster_simulator_tpu_torch.kernels import fused_tick

        self.ft, self.clone = fused_tick, clone_state
        self.cost, self.picks = cost, set(picks)
        self.real = fused_tick.fused_prefix_lanes
        self.evs, self.plain_ms = [], []
        self.read, self.written, self.ops, self.worst, self.n = 0, 0, 0, 0.0, 0

    def __enter__(self):
        self.ft.fused_prefix_lanes = self
        return self

    def __exit__(self, *exc):
        self.ft.fused_prefix_lanes = self.real

    def compare(self, engine, state, rows, counts, t, params, host, emit,
                obs):
        """The launch on a copy against the plain per-lane loop on
        another; raises on any difference. The comparison's launch is not
        counted."""
        saved = self.ft.launch_counts()
        ref = self.clone(state)
        ref_obs = None if obs is None else tuple(map(self.clone, obs))
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        _, *ref_io, _ = self.ft.fused_prefix_lanes_reference(
            engine, ref, rows, counts, t, params, host, emit, None, ref_obs)
        ev[1].record()
        got = self.clone(state)
        got_obs = None if obs is None else tuple(map(self.clone, obs))
        _, *io, _ = self.real(engine, got, rows, counts, t, params, host,
                              emit, None, got_obs)
        torch.cuda.synchronize()
        for k in self.ft.KERNELS.values():
            k.launches = saved[k.name]
        self.plain_ms.append(ev[0].elapsed_time(ev[1]))
        d = max_abs_diff(ref, got)
        if emit:
            d = max(d, io_diff(ref_io, io))
        if obs is not None:
            d = max(d, max_abs_diff(ref_obs[0], got_obs[0]),
                    max_abs_diff(ref_obs[1], got_obs[1]))
        if d:
            raise AssertionError(f"lane form differs from the plain per-lane "
                                 f"loop at t={t}: max |diff| {d}")
        self.worst, self.n = max(self.worst, d), self.n + 1

    def __call__(self, engine, state, rows, counts, t, params, host,
                 emit_returns=False, out=None, obs=None, windowed=False):
        if len(self.evs) in self.picks:
            self.compare(engine, state, rows, counts, t, params, host,
                         emit_returns, obs)
        before = self.clone(state)
        self.ft.prepare_lanes(engine, state, host, emit_returns, obs)
        ev = timed_launch_events()
        ev[0].record()
        res = self.real(engine, state, rows, counts, t, params, host,
                        emit_returns, out, obs, windowed)
        ev[1].record()
        self.evs.append(ev)
        L, C = state.arr_ptr.shape
        r, w, o = self.cost(lane_flat(before), lane_flat(state),
                            rows.view(L * C, *rows.shape[2:]),
                            counts.view(L * C), t)
        self.read, self.written, self.ops = (self.read + r, self.written + w,
                                             self.ops + o)
        return res

    def summary(self):
        torch.cuda.synchronize()
        n = max(len(self.evs), 1)
        return dict(kernel_ms=[a.elapsed_time(b) for a, b in self.evs],
                    read=int(self.read) / n, written=int(self.written) / n,
                    ops=int(self.ops) / n, plain_ms=self.plain_ms,
                    worst=self.worst, compared=self.n)


def lane_vs_one_lane(E, engine, state, rows, counts, t, params, reps):
    """The lane form's launch (``fused_prefix_lanes``) and the one-lane
    kernel's over the same L C clusters as one constellation
    (``fused_prefix`` on the clusters end to end, the lanes' shared
    parameters), each ``reps`` times on copies of ``state`` in turns, by
    CUDA events: (lane ms, one-lane ms) a launch. The launch counts are
    restored after."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    saved = fused_tick.launch_counts()
    L, C = state.arr_ptr.shape
    host = fused_tick.host_params(engine, engine.lane_params(params, L))
    p1 = fused_tick.lane(engine.lane_params(params, L), 0)
    host1 = fused_tick.host_params(engine, p1)
    rows1, counts1 = rows.view(L * C, *rows.shape[2:]), counts.view(L * C)
    lane_ms, one_ms = [], []
    for _ in range(reps):
        for form in ("lane", "one"):
            s = clone_state(state)
            if form == "lane":
                fused_tick.prepare_lanes(engine, s, host)
                ev = timed_launch_events()
                ev[0].record()
                fused_tick.fused_prefix_lanes(engine, s, rows, counts, t,
                                              params, host)
                ev[1].record()
                lane_ms.append(ev)
            else:
                s1 = lane_flat(s)
                fused_tick.prepare(engine, s1, host1)
                ev = timed_launch_events()
                ev[0].record()
                fused_tick.fused_prefix(engine, s1, rows1, counts1, t, p1,
                                        host1)
                ev[1].record()
                one_ms.append(ev)
    torch.cuda.synchronize()
    for k in fused_tick.KERNELS.values():
        k.launches = saved[k.name]
    return (float(np.mean([a.elapsed_time(b) for a, b in lane_ms])),
            float(np.mean([a.elapsed_time(b) for a, b in one_ms])))


def group_launches(engine, state, rows, counts, t, params, costs, reps):
    """Each kernel source's launch over its own lanes alone (the lane form
    with the other sources' lanes masked out), ``reps`` times on copies
    of ``state`` by CUDA events, and the least bytes and operations of the
    lanes it carries (``costs[lib](before, after, rows, counts, t,
    tesserae)`` on those lanes' clusters end to end; the scored source's
    table and tesserae lanes counted apart), and its plain version, the
    plain span lane by lane over the same lanes, timed once. Returns {lib:
    dict(ms, plain_ms, read, written, ops, lanes)}; the launch counts are
    restored after."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.utils.tree import tree_map

    saved = fused_tick.launch_counts()
    L, C = state.arr_ptr.shape
    lp = engine.lane_params(params, L)
    host = fused_tick.host_params(engine, lp)
    out = {}
    for g in host["groups"]:
        lib = g.kernels["kernel"].lib
        one = dict(host, groups=[g])
        evs = []
        for _ in range(reps):
            s = clone_state(state)
            fused_tick.prepare_lanes(engine, s, one)
            ev = timed_launch_events()
            ev[0].record()
            fused_tick.launch_lanes(engine, s, rows, counts, t, one)
            ev[1].record()
            evs.append(ev)
        after = clone_state(state)
        fused_tick.launch_lanes(engine, after, rows, counts, t, one)
        read = written = ops = 0
        mine = [i for i, spec in enumerate(host["specs"])
                if fused_tick.kernel_for(spec).lib == lib]
        s = clone_state(state)
        pev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pev[0].record()
        for i in mine:
            fused_tick.fused_prefix_reference(
                engine, fused_tick.lane(s, i), rows[i], counts[i], t,
                fused_tick.lane(lp, i), host["specs"][i])
        pev[1].record()
        for tess in (False, True):
            idx = [i for i in mine
                   if (host["specs"][i].kind == "tesserae") == tess]
            if not idx:
                continue
            ix = torch.tensor(idx, device=rows.device)

            def pick(x):
                if x.dtype == torch.uint32:  # no index kernel for uint32
                    return x.view(torch.int32)[ix].view(torch.uint32)
                return x[ix]
            b, a = (lane_flat(tree_map(pick, x)) for x in (state, after))
            r = rows[ix].reshape(len(idx) * C, *rows.shape[2:])
            c = counts[ix].reshape(-1)
            rd, wr, op = costs[lib](b, a, r, c, t, tess)
            read, written, ops = (read + int(rd), written + int(wr),
                                  ops + int(op))
        torch.cuda.synchronize()
        out[lib] = dict(ms=float(np.mean([a.elapsed_time(b)
                                          for a, b in evs])),
                        plain_ms=pev[0].elapsed_time(pev[1]),
                        read=read, written=written, ops=ops,
                        lanes=len(mine))
    for k in fused_tick.KERNELS.values():
        k.launches = saved[k.name]
    return out


def expect_lane_launches(counts, allowed, n_ticks, what):
    """Each kernel in ``allowed`` launched exactly ``n_ticks`` times (one
    launch a tick over every lane), every other kernel never."""
    want = {k: (n_ticks if k in allowed else 0) for k in counts}
    if counts != want:
        got = {k: v for k, v in counts.items() if v}
        raise AssertionError(f"{what}: launches {got}, want "
                             f"{ {k: n_ticks for k in allowed} }")


def tenant_world(P, E, dev, T, C, n_ticks, jobs, seed0=11):
    """bench.py bench_tenants' world (bench.py:2079-2250) as the port's: T
    tenants of C clusters, FIFO parity on lean shapes, a fault seed and a
    promotion threshold a tenant, the streams padded to the tenant-max K
    and stacked."""
    from multi_cluster_simulator_tpu_torch import tenancy
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = P.SimConfig(policy=P.PolicyKind.FIFO, parity=True, n_res=2,
                      queue_capacity=64, max_running=128, max_arrivals=64,
                      max_ingest_per_tick=64, max_nodes=5,
                      max_virtual_nodes=0)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(C)]
    tb = tenancy.TenantBatch(cfg, specs, device=dev)
    cells = []
    for i in range(T):
        cell = tenancy.default_tenant_params(cfg, pset=tb.engine.pset,
                                             fault_seed=i, device=dev)
        cells.append(cell.replace(policy=cell.policy.replace(
            max_wait_ms=torch.tensor(2_000 + 250 * i, dtype=torch.int32,
                                     device=dev))))
    tp = tenancy.stack_tenant_params(cells)
    tas = [E.pack_arrivals_by_tick(
        uniform_stream(C, jobs, n_ticks * cfg.tick_ms, 4, 2_000,
                       2 * cfg.tick_ms, seed=seed0 + i), n_ticks, cfg.tick_ms)
        for i in range(T)]
    k = max(ta.rows.shape[2] for ta in tas)
    tas = [tenancy.pad_tick_arrivals(ta, k) for ta in tas]
    return dict(cfg=cfg, specs=specs, tb=tb, tp=tp, tas=tas,
                sta=tenancy.stack_tick_arrivals(tas), jobs=T * C * jobs)


def cut_ticks(sta, n):
    from multi_cluster_simulator_tpu_torch.core.state import TickArrivals

    return TickArrivals(rows=np.ascontiguousarray(sta.rows[:, :n]),
                        counts=np.ascontiguousarray(sta.counts[:, :n]))


def phase_tenants(P, E, card, dev):
    """Phase 8a: bench_tenants' full shape (256 tenants x 2 clusters, 32
    ticks, 262,144 jobs) as one lane-stacked run: one FIFO launch a tick
    over all 512 clusters; every job placed, no drops; sampled tenants ==
    their standalone runs; the whole batch == the plain per-lane loop (the
    first ticks, every lane, the plane on: each tenant's buffer its own);
    batch and serial walls; the lane form's launch beside the one-lane
    launch over the same 512 clusters."""
    from multi_cluster_simulator_tpu_torch import tenancy
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    w = tenant_world(P, E, dev, TENANTS_T, TENANTS_C, TENANTS_TICKS,
                     TENANTS_JOBS)
    tb, tp, sta, T, NT = w["tb"], w["tp"], w["sta"], TENANTS_T, TENANTS_TICKS
    eng = tb.engine
    s0 = tb.init_stacked(tp)
    run = tb.run_fn(NT)
    run(clone_state(s0), sta, tp)  # warm-up: the kernel built and loaded
    out = clone_state(s0)
    w0 = lane_sync()
    fused_tick.reset_launches()
    out = run(out, sta, tp)
    wall = lane_sync() - w0
    counts = fused_tick.launch_counts()
    expect_lane_launches(counts, {"fused_prefix_fifo"}, NT, "8a")
    placed = tenancy.aggregate_placed(out)
    drops = tenancy.aggregate_drops(out)
    if placed != w["jobs"] or any(drops.values()):
        raise AssertionError(f"8a: placed {placed} of {w['jobs']}, drops "
                             f"{drops}")
    sampled = sorted({0, T // 3, 2 * T // 3, T - 1})
    for i in sampled:
        cell = tenancy.tenant_cell(tp, i)
        solo = eng.run(tenancy.init_tenant_state(w["cfg"], w["specs"], cell,
                                                 device=dev),
                       w["tas"][i], NT, params=cell.policy)
        d = max_abs_diff(solo, tenancy.tenant_cell(out, i))
        if d:
            raise AssertionError(f"8a: tenant {i} differs from its "
                                 f"standalone run by {d}")
    # the whole batch against the plain per-lane loop, the plane on (the
    # tap form, each tenant's buffer its own): every leaf, every lane
    part = cut_ticks(sta, TENANTS_PLAIN_TICKS)
    want = clone_state(s0)
    mb_want = tb.metrics_init(want)
    real = fused_tick.fused_prefix_lanes
    fused_tick.fused_prefix_lanes = fused_tick.fused_prefix_lanes_reference
    try:
        w0 = lane_sync()
        want, mb_want = eng.run(want, part, TENANTS_PLAIN_TICKS, tp.policy,
                                mbuf=mb_want)
        plain_wall = lane_sync() - w0
    finally:
        fused_tick.fused_prefix_lanes = real
    got = clone_state(s0)
    got, mb_got = eng.run(got, part, TENANTS_PLAIN_TICKS, tp.policy,
                          mbuf=tb.metrics_init(got))
    d = max(max_abs_diff(want, got), max_abs_diff(mb_want, mb_got))
    if d:
        raise AssertionError(f"8a: the batch differs from the plain per-lane "
                             f"loop by {d}")
    # the sampled pass: every launch timed, some held against the plain loop
    probe = LaneProbe(lambda b, a, r, c, t: (*tick_bytes(b, a, r, c, t,
                                                         False), 0),
                      picks=(0, NT - 1))
    with probe:
        mid = run(clone_state(s0), sta, tp)
    sp = probe.summary()
    # walls: the batch (min of runs) and the serial loop of T standalone
    # runs on the same engine
    walls = []
    for _ in range(TENANTS_WALLS):
        s = clone_state(s0)
        w0 = lane_sync()
        run(s, sta, tp)
        walls.append(lane_sync() - w0)
    cells = [tenancy.tenant_cell(tp, i) for i in range(T)]
    solos = [tenancy.init_tenant_state(w["cfg"], w["specs"], c, device=dev)
             for c in cells]
    w0 = lane_sync()
    for i in range(T):
        eng.run(solos[i], w["tas"][i], NT, params=cells[i].policy)
    serial = lane_sync() - w0
    batch = min(walls)
    if batch >= serial:
        raise AssertionError(f"8a: the batch ({batch:.4f} s) did not beat "
                             f"the serial loop ({serial:.4f} s)")
    # the lane form's launch beside the one-lane launch over the same
    # 512 clusters, at the state the run reaches half way
    tick = NT // 2
    half = eng.run(clone_state(s0), cut_ticks(sta, tick), tick, tp.policy)
    rows = torch.from_numpy(np.ascontiguousarray(sta.rows[:, tick])).to(dev)
    cnts = torch.from_numpy(np.ascontiguousarray(sta.counts[:, tick])).to(dev)
    lane_ms, one_ms = lane_vs_one_lane(E, eng, half, rows, cnts,
                                       (tick + 1) * w["cfg"].tick_ms,
                                       tp.policy, LANE_REPS)
    b_ms, b_by = bound(sp["read"], sp["written"])
    print(f"phase 8a: {T} tenants x {TENANTS_C} clusters, {NT} ticks, "
          f"{w['jobs']} jobs: placed {placed}, drops {drops}; launches "
          f"{counts['fused_prefix_fifo']} (one a tick over all "
          f"{T * TENANTS_C} clusters); tenants {sampled} == standalone; the "
          f"batch == the plain per-lane loop over {TENANTS_PLAIN_TICKS} "
          f"ticks with the plane on ({plain_wall:.2f} s plain); batch wall "
          f"{batch:.4f} s (walls {[round(x, 4) for x in walls]}, counted run "
          f"{wall:.4f} s), serial loop of {T} standalone runs {serial:.4f} s,"
          f" ratio {serial / batch:.1f}x; {w['jobs'] / batch:.0f} jobs/s "
          f"[{card}]")
    print(f"phase 8a: lane form {lane_ms * 1e3:.2f} us/launch ({T} lanes x "
          f"{TENANTS_C}) vs one-lane {one_ms * 1e3:.2f} us/launch (1 x "
          f"{T * TENANTS_C}), {LANE_REPS} each in turns; sampled pass "
          f"{np.mean(sp['kernel_ms']) * 1e3:.2f} us/launch over "
          f"{len(sp['kernel_ms'])} launches, bound {b_ms * 1e3:.4f} us by "
          f"{b_by} ({sp['read'] + sp['written']:.1f} B a launch), plain "
          f"per-lane loop {np.mean(sp['plain_ms']):.2f} ms a tick "
          f"({sp['compared']} ticks held bitwise) [{card}]")
    rec = dict(kernel=fused_tick.KERNELS["fused_prefix_fifo"],
               name=f"fused_prefix_fifo (lanes {T}x{TENANTS_C})",
               launches=counts["fused_prefix_fifo"], worst=sp["worst"],
               ms=float(np.mean(sp["kernel_ms"])), plain=sp["plain_ms"],
               bound=(b_ms, b_by), lane_ms=lane_ms, one_ms=one_ms)
    return dict(world=w, out=out, record=rec, mid=mid)


def phase_mixed_tenants(P, E, card, dev):
    """Phase 8b: the tournament's lineup plus rl (a seeded action) as one
    PolicySet, two tenants a member under a batched idx, on the
    tournament's world (tools/tournament.py _specs(64), _cfg()): at most
    one launch a kernel source a tick (DELAY's three variants in one
    DELAY launch, gavel, tesserae and rl in one scored launch), every lane
    == its standalone run, the masked lane forms == the plain per-lane
    loop at sampled ticks."""
    from multi_cluster_simulator_tpu_torch import tenancy
    from multi_cluster_simulator_tpu_torch.core.state import (
        clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.tools.tournament import (
        DEFAULT_POLICIES, _specs,
    )
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    names = DEFAULT_POLICIES + ("rl",)
    cfg = P.SimConfig(policy=P.PolicyKind.FIFO, parity=True, n_res=2,
                      queue_capacity=96, max_running=96, max_arrivals=120,
                      max_ingest_per_tick=32, max_nodes=5,
                      max_virtual_nodes=0)
    pset = PolicySet(names)
    eng = E.Engine(cfg, device=dev, policies=pset)
    specs = _specs(MIXED_C)
    seeds = (17, 18)  # the tournament's first two seeds, a tenant each
    arrs = {s: uniform_stream(MIXED_C, 120, 240_000, max_cores=24,
                              max_mem=18_000, max_dur_ms=30_000, seed=s)
            for s in seeds}
    tas = {s: E.pack_arrivals_by_tick(a, MIXED_TICKS, cfg.tick_ms)
           for s, a in arrs.items()}
    k = max(ta.rows.shape[2] for ta in tas.values())
    tas = {s: tenancy.pad_tick_arrivals(ta, k) for s, ta in tas.items()}
    scores = torch.from_numpy(np.random.default_rng(17).normal(
        size=(4, 4)).astype(np.float32)).to(dev)
    lanes = [(n, s) for n in names for s in seeds]
    cells = []
    for n, _ in lanes:
        p = pset.params_for(cfg, n, device=dev)
        cells.append(p.replace(rl_scores=scores) if n == "rl" else p)
    params = tenancy.stack_lanes(cells)
    sta = tenancy.stack_tick_arrivals([tas[s] for _, s in lanes])
    s0 = tenancy.stack_tenant_states(
        [init_state(cfg, specs, device=dev) for _ in lanes])
    eng.run(clone_state(s0), cut_ticks(sta, 2), 2, params)  # warm-up
    w0 = lane_sync()
    fused_tick.reset_launches()
    out = eng.run(clone_state(s0), sta, MIXED_TICKS, params)
    wall = lane_sync() - w0
    counts = fused_tick.launch_counts()
    sources = {"fused_prefix_fifo", "fused_prefix_ffd", "fused_prefix_delay",
               "fused_prefix_scored"}
    expect_lane_launches(counts, sources, MIXED_TICKS, "8b")
    for i, (n, s) in enumerate(lanes):
        solo = eng.run(init_state(cfg, specs, device=dev), tas[s],
                       MIXED_TICKS, cells[i])
        d = max_abs_diff(solo, tenancy.tenant_cell(out, i))
        if d:
            raise AssertionError(f"8b: lane {i} ({n}, seed {s}) differs from "
                                 f"its standalone run by {d}")
    QC = cfg.queue_capacity
    probe = LaneProbe(lambda b, a, r, c, t: (0, 0, 0),
                      picks=(1, MIXED_TICKS // 2))
    with probe:
        eng.run(clone_state(s0), sta, MIXED_TICKS, params)
    sp = probe.summary()
    # each source's launch on its own lanes, at the state half way
    tick = MIXED_TICKS // 2
    half = eng.run(clone_state(s0), cut_ticks(sta, tick), tick, params)
    rows = torch.from_numpy(np.ascontiguousarray(sta.rows[:, tick])).to(dev)
    cnts = torch.from_numpy(np.ascontiguousarray(sta.counts[:, tick])).to(dev)
    costs = {
        "fused_prefix_fifo": lambda b, a, r, c, t, tess: (
            *tick_bytes(b, a, r, c, t, False), 0),
        "fused_prefix_ffd": lambda b, a, r, c, t, tess: tick_cost_ffd(
            b, a, r, c, t, False, QC),
        "fused_prefix_delay": lambda b, a, r, c, t, tess: tick_cost_delay(
            b, a, r, c, t, False, QC),
        "fused_prefix_scored": lambda b, a, r, c, t, tess: tick_cost_scored(
            b, a, r, c, t, False, QC, tess)}
    groups = group_launches(eng, half, rows, cnts,
                            (tick + 1) * cfg.tick_ms, params, costs,
                            LANE_REPS)
    print(f"phase 8b: {len(lanes)} tenants ({len(names)} members x 2) x "
          f"{MIXED_C} clusters, {MIXED_TICKS} ticks: launches "
          f"{ {k: v for k, v in counts.items() if v} } (one a source a "
          f"tick); every lane == its standalone run; {sp['compared']} ticks "
          f"== the plain per-lane loop (plain {np.mean(sp['plain_ms']):.2f} "
          f"ms a tick); wall {wall:.3f} s, the tick's launches "
          f"{np.mean(sp['kernel_ms']) * 1e3:.2f} us together [{card}]")
    recs = []
    for name in sorted(sources):
        g = groups[name]
        b_ms, b_by = bound(g["read"], g["written"], g["ops"])
        print(f"phase 8b: {name} on its {g['lanes']} lanes (the others "
              f"masked): {g['ms'] * 1e3:.2f} us/launch over {LANE_REPS}, "
              f"plain on those lanes {g['plain_ms']:.3f} ms, "
              f"bound {b_ms * 1e3:.4f} us by {b_by} "
              f"({g['read'] + g['written']:.1f} B, {g['ops']:.0f} ops) "
              f"[{card}]")
        recs.append(dict(kernel=fused_tick.KERNELS[name],
                         name=f"{name} (lanes {len(lanes)}x{MIXED_C}, mixed)",
                         launches=counts[name], worst=sp["worst"],
                         ms=g["ms"], plain=[g["plain_ms"]],
                         bound=(b_ms, b_by)))
    return dict(records=recs)


def test_tenancy_world(P, dev, **kw):
    """tests/test_tenancy.py's world (tests/test_pipeline.py _cfg, 3
    clusters, 8 ticks of 12 jobs a cluster)."""
    base = dict(policy=P.PolicyKind.FIFO, parity=True, n_res=2,
                queue_capacity=16, max_running=32, max_arrivals=16,
                max_ingest_per_tick=8, max_nodes=5, max_virtual_nodes=0)
    base.update(kw)
    return P.SimConfig(**base), [P.uniform_cluster(c + 1, 5)
                                 for c in range(3)]


def phase_tenants_composed(P, E, card, dev):
    """Phase 8c: tests/test_tenancy.py's compact, compressed and
    generative-fault worlds tiled to 32 tenants, each sampled lane ==
    its standalone run; then 4 tenants of config 2's pair with borrowing
    and the greedy market, each == its standalone run."""
    from multi_cluster_simulator_tpu_torch import tenancy
    from multi_cluster_simulator_tpu_torch.core import compact as CC
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.workload.generator import (
        generate_arrivals,
    )
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    T, NT = COMPOSED_T, 8
    sampled = sorted({0, T // 3, 2 * T // 3, T - 1})
    worlds = {
        "compact": dict(),
        "compressed": dict(),
        "generative faults": dict(faults=P.FaultConfig(
            enabled=True, mode="generative", mttf_ms=4_000, mttr_ms=2_000,
            seed=3)),
    }
    for label, kw in worlds.items():
        cfg, specs = test_tenancy_world(P, dev, **kw)
        arrs = [uniform_stream(3, 12, NT * cfg.tick_ms, 24, 18_000,
                               3 * cfg.tick_ms, seed=7 + i) for i in range(T)]
        plan = CC.derive_plan(cfg, specs, arrs[0]) if label == "compact" \
            else None
        tb = tenancy.TenantBatch(cfg, specs, plan=plan, device=dev)
        tp = tb.default_params(T)
        tas = [E.pack_arrivals_by_tick(a, NT, cfg.tick_ms) for a in arrs]
        k = max(ta.rows.shape[2] for ta in tas)
        tas = [tenancy.pad_tick_arrivals(ta, k) for ta in tas]
        sta = tenancy.stack_tick_arrivals(tas)
        fused_tick.reset_launches()
        if label == "compressed":
            out = tb.run_compressed_fn(NT)(tb.init_stacked(tp), sta, tp)
        else:
            out, _ = tb.run_io_fn()(tb.init_stacked(tp), sta.rows,
                                    sta.counts, tp)
        counts = {k: v for k, v in fused_tick.launch_counts().items() if v}
        for i in sampled:
            cell = tenancy.tenant_cell(tp, i)
            s_i = tenancy.init_tenant_state(cfg, specs, cell, plan=plan,
                                            device=dev)
            if label == "compressed":
                solo = tb.engine.run_compressed(s_i, tas[i], NT,
                                                params=cell.policy)[0]
            else:
                solo, _ = tb.engine.run_io(s_i, tas[i].rows, tas[i].counts,
                                           params=cell.policy)
            d = max_abs_diff(solo, tenancy.tenant_cell(out, i))
            if d:
                raise AssertionError(f"8c {label}: tenant {i} differs from "
                                     f"its standalone run by {d}")
        if label == "generative faults" and max_abs_diff(
                tenancy.tenant_cell(out, 0).faults,
                tenancy.tenant_cell(out, 1).faults) == 0:
            raise AssertionError("8c: tenants 0 and 1 ran one fault timeline")
        print(f"phase 8c: {label}: {T} tenants x 3 clusters, {NT} ticks, "
              f"launches {counts}; tenants {sampled} == standalone [{card}]")
    # config 2's pair with borrowing and the greedy market, 4 tenants
    cfg = borrow_cfg(P, {})
    specs = borrow_specs(P, 2)
    eng = E.Engine(cfg, device=dev)
    tas = []
    for i in range(4):
        arr = generate_arrivals(P.WorkloadConfig(poisson_lambda_per_min=30.0),
                                2, 4096, BORROW_HORIZON_MS, 32, 24_000,
                                seed=9 + i)
        tas.append(E.pack_arrivals_by_tick(arr, COMPOSED_BORROW_TICKS,
                                           cfg.tick_ms))
    k = max(ta.rows.shape[2] for ta in tas)
    tas = [tenancy.pad_tick_arrivals(ta, k) for ta in tas]
    s0 = tenancy.stack_tenant_states(
        [init_state(cfg, specs, device=dev) for _ in tas])
    fused_tick.reset_launches()
    out = eng.run(s0, tenancy.stack_tick_arrivals(tas),
                  COMPOSED_BORROW_TICKS)
    counts = {k: v for k, v in fused_tick.launch_counts().items() if v}
    for i in range(4):
        solo = eng.run(init_state(cfg, specs, device=dev), tas[i],
                       COMPOSED_BORROW_TICKS)
        d = max_abs_diff(solo, tenancy.tenant_cell(out, i))
        if d:
            raise AssertionError(f"8c borrowing: tenant {i} differs from its "
                                 f"standalone run by {d}")
    lent = int(out.lent.count.sum() + out.borrowed.count.sum())
    vnodes = int((out.node_active[..., cfg.max_nodes:]).sum())
    print(f"phase 8c: config 2 pair, borrowing + greedy market, 4 tenants, "
          f"{COMPOSED_BORROW_TICKS} ticks: launches {counts}; each tenant == "
          f"its standalone run ({int(out.placed_total.sum())} placements, "
          f"{lent} lent/borrowed rows held, {vnodes} virtual nodes active) "
          f"[{card}]")


def env_world(P, dev, B=None):
    """bench.py bench_env's full shape (bench.py:2632-): 1,024 envs of 8
    clusters, episodes of 50 ticks, the generative stream, FIFO parity on
    queue 16 / running 64, the rl action port, neg_mean_wait."""
    from multi_cluster_simulator_tpu_torch.envs import ClusterEnv, StreamGen
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    cfg = P.SimConfig(policy=P.PolicyKind.FIFO, parity=True, n_res=2,
                      queue_capacity=16, max_running=64, max_arrivals=8,
                      max_ingest_per_tick=8, max_nodes=5,
                      max_virtual_nodes=0)
    specs = [P.uniform_cluster(c + 1, 5) for c in range(ENV_C)]
    gen = StreamGen(rate=2.0, k_max=8, max_cores=8, max_mem=6_000,
                    max_dur_ms=15_000)
    return cfg, specs, ClusterEnv(cfg, specs, episode_ticks=ENV_EP, gen=gen,
                                  policies=PolicySet(("rl",)),
                                  reward="neg_mean_wait", device=dev)


def phase_env(P, E, card, dev):
    """Phase 8d: the env at bench_env's full shape, 125 steps: auto-reset
    engages (every env's episode counter reads 2), no drops, the timed
    step loop under torch.cuda.set_sync_debug_mode("error") (no host
    synchronisation in a step, auto-reset included), the batched step
    against a serial loop of single-env steps, envs x steps a second; the
    scored kernel's lane form beside its one-lane launch over the same
    clusters."""
    from multi_cluster_simulator_tpu_torch import tenancy
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.utils import prng
    from multi_cluster_simulator_tpu_torch.utils.trace import total_drops

    cfg, specs, env = env_world(P, dev)
    B = ENV_B
    action = torch.zeros((B,) + env.action_shape, dtype=torch.float32,
                         device=dev)
    step = env.batch_step_fn()
    _, es = env.reset_batch(prng.prng_key(17, dev), B)
    step(es, action)  # warm-up: the lane plan made and the kernel loaded
    walls = []
    for rep in range(ENV_WALLS):
        # a fresh batch from the reset, whose clock the env holds on the
        # host: the step loop reads nothing from the card
        _, es = env.reset_batch(prng.prng_key(17, dev), B)
        torch.cuda.synchronize()
        if rep == 0:
            fused_tick.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            w0 = time.perf_counter()
            for _ in range(ENV_STEPS):
                obs, r, d, info, es = step(es, action)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - w0)
        if rep == 0:
            counts = {k: v for k, v in fused_tick.launch_counts().items()
                      if v}
            kernel = fused_tick.KERNELS["fused_prefix_scored"]
            if counts != {kernel.name: ENV_STEPS}:
                raise AssertionError(f"8d: launches {counts}, want one "
                                     f"scored launch a step")
    episodes = es.episodes.tolist()
    want_eps = ENV_STEPS // ENV_EP
    if set(episodes) != {want_eps}:
        raise AssertionError(f"8d: episode counters {sorted(set(episodes))}, "
                             f"want {want_eps}")
    drops = total_drops(es.sim)
    if any(drops.values()):
        raise AssertionError(f"8d: drops {drops}")
    if not bool(torch.isfinite(obs).all()) or \
            not bool(torch.isfinite(r).all()):
        raise AssertionError("8d: non-finite observations or rewards")
    wall = min(walls)
    rate = B * ENV_STEPS / wall
    # the serial loop of single-env steps (the host-stepped gym)
    _, one = env.reset(prng.prng_key(17, dev))
    single = env.step_fn(donate=True)
    act1 = action[0]
    single(one, act1)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for _ in range(ENV_SERIAL):
        single(one, act1)
    torch.cuda.synchronize()
    serial = (time.perf_counter() - w0) / ENV_SERIAL
    per = wall / (B * ENV_STEPS)
    if per >= serial:
        raise AssertionError(f"8d: a batched env-step {per * 1e6:.2f} us did "
                             f"not beat a single-env step "
                             f"{serial * 1e6:.2f} us")
    # the scored lane form's launch beside the one-lane launch over the
    # same 8,192 clusters, on the state the run reached
    sim = es.sim
    ks = prng.split(es.key, 2)
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        tick_arrivals_device,
    )
    g = env.gen
    t_host = int(sim.t[0])
    rows, cnts = tick_arrivals_device(ks[:, 1], sim.t + cfg.tick_ms, ENV_C,
                                      g.k_max, g.rate, g.max_cores,
                                      g.max_mem, g.max_dur_ms, g.beta)
    params = env._params
    lane_ms, one_ms = lane_vs_one_lane(E, env.engine, sim, rows, cnts,
                                       t_host + cfg.tick_ms, params,
                                       LANE_REPS)
    print(f"phase 8d: {B} envs x {ENV_C} clusters, episodes of {ENV_EP} "
          f"ticks, {ENV_STEPS} steps: episodes {want_eps} everywhere, no "
          f"drops, launches {counts} (one scored launch a step over "
          f"{B * ENV_C} clusters); the timed loop ran under "
          f"set_sync_debug_mode('error'); wall {wall:.4f} s (walls "
          f"{[round(x, 4) for x in walls]}): {rate:.0f} envs.steps/s, "
          f"{per * 1e6:.3f} us an env-step; a single-env step "
          f"{serial * 1e6:.1f} us ({serial / per:.0f}x) [{card}]")
    print(f"phase 8d: scored lane form {lane_ms * 1e3:.2f} us/launch ({B} "
          f"lanes x {ENV_C}) vs one-lane {one_ms * 1e3:.2f} us/launch "
          f"(1 x {B * ENV_C}), {LANE_REPS} each in turns [{card}]")
    return dict(env=env, es=es, counts=counts, lane_ms=lane_ms,
                one_ms=one_ms, rate=rate)


def phase_env_lanes(P, E, card, dev):
    """Phase 8e: the env at 8d's shape for 50 steps with a distinct seeded
    action a env (every lane's table its own): the scored lane form ==
    the plain per-lane loop at sampled steps, every leaf; a batch-1 replay
    env == Engine.run over the same bucketed arrivals."""
    from multi_cluster_simulator_tpu_torch.core.state import (
        TickArrivals, init_state,
    )
    from multi_cluster_simulator_tpu_torch.envs import ClusterEnv
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.utils import prng
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg, specs, env = env_world(P, dev)
    B = ENV_B
    rng = np.random.default_rng(23)
    action = torch.from_numpy(rng.normal(size=(B,) + env.action_shape)
                              .astype(np.float32)).to(dev)
    _, es = env.reset_batch(prng.prng_key(17, dev), B)
    step = env.batch_step_fn()

    def cost(b, a, r, c, t):
        return tick_cost_scored(b, a, r, c, t, False, cfg.queue_capacity,
                                False)
    probe = LaneProbe(cost, picks=ENV_PLAIN_STEPS)
    placed = torch.zeros((), dtype=torch.int64, device=dev)
    fused_tick.reset_launches()
    with probe:
        for _ in range(ENV_LANE_STEPS):
            *_, info, es = step(es, action)
            placed += info.placed.sum()  # the last step's reset zeroes it
    sp = probe.summary()
    launches = fused_tick.launch_counts()["fused_prefix_scored"]
    placed = int(placed)
    # a batch-1 replay env against Engine.run
    arr = uniform_stream(ENV_C, 60, 40_000, max_cores=8, max_mem=6_000,
                         max_dur_ms=15_000, seed=3)
    ta = E.pack_arrivals_by_tick(arr, 45, cfg.tick_ms)
    renv = ClusterEnv(cfg, specs, episode_ticks=45, arrivals=ta, device=dev)
    _, res = renv.reset(prng.prng_key(0, dev))
    rstep = renv.step_fn(donate=True)
    for _ in range(40):
        rstep(res)
    ref = E.Engine(cfg, device=dev).run(
        init_state(cfg, specs, device=dev),
        TickArrivals(rows=ta.rows, counts=ta.counts), 40)
    d = max_abs_diff(ref, res.sim)
    if d:
        raise AssertionError(f"8e: the batch-1 replay env differs from "
                             f"Engine.run by {d}")
    b_ms, b_by = bound(sp["read"] + 4 * 20 * B, sp["written"], sp["ops"])
    print(f"phase 8e: {B} envs x {ENV_C}, {ENV_LANE_STEPS} steps, a distinct "
          f"seeded action a env: the scored lane form == the plain per-lane "
          f"loop at steps {sorted(ENV_PLAIN_STEPS)} (every leaf; plain "
          f"{np.mean(sp['plain_ms']):.1f} ms a step), {launches} launches, "
          f"{np.mean(sp['kernel_ms']) * 1e3:.2f} us/launch, bound "
          f"{b_ms * 1e3:.4f} us by {b_by} ({sp['read'] + sp['written']:.1f} "
          f"B a launch, the lanes' tables and weights included), {placed} "
          f"placements; a batch-1 replay env == Engine.run over 40 ticks "
          f"({int(res.sim.placed_total.sum())} placements) [{card}]")
    return dict(record=dict(
        kernel=fused_tick.KERNELS["fused_prefix_scored"],
        name=f"fused_prefix_scored (lanes {B}x{ENV_C}, rl)",
        launches=launches, worst=sp["worst"],
        ms=float(np.mean(sp["kernel_ms"])), plain=sp["plain_ms"],
        bound=(b_ms, b_by)))


# ---------------------------------------------------------------------------
# phase 9: the services tier — the serving front door (services/serving.py)
# and the live scheduler host (services/scheduler_host.py) on the card
# ---------------------------------------------------------------------------

def serve_cfg(P, **kw):
    """bench.py bench_serving's config (bench.py:1760-1771): FIFO parity,
    queue 256, running 512, 64 arrival slots, 16 ingested a tick, 10 nodes
    a cluster."""
    base = dict(policy=P.PolicyKind.FIFO, parity=True, n_res=2,
                queue_capacity=256, max_running=512, max_arrivals=64,
                max_ingest_per_tick=16, max_nodes=10, max_virtual_nodes=0)
    base.update(kw)
    return P.SimConfig(**base)


def serve_specs(P, C=None):
    return [P.uniform_cluster(c + 1, 10) for c in range(C or SERVE_C)]


def serve_trace(C, T, seed=11):
    """bench_serving's parity trace (bench.py:1788-1806): per tick and
    cluster 0-2 jobs, one in ~20 at the endpoint the policy never drains;
    [T] lists of (c, id, cores, mem, dur, mismatched)."""
    rng = np.random.default_rng(seed)
    out, jid = [], 1
    for _ in range(T):
        row = []
        for c in range(C):
            for _ in range(int(rng.integers(0, 3))):
                mism = bool(rng.integers(0, 20) == 0)
                row.append((c, jid, int(rng.integers(1, 4)),
                            int(rng.integers(100, 2000)),
                            int(rng.integers(1000, 4001)), mism))
                jid += 1
        out.append(row)
    return out


class ServiceGuard:
    """The services' swallowed errors, surfaced: a handler on each watched
    service's logger keeps every ERROR record (a failed dispatch ends the
    serving drive thread, a failed tick is logged by the live loop and the
    loop carries on; both are the reference's semantics), and ``check``
    fails on any of them and on a watched service that is not healthy or
    whose loop thread died. Every phase 9 gate runs after a ``check``."""

    def __init__(self):
        import logging

        class Keep(logging.Handler):
            def __init__(self, out):
                super().__init__(logging.ERROR)
                self.out = out

            def emit(self, record):
                self.out.append(f"{record.name}: {record.getMessage()}")

        self.errors = []
        self.handler = Keep(self.errors)
        self.services = []

    def watch(self, s):
        s.logger.addHandler(self.handler)
        self.services.append(s)
        return s

    def check(self, what, *live):
        """No ERROR record so far; each service in ``live`` (started, not
        yet stopped) healthy, with its loop threads alive."""
        if self.errors:
            raise AssertionError(f"{what}: services logged errors: "
                                 f"{self.errors[:5]}")
        for s in live:
            ok, detail = s.health()
            threads = [getattr(s, n, None) for n in
                       ("_drive_thread", "_pacer_thread", "_tick_thread")]
            dead = [th.name for th in threads
                    if th is not None and not th.is_alive()]
            if not ok or dead:
                raise AssertionError(f"{what}: {s.name} unhealthy {detail}, "
                                     f"dead threads {dead}")


def host_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over two host leaf dicts (``state_host``), keys,
    dtypes and shapes equal (a float leaf counts any bit difference)."""
    if set(a) != set(b):
        raise AssertionError(f"leaf keys differ: {sorted(set(a) ^ set(b))}")
    worst = 0.0
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{k}: {x.dtype}{x.shape} vs "
                                 f"{y.dtype}{y.shape}")
        if x.dtype.kind == "f":
            if not np.array_equal(x.view(np.int32), y.view(np.int32)):
                worst = max(worst, float(np.abs(
                    x.astype(np.float64) - y.astype(np.float64)).max())
                    or math.inf)
        elif x.size:
            worst = max(worst, float(np.abs(
                x.astype(np.int64) - y.astype(np.int64)).max()))
    return worst


def require_equal(a: dict, b: dict, what: str) -> None:
    d = host_diff(a, b)
    if d:
        raise AssertionError(f"{what}: max |diff| {d}")


def no_drops(host: dict, what: str) -> None:
    bad = {k: int(v.sum()) for k, v in host.items()
           if k.startswith(".drops.") and v.any()}
    if bad:
        raise AssertionError(f"{what}: the engine dropped work {bad}")


class ServeProbe(LaunchProbe):
    """``LaunchProbe`` for the forms the services launch: the comparisons
    at the picks run the launch's own form (the emit outputs, and with the
    plane the buffer and the cursor, held too; windowed where the tick
    ingests its window of the live host's ring), and the tap's bytes
    (``tap_cost``) and a windowed tick's due checks (``window_feed``)
    count beside the span's. The comparisons' launches are taken back
    out of the launch counts. Launches of other engines (a CPU twin's
    plain path) pass through untouched."""

    def __init__(self, chk, cost, shared, picks):
        super().__init__(chk, cost, picks)
        self.shared = shared

    def __call__(self, engine, state, rows, counts, t, params, host,
                 emit_returns=False, out=None, obs=None, windowed=False):
        from multi_cluster_simulator_tpu_torch.core.state import empty_io

        if engine is not self.chk.engine:  # another service's tick
            return self.real(engine, state, rows, counts, t, params, host,
                             emit_returns, out, obs, windowed)
        if len(self.evs) in self.picks:
            saved = [(k, k.launches, k.windowed_launches)
                     for k in self.ft.KERNELS.values()]
            self.ft.fused_prefix = self.real
            try:
                self.chk.compare(state, rows, counts, t, emit=emit_returns,
                                 obs=obs, windowed=windowed)
            finally:
                self.ft.fused_prefix = self
                for k, n, nw in saved:
                    k.launches, k.windowed_launches = n, nw
        before = self.clone(state)
        ob = None if obs is None else tuple(map(self.chk.clone, obs))
        if emit_returns and out is None:
            out = empty_io((counts.shape[0],), engine.n_msgs(), state.device)
        self.ft.prepare(engine, state, host, emit_returns, obs)
        ev = timed_launch_events()
        ev[0].record()
        res = self.real(engine, state, rows, counts, t, params, host,
                        emit_returns, out, obs, windowed)
        ev[1].record()
        self.evs.append(ev)
        extra = 0
        if windowed:
            rows, counts, extra = window_feed(rows, counts, before, state)
        r, w, o = self.cost(before, state, rows, counts, t)
        if obs is not None:
            tr, tw = tap_cost(self.shared, *ob, *obs, n_ovf_tables(state))
            r, w = r + tr, w + tw
        self.read, self.written, self.ops = (self.read + r + extra,
                                             self.written + w, self.ops + o)
        return res


def serve_record(name, label, launches, worst, plain, sp):
    """A kernel record of a form a probe timed (``sp``, its summary). Its
    ms is the median launch: the services' probes time launches beside
    live service threads, and a thread switch between a pair's two
    records that outlasts the spin ahead of them lands in that one
    sample (``serve_us`` prints the mean and the largest beside it)."""
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    return dict(kernel=fused_tick.KERNELS[name], name=f"{name} ({label})",
                launches=launches, worst=worst,
                ms=float(np.median(sp["kernel_ms"])), plain=plain,
                bound=bound(sp["read"], sp["written"], sp["ops"]))


def serve_us(kernel_ms) -> str:
    """A services probe's launch times: median, mean and largest, in us."""
    k = np.asarray(kernel_ms) * 1e3
    return (f"{np.median(k):.2f} us/launch median (mean {k.mean():.2f}, "
            f"max {k.max():.2f})")


def drive_front_door(s, tick_jobs, window, batched, mism_jobs=True):
    """bench_serving's drive_ab loop (bench.py:1826-1858) on a started
    deterministic front door: a tick's jobs as one /submitBatch (each
    job's ``Delay`` its endpoint) or one POST a job on the wire-parity
    endpoints, one seal a tick, one dispatch a window. Returns the wall."""
    from multi_cluster_simulator_tpu_torch.services import httpd
    from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
        job_to_json,
    )

    w0 = time.perf_counter()
    for t, row in enumerate(tick_jobs):
        row = [j for j in row if mism_jobs or not j[5]]
        if batched:
            if row:
                code, body = httpd.post_json(
                    s.url + "/submitBatch",
                    [{**job_to_json(j, co, m, d), "Cluster": c, "Delay": mi}
                     for (c, j, co, m, d, mi) in row])
                if code != 200:
                    raise AssertionError(f"batch at tick {t} -> {code} "
                                         f"{body[:200]!r}")
        else:
            for (c, j, co, m, d, mi) in row:
                code, _ = httpd.post_json(
                    s.url + ("/delay" if mi else "/"),
                    {**job_to_json(j, co, m, d), "Cluster": c})
                if code != 200:
                    raise AssertionError(f"submit {j} -> {code}")
        s.seal_tick()
        if (t + 1) % window == 0:
            s.dispatch_sealed()
    s.dispatch_sealed()
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - w0


def phase_serving_parity(P, E, card, dev, guard):
    """Phase 9a: bench_serving's parity A/B (bench.py:1700-1870) at its
    full shape on the card, over localhost HTTP: 16 clusters of 10 nodes,
    160 ticks of the seed-11 trace; a window-1 front door (a POST a job, a
    dispatch a tick) and a window-8 one (a /submitBatch a tick) end in
    equal states, both equal to the window-8 front door on the CPU (the
    plain version, every leaf); without the mismatched-endpoint jobs the
    window-8 state equals ``Engine.run`` on the card over the bucketed
    stream; each card run launches the FIFO emit+tap form once a tick and
    nothing else. Then a deterministic window-8 run with every launch
    timed and 12 of them held against the plain version."""
    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )

    cfg, specs = serve_cfg(P), serve_specs(P)
    trace = serve_trace(SERVE_C, SERVE_T)
    n_jobs = sum(len(r) for r in trace)
    n_mism = sum(j[5] for r in trace for j in r)
    form = "fused_prefix_fifo_emit_tap"
    out = {}

    def run(label, window, batched, device, mism=True):
        s = guard.watch(ServingScheduler(
            f"serve-{label}", specs, cfg, pacer=False, window=window,
            warm_k=(4,), k_cap=64, max_staged=10 ** 6, device=device))
        s.start()  # the warm-up dispatches run here, before the counts
        fused_tick.reset_launches()
        wall = drive_front_door(s, trace, window, batched, mism)
        counts = fused_tick.launch_counts()
        guard.check(f"9a {label}", s)
        host = s.state_host()
        placed = s.snapshot.placed
        s.shutdown()
        guard.check(f"9a {label} shutdown")
        want = n_jobs - n_mism  # a mismatched job sits in its queue
        if placed != want:
            raise AssertionError(f"9a {label}: placed {placed} of {want}")
        no_drops(host, f"9a {label}")
        out[label] = dict(host=host, wall=wall, counts=counts)
        return out[label]

    w1 = run("w1", 1, False, dev)
    w8 = run("w8", SERVE_WINDOW, True, dev)
    require_equal(w1["host"], w8["host"], "9a window 1 vs window 8")
    for label in ("w1", "w8"):
        check_launches(out[label]["counts"], form, SERVE_T, f"9a {label}")
    cpu = run("w8-cpu", SERVE_WINDOW, True, "cpu")
    require_equal(cpu["host"], w8["host"],
                  "9a window 8 on the card vs the plain version on the CPU")
    # the staged path IS the batch engine: the trace without its
    # mismatched jobs, stamped at its staging ticks, through Engine.run
    clean = run("w8-clean", SERVE_WINDOW, True, dev, mism=False)
    check_launches(clean["counts"], form, SERVE_T, "9a w8-clean")
    rows = {c: [] for c in range(SERVE_C)}
    for t, row in enumerate(trace):
        for (c, j, co, m, d, mi) in row:
            if not mi:
                rows[c].append((j, co, m, d, (t + 1) * cfg.tick_ms))
    A = max(len(v) for v in rows.values())
    arr = {k: np.zeros((SERVE_C, A), np.int32)
           for k in ("t", "id", "cores", "mem", "gpu", "dur")}
    n = np.zeros((SERVE_C,), np.int32)
    for c, lst in rows.items():
        n[c] = len(lst)
        for i, (j, co, m, d, ta) in enumerate(lst):
            arr["id"][c, i], arr["cores"][c, i] = j, co
            arr["mem"][c, i], arr["dur"][c, i], arr["t"][c, i] = m, d, ta
    from multi_cluster_simulator_tpu_torch.core.state import Arrivals
    ta_b = E.pack_arrivals_by_tick(Arrivals(**arr, n=n), SERVE_T,
                                   cfg.tick_ms)
    ref = E.Engine(cfg, device=dev).run(
        P.init_state(cfg, specs, device=dev), ta_b, SERVE_T)
    require_equal(interop.to_numpy(ref), clean["host"],
                  "9a window 8 (no mismatched jobs) vs Engine.run")

    # the timed pass: a deterministic window-8 front door (no HTTP), every
    # launch between CUDA events, 12 held against the plain version
    s = guard.watch(ServingScheduler(
        "serve-timed", specs, cfg, pacer=False, window=SERVE_WINDOW,
        warm_k=(4,), k_cap=64, max_staged=10 ** 6, device=dev))
    s.start()
    chk = Checker(s.engine)
    cost, shared = cost_of("fifo_emit", s.engine)
    with ServeProbe(chk, cost, shared, spread(SERVE_T, 12)) as probe:
        for t, row in enumerate(trace):
            for (c, j, co, m, d, mi) in row:
                assert s.submit_direct(c, j, co, m, d, delay=mi,
                                       ta=(t + 1) * cfg.tick_ms)
            s.seal_tick()
            if (t + 1) % SERVE_WINDOW == 0:
                s.dispatch_sealed()
        s.dispatch_sealed()
    sp = probe.summary()
    guard.check("9a timed", s)
    require_equal(s.state_host(), w8["host"], "9a timed run vs window 8")
    s.shutdown()
    print(f"phase 9a: serving parity A/B, {SERVE_C} clusters x {SERVE_T} "
          f"ticks, {n_jobs} jobs ({n_mism} at the mismatched endpoint): "
          f"window 1 (a POST a job) == window 8 (a /submitBatch a tick) == "
          f"window 8 on the CPU (plain); no mismatched jobs == Engine.run; "
          f"launches {form} x {SERVE_T} a run and no other; walls: "
          f"per-request {w1['wall']:.3f} s ({n_jobs / w1['wall']:.1f} jobs/s),"
          f" batched {w8['wall']:.3f} s ({n_jobs / w8['wall']:.1f} jobs/s), "
          f"speedup {w1['wall'] / w8['wall']:.2f}x; CPU (plain) window 8 "
          f"{cpu['wall']:.3f} s [{card}]")
    print(f"phase 9a: {form} at {SERVE_C} clusters: "
          f"{serve_us(sp['kernel_ms'])} over "
          f"{len(sp['kernel_ms'])} launches, plain "
          f"{np.mean(chk.plain_ms):.3f} ms at {chk.n} comparisons, "
          f"{sp['read'] + sp['written']:.1f} B a launch [{card}]")
    return dict(record=serve_record(form, f"9a serving, {SERVE_C} clusters",
                                    w8["counts"][form], chk.worst,
                                    chk.plain_ms, sp))


def phase_serving_throughput(P, E, card, dev, guard):
    """Phase 9b: bench_serving's throughput phase (bench.py:1969-1995) at
    its full shape, once: 60,000 jobs from 4 client threads as
    /submitBatch of 128 with the retry-on-503 discipline, speed 100,
    window 8, warm K (16, 64, 128), k_cap 128, the pacer and the drive
    thread on; zero drops and every submitted job placed. The card's busy
    share comes from a torch.profiler window over the run: the union of
    the intervals of its kernels and copies over the wall (the profiler's
    host-side recording is inside the measured wall)."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.services import httpd
    from multi_cluster_simulator_tpu_torch.services.backoff import (
        jittered_backoff_ms,
    )
    from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
        job_to_json,
    )
    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )

    cfg, specs = serve_cfg(P), serve_specs(P)
    s = guard.watch(ServingScheduler(
        "serve-tput", specs, cfg, speed=100.0, window=SERVE_WINDOW,
        pacer=True, warm_k=(16, 64, 128), k_cap=128, max_staged=10 ** 6,
        device=dev))
    s.start()
    fused_tick.reset_launches()
    d0 = s.dispatches
    per = SERVE_JOBS // SERVE_CLIENTS
    counters = {"retries": 0, "rejected": 0}
    lock = threading.Lock()
    errors = []

    def client(ci):
        try:
            crng = np.random.default_rng(1000 + ci)
            batch = []
            for i in range(per):
                batch.append({**job_to_json(
                    ci * per + i + 1, int(crng.integers(1, 4)),
                    int(crng.integers(100, 2000)),
                    int(crng.integers(1000, 2501))),
                    "Cluster": int(crng.integers(0, SERVE_C))})
                if len(batch) < SERVE_BATCH and i != per - 1:
                    continue
                for attempt in range(257):
                    code, body = httpd.post_json(s.url + "/submitBatch",
                                                 batch)
                    if code == 200:
                        break
                    if code != 503 or attempt == 256:
                        raise AssertionError(f"client {ci}: {code} after "
                                             f"{attempt} retries")
                    e = json.loads(body)
                    with lock:
                        counters["retries"] += 1
                        counters["rejected"] += len(e["RejectedIdx"])
                    batch = [batch[k] for k in e["RejectedIdx"]]
                    time.sleep(jittered_backoff_ms(
                        attempt, max(float(e["RetryAfterMs"]), 1.0),
                        2_000.0, crng) / 1000.0)
                batch = []
        except BaseException as e:  # re-raised on the main thread
            with lock:
                errors.append(e)

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(SERVE_CLIENTS)]
    ages = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for th in ths:
            th.start()
        while any(th.is_alive() for th in ths):
            code, body = httpd.get(s.url + "/stats")
            if code == 200:
                ages.append(json.loads(body)["snapshot_age_ms"])
            time.sleep(0.05)
        for th in ths:
            th.join()
        if errors:
            raise errors[0]
        submit_wall = time.perf_counter() - t0
        deadline = time.perf_counter() + 600
        while time.perf_counter() < deadline:
            snap = s.snapshot
            if snap.placed >= SERVE_JOBS and snap.staged_jobs == 0:
                break
            time.sleep(0.02)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    guard.check("9b", s)
    s.shutdown()
    guard.check("9b shutdown")
    host = s.state_host()
    no_drops(host, "9b")
    placed = int(host[".placed_total"].sum())
    if s.snapshot.placed != SERVE_JOBS or placed != SERVE_JOBS:
        raise AssertionError(f"9b: placed {s.snapshot.placed} (state "
                             f"{placed}) of {SERVE_JOBS} submitted")
    counts = {k: v for k, v in fused_tick.launch_counts().items() if v}
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e6 / wall
    ticks = s.ticks_dispatched
    print(f"phase 9b: serving throughput, {SERVE_JOBS} jobs from "
          f"{SERVE_CLIENTS} clients in /submitBatch of {SERVE_BATCH}: "
          f"{SERVE_JOBS / wall:.1f} jobs/s placed (wall {wall:.3f} s, submit "
          f"{submit_wall:.3f} s), {s.dispatches - d0} dispatches, "
          f"{ticks} ticks dispatched, launches {counts}, 503 retries "
          f"{counters['retries']} ({counters['rejected']} jobs), snapshot "
          f"age p50 {np.percentile(ages, 50) if ages else float('nan'):.3f} "
          f"max {max(ages) if ages else float('nan'):.3f} ms over "
          f"{len(ages)} /stats; the card busy {100 * busy:.2f}% of the wall "
          f"({busy_us / 1e3:.1f} ms of kernels and copies, torch.profiler), "
          f"0 drops [{card}]")
    return dict(launches=counts, wall=wall, busy=busy)


def phase_serving_tenants(P, E, card, dev, guard):
    """Phase 9c: the tenant front door, 8 tenants on 9a's world (each its
    own seed-11+i trace without the mismatched jobs, which multi-tenant
    hosting refuses), window 8 over HTTP with one /submitBatch a tick for
    every tenant: the lane form launches once a tick over all 128
    clusters, and each tenant's final state equals its own standalone
    front door's on the card. Then a deterministic run with every lane
    launch timed and 12 held against the plain per-lane loop."""
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.services import httpd
    from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
        job_to_json,
    )
    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )

    cfg, specs = serve_cfg(P), serve_specs(P)
    T = SERVE_TENANTS
    traces = [[[j for j in row if not j[5]]
               for row in serve_trace(SERVE_C, SERVE_T, seed=11 + i)]
              for i in range(T)]
    form = "fused_prefix_fifo_emit_tap"

    def tenant_door(name):
        s = guard.watch(ServingScheduler(
            name, specs, cfg, pacer=False, tenants=T, window=SERVE_WINDOW,
            warm_k=(4,), k_cap=64, max_staged=10 ** 6, device=dev))
        s.start()
        return s

    s = tenant_door("serve-tenants")
    fused_tick.reset_launches()
    w0 = time.perf_counter()
    for t in range(SERVE_T):
        batch = [{**job_to_json(j, co, m, d), "Cluster": c, "Tenant": i}
                 for i in range(T) for (c, j, co, m, d, _mi) in traces[i][t]]
        if batch:
            code, body = httpd.post_json(s.url + "/submitBatch", batch)
            if code != 200:
                raise AssertionError(f"9c tick {t} -> {code} {body[:200]!r}")
        s.seal_tick()
        if (t + 1) % SERVE_WINDOW == 0:
            s.dispatch_sealed()
    s.dispatch_sealed()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    counts = fused_tick.launch_counts()
    guard.check("9c", s)
    check_launches(counts, form, SERVE_T, "9c tenant front door")
    host = s.state_host()
    s.shutdown()
    no_drops(host, "9c")
    w_alone = 0.0
    for i in range(T):
        a = guard.watch(ServingScheduler(
            f"serve-alone-{i}", specs, cfg, pacer=False, window=SERVE_WINDOW,
            warm_k=(4,), k_cap=64, max_staged=10 ** 6, device=dev))
        a.start()
        w0 = time.perf_counter()
        for t in range(SERVE_T):
            for (c, j, co, m, d, _mi) in traces[i][t]:
                assert a.submit_direct(c, j, co, m, d,
                                       ta=(t + 1) * cfg.tick_ms)
            a.seal_tick()
            if (t + 1) % SERVE_WINDOW == 0:
                a.dispatch_sealed()
        a.dispatch_sealed()
        torch.cuda.synchronize()
        w_alone += time.perf_counter() - w0
        guard.check(f"9c standalone {i}", a)
        require_equal({k: v[i] for k, v in host.items()}, a.state_host(),
                      f"9c tenant {i} vs its standalone front door")
        a.shutdown()
    # the timed pass: the lane form's launches between CUDA events
    s = tenant_door("serve-tenants-timed")
    cost, _shared = cost_of("fifo_emit", s.engine)
    with LaneProbe(cost, spread(SERVE_T, 12)) as probe:
        for t in range(SERVE_T):
            for i in range(T):
                for (c, j, co, m, d, _mi) in traces[i][t]:
                    assert s.submit_direct(c, j, co, m, d,
                                           ta=(t + 1) * cfg.tick_ms,
                                           tenant=i)
            s.seal_tick()
            if (t + 1) % SERVE_WINDOW == 0:
                s.dispatch_sealed()
        s.dispatch_sealed()
    sp = probe.summary()
    guard.check("9c timed", s)
    require_equal(s.state_host(), host, "9c timed run vs the HTTP run")
    s.shutdown()
    print(f"phase 9c: tenant front door, {T} tenants x {SERVE_C} clusters x "
          f"{SERVE_T} ticks ({sum(len(r) for tr in traces for r in tr)} "
          f"jobs): {form} x {counts[form]} (one lane launch a tick), each "
          f"tenant == its standalone front door; walls: tenants "
          f"{wall:.3f} s over HTTP, {T} standalone {w_alone:.3f} s; the lane "
          f"form {serve_us(sp['kernel_ms'])}, plain "
          f"per-lane loop {np.mean(sp['plain_ms']):.3f} ms at "
          f"{sp['compared']} comparisons [{card}]")
    return dict(record=serve_record(
        form, f"9c lanes {T}x{SERVE_C}, tenant front door", counts[form],
        sp["worst"], sp["plain_ms"], sp))


def serve_child_args(P, dirname: str, device):
    cfg, specs = serve_cfg(P), serve_specs(P)
    return cfg, specs, dict(
        pacer=False, window=SERVE_CKPT_WINDOW, warm_k=(4,), k_cap=64,
        max_staged=10 ** 6, wal_path=f"{dirname}/serve.wal",
        checkpoint_path=f"{dirname}/serve.ckpt",
        checkpoint_every=SERVE_CKPT_EVERY, device=device)


def feed_trace(s, trace, cfg, t0, t1, dispatch_until=None):
    """Stage ticks [t0, t1) of ``trace`` through the deterministic driver,
    one dispatch a window while the tick is below ``dispatch_until``."""
    for t in range(t0, t1):
        for (c, j, co, m, d, mi) in trace[t]:
            assert s.submit_direct(c, j, co, m, d, delay=mi,
                                   ta=(t + 1) * cfg.tick_ms)
        s.seal_tick()
        if (t + 1) % s.window == 0 and (dispatch_until is None
                                       or t + 1 <= dispatch_until):
            s.dispatch_sealed()


def serve_child_cmd(dirname: str, dev) -> list:
    import os

    return [sys.executable, os.path.abspath(__file__), "--serve-child",
            dirname, "--device", str(dev)]


def serve_child(argv) -> int:
    """9d's child: a front door with a WAL and checkpoints at 9a's world
    stages the trace's first ``SERVE_KILL_STAGED`` ticks (each job acked,
    its WAL record fsync'd first), dispatching through tick
    ``SERVE_KILL_DISPATCHED``, prints its ``# serve child:`` line and
    waits to be killed."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --serve-child")
    ap.add_argument("dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import multi_cluster_simulator_tpu_torch as P
    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )

    cfg, specs, kw = serve_child_args(P, args.dir, args.device)
    s = ServingScheduler("serve-child", specs, cfg, **kw)
    trace = serve_trace(SERVE_C, SERVE_T)
    feed_trace(s, trace, cfg, 0, SERVE_KILL_STAGED, SERVE_KILL_DISPATCHED)
    torch.cuda.synchronize()
    print(f"# serve child: staged {SERVE_KILL_STAGED} ticks, dispatched "
          f"{s.ticks_dispatched}, {s.dispatches} dispatches", flush=True)
    time.sleep(CHILD_HOLD_S)
    return 0


def phase_serving_recovery(P, E, card, dev, guard):
    """Phase 9d: crash recovery on the card. A child process serves 9a's
    world with a WAL and checkpoints (every 8 dispatches of 4 ticks), acks
    the trace's first 110 ticks, dispatches 104 of them and is killed
    with SIGKILL; a fresh front door here recovers the checkpoint and
    replays the WAL suffix, and after the rest of the trace every acked
    job has placed exactly once and the state equals an uninterrupted
    deterministic run; the card-written files recover on the CPU (the
    plain version) to the same state."""
    import os
    import shutil
    import signal

    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )

    d = os.path.join(SERVE_DIR, "recovery")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    w0 = time.perf_counter()
    child = subprocess.Popen(serve_child_cmd(d, dev), stdout=subprocess.PIPE,
                             text=True)
    try:
        line = child.stdout.readline()
        if not line.startswith("# serve child:"):
            raise AssertionError(f"9d: the child printed {line!r}")
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - w0
    if child.returncode != -signal.SIGKILL:
        raise AssertionError(f"9d: the child ended {child.returncode}")
    cpu_dir = d + "-cpu"
    shutil.copytree(d, cpu_dir)
    trace = serve_trace(SERVE_C, SERVE_T)
    want_placed = sum(1 for r in trace for j in r if not j[5])
    results = {}
    for side, device, where in (("card", dev, d),
                                ("cpu", torch.device("cpu"), cpu_dir)):
        cfg, specs, kw = serve_child_args(P, where, device)
        w0 = time.perf_counter()
        s = guard.watch(ServingScheduler(f"serve-recover-{side}",
                                         specs, cfg, **kw))
        rec_s = time.perf_counter() - w0
        replayed, t0 = s.recovered_jobs, s.ticks_dispatched
        while s._staged_ticks() < SERVE_KILL_STAGED:  # the child sealed
            s.seal_tick()                              # them all
        feed_trace(s, trace, cfg, SERVE_KILL_STAGED, SERVE_T)
        s.dispatch_sealed()
        guard.check(f"9d recovered on the {side}")
        results[side] = (s.state_host(), replayed, t0, rec_s)
    ref = guard.watch(ServingScheduler(
        "serve-uninterrupted", serve_specs(P), serve_cfg(P), pacer=False,
        window=SERVE_CKPT_WINDOW, warm_k=(4,), k_cap=64, max_staged=10 ** 6,
        device=dev))
    feed_trace(ref, trace, ref.cfg, 0, SERVE_T)
    ref.dispatch_sealed()
    ref_host = ref.state_host()
    guard.check("9d uninterrupted")
    card_host, replayed, t0, rec_s = results["card"]
    require_equal(ref_host, card_host,
                  "9d recovered on the card vs the uninterrupted run")
    require_equal(card_host, results["cpu"][0],
                  "9d the card's files recovered on the CPU")
    placed = int(card_host[".placed_total"].sum())
    if placed != want_placed:
        raise AssertionError(f"9d: placed {placed}, acked {want_placed}")
    no_drops(card_host, "9d")
    print(f"phase 9d: a child served {SERVE_KILL_STAGED} ticks with a WAL "
          f"and checkpoints (every {SERVE_CKPT_EVERY} dispatches), "
          f"dispatched {SERVE_KILL_DISPATCHED}, SIGKILL after {child_s:.1f} "
          f"s; recovered at the checkpoint's {t0} dispatched ticks with "
          f"{replayed} WAL jobs replayed in {rec_s:.3f} s; every acked job "
          f"placed once ({placed}), the state == the uninterrupted run, "
          f"and == the same files recovered on the CPU [{card}]")


def live_cfg(P, policy, **kw):
    """bench.py bench_live's scheduler config (bench.py:1592-1596)."""
    base = dict(policy=policy, queue_capacity=1024, max_running=1024,
                max_arrivals=4 * LIVE_JOBS, max_ingest_per_tick=32,
                max_nodes=10, max_virtual_nodes=2, parity=True,
                trader=P.TraderConfig(enabled=False))
    base.update(kw)
    return P.SimConfig(**base)


def phase_live_constellation(P, E, card, dev, guard):
    """Phase 9e: bench_live's constellation (bench.py:1523-1697) on the
    card, without the traders (the card's machine has no gRPC): a registry,
    two DELAY hosts (``uniform_cluster(i, 10)``, a C=1 ``tick_io`` a tick),
    two workload clients of 2,000 jobs (Poisson 30 a virtual minute,
    durations under 10 s, seeds 10 and 11) at speed 100, and a log sink the
    hosts log to; at least 90% placed and no drops, one launch a tick.
    Then 200 ticks of one DELAY host and one FIFO host with borrowing,
    driven by hand over a fixed staged stream, each equal to the same on
    the CPU, every launch timed and 12 held against the plain version."""
    import dataclasses
    import os

    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.services.logsink import (
        LogSinkServer, set_client_logger,
    )
    from multi_cluster_simulator_tpu_torch.services.registry import (
        RegistryServer,
    )
    from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
        SchedulerService, job_to_json,
    )
    from multi_cluster_simulator_tpu_torch.services.workload import (
        WorkloadClientService,
    )

    speed = 100.0
    cfg = live_cfg(P, P.PolicyKind.DELAY)
    wcfg = P.WorkloadConfig(poisson_lambda_per_min=30.0, max_duration_s=10)
    os.makedirs(SERVE_DIR, exist_ok=True)
    log_path = os.path.join(SERVE_DIR, "grading.log")
    reg = RegistryServer(port=0, speed=speed)
    reg.start()
    sink = LogSinkServer(log_path, registry_url=reg.url)
    sink.start()
    procs = [reg, sink]
    fused_tick.reset_launches()
    try:
        scheds = []
        for i in (1, 2):
            s = guard.watch(SchedulerService(
                f"Sched{i}", P.uniform_cluster(i, 10), cfg,
                registry_url=reg.url, speed=speed, grpc_port=None,
                device=dev))
            s.start()  # one warm-up tick on a clone before the loop
            set_client_logger(s.logger, sink.url, "Scheduler")
            scheds.append(s)
            procs.append(s)
        t0 = time.perf_counter()
        ticks0 = [s.ticks_run for s in scheds]
        vt0 = [s.stats()["t_ms"] for s in scheds]
        placed0 = sum(s.stats()["placed_total"] for s in scheds)
        clients = []
        for i, s in enumerate(scheds, 1):
            c = WorkloadClientService(
                f"Client{i}", s.url, wcfg=dataclasses.replace(
                    wcfg, seed=9 + i), speed=speed, max_jobs=LIVE_JOBS)
            c.start()
            clients.append(c)
            procs.append(c)
        total = 2 * LIVE_JOBS
        deadline = time.perf_counter() + 600
        while time.perf_counter() < deadline:
            placed = sum(s.stats()["placed_total"] for s in scheds) - placed0
            if placed >= 0.98 * total and all(c.jobs_sent >= LIVE_JOBS
                                              for c in clients):
                break
            time.sleep(0.25)
        wall = time.perf_counter() - t0
        guard.check("9e", *scheds)
        stats = [s.stats() for s in scheds]
        placed = sum(st["placed_total"] for st in stats) - placed0
        ticks = [s.ticks_run - k for s, k in zip(scheds, ticks0)]
        vms = [st["t_ms"] - v for st, v in zip(stats, vt0)]
        drops = [s.state_host() for s in scheds]
    finally:
        for p in reversed(procs):
            p.shutdown()
    guard.check("9e shutdown")
    counts = {k: v for k, v in fused_tick.launch_counts().items() if v}
    all_ticks = sum(s.ticks_run for s in scheds) + len(scheds)  # + warm-ups
    check_launches(fused_tick.launch_counts(), "fused_prefix_delay", all_ticks,
                "9e live hosts")
    for i, h in enumerate(drops):
        no_drops(h, f"9e host {i + 1}")
    if placed < 0.9 * total:
        raise AssertionError(f"9e: placed {placed} of {total} in "
                             f"{wall:.1f} s")
    if not (os.path.exists(log_path) and os.path.getsize(log_path)):
        raise AssertionError("9e: the log sink received nothing")
    print(f"phase 9e: live constellation, 2 DELAY hosts x 2 clients x "
          f"{LIVE_JOBS} jobs at speed {speed:g}: placed {placed} of {total} "
          f"({placed / wall:.1f} jobs/s) in {wall:.3f} s, ticks {ticks}, "
          f"achieved speed {[round(v / 1e3 / wall, 1) for v in vms]}, host "
          f"ms a tick {[round(1e3 * wall / max(t, 1), 3) for t in ticks]} "
          f"(tick cost {[round(1e3 * wall / max(t, 1) - cfg.tick_ms / speed, 3) for t in ticks]}), "
          f"client 503 retries {sum(c.retries_503 for c in clients)}, "
          f"launches {counts}, 0 drops [{card}]")

    # 200 ticks of one host by hand, card against CPU, every launch timed
    records = []
    rng = np.random.default_rng(23)
    stream = []
    for t in range(LIVE_HAND_TICKS):
        stream.append([(100 * t + k, int(rng.integers(1, 17)),
                        int(rng.integers(100, 12_000)),
                        int(rng.integers(1_000, 10_001)),
                        bool(rng.integers(0, 15) == 0))
                       for k in range(int(rng.integers(0, 3)))])
    for policy, kind, form in (
            (P.PolicyKind.DELAY, "delay", "fused_prefix_delay"),
            (P.PolicyKind.FIFO, "fifo_emit", "fused_prefix_fifo_emit")):
        hcfg = live_cfg(P, policy, borrowing=policy is P.PolicyKind.FIFO)
        pair = {side: guard.watch(SchedulerService(
            f"hand-{kind}-{side}", P.uniform_cluster(1, 10), hcfg,
            grpc_port=None, device=d))
            for side, d in (("card", dev), ("cpu", "cpu"))}
        card_host = pair["card"]
        chk = Checker(card_host.engine)
        cost, shared = cost_of(kind, card_host.engine,
                               QC=hcfg.queue_capacity)
        fused_tick.reset_launches()
        endpoint = "/" if policy is P.PolicyKind.FIFO else "/delay"
        with ServeProbe(chk, cost, shared,
                        spread(LIVE_HAND_TICKS, 12)) as probe:
            for t, row in enumerate(stream):
                for h in pair.values():
                    for (j, co, m, du, other) in row:
                        ep = ("/delay" if endpoint == "/" else "/") \
                            if other else endpoint
                        fn = (h._handle_submit_delay if ep == "/delay"
                              else h._handle_submit_fifo)
                        code, _ = fn(json.dumps(job_to_json(
                            j, co, m, du)).encode(), {})
                        if code != 200:
                            raise AssertionError(f"9e hand {kind}: {code}")
                    h._tick_once()
        counts = fused_tick.launch_counts()
        guard.check(f"9e hand {kind}")
        check_launches(counts, form, LIVE_HAND_TICKS, f"9e hand {kind}")
        win = fused_tick.windowed_launch_counts()[form]
        if win != LIVE_HAND_TICKS:
            raise AssertionError(f"9e hand {kind}: {win} windowed launches")
        a = interop.to_numpy(card_host.state)
        require_equal(interop.to_numpy(pair["cpu"].state), a,
                      f"9e {LIVE_HAND_TICKS} hand ticks ({kind}) card vs CPU")
        no_drops(a, f"9e hand {kind}")
        sp = probe.summary()
        print(f"phase 9e: {LIVE_HAND_TICKS} ticks of a {kind} host by hand "
              f"(C=1, tick_io, windowed ring of {hcfg.max_arrivals}): card "
              f"== CPU, {form} x {counts[form]} (windowed), placed "
              f"{int(a['.placed_total'].sum())}; "
              f"{serve_us(sp['kernel_ms'])}, plain "
              f"{np.mean(chk.plain_ms):.3f} ms at {chk.n} comparisons "
              f"[{card}]")
        # DELAY's launches are the live constellation's, FIFO's these
        records.append(serve_record(
            form, f"9e live host C=1, {kind.split('_')[0]}, windowed",
            all_ticks if kind == "delay" else counts[form], chk.worst,
            chk.plain_ms, sp))
        tick_ms, clone_ms = lone_tick_ms(
            card_host, card_host._handle_submit_delay if endpoint == "/delay"
            else card_host._handle_submit_fifo, stream)
        print(f"phase 9e: the {kind} host alone, no probe, no twin: "
              f"{np.median(tick_ms):.3f} ms a tick (median of "
              f"{len(tick_ms)}, mean {np.mean(tick_ms):.3f}), of which its "
              f"state's clone {clone_ms:.3f} ms [{card}]")
    return dict(records=records)


def lone_tick_ms(host, submit, stream):
    """One live host's ``_tick_once`` timed alone (no probe, no CPU twin,
    no other thread): the stream's jobs again under new ids, each tick
    synchronized; and its state's clone alone, the mean of 100. Returns
    ([ms a tick], clone ms). The launches count as the host's own."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
        job_to_json,
    )

    out = []
    for row in stream:
        for (j, co, m, du, _) in row:
            submit(json.dumps(job_to_json(10 ** 6 + j, co, m, du)).encode(),
                   {})
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        host._tick_once()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - w0))
    w0 = time.perf_counter()
    for _ in range(100):
        clone_state(host.state)
    torch.cuda.synchronize()
    return out, 10.0 * (time.perf_counter() - w0)


def phase_services(P, E, card, dev):
    """Phases 9a-9e, under one ``ServiceGuard``."""
    guard = ServiceGuard()
    lap = lap_timer()
    out = {"a": phase_serving_parity(P, E, card, dev, guard)}
    lap("9a")
    out["b"] = phase_serving_throughput(P, E, card, dev, guard)
    lap("9b")
    out["c"] = phase_serving_tenants(P, E, card, dev, guard)
    lap("9c")
    phase_serving_recovery(P, E, card, dev, guard)
    lap("9d")
    out["e"] = phase_live_constellation(P, E, card, dev, guard)
    lap("9e")
    guard.check("phase 9")
    return out


# ---------------------------------------------------------------------------
# phases 10a-10f: the reference's single-device drivers on the port, each
# through its tool in multi_cluster_simulator_tpu_torch/tools/
# ---------------------------------------------------------------------------

# bench.py:2599-2630 bench_tournament's full sweep (48 variants x 4 seeds x
# 8 clusters, 30 s + 40 drain ticks) and the tool's default grid
SWEEP_GRID = dict(n_seeds=4, C=8, jobs_per=56, horizon_ms=30_000,
                  drain_ticks=40)
DEFAULT_GRID = dict(n_seeds=4, C=64, jobs_per=120, horizon_ms=240_000,
                    drain_ticks=80)
# the trainer's defaults, and its world at bench_env's batch shape
TRAIN_DEFAULT = dict(iters=10, n_envs=32, n_clusters=4, episode_ticks=20)
TRAIN_WIDE = dict(iters=2, n_envs=1024, n_clusters=8, episode_ticks=50)
CHAOS_CYCLES, CHAOS_JOBS, BATCH_KILLS = 1, 20_000, 1
BATCH_TICKS = 600  # 10d's run: churn_bursts quick's first 600 of 1,570 ticks
MARKET_AB_C, MARKET_AB_TIMED = (1024, 4096), 3
METRICS_PICKS = (4, 10)  # 10f's launches held against plain (of ~11-60)
PHASE10_DIR = "build/phase10"


def engaged_sources(policies) -> set:
    """The kernel sources a lineup's members launch."""
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    return {fused_tick.kernel_for(spec).lib
            for spec in PolicySet(tuple(policies)).specs}


def tournament_pass(P, E, card, dev, policies, grid, label, resume=None):
    """One grid through the port's tournament tool on the card (its own
    gates: every cell bitwise its standalone run, at most a launch a
    source a tick, no drops; with ``resume`` its cache written), the
    launches exactly one a tick for each engaged source, then the same
    lane run with the lane forms held against the plain per-lane loop at
    two ticks, and each source timed on its own lanes at the half-way
    state (``group_launches``). Returns (detail, records)."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.tools import tournament as T

    detail = T.run_tournament(policies=policies, device=dev,
                              resume_path=resume, **grid)
    n = detail["ticks"]
    want = {lib: n for lib in engaged_sources(policies)}
    if detail["kernel_launches"] != want:
        raise AssertionError(f"{label}: launches {detail['kernel_launches']},"
                             f" want {want}")
    cfg, specs, _, _, padded, _ = T.grid_inputs(
        grid["n_seeds"], grid["C"], grid["jobs_per"], grid["horizon_ms"],
        grid["drain_ticks"])
    pset = PolicySet(tuple(policies))
    eng = E.Engine(cfg, device=dev, policies=pset)
    vparams = [pset.params_for(cfg, name, device=dev) for name in policies]
    lanes = [(v, si) for v in range(len(policies))
             for si in range(grid["n_seeds"])]
    params, sta, s0 = T.stack_grid(lanes, vparams, padded, cfg, specs, dev)
    probe = LaneProbe(lambda b, a, r, c, t: (0, 0, 0), picks=(1, n // 2))
    with probe:
        eng.run(clone_state(s0), sta, n, params)
    sp = probe.summary()
    tick = n // 2
    half = eng.run(clone_state(s0), cut_ticks(sta, tick), tick, params)
    rows = torch.from_numpy(np.ascontiguousarray(sta.rows[:, tick])).to(dev)
    cnts = torch.from_numpy(np.ascontiguousarray(sta.counts[:, tick])).to(dev)
    QC = cfg.queue_capacity
    costs = {
        "fused_prefix_fifo": lambda b, a, r, c, t, tess: (
            *tick_bytes(b, a, r, c, t, False), 0),
        "fused_prefix_ffd": lambda b, a, r, c, t, tess: tick_cost_ffd(
            b, a, r, c, t, False, QC),
        "fused_prefix_delay": lambda b, a, r, c, t, tess: tick_cost_delay(
            b, a, r, c, t, False, QC),
        "fused_prefix_scored": lambda b, a, r, c, t, tess: tick_cost_scored(
            b, a, r, c, t, False, QC, tess)}
    groups = group_launches(eng, half, rows, cnts, (tick + 1) * cfg.tick_ms,
                            params, costs, LANE_REPS)
    print(f"{label}: {len(policies)} variants x {grid['n_seeds']} seeds x "
          f"{grid['C']} clusters = {detail['lanes']} lanes, {n} ticks: "
          f"launches {detail['kernel_launches']} (one a source a tick); "
          f"every cell == its standalone run; grid wall "
          f"{detail['tournament_wall_s']} s against the serial loop's "
          f"{detail['serial_loop_wall_s']} s ({detail['speedup_vs_serial']}x);"
          f" {sp['compared']} ticks == the plain per-lane loop (plain "
          f"{np.mean(sp['plain_ms']):.2f} ms a tick); ranking top "
          f"{[a['policy'] for a in detail['ranking'][:3]]} [{card}]")
    recs = []
    for lib in sorted(groups):
        g = groups[lib]
        b_ms, b_by = bound(g["read"], g["written"], g["ops"])
        print(f"{label}: {lib} on its {g['lanes']} lanes: "
              f"{g['ms'] * 1e3:.2f} us/launch over {LANE_REPS}, plain on "
              f"those lanes {g['plain_ms']:.3f} ms, bound "
              f"{b_ms * 1e3:.4f} us by {b_by} [{card}]")
        recs.append(dict(kernel=fused_tick.KERNELS[lib],
                         name=f"{lib} ({label}, lanes {detail['lanes']}x"
                              f"{grid['C']})",
                         launches=detail["kernel_launches"][lib],
                         worst=sp["worst"], ms=g["ms"], plain=[g["plain_ms"]],
                         bound=(b_ms, b_by)))
    return detail, recs


def phase_tournament(P, E, card, dev):
    """Phase 10a: the port's tournament tool at full width on the card:
    (i) bench.py's full sweep, ``sweep_policies()`` x 4 seeds x 8 clusters
    (192 lanes; one DELAY and one scored launch a tick); (ii) the tool's
    default, the 8-member lineup x 4 seeds x 64 clusters (32 lanes, one
    launch a source a tick), its verified cells written to a resume cache;
    (iii) that cache with one variant deleted: a rerun runs only its
    lanes and the merged rows equal (ii)'s."""
    import json
    import os

    from multi_cluster_simulator_tpu_torch.tools import tournament as T

    sweep, recs = tournament_pass(P, E, card, dev, T.sweep_policies(),
                                  SWEEP_GRID, "phase 10a (i) sweep")
    os.makedirs(PHASE10_DIR, exist_ok=True)
    cache = os.path.join(PHASE10_DIR, "tournament_cells.json")
    if os.path.exists(cache):
        os.remove(cache)
    default, recs2 = tournament_pass(P, E, card, dev, T.DEFAULT_POLICIES,
                                     DEFAULT_GRID, "phase 10a (ii) default",
                                     resume=cache)
    with open(cache) as f:
        c = json.load(f)
    del c["completed"]["ffd-memfirst"]
    with open(cache, "w") as f:
        json.dump(c, f)
    again = T.run_tournament(policies=T.DEFAULT_POLICIES, device=dev,
                             resume_path=cache, **DEFAULT_GRID)
    rows = [{k: v for k, v in r.items() if k != "resumed"}
            for r in again["rows"]]
    resumed = [p for p in T.DEFAULT_POLICIES if p != "ffd-memfirst"]
    if rows != default["rows"] or again["resumed_variants"] != resumed or \
            again["lanes"] != DEFAULT_GRID["n_seeds"]:
        raise AssertionError(f"10a (iii): resumed {again['resumed_variants']}"
                             f", {again['lanes']} lanes, rows equal "
                             f"{rows == default['rows']}")
    print(f"phase 10a (iii): the cache without ffd-memfirst resumed 7 "
          f"variants and ran {again['lanes']} lanes; rows == (ii)'s, grid "
          f"digest {again['grid_digest']} [{card}]")
    return dict(records=recs + recs2, sweep=sweep, default=default)


def phase_train(P, E, card, dev):
    """Phase 10b: the port's ES trainer on the card: its defaults (32 envs
    x 4 clusters x 20 ticks, 10 iterations) with one scored launch a step
    and the scored lane form == the plain per-lane loop at two steps; then
    its world at bench_env's batch shape (1,024 envs x 8 clusters, 50-tick
    episodes, 2 iterations), the wall split into draws, steps and update,
    cut after iteration 1 and resumed with the returns and the head bitwise
    the uninterrupted run's."""
    import os

    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.tools import train_env_demo as TE

    QC = TE.train_cfg().queue_capacity
    probe = LaneProbe(lambda b, a, r, c, t: tick_cost_scored(
        b, a, r, c, t, False, QC, False), picks=(1, 101))
    fused_tick.reset_launches()
    with probe:
        res = TE.train(**TRAIN_DEFAULT, device=dev)
    counts = fused_tick.launch_counts()
    steps = TRAIN_DEFAULT["iters"] * TRAIN_DEFAULT["episode_ticks"]
    expect_lane_launches(counts, {"fused_prefix_scored"}, steps, "10b")
    sp = probe.summary()
    if not np.isfinite(res["mean_return_per_iter"]).all() or \
            res["head_norm"] == 0.0:
        raise AssertionError(f"10b: returns {res['mean_return_per_iter']}, "
                             f"head norm {res['head_norm']}")
    print(f"phase 10b: defaults {TRAIN_DEFAULT}: {steps} scored lane "
          f"launches, {sp['compared']} steps == the plain per-lane loop; "
          f"returns {[round(m, 4) for m in res['mean_return_per_iter']]}, "
          f"head norm {res['head_norm']:.4f}, "
          f"{res['episodes_simulated'] / res['wall_s']:.1f} episodes/s "
          f"(the probe's timing included) [{card}]")
    full = TE.train(**TRAIN_WIDE, device=dev, timings=True)
    os.makedirs(PHASE10_DIR, exist_ok=True)
    ck = os.path.join(PHASE10_DIR, "train.ckpt")
    if os.path.exists(ck):
        os.remove(ck)
    TE.train(**{**TRAIN_WIDE, "iters": 1}, device=dev, checkpoint=ck)
    res2 = TE.train(**TRAIN_WIDE, device=dev, checkpoint=ck, resume=True)
    if res2["mean_return_per_iter"] != full["mean_return_per_iter"] or \
            not np.array_equal(res2["W"], full["W"]):
        raise AssertionError("10b: the resumed training differs from the "
                             "uninterrupted run")
    sp_ = full["split"]
    print(f"phase 10b: {TRAIN_WIDE}: returns "
          f"{[round(m, 4) for m in full['mean_return_per_iter']]}, "
          f"{full['episodes_simulated'] / full['wall_s']:.1f} episodes/s "
          f"({full['wall_s']} s); an iteration: draws "
          f"{np.mean(sp_['draws_s']) * 1e3:.1f} ms, steps "
          f"{np.mean(sp_['steps_s']) * 1e3:.1f} ms "
          f"({np.mean(sp_['steps_s']) * 1e3 / TRAIN_WIDE['episode_ticks']:.2f}"
          f" ms a step), update {np.mean(sp_['update_s']) * 1e3:.1f} ms; cut "
          f"after iteration 1 and resumed: returns and head bitwise [{card}]")
    b_ms, b_by = bound(sp["read"], sp["written"], sp["ops"])
    return dict(record=dict(
        kernel=fused_tick.KERNELS["fused_prefix_scored"],
        name=f"fused_prefix_scored (10b trainer, lanes "
             f"{TRAIN_DEFAULT['n_envs']}x{TRAIN_DEFAULT['n_clusters']})",
        launches=counts["fused_prefix_scored"], worst=sp["worst"],
        ms=float(np.mean(sp["kernel_ms"])), plain=sp["plain_ms"],
        bound=(b_ms, b_by)))


def phase_chaos(P, E, card, dev):
    """Phases 10c-10d and 11c's chaos cell: the port's chaos harness with
    its children on the card, the three cells at once (each waits mostly
    on its children's start-ups; 10d and 11c's in worker threads). 10c:
    one kill -9 cycle of a serving child under live HTTP traffic (the FIFO
    emit+tap form at chaos_cfg's shape), the recovered checkpoint bitwise
    the in-process reference fed the WAL on the card and bitwise the one
    on the CPU (the plain version), every acked job placed once, zero
    drops. 10d: the resumable churn_bursts batch child (the FIFO faults
    form on compact state under compression) killed with SIGKILL at one
    random chunk boundary and stopped with SIGTERM (exit 75) at one, its
    final checkpoint bitwise the uninterrupted child's on the CPU (the
    plain version) and the executed-tick cursor telescoping. 11c: the
    same batch over 2 ranks on the card, killed with SIGKILL once, its
    final checkpoint bitwise the uninterrupted 2-rank child's on the CPU,
    which is bitwise the one-process run on the CPU (the plain
    version)."""
    import concurrent.futures
    import os
    import shutil
    import tempfile

    from multi_cluster_simulator_tpu_torch.tools import chaos

    w0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="mcs-chaos-batch-")
    os.makedirs(MESH_DIR, exist_ok=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            one = pool.submit(chaos._batch_scenario, 1, BATCH_KILLS,
                              workdir, np.random.default_rng(101),
                              device=str(dev), ticks=BATCH_TICKS,
                              ref_device="cpu")
            mesh = pool.submit(chaos._batch_scenario, 2, 1, MESH_DIR,
                               np.random.default_rng(7), sigterm_cycles=0,
                               device=str(dev), ticks=MESH_CHAOS_TICKS,
                               ref_device="cpu")
            rep = chaos.run_chaos(CHAOS_CYCLES, CHAOS_JOBS, None, None,
                                  device=dev, ref_devices=(dev, "cpu"))
            w_serve = time.perf_counter() - w0
            s, m = one.result(), mesh.result()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"phase 10c: {rep['cycles']} kill -9 cycles under live traffic, "
          f"{rep['jobs_acked']} jobs acked, {rep['wal_records']} WAL records "
          f"({rep['duplicate_resubmits']} duplicates), placed "
          f"{rep['placed_total']}, {rep['ticks_dispatched']} ticks; the state"
          f" the card recovered bitwise the in-process reference on each of "
          f"{rep['reference_devices']} (the CPU's the plain version); "
          f"{w_serve:.1f} s beside 10d and 11c's chaos cell [{card}]")
    print(f"phase 10d: churn_bursts quick (compact, compressed, trace churn) "
          f"on {s['device']}: {s['kills']} kill -9 at ticks "
          f"{s['boundaries_killed_at_tick']} + {s['sigterm_preemptions']} "
          f"SIGTERM (exit 75), {s['completed_before_signal']} incarnations "
          f"finished first; final checkpoint bitwise the uninterrupted "
          f"child's on {s['reference_device']} (the plain version), ticks "
          f"executed {s['ticks_executed_compressed']} of {s['ticks_total']} "
          f"telescoped; {s['wall_s']} s beside 10c [{card}]")
    print(f"phase 11c: chaos --batch over 2 ranks on the card, the first "
          f"{MESH_CHAOS_TICKS} ticks: {m['kills']} kill -9 (SIGTERM's "
          f"save-and-exit is 10d's), the final checkpoint bitwise the "
          f"uninterrupted 2-rank child's on {m['reference_device']}, and "
          f"that bitwise the one-process run on "
          f"{m['one_process_device']} (the plain version), cursors "
          f"telescoped, {m['wall_s']} s beside 10c [{card}]")


class ComparingProbe:
    """Stands in for ``fused_tick.fused_prefix`` during a tool's runs: at
    the card launches whose ordinal is in ``picks`` the launch's own form
    (the emit outputs, and with the plane the buffer and the cursor, held
    too; windowed or not) is held against its plain version
    (``Checker.compare``) on the state the run reached, the comparison's
    launches left out of the counts; every launch goes on untimed. Without
    ``chk`` the checker is made for the first engine that launches on the
    card, with that launch's params; launches on the CPU (the plain path
    already) pass through."""

    def __init__(self, chk, picks):
        from multi_cluster_simulator_tpu_torch.kernels import fused_tick

        self.ft, self.chk, self.picks, self.n = fused_tick, chk, set(picks), 0
        self.real = fused_tick.fused_prefix
        self.forms = set()  # the forms compared

    def __enter__(self):
        self.ft.fused_prefix = self
        return self

    def __exit__(self, *exc):
        self.ft.fused_prefix = self.real

    def __call__(self, engine, state, rows, counts, t, params, host,
                 emit_returns=False, out=None, obs=None, windowed=False):
        if state.device.type == "cuda":
            if self.chk is None:
                self.chk = Checker(engine, params)
            if self.n in self.picks:  # the comparison's launch not counted
                self.forms.add(self.chk.host[
                    ("emit_" if emit_returns else "")
                    + ("tap_kernel" if obs is not None else "kernel")].name)
                saved = [(k, k.launches, k.windowed_launches)
                         for k in self.ft.KERNELS.values()]
                self.ft.fused_prefix = self.real
                try:
                    self.chk.compare(state, rows, counts, t,
                                     emit=emit_returns, obs=obs,
                                     windowed=windowed)
                finally:
                    self.ft.fused_prefix = self
                    for k, n, nw in saved:
                        k.launches, k.windowed_launches = n, nw
            self.n += 1
        return self.real(engine, state, rows, counts, t, params, host,
                         emit_returns, out, obs, windowed)


def phase_market_ab(P, E, card, dev):
    """Phase 10e: the port's matcher A/B on the card: greedy and sinkhorn
    at 1,024 and 4,096 clusters (``sinkhorn_market_setup``, 400 jobs a
    cluster over the windowed stream; cvx runs at 3j's quick shape only),
    with the launches counted (the DELAY form once a tick a run) and the kernel held against its plain
    version at two ticks of the first run. The sinkhorn row at 4,096 is
    BASELINE config 4: three timed runs, and bench.py:1060-1082's gates
    (>= 85% placed, >= 1,000 virtual nodes, zero drops); the other rows
    are one timed run each, reported as the reference's A/B reports
    them."""
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.tools import market_ab as MA
    from multi_cluster_simulator_tpu_torch.tools import tournament as T

    for C in MARKET_AB_C:
        for m in ("greedy", "sinkhorn"):
            cfg, specs, arr, n = MA.sinkhorn_market_setup(
                C, MA.JOBS_PER, MA.HORIZON_MS, matching=m)
            chk = Checker(E.Engine(cfg, device=dev))
            runs = MARKET_AB_TIMED if (m, C) == ("sinkhorn", MARKET_C) else 1
            fused_tick.reset_launches()
            with ComparingProbe(chk, picks=(120, 400)):
                r = MA.run_one(m, C, device=dev, runs=runs, warmups=0)
            counts = {k: v for k, v in T.source_launches(
                fused_tick.launch_counts()).items() if v}
            want = {"fused_prefix_delay": runs * n}
            if counts != want:
                raise AssertionError(f"10e {m}@{C}: launches {counts}, "
                                     f"want {want}")
            if (m, C) == ("sinkhorn", MARKET_C) and (
                    any(r["drops"].values())
                    or r["placed_frac"] < MARKET_FLOOR
                    or r["virtual_nodes_traded"] < VNODE_FLOOR):
                raise AssertionError(f"10e config 4: placed "
                                     f"{r['placed_frac']}, vnodes "
                                     f"{r['virtual_nodes_traded']}, drops "
                                     f"{r['drops']}")
            r.pop("final")
            print(f"phase 10e: {m}@{C}: placed {r['placed']} of {r['of']} "
                  f"({r['placed_frac']}), vnodes {r['virtual_nodes_traded']},"
                  f" drops {sum(r['drops'].values())}, mean wait "
                  f"{r['mean_avg_wait_ms']} ms (p95 "
                  f"{r['p95_avg_wait_ms']}), walls {r['walls']} s (min "
                  f"{r['wall_s']}), {runs * n} DELAY "
                  f"launches; kernel == plain at {chk.n} ticks (plain "
                  f"{np.mean(chk.plain_ms):.3f} ms); market {r['market']} "
                  f"[{card}]")


def phase_metrics_smoke(P, E, card, dev):
    """Phase 10f: the port's metrics_smoke on the card: its ``main``
    returns 0, and the form its front door launches (the FIFO emit+tap
    form at the smoke's 4 clusters) is held against its plain version at
    two ticks of the window."""
    import contextlib
    import io

    from multi_cluster_simulator_tpu_torch.tools import metrics_smoke

    w0 = time.perf_counter()
    err = io.StringIO()
    with ComparingProbe(None, picks=METRICS_PICKS) as probe:
        try:
            with contextlib.redirect_stderr(err):
                rc = metrics_smoke.main(["--device", str(dev)])
        except BaseException:
            print(err.getvalue()[-3000:], file=sys.stderr)
            raise
    if rc != 0 or probe.chk is None or probe.chk.n != len(METRICS_PICKS):
        raise AssertionError(f"10f: metrics_smoke returned {rc}, "
                             f"{0 if probe.chk is None else probe.chk.n} "
                             f"comparisons in {probe.n} launches:\n"
                             f"{err.getvalue()[-3000:]}")
    line = [ln for ln in err.getvalue().splitlines()
            if "metrics_smoke OK" in ln]
    print(f"phase 10f: {line[-1].lstrip('# ')}; main returned 0; "
          f"{sorted(probe.forms)} == plain at {probe.chk.n} ticks of its "
          f"{probe.n} launches (plain "
          f"{np.mean(probe.chk.plain_ms):.3f} ms); "
          f"{time.perf_counter() - w0:.1f} s [{card}]")


# phase 11: the parity gate on the card (11a), the mesh on one card (11b),
# the mesh's tools (11c)
PARITY_FLOOR = 100  # bench.py:1405: events compared over the scenarios
MESH_RANKS = 4  # 11b-11c's rank processes, all sharing the card
MESH_BORROW_C, MESH_BORROW_TICKS, MESH_BORROW_TICKS_4 = 64, 50, 12
MESH_TRADER_C, MESH_TRADER_TICKS = 64, 200
MESH_SINK_C, MESH_SINK_TICKS = 256, 200
MESH_FFD_C, MESH_FFD_TICKS = 16, 150
MESH_CUT = 800  # 11b's mesh cut of the headline
MESH_FLOAT_RTOL, MESH_FLOAT_ATOL = 1e-5, 1e-6  # tests/test_torch_market.py
COLLECTIVE_REPS, COLLECTIVE_REPS_4 = 200, 50  # over 2 ranks, over 4
WEAK_PER_RANK, WEAK_JOBS, WEAK_HORIZON_MS = 4096, 100, 200_000
MESH_CHAOS_TICKS = 300
MESH_DIR = "build/phase11"


def parity_scenarios(P):
    """bench.py:1266 bench_parity_tpu's eight scenarios (:1336-1377), as
    the port's: each a dict of name, config, specs, seed, ticks, the
    stream's largest cores and memory, the clusters silenced (None: none)
    and the mechanism the scenario must fire (``require``: None,
    "lent_at_1", "lent_any" or "market"; bench.py:1310-1327)."""
    import dataclasses
    import os

    R = dataclasses.replace
    small = P.load_cluster_json(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "assets",
        "cluster_small.json"))
    base = P.SimConfig(record_trace=True, queue_capacity=64,
                       max_running=512, max_arrivals=2048, max_nodes=12,
                       max_ingest_per_tick=128)
    heavy = P.WorkloadConfig(poisson_lambda_per_min=40.0)
    overload = P.WorkloadConfig(poisson_lambda_per_min=60.0)
    borrow = [P.uniform_cluster(1, 3, cores=16, memory=8_000),
              P.uniform_cluster(2, 10)]
    eight = [P.uniform_cluster(c + 1, 3, cores=16, memory=8_000)
             if c % 2 == 0 else P.uniform_cluster(c + 1, 10)
             for c in range(8)]
    DELAY, FIFO, FFD = (P.PolicyKind.DELAY, P.PolicyKind.FIFO,
                        P.PolicyKind.FFD)
    market = R(base, policy=DELAY, workload=overload, queue_capacity=512,
               max_virtual_nodes=4, trader=P.TraderConfig(enabled=True))
    rows = [
        ("delay_small", R(base, policy=DELAY), [small], 9, 400, 32, 24_000,
         None, None),
        ("delay_heavy", R(base, policy=DELAY, workload=heavy,
                          queue_capacity=256), [small], 3, 300, 32, 24_000,
         None, None),
        ("delay_packed", R(base, policy=DELAY, workload=heavy,
                           queue_capacity=256), [small], 17, 400, 8, 6_000,
         None, None),
        ("fifo_small", R(base, policy=FIFO), [small], 9, 400, 32, 24_000,
         None, None),
        ("fifo_borrowing", R(base, policy=FIFO, borrowing=True,
                             workload=heavy, queue_capacity=256), borrow, 7,
         300, 16, 8_000, 1, "lent_at_1"),
        ("ffd", R(base, policy=FFD, workload=heavy, queue_capacity=256),
         [small], 13, 200, 32, 24_000, None, None),
        ("trader_market", market, borrow, 21, 300, 16, 8_000, 1, "market"),
        ("fifo_borrowing_8c", R(base, policy=FIFO, borrowing=True,
                                workload=heavy, queue_capacity=256), eight,
         27, 300, 16, 8_000, slice(1, None, 2), "lent_any"),
    ]
    keys = ("name", "cfg", "specs", "seed", "n_ticks", "max_cores",
            "max_mem", "silence", "require")
    return [dict(zip(keys, row)) for row in rows]


def parity_arrivals(P, sc):
    """A scenario's stream (the reference's generator, silenced where the
    scenario says)."""
    from multi_cluster_simulator_tpu_torch.workload.generator import (
        generate_arrivals, silence_clusters,
    )

    cfg = sc["cfg"]
    arr = generate_arrivals(cfg.workload, len(sc["specs"]),
                            cfg.max_arrivals, sc["n_ticks"] * cfg.tick_ms,
                            sc["max_cores"], sc["max_mem"], seed=sc["seed"])
    return arr if sc["silence"] is None else silence_clusters(
        arr, sc["silence"])


def parity_require(sc, oracle) -> None:
    """bench.py:1310-1327: the scenario fired its mechanism."""
    need = sc["require"]
    lenders = {e[1] for e in oracle.trace if e[4] == 4}
    if need == "lent_at_1" and 1 not in lenders:
        raise AssertionError(f"parity[{sc['name']}]: no lent placement at "
                             "the lender")
    if need == "lent_any" and not lenders:
        raise AssertionError(f"parity[{sc['name']}]: nobody lent")
    if need == "market":
        n = sc["cfg"].max_nodes
        if not any(cl.active[n] for cl in oracle.clusters):
            raise AssertionError(f"parity[{sc['name']}]: no virtual node")
        if not any(e[3] >= n for e in oracle.trace):
            raise AssertionError(f"parity[{sc['name']}]: no placement on a "
                                 "virtual node")


PARITY_PLAIN_PKL = "build/phase11/parity_plain.pkl"  # under the script's dir


def parity_plain_runs(P, E) -> dict:
    """11a's plain runs: every scenario through the port's plain version on
    the CPU, its final state's leaves by name."""
    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core.state import init_state

    out = {}
    for sc in parity_scenarios(P):
        cfg = sc["cfg"]
        out[sc["name"]] = interop.to_numpy(E.Engine(cfg, device="cpu").run(
            init_state(cfg, sc["specs"], device="cpu"),
            parity_arrivals(P, sc), sc["n_ticks"]))
    return out


def start_parity_plain():
    """11a's plain runs (``parity_plain_runs``) in a process of its own on
    one CPU core, started beside the build and the earlier phases, their
    states pickled to ``PARITY_PLAIN_PKL``. Phase 11a waits for it;
    ``main`` stops it on every way out."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(here, PARITY_PLAIN_PKL)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    code = ("import os, pickle, torch\n"
            "torch.set_num_threads(1)\n"
            "import chip_smoke as cs\n"
            "import multi_cluster_simulator_tpu_torch as P\n"
            "from multi_cluster_simulator_tpu_torch.core import engine as E\n"
            "out = cs.parity_plain_runs(P, E)\n"
            "os.makedirs(os.path.dirname(cs.PARITY_PLAIN_PKL), exist_ok=True)\n"
            "with open(cs.PARITY_PLAIN_PKL, 'wb') as f:\n"
            "    pickle.dump(out, f)\n")
    log = open(out + ".log", "w")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=here,
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    proc.out = out
    return proc


def phase_parity(P, E, card, dev, plain_proc):
    """Phase 11a: bench.py:1266 bench_parity_tpu on the card: every
    scenario at its full horizon through the port's kernels (the windowed
    stream, ``record_trace``), every cluster's trace == the port's copy of
    the Go-semantics oracle (``oracle/go_semantics.py``), zero drops, each
    scenario's mechanism fired, more than 100 events compared; each final
    state == the plain version's, run on the CPU by the process
    ``start_parity_plain`` started at the script's entry (the plain
    version on the card takes ~46 ms a tick at these shapes)."""
    import os
    import pickle

    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.oracle import Oracle
    from multi_cluster_simulator_tpu_torch.utils.trace import (
        assert_no_drops, extract_trace, oracle_trace_per_cluster,
    )

    w0 = time.perf_counter()
    events, kernel_s, oracle_s = 0, 0.0, 0.0
    launches, finals = {}, {}
    for sc in parity_scenarios(P):
        cfg, specs, n = sc["cfg"], sc["specs"], sc["n_ticks"]
        arr = parity_arrivals(P, sc)
        engine = E.Engine(cfg, device=dev)
        s0 = init_state(cfg, specs, device=dev)
        torch.cuda.synchronize()
        fused_tick.reset_launches()
        k0 = time.perf_counter()
        out = engine.run(s0, arr, n)
        torch.cuda.synchronize()
        kernel_s += time.perf_counter() - k0
        counts = {k: v for k, v in fused_tick.launch_counts().items() if v}
        if sum(counts.values()) != n or len(counts) != 1:
            raise AssertionError(f"11a {sc['name']}: launches {counts}, "
                                 f"want one kernel {n} times")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        o0 = time.perf_counter()
        oracle = Oracle(cfg, list(specs), arr).run(n)
        oracle_s += time.perf_counter() - o0
        assert_no_drops(out)
        parity_require(sc, oracle)
        got, want = extract_trace(out), oracle_trace_per_cluster(
            oracle, len(specs))
        for c in range(len(specs)):
            if got[c] != want[c]:
                first = next(i for i, (a, b) in enumerate(
                    zip(got[c] + [None], want[c] + [None])) if a != b)
                raise AssertionError(
                    f"11a {sc['name']}: cluster {c} trace diverges from the "
                    f"oracle at event {first}: {got[c][first:first + 1]} "
                    f"against {want[c][first:first + 1]}")
            events += len(want[c])
        finals[sc["name"]] = interop.to_numpy(out)
        print(f"phase 11a: {sc['name']}: {len(specs)} clusters, {n} ticks, "
              f"{sum(map(len, want))} events == the oracle's, zero drops; "
              f"launches {counts} [{card}]")
    p0 = time.perf_counter()
    rc = plain_proc.wait(timeout=900)
    if rc != 0 or not os.path.exists(plain_proc.out):
        with open(plain_proc.out + ".log") as f:
            raise RuntimeError(f"11a: the plain runs failed (rc {rc}):\n"
                               f"{f.read()[-3000:]}")
    with open(plain_proc.out, "rb") as f:
        plain = pickle.load(f)
    plain_s = time.perf_counter() - p0
    for name, want in plain.items():
        bad = numpy_diff(want, finals[name])
        if bad or set(want) != set(finals[name]):
            raise AssertionError(f"11a {name}: the kernel's run differs from "
                                 f"the plain version at {bad[:6]}")
    if events <= PARITY_FLOOR or len(plain) != len(finals):
        raise AssertionError(f"11a: {events} events compared, want more "
                             f"than {PARITY_FLOOR}; {len(plain)} plain runs")
    print(f"phase 11a: parity gate on {torch.cuda.get_device_name(0)}: 8 "
          f"scenarios, {events} events compared, all == the Go-semantics "
          f"oracle, every final state == the plain version's (CPU); wall "
          f"{time.perf_counter() - w0:.1f} s (the kernel's runs "
          f"{kernel_s:.2f} s, the oracle {oracle_s:.2f} s, waiting for the "
          f"plain runs' process {plain_s:.2f} s); "
          f"launches {launches} [{card}]")
    return dict(events=events, launches=launches)


def mesh_world(P, E, name):
    """A mesh cell's world, built alike by every rank and by the one-process
    run it is held against: config, specs, the tick-indexed chunks, and
    the run's form (``compress``, ``metrics``, ``cut``)."""
    from multi_cluster_simulator_tpu_torch.workload.generator import (
        generate_arrivals,
    )
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    w = dict(compress=False, metrics=False, cut=None, policies=None)
    if name in ("headline", "plane", "cut"):
        cfg, specs, arr, n = headline_world(P, E)
        w.update(cfg=cfg, specs=specs, n_ticks=n, arr=arr,
                 chunks=E.pack_arrivals_chunks(arr, chunk_sizes(n),
                                               cfg.tick_ms),
                 metrics=name == "plane",
                 cut=MESH_CUT if name == "cut" else None)
    elif name in ("borrow64", "borrow64_4"):
        # its first ticks only: ~6 staged collectives a tick, each a few
        # ms of host time over 2 ranks sharing the card and more over 4
        # (the "one staged collective" lines)
        n = MESH_BORROW_TICKS if name == "borrow64" else MESH_BORROW_TICKS_4
        cfg = borrow_cfg(P, {})
        chunks, _ = borrow_stream(P, E, MESH_BORROW_C, n)
        w.update(cfg=cfg, specs=borrow_specs(P, MESH_BORROW_C), n_ticks=n,
                 chunks=chunks)
    elif name == "delay_trader":
        # tests/test_sharded.py:86's world, 8 clusters widened to 64
        C = MESH_TRADER_C
        cfg = P.SimConfig(policy=P.PolicyKind.DELAY, record_trace=True,
                          queue_capacity=256, max_running=256,
                          max_arrivals=2048, max_nodes=12,
                          max_virtual_nodes=4,
                          trader=P.TraderConfig(enabled=True),
                          workload=P.WorkloadConfig(
                              poisson_lambda_per_min=40.0))
        specs = [P.uniform_cluster(c + 1, 10) if c % 4 == 3 else
                 P.uniform_cluster(c + 1, 3, cores=16, memory=8_000)
                 for c in range(C)]
        arr = generate_arrivals(cfg.workload, C, cfg.max_arrivals,
                                MESH_TRADER_TICKS * 1_000, 16, 8_000,
                                seed=32)
        arr.n[3::4] = 0  # the big clusters sell
        w.update(cfg=cfg, specs=specs, n_ticks=MESH_TRADER_TICKS,
                 chunks=E.pack_arrivals_chunks(arr, [MESH_TRADER_TICKS],
                                               cfg.tick_ms))
    elif name == "sinkhorn256":
        cfg = market_cfg(P, quick=True, jobs=MARKET_QUICK[1],
                         trader=SINKHORN)
        chunks, _, _ = market_stream(E, MESH_SINK_C, MARKET_QUICK[1],
                                     quick=True)
        w.update(cfg=cfg, specs=market_specs(P, MESH_SINK_C),
                 n_ticks=MESH_SINK_TICKS,
                 chunks=first_ticks(chunks, MESH_SINK_TICKS))
    elif name == "sparse":
        cfg = sparse_cfg(P)
        arr, n = sparse_stream(SPARSE_C)
        w.update(cfg=cfg, specs=[P.uniform_cluster(c + 1, 5)
                                 for c in range(SPARSE_C)], n_ticks=n,
                 chunks=E.pack_arrivals_chunks(arr, chunk_sizes(n),
                                               cfg.tick_ms), compress=True)
    elif name == "ffd":
        # tests/test_sharded.py:257's FFD wave world
        cfg = P.SimConfig(policy=P.PolicyKind.FFD, parity=False,
                          max_placements_per_tick=16, queue_capacity=32,
                          max_running=48, max_arrivals=96,
                          max_ingest_per_tick=8, max_nodes=5,
                          max_virtual_nodes=0, n_res=2)
        arr = uniform_stream(MESH_FFD_C, 96, MESH_FFD_TICKS * 1_000,
                             max_cores=32, max_mem=24_000,
                             max_dur_ms=40_000, seed=11)
        w.update(cfg=cfg, specs=[P.uniform_cluster(c + 1, 5)
                                 for c in range(MESH_FFD_C)],
                 n_ticks=MESH_FFD_TICKS,
                 chunks=E.pack_arrivals_chunks(arr, [MESH_FFD_TICKS],
                                               cfg.tick_ms))
    else:
        raise ValueError(name)
    return w


def mesh_cell(mesh, name):
    """One rank's part of an 11b cell (run by ``parallel.launch``): the
    world's shard through ``ShardedEngine.run_fn`` chunk by chunk (the
    kernel launched once a tick over the rank's clusters), every launch
    count set to 0 just before and read just after, the wall between two
    barriers. The cut cell stops at ``MESH_CUT`` and gathers its shards
    into one checkpoint file. Rank 0 returns the gathered state (the
    ``collect_metrics`` buffer too), every rank its launches, wall and
    collectives."""
    import torch.distributed as dist

    import multi_cluster_simulator_tpu_torch as P
    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core import engine as E
    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs import device as D
    from multi_cluster_simulator_tpu_torch.parallel import ShardedEngine

    w = mesh_world(P, E, name)
    cfg = w["cfg"]
    sh = ShardedEngine(cfg, mesh)
    g0 = init_state(cfg, w["specs"], device="cpu")
    state = sh.shard_state(g0)
    mb = sh.shard_metrics(D.metrics_init(g0)) if w["metrics"] else None
    chunks = [sh.shard_arrivals(ch) for ch in w["chunks"]]
    if w["cut"] is not None:
        chunks = chunks[:w["cut"] // CHUNK]
    executed = 0
    torch.cuda.synchronize()
    dist.barrier(group=mesh.group)
    fused_tick.reset_launches()
    calls0 = sh.ex.calls
    w0 = time.perf_counter()
    for ch in chunks:
        n = ch.counts.shape[0]
        out = sh.run_fn(n, tick_indexed=True, donate=True,
                        time_compress=w["compress"],
                        with_metrics=w["metrics"])(
            state, ch, *(() if mb is None else (mb,)))
        out = out if isinstance(out, tuple) else (out,)
        state = out[0]
        if w["compress"]:
            executed += int(out[1].ticks_executed)
        if mb is not None:
            mb = out[-1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    dist.barrier(group=mesh.group)
    counts = {k: v for k, v in fused_tick.launch_counts().items() if v}
    ticks = sum(ch.counts.shape[0] for ch in chunks)
    res = dict(launches=counts, wall=wall, ticks=ticks, executed=executed,
               calls=sh.ex.calls - calls0)
    if w["cut"] is not None:
        import os

        os.makedirs(MESH_DIR, exist_ok=True)
        preempt.save_run_sharded(os.path.join(MESH_DIR, "cut.ckpt"), sh,
                                 state, cfg=cfg, tick_ms=cfg.tick_ms)
    whole = interop.to_numpy(sh.gather_state(state))
    if mb is not None:
        res["mbuf"] = interop.to_numpy(sh.collect_metrics(mb))
    if mesh.rank == 0:
        res["state"] = whole
    return res


def collective_cost(mesh, c_loc, reps):
    """Host µs of one staged collective on the card: ``allmin`` and
    ``gather`` of a [c_loc] int32 tensor, ``reps`` each."""
    from multi_cluster_simulator_tpu_torch.parallel import MeshExchange

    ex = MeshExchange(mesh)
    x = torch.arange(c_loc, dtype=torch.int32, device=mesh.device)
    out = {}
    for op in ("allmin", "gather"):
        fn = getattr(ex, op)
        fn(x)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
        torch.cuda.synchronize()
        out[op] = 1e6 * (time.perf_counter() - w0) / reps
    return out


def numpy_diff(want: dict, got: dict, float_tol=False) -> list:
    """The leaves of two numpy state dicts that differ: in dtype, shape or
    value (floats bitwise, or within MESH_FLOAT_RTOL/ATOL with
    ``float_tol``)."""
    bad = []
    for k in want:
        a, b = want[k], got[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(k)
        elif float_tol and a.dtype.kind == "f":
            if not np.allclose(b, a, rtol=MESH_FLOAT_RTOL,
                               atol=MESH_FLOAT_ATOL):
                bad.append(k)
        elif a.tobytes() != b.tobytes():
            bad.append(k)
    return bad


def phase_mesh(P, E, card, dev, ranks, head, plane, sparse):
    """Phase 11b: the mesh on one card (ranks are processes sharing it).
    Each cell's gathered state == the one-process run on the card (4a's,
    4n's buffer, 6a's, or a run made here), every rank launching its
    kernel once a tick (once an executed tick, compressed)."""
    import os

    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    cells = (("headline", 2), ("borrow64", 2), ("borrow64_4", 4),
             ("delay_trader", 4), ("sinkhorn256", 2), ("sparse", 2),
             ("ffd", 4), ("plane", 2), ("cut", 2))
    rows = {}
    for name, n in cells:
        w = mesh_world(P, E, name)
        c0 = time.perf_counter()
        parts = ranks.run(n, mesh_cell, name)
        cell_s = time.perf_counter() - c0
        got = parts[0]["state"]
        for r, part in enumerate(parts):
            want_n = part["executed"] if w["compress"] else part["ticks"]
            if sum(part["launches"].values()) != want_n or \
                    len(part["launches"]) != 1:
                raise AssertionError(f"11b {name} x {n}: rank {r} launches "
                                     f"{part['launches']}, want one kernel "
                                     f"{want_n} times")
        tol = False
        if name in ("headline", "plane"):
            want = interop.to_numpy(head["final"])
        elif name == "sparse":
            want = interop.to_numpy(sparse["final"])
            if parts[0]["executed"] != sparse["executed"]:
                raise AssertionError(
                    f"11b sparse: {parts[0]['executed']} ticks executed, 6a "
                    f"{sparse['executed']}")
        elif name == "cut":
            cfg = w["cfg"]
            engine = E.Engine(cfg, device=dev)
            rc = preempt.load_run(os.path.join(MESH_DIR, "cut.ckpt"),
                                  init_state(cfg, w["specs"], device=dev),
                                  cfg=cfg)
            fused_tick.reset_launches()
            fin = engine.run_chunks(rc.state, chunks_from(
                E, w["arr"], cfg, w["n_ticks"], start=MESH_CUT))
            check_launches(fused_tick.launch_counts(), "fused_prefix_fifo",
                           w["n_ticks"] - MESH_CUT, "11b cut resumed")
            got = interop.to_numpy(fin)
            want = interop.to_numpy(head["final"])
        else:
            cfg = w["cfg"]
            one = E.Engine(cfg, device=dev).run_chunks(
                init_state(cfg, w["specs"], device=dev), w["chunks"])
            want = interop.to_numpy(one)
            tol = name == "sinkhorn256"
        bad = numpy_diff(want, got, float_tol=tol)
        if bad:
            raise AssertionError(f"11b {name} x {n}: the gathered state "
                                 f"differs from one process at {bad[:6]}")
        extra = ""
        if tol:
            inexact = numpy_diff(want, got)
            extra = (f"; float leaves not bitwise (within rtol "
                     f"{MESH_FLOAT_RTOL}, atol {MESH_FLOAT_ATOL}): "
                     f"{inexact or 'none'}")
        if name == "plane":
            mb_bad = numpy_diff(interop.to_numpy(plane["mbuf"]),
                                parts[0]["mbuf"])
            if mb_bad:
                raise AssertionError(f"11b plane: collect_metrics differs "
                                     f"from 4n's buffer at {mb_bad}")
            extra = "; collect_metrics == 4n's buffer"
        ticks = parts[0]["ticks"]
        calls = parts[0]["calls"] / max(parts[0]["executed"] or ticks, 1)
        walls = [round(p["wall"], 4) for p in parts]
        rows[(name, n)] = dict(walls=walls, calls=calls)
        print(f"phase 11b: {name} over {n} ranks: {len(w['specs'])} "
              f"clusters, {ticks} ticks"
              f"{', ' + str(parts[0]['executed']) + ' executed' if w['compress'] else ''}"
              f": gathered state == the one-process run on the card"
              f"{extra}; each rank {parts[0]['launches']}; rank walls "
              f"{walls} s, the cell {cell_s:.1f} s with its start and "
              f"gather; collectives a tick {calls:.2f} (rank 0) [{card}]")
    for n, reps in ((2, COLLECTIVE_REPS), (4, COLLECTIVE_REPS_4)):
        cost = ranks.run(n, collective_cost, HEADLINE_C // n, reps)
        print(f"phase 11b: one staged collective on the card (host to host "
              f"through gloo), [{HEADLINE_C // n}] int32 a rank, {n} ranks: "
              f"allmin {cost[0]['allmin']:.1f} us, gather "
              f"{cost[0]['gather']:.1f} us (rank 0, mean of {reps}); the "
              f"ranks share one card, so no cell is a scaling figure "
              f"[{card}]")
    return rows


def phase_mesh_tools(P, E, card, dev, ranks):
    """Phase 11c: the mesh's tools on the card: weak_scaling's parity
    cells and its curve at 1 and 2 ranks x 4,096 clusters a rank (ranks
    sharing the card: not a scaling figure) and the tournament's seed axis
    over 2 ranks with its device A/B. Chaos's batch cell over 2 ranks runs
    beside 10c (``phase_chaos``)."""
    from multi_cluster_simulator_tpu_torch.tools import tournament as T
    from multi_cluster_simulator_tpu_torch.tools import weak_scaling as ws

    lap = lap_timer()
    cells = ws.verify_parity_cells(ranks, (1, 2), quick=True)
    curve = ws.run_curve(ranks, WEAK_PER_RANK, WEAK_JOBS, WEAK_HORIZON_MS,
                         (1, 2), repeats=1)
    print(f"phase 11c: weak_scaling parity cells {cells}; rows "
          f"{[(r['n_devices'], r['clusters'], r['jobs_per_sec'], r['wall_s'], r['ticks_executed']) for r in curve]} "
          f"(ranks, clusters, jobs/s, wall s, ticks executed); efficiency at "
          f"2 ranks {curve[-1]['efficiency_vs_linear']} with both ranks on "
          f"one card: not a scaling figure [{card}]")
    lap("11c weak_scaling")
    d = T.run_tournament(policies=T.DEFAULT_POLICIES[:4], n_seeds=2, C=16,
                         jobs_per=60, horizon_ms=120_000,
                         shard_seeds="always", shard_devices=2,
                         device_ab=True, device=str(dev))
    ab = d["replication_shard_ab"]
    print(f"phase 11c: the tournament's seed axis over 2 ranks: every cell "
          f"== its standalone run, the one-process grid bitwise the "
          f"sharded one; launches a rank {d['kernel_launches']}; grid walls "
          f"sharded {ab['sharded_wall_s']} s, one process "
          f"{ab['single_device_wall_s']} s [{card}]")
    lap("11c tournament")


def phase_mesh_all(P, E, card, dev, head, plane, sparse, plain_proc):
    """Phases 11a-11c."""
    from multi_cluster_simulator_tpu_torch.parallel.launch import RankGroup

    lap = lap_timer()
    phase_parity(P, E, card, dev, plain_proc)
    lap("11a")
    with RankGroup(MESH_RANKS) as ranks:
        lap("11 ranks up")
        phase_mesh(P, E, card, dev, ranks, head, plane, sparse)
        lap("11b")
        phase_mesh_tools(P, E, card, dev, ranks)


def phase_drivers(P, E, card, dev):
    """Phases 10a-10f."""
    lap = lap_timer()
    tour = phase_tournament(P, E, card, dev)
    lap("10a")
    train = phase_train(P, E, card, dev)
    lap("10b")
    phase_chaos(P, E, card, dev)
    lap("10c-10d, 11c chaos")
    phase_market_ab(P, E, card, dev)
    lap("10e")
    phase_metrics_smoke(P, E, card, dev)
    lap("10f")
    return dict(records=tour["records"] + [train["record"]])


# phase 12: the sinkhorn round's kernel (kernels/csrc/sinkhorn_round.cu)
SINK_PICKS = (5, 20, 35)  # config 4's sampled rounds (of 70)
SINK_AB = (1024, 100, 9)  # 10e's width: its first 100 ticks, round 9
SINK_SHARD = (30, 2)  # 11b's sinkhorn cell: its first 30 ticks, round 2
SINK_DIGEST_C = (64, 256)  # config 4's world against the pinned digests
SINK_REPS = 5  # timed rounds a record, each way


class RoundRecorder:
    """``market.sinkhorn.sinkhorn_round`` for a run: each call goes to the
    real one; the inputs of the rounds ``picks`` names (by their order in
    the run) are kept."""

    def __init__(self, picks):
        self.picks, self.n, self.kept = set(picks), 0, []

    def __enter__(self):
        from multi_cluster_simulator_tpu_torch.market import sinkhorn

        self.real = sinkhorn.sinkhorn_round
        sinkhorn.sinkhorn_round = self
        return self

    def __exit__(self, *exc):
        from multi_cluster_simulator_tpu_torch.market import sinkhorn

        sinkhorn.sinkhorn_round = self.real

    def __call__(self, feas, jitter, v, eps, iters, n_iters, ex):
        if self.n in self.picks:
            self.kept.append(dict(
                round=self.n, n_iters=n_iters,
                args=(feas.clone(), jitter, v.clone(), eps.clone(),
                      iters.clone())))
        self.n += 1
        return self.real(feas, jitter, v, eps, iters, n_iters, ex)


class ShardSum:
    """The mesh's launch sequence for a record on one process: the column
    product writes the shard's partial sums, this all-sum stand-in adds
    the partial to itself (in both versions), the finish launch takes
    it."""

    size = 2

    def allsum(self, x):
        return x + x


def library_round(feas, jitter, v, eps, iters, n_iters):
    """The round's products as one PyTorch call each (``torch.matmul``;
    ``torch.exp`` for K): the same function in another order, the
    record's library yardstick."""
    score = v[None, :] + jitter * (0.5 * eps)
    K = torch.where(feas, torch.exp(score / eps), 0.0)
    u = torch.ones(K.shape[0], device=K.device)
    vc = torch.ones(K.shape[1], device=K.device)
    for i in range(n_iters):
        act = iters > i
        u2 = 1.0 / (K @ vc).clamp(min=1e-30)
        vc2 = 1.0 / (K.T @ u2).clamp(min=1e-30)
        u, vc = torch.where(act, u2, u), torch.where(act, vc2, vc)
    return u[:, None] * K * vc[None, :]


def events_ms(fn, reps, warm=True):
    """Mean card ms of ``fn()`` over ``reps`` calls, by CUDA events (after
    one untimed call with ``warm``)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def round_record(kept, ex, what, card):
    """One kept round: the kernel against its plain version on the card
    (K, ``u`` and ``vc`` after every iteration, the plan: bitwise), the
    kernel's, the plain version's and the library call's times, and the
    round's least time: its inputs read once and its outputs written once
    at 3.35 TB/s, or its operations at 67 T/s (a fused multiply-add two,
    over K's nonzeros, both products, the active iterations; XLA's exp
    about 20 a feasible pair), whichever is larger."""
    from multi_cluster_simulator_tpu_torch.market import sinkhorn

    args, n_iters = kept["args"], kept["n_iters"]
    want = sinkhorn.sinkhorn_plain(*args, n_iters, ex, trace=True)
    got = sinkhorn.sinkhorn_kernel(*args, n_iters, ex, trace=True)
    torch.cuda.synchronize()
    worst = max(max_abs_diff(a, b) for a, b in zip(want[:4], got[:4]))
    for i, ((ua, va), (ub, vb)) in enumerate(zip(want[4], got[4])):
        worst = max(worst, max_abs_diff(ua, ub), max_abs_diff(va, vb))
        if not (torch.equal(ua.view(torch.int32), ub.view(torch.int32))
                and torch.equal(va.view(torch.int32), vb.view(torch.int32))):
            raise AssertionError(f"12 {what}: u or vc differs after "
                                 f"iteration {i}")
    for name, a, b in zip(("K", "u", "vc", "plan"), want[:4], got[:4]):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"12 {what}: {name} differs from plain")
    feas = args[0]
    C_loc, C_tot = feas.shape
    active = min(int(args[4]), n_iters)
    nnz = int(torch.count_nonzero(want[0]))
    read = feas.numel() * (1 + 4) + C_tot * 4 + 8
    written = feas.numel() * 4 + (C_loc + C_tot) * 4
    ops = nnz * 2 * 2 * active + 20 * int(feas.sum()) + 2 * feas.numel()
    k_ms = events_ms(lambda: sinkhorn.sinkhorn_kernel(*args, n_iters, ex),
                     SINK_REPS)
    p_ms = events_ms(lambda: sinkhorn.sinkhorn_plain(*args, n_iters, ex), 1,
                     warm=False)
    l_ms = events_ms(lambda: library_round(*args, n_iters), SINK_REPS)
    k_bytes = 2 * active * nnz * 4
    print(f"phase 12: {what}: round {kept['round']}, K {C_loc} x {C_tot} "
          f"({nnz} nonzero, {int(feas.sum())} feasible pairs), {active} "
          f"active iterations: kernel == plain bitwise (K, u and vc after "
          f"each of {len(got[4])} iterations, plan; max_abs_err {worst}); "
          f"kernel {k_ms:.3f} ms a round, plain {p_ms:.3f} ms, torch.matmul "
          f"pair {l_ms:.3f} ms; bound {1e3 * (read + written) / HBM_BYTES_PER_S:.4f}"
          f" ms by bytes ({read + written} B), "
          f"{1e3 * ops / SCALAR_OPS_PER_S:.4f} ms by operations ({ops}); "
          f"K's nonzeros read twice an iteration: "
          f"{1e3 * k_bytes / HBM_BYTES_PER_S:.4f} ms, dense: "
          f"{1e3 * 2 * active * feas.numel() * 4 / HBM_BYTES_PER_S:.4f} ms "
          f"[{card}]")
    return dict(worst=worst, ms=k_ms, plain=[p_ms], library_ms=l_ms,
                bound=bound(read, written, ops))


def phase_sinkhorn(P, E, card, dev, market, run_a):
    """Phase 12: the sinkhorn round's kernel. (a) config 4's run counted
    and three of its rounds kept, each held bitwise against the plain
    version and timed; (b) one round of config 4's world at 1,024 (10e's
    width); (c) the 256-cluster sinkhorn cell of 11b: a round's second
    half of the sellers, the 128 x 256 shard, through the mesh's launches;
    (d) config 4's world at 64 and 256 clusters on the card, each final
    state's digest against the reference engine's pinned one
    (``tools/market_ab.py CONFIG4_DIGESTS``)."""
    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.market import sinkhorn
    from multi_cluster_simulator_tpu_torch.parallel.exchange import (
        LocalExchange,
    )
    from multi_cluster_simulator_tpu_torch.tools import market_ab as MA

    cfg = market_cfg(P, **MARKET_RUNS["a"][1])
    engine = E.Engine(cfg, device=dev)
    kernel = fused_tick.host_params(engine, engine._default_params)[
        "kernel"].name
    s0 = init_state(cfg, market["specs"], device=dev)
    with RoundRecorder(SINK_PICKS) as rec:
        out, wall, counts = counted_run(engine, s0, market["chunks"], kernel)
    if int(out.placed_total.sum()) != run_a["placed"] or \
            counts["sinkhorn_round"] != run_a["sinkhorn_rounds"]:
        raise AssertionError(f"12a: placed {int(out.placed_total.sum())}, "
                             f"rounds {counts['sinkhorn_round']} against 4d")
    print(f"phase 12a: config 4's run again with {len(rec.kept)} rounds "
          f"kept: {counts['sinkhorn_round']} rounds through the kernel, "
          f"placed {run_a['placed']} (4d's) [{card}]")
    recs = [round_record(k, LocalExchange(), "config 4's run", card)
            for k in rec.kept]

    C, n, pick = SINK_AB
    cfg_b, specs_b, arr_b, _ = MA.sinkhorn_market_setup(
        C, MA.JOBS_PER, MA.HORIZON_MS, matching="sinkhorn")
    with RoundRecorder((pick,)) as rec:
        E.Engine(cfg_b, device=dev).run(init_state(cfg_b, specs_b,
                                                   device=dev), arr_b, n)
    recs.append(round_record(rec.kept[0], LocalExchange(),
                             f"10e's world at {C}", card))

    w = mesh_world(P, E, "sinkhorn256")
    n, pick = SINK_SHARD
    with RoundRecorder((pick,)) as rec:
        E.Engine(w["cfg"], device=dev).run_chunks(
            init_state(w["cfg"], w["specs"], device=dev),
            first_ticks(w["chunks"], n))
    kept = rec.kept[0]
    half = kept["args"][0].shape[0] // 2
    feas, jitter, v, eps, iters = kept["args"]
    kept["args"] = (feas[half:].contiguous(), jitter[half:].contiguous(), v,
                    eps, iters)
    recs.append(round_record(kept, ShardSum(), f"11b's {half} x "
                             f"{feas.shape[1]} shard", card))

    for C in SINK_DIGEST_C:
        sinkhorn.reset_launches()
        r = MA.run_one("sinkhorn", C, device=dev, runs=1, warmups=0)
        digest = interop.leaves_digest(interop.to_numpy(r["final"]))
        if digest != MA.CONFIG4_DIGESTS[C] or not sinkhorn.LAUNCHES[
                "sinkhorn_round"]:
            raise AssertionError(f"12d: config 4's world at {C}: digest "
                                 f"{digest}, pinned "
                                 f"{MA.CONFIG4_DIGESTS[C]}, launches "
                                 f"{dict(sinkhorn.LAUNCHES)}")
        print(f"phase 12d: config 4's world at {C} clusters on the card: "
              f"placed {r['placed']} of {r['of']}, final state digest "
              f"{digest} == the reference engine's (pinned), "
              f"{sinkhorn.LAUNCHES['sinkhorn_round']} rounds through the "
              f"kernel, wall {r['wall_s']} s [{card}]")
    worst = max(r["worst"] for r in recs)
    main = recs[0]
    return dict(name="sinkhorn_round", source=sinkhorn.SOURCE,
                replaces=sinkhorn.REPLACES,
                launches=run_a["sinkhorn_rounds"], worst=worst,
                ms=float(np.mean([r["ms"] for r in recs[:len(SINK_PICKS)]])),
                plain=[p for r in recs[:len(SINK_PICKS)] for p in r["plain"]],
                library_ms=float(np.mean(
                    [r["library_ms"] for r in recs[:len(SINK_PICKS)]])),
                bound=main["bound"])


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


def ptxas_lines(report: str):
    """(form, line) for each resource line of nvcc's ``-Xptxas -v``
    report: the registers, static shared memory, stack frame and spills
    of each kernel form, the form read off the mangled template flags
    (``<emit, expire, faults, tap>``)."""
    import re

    form = ""
    names = ("emit", "expire", "faults", "tap")
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        callee = "Function properties" in line and re.search(
            r"(tap|node_exit)_epilogue", line)
        if entry:
            flags = re.findall(r"Lb([01])E", entry.group(1))[:4]
            form = "<" + ",".join(n for n, f in zip(names, flags)
                                  if f == "1") + ">"
        elif callee:
            scope = "warp::" if "4warp" in line else ""
            form = f" ({scope}{callee.group(0)}, a call)"
        elif "registers" in line or "spill" in line:
            yield form, line.split(":", 1)[-1].strip()


def launch_geometry(build, kernel: str, C: int, N: int, R: int, Q: int,
                    *extra: int, lanes: int = 1) -> tuple[int, int]:
    """The warps a block and the dynamic shared-memory bytes a warp with
    which ``kernel``'s launcher launches ``lanes`` lanes of C clusters at
    (N, R, Q) (and ``extra``, whether the scored kernel stages the BFD
    order: a lane picks tesserae), from its ``<kernel>_geometry``
    export."""
    warps, warp_bytes = ctypes.c_int(), ctypes.c_int64()
    getattr(build.load(kernel), kernel + "_geometry")(
        C, lanes, N, R, Q, *extra, ctypes.byref(warps),
        ctypes.byref(warp_bytes))
    return warps.value, warp_bytes.value


def lap_timer():
    """A function that prints, under a label, the seconds since its last
    call (or since it was made): where the script's time goes."""
    last = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"time: {what} {now - last[0]:.1f} s")
        last[0] = now
    return lap


def main(device: str = "cuda") -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import multi_cluster_simulator_tpu_torch as P  # noqa: F401

    sample, plain_proc = start_borg_sample(), start_parity_plain()
    try:
        return run_phases(device, sample, plain_proc)
    finally:
        for proc in (sample, plain_proc):
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def run_phases(device: str, sample, plain_proc) -> int:
    """Every phase in order, then the records and the result line."""
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
        for form, line in ptxas_lines(report):
            print(f"phase 2: {kernel}{form}: {line}")
    # each kernel's launch shape at the (C, N, R, Q) of the cells it runs
    # (the scored kernel's also by its pick: 0 gavel and rl, 1 tesserae)
    warp_cells = {"the headline": (4096, 5, 2, 8), "borg4k": (4096, 5, 2, 32),
                  "ffd64": (64, 10, 2, 768), "config 2": (2, 10, 2, 1024),
                  "config 2 tiled": (4096, 10, 2, 1024)}
    level_cells = {"config 4": (4096, 9, 3, 256), "config 1": (1, 5, 2, 768)}
    for kernel, cells, pick in (
            ("fused_prefix_fifo", warp_cells, ()),
            ("fused_prefix_ffd", warp_cells, ()),
            ("fused_prefix_delay", level_cells, ()),
            ("fused_prefix_scored gavel/rl", level_cells, (0,)),
            ("fused_prefix_scored tesserae", level_cells, (1,))):
        sizes = []
        for what, shape in cells.items():
            warps, b = launch_geometry(build, kernel.split()[0], *shape,
                                       *pick)
            sizes.append(f"{what} {b} B a warp, {warps} warps a block")
        print(f"phase 2: {kernel}: dynamic shared memory and blocks: "
              f"{'; '.join(sizes)}")
    # the lane forms' launch shapes: (lanes, C, N, R, Q[, order])
    for kernel, shape in (
            ("fused_prefix_fifo 8a", (TENANTS_T, TENANTS_C, 5, 2, 64)),
            ("fused_prefix_scored 8d", (ENV_B, ENV_C, 5, 2, 16, 0)),
            ("fused_prefix_scored 8b", (18, MIXED_C, 5, 2, 96, 1)),
            ("fused_prefix_ffd 8b", (18, MIXED_C, 5, 2, 96)),
            ("fused_prefix_delay 8b", (18, MIXED_C, 5, 2, 96))):
        L, C, *rest = shape
        warps, b = launch_geometry(build, kernel.split()[0], C, *rest,
                                   lanes=L)
        print(f"phase 2: {kernel}: {L} lanes x {C} clusters: {warps} warps "
              f"a block, {-(-C // warps)} blocks a lane, {b} B a warp")

    dev = torch.device(device)
    w0 = time.perf_counter()
    lap = lap_timer()
    check = phase_kernel_vs_plain(P, E, card, dev)
    lap("3a-b")
    head = phase_headline(P, E, card, dev)
    lap("4a")
    borg = phase_ffd_kernel_vs_plain(P, E, card, dev)
    lap("3c")
    b4k = phase_borg4k(P, E, card, dev, borg)
    lap("4b")
    f64 = phase_ffd64(P, E, card, dev)
    lap("4c")
    print(f"phases 3a-c, 4a-c: {time.perf_counter() - w0:.1f} s")

    w1 = time.perf_counter()
    chunks, n_ticks, unplaceable, m_arr = market_stream(
        E, MARKET_C, MARKET_JOBS, arrivals=True)
    market = dict(chunks=chunks, n_ticks=n_ticks, unplaceable=unplaceable,
                  specs=market_specs(P, MARKET_C), arr=m_arr)
    print(f"market stream: {MARKET_C * MARKET_JOBS} jobs in {len(chunks)} "
          f"chunks, {sum(ch.nbytes() for ch in chunks)} B of rows (K per "
          f"chunk {[ch.rows.shape[2] for ch in chunks]}), unplaceable "
          f"without the market {unplaceable}; built in "
          f"{time.perf_counter() - w1:.1f} s")
    lap("market stream")
    delay = phase_delay_kernel_vs_plain(P, E, card, dev, market)
    lap("3d")
    scored = phase_scored_kernel_vs_plain(P, E, card, dev, market)
    lap("3e")
    phase_dispatch(P, E, card, dev)
    lap("3f")
    expire = phase_expire_kernel_vs_plain(P, E, card, dev, market,
                                          delay["a"]["sampled"]["state"])
    lap("3i")
    phase_matchers(P, E, card, dev)
    lap("3j")
    sampled = {"a": delay["a"], "b": scored["b"], "c": scored["c"],
               "d": delay["d"], "e": expire["e"]}
    runs = {}
    for name in MARKET_RUNS:
        runs[name] = phase_market(P, E, card, dev, market, name,
                                  sampled[name]["sampled"])
        lap(f"4{'defgh'['abcde'.index(name)]}")
    print(f"phases 3d-f, 3i-j, 4d-h: {time.perf_counter() - w1:.1f} s")

    w2 = time.perf_counter()
    borrow = phase_borrow_kernel_vs_plain(P, E, card, dev)
    lap("3g-h")
    bb = borrow["b"]
    chunks_a, jobs_a = borrow_stream(P, E, 2)
    cfg_a = borrow_cfg(P, {})
    chk_a = Checker(E.Engine(cfg_a, device=dev))
    sp_a = borrow_pass(E, chk_a, P.init_state(cfg_a, borrow_specs(P, 2),
                                              device=dev),
                       chunks_a[:1], set())
    run_a = phase_borrow_run(P, E, card, dev, "a", 2, chunks_a, jobs_a,
                             sp_a)
    lap("4i")
    run_b = phase_borrow_run(P, E, card, dev, "b", BORROW_C,
                             bb["chunks"][:BORROW_B_CHUNKS], bb["jobs"],
                             bb["sampled"])
    lap("4j")
    print(f"phases 3g-h, 4i-j: {time.perf_counter() - w2:.1f} s")

    w3 = time.perf_counter()
    faults = phase_faults_kernel_vs_plain(
        P, E, card, dev, market, delay["a"]["sampled"]["state"],
        (bb["sampled"]["state"], bb["sampled"]["t"]))
    lap("3k")
    churn = phase_faults_run(P, E, card, dev, FAULTS_C, "phase 4k")
    lap("4k")
    churn_wide = phase_faults_run(P, E, card, dev, FAULTS_WIDE_C, "phase 4m")
    lap("4m")
    print(f"phases 3k, 4k, 4m: {time.perf_counter() - w3:.1f} s")

    w4 = time.perf_counter()
    plane = phase_plane_headline(P, E, card, dev, check, head)
    lap("4n")
    plane_churn = phase_plane_churn(P, E, card, dev, churn_wide)
    lap("4o")
    config1 = phase_config1(P, E, card, dev)
    lap("4p")
    plane_l0 = phase_plane_level0(P, E, card, dev, borg, market, sampled)
    lap("4q")
    print(f"phases 4n-4q: {time.perf_counter() - w4:.1f} s")

    w5 = time.perf_counter()
    compact = phase_compact_headline(P, E, card, dev, head)
    lap("5a")
    phase_compact_undersized(P, E, card, dev)
    lap("5b")
    c_l0 = phase_compact_level0(P, E, card, dev, market)
    lap("5c")
    c_emit = phase_compact_emit_expire(P, E, card, dev, market)
    lap("5d")
    c_faults = phase_compact_faults(P, E, card, dev, churn, market)
    lap("5e")
    phase_compact_config4(P, E, card, dev, market, runs["a"])
    lap("5f")
    print(f"phases 5a-5f: {time.perf_counter() - w5:.1f} s")

    w6 = time.perf_counter()
    sparse = phase_sparse_bursts(P, E, card, dev)
    lap("6a-6b")
    churn_b = phase_churn_bursts(P, E, card, dev)
    lap("6c")
    phase_leap_classes(P, E, card, dev)
    lap("6d")
    replay = phase_borg_replay(P, E, card, dev, sample)
    lap("6e")
    print(f"phases 6a-6e: {time.perf_counter() - w6:.1f} s")

    w7 = time.perf_counter()
    phase_ckpt_headline(P, E, card, dev, head)
    lap("7a")
    phase_ckpt_compact(P, E, card, dev, head)
    lap("7b")
    phase_ckpt_sparse(P, E, card, dev)
    lap("7c")
    phase_ckpt_preempt(P, E, card, dev, head)
    lap("7d")
    phase_prefix_ablation(P, E, card, dev, head)
    lap("7e")
    phase_ckpt_bytes(P, E, card, dev, {
        "config 4 (market run (a))": (market_cfg(P, **MARKET_RUNS["a"][1]),
                                      runs["a"]["final"]),
        "config 5 (6e)": (replay["cfg"], replay["final"])})
    lap("7 bytes")
    print(f"phases 7a-7e: {time.perf_counter() - w7:.1f} s")

    w8 = time.perf_counter()
    tenants = phase_tenants(P, E, card, dev)
    lap("8a")
    mixed = phase_mixed_tenants(P, E, card, dev)
    lap("8b")
    phase_tenants_composed(P, E, card, dev)
    lap("8c")
    env = phase_env(P, E, card, dev)
    lap("8d")
    env_lanes = phase_env_lanes(P, E, card, dev)
    lap("8e")
    print(f"phases 8a-8e: {time.perf_counter() - w8:.1f} s")

    w9 = time.perf_counter()
    services = phase_services(P, E, card, dev)
    print(f"phases 9a-9e: {time.perf_counter() - w9:.1f} s")

    w10 = time.perf_counter()
    drivers = phase_drivers(P, E, card, dev)
    print(f"phases 10a-10f: {time.perf_counter() - w10:.1f} s")

    w11 = time.perf_counter()
    phase_mesh_all(P, E, card, dev, head, plane, sparse, plain_proc)
    print(f"phases 11a-11c: {time.perf_counter() - w11:.1f} s")

    w12 = time.perf_counter()
    sink = phase_sinkhorn(P, E, card, dev, market, runs["a"])
    print(f"time: 12 {time.perf_counter() - w12:.1f} s")

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
    records.append(f64["record"])

    # the market runs: the record of each kernel is its first run's, (a)
    # for DELAY and (b) for the scored sweep, and each other run's a record
    # of its own, (d) the parity sweep and (c) tesserae; every run is
    # printed (run (e), the expire form's, below)
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
            rec = dict(kernel=fused_tick.KERNELS[kernel],
                       launches=runs[run]["launches"], worst=group["worst"],
                       ms=kms, plain=group[run]["plain_ms"],
                       bound=(b_ms, b_by))
            if run != first:
                rec["name"] = f"{kernel} ({run})"
            records.append(rec)

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
    for where, rd, wr in (("run (a)", sp_a["read"], sp_a["written"]),
                          ("the headline", check["emit_read"],
                           check["emit_written"])):
        e_ms, e_by = bound(rd, wr)
        print(f"kernel fused_prefix_fifo_emit at {where}: bound "
              f"{e_ms * 1e3:.4f} us by {e_by} ({rd + wr:.1f} B per launch, "
              f"mean of {rd:.1f} read and {wr:.1f} written) [{card}]")
    breakdown("borrowing (a)", run_a, sp_a["ms"]["kernel"], card)
    breakdown("borrowing (b)", run_b, sp["ms"]["kernel"], card)
    records.append(dict(kernel=fused_tick.KERNELS["fused_prefix_fifo_emit"],
                        launches=run_b["launches"], worst=borrow["worst"],
                        ms=kms, plain=bb["plain_ms"], bound=(b_ms, b_by)))

    # the expire forms: run (e)'s sampled pass for DELAY's (its main
    # path), the heavy ticks for the others; launches from the counted
    # runs of their paths
    sp = expire["e"]["sampled"]
    kms = float(np.mean(sp["kernel_ms"]))
    b_ms, b_by = bound(sp["read"], sp["written"], sp["ops"])
    print(f"kernel fused_prefix_delay_expire, run (e): {kms * 1e3:.2f} "
          f"us/launch mean over {len(sp['kernel_ms'])} launches (CUDA "
          f"events), plain {np.mean(expire['e']['plain_ms']):.3f} ms, bound "
          f"{b_ms * 1e3:.4f} us by {b_by} ({sp['read'] + sp['written']:.1f} B"
          f" per launch, mean of {sp['read']:.1f} read and "
          f"{sp['written']:.1f} written, expire words included); kernel / "
          f"bound {kms / b_ms:.1f} [{card}]")
    breakdown("market (e)", runs["e"], sp["kernel_ms"], card)
    records.append(dict(kernel=fused_tick.KERNELS["fused_prefix_delay_expire"],
                        launches=runs["e"]["launches"],
                        worst=expire["worst"], ms=kms,
                        plain=expire["e"]["plain_ms"], bound=(b_ms, b_by)))
    for name, runs_h in expire["heavy"].items():
        for h in runs_h:
            b_ms, b_by = bound(h["read"], h["written"])
            print(f"kernel {name}, heavy ticks: {np.mean(h['ms']) * 1e3:.2f} "
                  f"us/launch over {len(h['ms'])} launches, plain "
                  f"{np.mean(h['plain_ms']):.3f} ms, bound "
                  f"{b_ms * 1e3:.4f} us by {b_by} "
                  f"({h['read'] + h['written']:.1f} B per launch) [{card}]")
        if name == "fused_prefix_delay_expire":
            continue
        h = runs_h[0]
        records.append(dict(kernel=fused_tick.KERNELS[name],
                            launches=expire["launches"][name],
                            worst=expire["worst"], ms=float(np.mean(h["ms"])),
                            plain=h["plain_ms"],
                            bound=bound(h["read"], h["written"])))

    # the faults forms: 4m's pass for the main path's FIFO form, 3k's heavy
    # ticks for the others; launches from the counted runs of their paths
    sp = churn_wide["sampled"]
    b_ms, b_by = bound(sp["read"], sp["written"])
    records.append(dict(kernel=fused_tick.KERNELS["fused_prefix_fifo_faults"],
                        launches=churn_wide["launches"],
                        worst=max(churn_wide["worst"], churn["worst"],
                                  faults["worst"]),
                        ms=float(np.mean(sp["kernel_ms"])),
                        plain=churn_wide["plain_ms"], bound=(b_ms, b_by)))
    for name, runs_h in faults["heavy"].items():
        for h in runs_h:
            b_ms, b_by = bound(h["read"], h["written"])
            print(f"kernel {name}, heavy ticks ({h['policy']}, {h['mode']}): "
                  f"{np.mean(h['ms']) * 1e3:.2f} us/launch over "
                  f"{len(h['ms'])} launches, plain "
                  f"{np.mean(h['plain_ms']):.3f} ms, bound "
                  f"{b_ms * 1e3:.4f} us by {b_by} "
                  f"({h['read'] + h['written']:.1f} B per launch) [{card}]")
        if name == "fused_prefix_fifo_faults":
            continue
        h = runs_h[0]
        records.append(dict(kernel=fused_tick.KERNELS[name],
                            launches=faults["launches"][name],
                            worst=faults["worst"], ms=float(np.mean(h["ms"])),
                            plain=h["plain_ms"],
                            bound=bound(h["read"], h["written"])))

    # the metrics plane's tap forms and the windowed ingest
    breakdown("headline, the plane on", plane, plane["kernel_ms"], card)
    breakdown("headline, compact", compact, compact["kernel_ms"], card)
    for group in (plane, plane_churn, config1, plane_l0, compact, c_l0,
                  c_emit, c_faults):
        for r in group["records"]:
            b_ms, b_by = r["bound"]
            print(f"kernel {r.get('name', r['kernel'].name)}: "
                  f"{r['ms'] * 1e3:.2f} us/launch, plain "
                  f"{np.mean(r['plain']):.3f} ms, bound {b_ms * 1e3:.4f} us "
                  f"by {b_by}, launches {r['launches']}; kernel / bound "
                  f"{r['ms'] / b_ms:.1f} [{card}]")
            records.append(r)

    # event-compressed time and the Borg replay: the kernels' times on the
    # executed ticks of 6a and 6c and on 6e's replay
    for r in (sparse["record"], churn_b["record"], replay["record"]):
        b_ms, b_by = r["bound"]
        print(f"kernel {r['name']}: {r['ms'] * 1e3:.2f} us/launch, plain "
              f"{np.mean(r['plain']):.3f} ms, bound {b_ms * 1e3:.4f} us by "
              f"{b_by}, launches {r['launches']}; kernel / bound "
              f"{r['ms'] / b_ms:.1f} [{card}]")
        records.append(r)

    # the lane forms: 8a's tenant batch, 8b's mixed batch, 8e's env batch
    for r in (tenants["record"], *mixed["records"], env_lanes["record"]):
        b_ms, b_by = r["bound"]
        print(f"kernel {r['name']}: {r['ms'] * 1e3:.2f} us/launch, plain "
              f"per-lane loop {np.mean(r['plain']):.3f} ms, bound "
              f"{b_ms * 1e3:.4f} us by {b_by}, launches {r['launches']}; "
              f"kernel / bound {r['ms'] / b_ms:.1f} [{card}]")
        records.append(r)
    # the services tier: the serving front door's FIFO emit+tap form
    # (9a), its lane form under tenants (9c), the live hosts' windowed
    # C=1 forms (9e)
    for r in (services["a"]["record"], services["c"]["record"],
              *services["e"]["records"]):
        b_ms, b_by = r["bound"]
        print(f"kernel {r['name']}: {r['ms'] * 1e3:.2f} us/launch, plain "
              f"{np.mean(r['plain']):.3f} ms, bound {b_ms * 1e3:.4f} us by "
              f"{b_by}, launches {r['launches']}; kernel / bound "
              f"{r['ms'] / b_ms:.1f} [{card}]")
        records.append(r)
    # the reference's drivers: the tournament's lane forms (10a), the
    # trainer's scored lane form (10b)
    for r in drivers["records"]:
        b_ms, b_by = r["bound"]
        print(f"kernel {r['name']}: {r['ms'] * 1e3:.2f} us/launch, plain "
              f"per-lane loop {np.mean(r['plain']):.3f} ms, bound "
              f"{b_ms * 1e3:.4f} us by {b_by}, launches {r['launches']}; "
              f"kernel / bound {r['ms'] / b_ms:.1f} [{card}]")
        records.append(r)
    print(f"lane forms beside one lane over the same clusters: FIFO "
          f"{tenants['record']['lane_ms'] * 1e3:.2f} us ({TENANTS_T} x "
          f"{TENANTS_C}) vs {tenants['record']['one_ms'] * 1e3:.2f} us (1 x "
          f"{TENANTS_T * TENANTS_C}); scored rl {env['lane_ms'] * 1e3:.2f} us "
          f"({ENV_B} x {ENV_C}) vs {env['one_ms'] * 1e3:.2f} us (1 x "
          f"{ENV_B * ENV_C}) [{card}]")

    # the sinkhorn round's kernel (phase 12)
    b_ms, b_by = sink["bound"]
    print(f"kernel sinkhorn_round: {sink['ms']:.3f} ms a round (CUDA "
          f"events, mean of {len(SINK_PICKS)} of config 4's rounds), plain "
          f"{np.mean(sink['plain']):.3f} ms, torch.matmul pair "
          f"{sink['library_ms']:.3f} ms, bound {b_ms:.4f} ms by {b_by}, "
          f"launches {sink['launches']} rounds in config 4's run; kernel / "
          f"bound {sink['ms'] / b_ms:.1f} [{card}]")
    records.append(sink)

    print(json.dumps({"kernels": [{
        "name": r.get("name") or r["kernel"].name, "route": "cuda",
        "source": r["source"] if "source" in r else r["kernel"].source,
        "replaces": r.get("replaces", fused_tick.REPLACES),
        "launches": r["launches"], "max_abs_err": r["worst"],
        "ms": r["ms"], "plain_ms": float(np.mean(r["plain"])),
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": r.get("library_ms")} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--preempt-child"]:
        sys.exit(preempt_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-child"]:
        sys.exit(serve_child(sys.argv[2:]))
    sys.exit(main())
