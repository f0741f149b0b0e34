"""The warp-per-cluster prefix kernels (``kernels/csrc/fused_prefix_fifo.cu``,
``fused_prefix_ffd.cu``, ``fused_prefix_delay.cu`` and
``fused_prefix_scored.cu``) built as host C++ with g++ and held, tick by
tick, against their plain PyTorch version on the CPU.

The sources compile for the host against a shim ``cuda_runtime.h`` (the
CUDA qualifiers defined away) with ``-ffp-contract=off``; the lane helpers
of ``csrc/prefix_warp.cuh`` have a host meaning (the 32 lanes one after
another) and ``launch_warps`` runs each warp as one call. ``build.load``
returns these libraries and ``torch.cuda.current_stream`` a null stream,
so ``fused_tick._LAUNCH`` drives them on CPU tensors exactly as it drives
the card. Every run goes through the engine's entry points with
``fused_tick.fused_prefix`` replaced by ``Checked``: each tick the host
kernel updates the state in place and ``fused_prefix_reference`` runs on a
copy; every state leaf (``wait_total`` bitwise), every emit output and,
with the metrics plane, every buffer and cursor leaf must be equal.
Cases cover the FIFO headline shape, the emit form with borrowing and
returns past the message slots, the expire, faults and tap forms, the
windowed ingest, FFD with a cap below the queue, the whole queue
(parity) and ``ffd-memfirst``, DELAY in parity (the skip firing) and in
its wave form under a cap below Level1, promotions into a full Level1,
the scored kinds (gavel and rl tables, tesserae, a NaN score, scores all
``-inf``, more than 32 nodes), both state layouts, undersized plans whose
clamped demands replay the waves, the node exit narrow, and cluster
counts that leave a block's last warps idle. Each case also checks that
the branch it is for fired.

The ``lanes-*`` cases run the lane form: a lane-stacked batch (L > 1
constellations of C clusters, the members of a mixed ``PolicySet`` a lane
each) through ``run_chunks``, with ``fused_tick.fused_prefix_lanes``
replaced by ``CheckedLanes``: each tick the host kernels launch once a
source over every lane (``fused_tick.launch_lanes``, the other sources'
lanes masked out, every parameter read per lane) and the plain per-lane
loop (``fused_prefix_lanes_reference``) runs on a copy, every leaf held
bitwise. They cover per-lane parameters that differ, C not a multiple of
the warps a block, the tap and the node exit narrow per lane, and the
member masks. Needs g++ (skipped without one, decided in a fixture)."""

import collections
import ctypes
import dataclasses
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import multi_cluster_simulator_tpu_torch as P
from multi_cluster_simulator_tpu_torch import tenancy
from multi_cluster_simulator_tpu_torch.core import compact as CC
from multi_cluster_simulator_tpu_torch.core import engine as E
from multi_cluster_simulator_tpu_torch.core.state import (
    clone_state, empty_io, init_state,
)
from multi_cluster_simulator_tpu_torch.kernels import build, fused_tick
from multi_cluster_simulator_tpu_torch.obs import device as D
from multi_cluster_simulator_tpu_torch.policies import kernels as K
from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys
from multi_cluster_simulator_tpu_torch.workload.traces import uniform_stream

torch.set_num_threads(1)

NAMES = ("fused_prefix_fifo", "fused_prefix_ffd", "fused_prefix_delay",
         "fused_prefix_scored")

# The CUDA runtime as the host build sees it: the qualifiers defined away,
# the launch geometry as globals that launch_warps' host loop sets.
SHIM = """#pragma once
#include <stddef.h>
#include <stdint.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __grid_constant__
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct int2 { int x, y; };
static dim3 gridDim, blockDim, blockIdx, threadIdx;
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The sources built with g++ into a temporary directory and routed
    to: ``build.load`` returns them, the stream is null."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the kernels' host build needs a C++17 "
                    "compiler")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "cuda_runtime.h").write_text(SHIM)
    procs = {}
    for name in NAMES:
        cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
               "-ffp-contract=off", "-w", "-I", str(d), "-x", "c++",
               str(build.CSRC / build.SOURCES[name]), "-o",
               str(d / f"lib{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed for {name}:\n{out}"
        libs[name] = ctypes.CDLL(str(d / f"lib{name}.so"))
    stream = types.SimpleNamespace(cuda_stream=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "load", lambda name: libs[name])
        mp.setattr(torch.cuda, "current_stream", lambda device=None: stream)
        fused_tick._entry.cache_clear()
        yield libs
    fused_tick._entry.cache_clear()


def assert_same(want, got, what: str) -> None:
    """Every leaf equal, floats bitwise."""
    for (k, a), (_, b) in zip(leaves_with_keys(want), leaves_with_keys(got)):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {k}"
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:4].tolist()
            raise AssertionError(f"{what}: {k} differs at {bad}")


class Checked:
    """``fused_tick.fused_prefix`` for runs on CPU tensors: the host-built
    kernel on the state in place, the plain version on a copy, every leaf
    held equal; counts the launches of each form (and the windowed ones in
    ``seen``). A run may set ``watch(seen, before, after, rows, counts)``,
    called after every tick, to count in ``seen`` the branches it fired."""

    def __init__(self):
        self.launches = collections.Counter()
        self.seen = collections.Counter()
        self.watch = None
        self.real = fused_tick.fused_prefix

    def __call__(self, engine, state, rows, counts, t, params, host,
                 emit_returns=False, out=None, obs=None, windowed=False):
        before = clone_state(state) if self.watch is not None else None
        ref = clone_state(state)
        ref_obs = None if obs is None else tuple(map(clone_state, obs))
        _, *ref_io, _ = self.real(engine, ref, rows, counts, t, params, host,
                                  emit_returns, None, ref_obs, windowed)
        tap = None
        if obs is not None:
            tap = fused_tick._tap_args(engine, state, obs[0], obs[1], host)
        io = None
        if emit_returns:
            io = out if out is not None else empty_io(
                (counts.shape[0],), engine.n_msgs(), counts.device)
        k = host[("emit_" if emit_returns else "")
                 + ("tap_kernel" if tap is not None else "kernel")]
        fused_tick._LAUNCH[k.lib](engine.cfg, state, rows, counts, t, host,
                                  io, windowed, tap)
        self.launches[k.name] += 1
        self.seen["windowed"] += int(windowed)
        self.seen["emit"] += int(emit_returns)
        what = f"{k.name} at t={t}"
        assert_same(ref, state, what)
        if self.watch is not None:
            self.watch(self.seen, before, state, rows, counts)
        obs_out = None
        if obs is not None:
            assert_same(ref_obs[0], obs[0], what + " (buffer)")
            assert_same(ref_obs[1], obs[1], what + " (cursor)")
            obs_out = (tap.pc, obs[1], tap.placed_d, tap.depth)
        if not emit_returns:
            return state, None, None, None, None, obs_out
        got = fused_tick._outputs(io)
        for name, a, b in zip(("want", "bjob_vec", "ret_rows", "ret_valid"),
                              ref_io, got):
            assert torch.equal(a, b), f"{what}: {name}"
        return (state, *got, obs_out)


class CheckedLanes:
    """``fused_tick.fused_prefix_lanes`` for lane-stacked runs on CPU
    tensors: the host kernels' lane form (``fused_tick.launch_lanes``) on
    the batch in place, the plain per-lane loop on a copy, every leaf held
    equal; counts into ``chk`` (a ``Checked``) each form's launches, and
    in ``seen`` the ticks (``lane_ticks``) and the ticks whose launches
    were not one per group of lanes (``extra_launches``)."""

    def __init__(self, chk: Checked):
        self.chk = chk

    def __call__(self, engine, state, rows, counts, t, params, host,
                 emit_returns=False, out=None, obs=None, windowed=False):
        ref = clone_state(state)
        ref_obs = None if obs is None else tuple(map(clone_state, obs))
        _, *ref_io, _ = fused_tick.fused_prefix_lanes_reference(
            engine, ref, rows, counts, t, params, host, emit_returns, None,
            ref_obs, windowed)
        if emit_returns and out is None:
            out = empty_io(tuple(counts.shape), engine.n_msgs(),
                           counts.device)
        launched = fused_tick.launch_lanes(
            engine, state, rows, counts, t, host,
            out if emit_returns else None, obs, windowed)
        for k in launched:
            self.chk.launches[k.name] += 1
        self.chk.seen["lane_ticks"] += 1
        libs = [k.lib for k in launched]
        self.chk.seen["extra_launches"] += int(
            len(libs) != len(set(libs)) or len(libs) != len(host["groups"]))
        what = f"{[k.name for k in launched]} at t={t}"
        assert_same(ref, state, what)
        if obs is not None:
            assert_same(ref_obs[0], obs[0], what + " (buffer)")
            assert_same(ref_obs[1], obs[1], what + " (cursor)")
        if not emit_returns:
            return state, None, None, None, None, None
        got = fused_tick._outputs(out)
        for name, a, b in zip(("want", "bjob_vec", "ret_rows", "ret_valid"),
                              ref_io, got):
            assert torch.equal(a, b), f"{what}: {name}"
        return (state, *got, None)


@pytest.fixture
def checked(host_kernels, monkeypatch):
    chk = Checked()
    monkeypatch.setattr(fused_tick, "fused_prefix", chk)
    monkeypatch.setattr(fused_tick, "fused_prefix_lanes", CheckedLanes(chk))
    return chk


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def fifo_cfg(**kw):
    """The headline's config (bench.py _fifo_parity_scale) at its own
    queue and running-set sizes."""
    base = dict(policy=P.PolicyKind.FIFO, queue_capacity=8, max_running=32,
                max_arrivals=64, max_ingest_per_tick=8, parity=True,
                n_res=2, max_nodes=5, max_virtual_nodes=0)
    base.update(kw)
    return P.SimConfig(**base)


def ffd_cfg(**kw):
    """bench_borg4k's config (bench.py:1236) at a smaller queue."""
    base = dict(policy=P.PolicyKind.FFD, parity=False,
                max_placements_per_tick=16, queue_capacity=32,
                max_running=24, max_arrivals=64, max_ingest_per_tick=8,
                max_nodes=5, max_virtual_nodes=0, n_res=2)
    base.update(kw)
    return P.SimConfig(**base)


def specs(C, n_nodes=5, **kw):
    return [P.uniform_cluster(c + 1, n_nodes, **kw) for c in range(C)]


def stream(C, jobs, horizon_ms=40_000, max_cores=16, max_mem=12_000,
           max_dur_ms=20_000, seed=5):
    return uniform_stream(C, jobs, horizon_ms, max_cores=max_cores,
                          max_mem=max_mem, max_dur_ms=max_dur_ms, seed=seed)


def chunks_of(arr, n_ticks, cfg):
    half = n_ticks // 2
    return E.pack_arrivals_chunks(arr, [half, n_ticks - half], cfg.tick_ms)


def undersized(plan):
    """``plan`` with int8 queue cores (tests/test_kernels.py:283): a 600-core
    demand is stored as -128."""
    return dataclasses.replace(plan, queue=tuple(
        (n, "int8" if n == "cores" else dt) for n, dt in plan.queue))


def run(engine, state, arr, n_ticks, plane=False, params=None):
    """``n_ticks`` ticks of ``arr`` through ``run_chunks`` (the metrics
    plane on with ``plane``)."""
    mbuf = D.metrics_init(state) if plane else None
    out = engine.run_chunks(state, chunks_of(arr, n_ticks, engine.cfg),
                            params=params, mbuf=mbuf)
    return out[0] if plane else out


def fifo_headline(compact=False, plane=False, C=16, **kw):
    cfg = fifo_cfg(**kw)
    sp = specs(C)
    arr = stream(C, 60)
    plan = CC.derive_plan(cfg, sp, arr) if compact else None
    state = init_state(cfg, sp, device="cpu", plan=plan)
    return run(E.Engine(cfg, device="cpu"), state, arr, 45, plane)


def fifo_emit(compact=False):
    """Borrowing (BASELINE config 2's semantics) on small queues with one
    message slot: the even clusters are loaded and borrow, the odd ones
    lend; returns past the slot count into drops.msgs. A run_io chunk
    (the emit form's other caller) closes it."""
    cfg = fifo_cfg(parity=False, borrowing=True, queue_capacity=16,
                   max_running=16, max_msgs=1, max_nodes=5)
    C = 4
    sp = specs(C, n_nodes=2)
    arr = stream(C, 80, horizon_ms=30_000, max_cores=24, max_dur_ms=8_000)
    arr = dataclasses.replace(arr, n=np.where(np.arange(C) % 2 == 0,
                                              arr.n, 0).astype(np.int32))
    plan = CC.derive_plan(cfg, sp, arr) if compact else None
    state = init_state(cfg, sp, device="cpu", plan=plan)
    engine = E.Engine(cfg, device="cpu")
    out = run(engine, state, arr, 40)
    ta = E.pack_arrivals_by_tick(arr, 50, cfg.tick_ms)
    rows = torch.from_numpy(ta.rows[40:50].copy())
    counts = torch.from_numpy(ta.counts[40:50].copy())
    out, io = engine.run_io(out, rows, counts)
    return out


def with_vnodes(state, n_phys, expire_at):
    """Every virtual node slot active with a physical node's capacity, its
    contract ending at ``expire_at``: jobs place on them, then they
    expire."""
    v = slice(n_phys, None)
    state.node_active[:, v] = True
    state.node_cap[:, v] = state.node_cap[:, :1]
    state.node_free[:, v] = state.node_cap[:, :1]
    state.node_expire[:, v] = expire_at
    return state


def engine_for(cfg, policy):
    """The engine of ``cfg`` running ``policy`` (the config's own kind for
    fifo and ffd)."""
    if policy in ("fifo", "ffd"):
        return E.Engine(cfg, device="cpu")
    return E.Engine(cfg, device="cpu", policies=PolicySet((policy,)))


def expiring(policy, borrowing=False):
    """The expire forms: the trader on with expiry, the virtual slots
    loaded and expiring at 6 s."""
    trader = P.TraderConfig(enabled=True, expire_virtual_nodes=True)
    make = fifo_cfg if policy == "fifo" else ffd_cfg
    cfg = make(max_virtual_nodes=2, n_res=3, trader=trader,
               borrowing=borrowing, queue_capacity=16, max_running=24)
    C = 4
    sp = specs(C, n_nodes=3)
    state = with_vnodes(init_state(cfg, sp, device="cpu"), 3, 6_000)
    return run(engine_for(cfg, policy), state, stream(C, 60), 20)


def faulty(policy, compact=False, plane=False):
    """Generative churn fast enough to fail nodes within the run."""
    faults = P.FaultConfig(enabled=True, mode="generative", mttf_ms=15_000,
                           mttr_ms=4_000, seed=29, max_retries=2)
    make = fifo_cfg if policy == "fifo" else ffd_cfg
    cfg = make(faults=faults, queue_capacity=32, max_running=32)
    C = 8
    sp = specs(C)
    arr = stream(C, 60, max_dur_ms=30_000)
    plan = CC.derive_plan(cfg, sp, arr) if compact else None
    state = init_state(cfg, sp, device="cpu", plan=plan)
    return run(engine_for(cfg, policy), state, arr, 40, plane)


def windowed():
    """BASELINE config 1's shape at two clusters: the windowed Arrivals
    stream, the plane on (the tap form)."""
    cfg = fifo_cfg(parity=False, queue_capacity=64, max_running=32,
                   max_arrivals=256, max_ingest_per_tick=4)
    sp = specs(2)
    state = init_state(cfg, sp, device="cpu")
    arr = stream(2, 200, horizon_ms=30_000, max_dur_ms=60_000)
    engine = E.Engine(cfg, device="cpu")
    return engine.run(state, arr, 35, mbuf=D.metrics_init(state))[0]


def undersized_fifo():
    """The wave drain on an undersized plan: 600-core demands stored as
    -128 place and lift their node's free cores; the kernel replays the
    reference's waves."""
    cfg = fifo_cfg(parity=False, fifo_drain="wave")
    C = 8
    sp = specs(C)
    arr = stream(C, 30, horizon_ms=20_000, max_cores=600, max_mem=6_000,
                 max_dur_ms=60_000, seed=3)
    plan = undersized(CC.derive_plan(cfg, sp, None))
    state = init_state(cfg, sp, device="cpu", plan=plan)
    return run(E.Engine(cfg, device="cpu"), state, arr, 25)


def node_exit(policy):
    """The terminal node exit narrow on a hand-built plan: int8 node
    columns on 100-core nodes, which a placed -128-core job lifts past
    127; the one total over every cluster lands in each run.ovf."""
    cfg = fifo_cfg()
    C = 6
    sp = specs(C, n_nodes=2, cores=100, memory=100)
    arr = stream(C, 4, horizon_ms=4_000, max_cores=600, max_mem=50,
                 max_dur_ms=60_000, seed=4)
    plan = undersized(CC.derive_plan(cfg, sp, None))
    state = init_state(cfg, sp, device="cpu", plan=plan)
    engine = E.Engine(cfg, device="cpu", policies=PolicySet((policy,)))
    return run(engine, state, arr, 8, plane=policy == "fifo")


def ffd_run(policy="ffd", compact=False, plane=False, C=8, jobs=120,
            plan_of=None, max_cores=16, **kw):
    cfg = ffd_cfg(**kw)
    sp = specs(C)
    arr = stream(C, jobs, horizon_ms=30_000, max_cores=max_cores,
                 max_dur_ms=40_000)
    plan = plan_of(cfg, sp, arr) if plan_of else (
        CC.derive_plan(cfg, sp, arr) if compact else None)
    state = init_state(cfg, sp, device="cpu", plan=plan)
    engine = E.Engine(cfg, device="cpu", policies=PolicySet((policy,)))
    return run(engine, state, arr, 40, plane)


def ffd_emit():
    """The FFD kernel's emit form: run_io (every tick emits)."""
    cfg = ffd_cfg(max_msgs=4)
    C = 4
    sp = specs(C)
    arr = stream(C, 80, horizon_ms=20_000)
    ta = E.pack_arrivals_by_tick(arr, 24, cfg.tick_ms)
    state = init_state(cfg, sp, device="cpu")
    out, _ = E.Engine(cfg, device="cpu").run_io(
        state, torch.from_numpy(ta.rows.copy()),
        torch.from_numpy(ta.counts.copy()))
    return out


def ffd_undersized():
    """FFD's wave sweep on an undersized plan, over a queue deeper than
    its cap: the clamped rows make the kernel replay the waves over the
    warp's order."""
    return ffd_run(C=8, jobs=60, ffd_sweep="wave", max_cores=600,
                   plan_of=lambda cfg, sp, arr: undersized(
                       CC.derive_plan(cfg, sp, None)),
                   max_placements_per_tick=4)


def watching(watch):
    """Count the branches a run fires (``Checked.watch``)."""
    fused_tick.fused_prefix.watch = watch


def delay_cfg(**kw):
    """sinkhorn_market_setup's DELAY config (bench.py:993, config 4) at
    small queues, the trace on."""
    base = dict(policy=P.PolicyKind.DELAY, parity=False,
                max_placements_per_tick=8, queue_capacity=16,
                max_running=24, max_arrivals=128, max_ingest_per_tick=8,
                max_nodes=5, max_virtual_nodes=0, n_res=3,
                delay_sweep="wave", record_trace=True, max_trace_events=512)
    base.update(kw)
    return P.SimConfig(**base)


def delay_watch(QC):
    """Promotions (Level1 grows only by them), promotions dropped by a full
    Level1 (the tick's drops.queue less the ingest's), run_full, a Level1
    deeper than the cap, a negative demand among the swept Level1 rows,
    and the parity skip (a Level1 slot placed while the next one was still
    inside the sweep: the skip passes over it; needs the trace)."""
    def watch(seen, before, after, rows, counts):
        room = before.l0.capacity - before.l0.count
        ingest_drops = (counts.clamp(0, rows.shape[1]) - room).clamp(min=0)
        seen["promoted"] += int((after.l1.count > before.l1.count).sum())
        seen["l1_full"] += int((after.drops.queue - before.drops.queue
                                - ingest_drops).sum())
        seen["run_full"] += int((after.drops.run_full
                                 - before.drops.run_full).sum())
        n_sweep = before.l1.count.clamp(max=QC)
        seen["capped"] += int((before.l1.count > QC).sum())
        swept = torch.arange(before.l1.capacity) < n_sweep[:, None]
        seen["negative"] += int(((before.l1.cores < 0) & swept).sum())
        n0, n1 = before.trace.n.tolist(), after.trace.n.tolist()
        for c in range(len(n0)):
            new = slice(n0[c], n1[c])
            placed = set(after.trace.job[c, new][
                after.trace.src[c, new] == 0].tolist())  # SRC_L1
            ids = before.l1.id[c].tolist()
            seen["skips"] += sum(1 for i in range(int(n_sweep[c]) - 1)
                                 if ids[i] in placed)
    return watch


def delay_run(compact=False, plane=False, C=8, jobs=120, n_ticks=40,
              policy="delay", plan_of=None, max_cores=24, max_mem=18_000,
              **kw):
    """DELAY (``policy``: delay, delay-eager) on the market's gpu-rich and
    gpu-poor clusters, its branches counted."""
    cfg = delay_cfg(**kw)
    sp = specs(C)
    arr = stream(C, jobs, horizon_ms=30_000, max_cores=max_cores,
                 max_mem=max_mem, max_dur_ms=40_000)
    plan = plan_of(cfg, sp, arr) if plan_of else (
        CC.derive_plan(cfg, sp, arr) if compact else None)
    state = init_state(cfg, sp, device="cpu", plan=plan)
    watching(delay_watch(K._sweep_len(cfg)))
    return run(engine_for(cfg, policy), state, arr, n_ticks, plane)


def delay_emit():
    """The DELAY kernel's emit form: run_io (every tick emits)."""
    cfg = delay_cfg(max_msgs=4)
    C = 4
    arr = stream(C, 80, horizon_ms=20_000, max_cores=24)
    ta = E.pack_arrivals_by_tick(arr, 24, cfg.tick_ms)
    state = init_state(cfg, specs(C), device="cpu")
    out, _ = E.Engine(cfg, device="cpu").run_io(
        state, torch.from_numpy(ta.rows.copy()),
        torch.from_numpy(ta.counts.copy()))
    return out


def delay_windowed():
    """BASELINE config 1's shape (bench.py:839-895) under DELAY: one
    cluster_small, queue 768, running 512, the windowed Arrivals stream,
    record_metrics and the plane on (the tap form), its first 40 ticks."""
    cfg = P.SimConfig(policy=P.PolicyKind.DELAY, queue_capacity=768,
                      max_running=512, max_arrivals=512, max_nodes=5,
                      n_res=2, record_metrics=True)
    state = init_state(cfg, [P.uniform_cluster(1, 5)], device="cpu")
    arr = uniform_stream(1, 512, 60_000, max_cores=16, max_mem=12_000,
                         max_dur_ms=600_000, seed=9)
    return E.Engine(cfg, device="cpu").run(state, arr, 40,
                                           mbuf=D.metrics_init(state))[0]


def mixed_specs(C, n_nodes=5):
    """Clusters with nodes of all four device types (chip_smoke.py
    mixed_specs), where the class tables of gavel and rl choose between
    nodes; ``n_nodes`` past 5 repeats them."""
    kinds = ((32, 24_000, 0, 0), (16, 12_000, 0, 2), (64, 48_000, 4, 3),
             (32, 24_000, 8, 1), (32, 24_000, 0, 0))
    return [P.ClusterSpec(id=c + 1, nodes=tuple(
        P.NodeSpec(id=i + 1, cores=k, memory=m, gpus=g, device_type=d)
        for i, (k, m, g, d) in ((i, kinds[i % 5]) for i in range(n_nodes))))
        for c in range(C)]


def table(rows):
    return torch.tensor(rows, dtype=torch.float32)


RNG = np.random.default_rng(17)
# a non-uniform gavel table and seeded rl scores (tests/test_torch_scored.py)
GAVEL = table(RNG.uniform(0.5, 4.0, size=(4, 4)))
RL = table(RNG.normal(size=(4, 4)))
# a NaN score wins wherever its node fits; every score -inf sends every
# job to node 0 while any node fits, fit or not (the reference's argmax)
NAN = table([[1.0, 2.0, float("nan"), 1.0]] * 4)
NEG_INF = table([[float("-inf")] * 4] * 4)


def scored_cfg(**kw):
    """tests/test_kernels.py:98's scored config, the trace on."""
    base = dict(policy=P.PolicyKind.DELAY, parity=False,
                max_placements_per_tick=8, queue_capacity=32,
                max_running=64, max_arrivals=128, max_ingest_per_tick=8,
                n_res=3, max_nodes=5, max_virtual_nodes=0,
                record_trace=True, max_trace_events=512)
    base.update(kw)
    return P.SimConfig(**base)


def scored_run(policy, leaves=None, compact=False, plane=False, C=8,
               jobs=100, n_nodes=5, n_ticks=40, first_fit_twin=False,
               **kw):
    """A scored kind on clusters of mixed device types, a gpu job in
    five; ``leaves`` replaces parameter leaves. With ``first_fit_twin`` the
    same world also runs through the plain version under first fit (rl's
    zero scores, the same queue order), and ``seen["off_first_fit"]``
    counts the clusters whose placements the scores moved."""
    cfg = scored_cfg(max_nodes=n_nodes, **kw)
    sp = mixed_specs(C, n_nodes)
    arr = uniform_stream(C, jobs, 30_000, max_cores=16, max_mem=12_000,
                         max_dur_ms=40_000, seed=3, max_gpus=2,
                         gpu_frac=0.2)
    plan = CC.derive_plan(cfg, sp, arr) if compact else None
    engine = engine_for(cfg, policy)
    params = engine._default_params.replace(**(leaves or {}))
    out = run(engine, init_state(cfg, sp, device="cpu", plan=plan), arr,
              n_ticks, plane, params)
    if first_fit_twin:
        chk = fused_tick.fused_prefix
        twin = engine_for(cfg, "rl")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fused_tick, "fused_prefix", chk.real)
            ff = run(twin, init_state(cfg, sp, device="cpu"), arr, n_ticks)
        trace = (CC.to_wide(out) if compact else out).trace
        moved = (trace.node != ff.trace.node).any(dim=1)
        chk.seen["off_first_fit"] += int(moved.sum())
    return out


def scored_emit(policy):
    """The scored kernel's emit form: run_io (every tick emits)."""
    cfg = scored_cfg(max_msgs=4)
    C = 4
    arr = uniform_stream(C, 80, 20_000, max_cores=16, max_mem=12_000,
                         max_dur_ms=20_000, seed=3, max_gpus=2,
                         gpu_frac=0.2)
    ta = E.pack_arrivals_by_tick(arr, 24, cfg.tick_ms)
    state = init_state(cfg, mixed_specs(C), device="cpu")
    out, _ = engine_for(cfg, policy).run_io(
        state, torch.from_numpy(ta.rows.copy()),
        torch.from_numpy(ta.counts.copy()))
    return out


def vnodes_expired(seen, before, after, rows, counts):
    """Virtual node slots the prefix deactivated (only expiry does, without
    the fault plane); the trader's rounds may attach them again."""
    v = slice(before.node_active.shape[1] - 2, None)
    seen["expired"] += int((before.node_active[:, v]
                            & ~after.node_active[:, v]).sum())


def level0_capped(QC):
    """Ticks where Level0, its arrivals in, holds more rows than the
    sweep's cap."""
    def watch(seen, before, after, rows, counts):
        depth = (before.l0.count + counts.clamp(0, rows.shape[1])).clamp(
            max=before.l0.capacity)
        seen["capped"] += int((depth > QC).sum())
    return watch


def idle_warps(name, C, *pick):
    """Whether ``name``'s launch at C clusters (config 4's N, R and Q)
    leaves its last block's last warps without a cluster."""
    warps, warp_bytes = ctypes.c_int(), ctypes.c_int64()
    getattr(build.load(name), name + "_geometry")(
        C, 1, 9, 3, 256, *pick, ctypes.byref(warps),
        ctypes.byref(warp_bytes))
    return C % warps.value != 0


def lane_idle_warps(name, C, L, N, R, Q, *order):
    """Whether the lane form's launch of ``name`` at L lanes of C clusters
    leaves the last block of each lane with warps and no cluster."""
    warps, warp_bytes = ctypes.c_int(), ctypes.c_int64()
    getattr(build.load(name), name + "_geometry")(
        C, L, N, R, Q, *order, ctypes.byref(warps),
        ctypes.byref(warp_bytes))
    return C % warps.value != 0


def lane_batch(cfg, sp, names, stream_of, leaves_of=None, n_ticks=24,
               plan_of=None, plane=False):
    """A lane-stacked batch through ``run_chunks`` (two chunks): lane i
    runs member ``names[i]`` of the set of the distinct names, over its
    own stream ``stream_of(i)`` and with its own parameter leaves
    ``leaves_of(i)``; the compact layout where ``plan_of`` makes a plan,
    the metrics plane with ``plane``. Returns the final batch."""
    pset = PolicySet(tuple(dict.fromkeys(names)))
    engine = E.Engine(cfg, device="cpu", policies=pset)
    arrs = [stream_of(i) for i in range(len(names))]
    plan = plan_of(cfg, sp, arrs[0]) if plan_of else None
    state = tenancy.stack_tenant_states(
        [init_state(cfg, sp, device="cpu", plan=plan) for _ in names])
    params = tenancy.stack_lanes([
        pset.params_for(cfg, n).replace(**(leaves_of(i) if leaves_of
                                           else {}))
        for i, n in enumerate(names)])
    per_lane = [chunks_of(a, n_ticks, cfg) for a in arrs]
    chunks = []
    for parts in zip(*per_lane):
        k = max(part.rows.shape[2] for part in parts)
        chunks.append(tenancy.stack_tick_arrivals(
            [tenancy.pad_tick_arrivals(part, k) for part in parts]))
    if not plane:
        return engine.run_chunks(state, chunks, params=params)
    mbuf = tenancy.stack_lanes([D.metrics_init(tenancy.tenant_cell(state, i))
                                for i in range(len(names))])
    return engine.run_chunks(state, chunks, params=params, mbuf=mbuf)[0]


def lanes_fifo():
    """FIFO lanes beside DELAY ones (each launch masks the other's lanes),
    compact, the plane on, 34 lanes of 7 clusters: two warps a block, the
    last one idle in every lane."""
    cfg = fifo_cfg(queue_capacity=16)
    sp = specs(7)
    names = ["fifo" if i % 3 else "delay-eager" for i in range(34)]
    return lane_batch(cfg, sp, names,
                      lambda i: stream(7, 30, horizon_ms=20_000, seed=5 + i),
                      plan_of=lambda cfg, sp, arr: CC.derive_plan(
                          cfg, sp, arr), plane=True)


def lanes_ffd():
    """FFD and ffd-memfirst lanes (the tie-break read per lane) beside
    FIFO ones, the plane on, 34 lanes of 7 clusters."""
    cfg = ffd_cfg(max_placements_per_tick=4)
    names = [("ffd", "ffd-memfirst", "fifo")[i % 3] for i in range(34)]
    return lane_batch(cfg, specs(7), names,
                      lambda i: stream(7, 40, horizon_ms=20_000,
                                       max_cores=24, seed=5 + i),
                      plane=True)


def lanes_delay():
    """delay, delay-eager and delay-patient lanes in one DELAY launch, each
    lane's promotion threshold its own, beside FIFO lanes, the plane on."""
    cfg = delay_cfg(max_placements_per_tick=2)
    names = [("delay-patient", "delay-eager", "delay", "fifo")[i % 4]
             for i in range(34)]
    return lane_batch(
        cfg, specs(7), names,
        lambda i: stream(7, 80, horizon_ms=20_000, max_cores=32,
                         max_dur_ms=40_000, seed=5 + i),
        leaves_of=lambda i: ({"max_wait_ms": torch.tensor(
            1_000 * (i % 7), dtype=torch.int32)} if i % 4 == 1 else {}),
        plane=True)


def lanes_scored():
    """gavel, rl and tesserae lanes in one scored launch, every lane's
    table, scores and weights its own, beside FFD lanes (the BFD order
    staged where a lane picks tesserae), the plane on."""
    cfg = scored_cfg()
    names = [("gavel", "rl", "tesserae", "ffd")[i % 4] for i in range(34)]
    rng = np.random.default_rng(23)

    def leaves(i):
        return {"gavel_tput": table(rng.uniform(0.5, 4.0, (4, 4))),
                "rl_scores": table(rng.normal(size=(4, 4))),
                "tess_w": table(rng.uniform(0.0, 2.0, 3))}
    return lane_batch(
        cfg, mixed_specs(7), names,
        lambda i: uniform_stream(7, 40, 20_000, max_cores=16,
                                 max_mem=12_000, max_dur_ms=30_000,
                                 seed=3 + i, max_gpus=2, gpu_frac=0.2),
        leaves_of=leaves, plane=True)


def lanes_node_exit():
    """The node exit narrow per lane, every source: int8 node columns on
    100-core nodes; the odd lanes' -128-core jobs lift a node past 127,
    the even lanes' small jobs never do, so only the odd lanes' run.ovf
    grow, each by its own lane's total."""
    cfg = fifo_cfg()
    names = [("fifo", "ffd", "delay", "gavel", "tesserae")[i % 5]
             for i in range(10)]
    sp = specs(6, n_nodes=2, cores=100, memory=100)
    return lane_batch(
        cfg, sp, names,
        lambda i: stream(6, 4, horizon_ms=4_000,
                         max_cores=600 if i % 2 else 16, max_mem=50,
                         max_dur_ms=60_000, seed=4 + i),
        n_ticks=10, plan_of=lambda cfg, sp, arr: undersized(
            CC.derive_plan(cfg, sp, None)), plane=True)


def promoted_lanes(s):
    """The lane indices mod 4 whose DELAY pass placed from Level1 (the
    trace's source 0): the delay-eager lanes (thresholds of 0-6 s) and the
    delay lanes, never the delay-patient ones (30 s) nor the FIFO ones."""
    return {i % 4 for i in range(s.trace.src.shape[0])
            if bool((s.trace.src[i] == 0).any())}


def per_lane_ovf(s):
    """Each lane's run.ovf one value over its clusters, nonzero on the odd
    lanes only."""
    ovf = s.run.ovf
    same = bool((ovf == ovf[:, :1]).all())
    return same and bool((ovf[1::2] > 0).all()) and \
        not bool(ovf[0::2].any())


def node_zero_overdrawn(seen, before, after, rows, counts):
    """The index-0 pick on a node that does not fit: node 0's free goes
    negative."""
    seen["node0_overdrawn"] += int((after.node_free[:, 0] < 0).any())


FIFO, EMIT = "fused_prefix_fifo", "fused_prefix_fifo_emit"
FFD = "fused_prefix_ffd"
DELAY, SCORED = "fused_prefix_delay", "fused_prefix_scored"

# name -> (the run, the kernel forms it must launch, a check of its final
# state and of the branches its watch counted)
CASES = {
    "fifo-headline": (lambda: fifo_headline(), [FIFO], None),
    "fifo-headline-compact": (lambda: fifo_headline(compact=True), [FIFO],
                              None),
    "fifo-tap": (lambda: fifo_headline(plane=True), [FIFO + "_tap"], None),
    "fifo-tap-compact": (lambda: fifo_headline(compact=True, plane=True),
                         [FIFO + "_tap"], None),
    "fifo-odd-C": (lambda: fifo_headline(C=301), [FIFO], None),
    "fifo-emit": (lambda: fifo_emit(), [EMIT],
                  lambda s, seen: int(s.drops.msgs.sum()) > 0
                  and int(s.lent.count.sum() + s.borrowed.count.sum()) > 0),
    "fifo-emit-compact": (lambda: fifo_emit(compact=True), [EMIT], None),
    "fifo-expire": (lambda: expiring("fifo"), [FIFO + "_expire"],
                    lambda s, seen: not bool(s.node_active[:, 3:].any())),
    "fifo-emit-expire": (lambda: expiring("fifo", borrowing=True),
                         [EMIT + "_expire"], None),
    "fifo-faults": (lambda: faulty("fifo"), [FIFO + "_faults"],
                    lambda s, seen: int(s.faults.kills.sum()) > 0),
    "fifo-faults-tap-compact": (
        lambda: faulty("fifo", compact=True, plane=True),
        [FIFO + "_tap_faults"], lambda s, seen: int(s.faults.kills.sum()) > 0),
    "fifo-windowed": (windowed, [FIFO + "_tap"],
                      lambda s, seen: int(s.drops.ingest.sum()) > 0),
    "fifo-undersized-waves": (undersized_fifo, [FIFO],
                              lambda s, seen: CC.overflow_total(s) > 0),
    "fifo-node-exit": (lambda: node_exit("fifo"), [FIFO + "_tap"],
                       lambda s, seen: int(s.run.ovf.min()) > 0),
    "ffd-cap2": (lambda: ffd_run(max_placements_per_tick=2,
                                 queue_capacity=64), [FFD], None),
    "ffd-cap16": (lambda: ffd_run(max_running=8), [FFD],
                  lambda s, seen: int(s.drops.run_full.sum()) > 0),
    "ffd-parity": (lambda: ffd_run(parity=True), [FFD], None),
    "ffd-memfirst-serial": (lambda: ffd_run("ffd-memfirst",
                                            ffd_sweep="serial",
                                            max_placements_per_tick=3),
                            [FFD], None),
    "ffd-compact-tap": (lambda: ffd_run(compact=True, plane=True),
                        [FFD + "_tap"], None),
    "ffd-odd-C": (lambda: ffd_run(C=299, jobs=20), [FFD], None),
    "ffd-emit": (ffd_emit, [FFD], None),
    "ffd-expire": (lambda: expiring("ffd"), [FFD + "_expire"], None),
    "ffd-faults-tap": (lambda: faulty("ffd", plane=True),
                       [FFD + "_tap_faults"],
                       lambda s, seen: int(s.faults.kills.sum()) > 0),
    "ffd-faults-compact": (lambda: faulty("ffd", compact=True),
                           [FFD + "_faults"], None),
    "ffd-undersized-waves": (ffd_undersized, [FFD],
                             lambda s, seen: CC.overflow_total(s) > 0),
    "ffd-node-exit": (lambda: node_exit("ffd"), [FFD],
                      lambda s, seen: int(s.run.ovf.min()) > 0),
    # DELAY: the Level1 sweep in parity (the skip) and in its wave form
    # under a cap below Level1, promotions into a full Level1, the head's
    # run_full, every form, both layouts
    "delay-parity-skip": (lambda: delay_run(parity=True, policy="delay-eager"),
                          [DELAY], lambda s, seen: seen["skips"] > 0),
    "delay-wave-capped": (lambda: delay_run(max_placements_per_tick=2,
                                            policy="delay-eager"),
                          [DELAY], lambda s, seen: seen["capped"] > 0
                          and seen["promoted"] > 0),
    "delay-serial-full-l1": (
        lambda: delay_run(queue_capacity=4, max_running=8, jobs=160,
                          delay_sweep="serial", policy="delay-eager"),
        [DELAY], lambda s, seen: seen["l1_full"] > 0
        and seen["run_full"] > 0),
    "delay-compact": (lambda: delay_run(compact=True, policy="delay-eager"),
                      [DELAY], lambda s, seen: seen["promoted"] > 0),
    "delay-tap": (lambda: delay_run(plane=True, policy="delay-eager"),
                  [DELAY + "_tap"], lambda s, seen: seen["promoted"] > 0),
    "delay-tap-compact-parity": (
        lambda: delay_run(compact=True, plane=True, parity=True,
                          policy="delay-eager"),
        [DELAY + "_tap"], lambda s, seen: seen["skips"] > 0),
    "delay-odd-C": (lambda: delay_run(C=297, jobs=16, n_ticks=20), [DELAY],
                    lambda s, seen: idle_warps(DELAY, 297)),
    "delay-emit": (delay_emit, [DELAY], lambda s, seen: seen["emit"] >= 8),
    "delay-expire": (lambda: (watching(vnodes_expired),
                              expiring("delay"))[1], [DELAY + "_expire"],
                     lambda s, seen: seen["expired"] > 0),
    "delay-faults-tap": (lambda: faulty("delay", plane=True),
                         [DELAY + "_tap_faults"],
                         lambda s, seen: int(s.faults.kills.sum()) > 0),
    "delay-faults-compact": (lambda: faulty("delay", compact=True),
                             [DELAY + "_faults"],
                             lambda s, seen: int(s.faults.kills.sum()) > 0),
    # 600-core demands stored as -128 that no node's memory fits: promoted,
    # they sit in Level1, and the wave sweep replays the waves
    "delay-undersized-waves": (
        lambda: delay_run(jobs=60, max_cores=600, max_mem=30_000,
                          policy="delay-eager",
                          plan_of=lambda cfg, sp, arr: undersized(
                              CC.derive_plan(cfg, sp, None))),
        [DELAY], lambda s, seen: CC.overflow_total(s) > 0
        and seen["negative"] > 0),
    "delay-node-exit": (lambda: node_exit("delay"), [DELAY],
                        lambda s, seen: int(s.run.ovf.min()) > 0),
    "delay-windowed": (delay_windowed, [DELAY + "_tap"],
                       lambda s, seen: seen["windowed"] >= 8),
    # the scored kinds: the pick's tables, NaN and -inf scores, a second
    # round of 32 nodes, tesserae's order and score, every form
    "gavel-table": (lambda: scored_run("gavel", {"gavel_tput": GAVEL},
                                       first_fit_twin=True),
                    [SCORED], lambda s, seen: seen["off_first_fit"] > 0),
    "gavel-tap-compact": (lambda: scored_run("gavel", compact=True,
                                             plane=True),
                          [SCORED + "_tap"], None),
    "rl-seeded": (lambda: scored_run("rl", {"rl_scores": RL},
                                     first_fit_twin=True),
                  [SCORED], lambda s, seen: seen["off_first_fit"] > 0),
    "gavel-nan": (lambda: scored_run("gavel", {"gavel_tput": NAN},
                                     first_fit_twin=True),
                  [SCORED], lambda s, seen: seen["off_first_fit"] > 0),
    "gavel-all-neg-inf": (
        lambda: (watching(node_zero_overdrawn),
                 scored_run("gavel", {"gavel_tput": NEG_INF}))[1],
        [SCORED], lambda s, seen: seen["node0_overdrawn"] > 0),
    "gavel-40-nodes": (
        lambda: scored_run("gavel", {"gavel_tput": table(
            [[1.0, 1.0, 1.0, 2.0]] * 4)}, n_nodes=40, C=4),
        [SCORED], lambda s, seen: int(s.trace.node.max()) >= 32),
    "gavel-odd-C": (lambda: scored_run("gavel", C=299, jobs=12,
                                       n_ticks=20), [SCORED],
                    lambda s, seen: idle_warps(SCORED, 299, 0)),
    "gavel-emit": (lambda: scored_emit("gavel"), [SCORED],
                   lambda s, seen: seen["emit"] >= 8),
    "gavel-node-exit": (lambda: node_exit("gavel"), [SCORED],
                        lambda s, seen: int(s.run.ovf.min()) > 0),
    "tesserae": (lambda: (watching(level0_capped(3)),
                          scored_run("tesserae",
                                     max_placements_per_tick=3))[1],
                 [SCORED], lambda s, seen: seen["capped"] > 0),
    "tesserae-big-weights": (
        lambda: scored_run("tesserae", {"tess_w": torch.ones(3)}),
        [SCORED], None),
    "tesserae-compact-tap": (lambda: scored_run("tesserae", compact=True,
                                                plane=True),
                             [SCORED + "_tap"], None),
    "tesserae-emit": (lambda: scored_emit("tesserae"), [SCORED],
                      lambda s, seen: seen["emit"] >= 8),
    "tesserae-expire": (lambda: (watching(vnodes_expired),
                                 expiring("tesserae"))[1],
                        [SCORED + "_expire"],
                        lambda s, seen: seen["expired"] > 0),
    "tesserae-faults": (lambda: faulty("tesserae"), [SCORED + "_faults"],
                        lambda s, seen: int(s.faults.kills.sum()) > 0),
    "tesserae-faults-tap-compact": (
        lambda: faulty("tesserae", compact=True, plane=True),
        [SCORED + "_tap_faults"],
        lambda s, seen: int(s.faults.kills.sum()) > 0),
    "tesserae-node-exit": (lambda: node_exit("tesserae"), [SCORED],
                           lambda s, seen: int(s.run.ovf.min()) > 0),
    # the lane form: one launch a source a tick over every lane
    "lanes-fifo": (lanes_fifo, [FIFO + "_tap", DELAY + "_tap"],
                   lambda s, seen: seen["extra_launches"] == 0
                   and lane_idle_warps(FIFO, 7, 34, 5, 2, 16)
                   and int(s.placed_total.sum()) > 0),
    "lanes-ffd": (lanes_ffd, [FFD + "_tap", FIFO + "_tap"],
                  lambda s, seen: seen["extra_launches"] == 0
                  and lane_idle_warps(FFD, 7, 34, 5, 2, 32)),
    "lanes-delay": (lanes_delay, [DELAY + "_tap", FIFO + "_tap"],
                    lambda s, seen: seen["extra_launches"] == 0
                    and promoted_lanes(s) == {1, 2}),
    "lanes-scored": (lanes_scored, [SCORED + "_tap", FFD + "_tap"],
                     lambda s, seen: seen["extra_launches"] == 0
                     and lane_idle_warps(SCORED, 7, 34, 5, 3, 32, 1)),
    "lanes-node-exit": (lanes_node_exit,
                        [FIFO + "_tap", FFD + "_tap", DELAY + "_tap",
                         SCORED + "_tap"],
                        lambda s, seen: seen["extra_launches"] == 0
                        and per_lane_ovf(s)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_host_kernel_equals_plain(checked, name):
    make, forms, check = CASES[name]
    out = make()
    assert set(checked.launches) == set(forms), dict(checked.launches)
    assert min(checked.launches.values()) >= 8
    if check is not None:
        assert check(out, checked.seen), (
            f"{name}: the run missed the branch it is for: {dict(checked.seen)}")

