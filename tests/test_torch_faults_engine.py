"""Runs of the port's fault plane against the JAX package, on the CPU.

The scenarios of tests/test_faults.py, mirrored port against JAX: the
faults-off baseline and the enabled plane with an empty trace schedule
(:70); generative churn dense and in ragged chunks (:93 — its compact
cell is tests/test_torch_compact.py's; its mesh cells are
tests/test_torch_mesh_paths.py's); the
adversarial trace schedules (:186, :205, :215, :227, :238); a killed
foreign job back into the LentQueue (:249); a failed node hosting a traded
virtual node (:299). Then the fused kernel's own test
(tests/test_kernels.py:178 test_fused_composes_with_faults) against the
reference's Pallas kernel in interpret mode, DELAY, FFD and gavel under
churn, and bench.py bench_faults's quick shape with its gates. Every
``SimState`` leaf bitwise (the fault leaves and the uint32 keys included)
through ``interop.state_to_numpy``; on the CPU the plain path runs, which
the CUDA kernels are held against on the card (chip_smoke.py 3k).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from multi_cluster_simulator_tpu.config import FaultConfig, PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.policies import PolicySet as JPolicySet
from multi_cluster_simulator_tpu.workload.traces import uniform_stream
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.kernels import fused_tick as tfused
from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg

CHURN = FaultConfig(enabled=True, mode="generative", mttf_ms=20_000,
                    mttr_ms=4_000, seed=5, max_retries=8)


def _cfg(faults=None, **kw):
    """tests/test_faults.py's config."""
    base = dict(policy=PolicyKind.FIFO, parity=True, n_res=2,
                queue_capacity=64, max_running=64, max_arrivals=40,
                max_ingest_per_tick=16, max_nodes=5, max_virtual_nodes=0)
    base.update(kw)
    if faults is not None:
        base["faults"] = faults
    return SimConfig(**base)


def _stream(C, jobs=40, horizon=60_000, seed=3, max_dur=20_000):
    return uniform_stream(C, jobs, horizon, max_cores=8, max_mem=6_000,
                          max_dur_ms=max_dur, seed=seed)


def _specs(C, n_nodes=5, **kw):
    return ([uniform_cluster(c + 1, n_nodes, **kw) for c in range(C)],
            [tspec.uniform_cluster(c + 1, n_nodes, **kw) for c in range(C)])


def run_pair(cfg, C, arr, T, chunks=None, events=None, policy=None,
             js0=None, n_nodes=5, **spec_kw):
    """The JAX engine's jitted run over the tick-indexed bucket and the
    port's ``run_chunks`` (in ``chunks`` when given) from the same initial
    state — each package's own ``init_state``, held equal, unless ``js0``
    (a JAX state) is given; every leaf must be equal. Returns both final
    states."""
    specs_j, specs_t = _specs(C, n_nodes, **spec_kw)
    jp = None if policy is None else JPolicySet((policy,))
    tp = None if policy is None else PolicySet((policy,))
    tcfg = port_cfg(cfg)
    if js0 is None:  # the port's own initial state, equal to the JAX one
        js0 = jinit_state(cfg, specs_j, fault_events=events)
        ts0 = tstate.init_state(tcfg, specs_t, fault_events=events,
                                device="cpu")
        assert_leaves_equal(jax_leaves(js0), interop.state_to_numpy(ts0))
    else:
        ts0 = interop.state_from_numpy(jax_leaves(js0), device="cpu")
    want = jengine.Engine(cfg, policies=jp).run_jit()(
        js0, jengine.pack_arrivals_by_tick(arr, T, cfg.tick_ms), T)
    got = tengine.Engine(tcfg, device="cpu", policies=tp).run_chunks(
        ts0, tengine.pack_arrivals_chunks(port_arrivals(arr),
                                          chunks or [T], tcfg.tick_ms))
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    return want, got


def _shared(leaves: dict) -> dict:
    return {k: v for k, v in leaves.items() if not k.startswith(".faults")}


# --------------------------------------------------------------------------
# tests/test_faults.py, mirrored
# --------------------------------------------------------------------------

def test_faults_off_is_baseline():
    """:70 — the enabled plane with an empty trace schedule leaves every
    shared leaf as the faults-off run does; both runs equal the JAX
    package's."""
    C, T = 4, 80
    arr = _stream(C)
    _, off = run_pair(_cfg(), C, arr, T)
    cfg_empty = _cfg(faults=dataclasses.replace(CHURN, mode="trace"))
    _, empty = run_pair(cfg_empty, C, arr, T, events=[])
    assert_leaves_equal(_shared(interop.state_to_numpy(off)),
                        _shared(interop.state_to_numpy(empty)))
    assert bool(off.faults.health.all())
    assert int(empty.faults.kills.sum()) == 0
    assert ttrace.total_drops(off)["failed"] == 0


@pytest.mark.parametrize("cell", ["dense", "ragged"])
def test_churn_dense_and_ragged_chunks_equal_jax(cell):
    """:93 — generative churn at 8 clusters over 80 ticks, in one chunk
    and in ragged chunks cut mid-outage (33, 29, 18)."""
    C, T = 8, 80
    chunks = None if cell == "dense" else [33, 29, T - 62]
    _, got = run_pair(_cfg(faults=CHURN), C, _stream(C), T, chunks=chunks)
    assert int(got.faults.kills.sum()) > 0
    assert int(got.faults.requeues.sum()) > 0
    ttrace.check_conservation(got)


def _one_cluster_trace(events, T=30, jobs=6, max_retries=3, dur=60_000):
    """tests/test_faults.py:163's single cluster under an explicit
    schedule, with jobs that outlive the horizon."""
    fc = FaultConfig(enabled=True, mode="trace", max_retries=max_retries,
                     max_events=4)
    arr = uniform_stream(1, jobs, 2_000, max_cores=4, max_mem=2_000,
                         max_dur_ms=dur, seed=9)
    arr = arr.replace(dur=jnp.maximum(arr.dur, dur // 2))
    return run_pair(_cfg(faults=fc), 1, arr, T, events=events)[1]


def _kill_requeues_with_budget_bump(out):
    fs = out.faults
    assert int(fs.kills[0]) > 0
    assert int(fs.requeues[0]) == int(fs.kills[0])
    assert int(fs.down_ms[0]) == 3_000
    assert bool(fs.health.all())
    assert int(fs.n_fails[0, 0]) == 1
    act = out.run.active[0]
    assert bool(act.any())
    assert (out.run.data[0, :, 9][act] == 1).all()  # retries
    assert ttrace.total_drops(out)["failed"] == 0


def _fail_at_t0(out):
    assert not bool(out.faults.health[0, :5].any())
    assert int(out.placed_total.sum()) == 0
    assert int(out.faults.kills.sum()) == 0
    assert bool((out.node_free[0, :5] == 0).all())


def _same_tick_outage(out):
    fs = out.faults
    assert int(fs.kills[0]) > 0
    assert int(fs.down_ms[0]) == 0
    assert int(fs.n_fails[0, 0]) == 1
    assert bool(fs.health.all())


def _repair_before_fail(out):
    fs = out.faults
    assert bool(fs.health.all())
    assert int(fs.n_fails[0, 0]) == 1
    assert int(fs.down_ms[0]) == 0


def _budget_exhausted(out):
    kills = int(out.faults.kills[0])
    assert kills > 0
    assert int(out.faults.requeues[0]) == 0
    assert ttrace.total_drops(out)["failed"] == kills


TRACE_CASES = {
    "kill_requeues_with_budget_bump": ([(0, 0, 5_000, 8_000)], 3,
                                       _kill_requeues_with_budget_bump),
    "fail_at_t0": ([(0, n, 0, 60_000) for n in range(5)], 3, _fail_at_t0),
    "same_tick_fail_repair": ([(0, 0, 5_000, 5_000)], 3, _same_tick_outage),
    "repair_before_fail": ([(0, 0, 5_000, 3_000)], 3, _repair_before_fail),
    "retry_budget_exhaustion": ([(0, n, 5_000, 6_000) for n in range(5)], 0,
                                _budget_exhausted),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_schedules_equal_jax(case):
    """:186, :205, :215, :227, :238 — each scenario's own asserts on the
    port's state, which equals the JAX package's."""
    events, max_retries, check = TRACE_CASES[case]
    out = _one_cluster_trace(events, max_retries=max_retries)
    check(out)
    if case != "fail_at_t0":
        ttrace.check_conservation(out)


def test_killed_foreign_job_requeues_into_lent():
    """:249 — on a cluster whose nodes all fail, a foreign job goes back
    into the LentQueue and an own job into the FIFO ready/wait flow."""
    from multi_cluster_simulator_tpu.ops import queues as jQ
    from multi_cluster_simulator_tpu.ops import runset as jR

    fc = FaultConfig(enabled=True, mode="trace", max_retries=3, max_events=2)
    cfg = _cfg(faults=fc)
    specs_j, _ = _specs(2)
    state = jinit_state(cfg, specs_j, fault_events=[
        (0, n, 2_000, 60_000) for n in range(cfg.total_nodes)])
    rows = {1: jR.make_row(90_000, 0, 2, 100, 0, 71, 1, 89_000, 1_000),
            0: jR.make_row(90_000, 0, 3, 200, 0, 72, int(np.asarray(jQ.OWN)),
                           89_000, 1_000)}
    data = np.asarray(state.run.data).copy()
    act = np.asarray(state.run.active).copy()
    for slot, row in rows.items():
        data[0, slot] = np.asarray(row)
        act[0, slot] = True
    state = state.replace(
        run=state.run.replace(data=jnp.asarray(data),
                              active=jnp.asarray(act)),
        node_free=state.node_free.at[0, 0, 0].add(-5).at[0, 0, 1].add(-300))
    arr = uniform_stream(2, 1, 1, max_cores=1, max_mem=1, max_dur_ms=1,
                         seed=0)
    arr = arr.replace(n=jnp.zeros_like(arr.n))
    _, out = run_pair(cfg, 2, arr, 5, js0=state)
    assert int(out.faults.kills[0]) == 2
    lent = out.lent.data[0, :int(out.lent.count[0])]
    assert lent[:, 0].tolist() == [71]
    assert lent[0, 6] == 1 and lent[0, 9] == 1  # owner, retries
    own = np.concatenate([
        out.ready.data[0, :int(out.ready.count[0]), 0].numpy(),
        out.wait.data[0, :int(out.wait.count[0]), 0].numpy()])
    assert 72 in own.tolist()
    ttrace.check_conservation(out)


def test_fail_node_hosting_borrowed_vnode():
    """:299 — the slot a traded virtual node occupies fails: its job is
    killed and requeued, the slot stays down and inactive, and repair
    restores the virtual node empty."""
    from multi_cluster_simulator_tpu.services import host_ops

    fc = FaultConfig(enabled=True, mode="trace", max_retries=3, max_events=4)
    cfg = _cfg(faults=fc, max_nodes=1, max_virtual_nodes=2, n_res=3)
    spec = [uniform_cluster(1, 1, cores=2, memory=500)]
    vslot = cfg.max_nodes
    state = jinit_state(cfg, spec, fault_events=[(0, vslot, 5_000, 9_000)])
    state, ok = host_ops.add_virtual_node(state, 8, 4_000, 60_000,
                                          vstart=cfg.max_nodes)
    assert bool(ok)
    arr = uniform_stream(1, 1, 1_000, max_cores=4, max_mem=2_000,
                         max_dur_ms=50_000, seed=1)
    arr = arr.replace(cores=jnp.full_like(arr.cores, 4),
                      mem=jnp.full_like(arr.mem, 2_000),
                      dur=jnp.full_like(arr.dur, 50_000))
    want, mid = run_pair(cfg, 1, arr, 6, js0=state, n_nodes=1)
    assert int(mid.faults.kills[0]) == 1
    assert not bool(mid.faults.health[0, vslot])
    assert not bool(mid.node_active[0, vslot])
    _, out = run_pair(cfg, 1, arr, 14, js0=want, n_nodes=1)
    assert bool(out.faults.health[0, vslot])
    assert bool(out.node_active[0, vslot])
    there = (out.run.node[0] == vslot) & out.run.active[0]
    used = out.run.data[0, there][:, 2:5].sum(0)
    assert (out.node_free[0, vslot] == out.node_cap[0, vslot] - used).all()
    ttrace.check_conservation(out)


# --------------------------------------------------------------------------
# the kernel's span, other kinds, the bench's churn config
# --------------------------------------------------------------------------

def test_fused_composes_with_faults():
    """tests/test_kernels.py:178 — generative churn opening the span, the
    reference run through its Pallas kernel (interpret mode on the CPU):
    the port equals it, and the span the port's kernel carries opens
    with the faults step."""
    from tests.test_pipeline import _bursty_arrivals
    from tests.test_pipeline import _cfg as pipeline_cfg

    cfg = pipeline_cfg()
    cfg = dataclasses.replace(cfg, fused="on", fused_block=1,
                              faults=dataclasses.replace(
                                  cfg.faults, enabled=True, mttf_ms=8_000,
                                  mttr_ms=3_000))
    C = 3
    _, got = run_pair(cfg, C, _bursty_arrivals(C), 30)
    assert int(got.faults.kills.sum()) > 0
    eng = tengine.Engine(port_cfg(cfg), device="cpu")
    prov = tfused.provenance(eng)
    assert prov["span"] == ["faults", "release", "ingest", "schedule"]
    assert prov["kernel"] == "fused_prefix_fifo_faults"
    assert not any(tfused.launch_counts().values())


@pytest.mark.parametrize("policy", ["delay", "ffd", "gavel"])
def test_level0_kinds_under_churn_equal_jax(policy):
    """The Level0 ingest target: requeues into Level0 with the DELAY-side
    counters, at 8 clusters over 80 ticks with small queues."""
    C, T = 8, 80
    cfg = _cfg(faults=dataclasses.replace(CHURN, mttf_ms=10_000),
               parity=False, queue_capacity=16, max_running=24)
    _, got = run_pair(cfg, C, _stream(C), T, chunks=[40, 40], policy=policy)
    assert int(got.faults.kills.sum()) > 0
    assert int(got.faults.requeues.sum()) > 0
    eng = tengine.Engine(port_cfg(cfg), device="cpu",
                         policies=PolicySet((policy,)))
    assert tfused.provenance(eng)["kernel"].endswith("_faults")


def test_bench_faults_quick_shape_and_its_gates():
    """bench.py:2869 bench_faults(quick=True): FIFO parity, 8 clusters x
    40 jobs over 120 s, generative churn (mttf 30 s, mttr 3 s, seed 29,
    max_retries 16). Its gates on the port: an enabled plane with an empty
    trace schedule leaves every shared leaf as the faults-off run; the
    churn run kills and requeues, drops nothing, conserves; and equals the
    JAX package's."""
    C, jobs, horizon = 8, 40, 120_000
    base = SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                     queue_capacity=128, max_running=128, max_arrivals=jobs,
                     max_ingest_per_tick=16, max_nodes=5,
                     max_virtual_nodes=0)
    churn = FaultConfig(enabled=True, mode="generative",
                        mttf_ms=horizon // 4, mttr_ms=horizon // 40,
                        seed=29, max_retries=16)
    arr = uniform_stream(C, jobs, horizon, max_cores=8, max_mem=6_000,
                         max_dur_ms=30_000, seed=13)
    T = horizon // base.tick_ms + 90
    tcfg = port_cfg(base)
    _, specs_t = _specs(C)
    parts = tengine.pack_arrivals_chunks(port_arrivals(arr), [T],
                                         tcfg.tick_ms)
    off = tengine.Engine(tcfg, device="cpu").run_chunks(
        tstate.init_state(tcfg, specs_t, device="cpu"), parts)
    cfg_empty = port_cfg(dataclasses.replace(
        base, faults=dataclasses.replace(churn, mode="trace")))
    empty = tengine.Engine(cfg_empty, device="cpu").run_chunks(
        tstate.init_state(cfg_empty, specs_t, fault_events=[],
                          device="cpu"), parts)
    assert_leaves_equal(_shared(interop.state_to_numpy(off)),
                        _shared(interop.state_to_numpy(empty)))
    _, got = run_pair(dataclasses.replace(base, faults=churn), C, arr, T)
    assert int(got.faults.kills.sum()) > 0
    assert int(got.faults.requeues.sum()) > 0
    assert all(v == 0 for v in ttrace.total_drops(got).values())
    ttrace.check_conservation(got)
