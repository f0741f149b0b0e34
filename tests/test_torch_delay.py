"""The port's DELAY path against the JAX package, on the CPU.

Bitwise throughout, ``wait_total`` (f32) included: ``set_field_elem``
under ``jax.vmap``; the DELAY pass through ``_run_kind`` in its three
forms (parity: the serial sweep with the remove-then-skip quirk; wave;
serial with parity off) for ``delay``, ``delay-eager`` and
``delay-patient`` on states the JAX engine reached, on bounds tight
enough that the skip quirk, the Level0-head promotion, a full Level1
(``drops.queue``) and ``drops.run_full`` all fire; whole ``run_chunks``
runs in two ragged-K chunks against JAX ``run_jit``, unfused and with the
Pallas prefix in interpret mode; the two DELAY scenarios of the reference's
fused-kernel policy matrix that run without the trader; and the
reference's DELAY oracle-parity scenarios (bench.py:1336-1350), whose
traces must equal the pure-Python Go oracle's and the JAX engine's.
Inputs come from numpy seeds.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import (
    PolicyKind, SimConfig, WorkloadConfig,
)
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.spec import (
    load_cluster_json, uniform_cluster,
)
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.oracle.go_semantics import Oracle
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.policies import base as jbase
from multi_cluster_simulator_tpu.utils.trace import (
    extract_trace as jextract, oracle_trace_per_cluster,
)
from multi_cluster_simulator_tpu.workload.generator import generate_arrivals
from multi_cluster_simulator_tpu.workload.traces import uniform_stream
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.core.state import SRC_L1
from multi_cluster_simulator_tpu_torch.ops import queues as tQ
from multi_cluster_simulator_tpu_torch.policies import base as tbase
from multi_cluster_simulator_tpu_torch.policies import kernels as tK
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from multi_cluster_simulator_tpu_torch.workload import traces as ttraces
from tests.test_pipeline import TC_TICKS, _tc_scenarios
from tests.test_torch_engine import (
    assert_leaves_equal, jax_leaves, port_cfg,
)
from tests.test_torch_ops import eq, rand_queue, t_

SEEDS = [0, 1, 2]
POLICIES = ["delay", "delay-eager", "delay-patient"]
FORMS = {"parity": dict(parity=True), "wave": dict(),
         "serial": dict(delay_sweep="serial")}


def delay_cfg(**kw):
    """The market shape of bench.py:sinkhorn_market_setup at test scale
    (DELAY, wave sweep, 3 resources, 4 virtual slots, trader off), the JAX
    class, with the trace on and bounds that bind."""
    base = dict(policy=PolicyKind.DELAY, parity=False, delay_sweep="wave",
                max_placements_per_tick=4, queue_capacity=12, max_running=10,
                max_arrivals=100, max_ingest_per_tick=16, max_nodes=5,
                max_virtual_nodes=4, n_res=3, record_trace=True,
                max_trace_events=512)
    base.update(kw)
    return SimConfig(**base)


def market_specs(n_clusters):
    """gpu-rich even clusters, gpu-poor odd ones, in both packages."""
    gpus = [8 if c % 2 == 0 else 0 for c in range(n_clusters)]
    return ([uniform_cluster(c + 1, 5, gpus=g) for c, g in enumerate(gpus)],
            [tspec.uniform_cluster(c + 1, 5, gpus=g)
             for c, g in enumerate(gpus)])


def port_arrivals(arr) -> tstate.Arrivals:
    """A JAX ``Arrivals`` stream as the port's (host numpy either way)."""
    return tstate.Arrivals(**{f.name: np.asarray(getattr(arr, f.name))
                              for f in dataclasses.fields(tstate.Arrivals)})


def market_stream(n_clusters, jobs, horizon_ms, seed=7, **kw):
    """The market's uniform stream from the JAX package and from the
    port's copy (tests/test_torch_copies.py pins them equal)."""
    args = dict(max_cores=24, max_mem=18_000, max_dur_ms=40_000, seed=seed,
                max_gpus=2, gpu_frac=0.1)
    args.update(kw)
    return (uniform_stream(n_clusters, jobs, horizon_ms, **args),
            ttraces.uniform_stream(n_clusters, jobs, horizon_ms, **args))


def port_params(cfg, name):
    return tbase.default_params(port_cfg(cfg), tbase.REGISTRY[name])


# --------------------------------------------------------------------------
# the op and the parameter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slot", [0, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_set_field_elem_equals_jax(seed, slot):
    rng = np.random.default_rng(50 + seed)
    data, count = rand_queue(rng)
    vals = rng.integers(-50, 50_000, data.shape[0]).astype(np.int32)
    want = jax.vmap(lambda d, n, v: jQ.set_field_elem(
        jQ.JobQueue(data=d, count=n), "rec_wait", slot, v))(
        jnp.asarray(data), jnp.asarray(count), jnp.asarray(vals))
    q = tQ.JobQueue(data=t_(data), count=t_(count))
    got = tQ.set_field_elem(q, "rec_wait", slot, t_(vals))
    eq(want.data, got.data)
    eq(want.count, got.count)
    np.testing.assert_array_equal(q.data.numpy(), data)  # input untouched


def test_max_wait_ms_is_a_parameter():
    cfg = delay_cfg()
    tcfg = port_cfg(cfg)
    assert tK._max_wait_ms(tcfg, None) == cfg.max_wait_ms == 10_000
    for name, want in (("delay", 10_000), ("delay-eager", 2_000),
                       ("delay-patient", 30_000)):
        got = tK._max_wait_ms(tcfg, port_params(cfg, name))
        assert got.dtype == torch.int32 and int(got) == want
        assert int(jbase.default_params(
            cfg, jbase.REGISTRY[name]).max_wait_ms) == want


# --------------------------------------------------------------------------
# the DELAY pass (_run_kind) on states the JAX engine reached
# --------------------------------------------------------------------------

NC = 12
PASS_TICKS = (6, 12, 18, 24, 30, 36)


def _pre_states(form, policy):
    """(t, JAX pre-schedule state) at PASS_TICKS: the JAX engine runs the
    ticks before, then release and ingest of the tick itself."""
    cfg = delay_cfg(**FORMS[form])
    arr, _ = market_stream(NC, 100, 30_000)
    jspecs, _ = market_specs(NC)
    n = max(PASS_TICKS)
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    pset = jbase.PolicySet((policy,))
    eng = jengine.Engine(cfg, policies=pset)
    params = pset.params_for(cfg)
    step = jax.jit(lambda s, r, c: eng.step_tick(s, r, c, params))
    pre = jax.jit(lambda s, r, c, t: eng._span_prefix(
        s, r, c, t, params, tick_indexed=True, emit_returns=False,
        phase_limit=4)[0])
    state = jinit_state(cfg, jspecs)
    out = []
    for k in range(n):
        rows, counts = jnp.asarray(ta.rows[k]), jnp.asarray(ta.counts[k])
        if k + 1 in PASS_TICKS:
            t = int(state.t) + cfg.tick_ms
            out.append((t, pre(state, rows, counts, jnp.int32(t))))
        state = step(state, rows, counts)
    return cfg, out


def _skips(pre, out, QC):
    """How many times the parity skip fired: a Level1 slot placed while a
    later slot was still inside the sweep."""
    n = 0
    for c in range(pre.l1.count.shape[0]):
        n_sweep = min(int(pre.l1.count[c]), QC)
        ids = pre.l1.data[c, :n_sweep, tQ.FID].tolist()
        new = range(int(pre.trace.n[c]), int(out.trace.n[c]))
        placed = {int(out.trace.job[c, i]) for i in new
                  if int(out.trace.src[c, i]) == SRC_L1}
        n += sum(1 for i, j in enumerate(ids)
                 if j in placed and i + 1 < n_sweep)
    return n


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_delay_pass_bitwise_equals_jax_run_kind(form, policy):
    cfg, states = _pre_states(form, policy)
    tcfg = port_cfg(cfg)
    jspec, tspec_ = jbase.REGISTRY[policy], tbase.REGISTRY[policy]
    jparams = jbase.default_params(cfg, jspec)
    tparams = port_params(cfg, policy)
    run_kind = jax.jit(lambda s, t: jbase._run_kind(jspec, s, t, jparams,
                                                    cfg))
    seen = dict(placed=0, promoted=0, l1_full=0, run_full=0, skips=0)
    for t, pre in states:
        jout, jwant, jbjob = run_kind(pre, jnp.int32(t))
        tpre = interop.state_from_numpy(jax_leaves(pre), device="cpu")
        tout, twant, tbjob = tbase._run_kind(tspec_, tpre, t, tparams, tcfg)
        assert_leaves_equal(jax_leaves(jout), interop.state_to_numpy(tout))
        np.testing.assert_array_equal(np.asarray(jwant), twant.numpy())
        np.testing.assert_array_equal(np.asarray(jbjob), tbjob.numpy())
        tpre = interop.state_from_numpy(jax_leaves(pre), device="cpu")
        placed = tout.placed_total - tpre.placed_total
        l1_placed = sum(
            int(tout.trace.src[c, i]) == SRC_L1 for c in range(NC)
            for i in range(int(tpre.trace.n[c]), int(tout.trace.n[c])))
        seen["placed"] += int(placed.sum())
        seen["promoted"] += int(tout.l1.count.sum() - tpre.l1.count.sum()
                                + l1_placed)
        seen["l1_full"] += int((tout.drops.queue - tpre.drops.queue).sum())
        seen["run_full"] += int((tout.drops.run_full
                                 - tpre.drops.run_full).sum())
        seen["skips"] += _skips(tpre, tout, tK._sweep_len(tcfg))
    assert seen["placed"] > 0 and seen["run_full"] > 0, seen
    if policy != "delay-patient":  # 30 s of patience: Level1 stays short
        assert seen["promoted"] > 0 and seen["l1_full"] > 0, seen
        if form == "parity":
            assert seen["skips"] > 0, seen


def test_delay_forms_agree_without_the_skip():
    """With parity off the serial and the wave sweep are one function in
    the port, as the reference pins for its pair."""
    cfg, states = _pre_states("wave", "delay-eager")
    params = port_params(cfg, "delay-eager")
    tcfg = port_cfg(cfg)
    for t, pre in states:
        outs = []
        for fn in (tK._delay_wave_local, tK._delay_local):
            tpre = interop.state_from_numpy(jax_leaves(pre), device="cpu")
            outs.append(interop.state_to_numpy(fn(tpre, t, tcfg, params)))
        assert_leaves_equal(*outs)


# --------------------------------------------------------------------------
# whole runs: run_chunks against run_jit, unfused and Pallas-fused
# --------------------------------------------------------------------------

RC, RJOBS, RHORIZON = 12, 80, 40_000
RCHUNKS = [40, 30]  # 70 ticks; the second drains (K = 1)
RUNS = {"parity": (dict(parity=True), "delay"),
        "wave": (dict(), "delay"),
        "serial": (dict(delay_sweep="serial"), "delay"),
        "eager": (dict(parity=True), "delay-eager"),
        "patient": (dict(), "delay-patient")}
FUSED_RUNS = ("parity", "wave")


@pytest.fixture(scope="module")
def jax_delay_runs():
    arr, _ = market_stream(RC, RJOBS, RHORIZON, seed=11)
    jspecs, _ = market_specs(RC)
    n = sum(RCHUNKS)
    out = {}
    for case, (kw, policy) in RUNS.items():
        cfg = delay_cfg(queue_capacity=24, max_running=16, **kw)
        ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
        refs = [("unfused", cfg)]
        if case in FUSED_RUNS:
            refs.append(("fused", dataclasses.replace(cfg, fused="on",
                                                      fused_block=4)))
        for ref, c in refs:
            pset = jbase.PolicySet((policy,))
            eng = jengine.Engine(c, policies=pset)
            out[case, ref] = eng.run_jit()(jinit_state(c, jspecs), ta, n,
                                           params=pset.params_for(c))
    return out


@pytest.fixture(scope="module")
def port_delay_runs():
    _, arr = market_stream(RC, RJOBS, RHORIZON, seed=11)
    _, tspecs = market_specs(RC)
    out = {}
    for case, (kw, policy) in RUNS.items():
        cfg = port_cfg(delay_cfg(queue_capacity=24, max_running=16, **kw))
        parts = tengine.pack_arrivals_chunks(arr, RCHUNKS, cfg.tick_ms)
        assert parts[0].rows.shape[2] != parts[1].rows.shape[2]
        eng = tengine.Engine(cfg, device="cpu",
                             policies=tbase.PolicySet((policy,)))
        out[case] = eng.run_chunks(
            tstate.init_state(cfg, tspecs, device="cpu"), parts)
    return out


@pytest.mark.parametrize("case,ref", [(c, "unfused") for c in sorted(RUNS)]
                         + [(c, "fused") for c in FUSED_RUNS])
def test_port_delay_run_chunks_bitwise_equals_jax(jax_delay_runs,
                                                  port_delay_runs, case,
                                                  ref):
    want, got = jax_delay_runs[case, ref], port_delay_runs[case]
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert ttrace.extract_trace(got) == jextract(want)


def test_port_delay_runs_are_sound(port_delay_runs):
    """Real work, the counters the path moves, conservation, and the
    variants changing the outcome."""
    for case, s in port_delay_runs.items():
        placed = int(s.placed_total.sum())
        assert placed > 0.3 * RC * RJOBS, (case, placed)
        assert int(s.trace.n.sum()) == placed
        assert int(s.wait_jobs.sum()) == int(s.arr_ptr.sum())
        assert float(s.wait_total.sum()) > 0
        ttrace.check_conservation(s)
    runs = port_delay_runs
    assert not torch.equal(runs["parity"].trace.job, runs["eager"].trace.job)
    assert not torch.equal(runs["wave"].wait_total,
                           runs["patient"].wait_total)
    assert int(runs["eager"].l1.count.sum()) > 0


# --------------------------------------------------------------------------
# the reference's fused-kernel policy matrix: its DELAY scenarios without
# the trader (tests/test_kernels.py:86 over tests/test_pipeline.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["delay_parity", "delay_blocked"])
def test_policy_matrix_delay_scenarios_equal_jax(name):
    cfg, arr, jspecs = _tc_scenarios()[name]
    cfg = dataclasses.replace(cfg, record_metrics=False, record_trace=True,
                              max_trace_events=64)  # metrics: ROADMAP A10
    ta = jengine.pack_arrivals_by_tick(arr, TC_TICKS, cfg.tick_ms)
    want = jengine.Engine(cfg).run_jit()(jinit_state(cfg, jspecs), ta,
                                         TC_TICKS)
    fused = jengine.Engine(dataclasses.replace(
        cfg, fused="on", fused_block=1)).run_jit()(
        jinit_state(cfg, jspecs), ta, TC_TICKS)
    tcfg = port_cfg(cfg)
    tspecs = [tspec.uniform_cluster(1, 5)]
    ta_t = tengine.pack_arrivals_by_tick(port_arrivals(arr), TC_TICKS,
                                         tcfg.tick_ms)
    got = tengine.Engine(tcfg, device="cpu").run(
        tstate.init_state(tcfg, tspecs, device="cpu"), ta_t, TC_TICKS)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert_leaves_equal(jax_leaves(fused), interop.state_to_numpy(got))
    assert int(got.placed_total.sum()) > 0
    if name == "delay_blocked":  # the 64-core jobs were promoted
        assert int(got.l1.count.sum()) > 0


# --------------------------------------------------------------------------
# oracle parity: the DELAY scenarios of bench.py:1336-1350
# --------------------------------------------------------------------------

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
ORACLE = {  # name: (workload, queue_capacity, seed, ticks, cores, mem)
    "delay_small": (None, 64, 9, 400, 32, 24_000),
    "delay_heavy": (40.0, 256, 3, 300, 32, 24_000),
    "delay_packed": (40.0, 256, 17, 400, 8, 6_000),
}


@pytest.mark.parametrize("name", sorted(ORACLE))
def test_delay_oracle_scenarios_trace_equal(name):
    lam, qcap, seed, n_ticks, max_cores, max_mem = ORACLE[name]
    cfg = SimConfig(policy=PolicyKind.DELAY, record_trace=True,
                    queue_capacity=qcap, max_running=512, max_arrivals=2048,
                    max_nodes=12, max_ingest_per_tick=128)
    if lam is not None:
        cfg = dataclasses.replace(
            cfg, workload=WorkloadConfig(poisson_lambda_per_min=lam))
    small = load_cluster_json(os.path.join(ASSETS, "cluster_small.json"))
    arr = generate_arrivals(cfg.workload, 1, cfg.max_arrivals,
                            n_ticks * cfg.tick_ms, max_cores, max_mem,
                            seed=seed)
    oracle = Oracle(cfg, [small], arr).run(n_ticks)
    want = oracle_trace_per_cluster(oracle, 1)
    jstate = jengine.Engine(cfg).run_jit()(jinit_state(cfg, [small]), arr,
                                           n_ticks)
    assert jextract(jstate) == want

    tcfg = port_cfg(cfg)
    tsmall = tspec.load_cluster_json(os.path.join(ASSETS,
                                                  "cluster_small.json"))
    ta = tengine.pack_arrivals_by_tick(port_arrivals(arr), n_ticks,
                                       tcfg.tick_ms)
    got = tengine.Engine(tcfg, device="cpu").run(
        tstate.init_state(tcfg, [tsmall], device="cpu"), ta, n_ticks)
    assert ttrace.total_drops(got) == dict.fromkeys(
        ("queue", "msgs", "run_full", "vslot", "carve", "ingest", "failed",
         "narrow"), 0)
    assert ttrace.extract_trace(got) == want
    assert len(want[0]) > 10
