"""The port's FFD bin-pack path against the JAX package, on the CPU.

Bitwise throughout, ``wait_total`` (f32) included: the ops the path adds
under ``jax.vmap`` (``best_fit_decreasing_order``, ``_bfd_order`` with
both ``ffd_mem_first`` values, ``compact``, ``gather_rows``,
``set_field``); the FFD pass through ``_run_kind`` in its wave and serial
forms on states the JAX engine reached, tight bounds included; the port's
CPU ``fused_prefix`` against the Pallas ``fused_prefix`` in interpret mode
(``fused="on"``); and whole ``run_chunks`` runs over a ``borg_like_stream``
against JAX ``run_jit``, unfused and fused, for parity off and on and for
the ``ffd-memfirst`` variant. Inputs come from numpy seeds.

The one float, ``wait_total``, is held with no tolerance: the serial
forms add in the same order, and the wave form's per-tick sum of integer
deltas is exact on both sides at these sizes (policies/kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.kernels import fused_tick as jfused
from multi_cluster_simulator_tpu.ops import placement as jP
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.policies import base as jbase
from multi_cluster_simulator_tpu.policies import kernels as jK
from multi_cluster_simulator_tpu.utils.trace import extract_trace as jextract
from multi_cluster_simulator_tpu.workload.traces import borg_like_stream
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.kernels import fused_tick as tfused
from multi_cluster_simulator_tpu_torch.ops import placement as tP
from multi_cluster_simulator_tpu_torch.ops import queues as tQ
from multi_cluster_simulator_tpu_torch.policies import base as tbase
from multi_cluster_simulator_tpu_torch.policies import kernels as tK
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from multi_cluster_simulator_tpu_torch.workload import traces as ttraces
from tests.test_torch_engine import (
    assert_leaves_equal, jax_leaves, port_cfg,
)
from tests.test_torch_ops import eq, rand_rows, t_

SEEDS = [0, 1, 2]


def ffd_cfg(**kw):
    """bench_borg4k's FFD config (bench.py:1213) at test scale, the JAX
    class, with the trace on."""
    base = dict(policy=PolicyKind.FFD, parity=False,
                max_placements_per_tick=16, queue_capacity=32,
                max_running=96, max_arrivals=120, max_ingest_per_tick=8,
                max_nodes=5, max_virtual_nodes=0, n_res=2,
                record_trace=True, max_trace_events=512)
    base.update(kw)
    return SimConfig(**base)


def borg_specs(n_clusters):
    return ([uniform_cluster(c + 1, 5) for c in range(n_clusters)],
            [tspec.uniform_cluster(c + 1, 5) for c in range(n_clusters)])


def borg(n_clusters, jobs, horizon_ms, seed=19):
    """The Borg-like stream from the JAX package and from the port's copy
    (tests/test_torch_copies.py pins them equal)."""
    args = dict(max_cores=32, max_mem=24_000, seed=seed)
    return (borg_like_stream(n_clusters, jobs, horizon_ms, **args),
            ttraces.borg_like_stream(n_clusters, jobs, horizon_ms, **args))


def port_params(cfg, name):
    """The port's PolicyParams for registered policy ``name``, on the CPU."""
    return tbase.default_params(port_cfg(cfg), tbase.REGISTRY[name])


# --------------------------------------------------------------------------
# the ops, under jax.vmap
# --------------------------------------------------------------------------

C, QCAP = 24, 12


def rand_ffd_queue(rng, cap=QCAP):
    """A queue batch whose sort keys tie often (few distinct cores/mem)."""
    count = rng.integers(0, cap + 1, C).astype(np.int32)
    count[:3] = (0, cap, 1)
    data = np.broadcast_to(np.asarray(tQ.F.QUEUE_INVALID, np.int32),
                           (C, cap, tQ.NF)).copy()
    rows = rand_rows(rng, (C, cap))
    rows[..., tQ.FCORES] = rng.integers(0, 4, (C, cap))
    rows[..., tQ.FMEM] = rng.integers(0, 3, (C, cap)) * 1_000
    live = np.arange(cap)[None, :] < count[:, None]
    data[live] = rows[live]
    return data, count


@pytest.mark.parametrize("seed", SEEDS)
def test_best_fit_decreasing_order_equals_jax(seed):
    data, count = rand_ffd_queue(np.random.default_rng(seed))
    valid = np.arange(QCAP)[None, :] < count[:, None]
    cores, mem = data[..., tQ.FCORES], data[..., tQ.FMEM]
    want = jax.vmap(jP.best_fit_decreasing_order)(
        jnp.asarray(cores), jnp.asarray(mem), jnp.asarray(valid))
    eq(want, tP.best_fit_decreasing_order(t_(cores), t_(mem), t_(valid)))


@pytest.mark.parametrize("mem_first", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_bfd_order_equals_jax(seed, mem_first):
    data, count = rand_ffd_queue(np.random.default_rng(10 + seed))
    cfg = ffd_cfg()
    name = "ffd-memfirst" if mem_first else "ffd"
    jparams = jbase.default_params(cfg, jbase.REGISTRY[name])
    want = jax.vmap(lambda d, n: jK._bfd_order(jQ.JobQueue(data=d, count=n),
                                               jparams))(
        jnp.asarray(data), jnp.asarray(count))
    got = tK._bfd_order(tQ.JobQueue(data=t_(data), count=t_(count)),
                        port_params(cfg, name))
    eq(want, got)
    if mem_first == 0:  # params at their default are the plain BFD order
        eq(want, tK._bfd_order(tQ.JobQueue(data=t_(data), count=t_(count)),
                               None))


@pytest.mark.parametrize("cap", [QCAP, 300])  # 300: the argsort branch
@pytest.mark.parametrize("seed", SEEDS)
def test_compact_equals_jax(seed, cap):
    rng = np.random.default_rng(20 + seed)
    data, count = rand_ffd_queue(rng, cap)
    keep = rng.random((C, cap)) < 0.6
    want = jax.vmap(lambda d, n, k: jQ.compact(jQ.JobQueue(data=d, count=n),
                                               k))(
        jnp.asarray(data), jnp.asarray(count), jnp.asarray(keep))
    got = tQ.compact(tQ.JobQueue(data=t_(data), count=t_(count)), t_(keep))
    eq(want.data, got.data)
    eq(want.count, got.count)


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_rows_equals_jax(seed):
    rng = np.random.default_rng(30 + seed)
    data, count = rand_ffd_queue(rng)
    K = 5
    pick = rng.integers(0, QCAP, (C, K))
    sel = (pick[..., None] == np.arange(QCAP)) & (rng.random((C, K, 1)) < 0.8)
    want = jax.vmap(lambda d, n, s: jQ.gather_rows(
        jQ.JobQueue(data=d, count=n), s))(
        jnp.asarray(data), jnp.asarray(count), jnp.asarray(sel))
    eq(want, tQ.gather_rows(tQ.JobQueue(data=t_(data), count=t_(count)),
                            t_(sel)))


@pytest.mark.parametrize("seed", SEEDS)
def test_set_field_equals_jax(seed):
    rng = np.random.default_rng(40 + seed)
    data, count = rand_ffd_queue(rng)
    vals = rng.integers(-50, 50_000, (C, QCAP)).astype(np.int32)
    want = jax.vmap(lambda d, n, v: jQ.set_field(
        jQ.JobQueue(data=d, count=n), "rec_wait", v))(
        jnp.asarray(data), jnp.asarray(count), jnp.asarray(vals))
    q = tQ.JobQueue(data=t_(data), count=t_(count))
    got = tQ.set_field(q, "rec_wait", t_(vals))
    eq(want.data, got.data)
    np.testing.assert_array_equal(q.data.numpy(), data)  # input untouched


# --------------------------------------------------------------------------
# the FFD pass (_run_kind) on states the JAX engine reached
# --------------------------------------------------------------------------

NC = 8
SCENARIOS = {
    # bench_borg4k's bounds on a busy stream: the cap (16) binds
    "borg": dict(cfg=dict(), stream=dict(jobs=120, horizon_ms=40_000),
                 ticks=(4, 12, 25, 38)),
    # tight bounds: run_full, drops.queue and the cap all fire
    "tight": dict(cfg=dict(queue_capacity=8, max_running=6,
                           max_placements_per_tick=3),
                  stream=dict(jobs=60, horizon_ms=20_000, seed=6),
                  ticks=(3, 8, 14, 19)),
}


def _pre_states(name):
    """(t, JAX pre-schedule state) at the scenario's ticks: the JAX engine
    runs the ticks before, then release and ingest of the tick itself."""
    sc = SCENARIOS[name]
    cfg = ffd_cfg(**sc["cfg"])
    arr, _ = borg(NC, **sc["stream"])
    jspecs, _ = borg_specs(NC)
    n = max(sc["ticks"])
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    eng = jengine.Engine(cfg)
    params = eng._default_params
    step = jax.jit(eng.step_tick)
    pre = jax.jit(lambda s, r, c, t: eng._span_prefix(
        s, r, c, t, params, tick_indexed=True, emit_returns=False,
        phase_limit=4)[0])
    state = jinit_state(cfg, jspecs)
    out = []
    for k in range(n):
        rows, counts = jnp.asarray(ta.rows[k]), jnp.asarray(ta.counts[k])
        if k + 1 in sc["ticks"]:
            t = int(state.t) + cfg.tick_ms
            out.append((t, pre(state, rows, counts, jnp.int32(t))))
        state = step(state, rows, counts)
    return cfg, out


@pytest.fixture(scope="module")
def pre_states():
    return {name: _pre_states(name) for name in SCENARIOS}


FORMS = {"wave": dict(), "serial": dict(ffd_sweep="serial"),
         "parity": dict(parity=True)}


@pytest.mark.parametrize("policy", ["ffd", "ffd-memfirst"])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ffd_pass_bitwise_equals_jax_run_kind(pre_states, name, form,
                                              policy):
    cfg, states = pre_states[name]
    cfg = dataclasses.replace(cfg, **FORMS[form])
    jspec, tspec_ = jbase.REGISTRY[policy], tbase.REGISTRY[policy]
    jparams = jbase.default_params(cfg, jspec)
    tparams = port_params(cfg, policy)
    run_kind = jax.jit(lambda s, t: jbase._run_kind(jspec, s, t, jparams,
                                                    cfg))
    seen = dict(placed=0, queue=0, run_full=0, capped=0)
    for t, pre in states:
        jout, jwant, jbjob = run_kind(pre, jnp.int32(t))
        tpre = interop.state_from_numpy(jax_leaves(pre), device="cpu")
        tout, twant, tbjob = tbase._run_kind(tspec_, tpre, t, tparams,
                                             port_cfg(cfg))
        assert_leaves_equal(jax_leaves(jout), interop.state_to_numpy(tout))
        np.testing.assert_array_equal(np.asarray(jwant), twant.numpy())
        np.testing.assert_array_equal(np.asarray(jbjob), tbjob.numpy())
        seen["placed"] += int(tout.placed_total.sum()
                              - tpre.placed_total.sum())
        seen["queue"] += int(tout.drops.queue.sum())
        seen["run_full"] += int(tout.drops.run_full.sum()
                                - tpre.drops.run_full.sum())
        seen["capped"] += int((tpre.l0.count
                               > tK._sweep_len(port_cfg(cfg))).sum())
    assert seen["placed"] > 0, seen
    if name == "tight":
        assert seen["queue"] > 0 and seen["run_full"] > 0, seen
        if form != "parity":
            assert seen["capped"] > 0, seen
    if name == "borg" and form != "parity":
        assert seen["capped"] > 0, seen


def test_serial_and_wave_sweeps_agree_in_the_port(pre_states):
    """The two FFD forms of the port give one outcome (the reference pins
    the same for its pair in tests/test_kernel_equiv.py)."""
    cfg, states = pre_states["tight"]
    params = port_params(cfg, "ffd")
    for t, pre in states:
        outs = []
        for fn in (tK._ffd_wave_local, tK._ffd_local):
            tpre = interop.state_from_numpy(jax_leaves(pre), device="cpu")
            outs.append(interop.state_to_numpy(fn(tpre, t, port_cfg(cfg),
                                                  params)))
        assert_leaves_equal(*outs)


def test_scored_sweep_refuses_a_score_fn(pre_states):
    """The scored picks are ported (tests/test_torch_scored.py); what the
    sweep refuses is a score_fn whose scores are not one f32 per node of
    each cluster."""
    cfg, states = pre_states["tight"]
    t, pre = states[0]
    tpre = interop.state_from_numpy(jax_leaves(pre), device="cpu")
    with pytest.raises(ValueError, match="scores of shape"):
        tK._scored_sweep_local(tpre, t, port_cfg(cfg), None,
                               tK._bfd_order(tpre.l0, None),
                               score_fn=lambda s, j: torch.zeros(3))


# --------------------------------------------------------------------------
# the port's fused_prefix against the Pallas fused_prefix (interpret mode)
# --------------------------------------------------------------------------

FUSED_TICKS = (2, 7, 13)


@pytest.fixture(scope="module")
def jax_fused_ticks():
    """(t, rows, counts, state before, JAX Pallas prefix after) per tick,
    on the tight bounds, for the wave and the serial form."""
    out = {}
    for form in ("wave", "serial"):
        cfg = ffd_cfg(queue_capacity=8, max_running=6,
                      max_placements_per_tick=3, **FORMS[form])
        arr, _ = borg(NC, jobs=60, horizon_ms=20_000, seed=6)
        jspecs, _ = borg_specs(NC)
        n = max(FUSED_TICKS)
        ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
        eng = jengine.Engine(cfg)
        eng_f = jengine.Engine(dataclasses.replace(cfg, fused="on",
                                                   fused_block=4))
        params = eng._default_params
        step = jax.jit(eng.step_tick)
        fused = jax.jit(lambda s, r, c, t: jfused.fused_prefix(
            eng_f, s, r, c, t, params, True, emit_returns=False)[0])
        state = jinit_state(cfg, jspecs)
        ticks = []
        for k in range(n):
            rows, counts = jnp.asarray(ta.rows[k]), jnp.asarray(ta.counts[k])
            if k + 1 in FUSED_TICKS:
                t = int(state.t) + cfg.tick_ms
                ticks.append((t, ta.rows[k], ta.counts[k], state,
                              fused(state, rows, counts, jnp.int32(t))))
            state = step(state, rows, counts)
        out[form] = (cfg, ticks)
    return out


@pytest.mark.parametrize("i", range(len(FUSED_TICKS)))
@pytest.mark.parametrize("form", ["wave", "serial"])
def test_fused_prefix_bitwise_equals_jax_pallas(jax_fused_ticks, form, i):
    cfg, ticks = jax_fused_ticks[form]
    t, rows, counts, before, want = ticks[i]
    eng = tengine.Engine(port_cfg(cfg), device="cpu")
    state = interop.state_from_numpy(jax_leaves(before), device="cpu")
    tfused.reset_launches()
    params = eng._default_params
    out = tfused.fused_prefix(eng, state, torch.from_numpy(rows.copy()),
                              torch.from_numpy(counts.copy()), t, params,
                              tfused.host_params(eng, params))[0]
    assert out is state, "the prefix updates the state in place"
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(out))
    assert not any(tfused.launch_counts().values())


def test_ffd_provenance_names_its_kernel():
    eng = tengine.Engine(port_cfg(ffd_cfg()), device="cpu")
    prov = tfused.provenance(eng)
    assert prov["kernel"] == "fused_prefix_ffd" and prov["schedule"] == "ffd"
    assert prov["source"].endswith("csrc/fused_prefix_ffd.cu")
    assert [k.name for k in tfused.KERNELS.values()][:2] == [
        "fused_prefix_fifo", "fused_prefix_ffd"]
    mf = tengine.Engine(port_cfg(ffd_cfg()), device="cpu",
                        policies=tbase.PolicySet(("ffd-memfirst",)))
    host = tfused.host_params(mf, port_params(ffd_cfg(), "ffd-memfirst"))
    assert host["ffd_mem_first"] == 1
    assert host["kernel"] is tfused.KERNELS["fused_prefix_ffd"]


# --------------------------------------------------------------------------
# whole runs: run_chunks against run_jit, unfused and Pallas-fused
# --------------------------------------------------------------------------

RC, RJOBS, RHORIZON = 16, 120, 60_000
RCHUNKS = [60, 40]  # 100 ticks; the two chunks bucket to different K
RUNS = {"wave": (dict(), "ffd"), "parity": (dict(parity=True), "ffd"),
        "memfirst": (dict(), "ffd-memfirst")}


@pytest.fixture(scope="module")
def jax_ffd_runs():
    arr, _ = borg(RC, RJOBS, RHORIZON)
    jspecs, _ = borg_specs(RC)
    n = sum(RCHUNKS)
    out = {}
    for case, (kw, policy) in RUNS.items():
        cfg = ffd_cfg(**kw)
        ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
        for ref, c in (("unfused", cfg),
                       ("fused", dataclasses.replace(cfg, fused="on",
                                                     fused_block=8))):
            pset = jbase.PolicySet((policy,))
            eng = jengine.Engine(c, policies=pset)
            out[case, ref] = eng.run_jit()(jinit_state(c, jspecs), ta, n,
                                           params=pset.params_for(c))
    return out


@pytest.fixture(scope="module")
def port_ffd_runs():
    _, arr = borg(RC, RJOBS, RHORIZON)
    _, tspecs = borg_specs(RC)
    out = {}
    for case, (kw, policy) in RUNS.items():
        cfg = port_cfg(ffd_cfg(**kw))
        parts = tengine.pack_arrivals_chunks(arr, RCHUNKS, cfg.tick_ms)
        assert parts[0].rows.shape[2] != parts[1].rows.shape[2]
        eng = tengine.Engine(cfg, device="cpu",
                             policies=tbase.PolicySet((policy,)))
        out[case] = eng.run_chunks(
            tstate.init_state(cfg, tspecs, device="cpu"), parts)
    return out


@pytest.mark.parametrize("ref", ["unfused", "fused"])
@pytest.mark.parametrize("case", sorted(RUNS))
def test_port_ffd_run_chunks_bitwise_equals_jax(jax_ffd_runs, port_ffd_runs,
                                                case, ref):
    want, got = jax_ffd_runs[case, ref], port_ffd_runs[case]
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert ttrace.extract_trace(got) == jextract(want)


def test_port_ffd_runs_are_sound(port_ffd_runs):
    """Real work, the counters the path moves, and conservation on the
    port's own output; parity (whole-queue sweep) places at least as many
    as the capped sweep, and the variant changes the outcome."""
    for case, s in port_ffd_runs.items():
        placed = int(s.placed_total.sum())
        assert placed > 0.5 * RC * RJOBS, (case, placed)
        assert int(s.trace.n.sum()) == placed
        assert int(s.wait_jobs.sum()) == int(s.arr_ptr.sum())
        assert int(s.jobs_in_queue.sum()) == int(
            s.arr_ptr.sum()) - placed
        assert float(s.wait_total.sum()) > 0
        ttrace.check_conservation(s)
    wave, memfirst = port_ffd_runs["wave"], port_ffd_runs["memfirst"]
    assert not torch.equal(wave.trace.job, memfirst.trace.job)


def test_ffd_launch_refuses_a_queue_past_the_kernel_limit():
    """Above the kernel's static Level0 limit the wrapper raises before it
    builds or launches anything; it never hands the work to the plain
    version."""
    cap = tfused.MAX_QUEUE + 1
    cfg = port_cfg(ffd_cfg(queue_capacity=cap, record_trace=False))
    _, tspecs = borg_specs(2)
    state = tstate.init_state(cfg, tspecs, device="cpu")
    rows = torch.full((2, 1, tQ.NF), -1, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds the kernel's limit"):
        tfused._launch_ffd(cfg, state, rows, counts, 1_000,
                           {"ffd_mem_first": 0})
