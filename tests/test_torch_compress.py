"""The port's event-compressed driver (``Engine.run_compressed``) against
the JAX package's, on the CPU.

The same seeded inputs go through the JAX ``run_compressed`` (under
``jax.jit``) and the port's; the final state is held leaf by leaf,
bitwise, dtypes included, and so are the reconstructed ``MetricSample``
series, the ``LeapStats`` and, with the metrics plane, the harvested
buffer. The port's compressed run is also held against its own dense run
(``run_chunks``). The cases mirror the reference's: tests/test_pipeline.py
:294 (the five leap scenarios), :312 (a ragged-K chunk boundary), :353 (a
run ending on a busy tick), :374 (windowed arrivals refused);
tests/test_faults.py:115 and :159 (churn, with the plane);
tests/test_obs.py:72 (``tap_leap``); tests/test_compact.py:204 (the compact
layout); tests/test_kernels.py:151 and :359 (the fused path: here the
hand-written kernels' host build); tests/test_policies.py:126 and :327
(multi-member sets, gavel and tesserae); tests/test_market_cvx.py:265 (the
cvx market, its floats to the market tests' tolerance). The leap pieces
(the masks, the closed-form accrual, the fingerprint, the next-event
probe, the next completion and cadence, ``tap_leap``) are held against
the reference's on random states, and the leap-size bucket at 2^k and
2^k - 1 ticks.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import (
    FaultConfig, PolicyKind, SimConfig, TraderConfig,
)
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core import state as jst
from multi_cluster_simulator_tpu.core.compact import derive_plan as jplan
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import Arrivals
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.market import trader as jtrader
from multi_cluster_simulator_tpu.obs import device as jD
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.ops import runset as jR
from multi_cluster_simulator_tpu.policies import kernels as jK
from multi_cluster_simulator_tpu.policies.base import PolicySet as JSet
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import compact as CC
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.market import trader as ttrader
from multi_cluster_simulator_tpu_torch.obs import device as tD
from multi_cluster_simulator_tpu_torch.ops import runset as tR
from multi_cluster_simulator_tpu_torch.policies import kernels as tK
from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
from tests.test_faults import _CHURN
from tests.test_faults import _cfg as faults_cfg
from tests.test_faults import _specs as faults_specs
from tests.test_faults import _stream as faults_stream
from tests.test_market_cvx import _matrix_cfg, _matrix_scenario
from tests.test_pipeline import (
    TC_TICKS, TICK_MS, _bursty_arrivals, _cfg, _specs, _tc_arrivals,
    _tc_scenarios,
)
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tests.test_torch_kernel_host import checked, host_kernels  # noqa: F401
from tests.test_torch_market import assert_decisions_equal
from tests.test_torch_obs import port_specs, random_world
from tests.test_torch_ops import rand_rows
from tests.test_torch_trader import _market_cfg, _random_state


def jax_compressed(cfg, specs, ta, n_ticks, mbuf=False, plan=None,
                   policies=None, params=None):
    """The reference's ``run_compressed`` under ``jax.jit``, from a fresh
    state (and buffer). Returns its tuple."""
    eng = jengine.Engine(cfg, policies=policies)
    s0 = jinit_state(cfg, specs, plan=plan)
    mb = jD.metrics_init(jinit_state(cfg, specs)) if mbuf else None
    return jax.jit(eng.run_compressed, static_argnums=(2,))(
        s0, ta, n_ticks, params, mb)


def port_world(cfg, jspecs, arr, plan=False, fault_events=None,
               policies=None):
    """The port's engine and initial state for a JAX config, specs and
    stream (on the compact layout of the derived plan with ``plan``)."""
    tcfg = port_cfg(cfg)
    tspecs = port_specs(jspecs)
    tarr = port_arrivals(arr)
    p = CC.derive_plan(tcfg, tspecs, tarr) if plan else None
    eng = tengine.Engine(tcfg, device="cpu", policies=policies)
    s0 = tstate.init_state(tcfg, tspecs, plan=p, fault_events=fault_events,
                           device="cpu")
    return eng, s0, tarr


def port_compressed(eng, s0, tarr, chunks, mbuf=False, params=None):
    """The port's ``run_compressed`` over ``chunks`` (tick counts), one
    call a chunk, the buffer and the stats carried over. Returns ``(state,
    series or None, executed, leaps, buffer or None)``."""
    parts = tengine.pack_arrivals_chunks(tarr, chunks, eng.cfg.tick_ms)
    mb = tD.metrics_init(s0) if mbuf else None
    executed, leaps, series = 0, 0, []
    state = s0
    for part, n in zip(parts, chunks):
        out = eng.run_compressed(state, part, n, params, mb)
        state, stats = out[0], out[2 if eng.cfg.record_metrics else 1]
        if eng.cfg.record_metrics:
            series.append(out[1])
        executed += int(stats.ticks_executed)
        leaps = leaps + stats.leaps
    ser = None
    if series:
        ser = tstate.MetricSample(**{
            f.name: torch.cat([getattr(x, f.name) for x in series])
            for f in dataclasses.fields(tstate.MetricSample)})
    return state, ser, executed, leaps, mb


def port_dense(eng, s0, tarr, chunks, mbuf=False, params=None):
    """The port's dense ``run_chunks`` over the same chunks."""
    parts = tengine.pack_arrivals_chunks(tarr, chunks, eng.cfg.tick_ms)
    mb = tD.metrics_init(s0) if mbuf else None
    out = eng.run_chunks(s0, parts, params, mb)
    return out if isinstance(out, tuple) else (out,)


def np_of(tree) -> dict:
    return interop.to_numpy(tree)


def assert_mbuf_equal(a: dict, b: dict, leap_hist=True):
    """Two buffers' leaves equal (``leap_hist`` is the driver's own: the
    dense driver takes no leaps)."""
    if not leap_hist:
        a = {k: v for k, v in a.items() if k != ".leap_hist"}
        b = {k: v for k, v in b.items() if k != ".leap_hist"}
    assert_leaves_equal(a, b)


# --------------------------------------------------------------------------
# the leap pieces on random states
# --------------------------------------------------------------------------

def leap_world(seed, C=12):
    """A random DELAY/market state of both packages with queued Level0
    and Level1 rows whose recorded waits lag their clocks, running jobs,
    and a fault plane: the inputs of every leap piece."""
    rng = np.random.default_rng(900 + seed)
    cfg = _market_cfg(faults=FaultConfig(enabled=True), parity=False,
                      max_placements_per_tick=5,
                      trader=TraderConfig(enabled=True,
                                          expire_virtual_nodes=True))
    js, ts = _random_state(rng, C, cfg)
    Qc, S = cfg.queue_capacity, cfg.max_running
    t = 50_000
    queues = {}
    for name in ("l0", "l1"):
        rows = rand_rows(rng, (C, Qc))
        rows[..., jQ.FREC] = rng.integers(
            0, np.maximum(t - rows[..., jQ.FENQ], 1))
        queues[name] = (rows, rng.integers(0, Qc + 1, C).astype(np.int32))
    run = np.asarray(js.run.data).copy()
    active = rng.random((C, S)) < 0.4
    run[..., jR.REND] = rng.integers(t, t + 90_000, (C, S))
    js = js.replace(
        wait_total=jnp.asarray(rng.integers(0, 2**20, C), jnp.float32),
        run=js.run.replace(data=jnp.asarray(run), active=jnp.asarray(active)),
        **{n: jQ.JobQueue(data=jnp.asarray(r), count=jnp.asarray(c))
           for n, (r, c) in queues.items()})
    ts = interop.state_from_numpy(jax_leaves(js), device="cpu")
    return cfg, js, ts, t


@pytest.mark.parametrize("seed", [0, 1])
def test_leap_pieces_equal_jax_on_random_states(seed):
    """``leap_wait_masks`` and ``_leap_local`` for every kind (FFD with
    both tie-breaks), the per-cluster next completion, the fingerprint,
    the next-event time for a DELAY and a FIFO member, and the cadence."""
    cfg, js, ts, t = leap_world(seed)
    tcfg = port_cfg(cfg)
    new_t = t + 37 * cfg.tick_ms
    for name in ("fifo", "delay", "ffd", "ffd-memfirst", "gavel",
                 "tesserae", "rl"):
        jset, tset = JSet((name,)), PolicySet((name,))
        jp = jset.params_for(cfg)
        tp = tset.params_for(tcfg)
        kind = tset.specs[0].kind
        want = jax.jit(jax.vmap(functools.partial(
            jK.leap_wait_masks, kind, cfg=cfg, params=jp),
            in_axes=(jst.STATE_AXES,)))(js)
        got = tK.leap_wait_masks(kind, ts, tcfg, tp)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                          err_msg=name)
        s_want, r_want = jax.jit(jax.vmap(
            functools.partial(jengine._leap_local, cfg=cfg, pset=jset,
                              params=jp),
            in_axes=(jst.STATE_AXES, None, None),
            out_axes=(jst.STATE_AXES, 0)))(js, jnp.int32(new_t), True)
        s_got, r_got = tengine._leap_local(ts, new_t, tcfg, tset, tp,
                                           tset.specs[0])
        assert_leaves_equal(jax_leaves(s_want), np_of(s_got))
        np.testing.assert_array_equal(np.asarray(r_want), r_got.numpy())
        if kind in ("fifo", "delay"):
            ev = jax.jit(functools.partial(
                jengine._next_event_t, cfg=cfg, pset=jset, params=jp))(
                js, jnp.int32(t))
            got_ev = tengine._next_event_t(ts, t, tcfg, tp, tset.specs[0])
            assert int(ev) == int(got_ev), name
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.vmap(jR.next_end_t))(js.run)),
        tR.next_end_t(ts.run).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jengine._quiescence_sig)(js)),
        tengine._quiescence_sig(ts).numpy())
    for tt in (0, 4_999, 5_000, 9_999, 10_000, t):
        assert int(jtrader.next_cadence_t(jnp.int32(tt), cfg.trader)) \
            == ttrader.next_cadence_t(tt, tcfg.trader)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tap_leap_equals_jax_on_random_states(seed):
    """``tap_leap`` on random buffers, cursors and post-leap states, for
    leaps of 0 (the identity), 1, 7, a full ring and past it."""
    js, mb, cur, ts, tmb, tcur = random_world(seed)
    fn = jax.jit(jD.tap_leap, static_argnums=(4,))
    for n_skip in (0, 1, 7, 64, 65, 130):
        t = (1_000 + 37 * seed + n_skip) * TICK_MS
        js2 = js.replace(t=jnp.int32(t))
        ts2 = ts.replace(t=torch.tensor(t, dtype=torch.int32))
        w_mb, w_cur = fn(mb, cur, js2, jnp.int32(n_skip), TICK_MS)
        g_mb, g_cur = tD.tap_leap(tmb, tcur, ts2, n_skip, TICK_MS)
        assert_leaves_equal(jax_leaves(w_mb), np_of(g_mb))
        assert_leaves_equal(jax_leaves(w_cur), np_of(g_cur))


def test_leap_bucket_at_powers_of_two():
    """The bucket of a leap of 2^k - 1, 2^k and 2^k + 1 ticks, for every
    k an int32 holds, equals the reference's floor(log2(f32)) as its CPU
    build computes it (which is not always k at 2^k)."""
    ns = sorted({max(v, 1) for k in range(31)
                 for v in (2**k - 1, 2**k, 2**k + 1) if v < 2**31})
    want = jax.jit(lambda n: jnp.clip(jnp.floor(jnp.log2(jnp.maximum(
        n, 1).astype(jnp.float32))).astype(jnp.int32), 0,
        jst.LEAP_BUCKETS - 1))(jnp.asarray(ns, jnp.int32))
    got = [tD.leap_bucket(n) for n in ns]
    np.testing.assert_array_equal(np.asarray(want), got)


def test_leaps_of_2k_and_2k_minus_1_ticks():
    """Through both drivers: one cluster whose arrivals are spaced so that
    the quiet gaps between them are leaps of exactly 2^k and 2^k - 1
    ticks (each job places on arrival and runs past the horizon, so the
    tick after an arrival is the first quiet one). ``LeapStats`` and the
    buffer's ``leap_hist`` equal the reference's, and the histogram is
    the one those leap sizes give."""
    gaps = [g for k in range(1, 8) for g in (2**k - 1, 2**k)]
    ticks = np.cumsum([0] + [g + 2 for g in gaps])  # arrival tick indices
    n = int(ticks[-1]) + 4
    A = len(ticks)
    cfg = _cfg(max_arrivals=A, max_running=A + 4,
               queue_capacity=A + 4, record_metrics=True)
    arr = _tc_arrivals([(ticks * TICK_MS + 500).tolist()], [[1] * A],
                       [[10**8] * A])
    specs = [uniform_cluster(1, 5)]
    ta = jengine.pack_arrivals_by_tick(arr, n, TICK_MS)
    w_state, w_ser, w_stats, w_mb = jax_compressed(cfg, specs, ta, n,
                                                   mbuf=True)
    eng, s0, tarr = port_world(cfg, specs, arr)
    got = eng.run_compressed(s0, tengine.pack_arrivals_by_tick(
        tarr, n, TICK_MS), n, None, tD.metrics_init(s0))
    assert_leaves_equal(jax_leaves(w_state), np_of(got[0]))
    assert_leaves_equal(jax_leaves(w_ser), np_of(got[1]))
    assert_leaves_equal(jax_leaves(w_stats), np_of(got[2]))
    assert_mbuf_equal(jax_leaves(w_mb), np_of(got[3]))
    expect = np.zeros(jst.LEAP_BUCKETS, np.int32)
    for g in gaps + [n - int(ticks[-1]) - 2]:
        expect[tD.leap_bucket(g)] += 1
    np.testing.assert_array_equal(got[2].leaps.numpy(), expect)
    np.testing.assert_array_equal(got[3].leap_hist.numpy(), expect)


# --------------------------------------------------------------------------
# the drivers, whole runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_tc_scenarios()))
def test_scenarios_equal_jax(name):
    """tests/test_pipeline.py:294 and tests/test_obs.py:72: each of the
    five leap scenarios (DELAY parity, DELAY blocked, DELAY wave with the
    trader, FFD, FIFO with borrowing) through both compressed drivers,
    with the plane and without; the port's compressed run equals its
    dense run, and it leapt."""
    cfg, arr, specs = _tc_scenarios()[name]
    ta = jengine.pack_arrivals_by_tick(arr, TC_TICKS, cfg.tick_ms)
    w_state, w_ser, w_stats, w_mb = jax_compressed(cfg, specs, ta, TC_TICKS,
                                                   mbuf=True)
    eng, s0, tarr = port_world(cfg, specs, arr)
    part = tengine.pack_arrivals_by_tick(tarr, TC_TICKS, cfg.tick_ms)
    got = eng.run_compressed(tstate.clone_state(s0), part, TC_TICKS, None,
                             tD.metrics_init(s0))
    assert_leaves_equal(jax_leaves(w_state), np_of(got[0]))
    assert_leaves_equal(jax_leaves(w_ser), np_of(got[1]))
    assert_leaves_equal(jax_leaves(w_stats), np_of(got[2]))
    assert_mbuf_equal(jax_leaves(w_mb), np_of(got[3]))
    eng.probe_reads = 0
    bare = eng.run_compressed(tstate.clone_state(s0), part, TC_TICKS)
    assert_leaves_equal(np_of(got[0]), np_of(bare[0]))
    assert_leaves_equal(np_of(got[1]), np_of(bare[1]))
    assert_leaves_equal(np_of(got[2]), np_of(bare[2]))
    executed = int(bare[2].ticks_executed)
    assert executed < TC_TICKS
    # one probe read per executed tick without arrivals (a tick with
    # arrivals is never quiet, and never leapt over)
    assert eng.probe_reads == executed - int(part.counts.any(axis=1).sum())
    d_state, d_ser, d_mb = port_dense(eng, s0, tarr, [TC_TICKS], mbuf=True)
    assert_leaves_equal(np_of(d_state), np_of(got[0]))
    assert_leaves_equal(np_of(d_ser), np_of(got[1]))
    assert_mbuf_equal(np_of(d_mb), np_of(got[3]), leap_hist=False)


def test_ragged_k_chunk_boundary():
    """tests/test_pipeline.py:312: compressed over two chunks whose K
    differs (1 and 8), each leaping from its own clock, equals one dense
    JAX run over the whole bucket."""
    C, T, chunks = 3, 60, [30, 30]
    t = np.asarray([[1_500, 2_500, 3_500,
                     40_200, 40_300, 40_350, 40_400, 40_450]] * C, np.int32)
    A = t.shape[1]
    rng = np.random.RandomState(7)
    arr = Arrivals(
        t=t, id=np.arange(C * A, dtype=np.int32).reshape(C, A),
        cores=rng.randint(1, 4, size=(C, A)).astype(np.int32),
        mem=rng.randint(100, 2_000, size=(C, A)).astype(np.int32),
        gpu=np.zeros((C, A), np.int32),
        dur=rng.randint(1_000, 5_000, size=(C, A)).astype(np.int32),
        n=np.full((C,), A, np.int32))
    cfg = _cfg()
    ref = jengine.Engine(cfg).run_jit()(
        jinit_state(cfg, _specs(C)),
        jengine.pack_arrivals_by_tick(arr, T, TICK_MS), T)
    eng, s0, tarr = port_world(cfg, _specs(C), arr)
    parts = tengine.pack_arrivals_chunks(tarr, chunks, TICK_MS)
    assert parts[0].rows.shape[2] != parts[1].rows.shape[2]
    got, _, executed, _, _ = port_compressed(eng, s0, tarr, chunks)
    assert_leaves_equal(jax_leaves(ref), np_of(got))
    assert executed < T


@pytest.mark.parametrize("n_ticks", [5, 6, 7])
def test_run_ending_on_busy_tick(n_ticks):
    """tests/test_pipeline.py:353: a horizon ending on a busy tick (a
    placement rotates a successor with a stale rec_wait into the processed
    set) equals both JAX drivers: the accrual is gated by the vote."""
    cfg = SimConfig(policy=PolicyKind.DELAY, parity=True, n_res=2,
                    queue_capacity=16, max_running=32, max_arrivals=6,
                    max_ingest_per_tick=8, max_nodes=5, max_virtual_nodes=0)
    arr = _tc_arrivals([[500, 600, 700, 800, 900, 1_000]],
                       [[8, 8, 8, 8, 2, 2]], [[30_000] * 6])
    specs = [uniform_cluster(1, 5)]
    ta = jengine.pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)
    ref = jengine.Engine(cfg).run_jit()(jinit_state(cfg, specs), ta,
                                        n_ticks)
    w_state, w_stats = jax_compressed(cfg, specs, ta, n_ticks)
    eng, s0, tarr = port_world(cfg, specs, arr)
    got, stats = eng.run_compressed(
        s0, tengine.pack_arrivals_by_tick(tarr, n_ticks, cfg.tick_ms),
        n_ticks)
    assert_leaves_equal(jax_leaves(ref), np_of(got))
    assert_leaves_equal(jax_leaves(w_state), np_of(got))
    assert_leaves_equal(jax_leaves(w_stats), np_of(stats))


def test_windowed_arrivals_refused_and_empty_run():
    """tests/test_pipeline.py:374: a windowed ``Arrivals`` stream is
    refused by name, and a chunk too short for the run too; a run of no
    ticks returns the state as it was, zero stats and an empty series."""
    cfg = _cfg(record_metrics=True)
    eng, s0, tarr = port_world(cfg, _specs(1), _bursty_arrivals(1))
    with pytest.raises(ValueError, match="TickArrivals"):
        eng.run_compressed(s0, tarr, 20)
    part = tengine.pack_arrivals_by_tick(tarr, 10, TICK_MS)
    with pytest.raises(ValueError, match="covers 10 ticks"):
        eng.run_compressed(s0, part, 11)
    before = np_of(s0)
    state, series, stats = eng.run_compressed(s0, part, 0)
    assert_leaves_equal(before, np_of(state))
    assert series.t.shape == (0,) and series.avg_wait_ms.shape == (0, 1)
    assert int(stats.ticks_executed) == 0 and int(stats.leaps.sum()) == 0


def test_faults_under_compression():
    """tests/test_faults.py:115: generative churn at 8 clusters over 80
    ticks, compressed (the leap bound folds in the fault events) on the
    wide and the compact layout and over ragged chunks [33, 29, 18], each
    equal to the dense JAX run."""
    C, T = 8, 80
    cfg = faults_cfg(C, faults=_CHURN)
    specs = faults_specs(C)
    arr = faults_stream(C)
    ref = jengine.Engine(cfg).run_jit()(
        jinit_state(cfg, specs),
        jengine.pack_arrivals_by_tick(arr, T, TICK_MS), T)
    assert int(np.asarray(ref.faults.kills).sum()) > 0
    want = jax_leaves(ref)
    _, w_stats = jax_compressed(cfg, specs,
                                jengine.pack_arrivals_by_tick(arr, T, TICK_MS),
                                T)
    eng, s0, tarr = port_world(cfg, specs, arr)
    got, _, executed, leaps, _ = port_compressed(eng, s0, tarr, [T])
    assert_leaves_equal(want, np_of(got))
    assert executed == int(w_stats.ticks_executed)
    np.testing.assert_array_equal(np.asarray(w_stats.leaps), leaps.numpy())
    eng, s0, tarr = port_world(cfg, specs, arr, plan=True)
    got, _, _, _, _ = port_compressed(eng, s0, tarr, [T])
    assert int(got.run.ovf.sum()) == 0
    assert_leaves_equal(want, np_of(CC.to_wide(got)))
    eng, s0, tarr = port_world(cfg, specs, arr)
    got, _, _, _, _ = port_compressed(eng, s0, tarr, [33, 29, T - 62])
    assert_leaves_equal(want, np_of(got))


def test_fault_counters_ride_the_buffer_compressed():
    """tests/test_faults.py:159: churn at 4 clusters with the plane; the
    compressed buffer equals the reference's compressed buffer and the
    port's dense one (but for the leap histogram), its fault totals the
    state's."""
    C, T = 4, 80
    cfg = faults_cfg(C, faults=_CHURN)
    specs = faults_specs(C)
    arr = faults_stream(C)
    ta = jengine.pack_arrivals_by_tick(arr, T, TICK_MS)
    w_state, w_stats, w_mb = jax_compressed(cfg, specs, ta, T, mbuf=True)
    eng, s0, tarr = port_world(cfg, specs, arr)
    got, _, _, _, mb = port_compressed(eng, tstate.clone_state(s0), tarr,
                                       [T], mbuf=True)
    assert_leaves_equal(jax_leaves(w_state), np_of(got))
    assert_mbuf_equal(jax_leaves(w_mb), np_of(mb))
    d_state, d_mb = port_dense(eng, s0, tarr, [T], mbuf=True)
    assert_mbuf_equal(np_of(d_mb), np_of(mb), leap_hist=False)
    h = tD.harvest(mb)
    assert h["fault_kills"] == int(got.faults.kills.sum()) > 0
    assert h["node_down_ms"] == int(got.faults.down_ms.sum()) > 0


@pytest.mark.parametrize("name", ["delay_parity", "fifo_borrowing"])
def test_compact_under_compression(name):
    """tests/test_compact.py:204: the compact layout of the derived plan
    under the compressed driver equals the dense wide JAX run (state
    through ``to_wide``, and the series) and the JAX compact compressed
    run."""
    cfg, arr, specs = _tc_scenarios()[name]
    ta = jengine.pack_arrivals_by_tick(arr, TC_TICKS, cfg.tick_ms)
    ref, ref_ser = jengine.Engine(cfg).run_jit()(jinit_state(cfg, specs),
                                                 ta, TC_TICKS)
    w_state, _, _ = jax_compressed(cfg, specs, ta, TC_TICKS,
                                   plan=jplan(cfg, specs, arr))
    eng, s0, tarr = port_world(cfg, specs, arr, plan=True)
    got, ser, executed, _, _ = port_compressed(eng, s0, tarr, [TC_TICKS])
    assert_leaves_equal(jax_leaves(w_state), np_of(got))
    assert_leaves_equal(jax_leaves(ref), np_of(CC.to_wide(got)))
    assert_leaves_equal(jax_leaves(ref_ser), np_of(ser))
    assert executed < TC_TICKS


@pytest.mark.parametrize("plane", [False, True], ids=["bare", "plane"])
def test_fused_path_under_compression(checked, plane):
    """tests/test_kernels.py:151 and :359: the JAX fused engine (its
    Pallas prefix, interpret mode) under compression against the port's
    compressed driver launching the hand-written kernels (their host
    build; each launch held against the plain version in place), DELAY
    parity, with the metrics plane's tap epilogue and ``tap_leap`` on the
    kernels' buffer in ``plane``."""
    cfg, arr, specs = _tc_scenarios()["delay_parity"]
    ta = jengine.pack_arrivals_by_tick(arr, TC_TICKS, cfg.tick_ms)
    want = jax_compressed(dataclasses.replace(cfg, fused="on"), specs, ta,
                          TC_TICKS, mbuf=plane)
    eng, s0, tarr = port_world(cfg, specs, arr)
    got = eng.run_compressed(
        s0, tengine.pack_arrivals_by_tick(tarr, TC_TICKS, cfg.tick_ms),
        TC_TICKS, None, tD.metrics_init(s0) if plane else None)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert_leaves_equal(jax_leaves(w), np_of(g))
    form = "fused_prefix_delay_tap" if plane else "fused_prefix_delay"
    assert checked.launches[form] == int(got[2].ticks_executed) < TC_TICKS


def test_multi_member_set_under_compression():
    """tests/test_policies.py:126: a five-kind set whose ``params.idx``
    selects DELAY, on the compact layout, compressed: equal to the JAX
    set's compressed run and to the port's singleton dense run."""
    from tests.test_policies import ZOO, _arr, _matrix

    cfg, jspecs, _ = _matrix()["delay_parity"]
    arr = _arr(len(jspecs), seed=11)
    n = 180
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    want, w_stats = jax_compressed(cfg, jspecs, ta, n,
                                   plan=jplan(cfg, jspecs, arr), policies=ZOO,
                                   params=ZOO.params_for(cfg, "delay"))
    zoo = PolicySet(ZOO.names)
    eng, s0, tarr = port_world(cfg, jspecs, arr, plan=True, policies=zoo)
    params = zoo.params_for(eng.cfg, "delay")
    got, _, executed, leaps, _ = port_compressed(
        eng, tstate.clone_state(s0), tarr, [n], params=params)
    assert_leaves_equal(jax_leaves(want), np_of(got))
    assert executed == int(w_stats.ticks_executed)
    np.testing.assert_array_equal(np.asarray(w_stats.leaps), leaps.numpy())
    chunked, _, _, _, _ = port_compressed(
        eng, tstate.clone_state(s0), tarr, [100, 80], params=params)
    assert_leaves_equal(np_of(got), np_of(chunked))
    single, s1, _ = port_world(cfg, jspecs, arr, plan=True)
    (dense,) = port_dense(single, s1, tarr, [n])
    assert_leaves_equal(np_of(dense), np_of(got))


@pytest.mark.parametrize("name", ["gavel", "tesserae"])
def test_scored_kinds_under_compression(name):
    """tests/test_policies.py:327: gavel and tesserae over sparse arrivals,
    compressed, equal the JAX compressed run and the port's dense run."""
    from multi_cluster_simulator_tpu.workload.traces import uniform_stream

    cfg = SimConfig(policy=PolicyKind.FFD, parity=True, n_res=2,
                    queue_capacity=32, max_running=32, max_arrivals=30,
                    max_ingest_per_tick=8, max_nodes=5, max_virtual_nodes=0)
    C, n = 4, 220
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    arr = uniform_stream(C, 30, 40_000, max_cores=8, max_mem=6_000,
                         max_dur_ms=20_000, seed=13)
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    want, w_stats = jax_compressed(cfg, specs, ta, n,
                                   policies=JSet((name,)))
    eng, s0, tarr = port_world(cfg, specs, arr, policies=PolicySet((name,)))
    got, _, executed, leaps, _ = port_compressed(
        eng, tstate.clone_state(s0), tarr, [n])
    assert_leaves_equal(jax_leaves(want), np_of(got))
    np.testing.assert_array_equal(np.asarray(w_stats.leaps), leaps.numpy())
    (dense,) = port_dense(eng, s0, tarr, [n])
    assert_leaves_equal(np_of(dense), np_of(got))
    assert executed < n


def test_cvx_market_under_compression():
    """tests/test_market_cvx.py:265: the cvx market (warm-started prices)
    with churn, 8 clusters over 80 ticks, compressed: the leap bound folds
    in the market cadence. Bitwise the port's dense run; against the JAX
    compressed run, decisions bitwise and floats within the market tests'
    tolerance (ROADMAP C1)."""
    C, T = 8, 80
    cfg = _matrix_cfg(faults=_CHURN)
    specs, arr = _matrix_scenario()
    ta = jengine.pack_arrivals_by_tick(arr, T, TICK_MS)
    want, _ = jax_compressed(cfg, specs, ta, T)
    assert int(np.asarray(want.node_active)[:, cfg.max_nodes:].sum()) > 0
    eng, s0, tarr = port_world(cfg, specs, arr)
    got, _, _, _, _ = port_compressed(eng, tstate.clone_state(s0), tarr,
                                      [33, 29, T - 62])
    assert_decisions_equal(jax_leaves(want), np_of(got))
    (dense,) = port_dense(eng, s0, tarr, [T])
    assert_leaves_equal(np_of(dense), np_of(got))
