"""The port's device metrics plane (obs/device.py) against the JAX
package's, on the CPU.

Every ported function of ``obs/device.py`` on random states and buffers
under ``jax.jit``; the depth bucket over every depth in [0, 2^24) (XLA's
f32 ``log2`` puts 8192 in bucket 13, not ``bit_length``'s 14); the plane
over tests/test_pipeline.py's ``_tc_scenarios`` (obs-on == obs-off, and
the state, the series and the buffer equal JAX's); the chunked carry; the
harvest; the tap on a terminal churn run; and the invariant that the
cursor at every tick's entry equals the state's counters. Integers and
``wait_total``/``wait_accrued``/``avg_wait_ms`` are bitwise: the
tolerance is zero. Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import FaultConfig
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.obs import device as jD
from multi_cluster_simulator_tpu.parallel.exchange import (
    LocalExchange as JLocal,
)
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.obs import device as tD
from multi_cluster_simulator_tpu_torch.parallel.exchange import LocalExchange
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys
from tests.test_pipeline import (
    CHUNKS, N_TICKS, TC_TICKS, TICK_MS, _bursty_arrivals, _cfg, _specs,
    _tc_scenarios,
)
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg


def port_specs(jspecs):
    """JAX cluster specs as the port's, field by field."""
    return [tspec.ClusterSpec(id=s.id, nodes=tuple(
        tspec.NodeSpec(**dataclasses.asdict(n)) for n in s.nodes))
        for s in jspecs]


def jax_obs_run(cfg, jspecs, ta, n_ticks, mbuf=True):
    """JAX's dense ``run`` under ``jax.jit``, with a fresh buffer."""
    eng = jengine.Engine(cfg)
    s0 = jinit_state(cfg, jspecs)
    mb = jD.metrics_init(s0) if mbuf else None
    return jax.jit(eng.run, static_argnums=(2,))(s0, ta, n_ticks, None, mb)


def port_obs_run(cfg, jspecs, arr, chunks, mbuf=True):
    """The port's ``run_chunks`` over ragged chunks, with a fresh
    buffer."""
    tcfg = port_cfg(cfg)
    s0 = tstate.init_state(tcfg, port_specs(jspecs), device="cpu")
    parts = tengine.pack_arrivals_chunks(port_arrivals(arr), chunks,
                                         tcfg.tick_ms)
    mb = tD.metrics_init(s0) if mbuf else None
    return tengine.Engine(tcfg, device="cpu").run_chunks(s0, parts, None, mb)


def assert_mbuf_equal(jmb, tmb):
    assert_leaves_equal(jax_leaves(jmb), interop.metrics_to_numpy(tmb))


# --------------------------------------------------------------------------
# every function on random states and buffers
# --------------------------------------------------------------------------

def random_world(seed, C=16):
    """A JAX state with random counters and queue counts (a fault-plane
    config, so every fault counter is a leaf), its port twin, and a
    random buffer and cursor in both packages."""
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(_cfg(), faults=FaultConfig(enabled=True))
    js = jinit_state(cfg, _specs(C))

    def ints(lo, hi, shape=(C,)):
        return jnp.asarray(rng.integers(lo, hi, shape), jnp.int32)

    def floats(shape=(C,)):
        # integer-valued and fractional f32, as waits accrue either way
        v = rng.integers(0, 2**24, shape).astype(np.float32)
        v[::3] *= np.float32(0.37)
        return jnp.asarray(v, jnp.float32)

    q = cfg.queue_capacity
    js = js.replace(
        placed_total=ints(0, 2**31 - 1), arr_ptr=ints(0, 2**20),
        wait_total=floats(),
        l0=js.l0.replace(count=ints(0, q + 1)),
        l1=js.l1.replace(count=ints(0, q + 1)),
        ready=js.ready.replace(count=ints(0, q + 1)),
        wait=js.wait.replace(count=ints(0, q + 1)),
        lent=js.lent.replace(count=ints(0, q + 1)),
        drops=js.drops.replace(failed=ints(0, 1000)),
        faults=js.faults.replace(kills=ints(0, 10**6),
                                 requeues=ints(0, 10**6),
                                 down_ms=ints(0, 2**30)))
    mb = jD.metrics_init(js)
    mb = mb.replace(**{k: (floats() if k == "wait_accrued"
                           else ints(-2**31, 2**31 - 1))
                       for k in jD.PC_LEAVES},
                    ticks=jnp.int32(rng.integers(0, 1000)),
                    depth_hist=ints(0, 1000, (1, jD.OBS_DEPTH_BUCKETS)),
                    ring_placed=ints(0, 1000, (1, jD.OBS_RING)),
                    ring_depth=ints(0, 1000, (1, jD.OBS_RING)),
                    ring_t=ints(0, 10**6, (jD.OBS_RING,)))
    cur = jD.TapCursor(placed=ints(0, 2**31 - 1), arrived=ints(0, 2**20),
                       lent=ints(0, q + 1), wait=floats(),
                       ovf=ints(0, 5), kills=ints(0, 10**6),
                       requeues=ints(0, 10**6), fail_drops=ints(0, 1000),
                       down_ms=ints(0, 2**30))
    ts = interop.state_from_numpy(jax_leaves(js), device="cpu")
    tmb = interop.metrics_from_numpy(jax_leaves(mb), device="cpu")
    tcur = tD.TapCursor(**{f.name: torch.from_numpy(
        np.asarray(getattr(cur, f.name)).copy())
        for f in dataclasses.fields(tD.TapCursor)})
    return js, mb, cur, ts, tmb, tcur


def leaves_np(x) -> dict:
    return {k: v.numpy() for k, v in leaves_with_keys(x)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_functions_equal_jax_on_random_states(seed):
    js, mb, cur, ts, tmb, tcur = random_world(seed)
    np.testing.assert_array_equal(np.asarray(jax.jit(jD.queue_depth)(js)),
                                  tD.queue_depth(ts).numpy())
    assert_leaves_equal(jax_leaves(jax.jit(jD.cursor_of)(js)),
                        leaves_np(tD.cursor_of(ts)))
    assert_leaves_equal(jax_leaves(jD.metrics_init(js)),
                        leaves_np(tD.metrics_init(ts)))
    # the per-cluster half: (pc', cur', placed_d, depth)
    want = jax.jit(jD.tap_tick_local)(jD.tap_pc(mb), cur, js)
    got = tD.tap_tick_local(tD.tap_pc(tmb), tcur, ts)
    assert_leaves_equal(jax_leaves(want[0]),  # a dict: keys like ['placed']
                        {f"['{k}']": v.numpy() for k, v in got[0].items()})
    assert_leaves_equal(jax_leaves(want[1]), leaves_np(got[1]))
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # the cross-cluster half, at clocks on either side of the ring's wrap
    for t in (1_000, 63_000, 64_000, 129_000, 7_777_000):
        w = jax.jit(jD.tap_tick_global, static_argnums=(4,))(
            mb, want[2], want[3], jnp.int32(t), 1_000)
        g = tD.tap_tick_global(tmb, got[2], got[3], t, 1_000)
        assert_mbuf_equal(w, g)
        g = tD.tap_tick_global(tmb, got[2], got[3],
                               torch.tensor(t, dtype=torch.int32), 1_000)
        assert_mbuf_equal(w, g)
    # the whole tap (reads the state's clock) and the exchange reduction
    js = js.replace(t=jnp.int32(5_000))
    ts.t.fill_(5_000)
    w_mb, w_cur = jax.jit(jD.tap_tick, static_argnums=(3,))(mb, cur, js,
                                                            1_000)
    g_mb, g_cur = tD.tap_tick(tmb, tcur, ts, 1_000)
    assert_mbuf_equal(w_mb, g_mb)
    assert_leaves_equal(jax_leaves(w_cur), leaves_np(g_cur))
    assert_mbuf_equal(jD.reduce_metrics(w_mb, JLocal()),
                      tD.reduce_metrics(g_mb, LocalExchange()))
    assert jD.harvest(w_mb) == tD.harvest(g_mb)


def test_cursor_owns_its_tensors():
    """The port updates states in place, so a cursor must copy."""
    _, _, _, ts, _, _ = random_world(3)
    cur = tD.cursor_of(ts)
    ts.placed_total.add_(1)
    assert not torch.equal(cur.placed, ts.placed_total)


# --------------------------------------------------------------------------
# the depth bucket, exhaustively
# --------------------------------------------------------------------------

def test_depth_buckets_equal_jax_for_every_depth_below_2_24():
    """Every depth in [0, 2^24), and the int32 extremes, bucket as
    ``jax.jit(_depth_buckets)`` does. XLA's f32 log2 of 8192 rounds just
    below 13, so 8192 lands in bucket 13: ``bit_length`` would be wrong
    there, and only there."""
    f = jax.jit(jD._depth_buckets)
    step = 1 << 22
    for lo in range(0, 1 << 24, step):
        d = np.arange(lo, lo + step, dtype=np.int32)
        np.testing.assert_array_equal(
            np.asarray(f(d)), tD._depth_buckets(torch.from_numpy(d)).numpy(),
            err_msg=f"depths from {lo}")
    odd = np.array([-2**31, -1, 0, 1, 8191, 8192, 8193, 16384, 2**24,
                    2**30, 2**31 - 1], np.int32)
    got = tD._depth_buckets(torch.from_numpy(odd)).numpy()
    np.testing.assert_array_equal(np.asarray(f(odd)), got)
    assert got[odd == 8192][0] == 13
    assert (8192).bit_length() == 14


# --------------------------------------------------------------------------
# the plane over the reference's time-compression scenarios, dense
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_tc_scenarios()))
def test_obs_invisible_and_equal_jax_across_matrix(name):
    """tests/test_obs.py:58 over dense runs, without time compression
    (DELAY parity and blocked, DELAY wave + trader and FIFO + borrowing —
    the non-terminal post-tick tap — and FFD): the port's obs-on state and
    series equal obs-off, and the state, the series and the buffer equal
    JAX's."""
    cfg, arr, jspecs = _tc_scenarios()[name]
    ta = jengine.pack_arrivals_by_tick(arr, TC_TICKS, cfg.tick_ms)
    want, want_ser, want_mb = jax_obs_run(cfg, jspecs, ta, TC_TICKS)
    off, off_ser = port_obs_run(cfg, jspecs, arr, [50, 30], mbuf=False)
    got, ser, mb = port_obs_run(cfg, jspecs, arr, [50, 30])
    assert_leaves_equal(interop.state_to_numpy(off),
                        interop.state_to_numpy(got))
    assert_leaves_equal(interop.series_to_numpy(off_ser),
                        interop.series_to_numpy(ser))
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert_leaves_equal(jax_leaves(want_ser), interop.series_to_numpy(ser))
    assert_mbuf_equal(want_mb, mb)
    h = tD.harvest(mb)
    assert h["ticks"] == TC_TICKS
    assert h["placed"] == int(got.placed_total.sum()) > 0


def test_obs_chunked_carry_matches_single_run():
    """tests/test_obs.py:103: the buffer carried over separate ragged
    chunk calls, the cursor re-derived from the state at each entry,
    equals one run's — the port's and JAX's."""
    cfg, arr, jspecs = _cfg(), _bursty_arrivals(), _specs(3)
    ta = jengine.pack_arrivals_by_tick(arr, N_TICKS, TICK_MS)
    want, want_mb = jax_obs_run(cfg, jspecs, ta, N_TICKS)
    one, one_mb = port_obs_run(cfg, jspecs, arr, [N_TICKS])
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    s = tstate.init_state(tcfg, port_specs(jspecs), device="cpu")
    mb = tD.metrics_init(s)
    for part in tengine.pack_arrivals_chunks(port_arrivals(arr), CHUNKS,
                                             TICK_MS):
        s, mb = eng.run_chunks(s, [part], None, mb)
    for got, got_mb in ((one, one_mb), (s, mb)):
        assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
        assert_mbuf_equal(want_mb, got_mb)


def test_obs_harvest_contents():
    """tests/test_obs.py:159: the harvest ties back to the state."""
    cfg, arr, jspecs = _cfg(), _bursty_arrivals(), _specs(3)
    out, mb = port_obs_run(cfg, jspecs, arr, CHUNKS)
    h = tD.harvest(mb)
    assert h["placed"] == int(out.placed_total.sum())
    assert h["arrived"] == int(out.arr_ptr.sum())
    assert h["ticks"] == N_TICKS
    assert sum(h["depth_hist_log2"]) == N_TICKS * len(jspecs)
    assert h["ring"]["t_ms"][-1] == N_TICKS * TICK_MS
    assert len(h["ring"]["t_ms"]) == min(N_TICKS, tD.OBS_RING)


def test_tap_on_a_terminal_churn_run_equals_post_tick_tap():
    """tests/test_kernels.py:322 through the port: on a terminal prefix
    the tap is the prefix's epilogue (the kernels' tap form on the card,
    its plain version here); with generative churn on, its buffer equals
    the post-tick tap's and JAX's unfused and Pallas-epilogue runs', and
    kills reach it."""
    cfg = dataclasses.replace(_cfg(), faults=dataclasses.replace(
        _cfg().faults, enabled=True, mttf_ms=8_000, mttr_ms=3_000))
    C, n_ticks = 3, 30
    arr = _bursty_arrivals(C)
    ta = jengine.pack_arrivals_by_tick(arr, n_ticks, TICK_MS)
    want, want_mb = jax_obs_run(cfg, _specs(C), ta, n_ticks)
    fused = dataclasses.replace(cfg, fused="on", fused_block=1)
    want_f, want_fmb = jax_obs_run(fused, _specs(C), ta, n_ticks)
    got, mb = port_obs_run(cfg, _specs(C), arr, [20, 10])
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    assert eng.prefix_terminal()
    # the same run with the tap after each tick instead of in the prefix
    s = tstate.init_state(tcfg, port_specs(_specs(C)), device="cpu")
    post, cur = tD.metrics_init(s), tD.cursor_of(s)
    rows = torch.from_numpy(ta.rows[:n_ticks])
    counts = torch.from_numpy(ta.counts[:n_ticks])
    params, host, t = eng._entry(s, None)
    for k in range(n_ticks):
        t += TICK_MS
        s, _ = eng._tick(s, rows[k], counts[k], t, params, host)
        post, cur = tD.tap_tick(post, cur, s, TICK_MS)
    for w in (want, want_f):
        assert_leaves_equal(jax_leaves(w), interop.state_to_numpy(got))
    for w in (want_mb, want_fmb):
        assert_mbuf_equal(w, mb)
        assert_mbuf_equal(w, post)
    assert int(mb.kills.sum()) > 0, "no kill reached the tap"


@pytest.mark.parametrize("name", ["ffd", "fifo_borrowing"])
def test_cursor_equals_entry_counters_at_every_tick(name):
    """The invariant a kernel may rely on instead of loading the cursor:
    at every tick's entry — across a chunk boundary, where the next call
    re-derives it — the carried cursor equals ``cursor_of`` of the state,
    on a terminal prefix (FFD) and with the post-tick tap (borrowing)."""
    cfg, arr, jspecs = _tc_scenarios()[name]
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    s = tstate.init_state(tcfg, port_specs(jspecs), device="cpu")
    mb = tD.metrics_init(s)
    seen = 0
    for part in tengine.pack_arrivals_chunks(port_arrivals(arr), [30, 30],
                                             tcfg.tick_ms):
        params, host, t = eng._entry(s, None)
        obs = eng._obs_entry(s, mb)
        for k in range(part.rows.shape[0]):
            assert_leaves_equal(leaves_np(tD.cursor_of(s)),
                                leaves_np(obs[1]))
            t += tcfg.tick_ms
            s, obs = eng._tick(s, torch.from_numpy(part.rows[k]),
                               torch.from_numpy(part.counts[k]), t, params,
                               host, obs=obs)
            seen += 1
        assert_leaves_equal(leaves_np(tD.cursor_of(s)), leaves_np(obs[1]))
        mb = obs[0]
    assert seen == 60 and int(mb.ticks) == 60
    assert int(mb.placed.sum()) == int(s.placed_total.sum()) > 0


def test_profile_scopes_only_while_profiling(tmp_path):
    """obs/profile.py: the tick's phase ranges appear in a profiler
    session and cost a shared null context outside one; start_trace and
    stop_trace leave a trace file behind."""
    from multi_cluster_simulator_tpu_torch.obs import profile as tprof

    cfg, arr, jspecs = _cfg(), _bursty_arrivals(2), _specs(2)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    parts = tengine.pack_arrivals_chunks(port_arrivals(arr), [3], TICK_MS)
    assert tprof.phase_scope("ingest") is tprof.phase_scope("schedule")
    tprof.start_trace(str(tmp_path))
    eng.run_chunks(tstate.init_state(tcfg, port_specs(jspecs), device="cpu"),
                   parts)
    prof = tprof._SESSION[-1][0]
    tprof.stop_trace()
    names = {e.name for e in prof.events()}
    assert {"tick.fused_prefix", "mcs.dispatch.chunk"} <= names
    assert tprof.trace_artifacts(str(tmp_path))
    assert not tprof.profiling()
