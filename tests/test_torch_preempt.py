"""The port's preemption plane (core/preempt.py) on the CPU: the cases of
tests/test_preempt.py, each resumed state also held against the JAX
package's uninterrupted run.

A run cut at any chunk boundary and resumed from its RunCheckpoint (the
remaining chunks re-bucketed from the cut tick, as a resuming driver does)
ends bitwise where the uninterrupted run ends, over the layout x fault
plane matrix, under event compression (the cursors telescoping) and with
the metrics buffer riding the bundle; the async checkpointer's snapshot
survives the next chunk's in-place writes; latest-wins and the worker's
error surface; a torn write keeps the previous file; SIGTERM saves and
exits 75 in a subprocess; generative churn clocks round-trip. Tolerance
is zero. Inputs come from numpy seeds.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import FaultConfig
from multi_cluster_simulator_tpu.core import compact as jCC
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.obs import device as jD
from multi_cluster_simulator_tpu.workload.traces import bursty_stream
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import checkpoint as tck
from multi_cluster_simulator_tpu_torch.core import compact as tCC
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import preempt
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.obs import device as tD
from tests.test_preempt import _CHURN_TRACE, C, CHUNK, T, _cfg, _specs, _stream
from tests.test_torch_compact import port_plan
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tests.test_torch_obs import port_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [CHUNK] * (T // CHUNK)

_JAX_RUNS: dict = {}


def jax_straight(name, cfg, arrivals, plan=None, mbuf=False):
    """JAX's uninterrupted tick-indexed run (kept per name), chunk by
    chunk through one jitted executable, with the buffer when ``mbuf``."""
    if name not in _JAX_RUNS:
        ta = jengine.pack_arrivals_by_tick(arrivals, T, cfg.tick_ms)
        fn = jengine.Engine(cfg).run_jit()
        s = jinit_state(cfg, _specs(), plan=plan,
                        fault_events=_CHURN_TRACE if cfg.faults.enabled
                        and cfg.faults.mode == "trace" else None)
        mb = jD.metrics_init(s) if mbuf else None
        for o in range(0, T, CHUNK):
            ch = jax.tree.map(lambda x, o=o: x[o:o + CHUNK], ta)
            out = fn(s, ch, CHUNK, None, mb) if mbuf else fn(s, ch, CHUNK)
            s, mb = out if mbuf else (out, None)
        _JAX_RUNS[name] = (s, mb)
    return _JAX_RUNS[name]


def state0(tcfg, plan=None):
    trace = tcfg.faults.enabled and tcfg.faults.mode == "trace"
    return tstate.init_state(tcfg, port_specs(_specs()), device="cpu",
                             plan=plan,
                             fault_events=_CHURN_TRACE if trace else None)


def chunks_from(arr, tcfg, start=0):
    """The chunks of ticks ``[start, T)``, bucketed from the cut tick."""
    return tengine.pack_arrivals_chunks(port_arrivals(arr),
                                        SIZES[start // CHUNK:], tcfg.tick_ms,
                                        start=start)


def assert_port_equals_jax(jstate, tstate_):
    assert_leaves_equal(jax_leaves(jstate), interop.state_to_numpy(tstate_))


def assert_same(a, b):
    assert_leaves_equal(interop.state_to_numpy(a), interop.state_to_numpy(b))


# --------------------------------------------------------------------------
# every boundary, compact x faults (tests/test_preempt.py:81)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compact,faults", [
    (False, False), (True, False), (False, True), (True, True),
], ids=["wide", "compact", "faults", "compact+faults"])
def test_resume_every_boundary_bit_identical(tmp_path, compact, faults):
    """Save and load at every chunk boundary, resume on the re-bucketed
    remaining chunks: the final state is the uninterrupted run's and
    JAX's; with the fault plane the churn clocks round-trip before any
    further tick."""
    cfg = _cfg(faults)
    arr = _stream()
    jplan = jCC.derive_plan(cfg, _specs(), arr) if compact else None
    plan = None if jplan is None else port_plan(jplan)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    pdig = preempt.policy_digest_for(tcfg)

    straight = eng.run_chunks(state0(tcfg, plan), chunks_from(arr, tcfg))
    want, _ = jax_straight(f"boundary-{compact}-{faults}", cfg, arr, jplan)
    assert_port_equals_jax(want, straight)
    if faults:
        assert int(straight.faults.kills.sum()) > 0, "churn never engaged"

    for b in range(1, len(SIZES)):
        path = str(tmp_path / f"b{b}.ckpt")
        s = eng.run_chunks(state0(tcfg, plan), chunks_from(arr, tcfg)[:b])
        mid = tstate.clone_state(s)
        preempt.save_run(path, s, meta={"chunk_idx": b,
                                        "dense_ticks": b * CHUNK},
                         cfg=tcfg, plan=plan, policy_digest=pdig,
                         tick_ms=tcfg.tick_ms)
        del s  # the "kill": nothing survives but the file
        rc = preempt.load_run(path, state0(tcfg, plan), cfg=tcfg, plan=plan,
                              policy_digest=pdig)
        assert rc.tick == b * CHUNK and rc.meta["chunk_idx"] == b
        assert rc.meta["ticks_executed"] == b * CHUNK
        if faults:
            assert_leaves_equal(interop.to_numpy(mid.faults),
                                interop.to_numpy(rc.state.faults))
        final = eng.run_chunks(rc.state, chunks_from(arr, tcfg,
                                                     start=b * CHUNK))
        assert_same(tCC.to_wide(straight), tCC.to_wide(final))
        assert_port_equals_jax(want, final)


# --------------------------------------------------------------------------
# a cut inside a quiet stretch, compressed (tests/test_preempt.py:129)
# --------------------------------------------------------------------------

def test_resume_mid_leap_region_compressed(tmp_path):
    """A cut inside a quiescent valley (tick 20): the resumed compressed
    run is bitwise the uninterrupted one and JAX's dense run, and the
    ticks_executed cursor (with the leap histogram) telescopes to the
    uninterrupted total."""
    cfg = _cfg()
    bursts, interval = 2, 30_000
    arr = bursty_stream(C, bursts, 8, interval, 6_000, max_cores=8,
                        max_mem=6_000, max_dur_ms=10_000, seed=5)
    n_ticks = bursts * interval // cfg.tick_ms + 10  # 70
    sizes = [20, 20, 30]
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    tarr = port_arrivals(arr)

    def chunks(start):
        i = [0, 20, 40].index(start)
        return tengine.pack_arrivals_chunks(tarr, sizes[i:], tcfg.tick_ms,
                                            start=start)

    s, executed, stats_all = state0(tcfg), 0, []
    for ch, n in zip(chunks(0), sizes):
        s, stats = eng.run_compressed(s, ch, n)
        executed += int(stats.ticks_executed)
        stats_all.append(stats)
    straight, straight_exec = s, executed
    assert straight_exec < n_ticks, "compression never engaged"
    _, want_hist = preempt.fold_cursors(0, stats_all)

    path = str(tmp_path / "leap.ckpt")
    s, stats = eng.run_compressed(state0(tcfg), chunks(0)[0], 20)
    preempt.save_run(path, s, meta={"chunk_idx": 1, "leap_stats": [stats]},
                     cfg=tcfg, plan=None, tick_ms=tcfg.tick_ms)
    rc = preempt.load_run(path, state0(tcfg), cfg=tcfg, plan=None)
    s, executed, rest = rc.state, int(rc.meta["ticks_executed"]), []
    for ch, n in zip(chunks(20), sizes[1:]):
        s, stats = eng.run_compressed(s, ch, n)
        executed += int(stats.ticks_executed)
        rest.append(stats)
    assert_same(straight, s)
    assert executed == straight_exec, (
        "the resumed ticks_executed cursor does not telescope to the "
        "uninterrupted total")
    assert preempt.fold_cursors(0, rest, rc.meta) == (straight_exec,
                                                     want_hist)
    ta = jengine.pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)
    dense = jengine.Engine(cfg).run_jit()(jinit_state(cfg, _specs()), ta,
                                          n_ticks)
    assert_port_equals_jax(dense, s)


# --------------------------------------------------------------------------
# the metrics buffer rides the bundle (tests/test_preempt.py:206)
# --------------------------------------------------------------------------

def test_obs_metrics_carry_across_resume(tmp_path):
    cfg = _cfg()
    arr = _stream(seed=13)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    s = state0(tcfg)
    s, mb = eng.run_chunks(s, chunks_from(arr, tcfg), None,
                           tD.metrics_init(s))
    straight_h = tD.harvest(mb)

    path = str(tmp_path / "obs.ckpt")
    s = state0(tcfg)
    s, mb = eng.run_chunks(s, chunks_from(arr, tcfg)[:2], None,
                           tD.metrics_init(s))
    preempt.save_run(path, s, mbuf=mb, meta={"chunk_idx": 2}, cfg=tcfg,
                     tick_ms=tcfg.tick_ms)
    rc = preempt.load_run(path, state0(tcfg), cfg=tcfg)
    assert rc.mbuf is not None, "the buffer did not ride the checkpoint"
    assert_leaves_equal(interop.to_numpy(mb), interop.to_numpy(rc.mbuf))
    s, mb = eng.run_chunks(rc.state, chunks_from(arr, tcfg, start=2 * CHUNK),
                           None, rc.mbuf)
    assert tD.harvest(mb) == straight_h
    want, jmb = jax_straight("obs", cfg, arr, mbuf=True)
    assert_port_equals_jax(want, s)
    assert_leaves_equal(jax_leaves(jmb), interop.to_numpy(mb))


# --------------------------------------------------------------------------
# the async checkpointer (tests/test_preempt.py:240, :264)
# --------------------------------------------------------------------------

def test_async_snapshot_survives_in_place_writes(tmp_path):
    """submit() snapshots the tensors, so the next chunk, which advances
    the very same tensors in place, cannot reach the checkpoint."""
    cfg = _cfg()
    arr = _stream(seed=17)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    chunks = chunks_from(arr, tcfg)
    path = str(tmp_path / "async.ckpt")
    ck = preempt.AsyncCheckpointer(path, cfg=tcfg, tick_ms=tcfg.tick_ms)
    s = eng.run_chunks(state0(tcfg), chunks[:2])
    ck.submit(s, meta={"chunk_idx": 2, "dense_ticks": 2 * CHUNK})
    s2 = eng.run_chunks(s, chunks[2:])  # advances s's tensors in place
    assert s2 is s and int(s.t) == T * tcfg.tick_ms
    s.node_free.fill_(-1)
    ck.flush()
    ck.close()
    assert ck.writes == 1
    rc = preempt.load_run(path, state0(tcfg), cfg=tcfg)
    ref = eng.run_chunks(state0(tcfg), chunks[:2])
    assert_same(ref, rc.state)
    assert rc.meta == {"chunk_idx": 2, "ticks_executed": 2 * CHUNK,
                       "leap_hist": [], "tick": 2 * CHUNK}
    final = eng.run_chunks(rc.state, chunks_from(arr, tcfg, start=2 * CHUNK))
    want, _ = jax_straight("async", cfg, arr)
    assert_port_equals_jax(want, final)


def _with_t(s, t):
    return s.replace(t=torch.tensor(t, dtype=torch.int32))


def test_async_latest_wins_and_error_surfaces(tmp_path):
    """A slow disk never queues snapshots without bound (latest wins,
    skipped counted) and a worker failure re-raises at flush."""
    tcfg = port_cfg(_cfg())
    s = state0(tcfg)
    gate = threading.Event()
    wrote = []

    def slow_save(path, state, **kw):
        gate.wait(timeout=30)
        wrote.append(int(state.t))
        preempt.save_run(path, state, **kw)

    path = str(tmp_path / "lw.ckpt")
    ck = preempt.AsyncCheckpointer(path, cfg=tcfg, save_fn=slow_save)
    ck.submit(_with_t(s, 1000))
    ck.submit(_with_t(s, 2000))  # replaces any waiting snapshot
    ck.submit(_with_t(s, 3000))
    gate.set()
    ck.flush()
    assert wrote[-1] == 3000, "the final submit must always be written"
    assert ck.writes + ck.skipped == 3 and ck.skipped >= 1
    ck.close()
    rc = preempt.load_run(path, state0(tcfg), cfg=tcfg)
    want = jinit_state(_cfg(), _specs())
    assert_port_equals_jax(want.replace(t=jax.numpy.int32(3000)), rc.state)

    def broken_save(path, state, **kw):
        raise OSError("disk on fire")

    ck2 = preempt.AsyncCheckpointer(str(tmp_path / "err.ckpt"), cfg=tcfg,
                                    save_fn=broken_save)
    ck2.submit(s)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        ck2.flush()
    ck2.abort()


# --------------------------------------------------------------------------
# torn writes (tests/test_preempt.py:299)
# --------------------------------------------------------------------------

def test_torn_write_preserves_previous_checkpoint(tmp_path, monkeypatch):
    tcfg = port_cfg(_cfg())
    s = state0(tcfg)
    path = str(tmp_path / "torn.ckpt")
    preempt.save_run(path, s, cfg=tcfg)
    with open(path, "rb") as f:
        good = f.read()
    real_write = tck._write

    def dying_write(p, header, payload):
        with open(p + ".tmp", "wb") as f:
            f.write(payload[: max(len(payload) // 2, 1)])
        raise KeyboardInterrupt("kill -9 during serialize")

    monkeypatch.setattr(tck, "_write", dying_write)
    with pytest.raises(KeyboardInterrupt):
        preempt.save_run(path, _with_t(s, 999), cfg=tcfg)
    monkeypatch.setattr(tck, "_write", real_write)
    with open(path, "rb") as f:
        assert f.read() == good, "a torn write corrupted the checkpoint"
    rc = preempt.load_run(path, state0(tcfg), cfg=tcfg)
    assert int(rc.state.t) == 0
    assert_port_equals_jax(jinit_state(_cfg(), _specs()), rc.state)


# --------------------------------------------------------------------------
# SIGTERM (tests/test_preempt.py:330)
# --------------------------------------------------------------------------

def test_preemption_guard_flag_and_save_and_exit(tmp_path):
    """SIGTERM sets the flag, uninstall restores the previous handler, a
    guard off the main thread stays inert, and save_and_exit writes a
    durable checkpoint then raises SystemExit(75)."""
    prev = signal.getsignal(signal.SIGTERM)
    guard = preempt.PreemptionGuard().install()
    try:
        assert guard.installed and not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 2.0
        while not guard.triggered and time.time() < deadline:
            pass  # the handler runs at a bytecode boundary
        assert guard.triggered
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    off = []
    th = threading.Thread(
        target=lambda: off.append(preempt.PreemptionGuard().install()))
    th.start()
    th.join()
    assert not off[0].installed

    tcfg = port_cfg(_cfg())
    path = str(tmp_path / "term.ckpt")
    ck = preempt.AsyncCheckpointer(path, cfg=tcfg)
    with pytest.raises(SystemExit) as e:
        preempt.PreemptionGuard().save_and_exit(ck, state0(tcfg),
                                                meta={"chunk_idx": 3})
    assert e.value.code == preempt.EXIT_PREEMPTED
    rc = preempt.load_run(path, state0(tcfg), cfg=tcfg)
    assert rc.meta["chunk_idx"] == 3


CHILD = """
import os, signal, sys
from multi_cluster_simulator_tpu_torch import PolicyKind, SimConfig
from multi_cluster_simulator_tpu_torch import uniform_cluster
from multi_cluster_simulator_tpu_torch.core import engine as E, preempt
from multi_cluster_simulator_tpu_torch.core.state import init_state
from multi_cluster_simulator_tpu_torch.workload.traces import uniform_stream
cfg = SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                queue_capacity=32, max_running=64, max_arrivals=40,
                max_ingest_per_tick=8, max_nodes=5, max_virtual_nodes=0)
arr = uniform_stream(8, 40, 40_000, max_cores=8, max_mem=6_000,
                     max_dur_ms=12_000, seed=3)
chunks = E.pack_arrivals_chunks(arr, [12] * 4, cfg.tick_ms)
eng = E.Engine(cfg, device="cpu")
s = init_state(cfg, [uniform_cluster(c + 1, 5) for c in range(8)],
               device="cpu")
ck = preempt.AsyncCheckpointer(sys.argv[1], cfg=cfg, tick_ms=cfg.tick_ms)
with preempt.PreemptionGuard() as guard:
    for i, ch in enumerate(chunks):
        s = eng.run_chunks(s, [ch])
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)  # the scheduler's notice
        if guard.triggered:
            guard.save_and_exit(ck, s, meta={"chunk_idx": i + 1,
                                             "dense_ticks": 12 * (i + 1)})
        ck.submit(s, meta={"chunk_idx": i + 1, "dense_ticks": 12 * (i + 1)})
ck.close()
print("finished without a signal")
"""


def test_sigterm_child_saves_and_exits_75(tmp_path):
    """A child driving the chunks under the guard gets SIGTERM after its
    second chunk: it saves at that boundary, prints the ``# preempted:``
    line and exits 75; the parent resumes the file to the uninterrupted
    run's state and JAX's."""
    path = str(tmp_path / "child.ckpt")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", CHILD, path], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == preempt.EXIT_PREEMPTED, out.stderr[-2000:]
    assert f"# preempted: checkpoint saved at t={2 * CHUNK * 1000} ms" in \
        out.stderr
    cfg = _cfg()
    tcfg = port_cfg(cfg)
    assert tck.peek_checkpoint_t(path) == 2 * CHUNK * tcfg.tick_ms
    # the child's config is _cfg() written with the port's classes
    rc = preempt.load_run(path, state0(tcfg), cfg=tcfg)
    assert rc.meta["chunk_idx"] == 2 and rc.tick == 2 * CHUNK
    final = tengine.Engine(tcfg, device="cpu").run_chunks(
        rc.state, chunks_from(_stream(), tcfg, start=rc.tick))
    want, _ = jax_straight("boundary-False-False", cfg, _stream())
    assert_port_equals_jax(want, final)


# --------------------------------------------------------------------------
# generative churn clocks (tests/test_preempt.py:358)
# --------------------------------------------------------------------------

def test_generative_churn_clocks_roundtrip(tmp_path):
    cfg = dataclasses.replace(_cfg(), faults=FaultConfig(
        enabled=True, mode="generative", mttf_ms=15_000, mttr_ms=3_000,
        seed=21, max_retries=8))
    arr = _stream(seed=23)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    straight = eng.run_chunks(state0(tcfg), chunks_from(arr, tcfg))
    assert int(straight.faults.kills.sum()) > 0

    path = str(tmp_path / "gen.ckpt")
    s = eng.run_chunks(state0(tcfg), chunks_from(arr, tcfg)[:1])
    preempt.save_run(path, s, cfg=tcfg, tick_ms=tcfg.tick_ms)
    rc = preempt.load_run(path, state0(tcfg), cfg=tcfg)
    assert_leaves_equal(interop.to_numpy(s.faults),
                        interop.to_numpy(rc.state.faults))
    final = eng.run_chunks(rc.state, chunks_from(arr, tcfg, start=CHUNK))
    assert_same(straight, final)
    want, _ = jax_straight("generative", cfg, arr)
    assert_port_equals_jax(want, final)
