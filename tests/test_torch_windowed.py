"""The port's windowed ``Arrivals`` ingest against the JAX package, on the
CPU: ``Engine.run`` over an ``Arrivals`` stream (each tick ingests the due
rows at its arrival cursor, at most ``max_ingest_per_tick``; the rest
count into ``drops.ingest``) for FIFO, FFD, DELAY and gavel; single
``tick`` and ``tick_io`` calls; the reference's golden-trace parity
scenarios (tests/test_parity.py:63-120) against JAX and the pure-Python Go
oracle; and BASELINE config 1's first 900-tick chunk with the metrics
plane and ``record_metrics`` (bench.py:839-895). Every leaf is bitwise
(``wait_total`` and ``avg_wait_ms`` included): the tolerance is zero.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from multi_cluster_simulator_tpu.config import (
    PolicyKind, SimConfig, WorkloadConfig,
)
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.spec import (
    load_cluster_json, uniform_cluster,
)
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.obs import device as jD
from multi_cluster_simulator_tpu.oracle.go_semantics import Oracle
from multi_cluster_simulator_tpu.policies.base import PolicySet as JSet
from multi_cluster_simulator_tpu.utils.trace import oracle_trace_per_cluster
from multi_cluster_simulator_tpu.workload.generator import generate_arrivals
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.obs import device as tD
from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import (
    assert_leaves_equal, jax_leaves, port_cfg, stream,
)
from tests.test_torch_obs import assert_mbuf_equal, port_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")


def jax_run(cfg, jspecs, arr, n_ticks, policies=None, mbuf=False):
    eng = jengine.Engine(cfg, policies=policies)
    s0 = jinit_state(cfg, jspecs)
    mb = jD.metrics_init(s0) if mbuf else None
    return jax.jit(eng.run, static_argnums=(2,))(s0, arr, n_ticks, None, mb)


def port_run(cfg, jspecs, arr, n_ticks, policies=None, mbuf=False):
    tcfg = port_cfg(cfg)
    s0 = tstate.init_state(tcfg, port_specs(jspecs), device="cpu")
    mb = tD.metrics_init(s0) if mbuf else None
    eng = tengine.Engine(tcfg, device="cpu", policies=policies)
    return eng.run(s0, port_arrivals(arr), n_ticks, None, mb)


# --------------------------------------------------------------------------
# the windowed ingest of every kind, with the window binding
# --------------------------------------------------------------------------

KINDS = {"fifo": (PolicyKind.FIFO, {}),
         "ffd": (PolicyKind.FFD, dict(max_placements_per_tick=4)),
         "delay": (PolicyKind.DELAY, dict(parity=True)),
         "gavel": (PolicyKind.FFD, dict(max_placements_per_tick=4))}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_windowed_run_defers_and_equals_jax(kind):
    """A stream with bursts beyond ``max_ingest_per_tick`` = 2: the due
    rows past the window slip to later ticks and count into
    ``drops.ingest``, as the reference counts them."""
    policy, kw = KINDS[kind]
    cfg = SimConfig(policy=policy, queue_capacity=16, max_running=16,
                    max_arrivals=40, max_ingest_per_tick=2, n_res=2,
                    max_nodes=5, max_virtual_nodes=0, record_trace=True,
                    max_trace_events=256, **kw)
    arr, _ = stream(n_clusters=6, jobs=40, horizon_ms=30_000, seed=4)
    jspecs = [uniform_cluster(c + 1, 5) for c in range(6)]
    jset = JSet(("gavel",)) if kind == "gavel" else None
    tset = PolicySet(("gavel",)) if kind == "gavel" else None
    want = jax_run(cfg, jspecs, arr, 50, jset)
    got = port_run(cfg, jspecs, arr, 50, tset)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert int(got.drops.ingest.sum()) > 0, "the window never bound"
    assert int(got.placed_total.sum()) > 0


@pytest.mark.parametrize("borrowing", [False, True])
def test_tick_and_tick_io_equal_jax(borrowing):
    """Single ticks over the windowed stream from a state 20 ticks in:
    ``tick`` and ``tick_io`` (its return messages and borrow request)
    equal the reference's."""
    cfg = SimConfig(policy=PolicyKind.FIFO, parity=True, queue_capacity=16,
                    max_running=8, max_arrivals=60, max_ingest_per_tick=4,
                    n_res=2, max_nodes=5, max_virtual_nodes=0,
                    borrowing=borrowing, max_msgs=2)
    arr, _ = stream(n_clusters=4, jobs=60, horizon_ms=40_000, seed=6,
                    max_dur_ms=8_000)
    jspecs = [uniform_cluster(c + 1, 2 if c % 2 else 5) for c in range(4)]
    jeng = jengine.Engine(cfg)
    js = jax.jit(jeng.run, static_argnums=(2,))(jinit_state(cfg, jspecs),
                                                arr, 20)
    tcfg = port_cfg(cfg)
    teng = tengine.Engine(tcfg, device="cpu")
    ts = interop.state_from_numpy(jax_leaves(js), device="cpu")
    tarr = port_arrivals(arr)
    for _ in range(3):
        js = jax.jit(jeng.tick)(js, arr)
        ts = teng.tick(ts, tarr)
        assert_leaves_equal(jax_leaves(js), interop.state_to_numpy(ts))
    want_s, want_io = jax.jit(jeng.tick_io)(js, arr)
    got_s, got_io = teng.tick_io(ts, tarr)
    assert_leaves_equal(jax_leaves(want_s), interop.state_to_numpy(got_s))
    assert_leaves_equal(jax_leaves(want_io), interop.io_to_numpy(got_io))
    assert int(got_s.t) == 24 * cfg.tick_ms


# --------------------------------------------------------------------------
# golden-trace parity: tests/test_parity.py:63-120 through the port
# --------------------------------------------------------------------------

# max_ingest_per_tick=128, as the reference's BASE: the Go client's minute
# bursts would bind a 64-row window (drops.ingest)
BASE = SimConfig(record_trace=True, queue_capacity=64, max_running=512,
                 max_arrivals=2048, max_nodes=12, max_ingest_per_tick=128)
HEAVY = WorkloadConfig(poisson_lambda_per_min=40.0)
PARITY = {  # name: (policy, config changes, specs, ticks, seed, the trace
    #               source that must appear, the least trace length)
    "delay_cluster_small": (PolicyKind.DELAY, {}, "s", 400, 9, None, 11),
    "delay_heavy_load": (PolicyKind.DELAY,
                         dict(workload=HEAVY, queue_capacity=256), "s", 300,
                         3, 0, 0),
    "delay_two_clusters": (PolicyKind.DELAY, {}, "sb", 300, 11, None, 0),
    "fifo_cluster_small": (PolicyKind.FIFO, {}, "s", 400, 9, None, 0),
    "fifo_heavy_wait_queue": (PolicyKind.FIFO,
                              dict(workload=HEAVY, queue_capacity=256), "s",
                              300, 5, 3, 0),
}


def assets(which):
    return [load_cluster_json(os.path.join(
        ASSETS, "cluster_small.json" if w == "s" else "cluster_big.json"))
        for w in which]


def assert_parity(cfg, jspecs, arr, n_ticks):
    """The port's windowed run equals JAX's, leaf by leaf, and its traces
    the Go oracle's, with no drops."""
    want = jax_run(cfg, jspecs, arr, n_ticks)
    got = port_run(cfg, jspecs, arr, n_ticks)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert not any(ttrace.total_drops(got).values())
    oracle = Oracle(cfg, list(jspecs), arr).run(n_ticks)
    want_tr = oracle_trace_per_cluster(oracle, len(jspecs))
    assert ttrace.extract_trace(got) == want_tr
    ttrace.check_conservation(got)
    return oracle


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parity_scenarios_equal_jax_and_oracle(name):
    policy, kw, which, n_ticks, seed, src, min_trace = PARITY[name]
    cfg = dataclasses.replace(BASE, policy=policy, **kw)
    jspecs = assets(which)
    arr = generate_arrivals(cfg.workload, len(jspecs), cfg.max_arrivals,
                            n_ticks * cfg.tick_ms, 32, 24_000, seed=seed)
    oracle = assert_parity(cfg, jspecs, arr, n_ticks)
    assert len(oracle.trace) >= min_trace
    if src is not None:
        assert src in [e[3] for e in oracle.trace]


def test_parity_fifo_borrowing_two_clusters():
    """FIFO + borrowing: an overloaded small cluster borrows from an idle
    big one (the BorrowResources path, server.go:160-248)."""
    cfg = dataclasses.replace(
        BASE, policy=PolicyKind.FIFO, borrowing=True, queue_capacity=256,
        workload=WorkloadConfig(poisson_lambda_per_min=60.0))
    jspecs = [uniform_cluster(1, 3, cores=16, memory=8_000),
              uniform_cluster(2, 10)]
    arr = generate_arrivals(cfg.workload, 2, cfg.max_arrivals,
                            300 * cfg.tick_ms, 16, 8_000, seed=7)
    n = np.asarray(arr.n).copy()
    n[1] = 0  # only cluster 0 receives load
    arr = arr.replace(n=n)
    oracle = assert_parity(cfg, jspecs, arr, 300)
    assert any(e[1] == 1 and e[3] == 4 for e in oracle.trace), \
        "expected lent placements at the lender"


# --------------------------------------------------------------------------
# BASELINE config 1, its first chunk
# --------------------------------------------------------------------------

def config1():
    """bench.py:839-895 bench_fifo_small: FIFO, one cluster_small, queue
    768, running 512, 2,048 arrivals, 5 nodes, n_res 2, the windowed
    ingest, ``record_metrics``."""
    return SimConfig(policy=PolicyKind.FIFO, queue_capacity=768,
                     max_running=512, max_arrivals=2048, max_nodes=5,
                     n_res=2, record_metrics=True)


def test_config1_first_chunk_equals_jax():
    """Its first 900-tick chunk with the metrics plane on: the state, the
    series and the buffer equal JAX's, no bound binds, and the series at
    the 5 s marks equals the committed bench_metrics.json's opening —
    zero throughout, since under FIFO no handler moves ``jobs_in_queue``
    or the wait counters (core/engine.py _ingest_local)."""
    cfg = config1()
    jspecs = [uniform_cluster(1, 5)]
    arr = generate_arrivals(cfg.workload, 1, cfg.max_arrivals,
                            3600 * 1000, 32, 24_000, seed=9)
    want, want_ser, want_mb = jax_run(cfg, jspecs, arr, 900, mbuf=True)
    got, ser, mb = port_run(cfg, jspecs, arr, 900, mbuf=True)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert_leaves_equal(jax_leaves(want_ser), interop.series_to_numpy(ser))
    assert_mbuf_equal(want_mb, mb)
    assert not any(ttrace.total_drops(got).values())
    with open(os.path.join(REPO, "bench_metrics.json")) as f:
        ref = json.load(f)
    at = ser.t.numpy() % 5_000 == 0
    n = int(at.sum())
    assert ser.t.numpy()[at].tolist() == ref["t_ms"][:n]
    assert ser.jobs_in_queue[at, 0].tolist() == ref["jobs_in_queue"][:n]
    assert [round(float(x), 2) for x in ser.avg_wait_ms[at, 0]] == \
        ref["avg_wait_ms"][:n]
    h = tD.harvest(mb)
    assert h["placed"] == int(got.placed_total.sum()) > 0
    assert h["arrived"] == int(got.arr_ptr.sum())
    assert h["queue_depth_max"] > 0
