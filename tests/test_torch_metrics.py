"""The port's ``record_metrics`` series (the batch form of the reference's
RunMetrics recorder, pkg/scheduler/metrics.go:11-31) against the JAX
package and the pure-Python Go oracle, on the CPU — tests/test_metrics.py
mirrored: the series equals JAX's bitwise (``avg_wait_ms`` f32 included)
and the oracle's tick by tick (its waits are Python floats, held to the
reference test's rtol of 1e-6); the final sample is the final state's;
without ``record_metrics`` a run returns the bare state; and with the
metrics plane on, the series is unchanged.
"""

import numpy as np
import pytest

from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.oracle.go_semantics import Oracle
from multi_cluster_simulator_tpu.workload.generator import generate_arrivals
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import state as tstate
from tests.test_torch_engine import assert_leaves_equal, jax_leaves
from tests.test_torch_windowed import jax_run, port_run

N_TICKS = 120


def metrics_cfg(policy, **kw):
    """tests/test_metrics.py's config."""
    return SimConfig(policy=policy, record_metrics=True, queue_capacity=64,
                     max_running=512, max_arrivals=2048, max_nodes=5, **kw)


def arrivals(cfg, n_clusters, seed=9):
    return generate_arrivals(cfg.workload, n_clusters, cfg.max_arrivals,
                             N_TICKS * cfg.tick_ms, 32, 24_000, seed=seed)


def oracle_series(cfg, specs, arr):
    """The oracle stepped one tick at a time, read as the engine samples
    after each tick."""
    o = Oracle(cfg, list(specs), arr)
    jq, aw = [], []
    for _ in range(N_TICKS):
        o.tick()
        jq.append([cl.jobs_in_queue for cl in o.clusters])
        aw.append([o.avg_wait(c) for c in range(len(o.clusters))])
    return np.asarray(jq, np.int32), np.asarray(aw, np.float32)


def test_series_equals_jax_and_oracle_delay():
    """tests/test_metrics.py:37: DELAY on two clusters."""
    cfg = metrics_cfg(PolicyKind.DELAY)
    specs = [uniform_cluster(1, 5), uniform_cluster(2, 5)]
    arr = arrivals(cfg, 2)
    want, want_ser = jax_run(cfg, specs, arr, N_TICKS)
    got, ser = port_run(cfg, specs, arr, N_TICKS)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert_leaves_equal(jax_leaves(want_ser), interop.series_to_numpy(ser))
    jq, aw = oracle_series(cfg, specs, arr)
    assert ser.jobs_in_queue.shape == (N_TICKS, 2)
    np.testing.assert_array_equal(ser.jobs_in_queue.numpy(), jq)
    np.testing.assert_allclose(ser.avg_wait_ms.numpy(), aw, rtol=1e-6)
    assert int(ser.jobs_in_queue.max()) > 0 and float(aw.max()) > 0
    np.testing.assert_array_equal(
        ser.t.numpy(), np.arange(1, N_TICKS + 1, dtype=np.int32) * 1000)


def test_series_final_sample_equals_state_fifo():
    """tests/test_metrics.py:56: FIFO on one cluster."""
    cfg = metrics_cfg(PolicyKind.FIFO)
    specs = [uniform_cluster(1, 5)]
    arr = arrivals(cfg, 1)
    want, want_ser = jax_run(cfg, specs, arr, N_TICKS)
    got, ser = port_run(cfg, specs, arr, N_TICKS)
    assert_leaves_equal(jax_leaves(want_ser), interop.series_to_numpy(ser))
    np.testing.assert_array_equal(ser.jobs_in_queue[-1].numpy(),
                                  got.jobs_in_queue.numpy())
    assert int(ser.t[-1]) == int(got.t)


def test_metrics_off_returns_bare_state():
    """tests/test_metrics.py:67."""
    cfg = SimConfig(policy=PolicyKind.DELAY, queue_capacity=64,
                    max_running=512, max_arrivals=2048, max_nodes=5)
    out = port_run(cfg, [uniform_cluster(1, 5)], arrivals(cfg, 1), N_TICKS)
    assert isinstance(out, tstate.SimState)


@pytest.mark.parametrize("policy", [PolicyKind.DELAY, PolicyKind.FIFO])
def test_series_unchanged_with_the_plane_on(policy):
    """The buffer rides the run without touching what it samples: the
    series and the state equal the plane-off run's, and JAX's buffer."""
    cfg = metrics_cfg(policy)
    specs = [uniform_cluster(1, 5), uniform_cluster(2, 5)]
    arr = arrivals(cfg, 2, seed=4)
    off, off_ser = port_run(cfg, specs, arr, N_TICKS)
    got, ser, mb = port_run(cfg, specs, arr, N_TICKS, mbuf=True)
    assert_leaves_equal(interop.state_to_numpy(off),
                        interop.state_to_numpy(got))
    assert_leaves_equal(interop.series_to_numpy(off_ser),
                        interop.series_to_numpy(ser))
    _, _, want_mb = jax_run(cfg, specs, arr, N_TICKS, mbuf=True)
    assert_leaves_equal(jax_leaves(want_mb), interop.metrics_to_numpy(mb))
    assert int(mb.ticks) == N_TICKS

