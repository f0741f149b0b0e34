"""The reference's own borrowing parity tests through the port, on the
CPU: tests/test_parity.py:114 ``test_borrowing_two_clusters`` and
tests/test_fuzz_parity.py:53 ``test_fuzz_borrowing_three_clusters`` on
three seeds. The starved first cluster borrows from the idle others; every
state leaf must equal the JAX engine's over the same tick-indexed stream,
and the placement trace and the queue statistics the Go oracle's.
"""

import dataclasses

import pytest

from multi_cluster_simulator_tpu.config import PolicyKind, WorkloadConfig
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.oracle.go_semantics import Oracle
from multi_cluster_simulator_tpu.utils.trace import oracle_trace_per_cluster
from multi_cluster_simulator_tpu.workload.generator import (
    generate_arrivals, silence_clusters,
)
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.test_parity import BASE, assert_stats_equal
from tests.test_torch_borrow import NO_DROPS, run_three
from tests.test_torch_engine import assert_leaves_equal, jax_leaves


@pytest.mark.parametrize("lam,seed,n_clusters", [
    (60.0, 7, 2),  # tests/test_parity.py:114 test_borrowing_two_clusters
    (45.0, 606, 3), (45.0, 707, 3), (45.0, 808, 3),  # test_fuzz_parity.py:53
])
def test_reference_borrowing_parity_tests(lam, seed, n_clusters):
    """The reference's own borrowing parity tests, through the port: the
    starved first cluster borrows from the idle others."""
    cfg = dataclasses.replace(
        BASE, policy=PolicyKind.FIFO, borrowing=True, queue_capacity=256,
        workload=WorkloadConfig(poisson_lambda_per_min=lam))
    if n_clusters == 2:
        n_ticks = 300
        shapes = [(1, 3, dict(cores=16, memory=8_000)), (2, 10, {})]
    else:
        n_ticks = 150
        shapes = [(1, 2, dict(cores=8, memory=4_000)), (2, 5, {}),
                  (3, 10, {})]
    specs_j = [uniform_cluster(i, n, **kw) for i, n, kw in shapes]
    specs_t = [tspec.uniform_cluster(i, n, **kw) for i, n, kw in shapes]
    arr = silence_clusters(generate_arrivals(
        cfg.workload, n_clusters, cfg.max_arrivals, n_ticks * cfg.tick_ms,
        16, 8_000, seed=seed), slice(1, None))
    want, got = run_three(cfg, specs_j, specs_t, arr, n_ticks)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    oracle = Oracle(cfg, specs_j, arr).run(n_ticks)
    assert ttrace.extract_trace(got) == oracle_trace_per_cluster(
        oracle, n_clusters)
    assert ttrace.total_drops(got) == NO_DROPS
    assert_stats_equal(got, oracle, n_clusters)
    assert any(e[3] == 4 for e in oracle.trace), "no lent placements fired"
    ttrace.check_conservation(got)
