"""tests/test_fuzz_parity.py ``test_fuzz_trader_market`` through the port,
on the CPU: an overloaded buyer beside an idle seller over four seeds and
both carve modes (seeds the reference picked so that the market trades).
The whole negotiation — request policy, sizing, approval, carve, the
virtual node's placements, seller locks and cooldowns — must give every
state leaf of the JAX engine and the Go oracle's placement trace and
queue statistics."""

import dataclasses

import pytest

from multi_cluster_simulator_tpu.config import (
    PolicyKind, TraderConfig, WorkloadConfig,
)
from multi_cluster_simulator_tpu.core import spec as jspec
from multi_cluster_simulator_tpu.oracle.go_semantics import Oracle
from multi_cluster_simulator_tpu.workload import silence_clusters
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.conftest import make_arrivals
from tests.test_parity import BASE, assert_stats_equal
from tests.test_torch_borrow import NO_DROPS, run_three
from tests.test_torch_engine import assert_leaves_equal, jax_leaves
from tests.test_torch_trader_oracle import pair
from multi_cluster_simulator_tpu.utils.trace import oracle_trace_per_cluster


@pytest.mark.parametrize("seed,lam,carve", [
    (848, 60.0, "asbuilt"),
    (838, 80.0, "asbuilt"),
    (828, 60.0, "sane"),
    (858, 80.0, "sane"),
])
def test_fuzz_trader_market(seed, lam, carve):
    cfg = dataclasses.replace(
        BASE, policy=PolicyKind.DELAY,
        workload=WorkloadConfig(poisson_lambda_per_min=lam),
        queue_capacity=512, max_virtual_nodes=4,
        trader=TraderConfig(enabled=True, carve_mode=carve))
    specs_j, specs_t = pair(jspec), pair(tspec)
    arr = silence_clusters(make_arrivals(cfg, 2, horizon_ms=300 * cfg.tick_ms,
                                         seed=seed, max_cores=16,
                                         max_mem=8_000), 1)
    want, got = run_three(cfg, specs_j, specs_t, arr, 300,
                          chunks=[140, 160])
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    oracle = Oracle(cfg, specs_j, arr).run(300)
    assert any(cl.active[cfg.max_nodes] for cl in oracle.clusters), \
        "the market never traded — fuzz case is vacuous"
    assert bool(got.node_active[:, cfg.max_nodes:].any())
    assert ttrace.extract_trace(got) == oracle_trace_per_cluster(oracle, 2)
    assert ttrace.total_drops(got) == NO_DROPS
    assert_stats_equal(got, oracle, 2)
    ttrace.check_conservation(got)
