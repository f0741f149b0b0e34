"""The reference's two borrowing oracle-parity scenarios through the port,
on the CPU: ``fifo_borrowing`` (2 clusters) and ``fifo_borrowing_8c``
(8 clusters, alternately starved and idle) of bench.py:1355-1375, at
their own shapes and ticks, the port in two ragged-K chunks. Every state
leaf must equal the JAX engine's over the same tick-indexed stream, and
the placement trace the pure-Python Go oracle's (oracle/go_semantics.py),
with no drop on any counter and a lent placement in the trace.
"""

import pytest

from multi_cluster_simulator_tpu.core import spec as jspec
from multi_cluster_simulator_tpu.oracle.go_semantics import Oracle
from multi_cluster_simulator_tpu.utils.trace import oracle_trace_per_cluster
from multi_cluster_simulator_tpu.workload.generator import (
    generate_arrivals, silence_clusters,
)
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core.state import SRC_LENT
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.test_parity import assert_stats_equal
from tests.test_torch_borrow import NO_DROPS, SCENARIO_CFG, run_three
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, n_traced


def oracle_scenarios():
    """bench.py:1355-1375: (the specs of both packages, seed, ticks, max
    cores, max mem, the silenced clusters)."""
    borrow = tuple([mod.uniform_cluster(1, 3, cores=16, memory=8_000),
                    mod.uniform_cluster(2, 10)] for mod in (jspec, tspec))

    def eight(mod):
        return [mod.uniform_cluster(c + 1, 3, cores=16, memory=8_000)
                if c % 2 == 0 else mod.uniform_cluster(c + 1, 10)
                for c in range(8)]

    return {"fifo_borrowing": (borrow, 7, 300, 16, 8_000, 1),
            "fifo_borrowing_8c": ((eight(jspec), eight(tspec)), 27, 300, 16,
                                  8_000, slice(1, None, 2))}


@pytest.mark.parametrize("name", ["fifo_borrowing", "fifo_borrowing_8c"])
def test_borrowing_oracle_scenarios(name):
    (specs_j, specs_t), seed, n_ticks, cores, mem, silent = \
        oracle_scenarios()[name]
    cfg = SCENARIO_CFG
    arr = silence_clusters(generate_arrivals(
        cfg.workload, len(specs_j), cfg.max_arrivals, n_ticks * cfg.tick_ms,
        cores, mem, seed=seed), silent)
    want, got = run_three(cfg, specs_j, specs_t, arr, n_ticks,
                          chunks=[170, n_ticks - 170])
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    oracle = Oracle(cfg, list(specs_j), arr).run(n_ticks)
    assert ttrace.extract_trace(got) == oracle_trace_per_cluster(
        oracle, len(specs_j))
    assert ttrace.total_drops(got) == NO_DROPS
    assert_stats_equal(got, oracle, len(specs_j))
    assert n_traced(got, SRC_LENT) > 0, "nobody lent"
    ttrace.check_conservation(got)
