"""The reference's greedy-market parity scenarios through the port, on the
CPU: tests/test_market.py ``TestMarketParity`` — an overloaded cluster
beside an idle one trading a virtual node, two buyers and one seller
(the one-contract lock and the cooldowns), the sane sizing and carve with
vnode expiry, non-default economics (f32 prices, budget stop, incentives)
and the fast-node policy through the wait time. Every state leaf equals
the JAX engine's (``trader.spent`` included, bitwise), and the placement
trace, node columns, cooldowns and locks equal the Go oracle's
(oracle/go_semantics.py)."""

import numpy as np
import pytest

from multi_cluster_simulator_tpu.core import spec as jspec
from multi_cluster_simulator_tpu.oracle.go_semantics import Oracle
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.conftest import make_arrivals
from tests.test_market import assert_market_state_equal, trader_cfg
from tests.test_torch_borrow import run_three
from tests.test_torch_engine import assert_leaves_equal, jax_leaves


def pair(mod, n_buyers=1):
    """``n_buyers`` overloaded 3-node clusters, then an idle big one."""
    return [mod.uniform_cluster(c + 1, 3, cores=16, memory=8_000)
            for c in range(n_buyers)] + [mod.uniform_cluster(n_buyers + 1,
                                                             10)]


# name -> (trader config changes, buyers, seed, ticks)
SCENARIOS = {
    "trade_creates_virtual_node": ({}, 1, 21, 300),
    "seller_lock_and_cooldowns": ({}, 2, 22, 200),
    "sane_modes_and_expiry": (dict(small_node_sizing="sane",
                                   carve_mode="sane",
                                   expire_virtual_nodes=True), 1, 23, 400),
    "nonzero_economics_bit_parity": (dict(
        max_core_cost=0.25, max_mem_cost=0.001, budget=50_000.0,
        min_core_incentive=0.0001, min_mem_incentive=0.00001), 1, 27, 300),
    "fast_node_policy_via_wait_time": (dict(request_max_wait_ms=20_000.0),
                                       1, 24, 300),
}


class _View:
    """A port state seen through the attribute paths the reference's
    assertion helpers read, as numpy."""

    def __init__(self, state):
        self._s = state

    def __getattr__(self, name):
        v = getattr(self._s, name)
        if hasattr(v, "numpy"):
            return v.numpy()
        return _View(v) if not isinstance(v, (int, float)) else v


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_market_parity_scenarios(name):
    kw, n_buyers, seed, n_ticks = SCENARIOS[name]
    cfg = trader_cfg(lam=60.0, **kw)
    specs_j, specs_t = pair(jspec, n_buyers), pair(tspec, n_buyers)
    arr = make_arrivals(cfg, n_buyers + 1, horizon_ms=n_ticks * 1_000,
                        seed=seed, max_cores=16, max_mem=8_000)
    n = np.asarray(arr.n).copy()
    n[n_buyers] = 0
    arr = arr.replace(n=n)
    want, got = run_three(cfg, specs_j, specs_t, arr, n_ticks,
                          chunks=[n_ticks // 2, n_ticks - n_ticks // 2])
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    oracle = Oracle(cfg, list(specs_j), arr).run(n_ticks)
    assert_market_state_equal(_View(got), oracle)
    assert int(got.trader.next_contract_id.sum()) > len(specs_t), \
        "nobody asked the market"
    np.testing.assert_allclose(got.trader.spent.numpy(),
                               [cl.spent for cl in oracle.clusters],
                               rtol=1e-6)
    ttrace.check_conservation(got)
