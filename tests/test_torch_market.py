"""The port's fractional matchers (sinkhorn, cvx) against the JAX package,
on the CPU.

The parity rule for these two (ROADMAP, North star): decisions bitwise at
the test sizes — every int and bool leaf (nodes, running set, queues,
drops, locks, cooldowns, contract ids, the trace) — and the float leaves
within ``RTOL``/``ATOL``. Three effects keep the floats from being
bitwise in general: the ``exp`` in the sinkhorn kernel and the order of
the matrix-vector reductions (the tie-break jitter table is bitwise the
reference's, tests/test_torch_faults.py). At the sizes here every float
leaf came out bitwise all the same; the tolerance states what the rule
allows.

Cases: the 2-buyer/2-seller round the greedy protocol loses
(tests/test_sinkhorn.py:69-92, tests/test_market_cvx.py:177-200), the cvx
round with a warm-started price column, rounds on random states, and the
quick market shape (bench.py sinkhorn_market_setup(quick=True)) at 16
clusters over 100 ticks, with and without vnode expiry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_cluster_simulator_tpu.config import MatchKind, TraderConfig
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.market import trader as jtrader
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.parallel.exchange import (
    LocalExchange as JLocalExchange,
)
from multi_cluster_simulator_tpu_torch import config as tconfig
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.market import trader as ttrader
from multi_cluster_simulator_tpu_torch.ops import queues as tQ
from multi_cluster_simulator_tpu_torch.parallel.exchange import LocalExchange
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.test_market_cvx import _matrix_cfg
from tests.test_sinkhorn import market_cfg, two_buyer_two_seller
from tests.test_torch_borrow import jax_runner
from tests.test_torch_delay import market_stream, port_arrivals
from tests.test_torch_engine import jax_leaves, port_cfg
from tests.test_torch_ops import rand_rows, t_
from tests.test_torch_trader import _market_cfg, _random_state

# the float leaves' tolerance (the rule above)
RTOL, ATOL = 1e-5, 1e-6
MATCHERS = [MatchKind.SINKHORN, MatchKind.CVX]


def assert_decisions_equal(want: dict, got: dict):
    """Every int and bool leaf equal; every float leaf within the
    tolerance. Returns the float leaves that were not bitwise."""
    assert set(want) == set(got)
    inexact = []
    for k in want:
        a, b = want[k], got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
            if not np.array_equal(a, b):
                inexact.append(k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    return inexact


def two_by_two_specs():
    return [tspec.uniform_cluster(1, 5), tspec.uniform_cluster(2, 5)] + [
        tspec.ClusterSpec(id=c, nodes=(tspec.NodeSpec(id=1, cores=8,
                                                      memory=8000),))
        for c in (3, 4)]


def run_both(cfg, specs_j, specs_t, arr, n_ticks, chunks=None):
    ta = jengine.pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)
    want = jax_runner(cfg)(jinit_state(cfg, specs_j), ta, n_ticks)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    got = eng.run_chunks(
        tstate.init_state(tcfg, specs_t, device="cpu"),
        tengine.pack_arrivals_chunks(port_arrivals(arr),
                                     chunks or [n_ticks], tcfg.tick_ms))
    assert_decisions_equal(jax_leaves(want), interop.state_to_numpy(got))
    ttrace.check_conservation(got)
    return got


@pytest.mark.parametrize("matching", MATCHERS)
@pytest.mark.parametrize("n_ticks", [25, 30])
def test_two_buyers_two_sellers_equal_jax(matching, n_ticks):
    """Both buyers matched in one round (greedy strands one), each placing
    its physical job and its two overflow jobs on its virtual node."""
    cfg = market_cfg(matching)
    specs_j, arr = two_buyer_two_seller()
    got = run_both(cfg, specs_j, two_by_two_specs(), arr, n_ticks)
    vstart = cfg.max_nodes
    assert int(got.node_active[:, vstart:].sum()) == 2
    assert int(got.node_cap[:, vstart:, 0].sum()) > 0
    if n_ticks == 30:
        assert got.placed_total[2:].tolist() == [3, 3]


def test_cvx_warm_start_price_column_equals_jax():
    """cvx with a price carry-over (``cvx_smooth`` 0.25, the reference's
    parity-matrix config), 8 clusters: each round opens from the last
    one's closing prices, so the column is state (it closes at 0 here,
    with supply to spare: the carry has to match whatever it holds)."""
    from tests.test_market_cvx import _matrix_scenario
    cfg = _matrix_cfg()
    specs_j, arr = _matrix_scenario()
    specs_t = [tspec.uniform_cluster(c + 1, 5) for c in range(4)] + [
        tspec.ClusterSpec(id=c + 1, nodes=(tspec.NodeSpec(
            id=1, cores=8, memory=8000),)) for c in range(4, 8)]
    got = run_both(cfg, specs_j, specs_t, arr, 45, chunks=[20, 25])
    assert int(got.node_active[:, cfg.max_nodes:].sum()) > 0


def test_cvx_settle_rule_holds_at_the_defaults():
    """market/cvx.py's schedule contract, on the port's defaults: the final
    dual step rho/(1+iters) sits under the primal band 1/step with margin
    >= 2."""
    tc = tconfig.TraderConfig()
    assert (1 + tc.cvx_iters) / (tc.cvx_step * tc.cvx_rho) >= 2.0
    assert dataclasses.asdict(tc) == dataclasses.asdict(
        port_cfg(jengine.SimConfig()).trader)


def _fractional_round(matching, seed, C):
    rng = np.random.default_rng(800 + seed)
    t = 50_000
    cfg = _market_cfg(trader=TraderConfig(
        enabled=True, matching=matching, carve_mode="sane",
        cvx_smooth=0.25 * seed))
    js, ts = _random_state(rng, C, cfg)
    price = rng.random(C).astype(np.float32)
    js = js.replace(trader=js.trader.replace(mkt_price=jnp.asarray(price)))
    ts.trader.mkt_price.copy_(t_(price))
    l1 = rand_rows(rng, (C, cfg.queue_capacity), gpu_frac=0.3)
    count = rng.integers(0, 4, C).astype(np.int32)
    js = js.replace(l1=jQ.JobQueue(data=jnp.asarray(l1),
                                   count=jnp.asarray(count)))
    ts = ts.replace(l1=tQ.JobQueue(data=t_(l1), count=t_(count)))
    # the hyperparameters traced, as Engine.run compiles the round (with
    # them as constants XLA multiplies by 1 / eps and orders the products
    # otherwise)
    want = jax.jit(lambda s, p: jtrader._round(s, jnp.int32(t), cfg,
                                               JLocalExchange(), p))(
        js, jengine.Engine(cfg)._default_params)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    got = ttrader.trade_round(ts, t, tcfg, LocalExchange(),
                              eng._default_params, eng.jitter(C))
    inexact = assert_decisions_equal(jax_leaves(want),
                                     interop.state_to_numpy(got))
    attached = int((got.node_active & ~ts.node_active).sum())
    assert attached > 0
    return inexact, attached


@pytest.mark.parametrize("matching", MATCHERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fractional_round_equals_jax(matching, seed):
    """One round at t = 50 s on random states of 24 clusters, the sane
    carve: buyers by both policies, locked sellers, sellers with gpus and
    without; with seed 1 the cvx prices open from a random carried column
    (``cvx_smooth`` 0.25). The sinkhorn round is bitwise, floats too."""
    inexact, _ = _fractional_round(matching, seed, 24)
    assert matching != MatchKind.SINKHORN or inexact == []


@pytest.mark.parametrize("matching", MATCHERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fractional_round_at_73_clusters_equals_jax(matching, seed):
    """The same round at 73 clusters: past the width (72) where the
    reference's compiled jitter table takes the vectorized argument, and
    not a multiple of its 8-wide body, so its tail columns count too."""
    inexact, _ = _fractional_round(matching, seed, 73)
    assert matching != MatchKind.SINKHORN or inexact == []


@pytest.mark.parametrize("C", [16, 64])
def test_sinkhorn_round_at_width_equals_jax(C):
    """The sinkhorn round at 16 and 64 clusters, beside 24 and 73 above
    and 4,096 below: every leaf bitwise, floats included."""
    inexact, _ = _fractional_round(MatchKind.SINKHORN, 0, C)
    assert inexact == []


def test_sinkhorn_round_at_4096_clusters_equals_jax():
    """One sinkhorn round at config 4's width (4,096 clusters) from a
    random state: with the jitter table bitwise and both products in the
    reference engine's order (the tiled gemv, ``K.T @ u`` over K's
    transposed copy), every winner, every attach and every float leaf
    equals the reference's."""
    inexact, attached = _fractional_round(MatchKind.SINKHORN, 0, 4096)
    assert attached > 100
    assert inexact == []


def test_cvx_round_at_4096_clusters_equals_jax():
    """One cvx round at config 4's width from a random state, beside the
    sinkhorn one (ROADMAP C1's check: the ``exp`` and the matrix-vector
    order of the dual ascent at width): every winner and attach equal,
    and every float leaf too (the tolerance allows less; none was
    needed)."""
    inexact, attached = _fractional_round(MatchKind.CVX, 0, 4096)
    assert attached > 10
    assert inexact == []


@pytest.mark.parametrize("expire", [False, True], ids=["keep", "expire"])
@pytest.mark.parametrize("matching", MATCHERS)
def test_quick_market_shape_equals_jax(matching, expire):
    """bench.py sinkhorn_market_setup(quick=True)'s config (DELAY wave,
    sane carve, 5 nodes + 4 virtual slots, gpu-rich even and gpu-poor odd
    clusters) at 16 clusters over 100 ticks: ten market rounds."""
    from bench import sinkhorn_market_setup

    C = 16
    cfg, specs_j, _, _ = sinkhorn_market_setup(C, 200, 600_000,
                                               matching=matching.value,
                                               quick=True)
    if expire:
        cfg = dataclasses.replace(cfg, trader=dataclasses.replace(
            cfg.trader, expire_virtual_nodes=True))
    arr, _ = market_stream(C, 200, 600_000, max_dur_ms=300_000)
    specs_t = [tspec.uniform_cluster(c + 1, 5, gpus=8 if c % 2 == 0 else 0)
               for c in range(C)]
    got = run_both(cfg, specs_j, specs_t, arr, 100, chunks=[60, 40])
    assert int(got.trader.next_contract_id.sum()) > C  # every one asked
    assert int(got.placed_total.sum()) > 0
