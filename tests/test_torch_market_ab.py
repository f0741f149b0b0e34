"""The port's matcher A/B (multi_cluster_simulator_tpu_torch/tools/
market_ab.py) against the JAX package's tools/market_ab.py, on the CPU.

``run_one`` at 16 clusters for each matcher: every integer of its row and
of its final state bitwise the reference engine's on the same world, the
floats within tests/test_torch_market.py's ``RTOL``/``ATOL`` (bitwise at
this size all the same). The world's copy (``sinkhorn_market_setup``) is
pinned to bench.py's.

The sinkhorn round's repair (ROADMAP C1) lands here: on that world the
round at t = 50 s chose another seller than the reference did, from two
float steps of the round — ``torch.exp`` is not XLA's f32 ``exp``, and
``K.T @ u`` summed in torch's order, not XLA's. ``xla_exp_f32`` and
``market.trader.XlaGemv`` write the reference's compiled steps out; both
are held against ``jax.jit`` here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from multi_cluster_simulator_tpu.core.engine import Engine as JEngine
from multi_cluster_simulator_tpu.core.state import avg_wait_ms as javg
from multi_cluster_simulator_tpu.core.state import init_state as jinit
from multi_cluster_simulator_tpu.utils.trace import total_drops as jdrops
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core.engine import Engine
from multi_cluster_simulator_tpu_torch.core.state import init_state
from multi_cluster_simulator_tpu_torch.market.trader import XlaGemv
from multi_cluster_simulator_tpu_torch.ops.floats import xla_exp_f32
from multi_cluster_simulator_tpu_torch.tools import market_ab
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import jax_leaves, port_cfg
from tests.test_torch_market import assert_decisions_equal

C = 16
MATCHERS = ("greedy", "sinkhorn", "cvx")


def jax_row(matching: str):
    """tools/market_ab.py ``run_one``'s row at C clusters, from one run of
    the reference engine (its timing keys left out), and its final
    state's leaves."""
    cfg, specs, arrivals, n_ticks = bench.sinkhorn_market_setup(
        C, market_ab.JOBS_PER, market_ab.HORIZON_MS, matching=matching)
    eng = JEngine(cfg)
    out = jax.jit(eng.run, static_argnums=(2,))(jinit(cfg, specs),
                                                arrivals, n_ticks)
    placed = int(np.asarray(out.placed_total).sum())
    waits = np.asarray(javg(out))
    row = {"matching": matching, "clusters": C, "placed": placed,
           "of": C * market_ab.JOBS_PER,
           "placed_frac": round(placed / (C * market_ab.JOBS_PER), 4),
           "virtual_nodes_traded": int(
               np.asarray(out.node_active)[:, cfg.max_nodes:].sum()),
           "mean_avg_wait_ms": round(float(waits.mean()), 1),
           "p95_avg_wait_ms": round(float(np.percentile(waits, 95)), 1),
           "drops": jdrops(out), "market": eng.market_provenance()}
    return row, jax_leaves(out)


def test_sinkhorn_market_setup_copy_equals_bench():
    for quick in (False, True):
        for matching in MATCHERS:
            jc, js, ja, jn = bench.sinkhorn_market_setup(
                24, 40, 120_000, matching=matching, quick=quick)
            tc, ts, ta, tn = market_ab.sinkhorn_market_setup(
                24, 40, 120_000, matching=matching, quick=quick)
            assert port_cfg(jc) == tc and jn == tn
            assert [dataclasses.astuple(s) for s in js] == \
                [dataclasses.astuple(s) for s in ts]
            for f in dataclasses.fields(ta):
                np.testing.assert_array_equal(
                    np.asarray(getattr(ja, f.name)), getattr(ta, f.name))


@pytest.mark.parametrize("matching", MATCHERS)
def test_run_one_equals_jax(matching):
    want, want_state = jax_row(matching)
    got = market_ab.run_one(matching, C, device="cpu", runs=1, warmups=0)
    got_state = interop.to_numpy(got["final"])
    assert got["device"] == "cpu" and got["timing"] == "min-of-1"
    for k, v in want.items():
        assert got[k] == v, k
    assert_decisions_equal(want_state, got_state)


def test_sinkhorn_round_at_50s_picks_the_reference_seller():
    """The world where the repair showed: 16 clusters, ticks 0-50 (the
    fifth round picked another seller before the repair)."""
    cfg, specs, arr, _ = bench.sinkhorn_market_setup(
        C, 400, 600_000, matching="sinkhorn")
    want = jax_leaves(jax.jit(JEngine(cfg).run, static_argnums=(2,))(
        jinit(cfg, specs), arr, 50))
    tcfg = port_cfg(cfg)
    tspecs = market_ab.sinkhorn_market_specs(C)
    got = interop.to_numpy(Engine(tcfg, device="cpu").run(
        init_state(tcfg, tspecs, device="cpu"), port_arrivals(arr), 50))
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_xla_exp_f32_is_the_compiled_exp():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-90, 90, 1 << 20),
                        rng.uniform(-2, 2, 1 << 16),
                        [0.0, -0.0, 88.7, -87.4, 100.0, -100.0, 1e-40,
                         -87.35287, 88.72283]]).astype(np.float32)
    x = x[: len(x) // 8 * 8]
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = xla_exp_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("n", [4, 8, 16, 24])
def test_xla_gemv_orders_equal_jit(n):
    """The tiled gemv (``K @ v``: 8 lanes, one chain below 8 columns) and
    the one-chain loop (``K.T @ u`` fused into a loop below 64) against
    ``jax.jit`` on sparse random matrices, as the round's kernel is
    sparse."""
    rng = np.random.default_rng(n)
    for density in (0.2, 0.6, 1.0):
        K = (rng.uniform(0, 20, (n, n))
             * (rng.uniform(size=(n, n)) < density)).astype(np.float32)
        v = rng.uniform(0.01, 2, n).astype(np.float32)
        rows = np.asarray(jax.jit(lambda K, v: K @ v)(K, v))
        cols = np.asarray(jax.jit(lambda K, v: K.T @ v)(K, v))
        Kt = torch.from_numpy(K)
        np.testing.assert_array_equal(
            rows, XlaGemv(Kt, 8 if n >= 8 else 1)(torch.from_numpy(v)).numpy())
        np.testing.assert_array_equal(
            cols, XlaGemv(Kt.T, 1)(torch.from_numpy(v)).numpy())


def test_market_ab_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        market_ab.run_one("greedy", 4)


def test_require_cvx_wins_gate():
    rows = [{"clusters": 4, "matching": "cvx", "placed": 10,
             "mean_avg_wait_ms": 5.0},
            {"clusters": 4, "matching": "sinkhorn", "placed": 11,
             "mean_avg_wait_ms": 5.0}]
    assert market_ab.cvx_wins(rows, [4])
    rows[0]["placed"] = 11
    assert not market_ab.cvx_wins(rows, [4])
    assert market_ab.cvx_wins(rows, [4, 8]) == [
        "8: need both cvx and sinkhorn rows"]
