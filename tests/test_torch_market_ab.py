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
``market.sinkhorn``'s reduction plans write the reference engine's
compiled steps out; both are held against ``jax.jit`` here and in
tests/test_torch_sinkhorn.py, and ``first_divergence`` runs config 4's
world through both engines: no tick may differ.
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
from multi_cluster_simulator_tpu_torch.market import sinkhorn as S
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


def test_sinkhorn_round_at_64_clusters_from_config4_tick_49():
    """Config 4's world at 64 clusters: the reference engine's state at
    tick 49 (one tick before the round where the port first left it),
    then tick 50 through both engines from that same state. Every leaf
    bitwise: the round's carve, the running set, the trader's floats."""
    C = 64
    cfg, specs, arr, _ = bench.sinkhorn_market_setup(
        C, 400, 600_000, matching="sinkhorn")
    jrun = jax.jit(JEngine(cfg).run, static_argnums=(2,))
    s49 = jrun(jinit(cfg, specs), arr, 49)
    want = jax_leaves(jrun(s49, arr, 1))
    tcfg = port_cfg(cfg)
    ts = interop.state_from_numpy(jax_leaves(s49), "cpu")
    got = interop.to_numpy(Engine(tcfg, device="cpu").run(
        ts, port_arrivals(arr), 1))
    assert int(want[".t"]) == 50_000
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


@pytest.mark.parametrize("n", [4, 8, 9, 13, 16, 17, 24, 64, 73, 128, 256,
                               1024])
def test_xla_gemv_orders_equal_jit(n):
    """The tiled gemv (``K @ v``, ``sinkhorn.gemv_plan``) against
    ``jax.jit`` on sparse random matrices, as the round's kernel is
    sparse: square, and with fewer and more rows than columns (a shard's
    [C_loc, C_tot] rows, rows past a whole tile of 8), at column counts
    past a multiple of 8 too. The one-chain loop (``K.T @ u``,
    ``sinkhorn.fused_dot_plan`` below 50 sellers) against ``jax.jit``
    below 50; from 50 the engine's fused loop has no standalone
    counterpart (a standalone ``K.T @ v`` is a column-major gemv of its
    own: tests/test_torch_sinkhorn.py holds it inside the round's scan)."""
    rng = np.random.default_rng(n)
    for density in (0.05, 0.2, 0.6, 1.0):
        for m in (n, max(1, n // 2), n + 3):
            K = (rng.uniform(0, 20, (m, n))
                 * (rng.uniform(size=(m, n)) < density)).astype(np.float32)
            v = rng.uniform(0.01, 2, n).astype(np.float32)
            rows = np.asarray(jax.jit(lambda K, v: K @ v)(K, v))
            got = S.PlanProduct(torch.from_numpy(K), S.gemv_plan(n, m))(
                torch.from_numpy(v))
            np.testing.assert_array_equal(rows.view(np.int32),
                                          got.numpy().view(np.int32))
            if n < 50 and m == n:
                cols = np.asarray(jax.jit(lambda K, v: K.T @ v)(K, v))
                np.testing.assert_array_equal(
                    cols, S.PlanProduct(torch.from_numpy(K).T,
                                        S.fused_dot_plan(n))(
                        torch.from_numpy(v)).numpy())


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


def first_divergence(C, n_ticks=None, chunk=50):
    """Config 4's world (bench.py:1032 ``sinkhorn_market_setup(C, 400,
    600_000)``, sinkhorn) through the JAX engine and the port's plain
    path, both over the windowed stream in ``chunk``-tick calls: the first
    tick at which a leaf differs bitwise (found tick by tick inside the
    first differing chunk) with the leaves that differ there, whether any
    of them is an integer leaf, and both final placed counts."""
    cfg, specs, arr, n = bench.sinkhorn_market_setup(C, 400, 600_000,
                                                     matching="sinkhorn")
    n = n if n_ticks is None else n_ticks
    tcfg = port_cfg(cfg)
    tspecs = market_ab.sinkhorn_market_specs(C)
    tarr = port_arrivals(arr)
    jeng, teng = JEngine(cfg), Engine(tcfg, device="cpu")
    jrun = jax.jit(jeng.run, static_argnums=(2,))
    js, ts = jinit(cfg, specs), init_state(tcfg, tspecs, device="cpu")
    first = None
    done = 0
    while done < n:
        k = min(chunk, n - done)
        if first is None:  # the port advances ``ts`` in place: a copy
            j0, t0 = js, {key: v.copy()
                          for key, v in interop.to_numpy(ts).items()}
        js = jrun(js, arr, k)
        ts = teng.run(ts, tarr, k)
        if first is None:
            want, got = jax_leaves(js), interop.to_numpy(ts)
            if any(not np.array_equal(want[key], got[key]) for key in want):
                # tick by tick from the chunk's start
                jj = j0
                tt = interop.state_from_numpy(t0, "cpu")
                one = jax.jit(jeng.run, static_argnums=(2,))
                for i in range(k):
                    jj = one(jj, arr, 1)
                    tt = teng.run(tt, tarr, 1)
                    w, g = jax_leaves(jj), interop.to_numpy(tt)
                    bad = sorted(key for key in w
                                 if not np.array_equal(w[key], g[key]))
                    if bad:
                        first = dict(tick=done + i + 1, leaves=bad,
                                     int_leaf=any(w[b].dtype.kind != "f"
                                                  for b in bad))
                        break
        done += k
    return dict(clusters=C, ticks=n, first=first,
                placed_jax=int(np.asarray(js.placed_total).sum()),
                placed_port=int(ts.placed_total.sum()))


def test_config4_world_at_64_clusters_never_leaves_jax():
    """ROADMAP C1's repair at 64 clusters: config 4's world over its 700
    ticks, no tick's state differs from the reference engine's in any
    leaf (before the repair the first was tick 50, a round's carve), and
    both place the same jobs."""
    out = first_divergence(64)
    assert out["first"] is None, out
    assert out["placed_port"] == out["placed_jax"]


@pytest.mark.slow
@pytest.mark.parametrize("C", [128, 256])
def test_config4_world_never_leaves_jax(C):
    """The same at 128 and 256 clusters (first diverging chunk ends 200 and
    450 before the repair)."""
    out = first_divergence(C)
    assert out["first"] is None, out
    assert out["placed_port"] == out["placed_jax"]


@pytest.mark.parametrize(
    "C", [64, pytest.param(256, marks=pytest.mark.slow)])
def test_config4_digest_is_the_reference_engines(C):
    """``tools/market_ab.py CONFIG4_DIGESTS``, which chip_smoke.py holds
    the card's runs to, recomputed from the reference engine: config 4's
    world at C clusters over its 700 ticks, the final state's digest (the
    port's CPU run meets that state tick by tick:
    ``test_config4_world_at_64_clusters_never_leaves_jax``)."""
    cfg, specs, arr, n = bench.sinkhorn_market_setup(C, 400, 600_000,
                                                     matching="sinkhorn")
    want = jax.jit(JEngine(cfg).run, static_argnums=(2,))(
        jinit(cfg, specs), arr, n)
    assert n == 700
    assert interop.leaves_digest(jax_leaves(want)) == \
        market_ab.CONFIG4_DIGESTS[C]


@pytest.mark.slow
def test_config4_at_width_against_jax():
    """ROADMAP C1 at config 4's own width (4,096 clusters, 700 ticks): the
    port's sinkhorn rounds take the reference engine's orders at every
    width, so no tick may differ and both place the same jobs."""
    out = first_divergence(4096)
    print(out)
    assert out["first"] is None, out
    assert out["placed_port"] == out["placed_jax"]
