"""The port's mesh (``multi_cluster_simulator_tpu_torch/parallel/``) against
the JAX package's ``ShardedEngine`` on the conftest's virtual CPU devices.

Ranks are gloo processes on the CPU (``parallel.launch.RankGroup``, one
group of 8 for the module, meshes of its first 2, 4 or 8 ranks); the rank
side of each cell is in ``tests/_torch_mesh_tasks.py``, which loads no
JAX. Each cell runs a reference test's own shapes, seeds and rank counts
(``tests/test_sharded.py``) and holds the gathered state leaf by leaf,
dtypes included and with no tolerance, against the JAX package's sharded
run and, where the reference test holds sharded against local, against
its one-device run too. Beside them: ``MeshExchange``'s collectives (the
``allsum`` order against ``jax.jit`` of the reference's stacked sum), the
jitter table of a shard at its offset against the reference's, and the
divisibility errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import (
    MatchKind, PolicyKind, SimConfig, TraderConfig, WorkloadConfig,
)
from multi_cluster_simulator_tpu.core.engine import Engine as JEngine
from multi_cluster_simulator_tpu.core.engine import pack_arrivals_by_tick
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import Arrivals as JArrivals
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.market import trader as jtrader
from multi_cluster_simulator_tpu.parallel import ShardedEngine as JSharded
from multi_cluster_simulator_tpu.parallel import make_mesh as jmake_mesh
from multi_cluster_simulator_tpu_torch import config as tconfig
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.parallel import ShardedEngine
from multi_cluster_simulator_tpu_torch.parallel.launch import RankGroup
from multi_cluster_simulator_tpu_torch.parallel.mesh import Mesh
from multi_cluster_simulator_tpu_torch.tools import weak_scaling as tws
from tests import _torch_mesh_tasks as tasks
from tests.conftest import make_arrivals
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tools import weak_scaling as jws


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(8, device="cpu", timeout=300) as group:
        yield group


def port_specs(specs):
    return [tspec.ClusterSpec(id=s.id, nodes=tuple(
        tspec.NodeSpec(**dataclasses.asdict(n)) for n in s.nodes))
        for s in specs]


def port_arr(arr):
    if hasattr(arr, "rows"):
        return tstate.TickArrivals(rows=np.asarray(arr.rows),
                                   counts=np.asarray(arr.counts))
    return tstate.Arrivals(**{f.name: np.asarray(getattr(arr, f.name))
                              for f in dataclasses.fields(tstate.Arrivals)})


def _specs(C):
    """tests/test_sharded.py's mix: every fourth cluster a big lender."""
    return [uniform_cluster(c + 1, 10) if c % 4 == 3 else
            uniform_cluster(c + 1, 3, cores=16, memory=8_000)
            for c in range(C)]


def jax_sharded(cfg, specs, arr, n, n_ticks, tick_indexed=False,
                time_compress=False, plan=None):
    sh = JSharded(cfg, jmake_mesh(n))
    s0 = jinit_state(cfg, specs, plan=plan)
    out = sh.run_fn(n_ticks, tick_indexed=tick_indexed,
                    time_compress=time_compress)(
        sh.shard_state(s0), sh.shard_arrivals(arr))
    return out


def port_sharded(ranks, cfg, specs, arr, n, n_ticks, **kw):
    return ranks.run(n, tasks.run_sharded, port_cfg(cfg), port_specs(specs),
                     port_arr(arr), n_ticks, **kw)[0]


# --------------------------------------------------------------------------
# the exchange
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_allsum_order_equals_xla_stacked_sum(ranks, n):
    """``allsum`` is the reference's ``jnp.sum(all_gather(x), axis=0)``
    under XLA's CPU order, bitwise, on f32 partials spanning 20 binades;
    gather, min, max, and, offsets and bool gathers beside it."""
    rng = np.random.default_rng(n)
    parts = (rng.standard_normal((n, 4, 33)) *
             np.exp(rng.uniform(-10, 10, (n, 4, 33)))).astype(np.float32)
    parts[:, 0, 0] = -0.0
    ints = rng.integers(-50, 50, (n, 6)).astype(np.int32)
    outs = ranks.run(n, tasks.exchange_ops, parts, ints)
    want = np.asarray(jax.jit(lambda p: jnp.sum(p, axis=0))(parts))
    for r, out in enumerate(outs):
        assert out["allsum"].dtype == np.float32
        np.testing.assert_array_equal(out["allsum"].view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(out["gather"], ints.reshape(-1))
        np.testing.assert_array_equal(out["allmin"], ints.min(0))
        np.testing.assert_array_equal(out["allmax"], ints.max(0))
        np.testing.assert_array_equal(out["fmax"], parts.max(0))
        assert out["alland"] is False
        assert out["offset"] == 5 * r and out["total"] == 5 * n
        np.testing.assert_array_equal(out["gidx"], 3 * r + np.arange(3))
        assert out["bool_gather"].dtype == bool
        np.testing.assert_array_equal(out["bool_gather"],
                                      ints.reshape(-1) > 0)


@pytest.mark.parametrize("n,C", [(2, 16), (2, 128), (4, 256)])
def test_engine_jitter_at_an_offset_equals_the_reference(ranks, n, C):
    """``Engine.jitter`` on a shard: the [C_loc sellers, C_tot buyers]
    table from the shard's global offset, bitwise the reference's
    ``_pair_jitter(gidx, C_tot)`` (the vectorized argument from 72 buyers
    on)."""
    cfg = port_cfg(SimConfig(policy=PolicyKind.DELAY, n_res=3,
                             trader=TraderConfig(
                                 enabled=True, matching=MatchKind.SINKHORN)))
    c_loc = C // n
    outs = ranks.run(n, tasks.jitter_table, cfg, c_loc)
    for r, table in outs:
        assert table.shape == (c_loc, C)
        want = np.asarray(jax.jit(jtrader._pair_jitter, static_argnums=1)(
            jnp.arange(r * c_loc, (r + 1) * c_loc, dtype=jnp.int32), C))
        np.testing.assert_array_equal(table.view(np.int32),
                                      want.view(np.int32))


def _fake_mesh(n):
    """Rank 0 of an n-rank mesh without a group: enough for the checks that
    raise before any collective."""
    return Mesh(rank=0, size=n, axis="clusters", device=torch.device("cpu"))


@pytest.mark.parametrize("n", [2, 4])
def test_shard_state_is_interops_shard(n):
    """``ShardedEngine.shard_state`` on each rank == ``interop``'s shard of
    the global numpy leaves (the clock whole, every other leaf's rows)."""
    cfg = port_cfg(SimConfig(policy=PolicyKind.DELAY, max_nodes=12))
    state = tstate.init_state(cfg, port_specs(_specs(8)), device="cpu")
    state.arr_ptr.copy_(torch.arange(8, dtype=torch.int32))
    whole = interop.to_numpy(state)
    for r in range(n):
        mesh = Mesh(rank=r, size=n, axis="clusters",
                    device=torch.device("cpu"))
        got = interop.to_numpy(ShardedEngine(cfg, mesh).shard_state(state))
        assert_leaves_equal(interop.shard_to_numpy(whole, r, n), got)
        assert list(got[".arr_ptr"]) == list(range(8))[r * 8 // n:
                                                      (r + 1) * 8 // n]


def test_cluster_count_must_divide():
    cfg = port_cfg(SimConfig(policy=PolicyKind.DELAY, max_nodes=12))
    state = tstate.init_state(cfg, port_specs(_specs(6)), device="cpu")
    arr = port_arr(make_arrivals(SimConfig(max_nodes=12), 6,
                                 horizon_ms=10_000, seed=1))
    with pytest.raises(ValueError, match="divide"):
        ShardedEngine(cfg, _fake_mesh(8)).shard_inputs(state, arr)


def test_divisibility_error_names_nearest_valid_counts():
    cfg = port_cfg(SimConfig(policy=PolicyKind.DELAY, max_nodes=12))
    state = tstate.init_state(cfg, port_specs(_specs(13)), device="cpu")
    arr = port_arr(make_arrivals(SimConfig(max_nodes=12), 13,
                                 horizon_ms=10_000, seed=1))
    with pytest.raises(ValueError, match=r"nearest valid cluster counts: "
                                         r"12 or 16"):
        ShardedEngine(cfg, _fake_mesh(4)).shard_inputs(state, arr)
    with pytest.raises(ValueError, match=r"nearest valid cluster counts: 8"):
        ShardedEngine(cfg, _fake_mesh(8)).shard_state(tstate.init_state(
            cfg, port_specs(_specs(6)), device="cpu"))


def test_mesh_without_a_card_refuses_unless_a_device_is_named(monkeypatch):
    """As every entry point of the port: no card and no device raises; the
    CPU is reached only by naming it."""
    from multi_cluster_simulator_tpu_torch.parallel.mesh import (
        make_mesh, rank_device,
    )
    from multi_cluster_simulator_tpu_torch.tools import multihost_scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: rank_device(1), lambda: make_mesh(),
                 lambda: RankGroup(2),
                 lambda: tws.main(["--quick", "--ranks", "1"]),
                 lambda: multihost_scaling.main(["--procs", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert rank_device(3, "cpu") == torch.device("cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))


# --------------------------------------------------------------------------
# tests/test_sharded.py's cells
# --------------------------------------------------------------------------

def test_sharded_metrics_series_matches_jax(ranks):
    """test_sharded.py:40: DELAY with record_metrics on 8 ranks; the state
    and the [T, C] series gathered on their cluster axis."""
    cfg = SimConfig(policy=PolicyKind.DELAY, record_metrics=True,
                    queue_capacity=64, max_running=256, max_arrivals=1024,
                    max_nodes=12)
    C = 8
    arr = make_arrivals(cfg, C, horizon_ms=120_000, seed=17, max_cores=16,
                        max_mem=8_000)
    want, wseries = jax_sharded(cfg, _specs(C), arr, 8, 120)
    got = port_sharded(ranks, cfg, _specs(C), arr, 8, 120)
    assert_leaves_equal(jax_leaves(want), got["state"])
    assert_leaves_equal(jax_leaves(wseries), got["series"])


@pytest.mark.parametrize("n_dev", [2, 8])
def test_fifo_borrowing_sharded_matches_jax(ranks, n_dev):
    """test_sharded.py:66: FIFO with borrowing (the return delivery and
    the borrow match ride the exchange), against JAX's mesh and its one
    device."""
    cfg = SimConfig(policy=PolicyKind.FIFO, borrowing=True,
                    record_trace=True, queue_capacity=128, max_running=256,
                    max_arrivals=1024, max_nodes=12,
                    workload=WorkloadConfig(poisson_lambda_per_min=30.0))
    C = 8
    arr = make_arrivals(cfg, C, horizon_ms=120_000, seed=31, max_cores=16,
                        max_mem=8_000)
    want = jax_leaves(jax_sharded(cfg, _specs(C), arr, n_dev, 120))
    got = port_sharded(ranks, cfg, _specs(C), arr, n_dev, 120)
    assert_leaves_equal(want, got["state"])
    assert got["calls_per_tick"] > 0


def test_delay_trader_sharded_matches_jax(ranks):
    """test_sharded.py:86: DELAY with the greedy trader on 8 ranks (the
    market round's gathers and min-reductions), the big clusters
    silenced so that they sell."""
    cfg = SimConfig(policy=PolicyKind.DELAY, record_trace=True,
                    queue_capacity=256, max_running=256, max_arrivals=2048,
                    max_nodes=12, max_virtual_nodes=4,
                    trader=TraderConfig(enabled=True),
                    workload=WorkloadConfig(poisson_lambda_per_min=40.0))
    C = 8
    arr = make_arrivals(cfg, C, horizon_ms=200_000, seed=32, max_cores=16,
                        max_mem=8_000)
    n = np.asarray(arr.n).copy()
    n[3::4] = 0
    arr = arr.replace(n=n)
    want = jax_leaves(jax_sharded(cfg, _specs(C), arr, 8, 200))
    got = port_sharded(ranks, cfg, _specs(C), arr, 8, 200)
    assert_leaves_equal(want, got["state"])
    assert got["state"][".node_active"][:, cfg.max_nodes].any(), \
        "expected the market to create a virtual node"


def test_time_compressed_sharded_matches_jax(ranks):
    """test_sharded.py:217: the compressed driver on 8 ranks, its votes
    and leap targets on the exchange, against JAX's mesh and its one-device
    dense run; the ranks leapt."""
    cfg = SimConfig(policy=PolicyKind.FIFO, borrowing=True, parity=True,
                    n_res=2, queue_capacity=16, max_running=32,
                    max_arrivals=8, max_ingest_per_tick=8, max_nodes=5,
                    max_virtual_nodes=0)
    C, A, T = 8, 8, 60
    t = np.asarray([[1_500, 2_200, 2_300, 35_500, 35_600, 35_650, 35_700,
                     36_200]] * C, np.int32)
    rng = np.random.RandomState(3)
    arr = JArrivals(
        t=t, id=np.arange(C * A, dtype=np.int32).reshape(C, A),
        cores=rng.randint(1, 4, (C, A)).astype(np.int32),
        mem=rng.randint(100, 2_000, (C, A)).astype(np.int32),
        gpu=np.zeros((C, A), np.int32),
        dur=rng.randint(1_000, 6_000, (C, A)).astype(np.int32),
        n=np.asarray([A, A, 3, A, A, 3, A, A], np.int32))
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    ta = pack_arrivals_by_tick(arr, T, cfg.tick_ms)
    local = JEngine(cfg).run_jit()(jinit_state(cfg, specs), ta, T)
    want, wstats = jax_sharded(cfg, specs, ta, 8, T, tick_indexed=True,
                               time_compress=True)
    got = port_sharded(ranks, cfg, specs, ta, 8, T, tick_indexed=True,
                       time_compress=True)
    assert_leaves_equal(jax_leaves(want), got["state"])
    assert_leaves_equal(jax_leaves(local), got["state"])
    assert_leaves_equal(jax_leaves(wstats), got["stats"])
    assert int(got["stats"][".ticks_executed"]) < T


def test_ffd_wave_sharded_matches_jax(ranks):
    """test_sharded.py:257: fast-mode FFD (the wave sweep) on 8 ranks."""
    from multi_cluster_simulator_tpu.workload.traces import uniform_stream

    cfg = SimConfig(policy=PolicyKind.FFD, parity=False,
                    max_placements_per_tick=16, queue_capacity=32,
                    max_running=48, max_arrivals=96, max_ingest_per_tick=8,
                    max_nodes=5, max_virtual_nodes=0, n_res=2)
    C = 16
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    arr = uniform_stream(C, 96, 150_000, max_cores=32, max_mem=24_000,
                         max_dur_ms=40_000, seed=11)
    want = jax_leaves(jax_sharded(cfg, specs, arr, 8, 150))
    got = port_sharded(ranks, cfg, specs, arr, 8, 150)
    assert_leaves_equal(want, got["state"])
    assert got["state"][".placed_total"].sum() > 0


@pytest.mark.parametrize("n_dev", [2, 4])
def test_weak_scaling_tiny_mesh_composed_matches_jax(ranks, n_dev):
    """test_sharded.py:141: the weak-scaling constellation (the port's
    ``tools/weak_scaling._fifo_constellation``, equal to the reference's)
    on the compact layout, compressed, against JAX's mesh."""
    from multi_cluster_simulator_tpu.core.compact import derive_plan
    from multi_cluster_simulator_tpu_torch.core.compact import (
        derive_plan as tderive_plan,
    )

    cfg, specs, arr, n_ticks = jws._fifo_constellation(16, 10, 30_000,
                                                       seed=41)
    tcfg, tspecs, tarr, tn = tws._fifo_constellation(16, 10, 30_000,
                                                     seed=41)
    assert tcfg == port_cfg(cfg) and tn == n_ticks
    plan = derive_plan(cfg, specs, arr)
    ta = pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)
    want, wstats = jax_sharded(cfg, specs, ta, n_dev, n_ticks,
                               tick_indexed=True, time_compress=True,
                               plan=plan)
    got = ranks.run(n_dev, tasks.run_sharded, tcfg, tspecs, port_arr(ta),
                    n_ticks, tick_indexed=True, time_compress=True,
                    plan=tderive_plan(tcfg, tspecs, tarr))[0]
    assert_leaves_equal(jax_leaves(want), got["state"])
    assert int(got["stats"][".ticks_executed"]) == \
        int(wstats.ticks_executed) < n_ticks


def test_sentinel_padding_matches_jax_on_the_real_prefix(ranks):
    """test_sharded.py:166: 13 clusters padded to 16 for 4 ranks
    (``pad_constellation``), with borrowing: the gathered state equals
    JAX's padded mesh run leaf for leaf, and its real clusters the
    unpadded one-device run; the sentinels never place or borrow."""
    cfg = SimConfig(policy=PolicyKind.FIFO, borrowing=True,
                    queue_capacity=64, max_running=128, max_arrivals=256,
                    max_nodes=12,
                    workload=WorkloadConfig(poisson_lambda_per_min=30.0))
    C, T = 13, 90
    arr = make_arrivals(cfg, C, horizon_ms=90_000, seed=47, max_cores=16,
                        max_mem=8_000)
    ref = jax_leaves(JEngine(cfg).run_jit()(
        jinit_state(cfg, _specs(C)), pack_arrivals_by_tick(
            arr, T, cfg.tick_ms), T))
    pspecs, parr, n_pad = jws.pad_constellation(cfg, _specs(C), arr, 4)
    tspecs_, tarr_, tn_pad = tws.pad_constellation(
        port_cfg(cfg), port_specs(_specs(C)), port_arr(arr), 4)
    assert n_pad == tn_pad == 3 and port_specs(pspecs) == tspecs_
    for f in dataclasses.fields(tstate.Arrivals):
        np.testing.assert_array_equal(getattr(tarr_, f.name),
                                      np.asarray(getattr(parr, f.name)))
    pta = pack_arrivals_by_tick(parr, T, cfg.tick_ms)
    want = jax_leaves(jax_sharded(cfg, pspecs, pta, 4, T,
                                  tick_indexed=True))
    got = port_sharded(ranks, cfg, pspecs, pta, 4, T,
                       tick_indexed=True)["state"]
    assert_leaves_equal(want, got)
    assert_leaves_equal(ref, {k: v[:C] if v.ndim and v.shape[0] == 16
                              else v for k, v in got.items()})
    assert got[".placed_total"][C:].sum() == 0
    assert got[".borrowed.count"][C:].sum() == 0


def test_sentinel_padding_refused_under_trader():
    """test_sharded.py:204: padding is refused with the trader on."""
    cfg = port_cfg(SimConfig(policy=PolicyKind.DELAY, max_nodes=12,
                             max_virtual_nodes=4,
                             trader=TraderConfig(enabled=True)))
    arr = port_arr(make_arrivals(SimConfig(max_nodes=12), 6,
                                 horizon_ms=10_000, seed=1))
    with pytest.raises(ValueError, match="cannot auto-pad"):
        tws.pad_constellation(cfg, port_specs(_specs(6)), arr, 4)
    assert isinstance(cfg, tconfig.SimConfig)
