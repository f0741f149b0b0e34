"""The paths that shard through the port's mesh, against the JAX package's
``ShardedEngine`` on the conftest's virtual CPU devices: the market
rounds (sinkhorn at 2 ranks, the 8-rank cvx cell under churn, plain and
compact + compressed), churn's mesh cells, the compact layout, the ragged chunk pipeline, the
kernel's form, the metrics plane's carry and harvest, the mesh cut
(checkpoints), the dispatch with replicated params, the env batch and the
multi-process rendezvous. Each at the reference test's own shapes, seeds
and rank counts (named in each docstring); ranks are gloo processes
(``parallel.launch.RankGroup``), their side in
``tests/_torch_mesh_tasks.py``. Integer and bool leaves and dtypes are
bitwise everywhere; floats bitwise too, except the sinkhorn/cvx solver
floats, which the port's market rule holds to ``RTOL``/``ATOL``
(tests/test_torch_market.py).
"""

import jax
import numpy as np
import pytest

from multi_cluster_simulator_tpu.config import MatchKind
from multi_cluster_simulator_tpu.core import compact as jcompact
from multi_cluster_simulator_tpu.core import preempt as jpreempt
from multi_cluster_simulator_tpu.core.engine import Engine as JEngine
from multi_cluster_simulator_tpu.core.engine import (
    pack_arrivals_by_tick, pack_arrivals_chunks,
)
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.obs import device as jobs_device
from multi_cluster_simulator_tpu.parallel import ShardedEngine as JSharded
from multi_cluster_simulator_tpu.parallel import make_mesh as jmake_mesh
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import compact as tcompact
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import preempt as tpreempt
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.parallel.launch import RankGroup
from tests import _torch_mesh_tasks as tasks
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tests.test_torch_market import assert_decisions_equal
from tests.test_torch_mesh import port_arr, port_specs


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(8, device="cpu", timeout=300) as group:
        yield group


def tplan(plan):
    return tcompact.CompactPlan(queue=plan.queue, run=plan.run,
                                node=plan.node)


def run_port(ranks, n, cfg, specs, arr, n_ticks, **kw):
    return ranks.run(n, tasks.run_sharded, port_cfg(cfg), port_specs(specs),
                     port_arr(arr), n_ticks, **kw)[0]


def test_sinkhorn_sharded_matches_jax(ranks):
    """tests/test_sinkhorn.py:93: the 2x2 market under sinkhorn over 2
    ranks (the jitter table at each shard's offset, ``K @ vc`` and
    ``K.T @ u`` on the shard's shapes, the column sums through
    ``allsum``), against JAX's mesh and its one device."""
    from tests.test_sinkhorn import market_cfg, two_buyer_two_seller

    cfg = market_cfg(MatchKind.SINKHORN)
    specs, arr = two_buyer_two_seller()
    sh = JSharded(cfg, jmake_mesh(2))
    want = sh.run_fn(25)(*sh.shard_inputs(jinit_state(cfg, specs), arr))
    local = jax.jit(JEngine(cfg).run, static_argnums=(2,))(
        jinit_state(cfg, specs), arr, 25)
    got = run_port(ranks, 2, cfg, specs, arr, 25)["state"]
    assert_decisions_equal(jax_leaves(want), got)
    assert_decisions_equal(jax_leaves(local), got)
    assert got[".node_active"][:, cfg.max_nodes:].sum() > 0


def test_cvx_eight_rank_cell_matches_jax(ranks):
    """tests/test_market_cvx.py:276: the cvx parity matrix's scenario
    under generative churn on 8 ranks (shard-local primal rows, the buyer
    prices through ``allsum``), then composed with compact + compressed,
    against JAX's 8-device mesh and its one-device run."""
    from tests.test_market_cvx import _CHURN, _matrix_cfg, _matrix_scenario

    C, T = 8, 80
    cfg = _matrix_cfg(faults=_CHURN)
    specs, arr = _matrix_scenario()
    ta = pack_arrivals_by_tick(arr, T, cfg.tick_ms)
    ref = jax_leaves(JEngine(cfg).run_jit()(jinit_state(cfg, specs), ta, T))
    sh = JSharded(cfg, jmake_mesh(8))
    want = jax_leaves(sh.run_fn(T, tick_indexed=True)(
        sh.shard_state(jinit_state(cfg, specs)), sh.shard_arrivals(ta)))
    got = run_port(ranks, 8, cfg, specs, ta, T, tick_indexed=True)["state"]
    assert_decisions_equal(want, got)
    assert_decisions_equal(ref, got)
    assert got[".faults.kills"].sum() > 0
    assert got[".node_active"][:, cfg.max_nodes:].sum() > 0

    plan = jcompact.derive_plan(cfg, specs, arr)
    want_x, wstats = sh.run_fn(T, tick_indexed=True, time_compress=True)(
        sh.shard_state(jinit_state(cfg, specs, plan=plan)),
        sh.shard_arrivals(ta))
    got_x = run_port(ranks, 8, cfg, specs, ta, T, tick_indexed=True,
                     time_compress=True, plan=tplan(plan))
    assert_decisions_equal(jax_leaves(want_x), got_x["state"])
    assert_leaves_equal(jax_leaves(wstats), got_x["stats"])


def test_churn_matrix_mesh_cells_match_jax(ranks):
    """tests/test_faults.py:93's mesh cells: generative churn on 8 ranks
    (every fault leaf per cluster, no new collective), plain and compact +
    compressed, against JAX's mesh and its one-device run."""
    from tests.test_faults import _CHURN, _cfg, _specs, _stream

    C, T = 8, 80
    cfg, specs, arr = _cfg(C, faults=_CHURN), _specs(C), _stream(C)
    ta = pack_arrivals_by_tick(arr, T, cfg.tick_ms)
    ref = jax_leaves(JEngine(cfg).run_jit()(jinit_state(cfg, specs), ta, T))
    sh = JSharded(cfg, jmake_mesh(8))
    want = jax_leaves(sh.run_fn(T, tick_indexed=True)(
        sh.shard_state(jinit_state(cfg, specs)), sh.shard_arrivals(ta)))
    got = run_port(ranks, 8, cfg, specs, ta, T, tick_indexed=True)["state"]
    assert_leaves_equal(want, got)
    assert_leaves_equal(ref, got)
    assert got[".faults.kills"].sum() > 0

    plan = jcompact.derive_plan(cfg, specs, arr)
    want_x, _ = sh.run_fn(T, tick_indexed=True, time_compress=True)(
        sh.shard_state(jinit_state(cfg, specs, plan=plan)),
        sh.shard_arrivals(ta))
    got_x = run_port(ranks, 8, cfg, specs, ta, T, tick_indexed=True,
                     time_compress=True, plan=tplan(plan))["state"]
    assert_leaves_equal(jax_leaves(want_x), got_x)
    wide = tcompact.to_wide(interop.state_from_numpy(got_x, "cpu"))
    assert_leaves_equal(ref, interop.to_numpy(wide))


def test_compact_sharded_matches_jax(ranks):
    """tests/test_compact.py:238: compact leaves shard over 8 ranks like
    their wide ancestors; the gathered compact state equals JAX's sharded
    compact run, and widened, the one-device wide run."""
    from tests.test_pipeline import TICK_MS, _bursty_arrivals, _cfg, _specs

    C = 8
    arr, cfg = _bursty_arrivals(C), _cfg()
    ta = pack_arrivals_by_tick(arr, 20, TICK_MS)
    ref = jax_leaves(JEngine(cfg).run_jit()(jinit_state(cfg, _specs(C)), ta,
                                            20))
    plan = jcompact.derive_plan(cfg, _specs(C), arr)
    sh = JSharded(cfg, jmake_mesh(8))
    want = jax_leaves(sh.run_fn(20, tick_indexed=True)(
        sh.shard_state(jinit_state(cfg, _specs(C), plan=plan)),
        sh.shard_arrivals(ta)))
    got = run_port(ranks, 8, cfg, _specs(C), ta, 20, tick_indexed=True,
                   plan=tplan(plan))["state"]
    assert_leaves_equal(want, got)
    wide = tcompact.to_wide(interop.state_from_numpy(got, "cpu"))
    assert tcompact.overflow_total(interop.state_from_numpy(got, "cpu")) == 0
    assert_leaves_equal(ref, interop.to_numpy(wide))


def test_sharded_pipeline_matches_jax(ranks):
    """tests/test_pipeline.py:145: 2 ranks fed the ragged chunks (K 1 then
    8) in place, against JAX's donated sharded chunks and its one-scan
    run."""
    from tests.test_pipeline import (
        CHUNKS, N_TICKS, TICK_MS, _bursty_arrivals, _cfg, _specs,
    )

    C = 4
    arr, cfg = _bursty_arrivals(C), _cfg()
    ta = pack_arrivals_by_tick(arr, N_TICKS, TICK_MS)
    ref = jax_leaves(JEngine(cfg).run_jit()(jinit_state(cfg, _specs(C)), ta,
                                            N_TICKS))
    parts = pack_arrivals_chunks(arr, CHUNKS, TICK_MS)
    assert parts[0].rows.shape[2] != parts[1].rows.shape[2]
    sh = JSharded(cfg, jmake_mesh(2))
    s = sh.shard_state(jinit_state(cfg, _specs(C)))
    for part, n in zip(parts, CHUNKS):
        s = sh.run_fn(n, tick_indexed=True, donate=True)(
            s, sh.shard_arrivals(part))
    got = ranks.run(2, tasks.run_sharded, port_cfg(cfg),
                    port_specs(_specs(C)), None, N_TICKS,
                    chunks=[port_arr(p) for p in parts])[0]["state"]
    assert_leaves_equal(jax_leaves(s), got)
    assert_leaves_equal(ref, got)
    assert got[".placed_total"].sum() > 0


def test_kernel_form_sharded_matches_jax(ranks):
    """tests/test_kernels.py:197: the fused config on 8 ranks (each rank
    runs its shard's prefix as the kernel's form: the plain version on the
    CPU, the hand-written kernel on the card) against JAX's fused kernel
    under shard_map and its one-device unfused run."""
    from tests.test_kernels import _fused
    from tests.test_pipeline import TICK_MS, _bursty_arrivals, _cfg, _specs

    C = 8
    arr, cfg = _bursty_arrivals(C), _cfg()
    ta = pack_arrivals_by_tick(arr, 20, TICK_MS)
    ref = jax_leaves(JEngine(cfg).run_jit()(jinit_state(cfg, _specs(C)), ta,
                                            20))
    sh = JSharded(_fused(cfg), jmake_mesh(8))
    want = jax_leaves(sh.run_fn(20, tick_indexed=True)(
        sh.shard_state(jinit_state(cfg, _specs(C))), sh.shard_arrivals(ta)))
    got = run_port(ranks, 8, _fused(cfg), _specs(C), ta, 20,
                   tick_indexed=True)["state"]
    assert_leaves_equal(want, got)
    assert_leaves_equal(ref, got)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_obs_sharded_carry_and_harvest_match_jax(ranks, n_dev):
    """tests/test_obs.py:123: the metrics buffer as a shard-local carry on
    2, 4 and 8 ranks (partials on each rank's row), harvested through
    ``collect_metrics`` (``reduce_metrics`` through ``allsum``); state and
    buffer against JAX's collect on as many devices and its one-device
    buffer."""
    from tests.test_pipeline import (
        N_TICKS, TICK_MS, _bursty_arrivals, _cfg, _specs,
    )

    C = 8
    cfg, specs, arr = _cfg(), _specs(C), _bursty_arrivals(C)
    ta = pack_arrivals_by_tick(arr, N_TICKS, TICK_MS)
    s0 = jinit_state(cfg, specs)
    ref, mb_ref = jax.jit(JEngine(cfg).run, static_argnums=(2,))(
        s0, ta, N_TICKS, None, jobs_device.metrics_init(s0))
    sh = JSharded(cfg, jmake_mesh(n_dev))
    out, mb = sh.run_fn(N_TICKS, tick_indexed=True, with_metrics=True)(
        sh.shard_state(s0), sh.shard_arrivals(ta),
        sh.shard_metrics(jobs_device.metrics_init(s0)))
    got = run_port(ranks, n_dev, cfg, specs, ta, N_TICKS, tick_indexed=True,
                   metrics=True)
    assert_leaves_equal(jax_leaves(out), got["state"])
    assert_leaves_equal(jax_leaves(ref), got["state"])
    assert_leaves_equal(jax_leaves(sh.collect_metrics(mb)), got["mbuf"])
    assert_leaves_equal(jax_leaves(mb_ref), got["mbuf"])
    assert got["mbuf"][".placed"].sum() > 0


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_resume_matches_jax(ranks, tmp_path, n_dev):
    """tests/test_preempt.py:173, compact + trace churn: n ranks cut at the
    midpoint write ONE file, byte for byte the one-process port's and the
    JAX mesh's file at that tick; it resumes on the ranks, and in one
    process, bitwise the uninterrupted run; a one-process file resumes on
    the ranks bitwise too."""
    from tests import test_preempt as jt

    T = jt.T
    cfg = jt._cfg(faults=True)
    arr = jt._stream(seed=9)
    plan = jcompact.derive_plan(cfg, jt._specs(), arr)
    ta = pack_arrivals_by_tick(arr, T, cfg.tick_ms)
    ref = jax_leaves(JEngine(cfg).run_jit()(jt._state0(cfg, plan), ta, T))
    halves = [jax.tree.map(lambda x: x[:T // 2], ta),
              jax.tree.map(lambda x: x[T // 2:], ta)]
    sh = JSharded(cfg, jmake_mesh(n_dev))
    mid = sh.run_fn(T // 2, tick_indexed=True)(
        sh.shard_state(jt._state0(cfg, plan)), sh.shard_arrivals(halves[0]))
    jpath = str(tmp_path / "jax_mesh.ckpt")
    jpreempt.save_run(jpath, mid, cfg=cfg, plan=plan, tick_ms=cfg.tick_ms)

    tcfg, tspecs, tp = port_cfg(cfg), port_specs(jt._specs()), tplan(plan)
    events = jt._CHURN_TRACE
    first, second = (port_arr(h) for h in halves)
    path = str(tmp_path / "port_mesh.ckpt")
    got = ranks.run(n_dev, tasks.mesh_cut, tcfg, tspecs, first, second,
                    plan=tp, fault_events=events, path=path)[0]
    assert_leaves_equal(ref, got)

    # the one-process port's file at the same tick
    eng = tengine.Engine(tcfg, device="cpu")

    def s0():
        return tstate.init_state(tcfg, tspecs, plan=tp, fault_events=events,
                                 device="cpu")
    one = str(tmp_path / "one.ckpt")
    tpreempt.save_run(one, eng.run(s0(), first, T // 2), cfg=tcfg, plan=tp,
                      tick_ms=tcfg.tick_ms)
    raw = open(path, "rb").read()
    assert raw == open(one, "rb").read() == open(jpath, "rb").read()
    # the mesh's file resumed in one process
    rc = tpreempt.load_run(path, s0(), cfg=tcfg, plan=tp)
    assert_leaves_equal(ref, interop.to_numpy(
        eng.run(rc.state, second, T - T // 2)))
    # a one-process file resumed on the ranks
    got = ranks.run(n_dev, tasks.mesh_cut, tcfg, tspecs, None, second,
                    plan=tp, fault_events=events, path=one, resume=True)[0]
    assert_leaves_equal(ref, got)


def test_dispatch_with_replicated_params_matches_jax(ranks):
    """tests/test_policies.py:142: the zoo's set on 8 ranks with the FIFO
    member's params replicated, against JAX's mesh with its params and
    the unsharded singleton engine."""
    from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
    from multi_cluster_simulator_tpu.core.spec import uniform_cluster
    from tests.test_policies import ZOO, _arr

    cfg = SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                    queue_capacity=64, max_running=64, max_arrivals=80,
                    max_ingest_per_tick=16, max_nodes=5,
                    max_virtual_nodes=0)
    C, n_ticks = 8, 150
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    arr = _arr(C, seed=7)
    s0 = jinit_state(cfg, specs)
    ref = jax_leaves(JEngine(cfg).run_jit()(s0, arr, n_ticks))
    sh = JSharded(cfg, jmake_mesh(8), policies=ZOO)
    ta = pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)
    want = jax_leaves(sh.run_fn(n_ticks, tick_indexed=True, with_params=True)(
        *sh.shard_inputs(s0, ta), ZOO.params_for(cfg, "fifo")))
    got = run_port(ranks, 8, cfg, specs, ta, n_ticks, tick_indexed=True,
                   policies=tuple(ZOO.names), params="fifo")["state"]
    assert_leaves_equal(want, got)
    assert_leaves_equal(ref, got)


@pytest.mark.parametrize("compact", [False, True])
def test_env_batch_sharded_matches_jax(ranks, compact):
    """tests/test_env.py:98 and :123: 8 replay envs sharded over 8 ranks
    on their batch axis (``shard_env_batch``), stepped 30 times, gathered:
    equal to JAX's sharded batch, and cell 3 (5 compact) to its one-env
    run."""
    from jax.sharding import Mesh

    from multi_cluster_simulator_tpu.envs import ClusterEnv as JEnv
    from multi_cluster_simulator_tpu.envs import shard_env_batch as jshard
    from tests.test_env import T, _cfg, _replay, _run_ref, _specs

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        cfg, specs = _cfg(), _specs()
        arr, ta = _replay(cfg)
        plan = jcompact.derive_plan(cfg, specs, arr) if compact else None
        env = JEnv(cfg, specs, episode_ticks=T + 5, arrivals=ta, plan=plan)
        seed = 4 if compact else 1
        _, es = env.reset_batch(jax.random.PRNGKey(seed), 8)
        es = jshard(es, Mesh(np.asarray(jax.devices()), ("envs",)))
        step = env.batch_step_fn(donate=False)
        for _ in range(T):
            _, _, _, _, es = step(es, None)
        cell = 5 if compact else 3
        ref = jax_leaves(_run_ref(cfg, specs, ta, T, plan=plan))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    got = ranks.run(8, tasks.env_sharded, port_cfg(cfg), port_specs(specs),
                    port_arr(ta), 8, seed, T,
                    plan=None if plan is None else tplan(plan))[0]
    assert_leaves_equal(jax_leaves(es.sim), got)
    assert_leaves_equal(ref, {k: v[cell] for k, v in got.items()})


def test_two_independent_processes_match_one_process():
    """tests/test_multihost.py:28: two processes started on their own meet
    at one FileStore (``parallel.multihost``), run the borrowing world of
    tests/_multihost_worker.py sharded, and each holds the gathered result
    bitwise against its one-process run."""
    from multi_cluster_simulator_tpu_torch.tools import multihost_scaling

    row = multihost_scaling.spawn(2, "cpu", check=True, timeout=300)
    assert row["bit_identical"] and row["nprocs"] == 2 and row["placed"] > 0
