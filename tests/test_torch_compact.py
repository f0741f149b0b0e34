"""The port's compact state layout (core/compact.py, the SoA queues and
running set, the narrow node columns) and its checked narrow store
against the JAX package's, on the CPU.

The plan's derivation, ``narrow_store`` and the checked ops' overflow
counts equal the reference's; across tests/test_pipeline.py's
``_tc_scenarios`` matrix, the undersized plan of tests/test_kernels.py:283,
the node exit narrow on a hand-built undersized state, the metrics plane
and generative churn, the port's compact run equals JAX's compact run
leaf by leaf (every ``f_*`` dtype and ``ovf`` included) and its wide run
through ``to_wide``. Integers and ``wait_total`` are bitwise: the
tolerance is zero. Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.core import compact as jCC
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.state import Arrivals as JArrivals
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.obs import device as jD
from multi_cluster_simulator_tpu.ops import fields as jF
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.ops import runset as jR
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import compact as tCC
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.obs import device as tD
from multi_cluster_simulator_tpu_torch.ops import fields as tF
from multi_cluster_simulator_tpu_torch.ops import queues as tQ
from multi_cluster_simulator_tpu_torch.ops import runset as tR
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.test_pipeline import (
    N_TICKS, TC_TICKS, _bursty_arrivals, _cfg, _specs,
    _tc_scenarios,
)
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tests.test_torch_obs import port_specs

SCENARIOS = sorted(_tc_scenarios())
I8 = {n: (np.dtype(np.int8) if n == "cores" else np.dtype(np.int32))
      for n in jF.QUEUE_FIELDS}


def port_plan(plan) -> tCC.CompactPlan:
    """A JAX ``CompactPlan`` as the port's."""
    return tCC.CompactPlan(queue=plan.queue, run=plan.run, node=plan.node)


def run_both(cfg, jspecs, arr, n_ticks, plan=None, chunks=None, mbuf=False):
    """The JAX engine's jitted dense run over the tick-indexed bucket and
    the port's ``run_chunks`` over ragged chunks, each from its package's
    own ``init_state`` with ``plan`` (held equal leaf by leaf); returns
    the JAX output tuple and the port's."""
    tcfg = port_cfg(cfg)
    js0 = jinit_state(cfg, jspecs, plan=plan)
    ts0 = tstate.init_state(tcfg, port_specs(jspecs), device="cpu",
                            plan=None if plan is None else port_plan(plan))
    assert_leaves_equal(jax_leaves(js0), interop.state_to_numpy(ts0))
    ta = jengine.pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)
    eng = jengine.Engine(cfg)
    jmb = jD.metrics_init(js0) if mbuf else None
    want = jax.jit(eng.run, static_argnums=(2,))(js0, ta, n_ticks, None, jmb)
    parts = tengine.pack_arrivals_chunks(port_arrivals(arr),
                                         chunks or [n_ticks], tcfg.tick_ms)
    tmb = tD.metrics_init(ts0) if mbuf else None
    got = tengine.Engine(tcfg, device="cpu").run_chunks(ts0, parts, None,
                                                        tmb)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return want, got


def assert_outputs_equal(want: tuple, got: tuple):
    for w, g in zip(want, got):
        assert_leaves_equal(jax_leaves(w), interop.to_numpy(g))


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 100), (-2, 127), (0, 128),
                                   (-129, 0), (0, 40_000), (-3, 2**31 - 1)])
def test_fit_dtype_equals_jax(lo, hi):
    assert tCC.fit_dtype(lo, hi) == jCC.fit_dtype(lo, hi)


def test_fit_dtype_refuses_past_int32():
    with pytest.raises(ValueError):
        tCC.fit_dtype(0, 2**31)


@pytest.mark.parametrize("audited", [True, False])
@pytest.mark.parametrize("name", SCENARIOS)
def test_derive_plan_equals_jax(name, audited):
    """The plan of every scenario's world, with the stream audit and
    without it (ids stay int32 then), and ``wide_plan``."""
    cfg, arr, jspecs = _tc_scenarios()[name]
    jplan = jCC.derive_plan(cfg, jspecs, arr if audited else None)
    tplan = tCC.derive_plan(port_cfg(cfg), port_specs(jspecs),
                            port_arrivals(arr) if audited else None)
    assert tplan == port_plan(jplan)
    assert tplan.describe() == jplan.describe()
    assert tplan.queue_dtypes() == jplan.queue_dtypes()
    assert tplan.node_dtype() == jplan.node_dtype()
    assert tCC.wide_plan() == port_plan(jCC.wide_plan())
    if not audited:
        assert tplan.queue_dtypes()["id"] == np.dtype(np.int32)
    assert tCC.audit_arrivals(port_arrivals(arr)) == jCC.audit_arrivals(arr)


# --------------------------------------------------------------------------
# the checked narrow store and the checked ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("checked", [True, False])
@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
def test_narrow_store_equals_jax(dtype, checked, masked):
    rng = np.random.default_rng(hash((dtype, checked, masked)) % 2**32)
    v = rng.integers(-70_000, 70_000, (6, 40)).astype(np.int32)
    v[:, :8] = [-32769, -32768, -129, -128, 127, 128, 32767, 32768]
    do = rng.random((6, 40)) < 0.5 if masked else None
    want, wbad = jF.narrow_store(jnp.asarray(v), np.dtype(dtype),
                                 None if do is None else jnp.asarray(do),
                                 checked)
    got, gbad = tF.narrow_store(torch.from_numpy(v), dtype,
                                None if do is None else torch.from_numpy(do),
                                checked)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert np.asarray(want).dtype == got.numpy().dtype
    assert int(wbad) == int(gbad)
    if checked and dtype == "int8":
        assert int(gbad) > 0 and int(got.min()) == -128


def _soa_queue(n_clusters, cap, dtypes):
    jq = jQ.empty_soa(cap, dtypes)
    jq = jax.tree.map(lambda a: jnp.broadcast_to(a, (n_clusters,) + a.shape),
                      jq)
    return jq, tQ.empty_soa(n_clusters, cap, dtypes, "cpu")


def _leaves_of(jtree, ttree):
    assert_leaves_equal(jax_leaves(jtree), interop.to_numpy(ttree))


def test_push_back_counts_instead_of_wrapping():
    """tests/test_compact.py:262: a 500-core job into an int8 cores leaf
    counts once and stores the dtype minimum (never 500 % 256); an
    in-range job adds nothing — the port's ops and JAX's, leaf by leaf."""
    jq, tq = _soa_queue(2, 4, I8)
    jjob = jQ.JobRec.make(id=1, cores=500, mem=10, dur=5, enq_t=0)
    tjob = tQ.JobRec(vec=torch.from_numpy(
        np.asarray(jjob.vec)).expand(2, -1).clone())
    do = np.array([True, False])
    jq2 = jax.vmap(jQ.push_back, in_axes=(0, None, 0))(jq, jjob,
                                                       jnp.asarray(do))
    tq2 = tQ.push_back(tq, tjob, torch.from_numpy(do))
    _leaves_of(jq2, tq2)
    assert tq2.ovf.tolist() == [1, 0]  # do=False: no store, no count
    assert int(tq2.cores[0, 0]) == np.iinfo(np.int8).min
    small = tQ.JobRec(vec=tjob.vec.clone())
    small.vec[:, tQ.FCORES] = 100
    tq3 = tQ.push_back(tq2, small, torch.tensor([True, True]))
    assert tq3.ovf.tolist() == [1, 0]


def test_push_many_counts_on_written_rows():
    """Arrival ingest's ``push_many``: rows past the capacity are not
    stored and not counted; the port equals ``jax.vmap`` of the reference."""
    rng = np.random.default_rng(4)
    jq, tq = _soa_queue(3, 4, I8)
    rows = np.zeros((3, 6, tQ.NF), np.int32)
    rows[..., tQ.FCORES] = rng.choice([5, 300, -200], (3, 6))
    rows[..., tQ.FID] = np.arange(6)
    take = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1],
                     [0, 1, 0, 1, 0, 1]], bool)
    jbatch = jQ.JobQueue(data=jnp.asarray(rows),
                         count=jnp.asarray(take.sum(1), jnp.int32))
    jq2 = jax.vmap(jQ.push_many)(jq, jbatch, jnp.asarray(take))
    tq2 = tQ.push_many(tq, tQ.JobQueue(data=torch.from_numpy(rows),
                                       count=torch.from_numpy(
                                           take.sum(1).astype(np.int32))),
                       torch.from_numpy(take))
    _leaves_of(jq2, tq2)
    assert int(tq2.ovf.sum()) > 0


def test_carve_insert_counts_like_insert_row():
    """The market carve's store (``start_many(..., checked=True)``) counts
    as the reference's ``insert_row`` does: each written row's fields
    outside their dtype; the placements' ``start_many`` is unchecked."""
    dtypes = {n: (np.dtype(np.int8) if n in ("cores", "node")
                  else np.dtype(np.int32)) for n in jF.RUN_FIELDS}
    jrs = jR.empty_soa(4, dtypes)
    row = jR.make_row(9_000, 2, 300, 10, 0, -3, -2, 9_000, 0)
    hot = jnp.asarray([False, True, False, False])
    jrs2 = jR.insert_row(jrs, hot, row)
    trs = tR.empty_soa(1, 4, dtypes, "cpu")
    rows = torch.from_numpy(np.asarray(row)).reshape(1, 1, tR.RF)
    trs2 = tR.start_many(trs, rows, torch.tensor([1], dtype=torch.int32),
                         checked=True)
    assert int(trs2.ovf[0]) == int(jrs2.ovf) == 1
    assert int(trs2.cores[0, 0]) == -128
    trs3 = tR.start_many(trs, rows, torch.tensor([1], dtype=torch.int32))
    assert int(trs3.ovf[0]) == 0
    assert int(trs3.f_cores[0, 0]) == np.int8(np.int32(300).astype(np.int8))


def test_interop_round_trips_a_compact_state():
    cfg, arr, jspecs = _tc_scenarios()["fifo_borrowing"]
    plan = jCC.derive_plan(cfg, jspecs, arr)
    js = jinit_state(cfg, jspecs, plan=plan)
    ts = interop.state_from_numpy(jax_leaves(js), device="cpu")
    assert isinstance(ts.l0, tQ.SoAJobQueue)
    assert isinstance(ts.run, tR.SoARunningSet)
    assert_leaves_equal(jax_leaves(js), interop.state_to_numpy(ts))
    assert tCC.state_nbytes(ts) == jCC.state_nbytes(js)
    assert_leaves_equal(jax_leaves(jCC.to_wide(js)),
                        interop.state_to_numpy(tCC.to_wide(ts)))


# --------------------------------------------------------------------------
# whole runs: compact == JAX compact, and == wide through to_wide
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_compact_run_equals_jax_and_wide(name):
    """tests/test_compact.py:179 (and tests/test_kernels.py:127's compact
    cells): the port's compact run equals JAX's compact run leaf by leaf,
    its series too, and the port's wide run through ``to_wide``, with
    every ``ovf`` zero."""
    cfg, arr, jspecs = _tc_scenarios()[name]
    plan = jCC.derive_plan(cfg, jspecs, arr)
    assert plan.describe().get("queue") and plan.describe().get("run")
    want, got = run_both(cfg, jspecs, arr, TC_TICKS, plan, chunks=[50, 30])
    assert_outputs_equal(want, got)
    _, wide = run_both(cfg, jspecs, arr, TC_TICKS, chunks=[50, 30])
    assert tCC.overflow_total(got[0]) == 0
    assert ttrace.total_drops(got[0])["narrow"] == 0
    assert_leaves_equal(interop.state_to_numpy(wide[0]),
                        interop.state_to_numpy(tCC.to_wide(got[0])))
    assert_leaves_equal(interop.to_numpy(wide[1]), interop.to_numpy(got[1]))
    assert int(got[0].placed_total.sum()) > 0
    assert tCC.state_nbytes(got[0]) < tCC.state_nbytes(wide[0])


def test_undersized_plan_counts_like_the_reference():
    """tests/test_kernels.py:283: int8 cores against a 500-core stream —
    the port equals JAX's unfused run leaf by leaf, counts into ``ovf`` and
    stores the dtype minimum, never 500 % 256."""
    cfg = _cfg()
    A = 4
    arr = JArrivals(
        t=np.asarray([[1_500, 2_500, 3_500, 4_500]], np.int32),
        id=np.arange(A, dtype=np.int32).reshape(1, A),
        cores=np.asarray([[500, 2, 500, 2]], np.int32),
        mem=np.full((1, A), 100, np.int32), gpu=np.zeros((1, A), np.int32),
        dur=np.full((1, A), 5_000, np.int32), n=np.full((1,), A, np.int32))
    plan = jCC.derive_plan(cfg, _specs(1), arrivals=None)
    under = dataclasses.replace(plan, queue=tuple(
        (n, "int8" if n == "cores" else dt) for n, dt in plan.queue))
    want, got = run_both(cfg, _specs(1), arr, 10, under, chunks=[6, 4])
    assert_outputs_equal(want, got)
    assert tCC.overflow_total(got[0]) > 0
    assert not (got[0].ready.f_cores == 500 % 256).any()


def test_node_exit_narrow_counts_on_a_hand_built_state():
    """The terminal exit narrow (tests/test_compact.py:144's claim, on the
    FIFO prefix): a hand-built plan whose int8 queue cores take -128 for a
    500-core job and whose int8 node columns hold the 100-core nodes. The
    placed -128-core job lifts its node's free cores past 127; the exit
    narrow clamps and counts ONE total over every cluster into each
    cluster's ``run.ovf`` — the port equals JAX's unfused run."""
    cfg = _cfg(n_res=2)
    C, A = 3, 2
    jspecs = [jax_spec(c) for c in range(C)]
    arr = JArrivals(
        t=np.full((C, A), 1_500, np.int32),
        id=np.arange(C * A, dtype=np.int32).reshape(C, A),
        cores=np.asarray([[500, 2], [2, 2], [500, 500]], np.int32),
        mem=np.full((C, A), 10, np.int32), gpu=np.zeros((C, A), np.int32),
        dur=np.full((C, A), 50_000, np.int32), n=np.full((C,), A, np.int32))
    plan = jCC.derive_plan(cfg, jspecs, arrivals=None)
    assert plan.node == "int8"
    under = dataclasses.replace(plan, queue=tuple(
        (n, "int8" if n == "cores" else dt) for n, dt in plan.queue))
    want, got = run_both(cfg, jspecs, arr, 4, under, chunks=[4])
    assert_outputs_equal(want, got)
    run_ovf = got[0].run.ovf
    assert int(run_ovf.min()) > 0 and bool((run_ovf == run_ovf[0]).all())


def jax_spec(c):
    from multi_cluster_simulator_tpu.core.spec import uniform_cluster

    return uniform_cluster(c + 1, 2, cores=100, memory=100)


def test_node_exit_narrow_counts_under_the_trader():
    """tests/test_compact.py:144: an undersized node dtype under the trader
    (non-terminal: the exit narrow after the trade round) counts the
    contract total that does not fit, as the reference does."""
    from tests.test_compact import _hot_market_case

    cfg, jspecs, arr = _hot_market_case()
    plan = jCC.derive_plan(cfg, jspecs, arr)
    stale = dataclasses.replace(plan, node=jCC.fit_dtype(0, 24_000))
    want, got = run_both(cfg, jspecs, arr, 300, stale, chunks=[300])
    assert_outputs_equal(want, got)
    assert ttrace.total_drops(got[0])["narrow"] > 0


def test_plane_on_the_compact_layout():
    """tests/test_obs.py:79: obs-on == obs-off on the compact state, the
    buffer equals the wide run's and JAX's compact run's."""
    cfg, arr, jspecs = _cfg(), _bursty_arrivals(), _specs(3)
    plan = jCC.derive_plan(cfg, jspecs, arr)
    want, got = run_both(cfg, jspecs, arr, N_TICKS, plan, chunks=[10, 10],
                         mbuf=True)
    assert_outputs_equal(want, got)
    _, off = run_both(cfg, jspecs, arr, N_TICKS, plan, chunks=[10, 10])
    assert_leaves_equal(interop.state_to_numpy(off[0]),
                        interop.state_to_numpy(got[0]))
    _, wide = run_both(cfg, jspecs, arr, N_TICKS, chunks=[10, 10], mbuf=True)
    assert_leaves_equal(interop.metrics_to_numpy(wide[1]),
                        interop.metrics_to_numpy(got[1]))
    assert tD.harvest(got[1])["narrow_ovf"] == 0


def test_churn_matrix_compact_cell():
    """tests/test_faults.py:93's compact cell: generative churn at 8
    clusters over 80 ticks, retries narrowed to int8; the port's compact
    run equals JAX's and, through ``to_wide``, the wide run."""
    from tests.test_torch_faults_engine import CHURN, _cfg as fcfg, _stream

    C, T = 8, 80
    cfg = fcfg(faults=CHURN)
    jspecs = _specs(C)
    arr = _stream(C)
    plan = jCC.derive_plan(cfg, jspecs, arr)
    assert dict(plan.queue)["retries"] == "int8"
    want, got = run_both(cfg, jspecs, arr, T, plan, chunks=[33, 29, T - 62])
    assert_outputs_equal(want, got)
    assert int(got[0].faults.kills.sum()) > 0
    _, wide = run_both(cfg, jspecs, arr, T)
    assert tCC.overflow_total(got[0]) == 0
    assert_leaves_equal(interop.state_to_numpy(wide[0]),
                        interop.state_to_numpy(tCC.to_wide(got[0])))


def test_node_exit_count_is_batch_wide_as_the_unfused_reference():
    """The terminal node exit narrow's count is ONE total over the whole
    batch, added to every cluster's ``run.ovf``, in the reference's
    unfused engine (its narrow is not vmapped) and in the port; the
    reference's Pallas kernel sums per block of ``fused_block`` clusters
    instead, so its ``run.ovf`` differs from its own unfused run's once the
    count is nonzero (ROADMAP queue C). The port follows the unfused
    path."""
    cfg = _cfg(n_res=2)
    C, A = 3, 2
    jspecs = [jax_spec(c) for c in range(C)]
    arr = JArrivals(
        t=np.full((C, A), 1_500, np.int32),
        id=np.arange(C * A, dtype=np.int32).reshape(C, A),
        cores=np.asarray([[500, 2], [2, 2], [500, 500]], np.int32),
        mem=np.full((C, A), 10, np.int32), gpu=np.zeros((C, A), np.int32),
        dur=np.full((C, A), 50_000, np.int32), n=np.full((C,), A, np.int32))
    under = dataclasses.replace(
        jCC.derive_plan(cfg, jspecs, arrivals=None),
        queue=tuple((n, "int8" if n == "cores" else dt) for n, dt in
                    jCC.derive_plan(cfg, jspecs, arrivals=None).queue))
    ta = jengine.pack_arrivals_by_tick(arr, 4, cfg.tick_ms)
    fused = dataclasses.replace(cfg, fused="on", fused_block=1)
    blocks = jengine.Engine(fused).run_jit()(
        jinit_state(fused, jspecs, plan=under), ta, 4)
    want, got = run_both(cfg, jspecs, arr, 4, under, chunks=[4])
    assert_outputs_equal(want, got)
    whole = np.asarray(want[0].run.ovf)
    per_block = np.asarray(blocks.run.ovf)
    assert (whole == whole[0]).all() and whole[0] > 0
    assert not np.array_equal(per_block, whole)
    assert got[0].run.ovf.tolist() == whole.tolist()
