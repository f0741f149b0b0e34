"""The port's borrowing path against the JAX package, on the CPU.

Bitwise throughout, with no tolerance. Per op, against the JAX function
(under ``jax.vmap`` where the reference writes it per cluster):
``gather_rows_along``, the stable ``push_many`` (overflow included, and the
shared batch of the lender push), ``can_lend``, ``_pack_returns`` (more
returns than message slots, none, FOREIGN owners), ``_deliver_returns``
(duplicate messages, messages to a cluster whose BorrowedQueue is empty),
``_borrow_match`` (several borrowers winning one lender, self-lend
excluded, LentQueue overflow) and ``LocalExchange``. Whole runs:
``run_io`` against the reference's stacked ``TickIO`` and against ``run``;
BASELINE config 2 with the trader cut, at its own two clusters and tiled
to 16 (through the Pallas prefix in interpret mode); and a Level0 member
with borrowing on. Inputs come from numpy seeds. The reference's borrowing
oracle-parity scenarios and parity tests are in
``test_torch_borrow_oracle.py`` and ``test_torch_borrow_parity.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import (
    PolicyKind, SimConfig, TraderConfig, WorkloadConfig,
)
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core import spec as jspec
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.ops import fields as jF
from multi_cluster_simulator_tpu.ops import placement as jP
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.ops import runset as jR
from multi_cluster_simulator_tpu.parallel.exchange import (
    LocalExchange as JLocalExchange,
)
from multi_cluster_simulator_tpu.policies import base as jbase
from multi_cluster_simulator_tpu.workload.generator import generate_arrivals
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.kernels import fused_tick as tfused
from multi_cluster_simulator_tpu_torch.ops import placement as tP
from multi_cluster_simulator_tpu_torch.ops import queues as tQ
from multi_cluster_simulator_tpu_torch.ops import runset as tR
from multi_cluster_simulator_tpu_torch.parallel.exchange import LocalExchange
from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.test_parity import BASE
from tests.test_pipeline import (
    N_TICKS, TICK_MS, _bursty_arrivals, _cfg, _specs, _tc_scenarios,
)
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import (
    assert_leaves_equal, jax_leaves, port_cfg,
)
from tests.test_torch_ops import (
    C, QCAP, S, eq, queues, rand_nodes, rand_queue, rand_rows, rand_runset,
    t_,
)

SEEDS = [0, 1, 2]
NO_DROPS = dict.fromkeys(("queue", "msgs", "run_full", "vslot", "carve",
                          "ingest", "failed", "narrow"), 0)


def jstate_with(cfg, n_clusters, **leaves):
    """A JAX initial state of ``n_clusters`` 5-node clusters with the
    given leaves replaced (numpy values)."""
    state = jinit_state(cfg, [uniform_cluster(c + 1, 5)
                              for c in range(n_clusters)])
    return state.replace(**{k: jax.tree.map(jnp.asarray, v)
                            for k, v in leaves.items()})


def port_of(jstate):
    return interop.state_from_numpy(jax_leaves(jstate), device="cpu")


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_gather_rows_along_equals_jax(seed):
    rng = np.random.default_rng(70 + seed)
    cap, active = rand_nodes(rng, 2)
    data, act, _ = rand_runset(rng, cap, active, 40_000)
    order = rng.integers(0, S, (C, 5)).astype(np.int32)
    want = jax.vmap(jR.gather_rows_along)(
        jR.RunningSet(data=jnp.asarray(data), active=jnp.asarray(act)),
        jnp.asarray(order))
    got = tR.gather_rows_along(tR.RunningSet(data=t_(data), active=t_(act)),
                               t_(order))
    eq(want, got)


@pytest.mark.parametrize("shared", [False, True], ids=["per_cluster",
                                                       "shared_batch"])
@pytest.mark.parametrize("K", [1, 5, 40])
@pytest.mark.parametrize("seed", SEEDS)
def test_push_many_stable_equals_jax(seed, K, shared):
    """The general form, ``take`` any mask: slot count + r gets the r-th
    taken row; rows past the capacity are dropped and counted."""
    rng = np.random.default_rng(80 + seed)
    data, count = rand_queue(rng)
    jq, tq = queues(data, count)
    rows = rand_rows(rng, (K,) if shared else (C, K))
    take = rng.random((C, K)) < rng.random((C, 1))
    n_rows = jnp.int32(K) if shared else jnp.full((C,), K, jnp.int32)
    jobs_j = jQ.JobQueue(data=jnp.asarray(rows), count=n_rows)
    want = jax.vmap(jQ.push_many, in_axes=(0, None if shared else 0, 0))(
        jq, jobs_j, jnp.asarray(take))
    jobs_t = tQ.JobQueue(data=t_(rows), count=torch.full((C,), K,
                                                         dtype=torch.int32))
    got = tQ.push_many(tq, jobs_t, t_(take))
    eq(want.data, got.data)
    eq(want.count, got.count)
    eq(jax.vmap(jQ.push_many_dropped)(jq, jnp.asarray(take)),
       tQ.push_many_dropped(tq, t_(take)))
    if K == 40:
        assert int(tQ.push_many_dropped(tq, t_(take)).sum()) > 0


@pytest.mark.parametrize("n_res", [2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_can_lend_equals_jax(seed, n_res):
    """Lend's strict check: jobs sized exactly to a node's free cores or
    mem are refused there; the gpu axis stays >=."""
    rng = np.random.default_rng(90 + seed)
    cap, active = rand_nodes(rng, n_res)
    free = (cap * rng.random(cap.shape)).astype(np.int32)
    rows = rand_rows(rng, (C,), gpu_frac=0.3)
    node = rng.integers(0, cap.shape[1], C)
    exact = rng.random(C) < 0.5  # sized to a node's free cores and mem
    rows[exact, tQ.FCORES] = free[np.arange(C), node, 0][exact]
    rows[exact, tQ.FMEM] = free[np.arange(C), node, 1][exact]
    want = jax.vmap(jP.can_lend)(jnp.asarray(free), jnp.asarray(active),
                                 jQ.JobRec(vec=jnp.asarray(rows)))
    got = tP.can_lend(t_(free), t_(active), tQ.JobRec(vec=t_(rows)))
    eq(want, got)
    assert got.any() and not got.all()
    loose = tP.feasible(t_(free), t_(active), t_(rows[:, 1]), t_(rows[:, 2]),
                        t_(rows[:, 3])).any(dim=-1)
    assert (loose & ~got).any(), "no job fit only with >="


@pytest.mark.parametrize("block", [1, 2, 5])
def test_can_lend_every_lender_and_borrower_equals_jax(monkeypatch, block):
    """The borrow match's form, [C, 1, N, R] lenders against [C] probes,
    whatever the node block: one node a step, blocks that leave a ragged
    last one, the whole axis."""
    rng = np.random.default_rng(130 + block)
    cap, active = rand_nodes(rng, 3)
    free = (cap * rng.random(cap.shape)).astype(np.int32)
    rows = rand_rows(rng, (C,), gpu_frac=0.3)
    want = jax.vmap(lambda f, a: jax.vmap(
        lambda v: jP.can_lend(f, a, jQ.JobRec(vec=v)))(jnp.asarray(rows)))(
        jnp.asarray(free), jnp.asarray(active))
    monkeypatch.setattr(tP, "LEND_BLOCK", block * C * C)
    got = tP.can_lend(t_(free)[:, None], t_(active)[:, None],
                      tQ.JobRec(vec=t_(rows)))
    eq(want, got)
    assert got.any() and not got.all()


@pytest.mark.parametrize("M", [1, 3, S])
@pytest.mark.parametrize("seed", SEEDS)
def test_pack_returns_equals_jax(seed, M):
    """Borrower-owned (>= 0), own (-1) and FOREIGN (-2) rows; clusters with
    more due returns than M, and clusters with none."""
    rng = np.random.default_rng(100 + seed)
    t = 40_000
    cap, active = rand_nodes(rng, 2)
    data, act, _ = rand_runset(rng, cap, active, t)
    owner = rng.choice([-2, -1, 0, 3, C - 1], size=(C, S))
    owner[: C // 4] = -1  # no returns at all in a quarter of the clusters
    data[..., tR.ROWNER] = np.where(act, owner, -1)
    done = act & (data[..., tR.REND] <= t)
    want = jengine._pack_returns(
        jR.RunningSet(data=jnp.asarray(data), active=jnp.asarray(act)),
        jnp.asarray(done), M)
    got = tengine._pack_returns(tR.RunningSet(data=t_(data), active=t_(act)),
                                t_(done), M)
    for w, g in zip(want, got):
        eq(w, g)
    n_ret = (done & (data[..., tR.ROWNER] >= 0)).sum(1)
    assert (n_ret > M).any() == (M < S) and (n_ret == 0).any()
    assert (data[..., tR.ROWNER] == -2).any()


def borrowed_state(rng, cfg, n_clusters):
    """A JAX state whose BorrowedQueues hold random rows (some clusters
    empty, some full)."""
    data, count = rand_queue(rng)
    data, count = data[:n_clusters], count[:n_clusters]
    count[:3] = 0
    return jstate_with(cfg, n_clusters, borrowed=jQ.JobQueue(
        data=data, count=count)), data, count


@pytest.mark.parametrize("seed", SEEDS)
def test_deliver_returns_equals_jax(seed):
    """Messages that match a borrowed row (some twice, from two lenders),
    messages that match nothing, and messages to clusters whose
    BorrowedQueue is empty."""
    rng = np.random.default_rng(110 + seed)
    cfg = dataclasses.replace(BASE, queue_capacity=QCAP, max_running=16,
                              borrowing=True)
    M = 3
    jstate, data, count = borrowed_state(rng, cfg, C)
    rows = np.zeros((C, M, tR.RF), np.int32)
    take = rng.random((C, M)) < 0.6
    for c in range(C):
        for m in range(M):
            dst = int(rng.integers(0, C))
            rows[c, m, tR.ROWNER] = dst
            if count[dst] and rng.random() < 0.7:
                q = data[dst, rng.integers(0, count[dst])]
            else:  # no borrowed row equals it, or none to match
                q = rand_rows(rng, ())
            rows[c, m, [tR.RID, tR.RCORES, tR.RMEM, tR.RDUR]] = q[
                [tQ.FID, tQ.FCORES, tQ.FMEM, tQ.FDUR]]
    rows[1] = rows[0]  # the same messages twice
    take[1] = take[0]
    rows[2, 0, tR.ROWNER] = 0  # to a cluster with no borrowed rows
    take[2, 0] = True
    want = jengine._deliver_returns(jstate, jnp.asarray(rows),
                                    jnp.asarray(take), JLocalExchange())
    got = tengine._deliver_returns(port_of(jstate), t_(rows), t_(take),
                                   LocalExchange())
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    removed = int(count.sum() - got.borrowed.count.sum())
    assert removed > 0 and int(got.borrowed.count.sum()) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_borrow_match_equals_jax(seed):
    """Lenders with room for most probes, so that the lowest-index lender
    wins several borrowers in a tick and its LentQueue overflows; wanting
    clusters that could host their own job (self-lend excluded)."""
    rng = np.random.default_rng(120 + seed)
    cfg = dataclasses.replace(BASE, queue_capacity=QCAP, max_running=16,
                              borrowing=True)
    cap, active = rand_nodes(rng, 2)
    free = (cap * rng.uniform(0.2, 1.0, cap.shape)).astype(np.int32)
    wait, wcount = rand_queue(rng)
    lent, lcount = rand_queue(rng, full_frac=0.1)
    lcount[0] = QCAP - 2  # the lowest lender has room for two
    lent[0, :QCAP - 2] = rand_rows(rng, (QCAP - 2,))
    lent[0, QCAP - 2:] = jF.QUEUE_INVALID
    jstate, _, _ = borrowed_state(rng, cfg, C)
    jstate = jstate.replace(
        node_free=jnp.asarray(free[..., :2]),
        node_active=jnp.asarray(active),
        wait=jQ.JobQueue(data=jnp.asarray(wait), count=jnp.asarray(wcount)),
        lent=jQ.JobQueue(data=jnp.asarray(lent), count=jnp.asarray(lcount)))
    want_b = (wcount > 0) & (rng.random(C) < 0.8)
    jobs = wait[:, 0]
    out = jengine._borrow_match(jstate, jnp.asarray(want_b),
                                jQ.JobRec(vec=jnp.asarray(jobs)), cfg,
                                JLocalExchange())
    got = tengine._borrow_match(port_of(jstate), t_(want_b),
                                tQ.JobRec(vec=t_(jobs)), port_cfg(cfg),
                                LocalExchange())
    assert_leaves_equal(jax_leaves(out), interop.state_to_numpy(got))
    # the cases fired: a lender took several borrowers, a LentQueue
    # overflowed, and a wanting cluster could have hosted its own job
    lent_new = got.lent.count.numpy() - lcount
    assert lent_new.max() > 1
    assert int(got.drops.queue.sum()) > 0
    own = tP.can_lend(t_(free[..., :2]), t_(active), tQ.JobRec(vec=t_(jobs)))
    assert (own.numpy() & want_b).any()


@pytest.mark.parametrize("n_res", [2, 3])
def test_borrow_match_lends_gpu_jobs_as_jax(n_res):
    """The reference asks a lender for the wanting head's cores and mem
    only (its JobRec is made of those two, core/engine.py:540-543): a head
    demanding a gpu is lent wherever it fits on them, to gpu-less nodes
    and on the narrowed n_res=2 axis too."""
    rng = np.random.default_rng(130 + n_res)
    cfg = dataclasses.replace(BASE, queue_capacity=QCAP, max_running=16,
                              borrowing=True, n_res=n_res)
    cap, active = rand_nodes(rng, n_res)
    free = (cap * rng.uniform(0.2, 1.0, cap.shape)).astype(np.int32)
    wait = np.broadcast_to(np.asarray(jF.QUEUE_INVALID, np.int32),
                           (C, QCAP, jQ.NF)).copy()
    wait[:, 0] = rand_rows(rng, (C,), gpu_frac=1.0)
    wcount = np.ones(C, np.int32)
    jstate = jstate_with(cfg, C, node_free=free, node_active=active,
                         wait=jQ.JobQueue(data=wait, count=wcount))
    want_b = rng.random(C) < 0.8
    jobs = wait[:, 0]
    out = jengine._borrow_match(jstate, jnp.asarray(want_b),
                                jQ.JobRec(vec=jnp.asarray(jobs)), cfg,
                                JLocalExchange())
    got = tengine._borrow_match(port_of(jstate), t_(want_b),
                                tQ.JobRec(vec=t_(jobs)), port_cfg(cfg),
                                LocalExchange())
    assert_leaves_equal(jax_leaves(out), interop.state_to_numpy(got))
    lent = got.lent.data[..., tQ.FGPU][
        torch.arange(QCAP)[None, :] < got.lent.count[:, None]]
    assert int((lent > 0).sum()) > 0, "no gpu job was lent"


def test_local_exchange_equals_jax():
    x = np.arange(12, dtype=np.int32).reshape(4, 3) - 5
    j, t = JLocalExchange(), LocalExchange()
    for op in ("gather", "allmin"):
        eq(getattr(j, op)(jnp.asarray(x)), getattr(t, op)(t_(x)))
    eq(j.global_index(7), t.global_index(7))
    assert int(j.offset(7)) == t.offset(7) == 0


# --------------------------------------------------------------------------
# whole runs against the JAX engine (the oracle-parity scenarios and the
# reference's borrowing parity tests are in test_torch_borrow_oracle.py
# and test_torch_borrow_parity.py, so that the test workers share them)
# --------------------------------------------------------------------------

HEAVY = WorkloadConfig(poisson_lambda_per_min=40.0)
SCENARIO_CFG = dataclasses.replace(
    BASE, policy=PolicyKind.FIFO, borrowing=True, workload=HEAVY,
    queue_capacity=256)


@functools.lru_cache(maxsize=None)
def jax_runner(cfg):
    """The reference engine's jitted ``run`` for ``cfg``, built once per
    test process, so that the cases sharing a configuration (the fuzz
    seeds) share its compilation."""
    return jengine.Engine(cfg).run_jit()


def run_three(cfg, specs_j, specs_t, arr, n_ticks, chunks=None):
    """The JAX engine over the tick-indexed bucket and the port (in ragged
    chunks when given), on one stream."""
    ta = jengine.pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)
    want = jax_runner(cfg)(jinit_state(cfg, specs_j), ta, n_ticks)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    s0 = tstate.init_state(tcfg, specs_t, device="cpu")
    if chunks:
        got = eng.run_chunks(s0, tengine.pack_arrivals_chunks(
            port_arrivals(arr), chunks, tcfg.tick_ms))
    else:
        got = eng.run(s0, tengine.pack_arrivals_by_tick(
            port_arrivals(arr), n_ticks, tcfg.tick_ms), n_ticks)
    return want, got


# --------------------------------------------------------------------------
# run_io: the reference's stacked TickIO, and run_io == run
# --------------------------------------------------------------------------

def test_run_io_equals_jax_tickio():
    """tests/test_kernels.py:214 through the port: the states and every
    TickIO leaf — the return rows under a false ``ret_valid`` included —
    equal the reference's unfused run_io and its Pallas prefix's."""
    cfg, arr, specs_j = _tc_scenarios()["fifo_borrowing"]
    cfg = dataclasses.replace(cfg, record_metrics=False, record_trace=True,
                              max_trace_events=64)
    ta = jengine.pack_arrivals_by_tick(arr, 30, cfg.tick_ms)
    s0 = jinit_state(cfg, specs_j)
    rows, counts = ta.rows[:30], ta.counts[:30]
    refs = [jengine.Engine(c).run_io_jit()(s0, rows, counts) for c in (
        cfg, dataclasses.replace(cfg, fused="on", fused_block=1))]
    tcfg = port_cfg(cfg)
    specs_t = [tspec.uniform_cluster(1, 2, cores=16, memory=8_000),
               tspec.uniform_cluster(2, 10)]
    got_s, got_io = tengine.Engine(tcfg, device="cpu").run_io(
        tstate.init_state(tcfg, specs_t, device="cpu"), rows, counts)
    for want_s, want_io in refs:
        assert_leaves_equal(jax_leaves(want_s), interop.state_to_numpy(got_s))
        assert_leaves_equal(jax_leaves(want_io), interop.io_to_numpy(got_io))
    assert bool(got_io.borrow_want.any())
    assert bool(got_io.ret_valid.any()), "no return message crossed"
    assert got_io.ret_rows.shape == (30, 2, tcfg.max_msgs, tR.RF)


@pytest.mark.parametrize("borrowing", [False, True])
def test_run_io_chunks_equal_run(borrowing):
    """tests/test_pipeline.py:381 through the port: run_io over windows of
    1, 4, 8 and 7 ticks equals ``run`` over the same bucket, and JAX's
    run; each window's io is stacked per tick."""
    n_c = 3
    arr = _bursty_arrivals(n_c)
    cfg = _cfg(borrowing=borrowing)
    ta = jengine.pack_arrivals_by_tick(arr, N_TICKS, TICK_MS)
    want = jax_runner(cfg)(jinit_state(cfg, _specs(n_c)), ta, N_TICKS)
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu")
    specs_t = [tspec.uniform_cluster(c + 1, 5) for c in range(n_c)]
    ref = eng.run(tstate.init_state(tcfg, specs_t, device="cpu"),
                  tengine.pack_arrivals_by_tick(port_arrivals(arr), N_TICKS,
                                                TICK_MS), N_TICKS)
    s = tstate.init_state(tcfg, specs_t, device="cpu")
    off = 0
    for n in (1, 4, 8, 7):
        s2, io = eng.run_io(s, ta.rows[off:off + n], ta.counts[off:off + n])
        assert s2 is s, "run_io updates the state in place"
        assert io.borrow_want.shape == (n, n_c)
        assert io.ret_rows.shape[:2] == (n, n_c)
        off += n
    assert off == N_TICKS
    assert_leaves_equal(interop.state_to_numpy(ref),
                        interop.state_to_numpy(s))
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(s))
    assert int(s.placed_total.sum()) > 0


# --------------------------------------------------------------------------
# BASELINE config 2 with the trader cut, and a Level0 member
# --------------------------------------------------------------------------

def config2(**kw):
    """bench.py:898-933 bench_fifo_two_trader's config with the trader off
    (the JAX class)."""
    base = dict(policy=PolicyKind.FIFO, borrowing=True, queue_capacity=1024,
                max_running=512, max_arrivals=4096, max_nodes=10,
                workload=WorkloadConfig(poisson_lambda_per_min=30.0),
                trader=TraderConfig(enabled=False), record_trace=True,
                max_trace_events=512)
    base.update(kw)
    return SimConfig(**base)


def config2_specs(n_clusters):
    """Config 2's pair, tiled: small clusters even, big ones odd."""
    def make(mod):
        return [mod.uniform_cluster(c + 1, 5 if c % 2 == 0 else 10)
                for c in range(n_clusters)]
    return make(jspec), make(tspec)


@pytest.mark.parametrize("n_clusters,n_ticks,fused", [
    (2, 300, False), (16, 40, True)])
def test_config2_without_the_trader_equals_jax(n_clusters, n_ticks, fused):
    cfg = config2()
    specs_j, specs_t = config2_specs(n_clusters)
    arr = generate_arrivals(cfg.workload, n_clusters, 4096, 1_800_000, 32,
                            24_000, seed=9)
    jcfg = dataclasses.replace(cfg, fused="on", fused_block=8) if fused \
        else cfg
    ta = jengine.pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)
    want = jax_runner(jcfg)(jinit_state(cfg, specs_j), ta, n_ticks)
    tcfg = port_cfg(cfg)
    got = tengine.Engine(tcfg, device="cpu").run_chunks(
        tstate.init_state(tcfg, specs_t, device="cpu"),
        tengine.pack_arrivals_chunks(port_arrivals(arr),
                                     [n_ticks // 2, n_ticks - n_ticks // 2],
                                     tcfg.tick_ms))
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    ttrace.check_conservation(got)
    assert int(got.placed_total.sum()) > 0
    if not fused:  # the path borrowed
        assert int(got.borrowed.count.sum()) > 0


def test_level0_member_with_borrowing_equals_jax():
    """DELAY with borrowing on: every tick packs its (empty) returns and
    delivers them, and nothing borrows; the state equals the reference's."""
    cfg = dataclasses.replace(SCENARIO_CFG, policy=PolicyKind.DELAY,
                              queue_capacity=64)
    specs_j, specs_t = config2_specs(4)
    arr = generate_arrivals(cfg.workload, 4, cfg.max_arrivals, 80_000, 32,
                            24_000, seed=3)
    want, got = run_three(cfg, specs_j, specs_t, arr, 80)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert int(got.placed_total.sum()) > 0
    pset = PolicySet(("fifo", "delay"))
    tcfg = port_cfg(cfg)
    eng = tengine.Engine(tcfg, device="cpu", policies=pset)
    params = pset.params_for(tcfg, "delay")
    got2 = eng.run(tstate.init_state(tcfg, specs_t, device="cpu"),
                   tengine.pack_arrivals_by_tick(port_arrivals(arr), 80,
                                                 tcfg.tick_ms), 80, params)
    jset = jbase.PolicySet(("fifo", "delay"))
    want2 = jengine.Engine(cfg, policies=jset).run_jit()(
        jinit_state(cfg, specs_j),
        jengine.pack_arrivals_by_tick(arr, 80, cfg.tick_ms), 80,
        params=jset.params_for(cfg, "delay"))
    assert_leaves_equal(jax_leaves(want2), interop.state_to_numpy(got2))


def test_borrowing_provenance_and_emit_outputs():
    """A borrowing engine names the FIFO kernel's emit form; the plain
    path returns the emit outputs in the given buffers, and nothing in
    the terminal form."""
    tcfg = port_cfg(SCENARIO_CFG)
    eng = tengine.Engine(tcfg, device="cpu")
    prov = tfused.provenance(eng)
    assert prov["kernel"] == "fused_prefix_fifo_emit"
    assert prov["emit_returns"] and not eng.prefix_terminal()
    assert prov["source"].endswith("fused_prefix_fifo.cu")
    k = tfused.KERNELS["fused_prefix_fifo_emit"]
    assert k.lib == "fused_prefix_fifo" and k.emit
    specs_t = [tspec.uniform_cluster(1, 5), tspec.uniform_cluster(2, 5)]
    state = tstate.init_state(tcfg, specs_t, device="cpu")
    rows = torch.full((2, 1, tQ.NF), -1, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    host = tfused.host_params(eng, eng._default_params)
    out = tstate.empty_io((2,), eng.n_msgs(), "cpu")
    res = tfused.fused_prefix(eng, state, rows, counts, 1_000,
                              eng._default_params, host, emit_returns=True,
                              out=out)
    assert res[0] is state and res[1] is out.borrow_want
    assert res[3] is out.ret_rows and not out.ret_valid.any()
    assert tfused.fused_prefix(eng, state, rows, counts, 2_000,
                               eng._default_params, host)[1:] == (None,) * 5
    assert not any(tfused.launch_counts().values())
