"""Each ported queue, running-set and placement op against the JAX op under
``jax.vmap``, bitwise, on seeded random batches that are consistent:
counts within capacity with INVALID rows past them, ``free <= cap``, and
running rows whose resources are exactly what ``node_free`` is missing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.ops import fields as jF
from multi_cluster_simulator_tpu.ops import placement as jP
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.ops import runset as jR
from multi_cluster_simulator_tpu_torch.ops import placement as tP
from multi_cluster_simulator_tpu_torch.ops import queues as tQ
from multi_cluster_simulator_tpu_torch.ops import runset as tR

C, QCAP, S, N = 24, 8, 16, 5
SEEDS = [0, 1, 2]


def t_(a):
    return torch.from_numpy(np.array(a, copy=True))


def eq(want, got):
    """Bitwise equality of a JAX result and a torch result, dtype too."""
    w, g = np.asarray(want), got.numpy()
    assert w.dtype == g.dtype, (w.dtype, g.dtype)
    np.testing.assert_array_equal(w, g)


def rand_rows(rng, shape, gpu_frac=0.0):
    """Valid queue rows [*shape, NF]: small demands, a gpu-demanding
    fraction to exercise the n_res=2 fail-closed rule."""
    cores = rng.integers(0, 13, shape)
    gpu = (rng.random(shape) < gpu_frac).astype(np.int64)
    vals = {"id": rng.integers(0, 10_000, shape), "cores": cores,
            "mem": rng.integers(0, 8_000, shape), "gpu": gpu,
            "dur": rng.integers(0, 20_000, shape),
            "enq_t": rng.integers(0, 50_000, shape),
            "owner": np.full(shape, -1), "rec_wait": np.zeros(shape),
            "jclass": jF.job_class(cores, gpu),
            "retries": rng.integers(0, 3, shape)}
    return np.stack([vals[n] for n in jF.QUEUE_FIELDS], -1).astype(np.int32)


def rand_queue(rng, full_frac=0.25):
    count = rng.integers(0, QCAP + 1, C).astype(np.int32)
    count[rng.random(C) < full_frac] = QCAP
    data = np.broadcast_to(np.asarray(jF.QUEUE_INVALID, np.int32),
                           (C, QCAP, jQ.NF)).copy()
    rows = rand_rows(rng, (C, QCAP))
    live = np.arange(QCAP)[None, :] < count[:, None]
    data[live] = rows[live]
    return data, count


def queues(data, count):
    return (jQ.JobQueue(data=jnp.asarray(data), count=jnp.asarray(count)),
            tQ.JobQueue(data=t_(data), count=t_(count)))


def rand_nodes(rng, n_res):
    cap = np.zeros((C, N, n_res), np.int32)
    cap[..., 0], cap[..., 1] = 32, 24_000
    if n_res == 3:
        cap[..., 2] = rng.integers(0, 3, (C, N))
    active = rng.random((C, N)) < 0.85
    return cap, active


def rand_runset(rng, cap, active, t):
    """Running rows on active nodes that fit the capacity; ``free`` is
    capacity minus what they hold."""
    n_res = cap.shape[-1]
    data = np.broadcast_to(np.asarray(jF.RUN_INVALID, np.int32),
                           (C, S, jR.RF)).copy()
    act = np.zeros((C, S), bool)
    free = cap.copy()
    for c in range(C):
        for s in range(S):
            node = int(rng.integers(0, N))
            cores, mem = int(rng.integers(0, 9)), int(rng.integers(0, 5_000))
            if (rng.random() < 0.6 and active[c, node]
                    and free[c, node, 0] >= cores and free[c, node, 1] >= mem):
                free[c, node, 0] -= cores
                free[c, node, 1] -= mem
                end = t + int(rng.integers(-3_000, 3_000))
                data[c, s] = [end, node, cores, mem, 0, s, -1, 1_000,
                              t - 5_000, 0]
                act[c, s] = True
    return data, act, free[..., :n_res]


@pytest.mark.parametrize("seed", SEEDS)
def test_head_select_rows_prefix(seed):
    rng = np.random.default_rng(seed)
    jq, tq = queues(*rand_queue(rng))
    eq(jax.vmap(jQ.head)(jq).vec, tQ.head(tq).vec)
    hot = np.zeros((C, QCAP), bool)
    hot[np.arange(C), rng.integers(0, QCAP, C)] = True
    hot[rng.random(C) < 0.2] = False  # no row selected: a zero row
    eq(jax.vmap(jQ.select_row)(jq, jnp.asarray(hot)).vec,
       tQ.select_row(tq, t_(hot)).vec)
    eq(jax.vmap(lambda q: jQ.rows_prefix(q, 5))(jq), tQ.rows_prefix(tq, 5))


@pytest.mark.parametrize("seed", SEEDS)
def test_push_back_and_drop_count(seed):
    rng = np.random.default_rng(seed)
    jq, tq = queues(*rand_queue(rng))
    rows = rand_rows(rng, (C,))
    do = rng.random(C) < 0.7
    jout = jax.vmap(jQ.push_back)(jq, jQ.JobRec(vec=jnp.asarray(rows)),
                                  jnp.asarray(do))
    tout = tQ.push_back(tq, tQ.JobRec(vec=t_(rows)), t_(do))
    eq(jout.data, tout.data)
    eq(jout.count, tout.count)
    eq(jax.vmap(jQ.push_back_dropped)(jq, jnp.asarray(do)),
       tQ.push_back_dropped(tq, t_(do)))


@pytest.mark.parametrize("K", [1, 4, 13])
@pytest.mark.parametrize("seed", SEEDS)
def test_push_many_prefix_and_drop_count(seed, K):
    rng = np.random.default_rng(seed)
    jq, tq = queues(*rand_queue(rng))
    rows = rand_rows(rng, (C, K))
    cnt = rng.integers(0, K + 1, C).astype(np.int32)
    take = np.arange(K)[None, :] < cnt[:, None]
    jb = jQ.JobQueue(data=jnp.asarray(rows), count=jnp.asarray(cnt))
    jout = jax.vmap(lambda q, b, tk: jQ.push_many(q, b, tk, prefix=True))(
        jq, jb, jnp.asarray(take))
    tout = tQ.push_many(tq, tQ.JobQueue(data=t_(rows), count=t_(cnt)),
                        t_(take), prefix=True)
    eq(jout.data, tout.data)
    eq(jout.count, tout.count)
    eq(jax.vmap(jQ.push_many_dropped)(jq, jnp.asarray(take)),
       tQ.push_many_dropped(tq, t_(take)))


@pytest.mark.parametrize("seed", SEEDS)
def test_pop_front_and_pop_front_n(seed):
    rng = np.random.default_rng(seed)
    jq, tq = queues(*rand_queue(rng))
    do = rng.random(C) < 0.6
    jout = jax.vmap(jQ.pop_front)(jq, jnp.asarray(do))
    tout = tQ.pop_front(tq, t_(do))
    eq(jout.data, tout.data)
    eq(jout.count, tout.count)
    # per-cluster shifts, past the count and negative ones included
    n = rng.integers(-2, QCAP + 3, C).astype(np.int32)
    jout = jax.vmap(jQ.pop_front_n)(jq, jnp.asarray(n))
    tout = tQ.pop_front_n(tq, t_(n))
    eq(jout.data, tout.data)
    eq(jout.count, tout.count)


@pytest.mark.parametrize("n_res", [2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_release(seed, n_res):
    rng = np.random.default_rng(seed)
    t = 40_000
    cap, active = rand_nodes(rng, n_res)
    data, act, free = rand_runset(rng, cap, active, t)
    jrs = jR.RunningSet(data=jnp.asarray(data), active=jnp.asarray(act))
    trs = tR.RunningSet(data=t_(data), active=t_(act))
    jout = jax.vmap(jR.release, in_axes=(0, 0, None))(
        jrs, jnp.asarray(free), jnp.int32(t))
    tout = tR.release(trs, t_(free), t)
    eq(jout[0].data, tout[0].data)
    eq(jout[0].active, tout[0].active)
    eq(jout[1], tout[1])
    eq(jout[2], tout[2])
    assert tout[2].any(), "vacuous: nothing released"


@pytest.mark.parametrize("M", [1, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_row_from_job_and_start_many(seed, M):
    rng = np.random.default_rng(seed)
    t = 40_000
    cap, active = rand_nodes(rng, 2)
    data, act, _ = rand_runset(rng, cap, active, t)
    jobs = rand_rows(rng, (C, M))
    nodes = rng.integers(0, N, (C, M)).astype(np.int32)
    jrows = jax.vmap(jax.vmap(lambda v, n: jR.row_from_job(
        jQ.JobRec(vec=v), n, jnp.int32(t))))(jnp.asarray(jobs),
                                             jnp.asarray(nodes))
    trows = tR.row_from_job(tQ.JobRec(vec=t_(jobs)), t_(nodes), t)
    eq(jrows, trows)
    free_slots = (~act).sum(1)
    n_take = np.minimum(rng.integers(0, M + 1, C), free_slots).astype(np.int32)
    jrs = jR.RunningSet(data=jnp.asarray(data), active=jnp.asarray(act))
    jout = jax.vmap(jR.start_many)(jrs, jrows, jnp.asarray(n_take))
    tout = tR.start_many(tR.RunningSet(data=t_(data), active=t_(act)),
                         trows, t_(n_take))
    eq(jout.data, tout.data)
    eq(jout.active, tout.active)


@pytest.mark.parametrize("n_res", [2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_feasible_first_fit_occupy(seed, n_res):
    rng = np.random.default_rng(seed)
    cap, active = rand_nodes(rng, n_res)
    free = (cap * rng.random(cap.shape)).astype(np.int32)
    jobs = rand_rows(rng, (C,), gpu_frac=0.2)
    jj, tj = jQ.JobRec(vec=jnp.asarray(jobs)), tQ.JobRec(vec=t_(jobs))
    jfeas = jax.vmap(lambda f, a, j: jP.feasible(f, a, j.cores, j.mem,
                                                 j.gpu))(
        jnp.asarray(free), jnp.asarray(active), jj)
    eq(jfeas, tP.feasible(t_(free), t_(active), tj.cores, tj.mem, tj.gpu))
    jnode = jax.vmap(jP.first_fit)(jnp.asarray(free), jnp.asarray(active), jj)
    tnode = tP.first_fit(t_(free), t_(active), tj)
    eq(jnode, tnode)
    assert (tnode.numpy() < 0).any() and (tnode.numpy() >= 0).any()
    do = rng.random(C) < 0.8
    eq(jax.vmap(jP.occupy)(jnp.asarray(free), jnode, jj, jnp.asarray(do)),
       tP.occupy(t_(free), tnode, tj, t_(do)))
