"""The port's fault plane pieces against the JAX package, on the CPU.

``faults/schedule.py`` — jax's threefry ``fold_in``, the scalar bits and
``uniform(minval=1e-7)`` under ``jax.jit``, XLA's CPU f32 ``log`` written
out (over 2^20 uniforms and 2^20 arbitrary bit patterns), ``_exp_draws``
against ``jax.jit(jax.vmap(_exp_draws))`` (every node count, kind and
mean of the grid over counters 0-63, and over 2^20 draws at each of three
means), ``init_fault_state`` in both modes with and without ``eligible``,
``pack_fault_trace`` with its refusals, ``gather_event`` and ``reseed``;
``ops/runset.py kill``; ``faults/apply.py fault_phase_local`` against
``jax.vmap(fault_phase_local)`` on random states for both ingest targets
in both modes, ``next_fault_event_t`` and ``sig_parts``; the sinkhorn/cvx
tie-break table against ``jax.jit(_pair_jitter)``; and the fault leaves'
round trip through ``interop``. Bitwise throughout, dtypes included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import FaultConfig, PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.faults import apply as japply
from multi_cluster_simulator_tpu.faults import schedule as jsched
from multi_cluster_simulator_tpu.market import trader as jtrader
from multi_cluster_simulator_tpu.ops import runset as jR
from multi_cluster_simulator_tpu_torch import config as tconfig
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.faults import apply as tapply
from multi_cluster_simulator_tpu_torch.faults import schedule as tsched
from multi_cluster_simulator_tpu_torch.market import trader as ttrader
from multi_cluster_simulator_tpu_torch.ops import runset as tR
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg

NEVER = 2**31 - 1


def _keys(rng, n):
    return rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32)


def _bits_equal(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(want.view(np.int32) if want.dtype.kind
                                  == "f" else want,
                                  got.view(np.int32) if got.dtype.kind
                                  == "f" else got)


def jax_state_from_leaves(template, leaves: dict):
    """A JAX state shaped like ``template`` with the leaves keyed by path."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves[jax.tree_util.keystr(p)]) for p, _ in flat])


# --------------------------------------------------------------------------
# the draw primitives
# --------------------------------------------------------------------------

def test_fold_in_equals_jax_in_torch_and_numpy():
    rng = np.random.default_rng(0)
    keys = _keys(rng, 4096)
    data = rng.integers(-2**31, 2**31, size=4096).astype(np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                                   jnp.asarray(data)))
    k = torch.from_numpy(keys.astype(np.int64))
    g0, g1 = tsched.fold_in(k[:, 0], k[:, 1],
                            torch.from_numpy(data.astype(np.int64)))
    _bits_equal(want, torch.stack([g0, g1], 1).to(torch.uint32).numpy())
    n0, n1 = tsched.fold_in(keys[:, 0].astype(np.int64),
                            keys[:, 1].astype(np.int64), data.astype(np.int64))
    _bits_equal(want, np.stack([n0, n1], 1).astype(np.uint32))
    # PRNGKey(seed) is (0, seed): the per-cluster keys of init
    _bits_equal(np.asarray(jax.vmap(lambda c: jax.random.fold_in(
        jax.random.PRNGKey(29), c))(jnp.arange(64, dtype=jnp.int32))),
        tsched.cluster_keys(29, 64).numpy())


def test_scalar_bits_equal_jax_random_bits():
    keys = _keys(np.random.default_rng(1), 4096)
    want = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(
        jnp.asarray(keys))
    k = torch.from_numpy(keys.astype(np.int64))
    _bits_equal(want, tsched.random_bits(k[:, 0], k[:, 1]).to(
        torch.uint32).numpy())


@functools.cache
def _jit_uniform():
    return jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float32, 1e-7, 1.0)))


def test_uniform_scalar_equals_jit_uniform():
    keys = _keys(np.random.default_rng(2), 1 << 16)
    k = torch.from_numpy(keys.astype(np.int64))
    _bits_equal(_jit_uniform()(jnp.asarray(keys)),
                tsched.uniform_scalar(k[:, 0], k[:, 1]).numpy())


def test_xla_log_equals_jit_log_on_a_million_uniforms():
    """The draws' own inputs: 2^20 uniforms of [1e-7, 1), where torch.log
    and the correctly rounded log differ from XLA's on ~15% of them."""
    u = np.asarray(_jit_uniform()(jnp.asarray(
        _keys(np.random.default_rng(3), 1 << 20))))
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(u)))
    got = tsched.xla_log_f32(torch.from_numpy(u.copy())).numpy()
    _bits_equal(want, got)
    assert (np.log(u).view(np.int32) != want.view(np.int32)).sum() > 10_000


def test_xla_log_equals_jit_log_on_any_bits():
    """Every class of f32: normals of both signs, subnormals (read as zero
    by the compiled code), zeros, infinities and NaNs."""
    x = np.random.default_rng(4).integers(
        0, 2**32, size=1 << 20, dtype=np.uint64).astype(np.uint32).view(
            np.float32)
    x = np.concatenate([x, np.float32([0, -0.0, np.inf, -np.inf, np.nan, 1,
                                       1e-45, -1e-40, 1.1754944e-38])])
    _bits_equal(jax.jit(jnp.log)(jnp.asarray(x)),
                tsched.xla_log_f32(torch.from_numpy(x.copy())).numpy())


@functools.cache
def _jit_exp_draws(kind, mean):
    return jax.jit(jax.vmap(lambda k, c: jsched._exp_draws(k, c, kind,
                                                           mean)))


@pytest.mark.parametrize("mean", [4_000, 60_000, 600_000])
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("N", [5, 9, 14])
def test_exp_draws_equal_jax(N, kind, mean):
    """Every node of every cluster at every counter 0-63."""
    C = 64
    keys = _keys(np.random.default_rng(100 + N), C)
    counters = ((np.arange(C)[:, None] * 7 + np.arange(N)[None, :])
                % 64).astype(np.int32)
    want = _jit_exp_draws(kind, mean)(jnp.asarray(keys), jnp.asarray(counters))
    got = tsched._exp_draws(torch.from_numpy(keys),
                            torch.from_numpy(counters), kind, mean)
    _bits_equal(want, got.numpy())


@pytest.mark.parametrize("mean,kind", [(4_000, 1), (60_000, 0),
                                       (600_000, 1)])
def test_exp_draws_equal_jax_over_a_million_draws(mean, kind):
    """2^20 draws at each mean (65,536 clusters x 16 nodes, counters
    0-63), both kinds."""
    rng = np.random.default_rng(mean)
    keys = _keys(rng, 1 << 16)
    counters = rng.integers(0, 64, size=(1 << 16, 16)).astype(np.int32)
    want = np.asarray(_jit_exp_draws(kind, mean)(jnp.asarray(keys),
                                                 jnp.asarray(counters)))
    got = tsched._exp_draws(torch.from_numpy(keys),
                            torch.from_numpy(counters), kind, mean).numpy()
    _bits_equal(want, got)
    assert (want > 1).mean() > 0.99


# --------------------------------------------------------------------------
# making the fault state
# --------------------------------------------------------------------------

def _fc(mode="generative", **kw):
    base = dict(enabled=True, mode=mode, mttf_ms=20_000, mttr_ms=4_000,
                seed=5, max_retries=8, max_events=4)
    base.update(kw)
    return FaultConfig(**base)


EVENTS = [(0, 1, 5_000, 8_000), (0, 1, 1_000, 2_000), (2, 4, 7_000, 7_000),
          (3, 0, 9_000, 3_000), (1, 2, 0, 60_000)]


@pytest.mark.parametrize("eligible", [False, True], ids=["all", "eligible"])
@pytest.mark.parametrize("mode", ["generative", "trace", "off"])
def test_init_fault_state_equals_jax(mode, eligible):
    C, N = 6, 9
    fc = _fc("generative") if mode == "off" else _fc(mode)
    if mode == "off":
        fc = dataclasses.replace(fc, enabled=False)
    elig = None
    if eligible:
        elig = np.random.default_rng(5).random((C, N)) < 0.6
    events = EVENTS if mode == "trace" else None
    want = jsched.init_fault_state(fc, C, N, events=events, eligible=elig)
    got = tsched.init_fault_state(port_cfg(SimConfig(faults=fc)).faults, C,
                                  N, events=events, eligible=elig,
                                  device="cpu")
    assert_leaves_equal(jax_leaves(want), interop.to_numpy(got))
    ptrs = {x.data_ptr() for _, x in leaves_with_keys(got)}
    assert len(ptrs) == 12  # every leaf a tensor of its own
    if mode == "generative":
        nf = got.next_fail.numpy()
        assert (nf < NEVER).any()
        if eligible:
            assert (nf[~elig] == NEVER).all()


def test_trace_mode_needs_events():
    with pytest.raises(ValueError, match="event list"):
        tsched.init_fault_state(_fc("trace"), 2, 5, device="cpu")


def test_pack_fault_trace_equals_jax_and_refuses_what_it_refuses():
    for events in (EVENTS, [], [(1, 3, 10, 5)]):
        want = jsched.pack_fault_trace(events, 4, 5, 3)
        got = tsched.pack_fault_trace(events, 4, 5, 3)
        for w, g in zip(want, got):
            _bits_equal(w, g)
    for bad, match in (([(4, 0, 1, 2)], "outside"), ([(0, 5, 1, 2)],
                                                      "outside"),
                       ([(0, 0, k, k + 1) for k in range(4)], "max_events")):
        with pytest.raises(ValueError, match=match):
            jsched.pack_fault_trace(bad, 4, 5, 3)
        with pytest.raises(ValueError, match=match):
            tsched.pack_fault_trace(bad, 4, 5, 3)


def test_gather_event_equals_jax():
    rng = np.random.default_rng(6)
    table = np.sort(rng.integers(0, 10**6, (8, 9, 4)), -1).astype(np.int32)
    cursor = rng.integers(0, 7, (8, 9)).astype(np.int32)
    want = jax.vmap(jsched.gather_event)(jnp.asarray(table),
                                          jnp.asarray(cursor))
    _bits_equal(want, tsched.gather_event(torch.from_numpy(table),
                                          torch.from_numpy(cursor)).numpy())


@pytest.mark.parametrize("eligible", [False, True], ids=["all", "eligible"])
def test_reseed_equals_jax(eligible):
    C, N = 5, 9
    fc = _fc()
    elig = np.random.default_rng(7).random((C, N)) < 0.5 if eligible \
        else None
    root = np.array(jax.random.PRNGKey(1234))
    js = jsched.init_fault_state(fc, C, N)
    # a used state: counters and outages that reseed must clear
    js = js.replace(n_fails=js.n_fails + 3, kills=js.kills + 2,
                    health=js.health.at[0, 1].set(False))
    ts = tsched.FaultState(**{k[1:]: torch.from_numpy(np.array(v))
                              for k, v in jax_leaves(js).items()})
    want = jsched.reseed(js, jnp.asarray(root), fc, elig)
    got = tsched.reseed(ts, torch.from_numpy(root), fc, elig)
    assert_leaves_equal(jax_leaves(want), interop.to_numpy(got))


def test_kill_equals_jax():
    rng = np.random.default_rng(8)
    C, S = 6, 12
    data = rng.integers(0, 50, (C, S, tR.RF)).astype(np.int32)
    active = rng.random((C, S)) < 0.7
    dead = rng.random((C, S)) < 0.5
    want = jax.vmap(jR.kill)(jR.RunningSet(data=jnp.asarray(data),
                                           active=jnp.asarray(active)),
                             jnp.asarray(dead))
    got = tR.kill(tR.RunningSet(data=torch.from_numpy(data),
                                active=torch.from_numpy(active)),
                  torch.from_numpy(dead))
    _bits_equal(want.data, got.data.numpy())
    _bits_equal(want.active, got.active.numpy())


# --------------------------------------------------------------------------
# the fault phase on random states
# --------------------------------------------------------------------------

PHASE_T = 40_000


@functools.cache
def _phase_base(mode):
    """A JAX state after 30 ticks of churn: real running sets and queues."""
    fc = _fc(mode, mttf_ms=8_000, mttr_ms=3_000)
    cfg = SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                    queue_capacity=8, max_running=32, max_arrivals=60,
                    max_ingest_per_tick=8, max_nodes=5, max_virtual_nodes=0,
                    faults=fc)
    from multi_cluster_simulator_tpu.workload.traces import uniform_stream

    C = 12
    arr = uniform_stream(C, 60, 30_000, max_cores=4, max_mem=2_000,
                         max_dur_ms=60_000, seed=11)
    events = [(c, n, 1_000 * (c + n), 1_000 * (c + n) + 2_000)
              for c in range(C) for n in range(5)] if mode == "trace" \
        else None
    s = jengine.Engine(cfg).run_jit()(
        jinit_state(cfg, [uniform_cluster(c + 1, 5) for c in range(C)],
                    fault_events=events),
        jengine.pack_arrivals_by_tick(arr, 30, cfg.tick_ms), 30)
    return cfg, s


def _random_phase_state(rng, cfg, js):
    """``js`` with random fault leaves (failures and repairs due at
    PHASE_T, outages open, counters and keys), random owners (own, carve
    placeholder, a peer) and retry budgets on the running rows, and
    Level0, ReadyQueue and LentQueue counts near their capacity."""
    leaves = jax_leaves(js)
    C, N = leaves[".faults.health"].shape
    t = PHASE_T
    health = rng.random((C, N)) < 0.7
    due = rng.random((C, N)) < 0.5
    nf = np.where(due, t - rng.integers(0, 1_000, (C, N)),
                  t + rng.integers(1, 5_000, (C, N)))
    du = np.where(rng.random((C, N)) < 0.5, t - rng.integers(0, 500, (C, N)),
                  t + rng.integers(1, 5_000, (C, N)))
    leaves[".faults.health"] = health
    leaves[".faults.next_fail"] = np.where(health, nf, NEVER).astype(np.int32)
    leaves[".faults.down_until"] = np.where(health, NEVER, du).astype(
        np.int32)
    leaves[".faults.down_since"] = np.where(
        health, 0, t - rng.integers(0, 20_000, (C, N))).astype(np.int32)
    leaves[".faults.n_fails"] = rng.integers(0, 3, (C, N)).astype(np.int32)
    leaves[".faults.was_active"] = rng.random((C, N)) < 0.8
    leaves[".faults.kills"] = rng.integers(0, 9, C).astype(np.int32)
    if cfg.faults.mode != "trace":
        leaves[".faults.key"] = _keys(rng, C)
    run = leaves[".run.data"].copy()
    S = run.shape[1]
    owner = rng.choice([-1, -1, -2, 3, 0], size=(C, S))
    run[..., tR.ROWNER] = owner
    run[..., tR.RRETRIES] = rng.integers(
        0, cfg.faults.max_retries + 2, (C, S))
    leaves[".run.data"] = run.astype(np.int32)
    cap = cfg.queue_capacity
    for q in ("l0", "ready", "lent"):
        count = rng.integers(cap - 3, cap + 1, C).astype(np.int32)
        data = leaves[f".{q}.data"].copy()
        live = np.arange(cap)[None, :] < count[:, None]
        data[live] = rng.integers(1, 40, (int(live.sum()), data.shape[-1]))
        leaves[f".{q}.data"] = data.astype(np.int32)
        leaves[f".{q}.count"] = count
    return leaves


@functools.cache
def _jit_phase(cfg, to_delay):
    return jax.jit(jax.vmap(
        functools.partial(japply.fault_phase_local, cfg=cfg,
                          to_delay=to_delay),
        in_axes=(jengine._STATE_AXES, None), out_axes=jengine._STATE_AXES))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("to_delay", [False, True], ids=["ready", "level0"])
@pytest.mark.parametrize("mode", ["generative", "trace"])
def test_fault_phase_equals_jax(mode, to_delay, seed):
    cfg, base = _phase_base(mode)
    leaves = _random_phase_state(np.random.default_rng(seed), cfg, base)
    js = jax_state_from_leaves(base, leaves)
    ts = interop.state_from_numpy(leaves, device="cpu")
    want = _jit_phase(cfg, to_delay)(js, jnp.int32(PHASE_T))
    got = tapply.fault_phase_local(ts, PHASE_T, port_cfg(cfg), to_delay)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    fs = got.faults
    assert int((fs.kills - ts.faults.kills).sum()) > 0
    assert int(got.drops.failed.sum()) > 0
    assert int(got.drops.queue.sum()) > 0
    assert int((fs.n_fails - ts.faults.n_fails).sum()) > 0
    assert int(got.lent.count.sum()) >= int(ts.lent.count.sum())


def test_next_fault_event_and_sig_parts_equal_jax():
    cfg, base = _phase_base("generative")
    leaves = _random_phase_state(np.random.default_rng(9), cfg, base)
    js = jax_state_from_leaves(base, leaves)
    ts = interop.state_from_numpy(leaves, device="cpu")
    _bits_equal(jax.jit(japply.next_fault_event_t)(js.faults),
                tapply.next_fault_event_t(ts.faults).numpy())
    for w, g in zip(jax.jit(japply.sig_parts)(js),
                    tapply.sig_parts(ts)):
        _bits_equal(w, g.numpy())


def test_fault_leaves_round_trip_through_interop():
    """The generative keys (uint32, values past 2^31 included) cross from
    the JAX state into the port's and back by path."""
    cfg, base = _phase_base("generative")
    leaves = jax_leaves(base)
    assert leaves[".faults.key"].dtype == np.uint32
    assert (leaves[".faults.key"] >= 2**31).any()
    ts = interop.state_from_numpy(leaves, device="cpu")
    assert ts.faults.key.dtype == torch.uint32
    assert_leaves_equal(leaves, interop.state_to_numpy(ts))


# --------------------------------------------------------------------------
# the sinkhorn/cvx tie-break table
# --------------------------------------------------------------------------

@pytest.mark.parametrize("C", [2, 16, 64, 72, 73, 256, 4096])
def test_pair_jitter_equals_jit_pair_jitter(C):
    """Bitwise at every width: the vectorized argument from 72 buyers on,
    glibc's sinf, and the f32 product, modf and abs."""
    want = jax.jit(jtrader._pair_jitter, static_argnums=1)(
        jnp.arange(C, dtype=jnp.int32), C)
    _bits_equal(want, ttrader.pair_jitter(0, C, C, "cpu").numpy())


def test_pair_jitter_of_a_shard_equals_jax():
    """Rows from a global seller offset, as a shard of the mesh holds."""
    want = jax.jit(jtrader._pair_jitter, static_argnums=1)(
        jnp.arange(100, 150, dtype=jnp.int32), 300)
    _bits_equal(want, ttrader.pair_jitter(100, 50, 300, "cpu").numpy())


def test_fault_config_matches_the_reference():
    assert dataclasses.asdict(tconfig.FaultConfig()) == dataclasses.asdict(
        FaultConfig())
