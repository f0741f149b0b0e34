"""The port's trader market ops, its greedy round and vnode expiry against
the JAX package, on the CPU.

Per op, against the JAX function under ``jax.jit`` (and ``jax.vmap``
where the reference writes it per cluster), so that the reference's
floats round as its compiled code rounds them: ``carve_plan`` in both
modes (the ``test_market.py`` carve cases and a seeded fuzz), the three
contract sizings (the as-built time-reset quirk, the budget stop with
non-zero costs, the empty queue, Q = 1,024),
``snapshot_utilization``/``avg_wait_ms``, ``_expire_vnodes_local``,
``_pair_feasibility``/``_pair_value`` and ``_pair_jitter``. Bitwise
throughout (the jitter at every width: tests/test_torch_faults.py pins it
up to 4,096 clusters). Then the greedy
round on states a run has reached, and whole runs: BASELINE config 2 with
the trader on (expiry off and on) over 600 ticks, every leaf bitwise, and
a trader run with expiry through ``run_io``, state and stacked TickIO
equal to the reference's unfused and Pallas-interpret runs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import (
    PolicyKind, SimConfig, TraderConfig,
)
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core import state as jst
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.kernels import fused_tick as jfused
from multi_cluster_simulator_tpu.market import trader as jtrader
from multi_cluster_simulator_tpu.ops import carve as jcarve
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.ops import runset as jR
from multi_cluster_simulator_tpu.ops import sizing as jsizing
from multi_cluster_simulator_tpu.parallel.exchange import (
    LocalExchange as JLocalExchange,
)
from multi_cluster_simulator_tpu.workload.generator import generate_arrivals
from multi_cluster_simulator_tpu_torch import config as tconfig
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.kernels import fused_tick as tfused
from multi_cluster_simulator_tpu_torch.market import trader as ttrader
from multi_cluster_simulator_tpu_torch.ops import carve as tcarve
from multi_cluster_simulator_tpu_torch.ops import queues as tQ
from multi_cluster_simulator_tpu_torch.ops import sizing as tsizing
from multi_cluster_simulator_tpu_torch.parallel.exchange import LocalExchange
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.test_pipeline import TC_TICKS, _tc_scenarios
from tests.test_torch_borrow import config2, config2_specs, jax_runner
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import (
    assert_leaves_equal, jax_leaves, port_cfg,
)
from tests.test_torch_ops import eq, rand_rows, t_

SEEDS = [0, 1, 2]


def _contract_eq(want, got):
    for f in ("cores", "mem", "gpu", "time_ms", "price"):
        eq(getattr(want, f), getattr(got, f))


# --------------------------------------------------------------------------
# carve_plan
# --------------------------------------------------------------------------

# tests/test_market.py TestCarve: (free, active, request, mode)
CARVE_CASES = [
    ([[8, 50, 0], [4, 50, 0], [0, 0, 0]], [True] * 3, (10, 0, 0), "asbuilt"),
    ([[8, 50, 0], [4, 50, 0]], [True] * 2, (10, 60, 0), "sane"),
    ([[2, 5, 0]], [True], (10, 0, 0), "sane"),
]


@functools.lru_cache(maxsize=None)
def _jcarve(mode):
    return jax.jit(jax.vmap(functools.partial(jcarve.carve_plan,
                                              mode=mode)))


def _carve_both(free, active, req, mode):
    want = _jcarve(mode)(jnp.asarray(free), jnp.asarray(active),
                         *(jnp.asarray(r) for r in req))
    got = tcarve.carve_plan(t_(free), t_(active), *(t_(r) for r in req),
                            mode)
    return want, got


@pytest.mark.parametrize("case", range(len(CARVE_CASES)))
def test_carve_cases_equal_jax(case):
    free, active, req, mode = CARVE_CASES[case]
    free = np.asarray([free], np.int32)
    active = np.asarray([active])
    req = [np.asarray([r], np.int32) for r in req]
    (wa, wok), (ga, gok) = _carve_both(free, active, req, mode)
    eq(wa, ga)
    eq(wok, gok)


@pytest.mark.parametrize("mode", ["asbuilt", "sane"])
@pytest.mark.parametrize("seed", SEEDS)
def test_carve_fuzz_equals_jax(seed, mode):
    """Free amounts around the requests (zero and negative included),
    inactive slots, zero requests on some axes."""
    rng = np.random.default_rng(200 + seed)
    C, N = 64, 9
    free = rng.integers(-2, 40, (C, N, 3)).astype(np.int32)
    free[..., 1] *= 600
    active = rng.random((C, N)) < 0.8
    req = [rng.integers(0, 80, C), rng.integers(0, 50_000, C),
           rng.integers(0, 6, C) * (rng.random(C) < 0.5)]
    req = [r.astype(np.int32) for r in req]
    (wa, wok), (ga, gok) = _carve_both(free, active, req, mode)
    eq(wa, ga)
    eq(wok, gok)
    assert int(gok.sum()) > 0
    if mode == "sane":  # the as-built walk succeeds on most draws
        assert int(gok.sum()) < C


# --------------------------------------------------------------------------
# contract sizing
# --------------------------------------------------------------------------

SIZINGS = ["fast_node_contract", "small_node_contract_asbuilt",
           "small_node_contract_sane"]


@functools.lru_cache(maxsize=None)
def _jsizing(name, budget, cc, mc):
    fn = getattr(jsizing, name)
    return jax.jit(jax.vmap(lambda q: fn(q, jnp.float32(budget),
                                         jnp.float32(cc), jnp.float32(mc))))


def _sizing_both(name, data, count, budget=-1.0, cc=0.0, mc=0.0):
    want = _jsizing(name, budget, cc, mc)(
        jQ.JobQueue(data=jnp.asarray(data), count=jnp.asarray(count)))
    got = getattr(tsizing, name)(tQ.JobQueue(data=t_(data), count=t_(count)),
                                 budget, cc, mc)
    return want, got


def _l1(jobs, Q=16):
    """One cluster's Level1 holding ``jobs`` (cores, mem, dur)."""
    data = np.broadcast_to(np.asarray(jQ.empty(1).data[0, 0]),
                           (1, Q, jQ.NF)).copy()
    for i, (c, m, d) in enumerate(jobs):
        data[0, i, jQ.FCORES], data[0, i, jQ.FMEM] = c, m
        data[0, i, jQ.FDUR] = d
        data[0, i, jQ.FID] = i
    return data, np.asarray([len(jobs)], np.int32)


@pytest.mark.parametrize("name", SIZINGS)
def test_sizing_cases_equal_jax(name):
    """tests/test_market.py TestSizing's queues: the as-built time reset
    (9 s then 5 s: the time falls to 0), the budget stop, and the empty
    queue's zero contract."""
    cases = [(_l1([(2, 100, 5000), (3, 200, 9000), (1, 50, 2000)]), {}),
             (_l1([(2, 0, 5000), (3, 0, 9000), (1, 0, 2000)]),
              dict(budget=45.0, cc=1.0)),
             (_l1([(2, 100, 9000), (3, 200, 5000)]), {}),
             (_l1([]), {})]
    for (data, count), kw in cases:
        want, got = _sizing_both(name, data, count, **kw)
        _contract_eq(want, got)
    if name == "small_node_contract_asbuilt":
        (data, count), _ = cases[2]
        got = _sizing_both(name, data, count)[1]
        assert int(got.time_ms[0]) == 0 and int(got.cores[0]) == 5


@pytest.mark.parametrize("name", SIZINGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_sizing_fuzz_equals_jax(seed, name):
    """Q = 1,024 (config 2's Level1), counts from empty to full, non-zero
    costs with budgets that stop the fold part way, unlimited budgets."""
    rng = np.random.default_rng(300 + seed)
    C, Q = 12, 1024
    rows = rand_rows(rng, (C, Q), gpu_frac=0.2)
    rows[..., jQ.FDUR] = rng.integers(0, 400_000, (C, Q))
    count = rng.integers(0, Q + 1, C).astype(np.int32)
    count[:2] = (0, Q)
    data = np.where((np.arange(Q)[None, :] < count[:, None])[..., None],
                    rows, np.asarray(jQ.empty(1).data[0, 0])[None, None])
    data = data.astype(np.int32)
    for kw in (dict(budget=-1.0), dict(budget=5e4, cc=0.3, mc=0.0007),
               dict(budget=2e6, cc=0.25, mc=0.001)):
        want, got = _sizing_both(name, data, count, **kw)
        _contract_eq(want, got)


# --------------------------------------------------------------------------
# snapshot, expiry
# --------------------------------------------------------------------------

def _market_cfg(**kw):
    """A small 3-resource DELAY config with virtual slots and the trader
    (the JAX class)."""
    base = dict(policy=PolicyKind.DELAY, queue_capacity=16, max_running=24,
                max_arrivals=64, max_nodes=4, max_virtual_nodes=3, n_res=3,
                trader=TraderConfig(enabled=True))
    base.update(kw)
    return SimConfig(**base)


def _random_state(rng, C, cfg=None):
    """A JAX initial state with random node columns (virtual slots active
    with expiries around t = 50 s), wait accounting and trader snapshot,
    and the port's copy."""
    cfg = _market_cfg() if cfg is None else cfg
    s = jinit_state(cfg, [uniform_cluster(c + 1, 4, gpus=2 * (c % 2))
                          for c in range(C)])
    N = cfg.max_nodes + cfg.max_virtual_nodes
    cap = np.asarray(s.node_cap).copy()
    active = np.asarray(s.node_active).copy()
    vcap = rng.integers(0, 40, (C, cfg.max_virtual_nodes, 3))
    cap[:, cfg.max_nodes:] = vcap * np.asarray([1, 700, 1])
    active[:, cfg.max_nodes:] = rng.random((C, cfg.max_virtual_nodes)) < 0.6
    cap = np.where(active[..., None], cap, 0).astype(np.int32)
    free = (cap * rng.random(cap.shape)).astype(np.int32)
    expire = np.full((C, N), jR.NEVER, np.int32)
    expire[:, cfg.max_nodes:] = np.where(
        active[:, cfg.max_nodes:],
        rng.integers(40_000, 60_000, (C, cfg.max_virtual_nodes)),
        jR.NEVER)
    tr = s.trader
    tr = tr.replace(
        snap_core_util=jnp.asarray(rng.random(C) * 1.2, jnp.float32),
        snap_mem_util=jnp.asarray(rng.random(C) * 1.2, jnp.float32),
        snap_avg_wait=jnp.asarray(rng.random(C) * 9e5, jnp.float32),
        seller_locked_until=jnp.asarray(
            rng.integers(0, 2, C) * 60_000, jnp.int32),
        cooldown_until=jnp.asarray(rng.integers(0, 2, C) * 60_000,
                                   jnp.int32))
    s = s.replace(
        node_cap=jnp.asarray(cap), node_free=jnp.asarray(free),
        node_active=jnp.asarray(active), node_expire=jnp.asarray(expire),
        wait_total=jnp.asarray(rng.random(C) * 1e6, jnp.float32),
        wait_jobs=jnp.asarray(rng.integers(0, 40, C), jnp.int32),
        trader=tr)
    return s, interop.state_from_numpy(jax_leaves(s), device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_snapshot_utilization_and_avg_wait_equal_jax(seed):
    js, ts = _random_state(np.random.default_rng(500 + seed), 24)
    cu, mu = jax.jit(jst.snapshot_utilization)(js)
    got_cu, got_mu = tstate.snapshot_utilization(ts)
    eq(cu, got_cu)
    eq(mu, got_mu)
    eq(jax.jit(jst.avg_wait_ms)(js), tstate.avg_wait_ms(ts))
    assert int((tstate.avg_wait_ms(ts) == 0).sum()) > 0  # wait_jobs == 0


@pytest.mark.parametrize("t", [45_000, 50_000, 60_000])
def test_expire_vnodes_local_equals_jax(t):
    js, ts = _random_state(np.random.default_rng(t), 24)
    want = jax.jit(jax.vmap(jengine._expire_vnodes_local,
                            in_axes=(jst.STATE_AXES, None),
                            out_axes=jst.STATE_AXES))(js, jnp.int32(t))
    got = tengine._expire_vnodes_local(ts, t)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    n = int((ts.node_active & (ts.node_expire <= t)).sum())
    assert 0 < n < int(ts.node_active[:, 4:].sum()) or t == 60_000


# --------------------------------------------------------------------------
# the matchers' shared pieces
# --------------------------------------------------------------------------

def _contracts(rng, C):
    """Random [C] contracts of both packages."""
    vals = dict(cores=rng.integers(0, 60, C), mem=rng.integers(0, 40_000, C),
                gpu=rng.integers(0, 3, C) * (rng.random(C) < 0.3),
                time_ms=rng.integers(0, 400_000, C))
    vals = {k: v.astype(np.int32) for k, v in vals.items()}
    price = (rng.random(C) * 50).astype(np.float32)
    return (jsizing.Contract(price=jnp.asarray(price),
                             **{k: jnp.asarray(v) for k, v in vals.items()}),
            tsizing.Contract(price=t_(price),
                             **{k: t_(v) for k, v in vals.items()}))


@pytest.mark.parametrize("economics", [False, True], ids=["default",
                                                          "nonzero"])
@pytest.mark.parametrize("seed", SEEDS)
def test_pair_feasibility_and_value_equal_jax(seed, economics):
    rng = np.random.default_rng(600 + seed)
    C, t = 24, 50_000
    js, ts = _random_state(rng, C)
    jcon, tcon = _contracts(rng, C)
    buyer = rng.random(C) < 0.5
    kw = dict(min_core_incentive=1e-4, min_mem_incentive=1e-5) \
        if economics else {}
    mcfg = TraderConfig(enabled=True, **kw)
    want = jax.jit(lambda s, b, con: jtrader._pair_feasibility(
        s, s.trader, jnp.int32(t), mcfg, jnp.arange(C, dtype=jnp.int32), b,
        con))(js, jnp.asarray(buyer), jcon)
    got = ttrader._pair_feasibility(
        ts, ts.trader, t, port_cfg(SimConfig(trader=mcfg)).trader,
        torch.arange(C, dtype=torch.int32), t_(buyer), tcon)
    eq(want, got)
    assert 0 < int(got.sum()) < C * C
    eq(jax.jit(jtrader._pair_value)(jcon), ttrader._pair_value(tcon))


def test_pair_jitter_equals_jax_within_bound():
    """Bitwise at 2 and 16 clusters: the table follows the reference's
    compiled rule (glibc's sinf, the vectorized argument from 72 buyers
    on), so the bound it once needed is zero."""
    for C in (2, 16):
        want = np.asarray(jax.jit(jtrader._pair_jitter, static_argnums=1)(
            jnp.arange(C, dtype=jnp.int32), C))
        got = ttrader.pair_jitter(0, C, C, "cpu").numpy()
        assert got.dtype == np.float32 and got.shape == (C, C)
        assert ((got >= 0) & (got < 1)).all()
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.view(np.int32))


# --------------------------------------------------------------------------
# the greedy round on states a run reached
# --------------------------------------------------------------------------

@pytest.mark.parametrize("carve", ["asbuilt", "sane"])
@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_round_equals_jax(seed, carve):
    """One round at t = 50 s on random states: buyers by both policies,
    locked sellers, cooled-down buyers, slots to attach and to miss; every
    leaf of the new state equal (the f32 spend included)."""
    rng = np.random.default_rng(700 + seed)
    C, t = 24, 50_000
    econ = dict(max_core_cost=0.3, max_mem_cost=0.0007, budget=4e4,
                min_core_incentive=1e-4, min_mem_incentive=1e-5) \
        if seed == 2 else {}
    cfg = _market_cfg(trader=TraderConfig(enabled=True, carve_mode=carve,
                                          **econ))
    js, ts = _random_state(rng, C, cfg)
    l1 = rand_rows(rng, (C, cfg.queue_capacity))
    count = rng.integers(0, cfg.queue_capacity + 1, C).astype(np.int32)
    js = js.replace(l1=jQ.JobQueue(data=jnp.asarray(l1),
                                   count=jnp.asarray(count)))
    ts = ts.replace(l1=tQ.JobQueue(data=t_(l1), count=t_(count)))
    want = jax.jit(lambda s: jtrader._round(s, jnp.int32(t), cfg,
                                            JLocalExchange()))(js)
    tcfg = port_cfg(cfg)
    got = ttrader.trade_round(ts, t, tcfg, LocalExchange(),
                              tengine.Engine(tcfg, device="cpu")
                              ._default_params, None)
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert int(got.trader.next_contract_id.sum()) > C  # somebody bought


# --------------------------------------------------------------------------
# whole runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("expire", [False, True], ids=["keep", "expire"])
def test_config2_with_the_trader_equals_jax(expire):
    """BASELINE config 2 (bench.py:898-933) with the trader on, at its own
    two clusters over 600 ticks: the first contract is traded near tick
    500; with ``expire_virtual_nodes`` its node expires in the prefix."""
    cfg = config2(trader=TraderConfig(enabled=True,
                                      expire_virtual_nodes=expire))
    specs_j, specs_t = config2_specs(2)
    arr = generate_arrivals(cfg.workload, 2, 4096, 1_800_000, 32, 24_000,
                            seed=9)
    n = 600
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    want = jax_runner(cfg)(jinit_state(cfg, specs_j), ta, n)
    tcfg = port_cfg(cfg)
    got = tengine.Engine(tcfg, device="cpu").run_chunks(
        tstate.init_state(tcfg, specs_t, device="cpu"),
        tengine.pack_arrivals_chunks(port_arrivals(arr), [250, 350],
                                     tcfg.tick_ms))
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    ttrace.check_conservation(got)
    assert ttrace.total_drops(got) == dict.fromkeys(
        ("queue", "msgs", "run_full", "vslot", "carve", "ingest", "failed",
         "narrow"), 0)
    assert int(got.trader.next_contract_id.sum()) > 2  # it traded
    assert int(got.borrowed.count.sum()) > 0


def test_trader_with_expiry_run_io_equals_jax_tickio():
    """tests/test_kernels.py:373-393 through the port: the trader with
    expiry engages the span release -> expire -> ingest -> schedule; the
    state and every stacked TickIO leaf equal the reference's unfused
    run_io and its Pallas prefix's (interpret mode)."""
    cfg, arr, specs_j = _tc_scenarios()["delay_wave_trader"]
    cfg = dataclasses.replace(
        cfg, record_metrics=False,
        trader=dataclasses.replace(cfg.trader, expire_virtual_nodes=True))
    tcfg = port_cfg(cfg)
    assert tfused.engaged_span(tcfg) == jfused.engaged_span(cfg) == (
        "release", "expire", "ingest", "schedule")
    ta = jengine.pack_arrivals_by_tick(arr, TC_TICKS, cfg.tick_ms)
    s0 = jinit_state(cfg, specs_j)
    rows, counts = ta.rows[:TC_TICKS], ta.counts[:TC_TICKS]
    refs = [jengine.Engine(c).run_io_jit()(s0, rows, counts) for c in (
        cfg, dataclasses.replace(cfg, fused="on", fused_block=1))]
    specs_t = [tspec.uniform_cluster(1, 5), tspec.uniform_cluster(2, 5)]
    eng = tengine.Engine(tcfg, device="cpu")
    got_s, got_io = eng.run_io(tstate.init_state(tcfg, specs_t,
                                                 device="cpu"), rows, counts)
    for want_s, want_io in refs:
        assert_leaves_equal(jax_leaves(want_s), interop.state_to_numpy(got_s))
        assert_leaves_equal(jax_leaves(want_io), interop.io_to_numpy(got_io))
    assert int(got_s.placed_total.sum()) > 0
    prov = tfused.provenance(eng)
    assert prov["span"] == ["release", "expire", "ingest", "schedule"]
    assert prov["kernel"] == "fused_prefix_delay_expire"
    assert not prov["emit_returns"] and not prov["terminal"]


def test_expire_forms_in_the_kernel_table():
    """Every kernel has its expire form as an entry of its own, from the
    same source, and ``host_params`` picks the expire forms exactly when
    the config engages expiry."""
    ks = tfused.KERNELS
    for lib in ("fused_prefix_fifo", "fused_prefix_ffd", "fused_prefix_delay",
                "fused_prefix_scored"):
        k = ks[f"{lib}_expire"]
        assert k.expire and k.lib == lib and not k.emit
        assert k.source == ks[lib].source
    k = ks["fused_prefix_fifo_emit_expire"]
    assert k.emit and k.expire and k.lib == "fused_prefix_fifo"
    base = port_cfg(config2())
    for expire, borrowing in ((False, True), (True, True), (True, False)):
        cfg = dataclasses.replace(base, borrowing=borrowing, n_res=3,
                                  trader=tconfig.TraderConfig(
                                      enabled=True,
                                      expire_virtual_nodes=expire))
        eng = tengine.Engine(cfg, device="cpu")
        host = tfused.host_params(eng, eng._default_params)
        assert host["expire"] == expire == tfused.expires(cfg)
        assert host["kernel"].name == "fused_prefix_fifo" + (
            "_expire" if expire else "")
        assert host["emit_kernel"].name == "fused_prefix_fifo_emit" + (
            "_expire" if expire else "")


def test_trader_configs_accepted_and_refused():
    """The trader runs with every matcher and either expiry; it refuses
    n_res != 3 as the reference does; faults and metrics stay refused by
    name."""
    base = port_cfg(config2())
    for matching in tconfig.MatchKind:
        for expire in (False, True):
            tengine.Engine(dataclasses.replace(
                base, trader=tconfig.TraderConfig(
                    enabled=True, matching=matching,
                    expire_virtual_nodes=expire)), device="cpu")
    with pytest.raises(ValueError, match="n_res=3"):
        tengine.Engine(dataclasses.replace(
            base, n_res=2, trader=tconfig.TraderConfig(enabled=True)),
            device="cpu")
    with pytest.raises(ValueError, match="n_res=3"):
        jengine.Engine(dataclasses.replace(
            config2(), n_res=2, trader=TraderConfig(enabled=True)))


def test_trader_leaves_round_trip_by_jax_path():
    """The TraderState leaves and node_expire cross between the packages
    by the reference's own paths, values and dtypes as they were."""
    js, ts = _random_state(np.random.default_rng(9), 8)
    js = js.replace(trader=js.trader.replace(
        mkt_price=jnp.linspace(0, 1, 8, dtype=jnp.float32),
        spent=jnp.full((8,), 2.5, jnp.float32),
        next_contract_id=jnp.arange(8, dtype=jnp.int32) + 3))
    leaves = jax_leaves(js)
    keys = [k for k in leaves if k.startswith(".trader.")]
    assert sorted(keys) == sorted(
        f".trader.{f.name}" for f in dataclasses.fields(tstate.TraderState))
    assert ".node_expire" in leaves
    back = interop.state_to_numpy(interop.state_from_numpy(leaves,
                                                           device="cpu"))
    assert_leaves_equal(leaves, back)
