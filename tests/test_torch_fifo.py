"""The port's FIFO pass (``policies/kernels.py:_fifo_local``), both drain
forms, against the JAX package's ``_run_kind`` on states the JAX engine
reaches: the JAX engine runs a few ticks from a seeded stream, the tick's
release and ingest phases run, and then both FIFO passes run on that same
pre-schedule state. Every state leaf, ``borrow_want`` and ``borrow_job``
must be equal bitwise. The tight-bounds case (queue 4, running set 4) makes
the drain stop on a failure, the wait head run, and both ``run_full`` and
``drops.queue`` count. The lent case loads foreign jobs into the lent
queue before the pass, so that the lent-head attempt places some."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.policies import base as jbase
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core.state import SRC_LENT
from multi_cluster_simulator_tpu_torch.policies import base as tbase
from multi_cluster_simulator_tpu_torch.policies import kernels as tK
from tests.test_torch_engine import (
    assert_leaves_equal, headline_cfg, jax_leaves, load_lent, n_traced,
    port_cfg, specs, stream,
)

SCENARIOS = {
    # the headline's bounds on a busy stream
    "headline": dict(cfg=dict(), stream=dict(jobs=60, horizon_ms=20_000,
                                             seed=4), ticks=(3, 9, 16)),
    # tight bounds: every FIFO branch and both drop counters fire
    "tight": dict(cfg=dict(queue_capacity=4, max_running=4),
                  stream=dict(jobs=60, horizon_ms=15_000, seed=6,
                              max_cores=24, max_mem=20_000),
                  ticks=(2, 6, 12)),
    # the headline's bounds with foreign jobs loaded into the lent queue
    # before the schedule phase: the lent-head attempt places some of them
    "lent": dict(cfg=dict(), stream=dict(jobs=60, horizon_ms=20_000,
                                         seed=4), ticks=(3, 9, 16), lent=21),
}
C = 8


def _pre_states(name):
    """(t, JAX pre-schedule state) at the scenario's ticks."""
    sc = SCENARIOS[name]
    cfg = headline_cfg(**sc["cfg"])
    arr, _ = stream(n_clusters=C, **sc["stream"])
    jspecs, _ = specs(C)
    n = max(sc["ticks"])
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    eng = jengine.Engine(cfg)
    params = eng._default_params
    step = jax.jit(eng.step_tick)
    pre = jax.jit(lambda s, r, c, t: eng._span_prefix(
        s, r, c, t, params, tick_indexed=True, emit_returns=False,
        phase_limit=4)[0])
    state = jinit_state(cfg, jspecs)
    out = []
    for k in range(n):
        rows, counts = jnp.asarray(ta.rows[k]), jnp.asarray(ta.counts[k])
        if k + 1 in sc["ticks"]:
            t = int(state.t) + cfg.tick_ms
            p = pre(state, rows, counts, jnp.int32(t))
            if "lent" in sc:
                p = load_lent(p, sc["lent"] + k)
            out.append((t, p))
        state = step(state, rows, counts)
    return cfg, out


@pytest.fixture(scope="module")
def pre_states():
    return {name: _pre_states(name) for name in SCENARIOS}


@pytest.mark.parametrize("drain", ["wave", "serial"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fifo_pass_bitwise_equals_jax_run_kind(pre_states, name, drain):
    cfg, states = pre_states[name]
    cfg = dataclasses.replace(cfg, fifo_drain=drain)
    spec = jbase.REGISTRY["fifo"]
    params = jbase.default_params(cfg, spec)
    run_kind = jax.jit(lambda s, t: jbase._run_kind(spec, s, t, params, cfg))
    seen = dict(placed=0, queue=0, run_full=0, wait=0, fail_stop=0, lent=0)
    for t, pre in states:
        jout, jwant, jbjob = run_kind(pre, jnp.int32(t))
        tpre = interop.state_from_numpy(jax_leaves(pre), device="cpu")
        tcfg = port_cfg(cfg)
        tout, twant, tbjob = tbase._run_kind(
            tbase.REGISTRY["fifo"], tpre, t,
            tbase.default_params(tcfg, tbase.REGISTRY["fifo"]), tcfg)
        assert_leaves_equal(jax_leaves(jout), interop.state_to_numpy(tout))
        np.testing.assert_array_equal(np.asarray(jwant), twant.numpy())
        np.testing.assert_array_equal(np.asarray(jbjob), tbjob.numpy())
        seen["placed"] += int(tout.placed_total.sum() - tpre.placed_total.sum())
        seen["queue"] += int(tout.drops.queue.sum())
        seen["run_full"] += int(tout.drops.run_full.sum()
                                - tpre.drops.run_full.sum())
        seen["wait"] += int(tout.wait.count.sum())
        # a drain stopped on a failure: the ready queue kept jobs while the
        # wait queue had been empty
        seen["fail_stop"] += int(((tpre.wait.count == 0)
                                  & (tout.wait.count > 0)).sum())
        seen["lent"] += n_traced(tout, SRC_LENT) - n_traced(tpre, SRC_LENT)
    assert seen["placed"] > 0
    if name == "tight":
        assert all(v > 0 for k, v in seen.items() if k != "lent"), seen
    assert (seen["lent"] > 0) == (name == "lent"), seen


def test_serial_and_wave_drains_agree_in_the_port(pre_states):
    """The two drain forms of the port give one outcome (the reference
    pins the same for its own pair in tests/test_kernel_equiv.py)."""
    cfg, states = pre_states["tight"]
    for t, pre in states:
        outs = []
        for drain in ("wave", "serial"):
            tpre = interop.state_from_numpy(jax_leaves(pre), device="cpu")
            c = port_cfg(dataclasses.replace(cfg, fifo_drain=drain))
            outs.append(interop.state_to_numpy(tK._fifo_local(tpre, t, c)[0]))
        assert_leaves_equal(*outs)


def test_trace_appends_match_jax():
    """``_trace_append`` and the batched ``_trace_append_many`` against the
    JAX ones, a nearly full ring included (appends past capacity drop)."""
    from multi_cluster_simulator_tpu.core.state import Trace as JTrace
    from multi_cluster_simulator_tpu.policies import kernels as jK
    from multi_cluster_simulator_tpu_torch.core.state import Trace as TTrace

    rng = np.random.default_rng(3)
    E, K = 12, 6
    n = rng.integers(0, E + 1, C).astype(np.int32)
    vals = {f: rng.integers(-5, 100, (C, E)).astype(np.int32)
            for f in ("t", "job", "node", "src")}
    jtr = JTrace(n=jnp.asarray(n), **{k: jnp.asarray(v)
                                      for k, v in vals.items()})

    def ttr():
        return TTrace(n=torch.from_numpy(n.copy()),
                      **{k: torch.from_numpy(v.copy())
                         for k, v in vals.items()})

    take = rng.random((C, K)) < 0.6
    ids = rng.integers(0, 50, (C, K)).astype(np.int32)
    nodes = rng.integers(0, 5, (C, K)).astype(np.int32)
    jmany = jax.vmap(lambda tr, tk, i, nd: jK._trace_append_many(
        tr, tk, jnp.int32(77), i, nd, 2))(jtr, jnp.asarray(take),
                                          jnp.asarray(ids), jnp.asarray(nodes))
    tmany = tK._trace_append_many(ttr(), torch.from_numpy(take), 77,
                                  torch.from_numpy(ids),
                                  torch.from_numpy(nodes), 2)
    jone = jax.vmap(lambda tr, d, i, nd: jK._trace_append(
        tr, d, jnp.int32(5), i, nd, 3))(jtr, jnp.asarray(take[:, 0]),
                                        jnp.asarray(ids[:, 0]),
                                        jnp.asarray(nodes[:, 0]))
    tone = tK._trace_append(ttr(), torch.from_numpy(take[:, 0]), 5,
                            torch.from_numpy(ids[:, 0]),
                            torch.from_numpy(nodes[:, 0]), 3)
    for j, t in ((jmany, tmany), (jone, tone)):
        for f in ("t", "job", "node", "src", "n"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy(), err_msg=f)
