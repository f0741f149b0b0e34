"""The port's profile plane against the JAX package's, on the CPU:
``Engine.run_prefix`` (the phase-prefix ablation), ``step_tick``, the
provenance methods and the profile capture tool.

``run_prefix`` at every phase limit k = 0..8 equals JAX's ``run_prefix``
leaf by leaf for FIFO, FFD, DELAY and gavel, as members of one policy set
with borrowing, the greedy trader and generative churn all on (JAX's nine
prefixes compiled as one program, run once per member); at the whole tick
it equals ``run`` (tests/test_obs.py:143). The provenance dicts equal the
reference's where the fields are shared, and
``python -m multi_cluster_simulator_tpu_torch.tools.profile_capture`` on
the CPU writes a full table and a trace. Tolerance is zero.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from multi_cluster_simulator_tpu.config import (
    FaultConfig, MatchKind, PolicyKind, SimConfig, TraderConfig,
)
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.obs.profile import TICK_PHASES as JPHASES
from multi_cluster_simulator_tpu.policies.base import PolicySet as JSet
from multi_cluster_simulator_tpu.workload.traces import uniform_stream
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.obs.profile import TICK_PHASES
from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
from multi_cluster_simulator_tpu_torch.tools import profile_capture as pc
from tests.test_obs import N_TICKS, TICK_MS, _bursty_arrivals
from tests.test_obs import _cfg as obs_cfg
from tests.test_obs import _specs as obs_specs
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tests.test_torch_obs import port_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMBERS = ("fifo", "ffd", "delay", "gavel")
C = 4
TICKS = 30
LIMITS = range(len(TICK_PHASES) + 1)


def world_cfg():
    """Borrowing, the greedy trader and generative churn on one config
    (the JAX class): every phase of the tick has work."""
    return SimConfig(policy=PolicyKind.FIFO, queue_capacity=16,
                     max_running=32, max_arrivals=40, max_ingest_per_tick=8,
                     parity=False, n_res=3, max_nodes=5, max_virtual_nodes=4,
                     borrowing=True,
                     trader=TraderConfig(enabled=True,
                                         matching=MatchKind.GREEDY),
                     faults=FaultConfig(enabled=True, mttf_ms=20_000,
                                        mttr_ms=5_000, seed=3,
                                        max_retries=8))


def world_specs():
    return [uniform_cluster(c + 1, 5, gpus=c % 2) for c in range(C)]


def world_stream():
    return uniform_stream(C, 40, TICKS * 1_000, max_cores=8, max_mem=6_000,
                          max_dur_ms=10_000, seed=1, max_gpus=1,
                          gpu_frac=0.1)


@pytest.fixture(scope="module")
def jax_prefixes():
    """JAX's final state at every phase limit for every member: the nine
    prefixes as one jitted program, run once per member's params."""
    cfg, specs, arr = world_cfg(), world_specs(), world_stream()
    pset = JSet(MEMBERS)
    eng = jengine.Engine(cfg, policies=pset)
    ta = jengine.pack_arrivals_by_tick(arr, TICKS, cfg.tick_ms)
    allk = jax.jit(lambda s, ta_, p: [
        eng.run_prefix(s, ta_, TICKS, k, p) for k in LIMITS])
    s0 = jinit_state(cfg, specs)
    return {name: [jax_leaves(s) for s in
                   allk(s0, ta, pset.params_for(cfg, name))]
            for name in MEMBERS}


@pytest.mark.parametrize("k", LIMITS)
@pytest.mark.parametrize("name", MEMBERS)
def test_run_prefix_equals_jax(jax_prefixes, name, k):
    """The port's ``run_prefix`` at limit k (the plain truncated span
    below 5, the prefix as ``fused_prefix`` runs it from 5) equals JAX's,
    every leaf; at k = 0 only the clock moved."""
    cfg = world_cfg()
    tcfg = port_cfg(cfg)
    tset = PolicySet(MEMBERS)
    eng = tengine.Engine(tcfg, device="cpu", policies=tset)
    s0 = tstate.init_state(tcfg, port_specs(world_specs()), device="cpu")
    ta = tengine.pack_arrivals_by_tick(port_arrivals(world_stream()), TICKS,
                                       tcfg.tick_ms)
    out = eng.run_prefix(tstate.clone_state(s0), ta, TICKS, k,
                         tset.params_for(tcfg, name))
    got = interop.state_to_numpy(out)
    assert_leaves_equal(jax_prefixes[name][k], got)
    if k == 0:
        before = interop.state_to_numpy(s0)
        moved = [key for key in got if not np.array_equal(got[key],
                                                          before[key])]
        assert moved == [".t"]


@pytest.mark.parametrize("limit", [len(TICK_PHASES), 99])
def test_run_prefix_full_equals_run(limit):
    """At the whole tick (and past it) the ablation is ``run``
    (tests/test_obs.py:143), and both equal JAX's ``run``."""
    cfg, specs, arr = obs_cfg(), obs_specs(3), _bursty_arrivals()
    tcfg = port_cfg(cfg)
    ta = tengine.pack_arrivals_by_tick(port_arrivals(arr), N_TICKS, TICK_MS)
    eng = tengine.Engine(tcfg, device="cpu")
    s0 = tstate.init_state(tcfg, port_specs(specs), device="cpu")
    ref = eng.run(tstate.clone_state(s0), ta, N_TICKS)
    ref = ref[0] if isinstance(ref, tuple) else ref
    out = eng.run_prefix(tstate.clone_state(s0), ta, N_TICKS, limit)
    assert_leaves_equal(interop.state_to_numpy(ref),
                        interop.state_to_numpy(out))
    if limit == len(TICK_PHASES):
        jta = jengine.pack_arrivals_by_tick(arr, N_TICKS, TICK_MS)
        want = jengine.Engine(cfg).run_jit()(jinit_state(cfg, specs), jta,
                                             N_TICKS)
        want = want[0] if isinstance(want, tuple) else want
        assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(out))


def test_run_prefix_refuses_a_short_stream():
    tcfg = port_cfg(world_cfg())
    eng = tengine.Engine(tcfg, device="cpu")
    ta = tengine.pack_arrivals_by_tick(port_arrivals(world_stream()), 5,
                                       tcfg.tick_ms)
    s0 = tstate.init_state(tcfg, port_specs(world_specs()), device="cpu")
    with pytest.raises(ValueError, match="covers 5 ticks"):
        eng.run_prefix(s0, ta, 6, 3)


def test_step_tick_equals_run_and_jax():
    """``step_tick`` over each tick's slice is ``run`` over the bucket,
    and JAX's ``step_tick`` sequence."""
    cfg = world_cfg()
    tcfg = port_cfg(cfg)
    n = 12
    ta = tengine.pack_arrivals_by_tick(port_arrivals(world_stream()), n,
                                       tcfg.tick_ms)
    eng = tengine.Engine(tcfg, device="cpu")
    s0 = tstate.init_state(tcfg, port_specs(world_specs()), device="cpu")
    stepped = tstate.clone_state(s0)
    for k in range(n):
        stepped = eng.step_tick(stepped, ta.rows[k], ta.counts[k])
    ran = eng.run(tstate.clone_state(s0), ta, n)
    assert_leaves_equal(interop.state_to_numpy(ran),
                        interop.state_to_numpy(stepped))
    jeng = jengine.Engine(cfg)
    jta = jengine.pack_arrivals_by_tick(world_stream(), n, cfg.tick_ms)
    step = jax.jit(jeng.step_tick)
    js = jinit_state(cfg, world_specs())
    for k in range(n):
        js = step(js, jta.rows[k], jta.counts[k])
    assert_leaves_equal(jax_leaves(js), interop.state_to_numpy(stepped))


# --------------------------------------------------------------------------
# provenance
# --------------------------------------------------------------------------

PROV_CFGS = {
    "headline": lambda: SimConfig(policy=PolicyKind.FIFO, parity=True,
                                  n_res=2, max_virtual_nodes=0),
    "world": world_cfg,
    "sinkhorn": lambda: dataclasses.replace(world_cfg(), trader=TraderConfig(
        enabled=True, matching=MatchKind.SINKHORN, sinkhorn_iters=9)),
    "cvx": lambda: dataclasses.replace(world_cfg(), trader=TraderConfig(
        enabled=True, matching=MatchKind.CVX, expire_virtual_nodes=True)),
    "delay": lambda: SimConfig(policy=PolicyKind.DELAY, n_res=2),
}


@pytest.mark.parametrize("name", sorted(PROV_CFGS))
def test_provenance_equals_jax(name):
    """policy_provenance and market_provenance are the reference's dicts;
    fused_provenance shares its span and epilogue_tap; prefix_phases is
    the engaged span; on the CPU no kernel is active."""
    cfg = PROV_CFGS[name]()
    tcfg = port_cfg(cfg)
    jeng, teng = jengine.Engine(cfg), tengine.Engine(tcfg, device="cpu")
    assert teng.policy_provenance() == jeng.policy_provenance()
    assert teng.market_provenance() == jeng.market_provenance()
    jf, tf = jeng.fused_provenance(), teng.fused_provenance()
    shared = set(jf) & set(tf)
    assert shared >= {"span", "epilogue_tap"}
    assert {k: tf[k] for k in shared} == {k: jf[k] for k in shared}
    assert teng.prefix_phases() == jeng.prefix_phases()
    assert teng.fused_active() is False
    assert TICK_PHASES == JPHASES


def test_policy_provenance_of_a_set_equals_jax():
    cfg = world_cfg()
    tcfg = port_cfg(cfg)
    jset, tset = JSet(MEMBERS), PolicySet(MEMBERS)
    jeng = jengine.Engine(cfg, policies=jset)
    teng = tengine.Engine(tcfg, device="cpu", policies=tset)
    assert teng.policy_provenance() == jeng.policy_provenance()
    for n in MEMBERS:
        assert teng.policy_provenance(tset.params_for(tcfg, n)) == \
            jeng.policy_provenance(jset.params_for(cfg, n))
        assert teng.market_provenance(tset.params_for(tcfg, n)) == \
            jeng.market_provenance(jset.params_for(cfg, n))


# --------------------------------------------------------------------------
# the profile capture tool
# --------------------------------------------------------------------------

def test_profile_capture_cli_on_the_cpu(tmp_path):
    """``--device cpu --quick --ticks 10 --repeats 1`` exits 0 with a full
    table (every phase and the carry row, finite, each with its route and
    bytes) and a trace artifact holding the prefix's range."""
    out_dir = tmp_path / "pc"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m",
         "multi_cluster_simulator_tpu_torch.tools.profile_capture",
         "--device", "cpu", "--quick", "--ticks", "10", "--repeats", "1",
         "--out", str(out_dir)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    table = json.loads((out_dir / "phase_table_headline.json").read_text())
    rows = table["phases"]
    assert [r["phase"] for r in rows] == list(TICK_PHASES) + [
        "(carry/clock)"]
    assert all(math.isfinite(r["ms_per_tick"]) for r in rows)
    assert {r["route"] for r in rows} == {"plain"}
    assert all(r["launches_per_tick"] == 0 for r in rows)
    byname = {r["phase"]: r["prefix_bytes_delta"] for r in rows}
    assert byname["(carry/clock)"] == 4  # the clock alone
    assert byname["schedule"] > 0 and byname["trade"] == 0
    assert table["fused"]["kernel"] == "fused_prefix_fifo"
    assert table["trace_artifacts"]
    trace = open(table["trace_artifacts"][0]).read()
    assert "tick.fused_prefix" in trace
    assert "mcs.dispatch.profile_capture" in trace


def test_profile_capture_trader_table_in_process(tmp_path):
    """The trader shape (non-terminal: snapshot and trade have work)
    without a trace, called in process."""
    rc = pc.main(["--config", "trader", "--quick", "--ticks", "20",
                  "--repeats", "1", "--device", "cpu", "--no-trace",
                  "--out", str(tmp_path)])
    assert rc == 0
    table = json.loads((tmp_path / "phase_table_trader.json").read_text())
    byname = {r["phase"]: r for r in table["phases"]}
    assert byname["snapshot"]["prefix_bytes_delta"] > 0
    assert table["trace_artifacts"] == []


def test_profile_capture_fails_on_a_degenerate_table(tmp_path, monkeypatch):
    def nan_table(*a, **kw):
        return {"rows": [{"phase": "faults", "ms_per_tick": float("nan")}],
                "full_ms": float("nan"), "last": None}

    monkeypatch.setattr(pc, "phase_table", nan_table)
    assert pc.main(["--quick", "--ticks", "2", "--device", "cpu",
                    "--out", str(tmp_path)]) == 1


def test_profile_capture_fails_without_an_artifact(tmp_path, monkeypatch):
    monkeypatch.setattr(pc, "capture_trace", lambda *a, **kw: [])
    assert pc.main(["--config", "delay", "--quick", "--ticks", "3",
                    "--repeats", "1", "--device", "cpu",
                    "--out", str(tmp_path)]) == 1
