"""The port's copy of the Go-semantics oracle
(``multi_cluster_simulator_tpu_torch/oracle/``) and the parity gate's
scenarios, on the CPU.

The copy is the reference's ``oracle/go_semantics.py`` with its imports
pointed at the port (its text pinned, as the services' copies are). Run
on bench.py:1266 bench_parity_tpu's eight scenarios (chip_smoke.py's
``parity_scenarios``, pinned to bench.py's table here) and on the
scenarios of tests/test_torch_{borrow,trader}_oracle.py, the copy's
trace and every cluster's state equal the reference oracle's on the same
stream. The port's plain path equals the copy's traces, with zero drops
and each scenario's mechanism fired, on the three bench scenarios no
other port test runs (fifo_small, ffd, trader_market); the other five
are held against the reference oracle, whose traces the copy's equal, by
tests/test_torch_delay.py (delay_small, delay_heavy, delay_packed) and
tests/test_torch_borrow_oracle.py (fifo_borrowing, fifo_borrowing_8c).
"""

import dataclasses
import os
import re
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import multi_cluster_simulator_tpu_torch as P
from multi_cluster_simulator_tpu.config import (
    PolicyKind, SimConfig, TraderConfig, WorkloadConfig,
)
from multi_cluster_simulator_tpu.core import spec as jspec
from multi_cluster_simulator_tpu.oracle import Oracle as JOracle
from multi_cluster_simulator_tpu.workload.generator import (
    generate_arrivals, silence_clusters,
)
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core.engine import Engine
from multi_cluster_simulator_tpu_torch.core.state import init_state
from multi_cluster_simulator_tpu_torch.oracle import Oracle
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from tests.conftest import make_arrivals
from tests.test_market import trader_cfg
from tests.test_torch_borrow_oracle import oracle_scenarios
from tests.test_torch_engine import port_cfg
from tests.test_torch_mesh import port_arr
from tests.test_torch_trader_oracle import SCENARIOS as TRADER_SCENARIOS
from tests.test_torch_trader_oracle import pair

REPO = Path(__file__).resolve().parents[1]


def renamed(text: str) -> str:
    return re.sub(r"multi_cluster_simulator_tpu\b",
                  "multi_cluster_simulator_tpu_torch", text)


@pytest.mark.parametrize("rel", ["oracle/go_semantics.py",
                                 "oracle/__init__.py"])
def test_oracle_copy_equals_its_reference(rel):
    """The text is the reference's but for the package in its imports."""
    ref = (REPO / "multi_cluster_simulator_tpu" / rel).read_text()
    got = (REPO / "multi_cluster_simulator_tpu_torch" / rel).read_text()
    assert got == renamed(ref)
    changed = [a for a, b in zip(ref.splitlines(), got.splitlines())
               if a != b]
    assert changed and all(line.startswith("from ") for line in changed)


def bench_scenarios():
    """bench.py:1336-1377's table, with the JAX package's classes:
    name -> (config, specs, seed, ticks, cores, mem, silenced, require)."""
    small = jspec.load_cluster_json(os.path.join(REPO, "assets",
                                                 "cluster_small.json"))
    R = dataclasses.replace
    base = SimConfig(record_trace=True, queue_capacity=64, max_running=512,
                     max_arrivals=2048, max_nodes=12,
                     max_ingest_per_tick=128)
    heavy = WorkloadConfig(poisson_lambda_per_min=40.0)
    overload = WorkloadConfig(poisson_lambda_per_min=60.0)
    borrow = [jspec.uniform_cluster(1, 3, cores=16, memory=8_000),
              jspec.uniform_cluster(2, 10)]
    eight = [jspec.uniform_cluster(c + 1, 3, cores=16, memory=8_000)
             if c % 2 == 0 else jspec.uniform_cluster(c + 1, 10)
             for c in range(8)]
    market = R(base, policy=PolicyKind.DELAY, workload=overload,
               queue_capacity=512, max_virtual_nodes=4,
               trader=TraderConfig(enabled=True))
    fb = R(base, policy=PolicyKind.FIFO, borrowing=True, workload=heavy,
           queue_capacity=256)
    dh = R(base, policy=PolicyKind.DELAY, workload=heavy, queue_capacity=256)
    return {
        "delay_small": (R(base, policy=PolicyKind.DELAY), [small], 9, 400,
                        32, 24_000, None, None),
        "delay_heavy": (dh, [small], 3, 300, 32, 24_000, None, None),
        "delay_packed": (dh, [small], 17, 400, 8, 6_000, None, None),
        "fifo_small": (R(base, policy=PolicyKind.FIFO), [small], 9, 400, 32,
                       24_000, None, None),
        "fifo_borrowing": (fb, borrow, 7, 300, 16, 8_000, 1, "lent_at_1"),
        "ffd": (R(base, policy=PolicyKind.FFD, workload=heavy,
                  queue_capacity=256), [small], 13, 200, 32, 24_000, None,
                None),
        "trader_market": (market, borrow, 21, 300, 16, 8_000, 1, "market"),
        "fifo_borrowing_8c": (fb, eight, 27, 300, 16, 8_000,
                              slice(1, None, 2), "lent_any"),
    }


def scenario(name):
    (sc,) = [s for s in chip_smoke.parity_scenarios(P) if s["name"] == name]
    return sc


def test_parity_scenarios_mirror_bench():
    """chip_smoke.py's copy of the table, field by field, and its streams
    equal to the reference generator's."""
    table = bench_scenarios()
    got = chip_smoke.parity_scenarios(P)
    assert [s["name"] for s in got] == list(table)
    for sc in got:
        cfg, specs, seed, n, cores, mem, silence, require = table[sc["name"]]
        assert sc["cfg"] == port_cfg(cfg)
        assert [dataclasses.asdict(s) for s in sc["specs"]] == \
            [dataclasses.asdict(s) for s in specs]
        assert (sc["seed"], sc["n_ticks"], sc["max_cores"], sc["max_mem"],
                sc["silence"], sc["require"]) == (seed, n, cores, mem,
                                                  silence, require)
        arr = generate_arrivals(cfg.workload, len(specs), cfg.max_arrivals,
                                n * cfg.tick_ms, cores, mem, seed=seed)
        if silence is not None:
            arr = silence_clusters(arr, silence)
        tarr = chip_smoke.parity_arrivals(P, sc)
        for f in dataclasses.fields(tarr):
            np.testing.assert_array_equal(getattr(tarr, f.name),
                                          np.asarray(getattr(arr, f.name)))


def plain(x):
    """An oracle's state as nested builtins (floats by their repr)."""
    if dataclasses.is_dataclass(x):
        return plain(dataclasses.asdict(x))
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return plain(vars(x))
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items() if k not in ("cfg", "arr")}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (float, np.floating)):
        return repr(float(x))
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def assert_oracles_equal(cfg, specs_j, arr, n_ticks):
    """The copy and the reference over the same stream: trace and every
    cluster's final state."""
    tcfg = port_cfg(cfg)
    specs_t = [tspec.ClusterSpec(id=s.id, nodes=tuple(
        tspec.NodeSpec(**dataclasses.asdict(n)) for n in s.nodes))
        for s in specs_j]
    want = JOracle(cfg, list(specs_j), arr).run(n_ticks)
    got = Oracle(tcfg, specs_t, port_arr(arr)).run(n_ticks)
    assert got.trace == want.trace
    assert [plain(c) for c in got.clusters] == \
        [plain(c) for c in want.clusters]
    return got


@pytest.mark.parametrize("name", list(bench_scenarios()))
def test_oracle_copy_equals_the_reference_on_bench_scenarios(name):
    cfg, specs, seed, n, cores, mem, silence, _ = bench_scenarios()[name]
    arr = generate_arrivals(cfg.workload, len(specs), cfg.max_arrivals,
                            n * cfg.tick_ms, cores, mem, seed=seed)
    if silence is not None:
        arr = silence_clusters(arr, silence)
    got = assert_oracles_equal(cfg, specs, arr, n)
    assert got.trace


@pytest.mark.parametrize("name", sorted(oracle_scenarios()))
def test_oracle_copy_equals_the_reference_on_borrowing(name):
    """tests/test_torch_borrow_oracle.py's scenarios."""
    from tests.test_torch_borrow import SCENARIO_CFG

    (specs_j, _), seed, n, cores, mem, silent = oracle_scenarios()[name]
    arr = silence_clusters(generate_arrivals(
        SCENARIO_CFG.workload, len(specs_j), SCENARIO_CFG.max_arrivals,
        n * SCENARIO_CFG.tick_ms, cores, mem, seed=seed), silent)
    assert_oracles_equal(SCENARIO_CFG, specs_j, arr, n)


@pytest.mark.parametrize("name", sorted(TRADER_SCENARIOS))
def test_oracle_copy_equals_the_reference_on_the_market(name):
    """tests/test_torch_trader_oracle.py's scenarios."""
    kw, n_buyers, seed, n_ticks = TRADER_SCENARIOS[name]
    cfg = trader_cfg(lam=60.0, **kw)
    arr = make_arrivals(cfg, n_buyers + 1, horizon_ms=n_ticks * 1_000,
                        seed=seed, max_cores=16, max_mem=8_000)
    n = np.asarray(arr.n).copy()
    n[n_buyers] = 0
    got = assert_oracles_equal(cfg, pair(jspec, n_buyers), arr.replace(n=n),
                               n_ticks)
    assert any(c.spent for c in got.clusters) or got.trace


@pytest.mark.parametrize("name", ["fifo_small", "ffd", "trader_market"])
def test_plain_path_equals_the_oracle_copy(name):
    """The port's plain path over the scenario's windowed stream: every
    cluster's trace == the copy's, zero drops, the mechanism fired
    (chip_smoke.py phase 11a's gate, here on the CPU)."""
    sc = scenario(name)
    cfg, specs, n = sc["cfg"], sc["specs"], sc["n_ticks"]
    arr = chip_smoke.parity_arrivals(P, sc)
    out = Engine(cfg, device="cpu").run(init_state(cfg, specs,
                                                   device="cpu"), arr, n)
    oracle = Oracle(cfg, list(specs), arr).run(n)
    ttrace.assert_no_drops(out)
    chip_smoke.parity_require(sc, oracle)
    want = ttrace.oracle_trace_per_cluster(oracle, len(specs))
    assert ttrace.extract_trace(out) == want
    assert sum(map(len, want)) > 0
    ttrace.check_conservation(out)
