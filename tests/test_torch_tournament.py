"""The port's policy tournament (multi_cluster_simulator_tpu_torch/tools/
tournament.py) against the JAX package's tools/tournament.py, on the CPU.

The port runs the whole (variant, seed) grid as one lane-stacked run
(each lane a cell, a batched ``params.idx``); the reference runs one
jitted call per variant with the seed axis vmapped. Held here: the rows
and the ranking equal the reference's on tests/test_policies.py:171's
grid; every cell's standalone run (which the tool holds each lane
bitwise against) equals the reference engine's leaf by leaf; the 48
sweep variants' parameter digests and the grid digest are the
reference's, so a ``--resume`` cache either package writes resumes in the
other; tests/test_preempt.py:477's resume case; tests/test_policies.py:
189-208's sharded seed axis over 2 rank processes (with the device A/B)
and its refusals; and tests/test_market_cvx.py:437's cvx pricing
grid as lanes, each cell its standalone run and the reference's.
"""

import json

import jax
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import MatchKind
from multi_cluster_simulator_tpu.core.engine import Engine as JEngine
from multi_cluster_simulator_tpu.core.engine import (
    pack_arrivals_by_tick as jpack,
)
from multi_cluster_simulator_tpu.core.state import init_state as jinit
from multi_cluster_simulator_tpu.policies import PolicySet as JPolicySet
from multi_cluster_simulator_tpu.policies import REGISTRY as JREGISTRY
from multi_cluster_simulator_tpu.policies import params_digest as jdigest
from multi_cluster_simulator_tpu.policies import variant as jvariant
from multi_cluster_simulator_tpu_torch import interop, tenancy
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core.state import init_state
from multi_cluster_simulator_tpu_torch.policies import base as tbase
from multi_cluster_simulator_tpu_torch.tools import tournament as T
from tests.test_sinkhorn import market_cfg, two_buyer_two_seller
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tools import tournament as JT

GRID = dict(policies=("fifo", "delay", "gavel", "tesserae"), n_seeds=2,
            C=8, jobs_per=40, horizon_ms=80_000)
RESUME = dict(policies=("fifo", "delay"), n_seeds=2, C=4, jobs_per=16,
              horizon_ms=20_000, drain_ticks=20)


@pytest.fixture(scope="module")
def grids():
    """The reference's and the port's detail on test_policies.py:171's
    grid."""
    return JT.run_tournament(**GRID), T.run_tournament(**GRID, device="cpu")


def test_rows_and_ranking_equal_jax(grids):
    want, got = grids
    assert got["rows"] == want["rows"]
    assert got["ranking"] == want["ranking"]
    for k in ("policies", "seeds", "clusters", "jobs_per_cluster", "cells",
              "ticks", "cells_bit_identical_to_standalone",
              "replication_axis_sharded"):
        assert got[k] == want[k], k
    assert got["lanes"] == got["cells"] == 8
    assert got["device"] == "cpu" and got["kernel_launches"] == {}
    assert got["serial_loop_wall_s"] > 0 and got["speedup_vs_serial"] > 0
    assert all(r["placed"] > 0 for r in got["rows"])


def test_standalone_cells_equal_jax():
    """Each cell's standalone run — the oracle the tool holds every lane
    bitwise against — is the reference engine's run, leaf by leaf."""
    cfg, tcfg = JT._cfg(jobs_per=GRID["jobs_per"]), \
        T._cfg(jobs_per=GRID["jobs_per"])
    n_ticks = GRID["horizon_ms"] // cfg.tick_ms + 80
    from multi_cluster_simulator_tpu.workload.traces import uniform_stream
    for s in (17, 18):
        arr = uniform_stream(GRID["C"], GRID["jobs_per"], GRID["horizon_ms"],
                             max_cores=24, max_mem=18_000, max_dur_ms=30_000,
                             seed=s)
        jta = jpack(arr, n_ticks, cfg.tick_ms)
        tta = tengine.pack_arrivals_by_tick(port_arrivals(arr), n_ticks,
                                            tcfg.tick_ms)
        for name in GRID["policies"]:
            want = jax_leaves(JEngine(cfg, policies=JPolicySet((name,)))
                              .run_jit()(jinit(cfg, JT._specs(GRID["C"])),
                                         jta, n_ticks))
            got = tengine.Engine(tcfg, device="cpu",
                                 policies=tbase.PolicySet((name,))).run(
                init_state(tcfg, T._specs(GRID["C"]), device="cpu"), tta,
                n_ticks)
            assert_leaves_equal(want, interop.to_numpy(got))


def test_sweep_digests_equal_jax():
    jnames, tnames = JT.sweep_policies(), T.sweep_policies()
    assert jnames == tnames and len(tnames) == 48
    cfg, tcfg = JT._cfg(), T._cfg()
    jps, tps = JPolicySet(jnames), tbase.PolicySet(tnames)
    want = [jdigest(jps.params_for(cfg, n)) for n in jnames]
    got = [tbase.params_digest(tps.params_for(tcfg, n)) for n in tnames]
    assert got == want and len(set(got)) == 48


def test_grid_digest_equals_jax():
    names = ("fifo", "delay-eager", "gavel")
    cfg, tcfg = JT._cfg(jobs_per=30), T._cfg(jobs_per=30)
    jp = [JPolicySet(names).params_for(cfg, n) for n in names]
    tp = [tbase.PolicySet(names).params_for(tcfg, n) for n in names]
    args = (names, [17, 18], 8, 30, 60_000, 20)
    assert T._grid_digest(*args, tcfg, tp) == JT._grid_digest(*args, cfg, jp)


def test_resume_cells(tmp_path):
    """tests/test_preempt.py:477 on the port: verified cells persist with
    the grid digest; a rerun runs only the missing variant's lanes and the
    merged rows equal a fresh sweep's; a changed grid fails fast."""
    rp = str(tmp_path / "cells.json")
    kw = dict(RESUME, device="cpu")
    full = T.run_tournament(**kw)
    T.run_tournament(**kw, resume_path=rp)
    cache = json.load(open(rp))
    del cache["completed"]["delay"]  # a kill after variant 1
    json.dump(cache, open(rp, "w"))
    res = T.run_tournament(**kw, resume_path=rp)
    assert res["resumed_variants"] == ["fifo"]
    assert res["lanes"] == 2  # only delay's two seeds ran
    strip = [{k: v for k, v in r.items() if k != "resumed"}
             for r in res["rows"]]
    assert strip == full["rows"]
    with pytest.raises(ValueError, match="different grid"):
        T.run_tournament(**{**kw, "jobs_per": 20}, resume_path=rp)
    with pytest.raises(ValueError, match="requires cell verification"):
        T.run_tournament(**kw, resume_path=rp, verify_cells=False)


def test_resume_caches_cross_packages(tmp_path):
    """A cache the reference wrote resumes in the port (and the other way
    round): the same grid digest, the same JSON keys, the same rows."""
    jp, tp = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    want = JT.run_tournament(**RESUME, resume_path=jp)
    cache = json.load(open(jp))
    del cache["completed"]["fifo"]
    json.dump(cache, open(jp, "w"))
    got = T.run_tournament(**RESUME, resume_path=jp, device="cpu")
    assert got["resumed_variants"] == ["delay"]
    assert got["grid_digest"] == want["grid_digest"]
    strip = [{k: v for k, v in r.items() if k != "resumed"}
             for r in got["rows"]]
    assert strip == [{k: v for k, v in r.items() if k != "resumed"}
                     for r in want["rows"]]
    T.run_tournament(**RESUME, resume_path=tp, device="cpu")
    cache = json.load(open(tp))
    del cache["completed"]["delay"]
    json.dump(cache, open(tp, "w"))
    back = JT.run_tournament(**RESUME, resume_path=tp)
    assert back["resumed_variants"] == ["fifo"]


def test_refusals():
    """tests/test_policies.py:208's refusals: a shard or device A/B
    request that cannot engage raises."""
    with pytest.raises(AssertionError, match="cannot engage"):
        T.run_tournament(policies=("fifo",), n_seeds=2, C=4, jobs_per=8,
                         horizon_ms=5_000, drain_ticks=5, verify_cells=False,
                         shard_seeds="always", shard_devices=1, device="cpu")
    with pytest.raises(AssertionError, match="device-ab requires"):
        T.run_tournament(policies=("fifo",), n_seeds=3, C=4, jobs_per=8,
                         horizon_ms=5_000, drain_ticks=5, verify_cells=False,
                         shard_seeds="auto", shard_devices=2, device_ab=True,
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_tournament(policies=("fifo",), n_seeds=1, C=2, jobs_per=4,
                             horizon_ms=2_000, drain_ticks=2)


def test_sharded_seed_axis_with_device_ab_equals_one_process():
    """tests/test_policies.py:189: the seed axis over 2 rank processes
    (``shard_seeds="always"``, ``shard_devices=2``): every cell still its
    standalone run, the device A/B's one-process grid bitwise the sharded
    one, and the rows and ranking those of the one-process tournament."""
    kw = dict(policies=("fifo", "delay"), n_seeds=2, C=8, jobs_per=24,
              horizon_ms=60_000, drain_ticks=30, device="cpu")
    detail = T.run_tournament(shard_seeds="always", shard_devices=2,
                              device_ab=True, **kw)
    assert detail["replication_axis_sharded"] and detail["devices"] == 2
    assert detail["cells_bit_identical_to_standalone"]
    ab = detail["replication_shard_ab"]
    assert ab["grids_bit_identical"] and ab["devices"] == 2
    one = T.run_tournament(shard_seeds="never", **kw)
    assert not one["replication_axis_sharded"]
    assert detail["rows"] == one["rows"]
    assert detail["ranking"] == one["ranking"]


def test_cvx_pricing_grid_as_lanes():
    """tests/test_market_cvx.py:437's pricing axis as one lane-stacked run:
    each lane bitwise its standalone run and the reference's."""
    cfg = market_cfg(MatchKind.CVX)
    specs, arr = two_buyer_two_seller()
    for reg, var in ((JREGISTRY, jvariant), (tbase.REGISTRY, tbase.variant)):
        if "delay-cvx-open" not in reg:
            var("delay-cvx-open", "delay", mkt_iters=0)
    lineup = ("delay", "delay-cvx-fast", "delay-cvx-tight",
              "delay-cvx-smooth", "delay-cvx-open")
    n = 45
    jps = JPolicySet(lineup)
    fn = jax.jit(JEngine(cfg, policies=jps).run, static_argnums=(2,))
    tcfg = port_cfg(cfg)
    tspecs = [tspec.uniform_cluster(1, 5), tspec.uniform_cluster(2, 5)] + [
        tspec.ClusterSpec(id=c, nodes=(tspec.NodeSpec(id=1, cores=8,
                                                      memory=8000),))
        for c in (3, 4)]
    tps = tbase.PolicySet(lineup)
    eng = tengine.Engine(tcfg, device="cpu", policies=tps)
    parr = port_arrivals(arr)
    ta = tengine.pack_arrivals_by_tick(parr, n, tcfg.tick_ms)
    cells = [tps.params_for(tcfg, name) for name in lineup]
    out = eng.run(
        tenancy.stack_tenant_states([init_state(tcfg, tspecs, device="cpu")
                                     for _ in lineup]),
        tenancy.stack_tick_arrivals([ta] * len(lineup)), n,
        tenancy.stack_lanes(cells))
    finals = []
    for i, name in enumerate(lineup):
        got = interop.to_numpy(tenancy.tenant_cell(out, i))
        solo = eng.run(init_state(tcfg, tspecs, device="cpu"), parr, n,
                       cells[i])
        assert_leaves_equal(interop.to_numpy(solo), got)
        assert_leaves_equal(jax_leaves(fn(jinit(cfg, specs), arr, n,
                                          jps.params_for(cfg, name))), got)
        finals.append(got)
    # the axis steers: the zero-iteration variant ends elsewhere
    assert not np.array_equal(finals[0][".trader.mkt_price"],
                              finals[-1][".trader.mkt_price"])
