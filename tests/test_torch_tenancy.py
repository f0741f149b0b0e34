"""The port's tenant axis (``multi_cluster_simulator_tpu_torch.tenancy``)
against the JAX package's vmapped ``TenantBatch``, on the CPU.

The mirror of tests/test_tenancy.py: T independent constellations run as
the lanes of one lane-stacked run, and every tenant cell must equal its
standalone run — and the JAX batch, leaf by leaf through ``interop``,
every leaf bitwise (floats by their bits). Cases: T = 1 against
``Engine.run``; a mixed FIFO/DELAY batch with per-tenant thresholds; the
compact layout; the compressed driver (lane by lane); generative faults
with per-tenant seeds; a batch of six kinds under a batched ``idx``; two
tenants with borrowing; the metrics plane per tenant; the stacking and
padding errors; the params digest; the aggregates; the A16 refusal; and
the port's tenancy and envs importing with jax and flax blocked. JAX's
compiled batches are made once per module (fixtures)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu import tenancy as jten
from multi_cluster_simulator_tpu.config import FaultConfig
from multi_cluster_simulator_tpu.core import compact as jcompact
from multi_cluster_simulator_tpu.core.engine import pack_arrivals_by_tick
from multi_cluster_simulator_tpu.obs import device as jobs_device
from multi_cluster_simulator_tpu.policies.base import PolicySet as JSet
from multi_cluster_simulator_tpu.workload.traces import uniform_stream
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch import tenancy
from multi_cluster_simulator_tpu_torch.core import compact as tcompact
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.obs import device as tobs_device
from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
from tests.test_pipeline import _cfg, _specs
from tests.test_torch_engine import jax_leaves, port_cfg, specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICK_MS = 1_000
N_TICKS = 8
C = 3


def assert_bitwise(want: dict, got: dict, what=""):
    """Every leaf equal in key set, dtype, shape and bits."""
    assert set(want) == set(got), what
    for k in want:
        a, b = np.ascontiguousarray(want[k]), np.ascontiguousarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (what, k)


def port(tree) -> dict:
    return interop.to_numpy(tree)


def streams(cfg, T, n_ticks=N_TICKS, seed0=7, n_clusters=C, jobs=12):
    """Per-tenant bucketed streams padded to the shared tenant-max K (the
    JAX package's host numpy, which both packages take)."""
    tas = []
    for i in range(T):
        arr = uniform_stream(n_clusters, jobs, n_ticks * cfg.tick_ms, 24,
                             18_000, 3 * cfg.tick_ms, seed=seed0 + i)
        tas.append(pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms))
    k = max(np.asarray(ta.rows).shape[2] for ta in tas)
    return [jten.pad_tick_arrivals(ta, k) for ta in tas]


def port_ta(ta):
    return tstate.TickArrivals(rows=np.asarray(ta.rows),
                               counts=np.asarray(ta.counts))


def mixed_params(jtb, T, names=None):
    """T tenants with distinct knobs (the reference test's _mixed_params):
    members of the set in turn, a threshold and a fault seed a tenant."""
    names = jtb.engine.pset.names if names is None else names
    cells = []
    for i in range(T):
        cell = jten.default_tenant_params(
            jtb.cfg, pset=jtb.engine.pset, name=names[i % len(names)],
            fault_seed=i, quota_jobs=-1)
        cells.append(cell.replace(policy=cell.policy.replace(
            max_wait_ms=jnp.int32(2_000 + 1_000 * i))))
    return jten.stack_tenant_params(cells)


class World:
    """One tenant world run by both packages: JAX's vmapped run_io over
    the stacked batch, the port's TenantBatch over the same inputs, and
    the port's standalone run_io of every tenant."""

    def __init__(self, cfg, T, policies=None, plan=None, names=None,
                 n_clusters=C, jobs=12, tp=None):
        self.T = T
        jspecs, tspecs = specs(n_clusters)
        self.jtb = jten.TenantBatch(cfg, jspecs, policies=policies and
                                    JSet(policies), plan=plan)
        self.tcfg = port_cfg(cfg)
        self.tplan = None if plan is None else tcompact.CompactPlan(
            queue=plan.queue, run=plan.run, node=plan.node)
        self.ttb = tenancy.TenantBatch(
            self.tcfg, tspecs, policies=policies and PolicySet(policies),
            plan=self.tplan, device="cpu")
        self.jtp = mixed_params(self.jtb, T, names) if tp is None else tp
        self.ttp = interop.tenant_params_from_numpy(jax_leaves(self.jtp),
                                                    device="cpu")
        self.tas = streams(cfg, T, n_clusters=n_clusters, jobs=jobs)
        self.sta = jten.stack_tick_arrivals(self.tas)
        self.jout, self.jio = self.jtb.run_io_fn(donate=False)(
            self.jtb.init_stacked(self.jtp), self.sta.rows, self.sta.counts,
            self.jtp)

    def port_batch(self):
        rows, counts = (np.asarray(x) for x in (self.sta.rows,
                                                 self.sta.counts))
        return self.ttb.run_io_fn()(self.ttb.init_stacked(self.ttp), rows,
                                    counts, self.ttp)

    def check(self):
        """The port's batch equals JAX's, state and TickIO, and every cell
        its standalone port run."""
        out, io = self.port_batch()
        assert_bitwise(jax_leaves(self.jout), port(out), "state")
        assert_bitwise(jax_leaves(self.jio), port(io), "io")
        for i in range(self.T):
            cell = tenancy.tenant_cell(self.ttp, i)
            s0 = tenancy.init_tenant_state(self.tcfg, self.ttb.specs, cell,
                                           plan=self.tplan, device="cpu")
            ta = self.tas[i]
            solo, solo_io = self.ttb.engine.run_io(
                s0, np.asarray(ta.rows), np.asarray(ta.counts),
                params=cell.policy)
            assert_bitwise(port(solo), port(tenancy.tenant_cell(out, i)),
                           f"cell {i}")
            assert_bitwise(port(solo_io), port(tenancy.tenant_cell(io, i)),
                           f"cell {i} io")
        return out


@pytest.fixture(scope="module")
def mixed_world():
    return World(_cfg(), 4, policies=("fifo", "delay"))


# --------------------------------------------------------------------------
# parity pins
# --------------------------------------------------------------------------

def test_t1_equals_engine_run_and_jax():
    """One tenant through the batched driver is the engine: T=1 over a
    stacked stream == Engine.run over the plain stream, == JAX's."""
    cfg = _cfg()
    jspecs, tspecs = specs(C)
    jtb = jten.TenantBatch(cfg, jspecs)
    jtp = jtb.default_params(1)
    ta = streams(cfg, 1)[0]
    jout = jtb.run_fn(N_TICKS, donate=False)(
        jtb.init_stacked(jtp), jten.stack_tick_arrivals([ta]), jtp)

    tcfg = port_cfg(cfg)
    ttb = tenancy.TenantBatch(tcfg, tspecs, device="cpu")
    ttp = ttb.default_params(1)
    out = ttb.run_fn(N_TICKS)(ttb.init_stacked(ttp),
                              tenancy.stack_tick_arrivals([port_ta(ta)]),
                              ttp)
    cell = tenancy.tenant_cell(ttp, 0)
    ref = ttb.engine.run(tenancy.init_tenant_state(tcfg, tspecs, cell,
                                                   device="cpu"),
                         port_ta(ta), N_TICKS, params=cell.policy)
    assert_bitwise(port(ref), port(tenancy.tenant_cell(out, 0)))
    assert_bitwise(jax_leaves(jout), port(out))
    assert int(out.placed_total.sum()) > 0


def test_cells_equal_standalone_and_jax(mixed_world):
    """Every cell of a T=4 FIFO/DELAY batch with per-tenant thresholds
    and fault seeds equals its standalone run and JAX's vmapped batch."""
    out = mixed_world.check()
    assert tenancy.aggregate_placed(out) > 0


def test_compact_plan_composes():
    """The tenant axis over the compact layout: a derived plan threaded
    through init and dispatch, per cell and against JAX."""
    cfg = _cfg()
    arr = uniform_stream(C, 12, N_TICKS * cfg.tick_ms, 24, 18_000,
                         3 * cfg.tick_ms, seed=7)
    plan = jcompact.derive_plan(cfg, _specs(C), arr)
    World(cfg, 3, plan=plan).check()


def test_compressed_driver_composes():
    """Event-compressed time over the tenant axis: each lane leaps its own
    gaps (the port drives the batch lane by lane), each cell equal to its
    standalone compressed run and to JAX's vmapped batch."""
    cfg = _cfg()
    jspecs, tspecs = specs(C)
    jtb = jten.TenantBatch(cfg, jspecs)
    T = 3
    jtp = jtb.default_params(T)
    tas = streams(cfg, T)
    sta = jten.stack_tick_arrivals(tas)
    jout = jtb.run_compressed_fn(N_TICKS, donate=False)(
        jtb.init_stacked(jtp), sta, jtp)

    tcfg = port_cfg(cfg)
    ttb = tenancy.TenantBatch(tcfg, tspecs, device="cpu")
    ttp = ttb.default_params(T)
    out = ttb.run_compressed_fn(N_TICKS)(
        ttb.init_stacked(ttp), port_ta(sta), ttp)
    assert_bitwise(jax_leaves(jout), port(out))
    for i in range(T):
        cell = tenancy.tenant_cell(ttp, i)
        solo = ttb.engine.run_compressed(
            tenancy.init_tenant_state(tcfg, tspecs, cell, device="cpu"),
            port_ta(tas[i]), N_TICKS, params=cell.policy)[0]
        assert_bitwise(port(solo), port(tenancy.tenant_cell(out, i)))


def test_generative_faults_per_tenant_streams():
    """Distinct fault seeds give each tenant its own churn from one shared
    FaultConfig (the reseed at init from PRNGKey(fault_seed)); every cell
    equals its standalone run and JAX's."""
    cfg = _cfg(faults=FaultConfig(enabled=True, mode="generative",
                                  mttf_ms=4_000, mttr_ms=2_000, seed=3))
    world = World(cfg, 3, tp=None)
    out = world.check()
    f0, f1 = (port(tenancy.tenant_cell(out, i).faults) for i in (0, 1))
    assert not all(np.array_equal(f0[k], f1[k]) for k in f0), \
        "tenants 0/1 ran identical fault timelines"


def test_mixed_member_batch_against_jax():
    """A batched idx over six kinds (FIFO, DELAY, FFD, gavel, tesserae,
    rl): the port groups the lanes by kernel source, JAX switches per
    lane; every leaf equal, every cell its standalone run."""
    names = ("fifo", "delay-eager", "ffd", "gavel", "tesserae", "rl")
    cfg = _cfg(parity=False, n_res=2)
    World(cfg, 6, policies=names).check()


def test_borrowing_two_tenants_against_jax():
    """Two tenants with borrowing: the cross-cluster phases run per tenant
    on its [C] views, so no job borrows across tenants; equal to JAX's
    vmapped batch and to each standalone run."""
    cfg = _cfg(parity=False, borrowing=True, queue_capacity=8)
    out = World(cfg, 2, n_clusters=4, jobs=30).check()
    assert int(out.borrowed.count.sum() + out.lent.count.sum()
               + out.placed_total.sum()) > 0


def test_metrics_plane_per_tenant_against_jax(mixed_world):
    """run_io_fn(obs=True): each tenant's MetricsBuffer is its own, the
    tap per lane; the buffers equal JAX's vmapped run's."""
    w = mixed_world
    jmb = jax.vmap(jobs_device.metrics_init)(w.jtb.init_stacked(w.jtp))
    _, _, jmb = w.jtb.run_io_fn(donate=False, obs=True)(
        w.jtb.init_stacked(w.jtp), w.sta.rows, w.sta.counts, w.jtp, jmb)
    s0 = w.ttb.init_stacked(w.ttp)
    mbuf = w.ttb.metrics_init(s0)
    out, _, mbuf = w.ttb.run_io_fn(obs=True)(
        s0, np.asarray(w.sta.rows), np.asarray(w.sta.counts), w.ttp, mbuf)
    assert_bitwise(jax_leaves(jmb), port(mbuf))
    assert_bitwise(jax_leaves(w.jout), port(out))
    one = tobs_device.metrics_init(tenancy.tenant_cell(s0, 0))
    assert tuple(mbuf.ring_t.shape) == (4,) + tuple(one.ring_t.shape)


# --------------------------------------------------------------------------
# plumbing
# --------------------------------------------------------------------------

def test_stack_and_pad_errors_match_the_reference():
    """Ragged K refuses to stack, and a stream wider than the bucket to
    pad, with the reference's texts; padding is invisible to a run."""
    cfg = _cfg()
    tas = [port_ta(ta) for ta in streams(cfg, 2)]
    narrow = tstate.TickArrivals(rows=tas[0].rows[:, :, :1],
                                 counts=np.minimum(tas[0].counts, 1))
    with pytest.raises(ValueError, match="pad K to the tenant-max"):
        tenancy.stack_tick_arrivals([narrow, tas[1]])
    with pytest.raises(ValueError, match="exceeds the shared bucket"):
        tenancy.pad_tick_arrivals(tas[0], 1)
    with pytest.raises(ValueError, match="at least one tenant"):
        tenancy.stack_tenant_states([])
    with pytest.raises(ValueError, match="at least one tenant"):
        tenancy.stack_tenant_params([])
    wide = tenancy.pad_tick_arrivals(tas[0], tas[0].rows.shape[2] + 5)
    jwide = jten.pad_tick_arrivals(streams(cfg, 1)[0],
                                   tas[0].rows.shape[2] + 5)
    assert np.array_equal(wide.rows, np.asarray(jwide.rows))
    tcfg = port_cfg(cfg)
    _, tspecs = specs(C)
    eng = tenancy.TenantBatch(tcfg, tspecs, device="cpu").engine
    a, _ = eng.run_io(tstate.init_state(tcfg, tspecs, device="cpu"),
                      tas[0].rows, tas[0].counts)
    b, _ = eng.run_io(tstate.init_state(tcfg, tspecs, device="cpu"),
                      wide.rows, wide.counts)
    assert_bitwise(port(a), port(b))


def test_tenant_params_digest_equals_jax():
    """The digest tracks every leaf, character for character the
    reference's, for cells and stacked batches."""
    cfg = _cfg()
    tcfg = port_cfg(cfg)
    pairs = [(jten.default_tenant_params(cfg, fault_seed=s, quota_jobs=q),
              tenancy.default_tenant_params(tcfg, fault_seed=s,
                                            quota_jobs=q))
             for s, q in ((0, -1), (1, -1), (0, 64), (2**32 - 1, 7))]
    jd = jten.default_tenant_params(cfg)
    jd = jd.replace(policy=jd.policy.replace(max_wait_ms=jnp.int32(123)))
    pairs.append((jd, interop.tenant_params_from_numpy(jax_leaves(jd),
                                                       device="cpu")))
    for j, t in pairs:
        assert tenancy.tenant_params_digest(t) == jten.tenant_params_digest(j)
    assert len({tenancy.tenant_params_digest(t) for _, t in pairs}) == 5
    js = jten.stack_tenant_params([j for j, _ in pairs])
    ts = tenancy.stack_tenant_params([t for _, t in pairs])
    assert tenancy.tenant_params_digest(ts) == jten.tenant_params_digest(js)
    assert tenancy.n_tenants(ts) == 5 and tenancy.n_tenants(pairs[0][1]) == 1
    assert_bitwise(jax_leaves(js), port(ts))


def test_aggregates_sum_over_tenants(mixed_world):
    out, _ = mixed_world.port_batch()
    per_cell = sum(int(tenancy.tenant_cell(out, i).placed_total.sum())
                   for i in range(mixed_world.T))
    assert tenancy.aggregate_placed(out) == per_cell > 0
    assert all(v == 0 for v in tenancy.aggregate_drops(out).values())


def test_shard_tenant_batch_raises_for_a16():
    with pytest.raises(NotImplementedError, match="A16"):
        tenancy.shard_tenant_batch(None, None)


def test_tenancy_and_envs_import_without_jax(tmp_path):
    """In a fresh interpreter where jax and flax cannot be imported, the
    port's tenancy and envs import and run a small batch on the CPU, and
    nothing of jax or the JAX package is loaded."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
from multi_cluster_simulator_tpu_torch import SimConfig, uniform_cluster
from multi_cluster_simulator_tpu_torch import envs, tenancy
from multi_cluster_simulator_tpu_torch.utils import prng
cfg = SimConfig(queue_capacity=8, max_running=16, max_nodes=5, n_res=2,
                max_virtual_nodes=0)
specs = [uniform_cluster(c + 1, 5) for c in range(2)]
tb = tenancy.TenantBatch(cfg, specs, device="cpu")
tp = tb.default_params(2)
s = tb.init_stacked(tp)
assert tuple(s.arr_ptr.shape) == (2, 2)
env = envs.ClusterEnv(cfg, specs, 4, gen=envs.StreamGen(), device="cpu")
obs, es = env.reset_batch(prng.prng_key(3), 2)
step = env.batch_step_fn()
for _ in range(5):
    obs, r, done, info, es = step(es)
assert int(es.episodes.sum()) == 2
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "multi_cluster_simulator_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
