"""The port's services tier, module by module: the copies of the JAX
package's jax-free service modules stay equal to their references, the
services import neither jax nor the JAX package, the device-boundary state
ops (``services/host_ops.py``) and the A2 ops they call equal the JAX
ones bitwise, and the kernels' first build is made once however many
threads reach it.

The JAX package runs on the CPU (tests/conftest.py); the port on
``device="cpu"``, its plain path."""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core.engine import Engine as JEngine
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.ops import queues as JQ
from multi_cluster_simulator_tpu.ops import runset as JR
from multi_cluster_simulator_tpu.services import host_ops as jops
from multi_cluster_simulator_tpu.workload.traces import uniform_stream
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.kernels import build
from multi_cluster_simulator_tpu_torch.obs import profile as tprofile
from multi_cluster_simulator_tpu_torch.ops import queues as TQ
from multi_cluster_simulator_tpu_torch.ops import runset as TR
from multi_cluster_simulator_tpu_torch.services import host_ops as tops
from tests.test_torch_engine import assert_leaves_equal, jax_leaves

REPO = Path(__file__).resolve().parents[1]
JPKG = REPO / "multi_cluster_simulator_tpu"
TPKG = REPO / "multi_cluster_simulator_tpu_torch"

# Modules the port keeps as copies (the same text, the package renamed):
# they import no JAX, so the runtime-import rule makes them copies.
COPIES = (
    "services/backoff.py", "services/wal.py", "services/telemetry.py",
    "services/httpd.py", "services/registry.py", "services/lifecycle.py",
    "services/logsink.py", "services/rpc.py", "services/workload.py",
    "obs/promtext.py", "services/proto/__init__.py",
    "services/proto/generate.sh",
    *(f"services/proto/{m}{ext}" for m in (
        "otlp_common", "otlp_metrics", "otlp_metrics_service",
        "otlp_resource", "otlp_trace", "otlp_trace_service",
        "resource_channel", "trader") for ext in ("_pb2.py", ".proto")),
)

PORTED = ("services/__init__.py", "services/host_ops.py",
          "services/scheduler_host.py", "services/serving.py",
          "services/trader_host.py", "services/main.py")


def renamed(text: str) -> str:
    import re
    return re.sub(r"multi_cluster_simulator_tpu\b",
                  "multi_cluster_simulator_tpu_torch", text)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_its_reference(rel):
    assert (TPKG / rel).read_text() == renamed((JPKG / rel).read_text())


def test_every_reference_service_module_has_a_port():
    ref = sorted(str(p.relative_to(JPKG)) for p in
                 (JPKG / "services").rglob("*")
                 if p.is_file() and "__pycache__" not in p.parts)
    assert ref and set(ref) <= set(COPIES) | set(PORTED)
    for rel in ref:
        assert (TPKG / rel).is_file(), rel


def test_services_import_neither_jax_nor_the_jax_package():
    """Every port service module (and promtext) in a fresh interpreter:
    neither ``jax`` nor ``multi_cluster_simulator_tpu`` is loaded."""
    mods = [f"multi_cluster_simulator_tpu_torch.{r[:-3].replace('/', '.')}"
            for r in COPIES + PORTED if r.endswith(".py")]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'multi_cluster_simulator_tpu' or "
              "m.startswith('multi_cluster_simulator_tpu.'))\n"
              "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_two_packages_share_the_proto_descriptors():
    """Both packages' generated modules load in one process: identical
    serialized files dedupe in the default pool."""
    from multi_cluster_simulator_tpu.services.proto import trader_pb2 as a
    from multi_cluster_simulator_tpu_torch.services.proto import (
        otlp_trace_pb2, trader_pb2 as b,
    )
    assert a.DESCRIPTOR is b.DESCRIPTOR
    assert otlp_trace_pb2.Span().SerializeToString() == b""


def test_kernel_load_builds_once_across_threads(monkeypatch):
    """Eight threads reaching a kernel's first use together: one build,
    one library, every thread gets it."""
    calls = []

    def fake_build(names=None):
        calls.append(list(names))
        time.sleep(0.05)  # wide enough for every thread to arrive
        return {n: "" for n in names}

    lib = object()
    build._load.cache_clear()
    monkeypatch.setattr(build, "build_all", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: lib)
    got = []
    start = threading.Barrier(8)

    def worker():
        start.wait()
        got.append(build.load("fused_prefix_fifo"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        build._load.cache_clear()
    assert calls == [["fused_prefix_fifo"]]
    assert got == [lib] * 8


def test_annotate_dispatch_takes_the_serving_metadata():
    with tprofile.annotate_dispatch("serving", ticks=4, jobs=7):
        pass
    with torch.profiler.profile() as prof:
        with tprofile.annotate_dispatch("serving", ticks=4, jobs=7):
            torch.zeros(1) + 1
    names = [e.name for e in prof.events()]
    assert "mcs.dispatch.serving" in names


# ---------------------------------------------------------------------------
# the device-boundary ops against the JAX ones
# ---------------------------------------------------------------------------

def live_cfg(policy=PolicyKind.FIFO, **kw):
    base = dict(policy=policy, borrowing=policy is PolicyKind.FIFO,
                queue_capacity=8, max_running=16, max_arrivals=64,
                max_nodes=3, max_virtual_nodes=2, max_ingest_per_tick=8)
    base.update(kw)
    return SimConfig(**base)


def jax_from_leaves(template, leaves: dict):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(leaves[jax.tree_util.keystr(p)]), template)


def loaded_pair(cfg, C=1, ticks=12, seed=3):
    """A JAX state a few ticks into a stream (queues and the running set
    populated, a wait head under FIFO with borrowing), and the same state
    in the port on the CPU."""
    specs = [uniform_cluster(c + 1, cfg.max_nodes, cores=8, memory=8_000)
             for c in range(C)]
    arr = uniform_stream(C, 48, ticks * cfg.tick_ms, max_cores=12,
                         max_mem=9_000, max_dur_ms=30_000, seed=seed)
    js = JEngine(cfg).run_jit()(jinit_state(cfg, specs), arr, ticks)
    if isinstance(js, tuple):
        js = js[0]
    ts = interop.state_from_numpy(jax_leaves(js), device="cpu")
    return js, ts


def assert_pair(js, ts):
    assert_leaves_equal(jax_leaves(js), interop.to_numpy(ts))


def test_job_vec_equals_jobrec_make():
    for kw in (dict(id=7, cores=3, mem=900, dur=5_000),
               dict(id=9, cores=0, mem=1, gpu=2, dur=1, enq_t=4_000, owner=3),
               dict()):
        np.testing.assert_array_equal(np.asarray(JQ.JobRec.make(**kw).vec),
                                      tops.job_vec(**kw))


def test_queue_and_lend_ops_equal_jax():
    cfg = live_cfg()
    js, ts = loaded_pair(cfg)
    assert int(np.asarray(js.wait.count)[0]) > 0, "no wait head to borrow"
    before = interop.to_numpy(ts)
    for cores, mem in ((1, 1), (7, 7_999), (8, 100), (0, 0)):
        assert bool(jops.lend_feasible(js, cores, mem)) == \
            bool(tops.lend_feasible(ts, cores, mem))
    for i in range(cfg.queue_capacity + 2):  # past the lent capacity
        kw = dict(id=500 + i, cores=1 + i % 3, mem=100 * i, dur=1_000 * i,
                  owner=1 + i % 2)
        js = jops.push_lent(js, JQ.JobRec.make(**kw).vec)
        ts = tops.push_lent(ts, tops.job_vec(**kw))
        assert_pair(js, ts)
    head = np.asarray(JQ.head(js.wait).vec)[0]
    for vec in (head + np.eye(len(head), dtype=np.int32)[0], head):
        js = jops.commit_borrow(js, jnp.asarray(vec))  # a stale head first
        ts = tops.commit_borrow(ts, vec)
        assert_pair(js, ts)
    js = jops.remove_borrowed(js, jnp.asarray(head))
    ts = tops.remove_borrowed(ts, head)
    assert_pair(js, ts)
    for i in range(cfg.queue_capacity + 1):
        kw = dict(id=900 + i, cores=2, mem=300, dur=4_000, enq_t=7_000)
        js = jops.push_l0(jops.push_ready(js, JQ.JobRec.make(**kw).vec),
                          JQ.JobRec.make(**kw).vec)
        ts = tops.push_l0(tops.push_ready(ts, tops.job_vec(**kw)),
                          tops.job_vec(**kw))
        assert_pair(js, ts)
    js = jops.rebase_arrivals(js, 5)
    ts = tops.rebase_arrivals(ts, 5)
    assert_pair(js, ts)
    # the ops are pure: the first port state was never written
    assert_leaves_equal(before, interop.to_numpy(
        interop.state_from_numpy(before, device="cpu")))


def test_at_ops_equal_jax_on_a_multi_cluster_state():
    cfg = live_cfg(borrowing=False)
    js, ts = loaded_pair(cfg, C=3)
    for i in range(2 * cfg.queue_capacity):
        c = i % 3
        kw = dict(id=700 + i, cores=1, mem=50 + i, dur=2_000, enq_t=3_000)
        op_j = jops.push_l0_at if i % 2 else jops.push_ready_at
        op_t = tops.push_l0_at if i % 2 else tops.push_ready_at
        js = op_j(js, JQ.JobRec.make(**kw).vec, jnp.int32(c))
        ts = op_t(ts, tops.job_vec(**kw), c)
        assert_pair(js, ts)


@pytest.mark.parametrize("mode", ["asbuilt", "sane"])
def test_carve_and_virtual_node_ops_equal_jax(mode):
    cfg = live_cfg(PolicyKind.DELAY)
    js, ts = loaded_pair(cfg)
    for cores, mem, dur in ((3, 2_000, 40_000), (20, 30_000, 5_000),
                            (1, 1, 1), (5, 4_000, 9_000)):
        j2, jok = jops.carve_occupy(js, cores, mem, dur, mode=mode)
        t2, tok = tops.carve_occupy(ts, cores, mem, dur, mode=mode)
        assert bool(jok) == bool(tok)
        assert_pair(j2, t2)
        js, ts = (j2, t2) if bool(jok) else (js, ts)
    for expire in (False, True):
        for k in range(cfg.max_virtual_nodes + 1):  # past the free slots
            j2, jok = jops.add_virtual_node(js, 4 + k, 1_000, 30_000,
                                            vstart=cfg.max_nodes,
                                            expire=expire)
            t2, tok = tops.add_virtual_node(ts, 4 + k, 1_000, 30_000,
                                            vstart=cfg.max_nodes,
                                            expire=expire)
            assert bool(jok) == bool(tok)
            assert_pair(j2, t2)
            js, ts = j2, t2
        js, ts = loaded_pair(cfg)


def test_remove_matching_and_insert_row_equal_jax():
    """The A2 ops the services call, on random queues and running sets,
    against the JAX functions vmapped over clusters."""
    rng = np.random.default_rng(11)
    C, Qc, S = 4, 12, 10
    data = rng.integers(0, 4, (C, Qc, JQ.NF)).astype(np.int32)
    count = rng.integers(0, Qc + 1, C).astype(np.int32)
    jq = JQ.JobQueue(data=jnp.asarray(data), count=jnp.asarray(count))
    tq = TQ.JobQueue(data=torch.from_numpy(data.copy()),
                     count=torch.from_numpy(count.copy()))
    job = data[np.arange(C), np.minimum(count, Qc - 1)]
    for fields in (("id", "cores", "mem", "dur"), ("id",)):
        want = jax.vmap(lambda q, v: JQ.remove_matching(
            q, JQ.JobRec(vec=v), fields))(jq, jnp.asarray(job))
        got = TQ.remove_matching(tq, TQ.JobRec(vec=torch.from_numpy(job)),
                                 fields)
        np.testing.assert_array_equal(np.asarray(want.data), got.data)
        np.testing.assert_array_equal(np.asarray(want.count), got.count)
    rdata = rng.integers(-5, 50, (C, S, JR.RF)).astype(np.int32)
    active = rng.random((C, S)) < 0.5
    hot = np.zeros((C, S), bool)
    hot[np.arange(C), rng.integers(0, S, C)] = True
    hot[0] = False  # a cluster where nothing is written
    row = rng.integers(0, 99, JR.RF).astype(np.int32)
    want = jax.vmap(lambda d, a, h: JR.insert_row(
        JR.RunningSet(data=d, active=a), h, jnp.asarray(row)))(
        jnp.asarray(rdata), jnp.asarray(active), jnp.asarray(hot))
    got = TR.insert_row(TR.RunningSet(data=torch.from_numpy(rdata),
                                      active=torch.from_numpy(active)),
                        torch.from_numpy(hot), torch.from_numpy(row))
    np.testing.assert_array_equal(np.asarray(want.data), got.data)
    np.testing.assert_array_equal(np.asarray(want.active), got.active)


def test_services_refuse_to_start_without_a_card():
    """Every service that holds device state defaults to the card and
    raises without one; ``device="cpu"`` runs the plain path."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from multi_cluster_simulator_tpu_torch import config as tconfig
    from multi_cluster_simulator_tpu_torch.core import spec as tspec
    from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
        SchedulerService,
    )
    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )
    from multi_cluster_simulator_tpu_torch.services.trader_host import (
        TraderService,
    )
    cfg = tconfig.SimConfig(policy=tconfig.PolicyKind.FIFO, n_res=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SchedulerService("t-nocard-sched", tspec.uniform_cluster(1, 5), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingScheduler("t-nocard-serve", [tspec.uniform_cluster(1, 5)],
                         cfg, pacer=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TraderService("t-nocard-trader", "127.0.0.1:1")


def test_cli_refuses_without_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    out = subprocess.run(
        [sys.executable, "-m", "multi_cluster_simulator_tpu_torch.services"
         ".main", "--registry", "http://127.0.0.1:9", "scheduler",
         "assets/cluster_small.json"], cwd=REPO, capture_output=True,
        text=True, timeout=120, input="\n")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert json.loads((REPO / "assets/cluster_small.json").read_text())
