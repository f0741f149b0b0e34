"""The port's live hosts (``services/scheduler_host.py``, the trader, the
workload client, the log sink and the CLI) on the CPU, held against the
JAX package's: a ``SchedulerService`` of each package fed the same jobs
over HTTP, its tick loop held off and ``_tick_once`` called by hand with a
``/borrow`` and a ``/lent`` landing while the tick is in flight, ends every
tick in the JAX host's state; the golden wire fixtures pass through the
port's encoders and decoders byte for byte; a constellation of port
schedulers trades with JAX traders over gRPC under a JAX registry; the
port's CLI brings up a registry, a scheduler and a client. Wall-clock
tests keep tests/test_services.py's timeouts and ``SPEED``."""

import json
import os
import re
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from multi_cluster_simulator_tpu.config import (
    PolicyKind, SimConfig, TraderConfig,
)
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.services import host_ops as jhost_ops
from multi_cluster_simulator_tpu.services.registry import (
    RegistryServer as JRegistry, SERVICE_TRADER,
)
from multi_cluster_simulator_tpu.services.scheduler_host import (
    SchedulerService as JSched,
)
from multi_cluster_simulator_tpu.services.trader_host import (
    TraderService as JTrader,
)
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.services import host_ops, httpd
from multi_cluster_simulator_tpu_torch.services.logsink import (
    LogSinkServer, set_client_logger,
)
from multi_cluster_simulator_tpu_torch.services.registry import (
    SERVICE_SCHEDULER, RegistryServer,
)
from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
    SchedulerService, job_to_json,
)
from multi_cluster_simulator_tpu_torch.services.workload import (
    WorkloadClientService,
)
from multi_cluster_simulator_tpu_torch.utils.trace import total_drops
from tests.conftest import free_port
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tests.test_torch_serving import wait_until, watch

REPO = Path(__file__).resolve().parents[1]
SPEED = 200.0  # tests/test_services.py's: 1 virtual second ≈ 5 ms wall


def small_cfg(policy=PolicyKind.DELAY, borrowing=False):
    """tests/test_services.py small_cfg (the JAX class)."""
    return SimConfig(policy=policy, borrowing=borrowing, queue_capacity=64,
                     max_running=128, max_arrivals=512, max_nodes=5,
                     max_virtual_nodes=2, max_ingest_per_tick=32,
                     trader=TraderConfig(enabled=False))


def port_sched(name, spec, cfg, **kw):
    return SchedulerService(name, spec, port_cfg(cfg), device="cpu", **kw)


@pytest.fixture
def registry():
    reg = RegistryServer(port=0, speed=SPEED)
    reg.start()
    yield reg
    reg.shutdown()


# ---------------------------------------------------------------------------
# the live host against JAX's, tick by tick, with mutations mid-tick
# ---------------------------------------------------------------------------

class Owner:
    """A peer scheduler's /lent endpoint: the owner a /borrow names, where
    the host returns the foreign job once it finishes."""

    def __init__(self):
        self.got = []
        self.srv = httpd.RoutedHTTPServer()
        self.srv.route("POST", "/lent", self._lent)
        self.srv.start()
        self.url = self.srv.url

    def _lent(self, body, headers):
        self.got.append(json.loads(body)["Id"])
        return 200, None


def serve_only(s):
    """The host's HTTP surface without its tick loop."""
    s.register_handlers()
    s.httpd.start()


@pytest.mark.parametrize("policy", ["FIFO", "DELAY"])
def test_live_host_ticks_equal_jax_with_mid_tick_mutations(policy):
    """One C=1 host of each package, fed the same jobs over HTTP (both
    endpoints), ticked by hand: at chosen ticks a /borrow from a peer and
    a /lent of a borrowed job land over HTTP while the tick is in flight
    (the journal replays them onto the tick's result), and under FIFO a
    borrow round commits a wait head. After every tick both hosts' states
    are equal, and each returned the same finished foreign jobs."""
    kind = PolicyKind[policy]
    cfg = SimConfig(policy=kind, borrowing=kind is PolicyKind.FIFO,
                    queue_capacity=16, max_running=32, max_arrivals=64,
                    max_nodes=3, max_virtual_nodes=2, max_ingest_per_tick=8,
                    trader=TraderConfig(enabled=False))
    own = uniform_cluster(1, 3, cores=8, memory=8_000)
    hosts = {"jax": JSched(f"j-live-{policy}", own, cfg, grpc_port=None),
             "torch": port_sched(f"t-live-{policy}",
                                 tspec.uniform_cluster(1, 3, cores=8,
                                                       memory=8_000),
                                 cfg, grpc_port=None)}
    owners = {k: Owner() for k in hosts}
    errors = watch(*hosts.values())
    rng = np.random.default_rng(17)
    ep, other = ("/", "/delay") if policy == "FIFO" else ("/delay", "/")
    mid = {}  # tick -> [(path, body)] posted while that tick is in flight

    def job(jid, big=False, owner=""):
        cores = 9 if big else int(rng.integers(1, 5))
        return job_to_json(jid, cores, int(rng.integers(100, 3_000)),
                           int(rng.integers(1_000, 4_000)), ownership=owner)

    feed = {t: [(other if jid % 11 == 0 else ep,
                 job(jid, big=policy == "FIFO" and jid % 13 == 0))
                for jid in range(100 * t + 1, 100 * t + int(
                    rng.integers(1, 4)) + 1)] for t in range(24)}
    for t in (3, 9, 15):
        mid[t] = [("/borrow", job(5_000 + t, owner="OWNER"))]
    borrowed = []
    codes = {name: [] for name in hosts}
    for name, s in hosts.items():
        serve_only(s)
        orig = s._tick_fn

        def in_flight(state, arr, s=s, name=name, orig=orig):
            for path, body in mid.get(s.ticks_run, []):
                body = {k: owners[name].url if v == "OWNER" else v
                        for k, v in body.items()}
                code, _ = httpd.post_json(s.url + path, body)
                assert code in (200, 406), (path, code)
                codes[name].append((path, code))
            return orig(state, arr)

        s._tick_fn = in_flight
    try:
        for t in range(24):
            for name, s in hosts.items():
                for path, body in feed[t]:
                    code, _ = httpd.post_json(s.url + path, body)
                    assert code == 200
                if policy == "FIFO" and t in (6, 12):
                    # a borrow round that won: the wait head moves to the
                    # BorrowedQueue (scheduler_host._process_borrow)
                    head = interop.to_numpy(hosts["torch"].state)[
                        ".wait.data"][0, 0]
                    if name == "torch":
                        borrowed.append(head.copy())
                    vec = head if name == "torch" else jnp.asarray(head)
                    op = host_ops.commit_borrow if name == "torch" else \
                        jhost_ops.commit_borrow
                    s._mutate(lambda st, op=op, vec=vec: (op(st, vec), None))
                if policy == "FIFO" and t in (8, 14) and borrowed:
                    b = borrowed[0]
                    mid.setdefault(t + 1, []).append(("/lent", job_to_json(
                        int(b[0]), int(b[1]), int(b[2]), int(b[4]))))
            for s in hosts.values():
                s._tick_once()
            assert_leaves_equal(jax_leaves(hosts["jax"].state),
                                interop.to_numpy(hosts["torch"].state))
        assert codes["torch"] == codes["jax"]
        assert ("/borrow", 200) in codes["torch"]
        st = hosts["torch"].stats()
        assert st["placed_total"] > 20
        for s in hosts.values():  # every return posted
            s._pool.shutdown(wait=True)
        if policy == "FIFO":
            # the lent jobs ran here and went back to their owner
            assert sorted(owners["jax"].got) == sorted(owners["torch"].got)
            assert owners["torch"].got
            assert st["lent"] == 0
            assert borrowed and st["borrowed"] < len(borrowed)
        else:
            # the Delay() loop never drains the LentQueue (as in Go)
            assert st["lent"] == 3
            assert owners["jax"].got == owners["torch"].got == []
    finally:
        for name, s in hosts.items():
            s.httpd.shutdown()
            s._pool.shutdown(wait=True)
            owners[name].srv.shutdown()
    assert not errors.records, errors.records


def test_ring_full_returns_retryable_503():
    """tests/test_services.py:353 on the port: a full staging ring answers
    503 with a retry quote, and every acked job places once the tick loop
    drains it."""
    cfg = SimConfig(policy=PolicyKind.DELAY, queue_capacity=64,
                    max_running=64, max_arrivals=6, max_ingest_per_tick=8,
                    max_nodes=5, max_virtual_nodes=2,
                    trader=TraderConfig(enabled=False))
    s = port_sched("t-ringfull", tspec.uniform_cluster(1, 5), cfg)
    for i in range(cfg.max_arrivals):
        status, _ = s._handle_submit_delay(
            json.dumps(job_to_json(i + 1, 1, 100, 5_000)).encode(), {})
        assert status == 200
    status, body = s._handle_submit_delay(
        json.dumps(job_to_json(99, 1, 100, 5_000)).encode(), {})
    assert status == 503 and json.loads(body)["RetryAfterMs"] > 0
    status, _ = s._handle_submit_fifo(
        json.dumps(job_to_json(98, 1, 100, 5_000)).encode(), {})
    assert status == 503
    assert s.meter.snapshot()["counters"]["submit_rejected"] == 2
    for _ in range(3):
        s._tick_once()
    status, _ = s._handle_submit_delay(
        json.dumps(job_to_json(99, 1, 100, 5_000)).encode(), {})
    assert status == 200
    for _ in range(12):
        if s.stats()["placed_total"] == cfg.max_arrivals + 1:
            break
        s._tick_once()
    assert all(v == 0 for v in total_drops(s.state).values())
    assert s.stats()["placed_total"] == cfg.max_arrivals + 1


def test_handlers_do_not_block_on_the_tick():
    """tests/test_services.py:907 on the port: the tick runs outside the
    state lock on a clone, a /borrow mid-tick answers at once, and its
    push survives the swap."""
    s = port_sched("t-noblock", tspec.uniform_cluster(1, 5), small_cfg())
    warm = json.dumps(job_to_json(1, 2, 500, 10_000,
                                  ownership="http://peer:1")).encode()
    assert s._handle_borrow(warm, {})[0] == 200
    s._tick_once()
    orig = s._tick_fn

    def slow_tick(state, arr):
        time.sleep(0.8)
        return orig(state, arr)

    s._tick_fn = slow_tick
    th = threading.Thread(target=s._tick_once)
    th.start()
    time.sleep(0.2)
    body = json.dumps(job_to_json(2, 2, 500, 10_000,
                                  ownership="http://peer:1")).encode()
    t0 = time.time()
    status, _ = s._handle_borrow(body, {})
    dt = time.time() - t0
    th.join()
    assert status == 200
    assert dt < 0.4, f"handler stalled {dt:.2f}s behind the in-flight tick"
    assert s.stats()["lent"] == 2


def test_live_delay_placement_and_endpoint_routing(registry):
    """The paced loop of the port's host: /delay jobs place, a POST / job
    sits in the ReadyQueue a DELAY host never drains (the reference's
    endpoint routing), /newClient answers the Go Cluster JSON, the meter
    counts the submits, and no tick fails."""
    with port_sched("t-live-delay", tspec.uniform_cluster(1, 5), small_cfg(),
                    registry_url=registry.url, speed=SPEED) as s:
        errors = watch(s)
        for i in range(10):
            status, _ = httpd.post_json(s.url + "/delay",
                                        job_to_json(i + 1, 4, 2000, 30_000))
            assert status == 200
        status, _ = httpd.post_json(s.url + "/",
                                    job_to_json(900, 4, 2000, 30_000))
        assert status == 200
        wait_until(lambda: s.stats()["placed_total"] == 10,
                   msg="all 10 jobs placed")
        wait_until(lambda: s.stats()["ready"] == 1, msg="/ job in ready")
        status, body = httpd.get(s.url + "/newClient")
        cluster = json.loads(body)
        assert status == 200 and len(cluster["Nodes"]) == 5
        assert b"jobs_in_queue 10" in httpd.get(s.url + "/metrics")[1]
        ok, detail = s.health()
        assert ok and detail["ticks_run"] > 0, detail
        time.sleep(0.3)
        assert s.stats()["placed_total"] == 10
    assert not errors.records, errors.records


def test_borrowing_over_http(registry):
    """Two FIFO port hosts: A's wait head is broadcast to B (/borrow), B
    runs it and returns it to A's /lent (tests/test_services.py:150)."""
    tiny = tspec.ClusterSpec(id=1, nodes=(tspec.NodeSpec(
        id=1, cores=4, memory=4000),))
    cfg = small_cfg(policy=PolicyKind.FIFO, borrowing=True)
    a = port_sched("t-borrower", tiny, cfg, registry_url=registry.url,
                   speed=SPEED)
    b = port_sched("t-lender", tspec.uniform_cluster(2, 5), cfg,
                   registry_url=registry.url, speed=SPEED)
    with a, b:
        errors = watch(a, b)
        wait_until(lambda: len(a.registry._providers.get(
            SERVICE_SCHEDULER, [])) == 2, msg="peers discovered")
        status, _ = httpd.post_json(a.url + "/",
                                    job_to_json(77, 8, 2000, 20_000))
        assert status == 200
        wait_until(lambda: a.stats()["borrowed"] == 1, msg="A borrowed")
        wait_until(lambda: b.stats()["placed_total"] >= 1, msg="B placed it")
        wait_until(lambda: a.stats()["borrowed"] == 0, msg="A got it back")
        assert b.stats()["lent"] == 0
    assert not errors.records, errors.records


def test_port_schedulers_trade_with_jax_traders_over_grpc():
    """A mixed constellation: two port schedulers (their ResourceChannel
    gRPC surface the port's copy of rpc.py), two JAX traders and a JAX
    registry. A's trader sizes a contract from A's Level1 backlog, B's
    trader approves and B's port host carves; A's port host attaches the
    virtual node and places the job that could not fit
    (tests/test_services.py:177)."""
    reg = JRegistry(port=0, speed=SPEED)
    reg.start()
    cfg = small_cfg()
    tcfg = TraderConfig(cooldown_success_ms=30_000)
    a = port_sched("t-tsched-a", tspec.uniform_cluster(1, 2), cfg,
                   registry_url=reg.url, speed=SPEED)
    b = port_sched("t-tsched-b", tspec.uniform_cluster(2, 5), cfg,
                   registry_url=reg.url, speed=SPEED)
    try:
        with a, b:
            errors = watch(a, b)
            ta = JTrader("j-trader-a", a.grpc_addr, tcfg=tcfg,
                         registry_url=reg.url, speed=SPEED)
            tb = JTrader("j-trader-b", b.grpc_addr, tcfg=tcfg,
                         registry_url=reg.url, speed=SPEED)
            with ta, tb:
                wait_until(lambda: len(ta.registry._providers.get(
                    SERVICE_TRADER, [])) == 2, msg="traders discovered")
                for i in range(5):
                    httpd.post_json(a.url + "/delay",
                                    job_to_json(i + 1, 16, 12_000,
                                                60_000_000))
                wait_until(lambda: tb.trades_sold >= 1, timeout=90,
                           msg="trader B sells")
                wait_until(lambda: a.stats()["placed_total"] == 5,
                           timeout=90, msg="overflow placed on the vnode")
                wait_until(lambda: ta.trades_won >= 1, msg="trader A won")
                with a._slock:
                    host = interop.to_numpy(a.state)
                active = host[".node_active"][0]
                assert active[cfg.max_nodes:].any(), "no virtual node"
                assert host[".node_cap"][0, cfg.max_nodes:].sum() > 0
                assert b.stats()["running"] >= 1
        assert not errors.records, errors.records
    finally:
        reg.shutdown()


def test_port_trader_sizes_like_the_batch_market():
    """The port's TraderService sizes a contract through ops/sizing.py on
    its device from a streamed backlog, equal to the JAX trader's, for
    each sizing."""
    from multi_cluster_simulator_tpu_torch.services.trader_host import (
        TraderService,
    )
    jobs = [(4, 2048, 30_000), (16, 12_000, 60_000), (1, 100, 5_000),
            (8, 4_096, 45_000)]

    class Batch:
        def __init__(self):
            self.jobs = [types.SimpleNamespace(
                cores_needed=c, memory_needed=m,
                unix_time_seconds=types.SimpleNamespace(
                    ToMilliseconds=lambda d=d: d)) for c, m, d in jobs]

    class Sched:
        def provide_jobs(self):
            return [Batch()]

    for sizing in ("asbuilt", "sane"):
        tcfg = TraderConfig(small_node_sizing=sizing)
        svc = {"jax": JTrader("j-size", "127.0.0.1:1", tcfg=tcfg),
               "torch": TraderService("t-size", "127.0.0.1:1", tcfg=tcfg,
                                      device="cpu")}
        out = {}
        for k, s in svc.items():
            s.sched = Sched()
            out[k] = [s._size_contract(kind).SerializeToString()
                      for kind in ("fast", "small")]
        assert out["torch"] == out["jax"]


def test_workload_client_and_log_sink(tmp_path, registry):
    """The port's workload client learns a port host's cluster over
    /newClient and streams jobs the host places; the host's log lines
    reach the port's log sink (tests/test_services.py:283, :295)."""
    dest = tmp_path / "grading.log"
    sink = LogSinkServer(str(dest), registry_url=registry.url)
    sink.start()
    try:
        with port_sched("t-wsched", tspec.uniform_cluster(1, 5), small_cfg(),
                        registry_url=registry.url, speed=SPEED) as s:
            errors = watch(s)
            set_client_logger(s.logger, sink.url, "Scheduler")
            c = WorkloadClientService("t-wclient", s.url, speed=SPEED,
                                      max_jobs=5)
            with c:
                assert c.max_job_cores == 32 and c.max_job_mem == 24_000
                wait_until(lambda: c.jobs_sent >= 5, msg="client sent 5")
                wait_until(lambda: s.stats()["placed_total"] >= 3,
                           msg="host placed client jobs")
        wait_until(lambda: dest.exists() and "[Scheduler]"
                   in dest.read_text(), msg="remote log line")
    finally:
        sink.shutdown()
    assert not errors.records, errors.records


# ---------------------------------------------------------------------------
# the golden wire fixtures through the port
# ---------------------------------------------------------------------------

def _port_wire_module():
    """tests/test_wire_fixtures.py with every import of the JAX package
    pointed at the port: the same golden bytes, the port's encoders and
    decoders."""
    src = (REPO / "tests" / "test_wire_fixtures.py").read_text()
    src = re.sub(r"multi_cluster_simulator_tpu\b",
                 "multi_cluster_simulator_tpu_torch", src)
    mod = types.ModuleType("port_wire_fixtures")
    exec(compile(src, "tests/test_wire_fixtures.py (port)", "exec"),
         mod.__dict__)
    return mod


_WIRE = _port_wire_module()
WIRE_CASES = [(cls, m) for cls, obj in vars(_WIRE).items()
              if cls.startswith("Test") for m in vars(obj)
              if m.startswith("test_")]


@pytest.mark.parametrize("cls,meth", WIRE_CASES,
                         ids=[f"{c}.{m}" for c, m in WIRE_CASES])
def test_wire_fixture_through_the_port(cls, meth):
    getattr(getattr(_WIRE, cls)(), meth)()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

class Proc:
    """A port CLI child (tests/test_cli.py _Proc), its stdout drained by a
    thread so a wait has a deadline."""

    def __init__(self, reg_port, *args):
        import queue
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "multi_cluster_simulator_tpu_torch.services.main", "--speed",
             "200", "--registry", f"http://127.0.0.1:{reg_port}",
             "--device", "cpu", *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=REPO,
            env=dict(os.environ))
        self.lines = queue.Queue()
        threading.Thread(target=lambda: [self.lines.put(x)
                                         for x in self.proc.stdout],
                         daemon=True).start()

    def await_line(self, prefix, timeout=120):
        import queue
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                assert self.proc.poll() is None, f"died awaiting {prefix!r}"
                continue
            if line.startswith(prefix):
                return line.strip()
        raise AssertionError(f"timed out waiting for {prefix!r}")

    def stop(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=30)
            except Exception:
                self.proc.kill()


def test_cli_registry_scheduler_client_topology(tmp_path):
    """tests/test_cli.py:77 with the port's CLI on ``--device cpu``."""
    reg_port = free_port()
    ck = str(tmp_path / "s.ckpt")
    reg = Proc(reg_port, "registry", "--port", str(reg_port))
    sched = client = None
    try:
        reg.await_line("registry at ")
        sched = Proc(reg_port, "scheduler", "assets/cluster_small.json",
                     "--checkpoint", ck)
        url = sched.await_line("scheduler HTTP ").split()[2]
        status, body = httpd.get(url + "/newClient")
        assert status == 200 and len(json.loads(body)["Nodes"]) == 5
        client = Proc(reg_port, "client", url, "--max-jobs", "5")
        wait_until(lambda: b"jobs_in_queue" in (
            httpd.get(url + "/metrics")[1] or b""), timeout=120,
            period=0.3, msg="the host's meter sees the client's jobs")
    finally:
        for p in (client, sched, reg):
            if p is not None:
                p.stop()
    assert os.path.exists(ck), "checkpoint file written"
