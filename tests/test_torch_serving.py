"""The port's serving front door (``services/serving.py``) held against
the JAX package's on the CPU: the same staged trace through both, over
real HTTP or the deterministic driver (``pacer=False``, ``seal_tick``,
``dispatch_sealed``), ends in bitwise equal states at window 1 and
window 4, per tenant under multi-tenant hosting (quotas included), and
equal to the port's own ``Engine.run`` over the bucketed stream; the
query endpoints answer the same bytes once the wall-clock fields are
masked. Mirrors tests/test_services.py's serving tests; the wall-clock
ones keep their timeouts and ``SPEED``."""

import json
import logging
import re
import threading
import time

import numpy as np
import pytest

from multi_cluster_simulator_tpu import tenancy as jtenancy
from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.services import httpd as jhttpd
from multi_cluster_simulator_tpu.services.scheduler_host import job_to_json
from multi_cluster_simulator_tpu.services.serving import (
    ServingScheduler as JServing,
)
from multi_cluster_simulator_tpu_torch import tenancy as ttenancy
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core.engine import (
    Engine as TEngine, pack_arrivals_by_tick,
)
from multi_cluster_simulator_tpu_torch.core.state import (
    Arrivals as TArrivals, init_state as tinit_state,
)
from multi_cluster_simulator_tpu_torch.services import httpd
from multi_cluster_simulator_tpu_torch.services.serving import (
    ServingScheduler,
)
from multi_cluster_simulator_tpu_torch import interop
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg

SPEED = 200.0  # tests/test_services.py's: 1 virtual second ≈ 5 ms wall


def wait_until(pred, timeout=30.0, period=0.05, msg="condition"):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return
        time.sleep(period)
    raise AssertionError(f"timed out waiting for {msg}")


class ErrorRecords(logging.Handler):
    """Collects every ERROR record of the loggers it is attached to: a
    swallowed failure (a failed dispatch ending the drive thread, a failed
    tick logged by the live loop) fails the test that checks it."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(self.format(record))


def watch(*services) -> ErrorRecords:
    h = ErrorRecords()
    for s in services:
        s.logger.addHandler(h)
    return h


def serving_cfg(**kw):
    """tests/test_services.py serving_cfg (the JAX class)."""
    base = dict(policy=PolicyKind.FIFO, parity=True, n_res=2,
                queue_capacity=64, max_running=64, max_arrivals=8,
                max_ingest_per_tick=8, max_nodes=5, max_virtual_nodes=0)
    base.update(kw)
    return SimConfig(**base)


def serving_trace(C, T, seed, mismatched_every=0):
    """tests/test_services.py _serving_trace: per-tick job lists of (c,
    id, cores, mem, dur, mismatched_endpoint)."""
    rng = np.random.default_rng(seed)
    out, jid = [], 1
    for t in range(T):
        row = []
        for c in range(C):
            for _ in range(int(rng.integers(0, 3))):
                mism = bool(mismatched_every
                            and jid % mismatched_every == 0)
                row.append((c, jid, int(rng.integers(1, 4)),
                            int(rng.integers(100, 2000)),
                            int(rng.integers(1000, 8001)), mism))
                jid += 1
        out.append(row)
    return out


def specs_pair(C):
    return ([uniform_cluster(c + 1, 5) for c in range(C)],
            [tspec.uniform_cluster(c + 1, 5) for c in range(C)])


def make(pkg, name, C, cfg, **kw):
    """A deterministic front door of either package (``pkg`` "jax" or
    "torch") over C clusters of ``cfg`` (the JAX class)."""
    js, ts = specs_pair(C)
    base = dict(pacer=False, warm_k=(4,), k_cap=32, max_staged=10 ** 6)
    base.update(kw)
    if pkg == "jax":
        return JServing(name, js, cfg, **base)
    return ServingScheduler(name, ts, port_cfg(cfg), device="cpu", **base)


def host_leaves(pkg, s) -> dict:
    return jax_leaves(s.state_host()) if pkg == "jax" else s.state_host()


def drive_http(s, tick_jobs, window):
    """tests/test_services.py _drive_serving_http on a started front door:
    per-cluster submitter threads over real HTTP, one seal per tick, one
    dispatch per window."""
    for t, row in enumerate(tick_jobs):
        by_c = {}
        for job in row:
            by_c.setdefault(job[0], []).append(job)

        def submit(jobs):
            for (c, j, cores, mem, dur, mism) in jobs:
                ep = "/delay" if mism else "/"
                code, _ = httpd.post_json(
                    s.url + ep, {**job_to_json(j, cores, mem, dur),
                                 "Cluster": c})
                assert code == 200, f"job {j} -> {code}"

        ths = [threading.Thread(target=submit, args=(jobs,))
               for jobs in by_c.values()]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        s.seal_tick()
        if (t + 1) % window == 0:
            s.dispatch_sealed()
    s.dispatch_sealed()


def served(pkg, name, C, cfg, tick_jobs, window, **kw) -> dict:
    s = make(pkg, name, C, cfg, window=window, **kw)
    errors = watch(s)
    s.start()
    try:
        drive_http(s, tick_jobs, window)
        assert s.health()[0]
        return host_leaves(pkg, s)
    finally:
        s.shutdown()
        assert not errors.records, errors.records


def test_front_door_windows_1_and_4_equal_jax():
    """The same trace (both endpoints, real HTTP, concurrent per-cluster
    submitters) through the port's window-1 and window-4 front doors ends
    bitwise in the JAX front door's state; nothing drops."""
    C, T = 3, 24
    cfg = serving_cfg()
    tick_jobs = serving_trace(C, T, seed=5, mismatched_every=9)
    want = served("jax", "svc-j-front4", C, cfg, tick_jobs, 4)
    for w in (1, 4):
        got = served("torch", f"svc-t-front{w}", C, cfg, tick_jobs, w)
        assert_leaves_equal(want, got)
    for k, v in got.items():
        if k.startswith(".drops."):
            assert not v.any(), k
    assert got[".placed_total"].sum() > 0


def test_front_door_equals_the_port_engine_run():
    """The staged path IS the port's batch engine: a policy-endpoint trace
    through the HTTP front door equals ``Engine.run`` over the bucketed
    Arrivals (stamps the staging ticks' clocks)."""
    C, T = 3, 20
    cfg = serving_cfg()
    tcfg = port_cfg(cfg)
    tick_jobs = serving_trace(C, T, seed=13)
    got = served("torch", "svc-t-batch", C, cfg, tick_jobs, 4)
    rows = {c: [] for c in range(C)}
    for t, row in enumerate(tick_jobs):
        for (c, j, cores, mem, dur, _m) in row:
            rows[c].append((j, cores, mem, dur, (t + 1) * cfg.tick_ms))
    A = max(len(v) for v in rows.values())
    arr = {k: np.zeros((C, A), np.int32)
           for k in ("t", "id", "cores", "mem", "gpu", "dur")}
    n = np.zeros((C,), np.int32)
    for c, lst in rows.items():
        n[c] = len(lst)
        for i, (j, cores, mem, dur, ta) in enumerate(lst):
            arr["id"][c, i], arr["cores"][c, i] = j, cores
            arr["mem"][c, i], arr["dur"][c, i] = mem, dur
            arr["t"][c, i] = ta
    ta_b = pack_arrivals_by_tick(TArrivals(**arr, n=n), T, cfg.tick_ms)
    _, ts = specs_pair(C)
    ref = TEngine(tcfg, device="cpu").run(
        tinit_state(tcfg, ts, device="cpu"), ta_b, T)
    assert_leaves_equal(interop.to_numpy(ref), got)


_WALL = re.compile(
    rb"\"(snapshot_age_ms|wait_quote_ms|SnapshotAgeMs)\": -?[0-9.e+-]+")


def masked(body: bytes) -> bytes:
    """A query body with its wall-clock fields masked: the snapshot's age
    and the quote's measured staging term."""
    return _WALL.sub(rb'"\1": X', body)


def test_query_bodies_equal_jax():
    """/stats, /quote and /placed answer the JAX front door's bytes (the
    wall-clock fields masked) after the same deterministic drive, and the
    503 back-pressure quote names the same rejected jobs."""
    C, T = 2, 12
    cfg = serving_cfg()
    tick_jobs = serving_trace(C, T, seed=21, mismatched_every=7)
    bodies = {}
    for pkg, name in (("jax", "svc-j-query"), ("torch", "svc-t-query")):
        s = make(pkg, name, C, cfg, window=2, k_cap=8, max_staged=64)
        errors = watch(s)
        s.start()
        try:
            out = []
            drive_http(s, tick_jobs, 2)
            ids = [j[1] for row in tick_jobs for j in row]
            for q in (["/stats", "/stats?tenant=0", "/stats?tenant=3"]
                      + [f"/quote?cluster={c}" for c in range(C + 1)]
                      + [f"/placed?cluster={i % C}&id={i}"
                         for i in ids[-12:] + [10 ** 6]]):
                out.append((q, *httpd.get(s.url + q)))
            # a long job stays running; back-pressure past max_staged
            batch = [{**job_to_json(5_000 + i, 1, 100, 600_000),
                      "Cluster": i % C} for i in range(70)]
            out.append(("batch", *httpd.post_json(s.url + "/submitBatch",
                                                  batch)))
            s.seal_tick()
            s.dispatch_sealed()
            for q in ("/stats", "/placed?cluster=0&id=5000"):
                out.append((q, *httpd.get(s.url + q)))
            bodies[pkg] = [(q, code, masked(b or b"")) for q, code, b in out]
        finally:
            s.shutdown()
        assert not errors.records, errors.records
    assert bodies["torch"] == bodies["jax"]
    codes = {q: code for q, code, _ in bodies["torch"]}
    assert codes["batch"] == 503 and codes["/stats?tenant=3"] == 400


def tenant_params(pkg, cfg, quotas):
    if pkg == "jax":
        return jtenancy.stack_tenant_params([
            jtenancy.default_tenant_params(cfg, fault_seed=i, quota_jobs=q)
            for i, q in enumerate(quotas)])
    return ttenancy.stack_tenant_params([
        ttenancy.default_tenant_params(port_cfg(cfg), fault_seed=i,
                                       quota_jobs=q, device="cpu")
        for i, q in enumerate(quotas)])


def test_tenant_front_door_equals_jax_per_tenant():
    """tests/test_services.py:681 through both packages: jobs route by the
    wire ``Tenant`` field, one tenant-batched dispatch advances every
    tenant; every tenant's state, /stats row and /placed lookup equal the
    JAX front door's."""
    C, T = 2, 3
    cfg = serving_cfg()
    out = {}
    for pkg, name in (("jax", "svc-j-mt"), ("torch", "svc-t-mt")):
        s = make(pkg, name, C, cfg, tenants=T, window=2, k_cap=8,
                 max_staged=256)
        errors = watch(s)
        s.start()
        try:
            codes, jid = [], 0
            for tn in range(T):
                for _ in range(tn + 1):
                    jid += 1
                    codes.append(httpd.post_json(
                        s.url + "/", {**job_to_json(jid, 1, 100, 600_000),
                                      "Cluster": 0, "Tenant": tn})[0])
            batch = [{**job_to_json(100 + tn, 1, 100, 600_000),
                      "Cluster": 1, "Tenant": tn} for tn in range(T)]
            codes.append(httpd.post_json(s.url + "/submitBatch", batch)[0])
            codes.append(httpd.post_json(
                s.url + "/", {**job_to_json(999, 1, 100, 1_000),
                              "Cluster": 0, "Tenant": T})[0])
            codes.append(httpd.post_json(
                s.url + "/delay", {**job_to_json(998, 1, 100, 1_000),
                                   "Cluster": 0, "Tenant": 0})[0])
            s.seal_tick()
            s.seal_tick()
            s.dispatch_sealed()
            s._refresh_snapshot()
            bodies = [masked(httpd.get(s.url + q)[1]) for q in
                      [f"/stats?tenant={tn}" for tn in range(T)]
                      + ["/stats", "/placed?cluster=0&id=1&tenant=0",
                         "/placed?cluster=0&id=1&tenant=1",
                         "/quote?cluster=0&tenant=2"]]
            metrics = httpd.get(s.url + "/metrics")[1].decode()
            out[pkg] = (codes, bodies, host_leaves(pkg, s), s.provenance())
        finally:
            s.shutdown()
        assert not errors.records, errors.records
        for tn in range(T):
            assert (f'_tenant_placed_total{{tenant="{tn}"}} '
                    f'{float(tn + 2)}') in metrics, metrics
    (jc, jb, jl, jp), (tc, tb, tl, tp) = out["jax"], out["torch"]
    assert tc == jc == [200] * 7 + [400, 400]
    assert tb == jb
    assert_leaves_equal(jl, tl)
    assert tp["tenants"] == T and tp["tenant_params_digest"]
    assert tl[".placed_total"].shape[0] == T
    for tn in range(T):
        assert tl[".placed_total"][tn].sum() == tn + 2


def test_tenant_quota_503_equals_jax():
    """tests/test_services.py:771 through both packages: a metered tenant
    quotes 503 at its budget while an unmetered co-tenant admits; the
    answers and the final states equal JAX's, and nothing drops."""
    C, T = 2, 2
    cfg = serving_cfg()
    out = {}
    for pkg, name in (("jax", "svc-j-quota"), ("torch", "svc-t-quota")):
        s = make(pkg, name, C, cfg, tenants=T,
                 tenant_params=tenant_params(pkg, cfg, (2, -1)), window=1,
                 k_cap=8, max_staged=256)
        errors = watch(s)
        s.start()
        try:
            answers = []
            for i in range(3):
                answers.append(httpd.post_json(
                    s.url + "/", {**job_to_json(i + 1, 1, 100, 600_000),
                                  "Cluster": 0, "Tenant": 0}))
            for i in range(4):
                answers.append(httpd.post_json(
                    s.url + "/", {**job_to_json(10 + i, 1, 100, 600_000),
                                  "Cluster": 0, "Tenant": 1}))
            s.seal_tick()
            s.dispatch_sealed()
            s._refresh_snapshot()
            answers += [httpd.get(s.url + f"/stats?tenant={tn}")
                        for tn in range(T)]
            out[pkg] = ([(c, masked(b or b"")) for c, b in answers],
                        host_leaves(pkg, s))
        finally:
            s.shutdown()
        assert not errors.records, errors.records
    assert out["torch"][0] == out["jax"][0]
    assert [c for c, _ in out["torch"][0]] == [200, 200, 503] + [200] * 6
    assert b"quota" in out["torch"][0][2][1]
    assert_leaves_equal(out["jax"][1], out["torch"][1])
    for k, v in out["torch"][1].items():
        if k.startswith(".drops."):
            assert not v.any(), k


def test_snapshot_backpressure_and_adaptive_windows():
    """The port front door's own contracts, as tests/test_services.py pins
    the reference's: snapshot-backed queries, per-job back-pressure with a
    quote and a clean retry, the adaptive early seal and partial
    dispatch, the measured staging quote."""
    C = 2
    cfg = serving_cfg()
    s = make("torch", "svc-t-bp", C, cfg, window=4, k_cap=2, max_staged=4,
             adaptive_window=True, adaptive_deadline_ms=1.0)
    errors = watch(s)
    s.start()
    try:
        wall = s._window_wall_ms()
        code, body = httpd.get(s.url + "/quote?cluster=0")
        d = json.loads(body)
        assert d["wait_quote_ms"] - d["avg_wait_ms"] == pytest.approx(wall)
        code, body = httpd.post_json(
            s.url + "/", {**job_to_json(7, 2, 500, 600_000), "Cluster": 1})
        assert code == 200
        assert json.loads(httpd.get(
            s.url + "/placed?cluster=1&id=7")[1])["status"] == "unknown"
        # k_cap 2: the second job of cluster 0 fills its bucket -> early seal
        batch = [{**job_to_json(i + 1, 1, 100, 2_000), "Cluster": 0}
                 for i in range(2)]
        batch += [{**job_to_json(20 + i, 1, 100, 2_000), "Cluster": 1}
                  for i in range(3)]
        code, body = httpd.post_json(s.url + "/submitBatch", batch)
        d = json.loads(body)
        # max_staged 4 (one staged already): 3 admitted, 2 quoted
        assert code == 503 and d["Accepted"] == 3
        assert d["RejectedIdx"] == [3, 4] and d["RetryAfterMs"] > 0
        assert s.meter.snapshot()["counters"]["submit_rejected"] == 2
        assert s._sealed_count() == 1, "full bucket did not seal early"
        time.sleep(0.02)
        assert s._adaptive_due() == 1
        s._dispatch(1)
        s._refresh_snapshot()
        assert json.loads(httpd.get(
            s.url + "/placed?cluster=1&id=7")[1])["status"] == "running"
        retry = [batch[k] for k in d["RejectedIdx"]]
        code, body = httpd.post_json(s.url + "/submitBatch", retry)
        assert code == 200 and json.loads(body)["Accepted"] == 2
        for _ in range(s.window):
            s.seal_tick()
        assert s._adaptive_due() == s.window
        s.dispatch_sealed()
        s._refresh_snapshot()
        assert s.snapshot.placed == 6
        host = s.state_host()
        assert host[".placed_total"].sum() == 6
        assert all(not v.any() for k, v in host.items()
                   if k.startswith(".drops."))
        assert s._measured_window_ms() < wall
        prov = s.provenance()
        assert prov["dispatches"] == s.dispatches and prov["obs"]["placed"] == 6
    finally:
        s.shutdown()
    assert not errors.records, errors.records


def test_live_pacer_multi_tenant_and_adaptive():
    """The paced drive and pacer threads hosting two tenants with adaptive
    windows: jobs submitted over HTTP place without a deterministic driver
    in the loop, the service healthy and its drive thread alive
    throughout."""
    C, T = 2, 2
    _, ts = specs_pair(C)
    s = ServingScheduler("svc-t-mt-live", ts, port_cfg(serving_cfg()),
                         speed=SPEED, tenants=T, adaptive_window=True,
                         window=4, warm_k=(4,), k_cap=8, max_staged=256,
                         device="cpu")
    errors = watch(s)
    with s:
        for tn in range(T):
            for i in range(3):
                code, _ = httpd.post_json(
                    s.url + "/",
                    {**job_to_json(10 * tn + i + 1, 1, 100, 2_000),
                     "Cluster": i % C, "Tenant": tn})
                assert code == 200
        wait_until(lambda: s.snapshot is not None
                   and s.snapshot.placed == 2 * 3,
                   msg="paced adaptive multi-tenant placement")
        assert all(int(p) == 3 for p in s.snapshot.placed_t)
        ok, detail = s.health()
        assert ok and detail["dispatches"] > 0, detail
        assert s._drive_thread.is_alive() and s._pacer_thread.is_alive()
        code, body = jhttpd.get(s.url + "/healthz")
        assert code == 200, body
    assert not errors.records, errors.records
