"""The port's serving crash recovery (WAL + checkpoints) held against the
JAX package's: files one package's front door wrote — acked jobs in the
write-ahead log, the device state in an ``MCSCKPT1`` checkpoint — recover
in the other to the same state, both ways; a stale-format (v1) checkpoint
degrades to WAL-alone recovery there too; and the port's own recovery
paths (torn tail, rotation, double replay, no checkpoint, a wedged stop)
behave as tests/test_faults.py pins the reference's."""

import json
import shutil
import struct
import threading

import numpy as np
import pytest

from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core import checkpoint as jckio
from multi_cluster_simulator_tpu.services.serving import (
    ServingScheduler as JServing,
)
from multi_cluster_simulator_tpu_torch.services import httpd
from multi_cluster_simulator_tpu_torch.services import wal as walmod
from multi_cluster_simulator_tpu_torch.services.serving import (
    ServingScheduler,
)
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg
from tests.test_torch_serving import specs_pair, watch

CFG = SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                queue_capacity=64, max_running=128, max_arrivals=32,
                max_ingest_per_tick=16, max_nodes=5, max_virtual_nodes=0)
TICK = CFG.tick_ms


def serving(pkg, d, name, wal=True, ckpt=True, **kw):
    """tests/test_faults.py _serving for either package, its files in
    directory ``d``."""
    d.mkdir(parents=True, exist_ok=True)
    js, ts = specs_pair(2)
    kw.setdefault("pacer", False)
    args = dict(window=4, warm_k=(4,), k_cap=32, max_staged=10 ** 6,
                wal_path=str(d / "serve.wal") if wal else None,
                checkpoint_path=str(d / "serve.ckpt") if ckpt else None,
                checkpoint_every=2, **kw)
    if pkg == "jax":
        return JServing(name, js, CFG, **args)
    return ServingScheduler(name, ts, port_cfg(CFG), device="cpu", **args)


def feed(s, jobs_per_tick, ticks, jid0=1, dispatch_every=None):
    jid = jid0
    for t in range(ticks):
        for _ in range(jobs_per_tick):
            assert s.submit_direct(c=(jid % 2), jid=jid, cores=1 + jid % 3,
                                   mem=100 + 10 * (jid % 7), dur_ms=2_000)
            jid += 1
        s.seal_tick()
        if dispatch_every and (t + 1) % dispatch_every == 0:
            s.dispatch_sealed()
    return jid


def finish(s, ticks):
    s.dispatch_sealed()
    while s._staged_ticks() < ticks:
        s.seal_tick()
    s.dispatch_sealed()


def leaves(pkg, s) -> dict:
    return jax_leaves(s.state_host()) if pkg == "jax" else s.state_host()


def reference(tmp_path, jobs_per_tick, ticks, until):
    """The port's uninterrupted run over the same stream."""
    ref = serving("torch", tmp_path / "ref", "t-rec-ref", wal=False,
                  ckpt=False)
    feed(ref, jobs_per_tick, ticks)
    finish(ref, until)
    return ref.state_host()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recovery_crosses_packages(tmp_path, writer):
    """A front door of ``writer`` acks 36 jobs, dispatches 8 ticks (a
    checkpoint at each second dispatch) and is killed with 4 ticks acked
    but undispatched. Both packages recover from copies of its files:
    each replays the 12 undispatched jobs onto the checkpoint, and both
    end, after the same tail, in the uninterrupted run's state."""
    w = serving(writer, tmp_path / "w", f"{writer}-rec-writer")
    jid = feed(w, 3, 8, dispatch_every=4)
    feed(w, 3, 4, jid0=jid)
    assert w.ticks_dispatched == 8
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        for f in ("serve.wal", "serve.ckpt"):
            shutil.copy(tmp_path / "w" / f, d / f)
        s = serving(pkg, d, f"{pkg}-rec-from-{writer}")
        errors = watch(s)
        assert s.recovered_jobs == 3 * 4
        assert s.ticks_dispatched == 8
        finish(s, 20)
        out[pkg] = leaves(pkg, s)
        assert not errors.records, errors.records
    assert_leaves_equal(out["jax"], out["torch"])
    assert_leaves_equal(reference(tmp_path, 3, 12, 20), out["torch"])
    assert out["torch"][".t"] == 20 * TICK
    assert out["torch"][".placed_total"].sum() == 3 * 12


def test_jax_v1_checkpoint_degrades_to_wal_alone(tmp_path):
    """tests/test_preempt.py:408 across packages: a JAX-written checkpoint
    downgraded to the v1 header (no version, no config digest) is refused
    by the port's header check, the port recovers from the WAL alone — the
    full history — and ends in the uninterrupted state."""
    w = serving("jax", tmp_path / "a", "jax-v1-writer")
    feed(w, 2, 8, dispatch_every=4)
    ck = str(tmp_path / "a" / "serve.ckpt")
    header, payload = jckio._read(ck)
    header.pop("v"), header.pop("config", None)
    hdr = json.dumps(header).encode()
    with open(ck, "wb") as f:
        f.write(jckio._MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(payload)
    s = serving("torch", tmp_path / "a", "t-v1-reader")
    assert s.recovered_jobs == 16
    finish(s, 16)
    got = s.state_host()
    assert_leaves_equal(reference(tmp_path, 2, 8, 16), got)
    assert all(not v.any() for k, v in got.items()
               if k.startswith(".drops."))


def test_torn_final_record_discarded(tmp_path):
    s1 = serving("torch", tmp_path, "t-torn-1", ckpt=False)
    feed(s1, 2, 3)
    path = str(tmp_path / "serve.wal")
    records, _offs, off, torn = walmod.read_records(path)
    assert len(records) == 6 and not torn
    with open(path, "ab") as f:  # a crash mid-append: half a record
        f.write(b"\x40\x00\x00\x00\x12\x34\x56\x78corrupt")
    s2 = serving("torch", tmp_path, "t-torn-2", ckpt=False)
    assert s2.wal_torn_tail and s2.recovered_jobs == 6
    assert s2.submit_direct(c=0, jid=999, cores=1, mem=100, dur_ms=1_000)
    records3, _offs3, _o3, torn3 = walmod.read_records(path)
    assert not torn3 and len(records3) == 7 and records3[-1]["i"] == 999


def test_double_replay_is_idempotent(tmp_path):
    s1 = serving("torch", tmp_path, "t-dup-1")
    feed(s1, 2, 6, dispatch_every=2)
    feed(s1, 2, 2, jid0=1000)
    out = []
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        for f in ("serve.wal", "serve.ckpt"):
            shutil.copy(tmp_path / f, tmp_path / d / f)
        s = serving("torch", tmp_path / d, f"t-dup-{d}")
        assert s.recovered_jobs == 8
        finish(s, 12)
        out.append(s.state_host())
    assert_leaves_equal(*out)
    assert out[0][".placed_total"].sum() == 2 * 8


def test_rotation_bounds_growth_and_recovery_seeks(tmp_path):
    s1 = serving("torch", tmp_path, "t-rot-1", wal_rotate_bytes=1)
    gen0 = s1._wal.generation
    jid = feed(s1, 2, 8, dispatch_every=2)
    assert s1._wal.generation != gen0, "rotation never fired"
    feed(s1, 2, 2, jid0=jid)
    records, _offs, _off, _torn = walmod.read_records(
        str(tmp_path / "serve.wal"))
    assert len(records) <= 8
    s2 = serving("torch", tmp_path, "t-rot-2", wal_rotate_bytes=1)
    finish(s2, 16)
    assert_leaves_equal(reference(tmp_path, 2, 10, 16), s2.state_host())


def test_recovery_without_checkpoint(tmp_path):
    s1 = serving("torch", tmp_path, "t-nockpt-1", ckpt=False)
    feed(s1, 2, 5)
    s2 = serving("torch", tmp_path, "t-nockpt-2", ckpt=False)
    assert s2.recovered_jobs == 10
    finish(s2, 12)
    assert s2.state_host()[".placed_total"].sum() == 10


def test_wedged_stop_flips_healthz(tmp_path):
    s = serving("torch", tmp_path, "t-wedge", wal=False, ckpt=False,
                pacer=True)
    wedge = threading.Event()
    s._drive_loop = lambda: wedge.wait()  # an injected wedge: ignores _stop
    s.stop_join_timeout_s = 0.2
    s.pacer_join_timeout_s = 0.2
    s.start()
    try:
        assert httpd.get(s.url + "/healthz")[0] == 200
        s.shutdown()
        code, body = httpd.get(s.url + "/healthz")
        assert code == 503
        d = json.loads(body)
        assert d["shutdown_wedged"] is False and "drive" in d["wedged_thread"]
    finally:
        wedge.set()
        s._wedged = None
        s.httpd.shutdown()


def test_quiesce_drains_and_checkpoints(tmp_path):
    """/admin/quiesce on a paced front door: the loops stop, every sealed
    tick dispatches, the final checkpoint lands, and a recovery from it
    replays exactly the jobs still staged on the open tick (never sealed
    into virtual time, durable in the WAL)."""
    s = serving("torch", tmp_path, "t-quiesce", pacer=True, speed=200.0)
    errors = watch(s)
    s.start()
    try:
        for i in range(6):
            code, _ = httpd.post_json(
                s.url + "/", {"Id": i + 1, "CoresNeeded": 1,
                              "MemoryNeeded": 100,
                              "Duration": 2_000 * 1_000_000, "Cluster": i % 2})
            assert code == 200
        code, body = httpd.post_json(s.url + "/admin/quiesce", {})
        assert code == 200, body
        d = json.loads(body)
        assert d["checkpoint"] and d["staged_jobs"] == s._staged_jobs
        assert d["placed"] + d["staged_jobs"] == 6
    finally:
        s.shutdown()
    assert not errors.records, errors.records
    r = serving("torch", tmp_path, "t-quiesce-rec")
    assert r.recovered_jobs == d["staged_jobs"]
    np.testing.assert_array_equal(r.state_host()[".t"], d["sim_t"])
