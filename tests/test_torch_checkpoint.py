"""The port's checkpoint format (core/checkpoint.py, utils/msgpack.py)
against the JAX package's, on the CPU.

The codec writes what flax's ``msgpack_serialize`` writes and reads it
back, every dtype a state holds, 0-d leaves and the chunked form of a
large leaf included. For the same state and meta, the file the port writes
is the JAX package's byte for byte, header and payload (wide, compact,
the fault plane, the greedy trader, the trace, the metrics buffer). A
checkpoint JAX writes mid-run resumes in the port to the JAX package's
uninterrupted final state, and the reverse. The digests equal the
reference's, and the header refuses what tests/test_checkpoint.py's cases
refuse, naming the field. The module works where neither msgpack nor flax
can be imported. Tolerance is zero: every comparison is bitwise, leaf by
leaf, dtypes included. Inputs come from numpy seeds.
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization as fser

from multi_cluster_simulator_tpu.config import (
    FaultConfig, MatchKind, PolicyKind, SimConfig, TraderConfig,
)
from multi_cluster_simulator_tpu.core import checkpoint as jck
from multi_cluster_simulator_tpu.core import compact as jCC
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core import preempt as jpre
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.obs import device as jD
from multi_cluster_simulator_tpu.policies import base as jbase
from multi_cluster_simulator_tpu.workload.traces import borg_like_stream
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch import load_state as pkg_load_state
from multi_cluster_simulator_tpu_torch import save_state as pkg_save_state
from multi_cluster_simulator_tpu_torch.core import checkpoint as tck
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import preempt as tpre
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.obs import device as tD
from multi_cluster_simulator_tpu_torch.policies import base as tbase
from multi_cluster_simulator_tpu_torch.utils import msgpack as tmp
from tests.test_torch_compact import port_plan
from tests.test_torch_delay import port_arrivals
from tests.test_torch_engine import (
    assert_leaves_equal, headline_cfg, jax_leaves, port_cfg, specs, stream,
)
from tests.test_torch_obs import port_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_jax(template, leaves: dict):
    """A JAX tree shaped like ``template`` from numpy leaves keyed by path
    (the port's interop keys)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves[jax.tree_util.keystr(p)]) for p, _ in flat])


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------

DTYPES = (np.bool_, np.int8, np.int16, np.int32, np.float32, np.int64)


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.shape(a) == np.shape(b) and np.array_equal(a, b))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_codec_equals_flax_for_every_dtype(dtype):
    """0-d, empty, small and 16-bit-length leaves of one dtype, nested
    maps of 0, 15, 16 and 17 keys: the bytes flax writes, read back
    bitwise as writable arrays."""
    rng = np.random.default_rng(7)
    tree = {"scalar": np.asarray(rng.integers(-100, 100)).astype(dtype),
            "empty": np.zeros((0, 3), dtype),
            "grid": rng.integers(-50, 50, (4, 5, 3)).astype(dtype),
            "long": rng.integers(-50, 50, (70_000,)).astype(dtype),
            "npscalar": dtype(3) if dtype is not np.bool_ else np.bool_(1)}
    for n in (0, 15, 16, 17):
        tree[f"m{n}"] = {f"k{i}": np.arange(i, dtype=np.int32)
                         for i in range(n)}
    want = fser.msgpack_serialize(tree, in_place=True)
    assert tmp.packb(tree) == want
    back = tmp.unpackb(want)
    assert _tree_equal(back, tree)
    assert back["grid"].flags.writeable and back["scalar"].shape == ()
    assert _tree_equal(fser.msgpack_restore(tmp.packb(tree)), tree)


def test_codec_chunks_a_large_leaf_as_flax_does(monkeypatch):
    """A leaf over MAX_CHUNK_SIZE bytes (lowered here on both sides) is
    written in flax's chunked form and joined back on read."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tmp, "MAX_CHUNK_SIZE", 64)

    def make():  # flax chunks its argument in place
        return {"s": {"big": np.arange(100, dtype=np.int32).reshape(10, 10),
                      "odd": np.arange(37, dtype=np.int16),
                      "small": np.arange(3, dtype=np.int8)}}
    tree = make()
    want = fser.msgpack_serialize(make(), in_place=True)
    assert tmp.packb(tree) == want
    assert tmp.CHUNKED.encode() in want
    assert _tree_equal(tmp.unpackb(want), tree)


@pytest.mark.parametrize("obj,what", [
    ({"x": 1.5}, "float"), ({1: np.int32(1)}, "not a str"),
    ({"x": np.asarray([object()])}, "dtype object")])
def test_codec_refuses_outside_the_subset(obj, what):
    with pytest.raises(ValueError, match=what):
        tmp.packb(obj)


def test_codec_refuses_other_ext_codes_and_floats():
    import msgpack

    with pytest.raises(ValueError, match="ext type 2"):
        tmp.unpackb(msgpack.packb(msgpack.ExtType(2, b"\x92\x01\x02")))
    with pytest.raises(ValueError, match="float"):
        tmp.unpackb(msgpack.packb({"x": 0.5}))
    with pytest.raises(ValueError, match="truncated"):
        tmp.unpackb(fser.msgpack_serialize({"x": np.arange(9)})[:-3])


# --------------------------------------------------------------------------
# byte identity with the JAX package's files
# --------------------------------------------------------------------------

def _faults_cfg():
    return headline_cfg(record_trace=False, faults=FaultConfig(
        enabled=True, mttf_ms=15_000, mttr_ms=3_000, seed=21,
        max_retries=8))


def _trader_cfg():
    return SimConfig(policy=PolicyKind.DELAY, queue_capacity=16,
                     max_running=24, max_arrivals=40, max_nodes=5,
                     max_virtual_nodes=3, n_res=3,
                     trader=TraderConfig(enabled=True))


CASES = {
    "wide": (lambda: headline_cfg(record_trace=False), False),
    "compact": (lambda: headline_cfg(record_trace=False), True),
    "faults": (_faults_cfg, False),
    "trader": (_trader_cfg, False),
    "trace": (headline_cfg, False),
    "compact+faults+mbuf": (_faults_cfg, True),
}


def _port_world(name, n_clusters=8, n_ticks=30):
    """A port state after ``n_ticks`` of the case's run on the CPU, its
    buffer, the case's JAX config, the JAX plan (None: wide) and the JAX
    state, buffer and specs with the same leaves."""
    make, compact = CASES[name]
    cfg = make()
    jspecs, tspecs = specs(n_clusters)
    jarr, tarr = stream(n_clusters, max_gpus=1 if cfg.n_res == 3 else 0,
                        gpu_frac=0.1 if cfg.n_res == 3 else 0.0)
    plan = jCC.derive_plan(cfg, jspecs, jarr) if compact else None
    tcfg = port_cfg(cfg)
    ts = tstate.init_state(tcfg, tspecs, device="cpu",
                           plan=None if plan is None else port_plan(plan))
    mb = tD.metrics_init(ts)
    ts, mb = tengine.Engine(tcfg, device="cpu").run(ts, tarr, n_ticks,
                                                    mbuf=mb)
    js0 = jinit_state(cfg, jspecs, plan=plan)
    js = to_jax(js0, interop.state_to_numpy(ts))
    jmb = to_jax(jD.metrics_init(js0), interop.to_numpy(mb))
    return dict(cfg=cfg, tcfg=tcfg, plan=plan, ts=ts, mb=mb, js=js,
                jmb=jmb, jspecs=jspecs, tspecs=tspecs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_file_is_the_jax_file_byte_for_byte(tmp_path, name):
    """save_run with the same state, buffer (where the case has one) and
    meta writes the same bytes in both packages; save_state too; and
    either file loads back into the port bitwise."""
    w = _port_world(name)
    with_mb = "mbuf" in name or name == "wide"
    plan = w["plan"]
    tplan = None if plan is None else port_plan(plan)
    meta = {"chunk_idx": 1, "dense_ticks": 30, "prior": {
        "ticks_executed": 12, "leap_hist": [0, 2, 1]}}
    jp, tp = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jpre.save_run(jp, w["js"], mbuf=w["jmb"] if with_mb else None,
                  meta=dict(meta), cfg=w["cfg"], plan=plan,
                  policy_digest=jpre.policy_digest_for(w["cfg"]))
    tpre.save_run(tp, w["ts"], mbuf=w["mb"] if with_mb else None,
                  meta=dict(meta), cfg=w["tcfg"], plan=tplan,
                  policy_digest=tpre.policy_digest_for(w["tcfg"]))
    assert read(tp) == read(jp)
    jck.save_state(w["js"], jp, extra={"who": name}, cfg=w["cfg"],
                   plan=plan)
    tck.save_state(w["ts"], tp, extra={"who": name}, cfg=w["tcfg"],
                   plan=tplan)
    assert read(tp) == read(jp)
    template = tstate.init_state(w["tcfg"], w["tspecs"], device="cpu",
                                 plan=tplan)
    back = tck.load_state(jp, template, cfg=w["tcfg"], plan=tplan)
    assert_leaves_equal(jax_leaves(w["js"]), interop.state_to_numpy(back))


def test_package_exports_save_and_load_state(tmp_path):
    w = _port_world("wide", n_clusters=2, n_ticks=5)
    path = str(tmp_path / "pkg.ckpt")
    pkg_save_state(w["ts"], path, cfg=w["tcfg"])
    got = pkg_load_state(path, tstate.init_state(
        w["tcfg"], w["tspecs"], device="cpu"), cfg=w["tcfg"])
    assert_leaves_equal(interop.state_to_numpy(w["ts"]),
                        interop.state_to_numpy(got))
    assert tck.peek_checkpoint_t(path) == 5_000
    assert tck.load_extra(path) == {}


# --------------------------------------------------------------------------
# resume across the packages (tests/test_checkpoint.py:33's replay)
# --------------------------------------------------------------------------

FFD = SimConfig(policy=PolicyKind.FFD, parity=False,
                max_placements_per_tick=16, queue_capacity=128,
                max_running=256, max_arrivals=64, max_ingest_per_tick=16,
                max_nodes=5, max_virtual_nodes=0, n_res=2)
FFD_C = 8
HALF = 120


@pytest.fixture(scope="module")
def ffd_replay():
    """The Borg-like FFD replay: JAX's state at tick 120 and its
    uninterrupted state at 240 (two 120-tick windowed runs compose)."""
    jspecs, _ = specs(FFD_C)
    arr = borg_like_stream(FFD_C, 64, 200_000, max_cores=32, max_mem=24_000,
                           seed=19)
    run = jengine.Engine(FFD).run_jit()
    mid = run(jinit_state(FFD, jspecs), arr, HALF)
    return dict(arr=arr, jspecs=jspecs, mid=mid, run=run,
                straight=run(mid, arr, HALF))


def test_jax_checkpoint_resumes_in_the_port(tmp_path, ffd_replay):
    """A JAX save_run cut at tick 120 loads into the port (cursors and
    all) and, resumed on the plain path, ends bitwise where JAX's
    uninterrupted run ends."""
    path = str(tmp_path / "j.ckpt")
    pd = jpre.policy_digest_for(FFD)
    jpre.save_run(path, ffd_replay["mid"], meta={"chunk_idx": 3}, cfg=FFD,
                  plan=None, policy_digest=pd)
    tcfg = port_cfg(FFD)
    assert tck.peek_checkpoint_t(path) == HALF * FFD.tick_ms
    rc = tpre.load_run(path, tstate.init_state(
        tcfg, port_specs(ffd_replay["jspecs"]), device="cpu"), cfg=tcfg,
        plan=None, policy_digest=tpre.policy_digest_for(tcfg))
    assert rc.tick == HALF and rc.meta["chunk_idx"] == 3
    assert rc.mbuf is None
    final = tengine.Engine(tcfg, device="cpu").run(
        rc.state, port_arrivals(ffd_replay["arr"]), HALF)
    assert_leaves_equal(jax_leaves(ffd_replay["straight"]),
                        interop.state_to_numpy(final))


def test_port_checkpoint_resumes_in_jax(tmp_path, ffd_replay):
    """The reverse: the port runs the first 120 ticks and saves; JAX's
    load_run takes the file and its resumed run ends bitwise at its own
    uninterrupted state."""
    tcfg = port_cfg(FFD)
    ts = tstate.init_state(tcfg, port_specs(ffd_replay["jspecs"]),
                           device="cpu")
    ts = tengine.Engine(tcfg, device="cpu").run(
        ts, port_arrivals(ffd_replay["arr"]), HALF)
    path = str(tmp_path / "t.ckpt")
    tpre.save_run(path, ts, meta={"chunk_idx": 3}, cfg=tcfg, plan=None,
                  policy_digest=tpre.policy_digest_for(tcfg))
    rc = jpre.load_run(path, jinit_state(FFD, ffd_replay["jspecs"]),
                       cfg=FFD, plan=None,
                       policy_digest=jpre.policy_digest_for(FFD))
    assert rc.tick == HALF
    final = ffd_replay["run"](rc.state, ffd_replay["arr"], HALF)
    assert_leaves_equal(jax_leaves(ffd_replay["straight"]),
                        jax_leaves(final))


# --------------------------------------------------------------------------
# digests
# --------------------------------------------------------------------------

DIGEST_CFGS = {
    "default": SimConfig,
    "headline": headline_cfg,
    "trader": _trader_cfg,
    "faults": _faults_cfg,
    "ffd-fused": lambda: dataclasses.replace(FFD, fused="on",
                                             fused_block=8),
}


@pytest.mark.parametrize("name", sorted(DIGEST_CFGS))
def test_config_digest_equals_jax(name):
    cfg = DIGEST_CFGS[name]()
    tcfg = port_cfg(cfg)
    assert tck.config_describe(tcfg) == jck.config_describe(cfg)
    assert json.dumps(tck.config_describe(tcfg)) == json.dumps(
        jck.config_describe(cfg))
    assert tck.config_digest(tcfg) == jck.config_digest(cfg)
    assert tck.digest_of({"grid": [1, 2]}) == jck.digest_of({"grid": [1, 2]})


def test_plan_digest_equals_jax():
    cfg = headline_cfg()
    jspecs, _ = specs(4)
    jarr, _ = stream(4)
    for plan in (None, jCC.derive_plan(cfg, jspecs, jarr),
                 jCC.derive_plan(cfg, jspecs, None)):
        tplan = None if plan is None else port_plan(plan)
        assert tck.plan_describe(tplan) == jck.plan_describe(plan)
        assert tck.plan_digest(tplan) == jck.plan_digest(plan)


@pytest.mark.parametrize("name", sorted(tbase.REGISTRY))
def test_params_digest_equals_jax_for_every_policy(name):
    """Every registered policy's default leaves, at a config that makes
    each leaf non-trivial, digest as the reference's; so does the
    provenance record."""
    cfg = dataclasses.replace(_trader_cfg(), max_wait_ms=7_000)
    tcfg = port_cfg(cfg)
    jset, tset = jbase.PolicySet((name,)), tbase.PolicySet((name,))
    want = jbase.params_digest(jset.params_for(cfg))
    assert tbase.params_digest(tset.params_for(tcfg)) == want
    assert tset.provenance(tcfg) == jset.provenance(cfg)


@pytest.mark.parametrize("matching", list(MatchKind), ids=lambda m: m.value)
def test_params_digest_equals_jax_for_each_matching(matching):
    """The market's leaves (``mkt_*``) come from the trader's config: the
    digest follows each matching kind's solver settings as the
    reference's does, and ``policy_digest_for`` is the default digest."""
    cfg = dataclasses.replace(_trader_cfg(), trader=TraderConfig(
        enabled=True, matching=matching, sinkhorn_iters=17, cvx_iters=33))
    tcfg = port_cfg(cfg)
    assert tpre.policy_digest_for(tcfg) == jpre.policy_digest_for(cfg)
    pset = jbase.PolicySet(("delay", "delay-cvx-fast", "gavel"))
    tset = tbase.PolicySet(pset.names)
    for n in pset.names:
        assert tbase.params_digest(tset.params_for(tcfg, n)) == \
            jbase.params_digest(pset.params_for(cfg, n))


def test_default_digest_is_the_reference_record():
    """The reference's default digest, as its header records it."""
    assert tpre.policy_digest_for(port_cfg(SimConfig())) == "95a2533cd61c"


# --------------------------------------------------------------------------
# header refusals (tests/test_checkpoint.py:56-140)
# --------------------------------------------------------------------------

def _ffd_state(cfg=FFD, plan=None):
    return tstate.init_state(port_cfg(cfg), port_specs(specs(FFD_C)[0]),
                             device="cpu", plan=plan)


def test_rejects_other_config_by_shape(tmp_path):
    path = str(tmp_path / "c.ckpt")
    tck.save_state(_ffd_state(), path)
    other = dataclasses.replace(FFD, queue_capacity=64)
    with pytest.raises(ValueError, match="checkpoint|mismatch"):
        tck.load_state(path, _ffd_state(other))


def test_header_names_differing_config_field(tmp_path):
    path = str(tmp_path / "c.ckpt")
    tcfg = port_cfg(FFD)
    tck.save_state(_ffd_state(), path, cfg=tcfg)
    other = port_cfg(dataclasses.replace(FFD, max_ingest_per_tick=8))
    with pytest.raises(ValueError, match="max_ingest_per_tick"):
        tck.load_state(path, _ffd_state(), cfg=other)
    ok = tck.load_state(path, _ffd_state(), cfg=tcfg)
    assert int(ok.t) == 0


def test_header_rejects_plan_mismatch(tmp_path):
    path = str(tmp_path / "c.ckpt")
    jspecs = specs(FFD_C)[0]
    arr = borg_like_stream(FFD_C, 64, 200_000, max_cores=32, max_mem=24_000,
                           seed=19)
    plan = port_plan(jCC.derive_plan(FFD, jspecs, arr))
    tcfg = port_cfg(FFD)
    s0 = _ffd_state(plan=plan)
    tck.save_state(s0, path, cfg=tcfg, plan=plan)
    with pytest.raises(ValueError, match="checkpoint layout: compact, "
                                         "expected: wide"):
        tck.load_state(path, s0, cfg=tcfg, plan=None)
    stale = dataclasses.replace(plan, node="int8")
    with pytest.raises(ValueError, match="node"):
        tck.load_state(path, s0, cfg=tcfg, plan=stale)
    # a wide template refuses the compact leaves by structure
    with pytest.raises(ValueError, match="Missing field|Unknown field"):
        tck.load_state(path, _ffd_state())


def test_header_rejects_policy_digest_mismatch(tmp_path):
    path = str(tmp_path / "c.ckpt")
    tcfg = port_cfg(FFD)
    tck.save_state(_ffd_state(), path, cfg=tcfg,
                   policy_digest=tpre.policy_digest_for(tcfg))
    with pytest.raises(ValueError, match="policy params"):
        tck.load_state(path, _ffd_state(), cfg=tcfg,
                       policy_digest="0000deadbeef")


def test_rejects_v1_format(tmp_path):
    path = str(tmp_path / "v1.bin")
    hdr = json.dumps({"t": 0, "extra": {}}).encode()
    with open(path, "wb") as f:
        f.write(tck._MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
    with pytest.raises(ValueError, match="format v1"):
        tck.load_state(path, _ffd_state())


def test_rejects_garbage(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"definitely not a checkpoint")
    with pytest.raises(ValueError, match="not a simulator checkpoint"):
        tck.load_state(str(p), _ffd_state())


# --------------------------------------------------------------------------
# no msgpack, no flax
# --------------------------------------------------------------------------

def test_checkpoint_works_without_msgpack_or_flax(tmp_path):
    """In a fresh interpreter where msgpack and flax cannot be imported,
    the port writes a file, reads it back bitwise, and never imports jax
    or the JAX package."""
    code = f"""
import sys
sys.modules["msgpack"] = None
sys.modules["flax"] = None
import torch
from multi_cluster_simulator_tpu_torch import SimConfig, init_state
from multi_cluster_simulator_tpu_torch import uniform_cluster
from multi_cluster_simulator_tpu_torch.core import preempt
cfg = SimConfig()
specs = [uniform_cluster(c + 1, 5) for c in range(3)]
s = init_state(cfg, specs, device="cpu")
s.node_free[1, 2, 0] = -7
s.t.fill_(4000)
path = {str(tmp_path / "x.ckpt")!r}
preempt.save_run(path, s, cfg=cfg,
                 policy_digest=preempt.policy_digest_for(cfg))
rc = preempt.load_run(path, init_state(cfg, specs, device="cpu"), cfg=cfg)
assert int(rc.state.t) == 4000 and int(rc.state.node_free[1, 2, 0]) == -7
assert rc.tick == 4
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "msgpack", "multi_cluster_simulator_tpu")
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
