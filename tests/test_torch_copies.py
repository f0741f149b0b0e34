"""The port's copies of the JAX package's pure-Python pieces stay equal to
their originals: the config dataclasses, the row schemas, the cluster-spec
helpers, the numpy workload generators, the host-side arrival bucketing,
and the policy registry with every registered policy's parameter leaves.
The port keeps its own copies because it never imports the JAX package."""

import dataclasses
import enum

import numpy as np
import pytest

from multi_cluster_simulator_tpu import config as jconfig
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core import spec as jspec
from multi_cluster_simulator_tpu.ops import fields as jfields
from multi_cluster_simulator_tpu.policies import base as jbase
from multi_cluster_simulator_tpu.workload import generator as jgen
from multi_cluster_simulator_tpu.workload import traces as jtraces
from multi_cluster_simulator_tpu_torch import config as tconfig
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.ops import fields as tfields
from multi_cluster_simulator_tpu_torch.policies import base as tbase
from multi_cluster_simulator_tpu_torch.workload import generator as tgen
from multi_cluster_simulator_tpu_torch.workload import traces as ttraces


def _plain(v):
    """Compare enum members by value, nested config dataclasses by their
    field tuples."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if dataclasses.is_dataclass(v):
        return tuple((f.name, _plain(getattr(v, f.name)))
                     for f in dataclasses.fields(v))
    return v


@pytest.mark.parametrize("name", ["SimConfig", "TraderConfig", "FaultConfig",
                                  "WorkloadConfig"])
def test_config_fields_and_defaults_equal(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in jf] == [f.name for f in tf]
    assert [str(f.type) for f in jf] == [str(f.type) for f in tf]
    assert _plain(j()) == _plain(t())


@pytest.mark.parametrize("name", ["PolicyKind", "MatchKind"])
def test_config_enums_equal(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert [(m.name, m.value) for m in j] == [(m.name, m.value) for m in t]


def test_config_constants_and_total_nodes_equal():
    for const in ("REGISTRY_PORT", "HEARTBEAT_PERIOD_S", "HEARTBEAT_ATTEMPTS",
                  "PROVIDE_JOBS_BATCH", "TRADE_COLLECT_WINDOW_S",
                  "RETURN_ATTEMPTS"):
        assert getattr(jconfig, const) == getattr(tconfig, const)
    kw = dict(max_nodes=5, max_virtual_nodes=3)
    assert (jconfig.SimConfig(**kw).total_nodes
            == tconfig.SimConfig(**kw).total_nodes == 8)


@pytest.mark.parametrize("name", [
    "QUEUE_FIELDS", "QUEUE_INDEX", "QUEUE_INVALID", "RUN_FIELDS",
    "RUN_INDEX", "RUN_INVALID", "NEVER_I", "N_JOB_CLASSES",
    "N_DEVICE_TYPES"])
def test_field_schemas_equal(name):
    assert getattr(jfields, name) == getattr(tfields, name)


def test_job_class_equal():
    rng = np.random.default_rng(0)
    cores = rng.integers(0, 20, 64)
    gpu = rng.integers(0, 3, 64)
    np.testing.assert_array_equal(jfields.job_class(cores, gpu),
                                  tfields.job_class(cores, gpu))


def test_spec_constants_and_helpers_equal(tmp_path):
    assert (jspec.RES, jspec.CORES, jspec.MEM, jspec.GPU) == \
        (tspec.RES, tspec.CORES, tspec.MEM, tspec.GPU)
    js = [jspec.uniform_cluster(c, n, cores=16 + c, memory=1_000 * n,
                                gpus=c % 2)
          for c, n in ((1, 5), (2, 3), (3, 8))]
    ts = [tspec.uniform_cluster(c, n, cores=16 + c, memory=1_000 * n,
                                gpus=c % 2)
          for c, n in ((1, 5), (2, 3), (3, 8))]
    assert [s.to_json() for s in js] == [s.to_json() for s in ts]
    np.testing.assert_array_equal(jspec.capacities_array(js, 8),
                                  tspec.capacities_array(ts, 8))
    np.testing.assert_array_equal(jspec.node_types_array(js, 8),
                                  tspec.node_types_array(ts, 8))
    import json
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(js[0].to_json()))
    assert jspec.load_cluster_json(str(path)).to_json() == \
        tspec.load_cluster_json(str(path)).to_json()


def _assert_arrivals_equal(a, b):
    for f in ("t", "id", "cores", "mem", "gpu", "dur", "n"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kw", [
    dict(max_cores=8, max_mem=6_000, max_dur_ms=60_000, seed=9),
    dict(max_cores=8, max_mem=6_000, max_dur_ms=20_000, seed=3, max_gpus=2,
         gpu_frac=0.25),
])
def test_uniform_stream_equal(kw):
    _assert_arrivals_equal(jtraces.uniform_stream(6, 50, 90_000, **kw),
                           ttraces.uniform_stream(6, 50, 90_000, **kw))


@pytest.mark.parametrize("kw", [
    dict(n_clusters=6, jobs_per_cluster=50, horizon_ms=90_000, max_cores=32,
         max_mem=24_000, seed=19),
    dict(n_clusters=3, jobs_per_cluster=80, horizon_ms=4_500_000,
         max_cores=8, max_mem=6_000, seed=2),
])
def test_borg_like_stream_equal(kw):
    _assert_arrivals_equal(jtraces.borg_like_stream(**kw),
                           ttraces.borg_like_stream(**kw))


def test_policy_registry_equal():
    """The same names, kinds, ingest targets and overrides, in the same
    registration order."""
    assert jbase.KINDS == tbase.KINDS
    assert list(jbase.REGISTRY) == list(tbase.REGISTRY)
    for name, j in jbase.REGISTRY.items():
        t = tbase.REGISTRY[name]
        assert (j.name, j.kind, j.to_delay, j.overrides) == \
            (t.name, t.kind, t.to_delay, t.overrides)


def _jax_leaves(tree):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("name", sorted(jbase.REGISTRY))
def test_default_params_leaves_equal(name):
    """Every leaf of every registered policy's params, by JAX path, value
    and dtype — ``ffd-memfirst`` gives the same params in both packages —
    and the params cross both ways through interop."""
    jcfg = jconfig.SimConfig(max_wait_ms=7_000)
    tcfg = tconfig.SimConfig(max_wait_ms=7_000)
    jp = jbase.default_params(jcfg, jbase.REGISTRY[name], idx=2)
    tp = tbase.default_params(tcfg, tbase.REGISTRY[name], idx=2)
    want, got = _jax_leaves(jp), interop.params_to_numpy(tp)
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    back = interop.params_to_numpy(interop.params_from_numpy(want,
                                                             device="cpu"))
    for k in want:
        np.testing.assert_array_equal(want[k], back[k], err_msg=k)
    pset_j, pset_t = jbase.PolicySet((name,)), tbase.PolicySet((name,))
    assert pset_j.kinds == pset_t.kinds
    assert pset_j.ingest_to_delay() == pset_t.ingest_to_delay()


@pytest.mark.parametrize("arrival", ["poisson", "weibull"])
def test_generate_arrivals_equal(arrival):
    jw = dataclasses.replace(jconfig.WorkloadConfig(), arrival=arrival)
    tw = dataclasses.replace(tconfig.WorkloadConfig(), arrival=arrival)
    _assert_arrivals_equal(
        jgen.generate_arrivals(jw, 3, 64, 600_000, 32, 24_000, seed=4),
        tgen.generate_arrivals(tw, 3, 64, 600_000, 32, 24_000, seed=4))


def _stream_with_far_arrival():
    """A stream whose last job of cluster 0 lands far beyond the horizon
    (near 2^31 ms), to pin the overflow-tick parking."""
    arr = ttraces.uniform_stream(4, 30, 40_000, max_cores=8, max_mem=6_000,
                                 max_dur_ms=20_000, seed=21)
    arr.t[0, -1] = 2**31 - 100
    return arr


def test_pack_arrivals_by_tick_equal():
    arr = _stream_with_far_arrival()
    ja = jengine.pack_arrivals_by_tick(arr, 45, 1_000)
    ta = tengine.pack_arrivals_by_tick(arr, 45, 1_000)
    np.testing.assert_array_equal(ja.rows, ta.rows)
    np.testing.assert_array_equal(ja.counts, ta.counts)
    assert ja.rows.dtype == ta.rows.dtype and ja.counts.dtype == ta.counts.dtype
    assert int(ta.counts.sum()) == 4 * 30 - 1  # the far job is parked


@pytest.mark.parametrize("chunks,start", [([20, 15, 10], 0), ([7, 30], 8)])
def test_pack_arrivals_chunks_equal(chunks, start):
    arr = _stream_with_far_arrival()
    jp = jengine.pack_arrivals_chunks(arr, chunks, 1_000, start=start)
    tp = tengine.pack_arrivals_chunks(arr, chunks, 1_000, start=start)
    assert len(jp) == len(tp) == len(chunks)
    ks = set()
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.rows.dtype == b.rows.dtype
        ks.add(b.rows.shape[2])
    assert len(ks) > 1, "the chunking must be ragged in K"


def test_round_up_pow2_equal():
    for k in (0, 1, 2, 3, 4, 5, 8, 9, 17, 1000):
        assert jengine.round_up_pow2(k) == tengine.round_up_pow2(k)
