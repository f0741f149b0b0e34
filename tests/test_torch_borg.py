"""The port's Borg-2019 replay ingest (``workload/borg.py``) against the JAX
package's, on the CPU.

Mirrors tests/test_borg.py:36-145: the JSONL lifecycle join, numeric types
and the flat CSV, incomplete lifecycles, the pre-joined CSV and the format
sniff, gzip, the round-robin deal, ``time_scale``; each case holds the
port's ``BorgJobs`` and ``Arrivals`` arrays equal (values and dtypes) to
the reference's. The engine replay runs through both engines, bitwise, and
the generated sample (tools/make_borg_sample.py, built from a fixed seed
on first use; nothing is downloaded) parses the same through both on a
slice of its events.
"""

import gzip
import itertools
import json

import jax
import numpy as np

from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core.engine import Engine as JEngine
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.workload import borg as jborg
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.utils.trace import assert_no_drops
from multi_cluster_simulator_tpu_torch.workload import borg as tborg
from tests.test_borg import _events, _write_jsonl
from tests.test_torch_copies import _assert_arrivals_equal
from tests.test_torch_engine import assert_leaves_equal, jax_leaves, port_cfg


def assert_jobs_equal(a, b):
    """Two ``BorgJobs`` equal: every array (value and dtype) and the raw
    row count."""
    for f in ("t_us", "cpus", "mem", "dur_us"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.n_events == b.n_events


def load_both(path, loader="load_borg"):
    """``path`` through the reference's and the port's loader, held
    equal; returns the port's jobs."""
    want = getattr(jborg, loader)(str(path))
    got = getattr(tborg, loader)(str(path))
    assert_jobs_equal(want, got)
    return got


def arrivals_both(path, *args, **kw):
    """``to_arrivals`` of both packages on the same loaded file, held
    equal (arrays and meta); returns the port's ``(arrivals, meta)``."""
    want, wmeta = jborg.to_arrivals(jborg.load_borg(str(path)), *args, **kw)
    got, gmeta = tborg.to_arrivals(tborg.load_borg(str(path)), *args, **kw)
    _assert_arrivals_equal(want, got)
    assert wmeta == gmeta
    return got, gmeta


class TestLoaders:
    def test_jsonl_join(self, tmp_path):
        p = tmp_path / "ev.jsonl"
        rows = (_events(1, 0, 1_000_000, 2_000_000, 62_000_000)
                + _events(1, 1, 5_000_000, 6_000_000, 36_000_000, term="KILL")
                + _events(2, 0, 3_000_000, 4_000_000, 10_000_000, cpus=0.5))
        _write_jsonl(p, rows)
        j = load_both(p, "load_instance_events")
        assert len(j) == 3 and j.n_events == 9
        assert list(j.dur_us) == [60_000_000, 6_000_000, 30_000_000]

    def test_numeric_types_and_flat_csv(self, tmp_path):
        p = tmp_path / "ev.csv"
        p.write_text(
            "time,type,collection_id,instance_index,"
            "resource_request.cpus,resource_request.memory\n"
            "1000,0,7,0,0.1,0.05\n"
            "2000,3,7,0,,\n"
            "9000,6,7,0,,\n")
        j = load_both(p)
        assert len(j) == 1 and j.dur_us[0] == 7000

    def test_incomplete_lifecycles_skipped(self, tmp_path):
        p = tmp_path / "ev.jsonl"
        rows = _events(1, 0, 1000, 2000, 9000)
        rows += _events(2, 0, 1000, 2000, 9000)[:1]  # never scheduled
        rows += _events(3, 0, 1000, 9000, 2000)  # reordered clock
        _write_jsonl(p, rows)
        assert len(load_both(p, "load_instance_events")) == 1

    def test_prejoined_csv_and_sniff(self, tmp_path):
        p = tmp_path / "jobs.csv"
        p.write_text("submit_time_us,cpus,memory,duration_us\n"
                     "2000,0.5,0.25,60000000\n"
                     "1000,0.25,0.125,30000000\n")
        j = load_both(p)  # sniffed as pre-joined
        assert len(j) == 2 and j.n_events == 0
        load_both(p, "load_jobs_csv")

    def test_gzip_transparent(self, tmp_path):
        p = tmp_path / "ev.jsonl.gz"
        _write_jsonl(p, _events(1, 0, 1000, 2000, 9000), gz=True)
        assert len(load_both(p)) == 1


def _jobs_file(n, tmp_path):
    rows = []
    for i in range(n):
        rows += _events(i, 0, i * 1_000_000, i * 1_000_000 + 500_000,
                        i * 1_000_000 + 30_000_000, cpus=0.25, mem=0.25)
    p = tmp_path / "ev.jsonl"
    _write_jsonl(p, rows)
    return p


class TestToArrivals:
    def test_round_robin_shard(self, tmp_path):
        arr, meta = arrivals_both(_jobs_file(10, tmp_path), 4, 3,
                                  max_cores=32, max_mem=24_000)
        assert meta["rows_used"] == 10 and list(arr.n) == [3, 3, 2, 2]
        assert (arr.t[3, 2:] == 2**31 - 1).all()  # pads sort last

    def test_time_scale_compresses_durations_too(self, tmp_path):
        p = _jobs_file(4, tmp_path)
        a1, m1 = arrivals_both(p, 1, 4, 32, 24_000, time_scale=1.0)
        a2, m2 = arrivals_both(p, 1, 4, 32, 24_000, time_scale=10.0)
        assert m2["span_ms"] * 10 - m1["span_ms"] <= 10
        assert a2.dur[0, 0] * 10 - a1.dur[0, 0] <= 10

    def test_engine_replay_through_both_engines(self, tmp_path):
        """tests/test_borg.py:119: the joined jobs through the FFD engine
        (windowed ingest), all placed with zero drops, the port's final
        state bitwise the reference's; and the same replay bucketed by
        tick, dense and compressed, bitwise too."""
        p = _jobs_file(24, tmp_path)
        arr, meta = jborg.to_arrivals(jborg.load_borg(str(p)), 2, 12, 32,
                                      24_000, time_scale=1000.0)
        tarr, _ = arrivals_both(p, 2, 12, 32, 24_000, time_scale=1000.0)
        cfg = SimConfig(policy=PolicyKind.FFD, parity=False,
                        max_placements_per_tick=16, queue_capacity=16,
                        max_running=32, max_arrivals=12,
                        max_ingest_per_tick=12, max_nodes=5,
                        max_virtual_nodes=0, n_res=2)
        specs = [uniform_cluster(c + 1, 5) for c in range(2)]
        n_ticks = meta["span_ms"] // cfg.tick_ms + 40
        want = jax.jit(JEngine(cfg).run, static_argnums=(2,))(
            jinit_state(cfg, specs), arr, n_ticks)
        tcfg = port_cfg(cfg)
        tspecs = [tspec.uniform_cluster(c + 1, 5) for c in range(2)]
        eng = tengine.Engine(tcfg, device="cpu")
        got = eng.run(tstate.init_state(tcfg, tspecs, device="cpu"), tarr,
                      n_ticks)
        assert_no_drops(got)
        assert int(got.placed_total.sum()) == 24
        assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
        part = tengine.pack_arrivals_by_tick(tarr, n_ticks, tcfg.tick_ms)
        dense = eng.run(tstate.init_state(tcfg, tspecs, device="cpu"), part,
                        n_ticks)
        comp, stats = eng.run_compressed(
            tstate.init_state(tcfg, tspecs, device="cpu"), part, n_ticks)
        assert_leaves_equal(interop.state_to_numpy(dense),
                            interop.state_to_numpy(comp))
        assert int(stats.ticks_executed) < n_ticks


def test_generated_sample_parses(tmp_path):
    """tests/test_borg.py:135: the deterministic sample (generated on first
    use, never committed or fetched) parses the same through both
    packages. Both loaders read its first 200,000 events (its raw schema,
    gzip and the join at a scale that keeps this fast); the deal of its
    rows over 8 clusters too."""
    from tools.make_borg_sample import ensure

    path = tmp_path / "slice.jsonl.gz"
    with gzip.open(ensure(), "rt") as src, gzip.open(path, "wt") as dst:
        dst.writelines(itertools.islice(src, 200_000))
    j = load_both(path)
    assert len(j) > 30_000 and j.n_events == 200_000
    json.loads(gzip.open(path, "rt").readline())  # the raw JSONL schema
    arr, meta = arrivals_both(path, 8, 64, 32, 24_000, time_scale=1000.0)
    assert meta["rows_used"] == 512 and (arr.n == 64).all()
