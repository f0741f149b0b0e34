"""``BENCHMARK.json`` against the benchmark's contract, and the discovery
of every configuration, traffic mix and metric by the name it gives."""

import json
import math
import re

import pytest

from cardbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    cells = []
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in names
        cells.append(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    fours = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert fours <= max(1, len(cells) // 4)
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in SOURCES
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = next(x for x in manifest["end_to_end"]
                         if x["name"] == m["moves"])
            assert cell in moved.get("workloads", cells)
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    all_names = [m["name"] for m in metrics]
    assert len(set(all_names)) == len(all_names)
    assert len(set(cells)) == len(cells) and len(set(names)) == len(names)
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for cell in cells:
        own = [m for m in manifest["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert len(own) >= 2
        assert harness.metrics_for(manifest, cell, True)


def test_every_file_under_paths_is_named_by_name_characters(manifest):
    for p in manifest["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT)
            assert all(NAME.match(part) for part in rel.parts), rel


def test_discovery_by_name(manifest):
    for c in manifest["configs"]:
        cfg = harness.load_config(c["name"])
        assert (ROOT / c["file"]) == harness.BENCH / "configs" / \
            f"{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert callable(harness.load_reference(cfg["reference"])
                        .replay_cluster)
        assert set(cfg["check"]["limits"]) == {"int_mismatch",
                                               "wait_rel_gap"}
    for w in manifest["workloads"]:
        assert harness.load_traffic(w["traffic"])["lanes"] >= 1
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
    for name in ("ffd", "fifo"):
        assert callable(harness.load_cost(name).tick_cost)
    with pytest.raises(FileNotFoundError):
        harness.load_config("no_such_config")
    with pytest.raises(FileNotFoundError):
        harness.load_metric("no_such_metric")
    with pytest.raises(KeyError):
        harness.find_cell(manifest, "no.such.cell")


def test_configs_are_whole(manifest):
    """Nothing cut: ``reduced`` is empty and the sizes are the sources'."""
    fifo = harness.load_config("fifo4k")
    ffd = harness.load_config("ffd64")
    assert fifo["clusters"]["count"] * fifo["stream"]["jobs_per_cluster"] \
        == 1_024_000
    assert harness.n_ticks(fifo) == 1570 and harness.n_ticks(ffd) == 6100
    assert ffd["clusters"]["count"] * ffd["stream"]["jobs_per_cluster"] \
        == 3_840_000
    assert ffd["sim"]["queue_capacity"] == 768


def test_metric_reader_leaves_out_what_it_cannot_read():
    """A reader that finds nothing returns None, never 0."""
    class Ctx:
        trace = None
    for name in ("chunk_copy_ms", "tick_loop_us", "device_idle_pct",
                 "fused_prefix_ffd_roofline", "fused_prefix_fifo_roofline",
                 "episode_s_p90.host"):
        assert harness.load_metric(name).read(Ctx()) is None


def test_p90_and_seeds():
    assert harness.p90([1.0]) == 1.0
    assert math.isclose(harness.p90([float(i) for i in range(1, 11)]), 9.1)
    assert harness.stream_seed(2**31 + 5, 0) != harness.stream_seed(
        2**31 + 5, 1)
    assert harness.stream_seed(-3, 0) == harness.stream_seed(2**64 - 3, 0)
    s = harness.sample_clusters(64, 16, 12345)
    assert len(set(s)) == 16 and all(4 * i <= c < 4 * i + 4
                                     for i, c in enumerate(s))
    assert json.loads(json.dumps(s)) == s
