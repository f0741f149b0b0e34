"""A whole run of each cell on the CPU at a small size, without the
harness's look for a card: the window, the traced segment, the metrics and
the check. Then the same runs with the timed path broken underneath, each
of which the check must call not correct. The cells BENCHMARK.json
holds back run here too."""

import time

import pytest
import torch

from cardbench import harness
from cardbench.tests._tiny import full_manifest, tiny_config, tiny_traffic
from multi_cluster_simulator_tpu_torch.core import engine as E

torch.set_num_threads(1)

CELLS = ("ffd64.deep", "fifo4k.chunked", "ffd64.seeds4")


def _run(cell, seed=7, trace=False):
    manifest = full_manifest()
    spec = harness.find_cell(manifest, cell)
    return harness.run_cell(cell, seed, 0.01, trace, torch.device("cpu"),
                            time.perf_counter(), manifest,
                            config=tiny_config(spec["config"]),
                            traffic=tiny_traffic(spec["traffic"]),
                            trace_ticks=1)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(cell, trace):
    out = _run(cell, trace=trace)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert out["verdict"]["episodes_checked"] >= 1
    names = {m["name"] for m in harness.metrics_for(full_manifest(), cell,
                                                     trace)}
    # on the CPU the device's metrics have nothing to read
    assert set(res["metrics"]) <= names
    if not trace:
        assert {"jobs_per_s", "setup_s"} <= set(res["metrics"])
    else:
        assert {"chunk_copy_ms", "tick_loop_us"} <= set(res["metrics"])


def _unchanged(self, state, *a, **k):
    """A tick that returns its state unchanged."""
    return state, k.get("obs")


def _half(real):
    """A tick that leaves out the second half of the clusters."""
    def tick(self, state, *a, **k):
        keep = harness_clone(state)
        out, obs = real(self, state, *a, **k)
        C = out.arr_ptr.shape[-1]
        for dst, src in zip(harness_leaves(out), harness_leaves(keep)):
            if dst.dim() and dst.shape[-1:] and src.shape == dst.shape \
                    and dst.dim() >= (2 if out.t.dim() else 1):
                sl = (slice(None), slice(C // 2, None)) if out.t.dim() \
                    else (slice(C // 2, None),)
                dst[sl] = src[sl]
        return out, obs
    return tick


def _altered(real):
    """A tick that alters one answer where it is produced: the last
    cluster's first node loses a core in the tick's output."""
    def tick(self, state, *a, **k):
        out, obs = real(self, state, *a, **k)
        out.node_free.view(-1, *out.node_free.shape[-2:])[-1, 0, 0] -= 1
        return out, obs
    return tick


def harness_clone(state):
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    return clone_state(state)


def harness_leaves(state):
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys
    return [x for _, x in leaves_with_keys(state)]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    real = E.Engine._tick
    patched = {"unchanged": _unchanged, "half": _half(real),
               "altered": _altered(real)}[fault]
    monkeypatch.setattr(E.Engine, "_tick", patched)
    res = _run(cell)["result"]
    assert res["correct"] is False
    assert res["failed"] >= 1
