"""The port's ``kernels/fused_tick.py`` on the CPU, where ``fused_prefix``
takes its plain PyTorch version: single ticks from states the JAX engine
reaches, against the JAX package's Pallas ``fused_prefix`` (``fused="on"``,
``fused_block=2``, interpret mode on the CPU as tests/test_kernels.py runs
it), bitwise, each tick as reached and with foreign jobs loaded into the
lent queue so that the lent-head attempt runs. Also: the launch counter stays 0 off the card, the entry
points refuse to guess a device, the kernel build module imports without a
CUDA compiler, and no module of the port (nor chip_smoke.py) imports jax,
flax or the JAX package."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import multi_cluster_simulator_tpu_torch as port
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.kernels import fused_tick as jfused
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.kernels import fused_tick as tfused
from multi_cluster_simulator_tpu_torch.core.state import SRC_LENT
from tests.test_torch_engine import (
    assert_leaves_equal, headline_cfg, jax_leaves, load_lent, n_traced,
    port_cfg, specs, stream,
)

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "multi_cluster_simulator_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "multi_cluster_simulator_tpu"}
C = 8
TICKS = (1, 5, 11, 18)


@pytest.fixture(scope="module")
def jax_ticks():
    """(t, rows, counts, state before, JAX fused prefix after) per tick,
    on the headline shape with tight bounds so drops and failures occur;
    each tick twice, the second time with the lent queue loaded."""
    cfg = headline_cfg(queue_capacity=4, max_running=6)
    arr, _ = stream(n_clusters=C, jobs=50, horizon_ms=18_000, seed=8,
                    max_cores=16)
    jspecs, _ = specs(C)
    n = max(TICKS)
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    eng = jengine.Engine(cfg)
    eng_f = jengine.Engine(dataclasses.replace(cfg, fused="on",
                                               fused_block=2))
    params = eng._default_params
    step = jax.jit(eng.step_tick)
    fused = jax.jit(lambda s, r, c, t: jfused.fused_prefix(
        eng_f, s, r, c, t, params, True, emit_returns=False)[0])
    state = jinit_state(cfg, jspecs)
    out = []
    for k in range(n):
        rows, counts = jnp.asarray(ta.rows[k]), jnp.asarray(ta.counts[k])
        if k + 1 in TICKS:
            t = int(state.t) + cfg.tick_ms
            for s in (state, load_lent(state, 30 + k)):
                out.append((t, ta.rows[k], ta.counts[k], s,
                            fused(s, rows, counts, jnp.int32(t))))
        state = step(state, rows, counts)
    return cfg, out


@pytest.mark.parametrize("lent", [False, True], ids=["as_reached", "lent"])
@pytest.mark.parametrize("i", range(len(TICKS)))
def test_fused_prefix_bitwise_equals_jax_pallas(jax_ticks, i, lent):
    cfg, ticks = jax_ticks
    t, rows, counts, before, want = ticks[2 * i + lent]
    eng = tengine.Engine(port_cfg(cfg), device="cpu")
    state = interop.state_from_numpy(jax_leaves(before), device="cpu")
    lent_before = n_traced(state, SRC_LENT)
    tfused.reset_launches()
    params = eng._default_params
    out, *io = tfused.fused_prefix(eng, state,
                                   torch.from_numpy(rows.copy()),
                                   torch.from_numpy(counts.copy()), t,
                                   params, tfused.host_params(eng, params))
    assert out is state, "the prefix updates the state in place"
    assert io == [None] * 5, "the terminal form emits nothing, untapped"
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(out))
    # the CPU takes the plain path
    assert not any(tfused.launch_counts().values())
    if not lent:
        assert n_traced(out, SRC_LENT) == lent_before


def test_lent_ticks_place_foreign_jobs(jax_ticks):
    """The lent-loaded ticks do reach the lent-head attempt's placement."""
    _, ticks = jax_ticks
    placed = 0
    for t, rows, counts, before, want in ticks[1::2]:
        a = interop.state_from_numpy(jax_leaves(before), device="cpu")
        b = interop.state_from_numpy(jax_leaves(want), device="cpu")
        placed += n_traced(b, SRC_LENT) - n_traced(a, SRC_LENT)
    assert placed > 0


def test_reference_leaves_its_input_alone(jax_ticks):
    cfg, ticks = jax_ticks
    t, rows, counts, before, want = ticks[-1]
    eng = tengine.Engine(port_cfg(cfg), device="cpu")
    state = interop.state_from_numpy(jax_leaves(before), device="cpu")
    out = tfused.fused_prefix_reference(eng, state, torch.from_numpy(rows),
                                        torch.from_numpy(counts), t,
                                        eng._default_params)[0]
    assert_leaves_equal(jax_leaves(before), interop.state_to_numpy(state))
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(out))


def test_wrapper_refuses_mixed_devices(jax_ticks):
    """No silent fallback: tensors that are not all on the CPU or all on
    one CUDA device are refused, and nothing launches."""
    cfg, ticks = jax_ticks
    t, rows, counts, before, _ = ticks[0]
    eng = tengine.Engine(port_cfg(cfg), device="cpu")
    state = interop.state_from_numpy(jax_leaves(before), device="cpu")
    meta_rows = torch.empty(rows.shape, dtype=torch.int32, device="meta")
    tfused.reset_launches()
    params = eng._default_params
    with pytest.raises(ValueError, match="CUDA device"):
        tfused.fused_prefix(eng, state, meta_rows,
                            torch.from_numpy(counts), t, params,
                            tfused.host_params(eng, params))
    assert not any(tfused.launch_counts().values())


def test_span_and_provenance():
    cfg = port_cfg(headline_cfg())
    assert tfused.engaged_span(cfg) == ("release", "ingest", "schedule")
    assert tfused.engaged_span(cfg) == jfused.engaged_span(headline_cfg())
    prov = tfused.provenance(tengine.Engine(cfg, device="cpu"))
    assert prov["kernel"] == "fused_prefix_fifo" and prov["route"] == "cuda"
    assert prov["terminal"] and not prov["emit_returns"]
    assert (REPO / prov["source"]).exists()
    path, line = prov["replaces"].split(":")
    src = (REPO / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("def fused_prefix(")


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(headline_cfg())
    _, tspecs = specs(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.Engine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate.init_state(cfg, tspecs)
    assert tengine.Engine(cfg, device="cpu").device.type == "cpu"


def test_build_module_imports_without_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)  # no nvcc on it
    env["PYTHONPATH"] = str(REPO)
    code = ("import multi_cluster_simulator_tpu_torch.kernels.build as b\n"
            "import shutil\n"
            "assert shutil.which('nvcc') is None\n"
            "print(sorted(b.SOURCES))\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "fused_prefix_fifo" in out.stdout
    assert "fused_prefix_ffd" in out.stdout


def _port_files():
    return sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_port_file_imports_jax_or_the_jax_package():
    """An AST scan: the top-level module of every import, compared exactly
    (``multi_cluster_simulator_tpu_torch`` shares the reference's prefix)."""
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_files()) > 20


def test_importing_the_whole_port_loads_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="multi_cluster_simulator_tpu_torch."))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            f"bad = sorted(set({sorted(FORBIDDEN)!r}) & set(sys.modules))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(mods) > 15
