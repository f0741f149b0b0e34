"""The port's command-line drivers (multi_cluster_simulator_tpu_torch/
tools/): none imports ``jax``, the JAX package or ``bench`` (read from
each module's source, and checked by importing every tool in a fresh
interpreter), and the observability gate ``metrics_smoke`` exits 0 on the
CPU."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "multi_cluster_simulator_tpu_torch", "tools")
MODULES = sorted(f[:-3] for f in os.listdir(TOOLS)
                 if f.endswith(".py") and f != "__init__.py")
FORBIDDEN = ("jax", "multi_cluster_simulator_tpu", "bench", "tools")


def imported(path: str) -> set:
    """Every top-level package a module's source imports."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_every_ported_driver_is_here():
    for name in ("tournament", "train_env_demo", "chaos", "market_ab",
                 "metrics_smoke", "profile_capture"):
        assert name in MODULES, name


@pytest.mark.parametrize("name", MODULES)
def test_tool_imports_no_jax_nor_the_jax_package(name):
    bad = imported(os.path.join(TOOLS, name + ".py")) & set(FORBIDDEN)
    assert not bad, f"{name} imports {sorted(bad)}"


def test_tools_load_without_jax():
    code = ("import sys\n"
            + "".join(f"import multi_cluster_simulator_tpu_torch.tools.{m}\n"
                      for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'bench' or "
              "m.split('.')[0] == 'multi_cluster_simulator_tpu')\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_metrics_smoke_exits_zero_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m",
         "multi_cluster_simulator_tpu_torch.tools.metrics_smoke",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=180, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "metrics_smoke OK on cpu" in proc.stderr
