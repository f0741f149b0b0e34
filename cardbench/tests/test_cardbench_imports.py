"""Nothing under ``cardbench/`` imports JAX, flax or the JAX package. Top
level names are compared whole: the port's package name begins with the
JAX package's."""

import ast
import sys

from cardbench import harness


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    for path in harness.BENCH.rglob("*.py"):
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        if bad:
            found[str(path.relative_to(harness.ROOT))] = sorted(bad)
    assert not found, found


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "gen", "cost"):
        for path in (harness.BENCH / sub).rglob("*.py"):
            assert harness.PROGRAM not in set(_imports(path)), path


def test_loaded_modules_compared_by_whole_top_level_name(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "multi_cluster_simulator_tpu_torch_x",
                        sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "multi_cluster_simulator_tpu.core", sys)
    assert "multi_cluster_simulator_tpu" in harness.forbidden_modules()
