"""What the benchmark imports: nothing of JAX or the JAX package anywhere
(top-level module names compared whole), nothing of the program in the
reference and the yardstick."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

PKG = harness.ROOT / "perfbench"
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)
PLAIN = sorted((PKG / "reference").glob("*.py")) + [
    PKG / "yardstick.py", PKG / "scene.py", PKG / "trace.py",
    PKG / "weights.py", PKG / "harness.py", PKG / "readers.py"]


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(harness.BANNED_MODULES)


@pytest.mark.parametrize("path", PLAIN, ids=lambda p: p.name)
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert "ngp_pl_torch" not in top_level_imports(path)


def test_names_are_compared_whole():
    assert "ngp_pl_torch".split(".")[0] not in harness.BANNED_MODULES
    assert "jaxlib.xla".split(".")[0] in harness.BANNED_MODULES


def test_the_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.train, perfbench.reference.render\n"
            "import perfbench.reference.grid, perfbench.yardstick\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('ngp_pl_torch', 'jax', 'jaxlib', 'flax', 'ngp_pl_tpu')]\n"
            "assert not bad, bad\n" % str(harness.ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
