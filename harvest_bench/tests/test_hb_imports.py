"""No module of the benchmark imports ``jax``, ``jaxlib``, ``flax``, the
JAX package ``repro`` or the old ``benchmarks`` folder: top-level names are
compared whole (``repro_torch`` starts with ``repro`` and is the port)."""
import ast

import pytest

from harvest_bench.harness.spec import BENCH_DIR

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_banned_import(path):
    assert not top_level_imports(path) & BANNED


def test_the_port_is_not_mistaken_for_repro():
    assert "repro_torch" not in BANNED and "repro" in BANNED


def test_the_references_import_nothing_of_the_port():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path
