"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
whole top-level name: ``mccnn_tpu_torch`` begins with ``mccnn_tpu``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mccnn_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_torch_and_numpy_only():
    for path in (BENCH / "reference").glob("*.py"):
        assert top_level_imports(path) <= {"__future__", "numpy", "torch"}


def test_name_comparison_is_whole():
    assert "mccnn_tpu_torch" not in FORBIDDEN
    assert "mccnn_tpu_torch.pipeline".split(".")[0] not in FORBIDDEN


def test_a_run_loads_none_of_them(tmp_path):
    """A CPU run of a tiny cell in a fresh process, then its modules."""
    script = tmp_path / "probe.py"
    script.write_text(f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}, {str(BENCH / 'tests')!r}]
import torch
torch.set_num_threads(2)
from conftest import tiny_cell
from portbench import harness
cell = tiny_cell("half-stream-mix")
run, weights, pool = harness.drive(cell, 5, 0.5, False, "cpu")
numbers = harness.compare(run, weights, pool, 5, "cpu")
print(json.dumps(harness.forbidden_modules()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    found, loaded = (json.loads(line) for line in out.splitlines()[-2:])
    assert found == []
    assert "mccnn_tpu_torch" in loaded
    assert not set(loaded) & FORBIDDEN
