"""The port's packages export what the JAX package's export, name for name.

Each ``mccnn_tpu/**/__init__.py`` that re-exports names from its modules is
read with ``ast`` (JAX is not imported); the port's counterpart package
must expose each name as an object of the port's own
(``tests/test_torch_no_jax.py`` imports them all in a fresh process, where
a cycle would show, and checks that no kernel was built).
"""

import ast
import importlib
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _jax_exports():
    """{JAX package: [names its __init__.py imports from mccnn_tpu]}."""
    exports = {}
    for init in sorted((ROOT / "mccnn_tpu").rglob("__init__.py")):
        names = [
            alias.asname or alias.name
            for node in ast.parse(init.read_text()).body
            if isinstance(node, ast.ImportFrom)
            and (node.module or "").startswith("mccnn_tpu")
            for alias in node.names
        ]
        if names:
            package = ".".join(init.parent.relative_to(ROOT).parts)
            exports[package] = names
    return exports


EXPORTS = _jax_exports()


def test_every_exporting_package_is_listed():
    assert set(EXPORTS) == {
        "mccnn_tpu", "mccnn_tpu.ops", "mccnn_tpu.models", "mccnn_tpu.io",
        "mccnn_tpu.pipeline", "mccnn_tpu.data", "mccnn_tpu.utils",
        "mccnn_tpu.parallel"}
    assert "sgm" in EXPORTS["mccnn_tpu.ops"]
    assert "save_reference_npy_dict" in EXPORTS["mccnn_tpu.models"]


@pytest.mark.parametrize("package", sorted(EXPORTS))
def test_port_package_exports_the_same_names(package):
    port = importlib.import_module(package.replace("mccnn_tpu",
                                                   "mccnn_tpu_torch", 1))
    for name in EXPORTS[package]:
        obj = getattr(port, name, None)
        assert obj is not None, f"{port.__name__} lacks {name}"
        assert obj.__module__.startswith("mccnn_tpu_torch."), (name, obj)
        # the object its defining module holds, not a copy
        assert getattr(sys.modules[obj.__module__], obj.__name__) is obj

