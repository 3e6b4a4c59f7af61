"""mccnn_tpu_torch imports neither JAX nor the JAX package mccnn_tpu."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    import mccnn_tpu_torch

    return sorted(
        info.name for info in pkgutil.walk_packages(
            mccnn_tpu_torch.__path__, "mccnn_tpu_torch.")
    )


def test_port_modules_import_without_jax():
    modules = _port_modules()
    assert "mccnn_tpu_torch.ops.sgm" in modules
    assert "mccnn_tpu_torch.cli.serve" in modules
    assert "mccnn_tpu_torch.cli.match" in modules
    assert "mccnn_tpu_torch.utils.scenes" in modules
    for new in ("ops.cbca_rolling", "ops.cbca_fused2", "ops.cbca_mxu",
                "ops.cbca_joint", "cli.eval", "tools.bench_cbca_stream",
                "pipeline.train", "utils.checkpoint", "data.sampler",
                "data.prefetch", "native", "cli.train",
                "tools.eval_fullscale", "tools.train_fullscale",
                "tools.parity_eval", "parallel", "parallel.multihost",
                "parallel.mesh", "parallel.cbca", "parallel.pallas_shard",
                "parallel.sgm", "parallel.match", "parallel.train",
                "parallel.launch", "tools.multiprocess_bringup",
                "tools.multichip_midscale", "bench", "tools.bench_serve",
                "tools.profile_pipeline", "tools.profile_fullres",
                "tools.warmup", "tools.bench_all", "cli.convert",
                "tools.bench_cbca_banded", "tools.bench_cbca_layout",
                "tools.time_stream_variants", "utils.tracing"):
        assert f"mccnn_tpu_torch.{new}" in modules
    assert "mccnn_tpu_torch.shared" not in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'mccnn_tpu') "
        "or m.startswith(('jax.', 'jaxlib', 'mccnn_tpu.')))\n"
        "assert not bad, bad\n"
        "from mccnn_tpu_torch.kernels import build\n"
        "assert build.library.cache_info().currsize == 0, 'kernels built'\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|mccnn_tpu)\b", re.M)


def test_only_the_gateway_imports_mccnn_tpu():
    """There is no gateway any more: nothing in the port or in
    chip_smoke.py imports JAX or the JAX package (the port keeps its own
    copies of the numpy-only modules)."""
    importers = sorted(
        str(path.relative_to(ROOT))
        for path in [ROOT / "chip_smoke.py",
                     *(ROOT / "mccnn_tpu_torch").rglob("*.py")]
        if _IMPORT.search(path.read_text())
    )
    assert importers == []
    assert not (ROOT / "mccnn_tpu_torch" / "shared.py").exists()


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA (or outside a checkout) it exits non-zero, printing no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
