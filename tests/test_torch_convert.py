"""mccnn_tpu_torch's weight converter (cli/convert.py) and npy-dict writer
against mccnn_tpu's.

Both packages write and read the same two files: the flat npz of
``save_params`` and the reference's npy dict (``conv{i}/weights:0``,
``conv{i}/biases:0``). Every comparison is of float32 arrays copied, not
computed, so each is exact.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu.cli import convert as jconvert  # noqa: E402
from mccnn_tpu.models import params as jparams  # noqa: E402
from mccnn_tpu_torch.cli import convert as tconvert  # noqa: E402
from mccnn_tpu_torch.models import params as tparams  # noqa: E402

from torch_parity import jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _assert_params_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == ["b", "w"]
        for kind in ("w", "b"):
            assert got[name][kind].dtype == np.float32
            np.testing.assert_array_equal(got[name][kind],
                                          np.asarray(want[name][kind]))


def _npy_dict(path):
    return np.load(path, allow_pickle=True).item()


def test_save_reference_npy_dict_matches_jax(tmp_path):
    params = jax_params()
    jparams.save_reference_npy_dict(params, str(tmp_path / "jax.npy"))
    tparams.save_reference_npy_dict(params, str(tmp_path / "port.npy"))
    want, got = (_npy_dict(tmp_path / f"{who}.npy") for who in ("jax", "port"))
    assert sorted(got) == sorted(want)
    assert "conv1/weights:0" in got and "conv5/biases:0" in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    # the port's reader gives back what its writer was given
    _assert_params_equal(
        tparams.load_reference_npy_dict(str(tmp_path / "port.npy")), params)


def test_convert_cli_npz_npy_npz_is_the_identity(tmp_path, capsys):
    """``python -m mccnn_tpu_torch.cli.convert w.npz w.npy`` writes the dict
    JAX reads as ``w.npz``; converting it back gives the same npz; both
    print JAX's report line."""
    params = jax_params()
    source = str(tmp_path / "w.npz")
    tparams.save_params(params, source)
    npy = str(tmp_path / "w.npy")
    proc = subprocess.run(
        [sys.executable, "-m", "mccnn_tpu_torch.cli.convert", source, npy],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    _assert_params_equal(jparams.load_reference_npy_dict(npy), params)

    layers = ", ".join(f"{name}:{tuple(layer['w'].shape)}"
                       for name, layer in sorted(params.items()))
    assert proc.stdout == f"converted {source} -> {npy} ({layers})\n"

    back = str(tmp_path / "back.npz")
    tconvert.main([npy, back])
    assert capsys.readouterr().out == f"converted {npy} -> {back} ({layers})\n"
    jconvert.main([npy, back + ".jax.npz"])
    assert capsys.readouterr().out == (
        f"converted {npy} -> {back}.jax.npz ({layers})\n")
    with np.load(source) as want, np.load(back) as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])


def test_each_package_reads_the_others_conversions(tmp_path):
    params = jax_params()
    source = str(tmp_path / "w.npz")
    jparams.save_params(params, source)
    for who, main, load_any in (("jax", jconvert.main, tparams.load_any),
                                ("port", tconvert.main, jparams.load_any)):
        for suffix in ("npy", "npz"):
            dest = str(tmp_path / f"{who}.{suffix}")
            main([source, dest])
            _assert_params_equal(load_any(dest), params)


def test_convert_refuses_other_destinations(tmp_path):
    source = str(tmp_path / "w.npz")
    tparams.save_params(jax_params(), source)
    for main in (jconvert.main, tconvert.main):
        with pytest.raises(SystemExit,
                           match="destination must end in .npz or .npy"):
            main([source, str(tmp_path / "w.ckpt")])
    assert not (tmp_path / "w.ckpt").exists()


def test_convert_names_tensorflow_for_a_checkpoint_prefix(tmp_path):
    """A TF1 prefix: the port needs tensorflow for it and says so (JAX
    raises ImportError there when tensorflow is missing)."""
    with pytest.raises(ValueError, match="tensorflow.*mccnn_tpu.cli.convert"):
        tconvert.main([str(tmp_path / "model_epoch2000.ckpt"),
                       str(tmp_path / "w.npz")])
