"""``python -m mccnn_tpu_torch.cli.match`` against ``python -m
mccnn_tpu.cli.match``: the same flags, the same artifacts for the same
scene list. The port runs with ``--device cpu``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu.cli import match as jax_cli  # noqa: E402
from mccnn_tpu.io.pfm import read_pfm  # noqa: E402
from mccnn_tpu.models.params import save_params as jax_save_params  # noqa: E402
from mccnn_tpu_torch.cli import match as port_cli  # noqa: E402
from mccnn_tpu_torch.pipeline.match import STAGES  # noqa: E402

from test_cli import _write_scene  # noqa: E402
from torch_parity import jax_params  # noqa: E402

# short crosses and one round each keep the JAX CPU compile short
FAST = ["--cbca_distance", "3", "--cbca_num_iterations1", "1",
        "--cbca_num_iterations2", "1"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two Middlebury-layout scenes of one shape, a list file and weights
    saved by the JAX package."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for name in ("sceneA", "sceneB"):
        _write_scene(root / "data" / name, rng)
    (root / "list.txt").write_text(
        f"{root}/data/sceneA/im0.png\n{root}/data/sceneB/im0.png\n")
    jax_save_params(jax_params(), str(root / "weights.npz"))
    return root


def _argv(root, save_dir, start=0, end=1, extra=()):
    return ["--list_file", str(root / "list.txt"),
            "--resume", str(root / "weights.npz"),
            "--data_dir", str(root / "data"), "--save_dir", str(save_dir),
            "--tag", "t0", "--start", str(start), "--end", str(end),
            *FAST, *extra]


def _files(save_dir):
    return sorted(str(p.relative_to(save_dir)) for p in save_dir.rglob("*")
                  if p.is_file())


def test_same_artifacts_as_the_jax_cli(scenes, monkeypatch):
    # sgm_chunk is JAX's semantics-neutral scan-unroll knob; 1 keeps the
    # CPU compile short
    config_from_args = jax_cli.config_from_args
    monkeypatch.setattr(
        jax_cli, "config_from_args",
        lambda args: config_from_args(args).replace(sgm_chunk=1))
    jax_cli.main(_argv(scenes, scenes / "jax"))
    port_cli.main(_argv(scenes, scenes / "port", extra=["--device", "cpu"]))
    assert _files(scenes / "port") == _files(scenes / "jax") == [
        f"submit_t0{kind}/scene{s}/{name}"
        for kind, names in (("", ("disp0MCCNN.pfm", "timeMCCNN.txt")),
                            ("_imgs", ("disp0MCCNN.pgm",)))
        for s in "AB" for name in names]
    for scene in ("sceneA", "sceneB"):
        rel = f"submit_t0/{scene}/disp0MCCNN.pfm"
        got = read_pfm(str(scenes / "port" / rel))
        want = read_pfm(str(scenes / "jax" / rel))
        assert got.shape == want.shape == (24, 40)
        assert np.isfinite(got).all()
        # the f32 budget: equal integer disparities up to WTA ties, the
        # subpixel fraction within float reassociation
        assert np.mean(np.abs(got - want) > 1e-3) <= 0.005
        assert abs(np.mean(np.abs(got - 3.0) > 2.0)
                   - np.mean(np.abs(want - 3.0) > 2.0)) <= 0.005
        rel = f"submit_t0_imgs/{scene}/disp0MCCNN.pgm"
        got_pgm = (scenes / "port" / rel).read_bytes()
        want_pgm = (scenes / "jax" / rel).read_bytes()
        assert len(got_pgm) == len(want_pgm)
        if np.array_equal(got, want):
            assert got_pgm == want_pgm
        else:  # the same header; pixels differ only where the PFM does
            differ = np.frombuffer(got_pgm, np.uint8) != np.frombuffer(
                want_pgm, np.uint8)
            assert differ.mean() <= np.mean(got != want)
        seconds = (scenes / "port" / f"submit_t0/{scene}/timeMCCNN.txt")
        assert float(seconds.read_text()) > 0


def test_start_and_end_select_scenes(scenes):
    port_cli.main(_argv(scenes, scenes / "slice", start=1, end=1,
                        extra=["--device", "cpu"]))
    assert _files(scenes / "slice") == [
        "submit_t0/sceneB/disp0MCCNN.pfm", "submit_t0/sceneB/timeMCCNN.txt",
        "submit_t0_imgs/sceneB/disp0MCCNN.pgm"]


@pytest.mark.parametrize("extra", [
    ["--cbca_impl", "pallas"],
    ["--cbca_impl", "fused8", "--volume_dtype", "bfloat16"],
    ["--cost_volume_method", "rolldot", "--cbca_chunk_d", "64"],
], ids=["pallas", "fused8-bf16", "rolldot-chunked"])
def test_stage_times_prints_ten_stages_and_same_disparity(scenes, capsys,
                                                          extra):
    common = ["--device", "cpu", *extra]
    port_cli.main(_argv(scenes, scenes / "plain", end=0, extra=common))
    capsys.readouterr()
    port_cli.main(_argv(scenes, scenes / "staged", end=0,
                        extra=[*common, "--stage_times"]))
    lines = [line for line in capsys.readouterr().out.splitlines()
             if re.fullmatch(r"  \w+ +\d+\.\d ms", line)]
    assert [line.split()[0] for line in lines] == list(STAGES)
    # the CLI's format: f"  {stage:16s} {ms:9.1f} ms"
    assert all(len(line) == 2 + 16 + 1 + 9 + 3 for line in lines)
    rel = "submit_t0/sceneA/disp0MCCNN.pfm"
    np.testing.assert_array_equal(read_pfm(str(scenes / "staged" / rel)),
                                  read_pfm(str(scenes / "plain" / rel)))


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.type, a.default, a.required,
                     tuple(a.choices) if a.choices else None, a.nargs)
            for a in parser._actions if a.dest != "help"}


JAX_FLAGS = sorted(_options(jax_cli.build_parser()))


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_flag_matches_the_jax_cli(dest):
    """Same names, types, defaults and choices, flag by flag."""
    assert _options(port_cli.build_parser())[dest] == \
        _options(jax_cli.build_parser())[dest]


def test_port_adds_only_the_device_flag():
    extra = set(_options(port_cli.build_parser())) - set(JAX_FLAGS)
    assert extra == {"device"}
    args = port_cli.build_parser().parse_args(
        ["--list_file", "l", "--resume", "w.npz", "--data_dir", "d",
         "--save_dir", "s", "-t", "x", "-s", "0", "-e", "0", "-g", "1"])
    assert args.device == "cuda" and args.bucket == 1 and args.gpu == "1"
    assert port_cli.config_from_args(args).cbca_distance == 14


@pytest.mark.parametrize("extra", [
    ["--cbca_impl", "pallas", "--volume_dtype", "bfloat16"],
    ["--cbca_impl", "mxu", "--volume_dtype", "bfloat16"],
], ids=lambda extra: "-".join(extra).replace("--", ""))
def test_unported_options_exit_with_value_error(scenes, extra):
    """What still raises: the two f32-only CBCA backends on bf16 volumes
    (TF1 checkpoints: ``test_torch_net.py``)."""
    with pytest.raises(ValueError):
        port_cli.main(_argv(scenes, scenes / "refused",
                            extra=["--device", "cpu", *extra]))
    assert not (scenes / "refused").exists()


def test_multihost_writes_each_scene_once(scenes, tmp_path):
    """Two ``--multihost`` processes over the two scenes, started with
    ``RANK`` 0 and 1 of ``WORLD_SIZE`` 2 and no process group: rank 0
    writes scene A, rank 1 scene B, and together they write what one
    process writes."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    argv = _argv(scenes, tmp_path / "multi", extra=["--device", "cpu",
                                                    "--multihost"])
    ranks = [subprocess.Popen(
        [sys.executable, "-m", "mccnn_tpu_torch.cli.match", *argv],
        cwd=Path(__file__).resolve().parents[1],
        env={**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
             "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outputs = [process.communicate(timeout=120)[0] for process in ranks]
    finally:
        for process in ranks:
            process.kill()
    assert [process.returncode for process in ranks] == [0, 0], outputs
    assert _files(tmp_path / "multi") == [
        f"submit_t0{kind}/scene{s}/{name}"
        for kind, names in (("", ("disp0MCCNN.pfm", "timeMCCNN.txt")),
                            ("_imgs", ("disp0MCCNN.pgm",)))
        for s in "AB" for name in names]
    # each file written once: the same disparity as the one-process run
    port_cli.main(_argv(scenes, tmp_path / "one", extra=["--device", "cpu"]))
    for s in "AB":
        rel = f"submit_t0/scene{s}/disp0MCCNN.pfm"
        np.testing.assert_array_equal(read_pfm(str(tmp_path / "multi" / rel)),
                                      read_pfm(str(tmp_path / "one" / rel)))


def test_multihost_rank_keeps_its_scenes(scenes, tmp_path, monkeypatch):
    """In one process, ``RANK=1 WORLD_SIZE=2`` keeps scene B only."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    port_cli.main(_argv(scenes, tmp_path / "rank1",
                        extra=["--device", "cpu", "--multihost"]))
    assert _files(tmp_path / "rank1") == [
        "submit_t0/sceneB/disp0MCCNN.pfm", "submit_t0/sceneB/timeMCCNN.txt",
        "submit_t0_imgs/sceneB/disp0MCCNN.pgm"]


@pytest.mark.parametrize("extra", [
    ["--cbca_impl", "mxu"], ["--cbca_impl", "fused16"],
    ["--cbca_impl", "fused2"], ["--cbca_impl", "fused2_16"],
    ["--cbca_impl", "rolling"], ["--cbca_impl", "rolling16"],
    ["--cbca_impl", "rolling", "--volume_dtype", "bfloat16"],
    ["--cbca_joint_regions"],
], ids=lambda extra: "-".join(extra).replace("--", ""))
def test_variant_options_run(scenes, extra):
    """Every CBCA backend name of the JAX CLI and the joint regions run
    through the port's CLI; the exact-f32 ones give the default's map."""
    tag = "-".join(extra).replace("--", "")
    port_cli.main(_argv(scenes, scenes / tag, end=0,
                        extra=["--device", "cpu", *extra]))
    rel = "submit_t0/sceneA/disp0MCCNN.pfm"
    got = read_pfm(str(scenes / tag / rel))
    assert got.shape == (24, 40) and np.isfinite(got).all()
    if not (scenes / "default").exists():
        port_cli.main(_argv(scenes, scenes / "default", end=0,
                            extra=["--device", "cpu"]))
    want = read_pfm(str(scenes / "default" / rel))
    if extra in (["--cbca_impl", "fused2"], ["--cbca_impl", "rolling"]):
        np.testing.assert_array_equal(got, want)
    elif "--cbca_joint_regions" not in extra:
        # the reduced-precision budget, on the GT of 3 px everywhere
        assert abs(np.mean(np.abs(got - 3.0) > 2.0)
                   - np.mean(np.abs(want - 3.0) > 2.0)) <= 0.005


def test_shape_mismatch_with_calib_raises(scenes, tmp_path):
    bad = tmp_path / "data" / "sceneC"
    _write_scene(bad, np.random.default_rng(1), height=24, width=40)
    calib = (bad / "calib.txt").read_text().replace("width=40", "width=48")
    (bad / "calib.txt").write_text(calib)
    (tmp_path / "list.txt").write_text(f"{bad}/im0.png\n")
    with pytest.raises(ValueError, match="calib"):
        port_cli.main(["--list_file", str(tmp_path / "list.txt"),
                       "--resume", str(scenes / "weights.npz"),
                       "--data_dir", str(tmp_path / "data"),
                       "--save_dir", str(tmp_path / "out"), "-t", "t0",
                       "-s", "0", "-e", "0", "--device", "cpu", *FAST])
