"""mccnn_tpu_torch.cli.train on the CPU, against mccnn_tpu.cli.train.

Both CLIs train two epochs on the same two 32 x 40 scenes from the same
weights file with the same seed, so they draw the same batches; their
checkpoints agree within the step tolerance of tests/test_torch_train.py
(rtol 1e-4, atol 1e-6). Each then resumes from the other's checkpoint.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu.cli import train as jcli  # noqa: E402
from mccnn_tpu.models.params import save_params  # noqa: E402
from mccnn_tpu.utils import metrics as jmetrics  # noqa: E402
from mccnn_tpu_torch.cli import train as tcli  # noqa: E402
from mccnn_tpu_torch.utils import metrics as tmetrics  # noqa: E402

from torch_parity import jax_params, write_training_scenes  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6


def _argv(root, tag, *extra):
    return ["--list_dir", str(root), "--tensorboard_dir", str(root / tag),
            "--checkpoint_dir", str(root / tag / "ckpt"), "--batch_size",
            "16", "--print_freq", "1", *extra]


def _events(root, tag):
    lines = (root / tag / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """Both loggers write JSONL only: importing tensorflow for their
    TensorBoard copies takes seconds and is not what these tests check."""
    with pytest.MonkeyPatch.context() as patch:
        for module in (jmetrics, tmetrics):
            patch.setattr(module, "_try_tb_writer", lambda log_dir: None)
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of each CLI from the JAX package's weights."""
    root = write_training_scenes(tmp_path_factory.mktemp("train"),
                                 np.random.default_rng(0))
    weights = root / "weights.npz"
    save_params(jax_params(), str(weights))
    for tag, main, device in (("jax", jcli.main, ()),
                              ("port", tcli.main, ("--device", "cpu"))):
        main(_argv(root, tag, "--end_epoch", "2", "--resume", str(weights),
                   *device))
    return root


def test_cli_writes_checkpoints_and_events(trained):
    for epoch in (1, 2):
        assert (trained / "port" / "ckpt" / f"model_epoch{epoch}.npz").exists()
    records = _events(trained, "port")
    assert {"start", "train", "checkpoint", "val"} <= {
        r["event"] for r in records}
    assert [r["epoch"] for r in records if r["event"] == "train"] == [
        1, 1, 2, 2]


def test_cli_matches_jax_cli(trained):
    for epoch in (1, 2):
        name = f"model_epoch{epoch}.npz"
        with np.load(trained / "jax" / "ckpt" / name) as want, \
                np.load(trained / "port" / "ckpt" / name) as got:
            assert sorted(got.files) == sorted(want.files)
            assert int(got["num_opt_leaves"]) == 10
            for key in want.files:
                np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                           atol=ATOL, err_msg=key)
    for event, key in (("train", "hinge_loss"), ("val", "val_hinge_loss")):
        want, got = ([r[key] for r in _events(trained, tag)
                      if r["event"] == event] for tag in ("jax", "port"))
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_cli_resumes_either_package(trained, source):
    """--resume model_epoch2.npz (params and momentum) runs epoch 3 only."""
    tag = f"resume_{source}"
    tcli.main(_argv(trained, tag, "--end_epoch", "3", "--device", "cpu",
                    "--resume",
                    str(trained / source / "ckpt" / "model_epoch2.npz")))
    assert sorted(p.name for p in (trained / tag / "ckpt").iterdir()) == [
        "model_epoch3.npz"]
    trains = [r for r in _events(trained, tag) if r["event"] == "train"]
    assert [r["epoch"] for r in trains] == [3, 3]


def test_cli_refusals(trained):
    with pytest.raises(ValueError, match="parallel/"):
        tcli.main(_argv(trained, "dp", "--device", "cpu", "--data_parallel"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(_argv(trained, "card", "--end_epoch", "1"))
