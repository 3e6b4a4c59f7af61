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
    if not torch.cuda.is_available():
        for extra in ((), ("--data_parallel",)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tcli.main(_argv(trained, "card", "--end_epoch", "1", *extra))


def _assert_checkpoints_match(root, tag, epochs=(1, 2)):
    """``tag``'s checkpoints against the plain port run's, within the
    step tolerance (the DP step sums its gradients in another order)."""
    for epoch in epochs:
        name = f"model_epoch{epoch}.npz"
        with np.load(root / "port" / "ckpt" / name) as want, \
                np.load(root / tag / "ckpt" / name) as got:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                           atol=ATOL, err_msg=key)


def test_cli_data_parallel_one_rank(trained):
    """``--data_parallel --device cpu``: one gloo rank in this process,
    the plain run's checkpoints and losses."""
    tcli.main(_argv(trained, "dp", "--end_epoch", "2", "--device", "cpu",
                    "--data_parallel", "--resume",
                    str(trained / "weights.npz")))
    _assert_checkpoints_match(trained, "dp")
    start = [r for r in _events(trained, "dp") if r["event"] == "start"]
    assert start[0]["devices"] == 1
    want, got = ([r["hinge_loss"] for r in _events(trained, tag)
                  if r["event"] == "train"] for tag in ("port", "dp"))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cli_data_parallel_two_ranks_as_torchrun(trained):
    """Two processes with torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) join one gloo group: each takes half
    of every batch, rank 0 alone writes the checkpoints and the metrics,
    and they match the plain run's: every loss, and the first epoch's
    checkpoint. (In the second epoch a conv1-2 pre-activation within
    rounding of 0 takes the other side of its ReLU when the half batches'
    convolutions round differently, which moves those two layers' traces
    by about 1e-4 while the losses stay within 1e-7.)"""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from mccnn_tpu_torch.parallel.launch import free_port

    # tensorflow (the metrics logger's TensorBoard copy) stays unimported
    code = ("import sys; sys.modules['tensorflow'] = None; "
            "from mccnn_tpu_torch.cli.train import main; main(sys.argv[1:])")
    argv = _argv(trained, "dp2", "--end_epoch", "2", "--device", "cpu",
                 "--data_parallel", "--resume", str(trained / "weights.npz"))
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "WORLD_SIZE": "2",
           "OMP_NUM_THREADS": "1"}
    ranks = [subprocess.Popen([sys.executable, "-c", code, *argv],
                              cwd=Path(__file__).resolve().parents[1],
                              env={**env, "RANK": str(rank),
                                   "LOCAL_RANK": str(rank)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        outputs = [process.communicate(timeout=120)[0] for process in ranks]
    finally:
        for process in ranks:
            process.kill()
    assert [process.returncode for process in ranks] == [0, 0], outputs
    assert sorted(p.name for p in (trained / "dp2" / "ckpt").iterdir()) == [
        "model_epoch1.npz", "model_epoch2.npz"]
    _assert_checkpoints_match(trained, "dp2", epochs=(1,))
    records = _events(trained, "dp2")
    assert [r["devices"] for r in records if r["event"] == "start"] == [2]
    assert [r["epoch"] for r in records if r["event"] == "train"] == [
        1, 1, 2, 2]
    for event, key in (("train", "hinge_loss"), ("val", "val_hinge_loss")):
        want, got = ([r[key] for r in _events(trained, tag)
                      if r["event"] == event] for tag in ("port", "dp2"))
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
