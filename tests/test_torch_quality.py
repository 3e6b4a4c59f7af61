"""The port's quality loop (mccnn_tpu_torch/tools: eval_fullscale,
train_fullscale, parity_eval) on the CPU, against the oracle chain and the
JAX package's tools.

The oracle-chain and parity cases run the port's pipeline against
``tests/oracles.py`` through the port's copy of the chain; the
five-family case holds the port's fast bf16 schedule to its exact one at
paper defaults; the tool cases run each tool at a tiny size and hold its
numbers to ``evaluate_pair`` on ``match_pair`` outputs computed here.
Scenes are 28 x 40, the smallest width and height at which every cross of
the paper's distance (13 pixels each way) fits: a pipeline at paper
defaults costs about 0.8 s on one CPU thread there, 2 s at 48 x 64.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mccnn_tpu.models.net import init_params as jax_init_params  # noqa: E402
from mccnn_tpu.utils.evaluate import evaluate_pair as jax_evaluate_pair  # noqa: E402,E501
from mccnn_tpu_torch.io.pfm import read_pfm  # noqa: E402
from mccnn_tpu_torch.models.net import init_params, params_from_numpy  # noqa: E402,E501
from mccnn_tpu_torch.pipeline.match import match_pair  # noqa: E402
from mccnn_tpu_torch.tools import eval_fullscale, parity_eval, train_fullscale  # noqa: E402,E501
from mccnn_tpu_torch.utils.evaluate import evaluate_pair  # noqa: E402

import torch_parity  # noqa: E402,F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parents[1]
HEIGHT, WIDTH, MAX_DISPARITY = 28, 40, 8  # eval scenes; ndisp 10
# bad-2.0 budgets: the bf16 schedule against the exact one, and the port
# against the oracle chain
BF16_BUDGET = 0.005


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- the whole oracle chain -------------------------------------------------


def test_end_to_end_matches_oracle_chain(rng):
    """tests/test_pipeline.py::test_end_to_end_matches_oracle_chain for the
    port: JAX's init_params(key(1)) carried across, the 10 x 16 pair, the
    oracle tests' configuration, ndisp 5."""
    from test_pipeline import CFG, _stereo_pair

    config = parity_eval.parity_config()
    assert dataclasses.asdict(config) == dataclasses.asdict(CFG)
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.key(1)))
    net = params_from_numpy(params)
    left, right = _stereo_pair(rng)
    ndisp = 5

    ours = match_pair(net, torch.from_numpy(left), torch.from_numpy(right),
                      ndisp, config).numpy()
    expected = parity_eval.oracle_pipeline(net, left, right, ndisp, config)

    # argmin ties under float reassociation may flip isolated pixels
    close = np.isclose(ours, expected, atol=1e-2)
    assert close.mean() > 0.98, f"only {close.mean():.2%} pixels agree"


# --- the bf16 budget on the five families -----------------------------------


@pytest.fixture(scope="module")
def family_maps():
    """Each family's eval scene (the tool's seeds, no noise) through
    ``match_pair`` at paper defaults, fast (bf16) and exact, with
    ``init_params(0)``: {family: (gt, fast, exact)}."""
    net = params_from_numpy(init_params(0))
    maps = {}
    for i, family in enumerate(eval_fullscale.FAMILIES):
        left, right, gt = eval_fullscale.eval_scene(
            family, i, HEIGHT, WIDTH, MAX_DISPARITY, 0.0)
        left, right = torch.from_numpy(left), torch.from_numpy(right)
        ndisp = MAX_DISPARITY + 2
        fast = match_pair(net, left, right, ndisp, volume_dtype="bfloat16")
        exact = match_pair(net, left, right, ndisp, cbca_impl="xla",
                           cost_volume_method="matmul")
        maps[family] = (gt, fast.numpy(), exact.numpy())
    return maps


@pytest.mark.parametrize("family", eval_fullscale.FAMILIES)
def test_bf16_schedule_within_budget_of_exact(family_maps, family):
    gt, fast, exact = family_maps[family]
    assert np.isfinite(fast).all() and np.isfinite(exact).all()
    fast_bad2 = evaluate_pair(fast, gt)["bad_2.0"]
    exact_bad2 = evaluate_pair(exact, gt)["bad_2.0"]
    assert abs(fast_bad2 - exact_bad2) <= BF16_BUDGET, (fast_bad2,
                                                        exact_bad2)


def test_photo_family_reads_bundled_photographs():
    """The photo rows above are photographs here, not synthetic texture
    (tests/test_parity_metrics.py asserts the same for the JAX copy)."""
    assert not eval_fullscale.photo_source().startswith("none")


# --- non-finite predictions (F2) ----------------------------------------------


def test_tools_score_non_finite_predictions_as_bad():
    gt = np.full((4, 5), 3.0, np.float32)
    gt[0, 0] = np.inf  # not scored
    disparity = gt.copy()
    disparity[0, 0] = 0.0
    disparity[1, 1] = np.nan
    disparity[2, 2] = np.inf
    disparity[3, 3] = -np.inf
    m = eval_fullscale.score(disparity, gt)
    assert m["nonfinite"] == 3
    for key in ("bad_0.5", "bad_1.0", "bad_2.0", "bad_4.0"):
        assert m[key] == pytest.approx(3 / 19)
    assert np.isfinite(m["avg_err"])
    # the shared copy still scores the NaN as good, as the original does
    plain = evaluate_pair(disparity, gt)
    assert plain["bad_2.0"] == pytest.approx(2 / 19)
    np.testing.assert_equal(plain, jax_evaluate_pair(disparity, gt))


# --- eval_fullscale -------------------------------------------------------------


def test_eval_fullscale_rows_equal_evaluate_pair(family_maps, capsys):
    result = eval_fullscale.main([
        "--device", "cpu", "--weights", "random", "--families",
        "translation,slanted", "--height", str(HEIGHT), "--width",
        str(WIDTH), "--max-disparity", str(MAX_DISPARITY)])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == result
    assert result["shape"] == [HEIGHT, WIDTH, MAX_DISPARITY + 2]
    modes = [(row["family"], row["mode"]) for row in result["results"]]
    assert modes == [("translation", "fast-bf16"),
                     ("translation", "exact-f32"),
                     ("slanted", "fast-bf16")]
    for row in result["results"]:
        gt, fast, exact = family_maps[row["family"]]
        want = evaluate_pair(fast if row["mode"] == "fast-bf16" else exact,
                             gt)
        for key in ("bad_0.5", "bad_1.0", "bad_2.0", "bad_4.0", "avg_err"):
            assert row[key] == want[key], (row, key)
        assert row["nonfinite"] == 0


def test_eval_fullscale_refuses_unreadable_weights(tmp_path):
    with pytest.raises(FileNotFoundError):
        eval_fullscale.main(["--device", "cpu", "--weights",
                             str(tmp_path / "missing.npz")])


# --- train_fullscale --------------------------------------------------------------


@pytest.mark.parametrize("family", eval_fullscale.FAMILIES)
def test_scene_files_equal_jax_writer(tmp_path, family):
    from PIL import Image

    jax_tool = _jax_tool("train_fullscale")
    for writer, where in ((jax_tool.write_scene_files, "jax"),
                          (train_fullscale.write_scene_files, "port")):
        writer(str(tmp_path / where), family, np.random.default_rng(7), 32,
               40, 8, 0.25)
    for name in ("im0.png", "im1.png"):
        with Image.open(tmp_path / "jax" / name) as a, \
                Image.open(tmp_path / "port" / name) as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(read_pfm(str(tmp_path / "jax/disp0GT.pfm")),
                                  read_pfm(str(tmp_path / "port/disp0GT.pfm")))


def test_train_fullscale_trains_and_scores(tmp_path, family_maps, capsys,
                                           monkeypatch):
    """Two epochs on two 128 x 128 scenes (the trainer's batch of 128
    draws distinct anchor rows and columns, so no smaller scene takes it),
    then both evaluations at the eval size; the random-init rows equal the
    fast maps above (the same weights, scenes and schedule)."""
    # two families keep the evaluations short, and the metrics logger's
    # TensorBoard writer (which imports tensorflow: seconds) stays off
    monkeypatch.setattr(eval_fullscale, "FAMILIES",
                        eval_fullscale.FAMILIES[:2])
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    out = train_fullscale.run([
        "--device", "cpu", "--epochs", "2", "--scenes", "2", "--height",
        "128", "--width", "128", "--max-disparity", "8", "--noise", "0",
        "--out", str(tmp_path), "--eval-height", str(HEIGHT),
        "--eval-width", str(WIDTH), "--eval-max-disparity",
        str(MAX_DISPARITY)])
    printed = capsys.readouterr().out
    assert (tmp_path / "ckpt" / "model_epoch2.npz").exists()
    assert "| family | self-trained bad-2.0 | random-init bad-2.0 |" in printed
    assert out["steps_per_s"] > 0
    trained = out["results"]["self-trained"]["results"]
    random_init = out["results"]["random-init"]["results"]
    assert [r["family"] for r in trained] == ["translation", "slanted"]
    assert [r["mode"] for r in trained + random_init] == ["fast-bf16"] * 4
    for row in random_init:
        gt, fast, _ = family_maps[row["family"]]
        assert row["bad_2.0"] == evaluate_pair(fast, gt)["bad_2.0"]
    worse = sum(mine["bad_2.0"] > theirs["bad_2.0"] + 0.005
                for mine, theirs in zip(trained, random_init))
    assert out["worse"] == worse


# --- parity_eval ------------------------------------------------------------------


def test_parity_eval_one_shift_and_one_family(rng):
    from test_parity_metrics import _textured_pair

    np.testing.assert_array_equal(
        np.stack(parity_eval.textured_pair(np.random.default_rng(5))),
        np.stack(_textured_pair(np.random.default_rng(5))))
    results = parity_eval.run("cpu", shifts=(2,), families=("occlusion",),
                              log=lambda line: None)
    assert sorted(results) == ["occlusion", "shift 2"]
    for scene, scores in results.items():
        assert sorted(scores) == sorted(parity_eval.PIPELINES)
        assert parity_eval.worst_delta(scores) <= parity_eval.BUDGET, (
            scene, scores)
