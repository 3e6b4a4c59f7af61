"""The port's own copies of the numpy-only modules against the JAX package's.

``mccnn_tpu_torch`` imports nothing of ``mccnn_tpu``; it keeps copies of
the configs, the scene generator, the scores, the Middlebury file formats
and the training data path (dataset, triplet sampler, prefetcher). These
tests hold each copy to the original on the same inputs, so configs, scene
directories, artifacts and batch streams stay interchangeable.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

PAIRS = {
    name: (importlib.import_module(f"mccnn_tpu.{name}"),
           importlib.import_module(f"mccnn_tpu_torch.{name}"))
    for name in ("utils.config", "utils.scenes", "utils.evaluate",
                 "utils.metrics", "io.pfm", "io.calib", "io.middlebury",
                 "data.dataset", "data.sampler", "data.prefetch",
                 "parallel.multihost")
}


@pytest.mark.parametrize("name", ["MatchConfig", "NetConfig", "TrainConfig"])
def test_config_fields_equal(name):
    theirs, ours = (getattr(m, name) for m in PAIRS["utils.config"])
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(theirs)] \
        == [(f.name, f.type, f.default) for f in dataclasses.fields(ours)]
    # a config of one package drives the other: same fields, same values
    assert dataclasses.asdict(theirs()) == dataclasses.asdict(ours())
    if name == "MatchConfig":
        moved = ours(**dataclasses.asdict(theirs(sgm_chunk=1, sgm_p1=1.5)))
        assert moved.sgm_chunk == 1 and moved.replace(sgm_p1=2.0).sgm_p1 == 2.0
    if name == "NetConfig":
        assert theirs().receptive_field == ours().receptive_field == 10


@pytest.mark.parametrize("family", ["translation", "slanted", "occlusion",
                                    "textureless", "photo"])
def test_make_scene_arrays_equal(family):
    theirs, ours = PAIRS["utils.scenes"]
    assert theirs.SCENE_FAMILIES == ours.SCENE_FAMILIES
    want = theirs.make_scene(family, np.random.default_rng(3), 40, 72, 9)
    got = ours.make_scene(family, np.random.default_rng(3), 40, 72, 9)
    assert sorted(want) == sorted(got)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value)
        else:
            assert got[key] == value


def test_scene_pair_helper_equal():
    theirs, ours = PAIRS["utils.scenes"]
    want = theirs.scene_pair("slanted", np.random.default_rng(2), 24, 40, 6)
    got = ours.scene_pair("slanted", np.random.default_rng(2), 24, 40, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pfm_bytes_and_round_trip(tmp_path, rng):
    theirs, ours = PAIRS["io.pfm"]
    disparity = rng.uniform(0, 60, (13, 21)).astype(np.float32)
    theirs.write_pfm(disparity, str(tmp_path / "jax.pfm"))
    ours.write_pfm(disparity, str(tmp_path / "port.pfm"))
    assert (tmp_path / "jax.pfm").read_bytes() == \
        (tmp_path / "port.pfm").read_bytes()
    # each package reads the other's file
    np.testing.assert_array_equal(ours.read_pfm(str(tmp_path / "jax.pfm")),
                                  disparity)
    np.testing.assert_array_equal(theirs.read_pfm(str(tmp_path / "port.pfm")),
                                  disparity)
    with pytest.raises(ValueError):
        ours.write_pfm(disparity, str(tmp_path / "big.pfm"), scale=1.0)


def test_pgm_and_time_file_bytes_equal(tmp_path, rng):
    theirs, ours = PAIRS["io.middlebury"]
    disparity = rng.uniform(-2, 300, (11, 17)).astype(np.float32)
    theirs.save_disparity_pgm(disparity, str(tmp_path / "jax.pgm"))
    ours.save_disparity_pgm(disparity, str(tmp_path / "port.pgm"))
    assert (tmp_path / "jax.pgm").read_bytes() == \
        (tmp_path / "port.pgm").read_bytes()
    theirs.save_time_file(1.25, str(tmp_path / "jax.txt"))
    ours.save_time_file(1.25, str(tmp_path / "port.txt"))
    assert (tmp_path / "jax.txt").read_text() == \
        (tmp_path / "port.txt").read_text()


def test_scene_paths_and_dirs_equal(tmp_path):
    theirs, ours = PAIRS["io.middlebury"]
    left = str(tmp_path / "data" / "trainingH" / "Adirondack" / "im0.png")
    args = (left, str(tmp_path / "data"), str(tmp_path / "out"), "run7")
    want = theirs.derive_scene_paths(*args)
    got = ours.derive_scene_paths(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ours.ensure_dirs(got)
    for path in (got.out_pfm, got.out_pgm, got.out_time):
        assert os.path.isdir(os.path.dirname(path))


@pytest.mark.parametrize("text", [
    "cam0=[1 0 0]\ncam1=[1 0 0]\ndoffs=0\nbaseline=100\nwidth=40\n"
    "height=24\nndisp=6\n",
    "ndisp=290\nheight=1988\nwidth=2964\n",
])
def test_parse_calib_equal(tmp_path, text):
    theirs, ours = PAIRS["io.calib"]
    path = tmp_path / "calib.txt"
    path.write_text(text)
    assert ours.parse_calib(str(path)) == theirs.parse_calib(str(path))


def test_scores_equal(rng):
    theirs, ours = PAIRS["utils.evaluate"]
    gt = rng.uniform(0, 50, (20, 30)).astype(np.float32)
    gt[2, 3] = np.inf  # Middlebury marks unknown ground truth so
    pred = gt + rng.normal(0, 2, gt.shape).astype(np.float32)
    pred[2, 3] = 7.0
    mask = rng.random(gt.shape) > 0.3
    for threshold in (0.5, 1.0, 2.0, 4.0):
        assert ours.bad_n(pred, gt, threshold) == \
            theirs.bad_n(pred, gt, threshold)
    want, got = theirs.evaluate_pair(pred, gt), ours.evaluate_pair(pred, gt)
    assert got == want
    total_t, total_o = {}, {}
    for _ in range(2):
        theirs.merge_counts(total_t, theirs.evaluate_counts(pred, gt, mask=mask))
        ours.merge_counts(total_o, ours.evaluate_counts(pred, gt, mask=mask))
    assert ours.summarize_counts(total_o) == theirs.summarize_counts(total_t)


def test_metrics_logger_lines_equal(tmp_path, capsys):
    theirs, ours = PAIRS["utils.metrics"]
    lines = []
    for module, name in ((theirs, "jax.jsonl"), (ours, "port.jsonl")):
        logger = module.MetricsLogger(str(tmp_path / name), echo=False)
        logger.log(step=3, event="done", seconds=0.5)
        logger.close()
        record = json.loads((tmp_path / name).read_text())
        assert record.pop("time") > 0
        lines.append(record)
    assert lines[0] == lines[1]
    assert lines[0]["event"] == "done"


def test_load_grayscale_equal(tmp_path, rng):
    from PIL import Image

    theirs, ours = PAIRS["data.dataset"]
    rgb = (rng.random((9, 14, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb, mode="RGB").save(tmp_path / "im.png")
    got = ours.load_grayscale(str(tmp_path / "im.png"))
    np.testing.assert_array_equal(
        got, theirs.load_grayscale(str(tmp_path / "im.png")))
    assert got.dtype == np.float32 and got.shape == (9, 14)


def _training_lists(tmp_path, rng):
    from torch_parity import write_training_scenes

    return write_training_scenes(tmp_path, rng, count=3, height=32, width=40)


def test_standardize_and_dataset_equal(tmp_path, rng):
    theirs, ours = PAIRS["data.dataset"]
    image = rng.uniform(0, 255, (9, 13)).astype(np.float32)
    np.testing.assert_array_equal(ours.standardize(image),
                                  theirs.standardize(image))
    train = str(_training_lists(tmp_path, rng) / "train.txt")
    want = theirs.StereoDataset(train, shuffle=True, seed=3)
    got = ours.StereoDataset(train, shuffle=True, seed=3)
    assert len(got) == len(want) == 3
    for _ in range(2):
        for index in range(len(want)):
            for a, b in zip(got.get(index), want.get(index)):
                np.testing.assert_array_equal(a, b)
        got.reshuffle()
        want.reshuffle()
    for a, b in zip(got.next_pair(), want.next_pair()):
        np.testing.assert_array_equal(a, b)


def _samplers(tmp_path, rng, **kw):
    """The JAX and the port sampler on the same list, shuffle and seed."""
    data, sampler = PAIRS["data.dataset"], PAIRS["data.sampler"]
    train = str(_training_lists(tmp_path, rng) / "train.txt")
    return [s.TripletSampler(d.StereoDataset(train, shuffle=True, seed=7),
                             seed=5, **kw)
            for d, s in zip(data, sampler)]


def _batches(feed, epochs=2, epoch_len=3, batch_size=8):
    out = []
    for _ in range(epochs):
        out += [feed.next_batch(batch_size) for _ in range(epoch_len)]
        feed.reset()
    return out


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == (8, 11, 11, 1) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_triplet_sampler_numpy_stream_equal(tmp_path, rng):
    """One seed, the same batches bit for bit, across a reshuffle."""
    theirs, ours = _samplers(tmp_path, rng)
    assert ours.backend == theirs.backend == "numpy"
    _assert_streams_equal(_batches(ours), _batches(theirs))


def test_prefetcher_stream_equal(tmp_path, rng):
    """The port's prefetcher gives the JAX prefetcher's stream, which is
    the synchronous sampler's, across ``reset()``."""
    (theirs_prefetch, ours_prefetch) = PAIRS["data.prefetch"]
    theirs, ours = _samplers(tmp_path, rng)
    with theirs_prefetch.BatchPrefetcher(theirs, 8, epoch_len=3) as feed:
        want = _batches(feed)
    with ours_prefetch.BatchPrefetcher(ours, 8, epoch_len=3) as feed:
        got = _batches(feed)
    _assert_streams_equal(got, want)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 7])
def test_process_slice_and_shard_scenes_equal(count):
    """The strided assignment, for every rank of ``count`` processes."""
    theirs, ours = PAIRS["parallel.multihost"]
    scenes = [f"s{i}" for i in range(11)]
    for num in (0, 1, 5, 11):
        for rank in range(count):
            assert ours.process_slice(num, rank, count) == \
                theirs.process_slice(num, rank, count)
            assert ours.shard_scenes(scenes[:num], rank, count) == \
                theirs.shard_scenes(scenes[:num], rank, count)
