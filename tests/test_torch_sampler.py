"""mccnn_tpu_torch's triplet sampler: its native backend against the JAX
package's, its prefetcher against its synchronous stream, and the refusals.

Both packages bind the same C++ library (``native/``). Each test here builds
it once into a temporary directory and points both bindings there, so no
test rewrites the repository's copy while another worker loads it.
"""

import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from mccnn_tpu import native as jnative  # noqa: E402
from mccnn_tpu.data import dataset as jdataset  # noqa: E402
from mccnn_tpu.data import sampler as jsampler  # noqa: E402
from mccnn_tpu_torch import native as tnative  # noqa: E402
from mccnn_tpu_torch.data.dataset import StereoDataset  # noqa: E402
from mccnn_tpu_torch.data.prefetch import BatchPrefetcher  # noqa: E402
from mccnn_tpu_torch.data.sampler import TripletSampler  # noqa: E402

from torch_parity import write_training_scenes  # noqa: E402


@pytest.fixture(scope="module")
def native_dir(tmp_path_factory):
    """The native sources copied and built in a directory of their own."""
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no C++ toolchain to build the native sampler")
    directory = tmp_path_factory.mktemp("native")
    for name in ("Makefile", "host_sampler.cc"):
        shutil.copy(f"{tnative._NATIVE_DIR}/{name}", directory)
    return directory


@pytest.fixture
def both_native(native_dir, monkeypatch):
    """Both bindings on the library built in ``native_dir``."""
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.ensure_built()
    monkeypatch.setattr(jnative, "_NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(jnative, "_LIB_PATH",
                        str(native_dir / "libmccnn_host.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.available()


@pytest.fixture
def train_list(tmp_path, rng):
    return str(write_training_scenes(tmp_path, rng, count=3) / "train.txt")


def _stream(sampler, epochs=2, epoch_len=3, batch_size=8):
    out = []
    for _ in range(epochs):
        out += [sampler.next_batch(batch_size) for _ in range(epoch_len)]
        sampler.reset()
    return out


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == (8, 11, 11, 1) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_native_backend_equals_jax_native(both_native, train_list):
    ours = TripletSampler(StereoDataset(train_list, shuffle=True, seed=2),
                          seed=9, backend="native")
    theirs = jsampler.TripletSampler(
        jdataset.StereoDataset(train_list, shuffle=True, seed=2), seed=9,
        backend="native")
    assert ours.backend == theirs.backend == "native"
    _assert_streams_equal(_stream(ours), _stream(theirs))
    assert TripletSampler(StereoDataset(train_list), backend="auto"
                          ).backend == "native"


def test_native_binding_equals_jax(both_native, rng):
    gt = rng.uniform(0, 12, (40, 60)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.15] = np.inf
    got = tnative.sample_triplets(gt, 16, 1234, 0.5, 1.5, 6.0)
    want = jnative.sample_triplets(gt, 16, 1234, 0.5, 1.5, 6.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rows, cols = got[0], got[1]
    assert np.isfinite(gt[rows, cols]).all()
    image = rng.standard_normal((40, 60)).astype(np.float32)
    patches = tnative.extract_patches(image, rows, cols, 11)
    np.testing.assert_array_equal(
        patches, jnative.extract_patches(image, rows, cols, 11))
    padded = np.pad(image, 5)
    np.testing.assert_array_equal(patches[3], padded[rows[3]:rows[3] + 11,
                                                     cols[3]:cols[3] + 11])
    with pytest.raises(ValueError, match="exceeds image dims"):
        tnative.sample_triplets(gt, 61, 0, 0.5, 1.5, 6.0)
    with pytest.raises(ValueError, match="no valid anchor"):
        tnative.sample_triplets(np.full((20, 20), np.inf, np.float32), 4, 0,
                                0.5, 1.5, 6.0)


def test_explicit_native_request_that_cannot_build_raises(
        tmp_path, monkeypatch, train_list):
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(tnative, "_lib", None)
    dataset = StereoDataset(train_list)
    with pytest.raises(RuntimeError, match="not buildable"):
        TripletSampler(dataset, backend="native")
    assert TripletSampler(dataset, backend="auto").backend == "numpy"
    with pytest.raises(RuntimeError, match="not built"):
        tnative.extract_patches(np.zeros((4, 4), np.float32),
                                np.zeros(1, np.int64), np.zeros(1, np.int64),
                                3)


def test_prefetcher_equals_synchronous_stream(train_list):
    sync = TripletSampler(StereoDataset(train_list, shuffle=True, seed=7),
                          seed=5)
    want = _stream(sync)
    sampler = TripletSampler(StereoDataset(train_list, shuffle=True, seed=7),
                             seed=5)
    with BatchPrefetcher(sampler, 8, epoch_len=3, depth=2) as feed:
        got = _stream(feed)
    _assert_streams_equal(got, want)


def test_prefetcher_rejects_early_reset_and_wrong_batch(train_list):
    sampler = TripletSampler(StereoDataset(train_list), seed=0)
    with BatchPrefetcher(sampler, 8, epoch_len=2, depth=2) as feed:
        with pytest.raises(ValueError):
            feed.next_batch(16)
        feed.next_batch(8)
        with pytest.raises(RuntimeError, match="before consuming"):
            feed.reset()
        feed.next_batch(8)
        feed.reset()
        feed.next_batch(8)
    with pytest.raises(ValueError):
        BatchPrefetcher(sampler, 8, epoch_len=0)
