"""The port's WTA, LR check, subpixel and filters against JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.ops import filters as tfilters  # noqa: E402
from mccnn_tpu_torch.ops import lr_check as tlr  # noqa: E402
from mccnn_tpu_torch.ops.subpixel import subpixel_enhance  # noqa: E402
from mccnn_tpu_torch.ops.wta import wta_disparity  # noqa: E402

from torch_parity import jitted, scene_pair  # noqa: E402

jfilters = importlib.import_module("mccnn_tpu.ops.filters")
jlr = importlib.import_module("mccnn_tpu.ops.lr_check")
jsub = importlib.import_module("mccnn_tpu.ops.subpixel")
jwta = importlib.import_module("mccnn_tpu.ops.wta")
# the JAX functions, each compiled once per shape and static arguments
jax_wta = jitted(jwta.wta_disparity)
jax_classify = jitted(jlr.classify, "ndisp")
jax_lr_interpolate = jitted(jlr.lr_consistency_interpolate, "ndisp")
jax_interpolate = jitted(jlr.interpolate)
jax_subpixel = jitted(jsub.subpixel_enhance, "ndisp")
jax_median = jitted(jfilters.median_filter, "filter_height", "filter_width")
jax_bilateral = jitted(jfilters.bilateral_filter, "filter_height",
                       "filter_width", "mean", "sigma", "threshold")

NDISP = 12


def _volume(rng, height=20, width=30, d_pad=128):
    # costs on a coarse grid so many fibres hold tied minima
    vol = rng.integers(0, 4, (height, width, d_pad)).astype(np.float32)
    vol[..., NDISP:] = BIG_COST
    return vol


def _disparities(rng, height=20, width=30):
    left = rng.integers(0, NDISP, (height, width)).astype(np.float32)
    right = rng.integers(0, NDISP, (height, width)).astype(np.float32)
    # make a share of pixels consistent so all three classes appear
    cols = np.arange(width)[None, :]
    src = np.clip(cols - left.astype(int), 0, width - 1)
    agree = rng.random((height, width)) < 0.5
    right_at = np.take_along_axis(right, src, axis=1)
    right_at[agree] = left[agree]
    np.put_along_axis(right, src, right_at, axis=1)
    return left, right


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wta_first_occurrence_on_ties(rng, dtype):
    vol = _volume(rng)
    assert (vol[..., :NDISP] == vol[..., :NDISP].min(-1, keepdims=True)
            ).sum(-1).max() > 1  # ties are present
    tdtype = getattr(torch, dtype)
    got = wta_disparity(torch.from_numpy(vol).to(tdtype))
    want = jax_wta(jnp.asarray(vol, getattr(jnp, dtype)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_classify_and_interpolate_match_jax(rng):
    left, right = _disparities(rng)
    got_status = tlr.classify(torch.from_numpy(left),
                              torch.from_numpy(right), NDISP)
    want_status = jax_classify(jnp.asarray(left), jnp.asarray(right), NDISP)
    np.testing.assert_array_equal(got_status.numpy(),
                                  np.asarray(want_status))
    assert set(np.unique(got_status.numpy())) == {0, 1, 2}
    got = tlr.lr_consistency_interpolate(torch.from_numpy(left),
                                         torch.from_numpy(right), NDISP)
    want = jax_lr_interpolate(jnp.asarray(left), jnp.asarray(right),
                              NDISP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interpolate_fills_from_the_right(rng):
    status = np.full((3, 6), 0, np.int32)
    status[:, 2] = 2  # occlusions take the nearest match to the right
    status[:, 5] = 2  # ... or keep their value when there is none
    disp = np.arange(18, dtype=np.float32).reshape(3, 6)
    got = tlr.interpolate(torch.from_numpy(disp), torch.from_numpy(status))
    want = jax_interpolate(jnp.asarray(disp), jnp.asarray(status))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, 2], disp[:, 3])
    np.testing.assert_array_equal(got.numpy()[:, 5], disp[:, 5])


def test_subpixel_f32_matches_jax(rng):
    vol = rng.uniform(-1, 1, (20, 30, 128)).astype(np.float32)
    vol[..., NDISP:] = BIG_COST
    disp = rng.uniform(0, NDISP, (20, 30)).astype(np.float32)
    disp[0, :5] = [0.0, 0.5, 1.0, NDISP - 1.0, NDISP - 1.5]
    vol[1, 1, :3] = [1.0, 2.0, 3.0]  # a degenerate (straight-line) fit
    disp[1, 1] = 1.0
    got = subpixel_enhance(torch.from_numpy(disp), torch.from_numpy(vol),
                           NDISP)
    want = jax_subpixel(jnp.asarray(disp), jnp.asarray(vol), NDISP)
    # one f32 division in another rounding path at most
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert got[1, 1] == 1.0


def test_subpixel_may_leave_the_search_range_as_in_jax():
    """The fit is unbounded where d is not a cost minimum (an LR-filled
    pixel): both packages then move d outside [0, ndisp) alike."""
    vol = np.zeros((1, 2, 128), np.float32)
    vol[..., NDISP:] = BIG_COST
    vol[0, 0, :3] = [0.0, 1.0, 2.01]  # rising through d = 1
    vol[0, 1, NDISP - 3:NDISP] = [2.01, 1.0, 0.0]  # falling through ndisp-2
    disp = np.array([[1.0, NDISP - 2.0]], np.float32)
    got = subpixel_enhance(torch.from_numpy(disp), torch.from_numpy(vol),
                           NDISP).numpy()
    want = np.asarray(jax_subpixel(jnp.asarray(disp), jnp.asarray(vol),
                                   NDISP))
    # delta = +-2.01 / 0.02: one f32 division in another rounding path
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0, 0] < -90 and got[0, 1] > NDISP + 90


def test_subpixel_bf16_volume_matches_jax(rng):
    """On a bf16 volume the fit runs in bf16, as in JAX."""
    vol = rng.uniform(-1, 1, (20, 30, 128)).astype(np.float32)
    vol[..., NDISP:] = BIG_COST
    disp = rng.integers(1, NDISP - 1, (20, 30)).astype(np.float32)
    got = subpixel_enhance(torch.from_numpy(disp),
                           torch.from_numpy(vol).to(torch.bfloat16), NDISP)
    want = jax_subpixel(jnp.asarray(disp), jnp.asarray(vol, jnp.bfloat16),
                        NDISP)
    assert got.dtype == torch.float32
    delta_got = disp - got.numpy()
    delta_want = disp - np.asarray(want)
    # the correction is a bf16 value: the port rounds after every bf16
    # operation, XLA on the CPU may keep f32 between them, so the two may
    # differ by a few bf16 ulps of the correction (2^-8 relative each)
    np.testing.assert_allclose(delta_got, delta_want,
                               atol=1e-3, rtol=4 * 2.0 ** -8)


def test_median_and_bilateral_match_jax(rng):
    image, _, _, _ = scene_pair("occlusion", 20, 30)
    disp = rng.uniform(0, NDISP, (20, 30)).astype(np.float32)
    got = tfilters.median_filter(torch.from_numpy(disp), 5, 5)
    want = jax_median(jnp.asarray(disp), 5, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tfilters.bilateral_filter(torch.from_numpy(image),
                                    torch.from_numpy(disp), 5, 5, 0.0, 6.0,
                                    0.5)
    want = jax_bilateral(jnp.asarray(image), jnp.asarray(disp), 5, 5, 0.0,
                         6.0, 0.5)
    # weighted means of <= 25 terms summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
