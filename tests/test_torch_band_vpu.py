"""``band_pair_pallas`` of the port against the JAX package's, the
multiply-reduce path (``use_mxu=False``, kernel K6) in particular.

On the CPU the port runs ``band_pair_scores_plain``; JAX runs its VPU
kernel in interpret mode with small tiles, as its own tests do. Both sum 64
f32 products per score, in another order: atol 1e-5 on unit descriptors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops.cost_volume_pallas import (  # noqa: E402
    band_pair_pallas as jax_band_pair_pallas,
)
from mccnn_tpu_torch.ops import cost_volume as tcv  # noqa: E402
from mccnn_tpu_torch.ops.common import BIG_COST  # noqa: E402

from torch_parity import jitted, unit_features  # noqa: E402

HEIGHT, WIDTH, D_PAD = 6, 20, 8
# JAX's bands, compiled once per shape and static arguments
jax_bands = jitted(jax_band_pair_pallas, "d_pad", "tile_h", "tile_w", "tile_d",
                   "interpret", "use_mxu", "sides", "finalize_ndisp",
                   "out_dtype")
TILES = {"tile_h": 2, "tile_w": 8, "tile_d": 4, "interpret": True}


@pytest.fixture()
def features(rng):
    return unit_features(rng, HEIGHT, WIDTH), unit_features(rng, HEIGHT,
                                                            WIDTH)


def test_vpu_bands_match_jax_and_direct_dots(features):
    fl, fr = features
    left, right = tcv.band_pair_pallas(torch.from_numpy(fl),
                                       torch.from_numpy(fr), D_PAD,
                                       use_mxu=False)
    want_l, want_r = jax_bands(jnp.asarray(fl), jnp.asarray(fr), D_PAD,
                               use_mxu=False, **TILES)
    assert left.shape == right.shape == (HEIGHT, WIDTH, D_PAD)
    assert left.dtype == torch.float32
    np.testing.assert_allclose(left.numpy(), np.asarray(want_l), atol=1e-5)
    np.testing.assert_allclose(right.numpy(), np.asarray(want_r), atol=1e-5)
    # raw scores: <fL(w), fR(w - d)>, 0 out of range, no BIG lanes
    for w, d in ((7, 3), (2, 5), (19, 0)):
        want = np.sum(fl[:, w] * fr[:, w - d], -1) if w >= d else 0.0
        np.testing.assert_allclose(left.numpy()[:, w, d], want, atol=1e-5)
        want = np.sum(fr[:, w] * fl[:, w + d], -1) if w + d < WIDTH else 0.0
        np.testing.assert_allclose(right.numpy()[:, w, d], want, atol=1e-5)


def test_vpu_out_dtype_casts_the_scores(features):
    fl, fr = features
    left, right = tcv.band_pair_pallas(
        torch.from_numpy(fl), torch.from_numpy(fr), D_PAD, use_mxu=False,
        out_dtype=torch.bfloat16)
    want_l, want_r = jax_bands(
        jnp.asarray(fl), jnp.asarray(fr), D_PAD, use_mxu=False,
        out_dtype=jnp.bfloat16, **TILES)
    assert left.dtype == right.dtype == torch.bfloat16
    # |score| <= 1: one bf16 step (2^-8) where the f32 sums round apart
    for got, want in ((left, want_l), (right, want_r)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            atol=2.0 ** -8)


@pytest.mark.parametrize("sides", ["both", "left", "right"])
@pytest.mark.parametrize("finalize", [None, 5])
def test_mxu_route_matches_jax(features, sides, finalize):
    """``use_mxu=True`` routes to K1 / K5 (their plain versions here): raw
    scores without ``finalize_ndisp``, cost volumes with it."""
    fl, fr = features
    got = tcv.band_pair_pallas(torch.from_numpy(fl), torch.from_numpy(fr),
                               D_PAD, sides=sides, finalize_ndisp=finalize)
    want = jax_bands(jnp.asarray(fl), jnp.asarray(fr), D_PAD, sides=sides,
                     finalize_ndisp=finalize, **TILES)
    if sides != "both":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for ours, theirs in zip(got, want):
        ours, theirs = ours.numpy(), np.asarray(theirs)
        real = slice(0, finalize or D_PAD)
        np.testing.assert_allclose(ours[..., real], theirs[..., real],
                                   atol=1e-5)
        if finalize:
            assert np.all(ours[..., finalize:] == np.float32(BIG_COST))
            assert np.all(theirs[..., finalize:] == np.float32(BIG_COST))


def test_the_two_errors_of_the_jax_function(features):
    fl, fr = (torch.from_numpy(f) for f in features)
    jl, jr = (jnp.asarray(f) for f in features)
    with pytest.raises(ValueError, match="finalize_ndisp requires"):
        tcv.band_pair_pallas(fl, fr, D_PAD, use_mxu=False, finalize_ndisp=5)
    with pytest.raises(ValueError, match="finalize_ndisp requires"):
        jax_band_pair_pallas(jl, jr, D_PAD, use_mxu=False, finalize_ndisp=5,
                             **TILES)
    for side in ("left", "right"):
        with pytest.raises(ValueError, match="single-side bands require"):
            tcv.band_pair_pallas(fl, fr, D_PAD, use_mxu=False, sides=side)
        with pytest.raises(ValueError, match="single-side bands require"):
            jax_band_pair_pallas(jl, jr, D_PAD, use_mxu=False, sides=side,
                                 **TILES)
    with pytest.raises(ValueError):
        tcv.band_pair_pallas(fl, fr, D_PAD, sides="top")


def test_negated_scores_equal_the_finalized_band(features):
    """The identity K6 is held to on the card: -scores == K5's finalized
    bands of ndisp = d_pad (here between the two plain versions)."""
    fl, fr = (torch.from_numpy(f) for f in features)
    scores = tcv.band_pair_scores_plain(fl, fr, D_PAD)
    costs = tcv.band_pair_plain(fl, fr, D_PAD, D_PAD, torch.float32)
    for score, cost in zip(scores, costs):
        torch.testing.assert_close(-score, cost, rtol=0, atol=0)
