"""The port's cost volume (K1's plain version + border fills) against JAX.

The JAX side runs the Pallas band kernel in interpret mode (as
tests/test_cost_volume.py runs it on the CPU), the XLA matmul path and the
numpy oracle.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu.ops.cost_volume import cost_volume_pair  # noqa: E402
from mccnn_tpu_torch.ops import cost_volume as tcv  # noqa: E402

from oracles import cost_volume_oracle  # noqa: E402
from torch_parity import jitted, unit_features  # noqa: E402

# JAX's cost volume, compiled once per shape and static arguments
jax_cvp = jitted(cost_volume_pair, "ndisp", "method", "sides", "dtype")

# |cost| <= 1 for unit descriptors: f32 sums in another order agree to a
# few ulps (1e-5); bf16 results may round to neighbouring bf16 values
# (one ulp at |v| <= 1 is 2^-8; two allowed for the fills' double rounding)
F32_ATOL = 1e-5
BF16_ATOL = 2 * 2.0 ** -8

_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _features(rng, height=6, width=40):
    return unit_features(rng, height, width), unit_features(rng, height, width)


def _port(fl, fr, ndisp, sides, dtype):
    tl, tr = torch.from_numpy(fl), torch.from_numpy(fr)
    if dtype == torch.bfloat16:  # the pipeline hands K1 bf16 descriptors
        tl, tr = tl.to(dtype), tr.to(dtype)
    return tcv.cost_volume_pair(tl, tr, ndisp, sides=sides, dtype=dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("side", ["left", "right"])
def test_side_matches_pallas_band(rng, side, dtype):
    ndisp = 12
    fl, fr = _features(rng)
    tdtype, jdtype = _DTYPES[dtype]
    got = _np(_port(fl, fr, ndisp, side, tdtype))
    want = _np(jax_cvp(jnp.asarray(fl), jnp.asarray(fr), ndisp,
                       method="pallas", sides=side, dtype=jdtype))
    assert got.shape == want.shape == (6, 40, 128)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got[..., :ndisp], want[..., :ndisp], atol=atol)
    # pad lanes hold BIG_COST exactly (in the storage type)
    np.testing.assert_array_equal(got[..., ndisp:], want[..., ndisp:])
    assert np.all(got[..., ndisp:] == _np(torch.tensor(BIG_COST, dtype=tdtype)))


def test_pair_matches_matmul_path_and_oracle(rng):
    ndisp = 9
    fl, fr = _features(rng, 5, 33)
    left, right = _port(fl, fr, ndisp, "both", torch.float32)
    want_l, want_r = jax_cvp(jnp.asarray(fl), jnp.asarray(fr), ndisp,
                             method="matmul")
    np.testing.assert_allclose(left.numpy(), np.asarray(want_l),
                               atol=F32_ATOL)
    np.testing.assert_allclose(right.numpy(), np.asarray(want_r),
                               atol=F32_ATOL)
    oracle_l, oracle_r = cost_volume_oracle(fl, fr, ndisp)
    np.testing.assert_allclose(np.moveaxis(left.numpy()[..., :ndisp], -1, 0),
                               oracle_l, atol=F32_ATOL)
    np.testing.assert_allclose(np.moveaxis(right.numpy()[..., :ndisp], -1, 0),
                               oracle_r, atol=F32_ATOL)


@pytest.mark.parametrize("side", ["left", "right"])
def test_plain_band_before_fills(rng, side):
    """K1's contract: -score in range, 0 out of range, BIG in pad lanes."""
    ndisp, d_pad = 7, 128
    fl, fr = _features(rng, 3, 20)
    anchor, other = (fl, fr) if side == "left" else (fr, fl)
    got = tcv.band_side_plain(torch.from_numpy(anchor),
                              torch.from_numpy(other), ndisp, d_pad, side,
                              torch.float32).numpy()
    want = np.full((3, 20, d_pad), BIG_COST, np.float32)
    for d in range(ndisp):
        for w in range(20):
            src = w - d if side == "left" else w + d
            want[:, w, d] = (-np.sum(anchor[:, w] * other[:, src], axis=-1)
                             if 0 <= src < 20 else 0.0)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_narrow_image_fills_clip_at_the_edge(rng):
    """ndisp close to the width: the fills average fewer than 3 columns."""
    ndisp = 8
    fl, fr = _features(rng, 4, 9)
    left, right = _port(fl, fr, ndisp, "both", torch.float32)
    with warnings.catch_warnings():
        # the oracle's right-edge mean over an empty slice; left is unaffected
        warnings.simplefilter("ignore", RuntimeWarning)
        oracle_l, _ = cost_volume_oracle(fl, fr, ndisp)
    np.testing.assert_allclose(np.moveaxis(left.numpy()[..., :ndisp], -1, 0),
                               oracle_l, atol=F32_ATOL)
    want_l, want_r = jax_cvp(jnp.asarray(fl), jnp.asarray(fr), ndisp,
                             method="matmul")
    np.testing.assert_allclose(left.numpy(), np.asarray(want_l),
                               atol=F32_ATOL)
    np.testing.assert_allclose(right.numpy(), np.asarray(want_r),
                               atol=F32_ATOL)


def test_rejects_bad_arguments(rng):
    fl, fr = _features(rng, 2, 8)
    with pytest.raises(ValueError):
        _port(fl, fr, 9, "left", torch.float32)  # ndisp > width
    with pytest.raises(ValueError):
        _port(fl, fr, 4, "up", torch.float32)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("method", ["matmul", "rolldot", "pallas"])
def test_both_sides_match_jax_method_by_method(rng, method, dtype):
    """``sides="both"`` (K5's plain version for the band methods) and the
    torch-op ``matmul`` / ``rolldot`` paths against JAX with the same
    method; JAX runs the both-sides Pallas kernel in interpret mode."""
    ndisp = 12
    fl, fr = _features(rng)
    tdtype, jdtype = _DTYPES[dtype]
    tl, tr = torch.from_numpy(fl), torch.from_numpy(fr)
    if method == "pallas" and dtype == "bfloat16":
        tl, tr = tl.to(tdtype), tr.to(tdtype)  # the band kernels' operands
    got = tcv.cost_volume_pair(tl, tr, ndisp, dtype=tdtype, method=method)
    want = jax_cvp(jnp.asarray(fl), jnp.asarray(fr), ndisp, method=method,
                   dtype=jdtype)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    for side, g, w in zip(("left", "right"), got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape == (6, 40, 128), side
        np.testing.assert_allclose(g[..., :ndisp], w[..., :ndisp], atol=atol)
        np.testing.assert_array_equal(g[..., ndisp:], w[..., ndisp:])
    # each side alone is the same volume
    for side, both in zip(("left", "right"), got):
        alone = tcv.cost_volume_pair(tl, tr, ndisp, sides=side, dtype=tdtype,
                                     method=method)
        torch.testing.assert_close(alone, both, rtol=0, atol=0)


def test_band_pair_plain_is_two_band_sides(rng):
    fl, fr = (torch.from_numpy(f) for f in _features(rng, 4, 30))
    left, right = tcv.band_pair(fl, fr, 9, 128, torch.float32)  # CPU: plain
    torch.testing.assert_close(
        left, tcv.band_side_plain(fl, fr, 9, 128, "left", torch.float32),
        rtol=0, atol=0)
    torch.testing.assert_close(
        right, tcv.band_side_plain(fr, fl, 9, 128, "right", torch.float32),
        rtol=0, atol=0)


def test_unknown_method_raises(rng):
    fl, fr = (torch.from_numpy(f) for f in _features(rng, 2, 8))
    with pytest.raises(ValueError, match="method"):
        tcv.cost_volume_pair(fl, fr, 4, method="scan")
