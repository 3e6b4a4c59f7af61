"""The port's joint-region CBCA against JAX ``cbca_joint`` and against the
loop oracle of the JAX package's tests (``tests/oracles.py``).

The port sums each element in JAX's order, a chunk of disparities at a
time: rtol 1e-5 against JAX (measured: equal), rtol 1e-4 against the f64
oracle (the JAX test's own tolerance).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops.cbca_joint import cbca_joint  # noqa: E402
from mccnn_tpu.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.ops import cbca_joint as tjoint  # noqa: E402

from oracles import cross_regions_oracle, joint_cbca_oracle  # noqa: E402
from torch_parity import jax_arms, jitted_round  # noqa: E402

# the module, not the function mccnn_tpu_torch.ops exports under its name
tcbca = importlib.import_module("mccnn_tpu_torch.ops.cbca")

# JAX's joint rounds, compiled once per shape and static arguments
jax_cbca_joint = jitted_round(cbca_joint)


def _padded(ref_volume, d_pad=8):
    """(ndisp, H, W) reference layout -> (H, W, d_pad) with BIG pad lanes."""
    ndisp, height, width = ref_volume.shape
    volume = np.full((height, width, d_pad), BIG_COST, np.float32)
    volume[..., :ndisp] = np.moveaxis(ref_volume, 0, -1)
    return volume


@pytest.mark.parametrize("choice", ["L", "R"])
@pytest.mark.parametrize("iterations", [1, 2])
def test_matches_jax_and_the_oracle(rng, choice, iterations):
    height, width, ndisp = 10, 14, 4
    tau, dist = 0.8, 3
    left = rng.normal(size=(height, width)).astype(np.float32)
    right = rng.normal(size=(height, width)).astype(np.float32)
    ref_volume = rng.normal(size=(ndisp, height, width)).astype(np.float32)
    volume = _padded(ref_volume)
    self_img, other_img = (left, right) if choice == "L" else (right, left)

    got = tjoint.cbca_joint(
        torch.from_numpy(volume),
        tcbca.compute_arms(torch.from_numpy(self_img), tau, dist),
        tcbca.compute_arms(torch.from_numpy(other_img), tau, dist),
        iterations, dist, ndisp, choice).numpy()
    want = np.asarray(jax_cbca_joint(
        jnp.asarray(volume),
        jax_arms(self_img, tau, dist),
        jax_arms(other_img, tau, dist),
        iterations, dist, ndisp, choice))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    expected = joint_cbca_oracle(
        ref_volume, cross_regions_oracle(self_img, tau, dist),
        cross_regions_oracle(other_img, tau, dist), iterations, choice)
    np.testing.assert_allclose(np.moveaxis(got[..., :ndisp], -1, 0), expected,
                               rtol=1e-4, atol=1e-4)
    assert got[..., ndisp:].min() >= 1e8  # pad lanes: plain regions of BIG


def test_disparity_chunks_do_not_change_the_result(rng, monkeypatch):
    """More disparities than one chunk holds, against chunks of 3."""
    height, width, ndisp, dist = 12, 20, 10, 4
    left = rng.normal(size=(height, width)).astype(np.float32)
    right = rng.normal(size=(height, width)).astype(np.float32)
    volume = _padded(rng.normal(size=(ndisp, height, width)).astype(
        np.float32), d_pad=16)
    arms = [tcbca.compute_arms(torch.from_numpy(i), 0.8, dist)
            for i in (left, right)]
    whole = tjoint.cbca_joint(torch.from_numpy(volume), *arms, 2, dist, ndisp,
                              "L")
    monkeypatch.setattr(tjoint, "_DISPARITY_CHUNK", 3)
    chunked = tjoint.cbca_joint(torch.from_numpy(volume), *arms, 2, dist,
                                ndisp, "L")
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    want = np.asarray(jax_cbca_joint(
        jnp.asarray(volume),
        *[jax_arms(i, 0.8, dist)
          for i in (left, right)], 2, dist, ndisp, "L"))
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-5, atol=1e-6)


def test_zero_rounds_is_identity_and_input_is_kept(rng):
    volume = torch.from_numpy(_padded(
        rng.normal(size=(3, 6, 9)).astype(np.float32)))
    arms = tcbca.compute_arms(torch.from_numpy(
        rng.normal(size=(6, 9)).astype(np.float32)), 0.8, 3)
    assert tjoint.cbca_joint(volume, arms, arms, 0, 3, 3, "R") is volume
    before = volume.clone()
    out = tjoint.cbca_joint(volume, arms, arms, 1, 3, 3, "R")
    assert out is not volume
    torch.testing.assert_close(volume, before, rtol=0, atol=0)
