"""The port's CBCA (arms, plain rounds, K2's wrapper) against JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops import cbca_fused as jfused  # noqa: E402
from mccnn_tpu.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.ops.cbca_fused import cbca_fused  # noqa: E402

from torch_parity import jax_arms as jax_arms_of  # noqa: E402
from torch_parity import jitted_round, scene_pair  # noqa: E402

# the module, not the function mccnn_tpu.ops re-exports under its name
jcbca = importlib.import_module("mccnn_tpu.ops.cbca")
# the module, not the function mccnn_tpu_torch.ops exports under its name
tcbca = importlib.import_module("mccnn_tpu_torch.ops.cbca")
# the JAX rounds, each compiled once per shape and static arguments
jax_cbca = jitted_round(jcbca.cbca)
jax_cbca_fused = jitted_round(jfused.cbca_fused)

# f32 sums of up to 27 x 27 terms of |v| <= 1 in another order (the Pallas
# kernel contracts with matmuls): relative 1e-5, absolute 1e-4
RTOL, ATOL = 1e-5, 1e-4
TAU, DIST = 0.02, 14


def _image(height, width, seed=0):
    left, _, _, _ = scene_pair("textureless", height, width, seed)
    return left


def _arms(image):
    port = tcbca.compute_arms(torch.from_numpy(image), TAU, DIST)
    jax_arms = jax_arms_of(image, TAU, DIST)
    return port, jax_arms


def _volume(rng, height, width, d_pad=128, ndisp=20):
    vol = rng.uniform(-1, 1, (height, width, d_pad)).astype(np.float32)
    vol[..., ndisp:] = BIG_COST
    return vol


def test_arms_bit_equal():
    image = _image(40, 56)
    port, jax_arms = _arms(image)
    for name in jcbca.CrossArms._fields:
        got = getattr(port, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jax_arms, name)))
    # the flat patches grow long arms, capped at distance - 1
    assert int(port.left.max()) == DIST - 1


@pytest.mark.parametrize("iterations", [1, 3])
def test_plain_cbca_matches_jax(rng, iterations):
    image = _image(30, 44)
    port_arms, jax_arms = _arms(image)
    vol = _volume(rng, 30, 44)
    got = tcbca.cbca(torch.from_numpy(vol), port_arms, iterations, DIST)
    want = jax_cbca(jnp.asarray(vol), jax_arms, iterations, DIST)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(got[..., 20:].min()) > 1e8  # pad lanes stay BIG


def test_plain_cbca_bf16_storage_matches_jax(rng):
    image = _image(30, 44)
    port_arms, jax_arms = _arms(image)
    vol = _volume(rng, 30, 44)
    got = tcbca.cbca(torch.from_numpy(vol).to(torch.bfloat16), port_arms, 2,
                     DIST)
    want = jax_cbca(jnp.asarray(vol, jnp.bfloat16), jax_arms, 2, DIST)
    assert got.dtype == torch.bfloat16
    # f32 accumulation, one bf16 rounding per round: the two may land on
    # neighbouring bf16 values (one ulp at |v| <= 1 is 2^-8)
    np.testing.assert_allclose(
        got.float().numpy()[..., :20],
        np.asarray(want.astype(jnp.float32))[..., :20], atol=2.0 ** -8)


def test_cbca_fused_matches_pallas_kernel(rng):
    """100 x 150 x 128 is above the Pallas kernel's small-shape fallback,
    so JAX runs the fused round kernel (in interpret mode)."""
    image = _image(100, 150)
    port_arms, jax_arms = _arms(image)
    vol = _volume(rng, 100, 150, ndisp=40)
    got = cbca_fused(torch.from_numpy(vol), port_arms, 1, DIST)
    want = jax_cbca_fused(jnp.asarray(vol), jax_arms, 1, DIST,
                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cbca_fused_zero_iterations_is_identity(rng):
    image = _image(20, 30)
    port_arms, _ = _arms(image)
    vol = torch.from_numpy(_volume(rng, 20, 30))
    assert cbca_fused(vol, port_arms, 0, DIST) is vol
