"""The port's exact-f32 (K7) and int8 (K4) CBCA modes against JAX.

On the CPU the wrappers run their plain versions. The JAX side runs
``cbca_pallas`` in interpret mode (as the JAX package's own tests run it on
the CPU), the exact ``cbca``, and ``cbca_int8_xla``, which is bit-equal to
the int8 Pallas kernel (exact integer math).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops import cbca_fused as jfused  # noqa: E402
from mccnn_tpu.ops.cbca_pallas import cbca_pallas as jcbca_pallas  # noqa: E402
from mccnn_tpu.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.ops import cbca_fused as tfused  # noqa: E402
from mccnn_tpu_torch.ops.cbca_pallas import cbca_pallas  # noqa: E402

from torch_parity import jax_arms, jitted_round, scene_pair  # noqa: E402

# the module, not the function mccnn_tpu.ops re-exports under its name
jcbca = importlib.import_module("mccnn_tpu.ops.cbca")
# the module, not the function mccnn_tpu_torch.ops exports under its name
tcbca = importlib.import_module("mccnn_tpu_torch.ops.cbca")
# the JAX rounds, each compiled once per shape and static arguments
jax_cbca = jitted_round(jcbca.cbca)
jax_cbca_pallas = jitted_round(jcbca_pallas)
jax_cbca_int8 = jitted_round(jfused.cbca_int8_xla)

TAU, DIST = 0.02, 14
HEIGHT, WIDTH, NDISP = 48, 64, 16
_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _arms(seed=0):
    image, _, _, _ = scene_pair("textureless", HEIGHT, WIDTH, seed)
    return (tcbca.compute_arms(torch.from_numpy(image), TAU, DIST),
            jax_arms(image, TAU, DIST))


def _volume(rng, d_pad=128, ndisp=NDISP):
    vol = rng.uniform(-1, 1, (HEIGHT, WIDTH, d_pad)).astype(np.float32)
    vol[..., ndisp:] = BIG_COST
    return vol


@pytest.mark.parametrize("iterations", [1, 3])
def test_cbca_pallas_matches_jax_kernel_and_exact_cbca(rng, iterations):
    port_arms, jax_arms = _arms()
    vol = _volume(rng)
    got = cbca_pallas(torch.from_numpy(vol), port_arms, iterations, DIST)
    kernel = jax_cbca_pallas(jnp.asarray(vol), jax_arms, iterations, DIST,
                             interpret=True)
    exact = jax_cbca(jnp.asarray(vol), jax_arms, iterations, DIST)
    # f32 sums of up to 27 x 27 terms, the same order up to XLA's fusion
    for want in (kernel, exact):
        np.testing.assert_allclose(got.numpy()[..., :NDISP],
                                   np.asarray(want)[..., :NDISP], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy()[..., NDISP:],
                                   np.asarray(want)[..., NDISP:], rtol=1e-5)


def test_cbca_pallas_takes_f32_only_and_zero_rounds_is_identity(rng):
    port_arms, _ = _arms()
    vol = torch.from_numpy(_volume(rng))
    assert cbca_pallas(vol, port_arms, 0, DIST) is vol
    with pytest.raises(ValueError):
        cbca_pallas(vol.to(torch.bfloat16), port_arms, 1, DIST)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_quantize_and_dequantize_bit_equal(rng, dtype):
    tdtype, jdtype = _DTYPES[dtype]
    vol = _volume(rng) * 0.37
    q, scale = tfused._quantize_int8(torch.from_numpy(vol).to(tdtype))
    want_q, want_scale = jfused._quantize_int8(jnp.asarray(vol, jdtype))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    assert float(scale) == float(want_scale)
    assert bool((q[..., NDISP:] == 127).all())
    assert int(q[..., :NDISP].abs().max()) == 126
    back = tfused._dequantize_int8(q, scale, tdtype)
    want_back = jfused._dequantize_int8(want_q, want_scale, jdtype)
    assert back.dtype == tdtype
    np.testing.assert_array_equal(
        back.float().numpy(), np.asarray(want_back.astype(jnp.float32)))
    assert float(back[..., NDISP:].float().min()) >= 1e8


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("iterations", [1, 3])
def test_cbca_int8_plain_bit_equal_to_jax(rng, iterations, dtype):
    tdtype, jdtype = _DTYPES[dtype]
    port_arms, jax_arms = _arms(1)
    vol = _volume(rng)
    got = tfused.cbca_int8_plain(torch.from_numpy(vol).to(tdtype), port_arms,
                                 iterations, DIST)
    want = jax_cbca_int8(jnp.asarray(vol, jdtype), jax_arms,
                                iterations, DIST)
    assert got.dtype == tdtype
    # exact integer math between one quantization and one dequantization
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the wrapper takes the plain version for a CPU tensor
    via_wrapper = tfused.cbca_fused(torch.from_numpy(vol).to(tdtype),
                                    port_arms, iterations, DIST,
                                    int8_storage=True)
    torch.testing.assert_close(via_wrapper, got, rtol=0, atol=0)


def test_cbca_int8_raw_mode_bit_equal_to_jax(rng):
    """Pre-quantized input: int8 in, int8 out, BIG lanes stay 127."""
    port_arms, jax_arms = _arms(2)
    q = rng.integers(-126, 127, (HEIGHT, WIDTH, 128)).astype(np.int8)
    q[..., NDISP:] = 127
    got = tfused.cbca_fused(torch.from_numpy(q), port_arms, 3, DIST,
                            int8_storage=True)
    want = jax_cbca_int8(jnp.asarray(q), jax_arms, 3, DIST)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[..., NDISP:] == 127).all())
    assert int(got[..., :NDISP].abs().max()) <= 126
    assert tfused.cbca_int8_plain(torch.from_numpy(q), port_arms, 0,
                                  DIST).dtype == torch.int8


def test_cbca_int8_close_to_exact_cbca(rng):
    """One int8 step is 1/126 of the largest |cost|: after the rounds the
    dequantized volume stays within a few steps of the exact f32 result."""
    port_arms, _ = _arms()
    vol = torch.from_numpy(_volume(rng))
    got = tfused.cbca_int8_plain(vol, port_arms, 2, DIST)
    want = tcbca.cbca(vol, port_arms, 2, DIST)
    step = 1.0 / 126
    assert float((got - want)[..., :NDISP].abs().max()) <= 2 * step
