"""The port's CBCA variants against their JAX counterparts on the CPU:
``cbca_fused_rolling`` (K8), ``cbca_fused_two`` (K9), ``cbca_fused`` with
``compute_dtype`` bf16 (K2's flag) and ``cbca_mxu``.

The port's wrappers run their plain rounds on CPU tensors; the JAX kernels
run in interpret mode, as the JAX package's own tests run them (small
tiles, shapes that are no multiple of a tile). XLA on the CPU evaluates the
kernels' DEFAULT-precision dots in f32, so in the bf16 modes JAX and the
port round at the same places (the volume values, and the storage) and
differ only by the order of the f32 sums.

Tolerances. f32 modes: rtol 2e-5, atol 1e-4 (sums of up to 27 x 27 terms
in another order; pad lanes hold ~1e9, compared relatively). bf16-multiply
and bf16-storage modes must stay inside the JAX tests' own budget, rtol
0.05 / atol 0.05 on the real lanes and > 0.5 x BIG_COST on the pad lanes;
the measured maxima are far tighter and are asserted beside it: the mixed
modes (f32 storage) differ by reassociation only (<= 2e-5), bf16 storage by
at most one bf16 step of a value near 1 (2^-8, where the two f32 sums
straddle a rounding boundary).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops import cbca_fused as jfused  # noqa: E402
from mccnn_tpu.ops import cbca_fused2 as jfused2  # noqa: E402
from mccnn_tpu.ops import cbca_rolling as jrolling  # noqa: E402
from mccnn_tpu.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu_torch.ops.cbca_fused import cbca_fused  # noqa: E402
from mccnn_tpu_torch.ops.cbca_fused2 import cbca_fused_two  # noqa: E402
from mccnn_tpu_torch.ops.cbca_mxu import build_masks, cbca_mxu  # noqa: E402
from mccnn_tpu_torch.ops.cbca_rolling import cbca_fused_rolling  # noqa: E402

from torch_parity import jax_arms, jitted, jitted_round  # noqa: E402

# the modules, not the functions mccnn_tpu.ops re-exports under their names
jcbca = importlib.import_module("mccnn_tpu.ops.cbca")
jmxu = importlib.import_module("mccnn_tpu.ops.cbca_mxu")
# the module, not the function mccnn_tpu_torch.ops exports under its name
tcbca = importlib.import_module("mccnn_tpu_torch.ops.cbca")
# the JAX kernels (interpret mode) and rounds, each compiled once per shape
# and static arguments
jax_cbca_fused = jitted_round(jfused.cbca_fused)
jax_fused_two = jitted_round(jfused2.cbca_fused_two)
jax_rolling = jitted_round(jrolling.cbca_fused_rolling)
jax_cbca_mxu = jitted_round(jmxu.cbca_mxu)
jax_build_masks = jitted(jmxu.build_masks)

TAU, NDISP = 0.8, 5
# (storage, compute_dtype) per mode, for torch and for JAX
MODES = {
    "f32": ((torch.float32, None), (jnp.float32, None)),
    "bf16": ((torch.bfloat16, None), (jnp.bfloat16, None)),
    "mixed": ((torch.float32, torch.bfloat16), (jnp.float32, jnp.bfloat16)),
}
BF16_STEP = 2.0 ** -8


def _case(rng, height, width, dist, d_pad=128):
    image = rng.normal(size=(height, width)).astype(np.float32)
    volume = np.full((height, width, d_pad), BIG_COST, dtype=np.float32)
    volume[:, :, :NDISP] = rng.normal(size=(height, width, NDISP))
    return (volume,
            tcbca.compute_arms(torch.from_numpy(image), TAU, dist),
            jax_arms(image, TAU, dist))


def _assert_mode(mode, got, want):
    """``got`` (torch) against ``want`` (JAX) in the mode's tolerance."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    real_g, real_w = got[..., :NDISP], want[..., :NDISP]
    if mode == "f32":
        np.testing.assert_allclose(real_g, real_w, rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(got[..., NDISP:], want[..., NDISP:],
                                   rtol=2e-5)
        return
    # the JAX tests' budget for the reduced-precision modes ...
    np.testing.assert_allclose(real_g, real_w, rtol=0.05, atol=0.05)
    assert np.all(got[..., NDISP:] > 0.5 * BIG_COST)
    # ... and the measured maximum, far inside it
    worst = np.abs(real_g - real_w).max()
    limit = 2e-5 if mode == "mixed" else 2 * BF16_STEP
    assert worst <= limit, worst


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rolling_matches_jax_kernel(rng, mode):
    (tdtype, tcompute), (jdtype, jcompute) = MODES[mode]
    volume, port_arms, jax_arms = _case(rng, 100, 150, 14)
    got = cbca_fused_rolling(torch.from_numpy(volume).to(tdtype), port_arms,
                             2, 14, compute_dtype=tcompute)
    want = jax_rolling(jnp.asarray(volume, jdtype), jax_arms, 2, 14,
                       interpret=True, tile_h=32, compute_dtype=jcompute)
    assert got.dtype == tdtype
    _assert_mode(mode, got, want)


@pytest.mark.parametrize("iterations,mode", [
    (2, "f32"), (3, "f32"), (2, "bf16"), (3, "mixed"),
])
def test_fused_two_matches_jax_kernel(rng, iterations, mode):
    (tdtype, tcompute), (jdtype, jcompute) = MODES[mode]
    volume, port_arms, jax_arms = _case(rng, 100, 300, 14)
    got = cbca_fused_two(torch.from_numpy(volume).to(tdtype), port_arms,
                         iterations, 14, compute_dtype=tcompute)
    want = jax_fused_two(jnp.asarray(volume, jdtype), jax_arms, iterations,
                         14, interpret=True, tile_h=32,
                         compute_dtype=jcompute)
    assert got.dtype == tdtype
    _assert_mode(mode, got, want)


def test_fused16_matches_jax_kernel(rng):
    """``cbca_fused(compute_dtype=bf16)`` on f32 storage ("fused16")."""
    volume, port_arms, jax_arms = _case(rng, 100, 150, 14)
    got = cbca_fused(torch.from_numpy(volume), port_arms, 2, 14,
                     compute_dtype=torch.bfloat16)
    want = jax_cbca_fused(jnp.asarray(volume), jax_arms, 2, 14,
                          interpret=True, tile_h=32,
                          compute_dtype=jnp.bfloat16)
    _assert_mode("mixed", got, want)
    # the flag does something: the exact f32 round differs
    exact = cbca_fused(torch.from_numpy(volume), port_arms, 2, 14)
    assert float((got - exact)[..., :NDISP].abs().max()) > 1e-4


def test_mxu_matches_jax(rng):
    """Both round the volume and the horizontal sums to bf16 once per
    round and accumulate in f32: equal up to the order of the f32 sums
    (where two sums straddle a bf16 boundary, one bf16 step of the
    horizontal sum, |sum| < 64: 2^-2, divided by a region of >= 1)."""
    volume, port_arms, jax_arms = _case(rng, 40, 60, 14)
    masks = build_masks(port_arms)
    for ours, theirs in zip(masks, jax_build_masks(jax_arms)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    got = cbca_mxu(torch.from_numpy(volume), port_arms, 2, 14, masks=masks)
    want = jax_cbca_mxu(jnp.asarray(volume), jax_arms, 2, 14)
    assert got.dtype == torch.float32
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got[..., :NDISP], want[..., :NDISP],
                               rtol=0.05, atol=0.05)
    assert np.all(got[..., NDISP:] > 0.5 * BIG_COST)
    assert np.abs(got - want)[..., :NDISP].max() <= 1e-3
    # masks built inside the call give the same result
    again = cbca_mxu(torch.from_numpy(volume), port_arms, 2, 14)
    np.testing.assert_array_equal(again.numpy(), got)
    # the JAX round returns f32, so its loop takes f32 volumes only
    with pytest.raises(ValueError):
        cbca_mxu(torch.from_numpy(volume).to(torch.bfloat16), port_arms, 1,
                 14)
    with pytest.raises(TypeError):
        jmxu.cbca_mxu(jnp.asarray(volume, jnp.bfloat16), jax_arms, 1, 14)


@pytest.mark.parametrize("iterations", [2, 3])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_variants_equal_fused_inside_the_port(rng, mode, iterations):
    """rolling == fused and fused2 == fused exactly (rolling16 == fused16,
    fused2_16 == fused16 in the mixed mode), for even and odd counts."""
    (tdtype, tcompute), _ = MODES[mode]
    volume, port_arms, _ = _case(rng, 60, 70, 14)
    vol = torch.from_numpy(volume).to(tdtype)
    want = cbca_fused(vol, port_arms, iterations, 14, compute_dtype=tcompute)
    for variant in (cbca_fused_rolling, cbca_fused_two):
        got = variant(vol, port_arms, iterations, 14, compute_dtype=tcompute)
        assert got.dtype == tdtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("variant", [cbca_fused_rolling, cbca_fused_two],
                         ids=["rolling", "fused2"])
def test_narrow_image_matches_jax(rng, variant):
    """40 x 30: JAX falls back to its XLA stencil, the port has no
    fallback (on the card it runs the kernel; here the plain round)."""
    volume, port_arms, jax_arms = _case(rng, 40, 30, 4)
    got = variant(torch.from_numpy(volume), port_arms, 2, 4)
    jax_fn = jax_rolling if variant is cbca_fused_rolling else jax_fused_two
    want = jax_fn(jnp.asarray(volume), jax_arms, 2, 4, interpret=True)
    _assert_mode("f32", got, want)


def test_zero_rounds_and_bad_arguments(rng):
    volume, port_arms, _ = _case(rng, 20, 30, 4)
    vol = torch.from_numpy(volume)
    for fn in (cbca_fused_rolling, cbca_fused_two, cbca_mxu):
        assert fn(vol, port_arms, 0, 4) is vol
    for fn in (cbca_fused_rolling, cbca_fused_two):
        with pytest.raises(ValueError):
            fn(vol.to(torch.int8), port_arms, 1, 4)
        with pytest.raises(ValueError):
            fn(vol, port_arms, 1, 4, compute_dtype=torch.float16)
