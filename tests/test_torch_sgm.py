"""The port's SGM (penalty bits, plain sweeps, K3's wrapper) against JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu.utils.config import MatchConfig  # noqa: E402

from torch_parity import jitted, scene_pair  # noqa: E402

jsgm = importlib.import_module("mccnn_tpu.ops.sgm")
# the module, not the function mccnn_tpu_torch.ops exports under its name
tsgm = importlib.import_module("mccnn_tpu_torch.ops.sgm")
# the JAX sweeps of one volume, compiled once per shape and static arguments
jax_sgm_one_volume = jitted(jsgm._sgm_one_volume, "choice", "ndisp", "config")
jax_sgm = jitted(jsgm.sgm, "ndisp", "config")

NDISP, D_PAD = 20, 128


def _inputs(rng, height=24, width=40):
    left, right, _, _ = scene_pair("slanted", height, width, seed=3)
    vol = rng.uniform(-1, 1, (height, width, D_PAD)).astype(np.float32)
    vol[..., NDISP:] = BIG_COST
    return left, right, vol


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("choice", ["L", "R"])
@pytest.mark.parametrize("direction", jsgm._DIRECTIONS)
def test_penalty_bits_bit_equal(rng, direction, choice):
    left, right, _ = _inputs(rng)
    height, width = left.shape
    small_d1, b2_chunk = jsgm._penalty_bits(
        jnp.asarray(left), jnp.asarray(right), choice, direction, D_PAD,
        0.08)
    port_d1, small_other = tsgm._penalty_bits(
        torch.from_numpy(left), torch.from_numpy(right), choice, direction,
        0.08)
    np.testing.assert_array_equal(port_d1.numpy(), np.asarray(small_d1))
    vertical = direction[0] != 0
    size = height if vertical else width
    index, oor = tsgm._probe(width, D_PAD, choice, direction[1], "cpu")
    port_b2 = torch.stack([
        tsgm._b2_line(small_other, index, oor, vertical, s)
        for s in range(size)
    ])
    np.testing.assert_array_equal(port_b2.numpy(),
                                  np.asarray(b2_chunk(0, size)))


@pytest.mark.parametrize("paper_mode,choice", [(False, "L"), (True, "R")])
def test_sgm_f32_matches_jax(rng, paper_mode, choice):
    left, right, vol = _inputs(rng)
    # sgm_chunk: JAX's semantics-neutral scan unroll, 1 for a short compile
    config = MatchConfig(sgm_paper_mode=paper_mode, sgm_chunk=1)
    want = np.asarray(jax_sgm_one_volume(
        jnp.asarray(vol), jnp.asarray(left), jnp.asarray(right), choice,
        NDISP, config))
    got = tsgm._sgm_one_volume(
        torch.from_numpy(vol.copy()), torch.from_numpy(left),
        torch.from_numpy(right), choice, NDISP, config).numpy()
    # the same f32 operations in the same association; 1e-5 relative
    # covers XLA's freedom to fuse on the CPU
    np.testing.assert_allclose(got[..., :NDISP], want[..., :NDISP],
                               rtol=1e-5, atol=1e-4)
    assert got[..., NDISP:].min() >= 1e8  # pad lanes stay BIG


@pytest.mark.parametrize("paper_mode", [False, True])
def test_sgm_bf16_storage_matches_jax(rng, paper_mode):
    left, right, vol = _inputs(rng)
    config = MatchConfig(sgm_paper_mode=paper_mode, sgm_chunk=1)
    want = np.asarray(jax_sgm_one_volume(
        jnp.asarray(vol, jnp.bfloat16), jnp.asarray(left), jnp.asarray(right),
        "L", NDISP, config).astype(jnp.float32))
    got = tsgm._sgm_one_volume(
        torch.from_numpy(vol).to(torch.bfloat16), torch.from_numpy(left),
        torch.from_numpy(right), "L", NDISP, config)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # DP lines carry f32 in both; each stored line rounds to bf16, and the
    # paper mode's average of four bf16 sweeps may round differently
    # (JAX on the CPU keeps excess precision): two bf16 ulps at the
    # largest cost
    atol = 2 * _bf16_ulp(want[..., :NDISP])
    np.testing.assert_allclose(got[..., :NDISP], want[..., :NDISP],
                               atol=atol)
    assert got[..., NDISP:].min() >= 1e8


def test_chained_mode_updates_in_place(rng):
    left, right, vol = _inputs(rng, 12, 24)
    volume = torch.from_numpy(vol.copy())
    out = tsgm._sgm_one_volume(volume, torch.from_numpy(left),
                               torch.from_numpy(right), "R", NDISP,
                               MatchConfig())
    assert out is volume
    paper = tsgm._sgm_one_volume(
        torch.from_numpy(vol), torch.from_numpy(left),
        torch.from_numpy(right), "R", NDISP, MatchConfig(sgm_paper_mode=True))
    np.testing.assert_array_equal(torch.from_numpy(vol).numpy(), vol)
    assert not torch.equal(paper, out)


def test_sgm_of_both_volumes_matches_jax(rng):
    """``ops.sgm.sgm``: the left volume's sweeps, then the right's."""
    left, right, vol = _inputs(rng, 12, 24)
    right_vol = vol[:, ::-1].copy()
    config = MatchConfig(sgm_chunk=1)
    want = jax_sgm(jnp.asarray(vol), jnp.asarray(right_vol),
                   jnp.asarray(left), jnp.asarray(right), NDISP, config)
    got = tsgm.sgm(torch.from_numpy(vol.copy()),
                   torch.from_numpy(right_vol.copy()), torch.from_numpy(left),
                   torch.from_numpy(right), NDISP, config)
    for port, jax_out in zip(got, want):
        np.testing.assert_allclose(port.numpy()[..., :NDISP],
                                   np.asarray(jax_out)[..., :NDISP],
                                   rtol=1e-5, atol=1e-4)
