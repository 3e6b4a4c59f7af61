"""The port's CBCA layout tools against JAX: ``tools/bench_cbca_banded.py::
banded_round`` and ``tools/bench_cbca_layout.py::cbca_hdw``.

Tolerances:
  * ``banded_round`` against JAX's and against the port's dense
    ``cbca_mxu``: ``round_tolerance``, per element. The operands are the
    same bf16 values and every product is exact, but an f32 horizontal sum
    taken in another order can round to the neighbouring bf16 value: one
    bf16 ulp of that sum, summed over the vertical arm and scaled by 1 /
    |region|, plus the f32 roundings of both orders' sums (measured here:
    0.0).
  * ``cbca_hdw``: the same additions per element in the same order as
    ``cbca``: bit for bit against the port's ``cbca``, rtol 1e-6 against
    JAX's (XLA's freedom to fuse on the CPU; measured: 0.0).
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu_torch.ops.cbca_mxu import cbca_mxu  # noqa: E402
from mccnn_tpu_torch.tools import bench_cbca_banded as banded  # noqa: E402
from mccnn_tpu_torch.tools import bench_cbca_layout as layout  # noqa: E402

from torch_parity import jax_arms, jitted, jitted_round, scene_pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the modules, not the functions mccnn_tpu.ops and mccnn_tpu_torch.ops
# export under their names
jcbca = importlib.import_module("mccnn_tpu.ops.cbca")
tcbca = importlib.import_module("mccnn_tpu_torch.ops.cbca")
jax_cbca = jitted_round(jcbca.cbca)

TAU, DIST = 0.02, 14
HEIGHT, WIDTH, DEPTH = 40, 56, 16


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def inputs():
    """A textureless image (arms up to the radius, 13) and a normal
    volume: the port's arms and volume, JAX's arms."""
    image, _, _, _ = scene_pair("textureless", HEIGHT, WIDTH, seed=0)
    volume = np.random.default_rng(1).normal(
        size=(HEIGHT, WIDTH, DEPTH)).astype(np.float32)
    arms = tcbca.compute_arms(torch.from_numpy(image), TAU, DIST)
    assert int(arms.left.max()) == DIST - 1
    return torch.from_numpy(volume), arms, jax_arms(image, TAU, DIST)


def _assert_within(got, want, tolerance):
    error = (got - want).abs()
    assert bool((error <= tolerance).all()), float(
        (error - tolerance).max())


def test_banded_round_matches_jax(inputs):
    volume, arms, arms_jax = inputs
    jax_banded_round = jitted(_jax_tool("bench_cbca_banded").banded_round,
                              "dist", "block")
    want = torch.from_numpy(np.array(jax_banded_round(
        jnp.asarray(volume.numpy()), arms_jax, dist=DIST, block=16)))
    got = banded.banded_round(volume, arms, DIST, 16)
    assert got.shape == (HEIGHT, WIDTH, DEPTH) and got.dtype == torch.float32
    _assert_within(got, want, banded.round_tolerance(volume, arms, DIST))


@pytest.mark.parametrize("block", [13, 16, 128])
def test_banded_round_matches_dense_mxu(inputs, block):
    """Blocks at the arms' reach (13), ragged (16) and wider than the image
    (128, the tool's default)."""
    volume, arms, _ = inputs
    want = cbca_mxu(volume, arms, 1, DIST)
    got = banded.banded_round(volume, arms, DIST, block)
    _assert_within(got, want, banded.round_tolerance(volume, arms, DIST))


def test_banded_round_refuses_blocks_shorter_than_the_arms(inputs):
    volume, arms, _ = inputs
    with pytest.raises(ValueError, match="block 12 < dist - 1 = 13"):
        banded.banded_round(volume, arms, DIST, 12)


def test_cbca_hdw_matches_cbca(inputs):
    volume, arms, arms_jax = inputs
    want = np.asarray(jax_cbca(jnp.asarray(volume.numpy()), arms_jax,
                               num_iterations=2, distance_threshold=DIST))
    got = layout.cbca_hdw(volume, arms, 2, DIST)
    assert got.shape == (HEIGHT, WIDTH, DEPTH) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.numpy(),
                                  tcbca.cbca(volume, arms, 2, DIST).numpy())


@pytest.mark.parametrize("tool", [banded, layout])
def test_tools_need_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tool.main()
