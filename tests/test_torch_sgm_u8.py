"""``MatchConfig.sgm_u8`` in the port: the penalty code volume against
JAX's ``penalty_scale_u8`` (exact), and SGM on codes against SGM on the
gradient planes (exact) and against JAX (f32 reassociation, rtol 1e-4).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.ops.common import BIG_COST  # noqa: E402
from mccnn_tpu.ops.sgm_pallas import penalty_scale_u8  # noqa: E402
from mccnn_tpu.utils.config import MatchConfig as JaxMatchConfig  # noqa: E402
from mccnn_tpu_torch.utils.config import MatchConfig  # noqa: E402

from torch_parity import jitted, scene_pair  # noqa: E402

jsgm = importlib.import_module("mccnn_tpu.ops.sgm")
# the module, not the function mccnn_tpu_torch.ops exports under its name
tsgm = importlib.import_module("mccnn_tpu_torch.ops.sgm")
# the JAX functions, each compiled once per shape and static arguments
jax_penalty_scale_u8 = jitted(penalty_scale_u8, "choice", "direction",
                              "d_pad", "sgm_d")
jax_sgm_one_volume = jitted(jsgm._sgm_one_volume, "choice", "ndisp", "config")

NDISP, D_PAD = 20, 128


def _inputs(rng, height=24, width=40):
    left, right, _, _ = scene_pair("slanted", height, width, seed=3)
    vol = rng.uniform(-1, 1, (height, width, D_PAD)).astype(np.float32)
    vol[..., NDISP:] = BIG_COST
    return left, right, vol


@pytest.mark.parametrize("choice", ["L", "R"])
@pytest.mark.parametrize("direction", tsgm._DIRECTIONS)
def test_codes_equal_jax(rng, direction, choice):
    left, right, _ = _inputs(rng)
    got = tsgm.penalty_scale_u8(torch.from_numpy(left),
                                torch.from_numpy(right), choice, direction,
                                D_PAD, 0.08)
    want = jax_penalty_scale_u8(jnp.asarray(left), jnp.asarray(right), choice,
                                direction, D_PAD, 0.08)
    height, width = left.shape
    lines = (height, width) if direction[0] else (width, height)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert tuple(got.shape) == (*lines, D_PAD)  # the sweep axis leads
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {0, 1, 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("paper_mode,choice", [(False, "L"), (True, "R")])
def test_sgm_on_codes_equals_sgm_on_planes(rng, paper_mode, choice, dtype):
    left, right, vol = _inputs(rng)
    images = (torch.from_numpy(left), torch.from_numpy(right))
    config = MatchConfig(sgm_paper_mode=paper_mode)
    plain = tsgm._sgm_one_volume(torch.from_numpy(vol.copy()).to(dtype),
                                 *images, choice, NDISP, config)
    coded = tsgm._sgm_one_volume(torch.from_numpy(vol.copy()).to(dtype),
                                 *images, choice, NDISP,
                                 config.replace(sgm_u8=True))
    assert coded.dtype == dtype
    torch.testing.assert_close(coded, plain, rtol=0, atol=0)


@pytest.mark.parametrize("paper_mode,choice", [(False, "R"), (True, "L")])
def test_sgm_on_codes_matches_jax(rng, paper_mode, choice):
    left, right, vol = _inputs(rng)
    want = np.asarray(jax_sgm_one_volume(
        jnp.asarray(vol), jnp.asarray(left), jnp.asarray(right), choice,
        NDISP, JaxMatchConfig(sgm_paper_mode=paper_mode, sgm_chunk=1,
                              sgm_u8=True)))
    got = tsgm._sgm_one_volume(
        torch.from_numpy(vol.copy()), torch.from_numpy(left),
        torch.from_numpy(right), choice, NDISP,
        MatchConfig(sgm_paper_mode=paper_mode, sgm_u8=True)).numpy()
    np.testing.assert_allclose(got[..., :NDISP], want[..., :NDISP],
                               rtol=1e-4, atol=1e-4)
    assert got[..., NDISP:].min() >= 1e8  # pad lanes stay BIG


def test_one_sweep_with_explicit_codes(rng):
    """``sweep_plain(codes=...)`` decodes the scale from the codes."""
    left, right, vol = _inputs(rng, 12, 24)
    images = (torch.from_numpy(left), torch.from_numpy(right))
    config = MatchConfig()
    for direction in ((0, -1), (1, 0)):
        codes = tsgm.penalty_scale_u8(*images, "L", direction, D_PAD,
                                      config.sgm_d)
        want = torch.empty(vol.shape)
        got = torch.empty(vol.shape)
        tsgm.sweep_plain(torch.from_numpy(vol), want, *images, "L",
                         direction, config)
        tsgm.sweep_plain(torch.from_numpy(vol), got, *images, "L", direction,
                         config, codes)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
