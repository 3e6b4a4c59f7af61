"""The batch matcher's schedules (exact-f32, int8, d-chunked, torch-op cost
volumes) in the port's ``match_pair`` against JAX ``match_pair`` with the
same arguments, and ``stage_times`` against ``__call__``.

Small sizes and two or three CBCA rounds keep the JAX CPU compiles short;
on the CPU the port's wrappers run their plain versions and JAX runs its
Pallas kernels in interpret mode or through their XLA references.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mccnn_tpu.pipeline.match import match_pair as jax_match_pair  # noqa: E402
from mccnn_tpu.utils.config import MatchConfig as JaxMatchConfig  # noqa: E402
from mccnn_tpu_torch.models.net import params_from_numpy  # noqa: E402
from mccnn_tpu_torch.pipeline.match import (  # noqa: E402
    STAGES,
    MatchPipeline,
    match_pair,
)
from mccnn_tpu_torch.utils.config import MatchConfig  # noqa: E402

from torch_parity import jax_params, scene_pair  # noqa: E402

# one round before SGM and two after; sgm_chunk is JAX's semantics-neutral
# scan-unroll knob
ROUNDS = {"cbca_num_iterations_1": 1, "cbca_num_iterations_2": 2}


def _bad2(disparity, gt):
    return float(np.mean(np.abs(disparity - gt) > 2.0))


def _both(scene, **kwargs):
    """The same pair through JAX and the port, volumes included."""
    left, right, gt, ndisp = scene
    params = jax_params()
    jax_config = JaxMatchConfig(sgm_chunk=1, **ROUNDS)
    out = jax.jit(lambda a, b: jax_match_pair(
        params, a, b, ndisp, jax_config, return_volumes=True,
        **kwargs))(left, right)
    want = {k: np.asarray(v, np.float32) for k, v in out.items()}
    out = match_pair(params_from_numpy(params), torch.from_numpy(left),
                     torch.from_numpy(right), ndisp, MatchConfig(**ROUNDS),
                     return_volumes=True, **kwargs)
    got = {k: v.float().numpy() for k, v in out.items()}
    return got, want, gt, ndisp


def _assert_f32_parity(got, want, gt, ndisp):
    for name in ("left_volume", "right_volume"):
        # float reassociation only (rtol 1e-4); atol for costs near zero
        np.testing.assert_allclose(got[name][..., :ndisp],
                                   want[name][..., :ndisp], rtol=1e-4,
                                   atol=1e-4)
        assert got[name][..., ndisp:].min() >= 1e8
    for name in ("left_disparity", "right_disparity"):
        np.testing.assert_array_equal(got[name], want[name])
    assert abs(_bad2(got["disparity"], gt)
               - _bad2(want["disparity"], gt)) <= 0.005


@pytest.fixture(scope="module")
def small():
    return scene_pair("occlusion", 48, 64)


def test_exact_f32_single_pass_cbca_matches_jax(small):
    """cbca_impl="pallas": K7's plain version against JAX's kernel in
    interpret mode."""
    _assert_f32_parity(*_both(small, cbca_impl="pallas"))


def test_int8_mode_within_budget_of_jax(small):
    got, want, gt, ndisp = _both(small, cbca_impl="fused8",
                                 volume_dtype="bfloat16")
    assert np.isfinite(got["disparity"]).all()
    for name in ("left_volume", "right_volume"):
        assert got[name][..., ndisp:].min() >= 1e8
        # a quantization step apart where the f32 inputs round apart
        top = np.abs(want[name][..., :ndisp]).max()
        close = np.abs(got[name][..., :ndisp]
                       - want[name][..., :ndisp]) <= 3 * top / 126
        assert close.mean() >= 0.99
    # the reduced-precision budget: 0.5 pt bad-2.0
    assert abs(_bad2(got["disparity"], gt)
               - _bad2(want["disparity"], gt)) <= 0.005


def test_int8_mode_within_budget_of_exact_f32(small):
    left, right, gt, ndisp = small
    net = params_from_numpy(jax_params())
    run = lambda **kw: match_pair(  # noqa: E731
        net, torch.from_numpy(left), torch.from_numpy(right), ndisp,
        MatchConfig(**ROUNDS), **kw).numpy()
    exact = run(cbca_impl="pallas")
    np.testing.assert_array_equal(exact, run())  # K2's and K7's plain round
    assert abs(_bad2(run(cbca_impl="fused8"), gt) - _bad2(exact, gt)) <= 0.005


@pytest.mark.parametrize("kwargs", [
    {},
    {"cbca_impl": "pallas"},
    {"cbca_impl": "fused8", "volume_dtype": "bfloat16"},
    {"cost_volume_method": "rolldot"},
], ids=["default", "pallas", "fused8-bf16", "rolldot"])
def test_stage_times_equals_call(small, kwargs):
    left, right, _, ndisp = small
    pipeline = MatchPipeline(jax_params(), MatchConfig(**ROUNDS), bucket=16,
                             device="cpu", **kwargs)
    want = pipeline(left[:45, :61], right[:45, :61], ndisp)
    got, times = pipeline.stage_times(left[:45, :61], right[:45, :61], ndisp)
    assert tuple(times) == STAGES
    assert got.shape == (45, 61)
    np.testing.assert_array_equal(got, want)
