"""The options of ``match_pair`` that reach the CBCA and band variants
(``cbca_impl`` mxu, fused16, fused2, fused2_16, rolling, rolling16; joint
regions; ``sgm_u8``) in the port against JAX ``match_pair`` with the same
options, at 48 x 64 with the paper-default ``MatchConfig``.

On the CPU the port's wrappers run their plain versions; at this size the
JAX wrappers of the Pallas CBCA kernels take their XLA stencil, which is
exact f32. So the exact-f32 classes (f32 volumes with "rolling", "fused2",
joint regions, ``sgm_u8``) are held to rtol 1e-4 on the pre-WTA volumes,
equal WTA maps and a bad-2.0 delta of at most 0.005; the classes that round
the rounds' operands to bf16 ("mxu", "fused16", "fused2_16", "rolling16")
to the reduced-precision budget: within 0.5 pt bad-2.0 of JAX with the same
option and of the port's exact f32.
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

from test_torch_pipeline_modes import _assert_f32_parity, _bad2  # noqa: E402
from torch_parity import jax_params, scene_pair  # noqa: E402


@pytest.fixture(scope="module")
def small():
    return scene_pair("occlusion", 48, 64)


@pytest.fixture(scope="module")
def net():
    return params_from_numpy(jax_params())


def _port(scene, net, config=None, **kwargs):
    """The port's pipeline on the pair, volumes included."""
    left, right, _, ndisp = scene
    out = match_pair(net, torch.from_numpy(left), torch.from_numpy(right),
                     ndisp, MatchConfig(**(config or {})), return_volumes=True,
                     **kwargs)
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def exact(small, net):
    """The port's exact-f32 pipeline, volumes included."""
    return _port(small, net)


@pytest.fixture(scope="module")
def bf16_operand_runs(small, net):
    """The port's pipeline with each option that rounds the operands to
    bf16, once per module: two tests read each."""
    return {impl: _port(small, net, cbca_impl=impl)
            for impl in ("mxu", "fused16", "fused2_16", "rolling16")}


def _both(scene, net, config=None, got=None, **kwargs):
    """The same pair through JAX and the port (``got``, where the module
    has run it already), volumes included; sgm_chunk is JAX's
    semantics-neutral scan-unroll knob (1: a short compile)."""
    left, right, gt, ndisp = scene
    config = config or {}
    params = jax_params()
    jax_config = JaxMatchConfig(sgm_chunk=1, **config)
    out = jax.jit(lambda a, b: jax_match_pair(
        params, a, b, ndisp, jax_config, return_volumes=True,
        **kwargs))(left, right)
    want = {k: np.asarray(v, np.float32) for k, v in out.items()}
    if got is None:
        got = _port(scene, net, config, **kwargs)
    return got, want, gt, ndisp


@pytest.mark.parametrize("cbca_impl", ["rolling", "fused2"])
def test_exact_f32_impl_matches_jax_and_the_default(small, net, exact,
                                                    cbca_impl):
    got, want, gt, ndisp = _both(small, net, cbca_impl=cbca_impl)
    _assert_f32_parity(got, want, gt, ndisp)
    # K8's and K9's plain rounds are K2's: the same map as cbca_impl="auto"
    for name, value in exact.items():
        np.testing.assert_array_equal(got[name], value)


@pytest.mark.parametrize("cbca_impl",
                         ["mxu", "fused16", "fused2_16", "rolling16"])
def test_bf16_operand_impl_within_budget(small, net, exact, bf16_operand_runs,
                                        cbca_impl):
    got, want, gt, ndisp = _both(small, net, got=bf16_operand_runs[cbca_impl],
                                 cbca_impl=cbca_impl)
    assert np.isfinite(got["disparity"]).all()
    for name in ("left_volume", "right_volume"):
        assert got[name][..., ndisp:].min() >= 1e8
    bad = _bad2(got["disparity"], gt)
    assert abs(bad - _bad2(want["disparity"], gt)) <= 0.005
    assert abs(bad - _bad2(exact["disparity"], gt)) <= 0.005
    # the operands really are rounded: the volumes differ from exact f32
    assert not np.array_equal(got["left_volume"], exact["left_volume"])


def test_bf16_operand_impls_agree_inside_the_port(bf16_operand_runs):
    """fused16, rolling16 and fused2_16 round at the same places."""
    maps = [bf16_operand_runs[impl]["disparity"]
            for impl in ("fused16", "rolling16", "fused2_16")]
    np.testing.assert_array_equal(maps[0], maps[1])
    np.testing.assert_array_equal(maps[0], maps[2])


def test_joint_regions_match_jax(small, net, exact):
    got, want, gt, ndisp = _both(small, net,
                                 config={"cbca_joint_regions": True})
    _assert_f32_parity(got, want, gt, ndisp)
    assert not np.array_equal(got["left_volume"], exact["left_volume"])


def test_sgm_u8_matches_jax_and_changes_nothing(small, net, exact):
    got, want, gt, ndisp = _both(small, net, config={"sgm_u8": True})
    _assert_f32_parity(got, want, gt, ndisp)
    for name, value in exact.items():
        np.testing.assert_array_equal(got[name], value)


@pytest.mark.parametrize("kwargs", [
    {"cbca_impl": "rolling", "volume_dtype": "bfloat16"},
    {"cbca_impl": "fused2", "volume_dtype": "bfloat16"},
    {"cbca_impl": "fused2_16", "cbca_chunk_d": 64},
    {"cbca_impl": "mxu"},
], ids=["rolling-bf16", "fused2-bf16", "fused2_16-chunked", "mxu"])
def test_stage_times_and_bf16_storage(small, kwargs):
    """``MatchPipeline`` takes the new names; ``stage_times`` equals
    ``__call__``; bf16 storage with K8 / K9 equals bf16 storage with K2."""
    left, right, _, ndisp = small
    rounds = MatchConfig(cbca_num_iterations_1=1, cbca_num_iterations_2=3)
    pipeline = MatchPipeline(jax_params(), rounds, bucket=16, device="cpu",
                             **kwargs)
    want = pipeline(left[:45, :61], right[:45, :61], ndisp)
    got, times = pipeline.stage_times(left[:45, :61], right[:45, :61], ndisp)
    assert tuple(times) == STAGES
    np.testing.assert_array_equal(got, want)
    if kwargs.get("volume_dtype") == "bfloat16":
        fused = MatchPipeline(jax_params(), rounds, bucket=16, device="cpu",
                              volume_dtype="bfloat16")
        np.testing.assert_array_equal(
            want, fused(left[:45, :61], right[:45, :61], ndisp))


def test_option_errors():
    for impl in ("pallas", "mxu"):
        with pytest.raises(ValueError, match="float32 volumes only"):
            MatchPipeline(jax_params(), cbca_impl=impl,
                          volume_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="unknown cbca_impl"):
        MatchPipeline(jax_params(), cbca_impl="fused4", device="cpu")
