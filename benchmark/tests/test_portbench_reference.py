"""The plain reference against the port's CPU path (its plain versions) at
a small size: the same maps, and the same stages bit for bit."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.scenes import FAMILIES, make_pair

REF = harness.load_module(harness.BENCH / "reference" / "mccnn_fast.py",
                          "portbench_reference_test")


def _inputs(family="slanted", seed=3, height=40, width=72, maxd=16):
    config = harness.load_cell("half-stream-mix").config
    weights, biases = harness.make_weights(seed, config["net"], "cpu")
    left, right = make_pair(family, seed, 0, height, width, maxd, "cpu")
    return config, weights, biases, left, right


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("volume_dtype", ["bfloat16", "float32"])
def test_reference_map_equals_the_port_on_cpu(family, volume_dtype):
    from mccnn_tpu_torch.pipeline.match import MatchPipeline
    from mccnn_tpu_torch.utils.config import MatchConfig

    config, weights, biases, left, right = _inputs(family)
    pipeline = MatchPipeline(harness.params_tree(weights, biases),
                             config=MatchConfig(**config["match"]), bucket=8,
                             volume_dtype=volume_dtype, device="cpu")
    program = pipeline(left, right, 24)
    ref = REF.match(weights, biases, left, right, 24, config["match"], 8,
                    volume_dtype, "cpu")
    assert program.shape == ref.shape == left.shape
    np.testing.assert_array_equal(program, ref)


def test_reference_cbca_in_lane_blocks_is_the_port_round_bit_for_bit():
    from mccnn_tpu_torch.ops.cbca import CrossArms, cbca, compute_arms

    gen = torch.Generator().manual_seed(0)
    image = torch.rand((30, 44), generator=gen)
    image[5:20, 10:30] = 0.5  # a flat patch: arms to the radius
    volume = (torch.randn((30, 44, 256), generator=gen) * 0.4).to(
        torch.bfloat16)
    arms = REF.compute_arms(image, 0.02, 14)
    port_arms = compute_arms(image, 0.02, 14)
    for ours, theirs in zip(arms, port_arms):
        assert torch.equal(ours, theirs)
    want = cbca(volume.clone(), CrossArms(*port_arms), 3, 14)
    got = REF.cbca(volume.clone(), arms, 3, 14, lanes=128)
    assert torch.equal(got, want)


def test_scene_pool_is_made_from_the_seed():
    a = make_pair("occlusion", 2**31 + 3, 1, 40, 72, 16, "cpu")
    b = make_pair("occlusion", 2**31 + 3, 1, 40, 72, 16, "cpu")
    c = make_pair("occlusion", 2**31 + 4, 1, 40, 72, 16, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    for image in a:
        assert image.dtype == np.float32 and image.shape == (40, 72)
        assert abs(float(image.mean())) < 1e-5
        assert abs(float(image.std()) - 1.0) < 1e-4
