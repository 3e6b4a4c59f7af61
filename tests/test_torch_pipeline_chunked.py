"""The d-chunked CBCA schedule and the torch-op cost volume in the port's
``match_pair`` against JAX ``match_pair`` with the same arguments.

A search range of 132 pads to a 256-lane depth, so ``cbca_chunk_d=128``
really chunks. Few CBCA rounds keep the JAX CPU compiles short.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu_torch.models.net import params_from_numpy  # noqa: E402
from mccnn_tpu_torch.ops.cbca import compute_arms  # noqa: E402
from mccnn_tpu_torch.ops.cbca_fused import cbca_int8_plain  # noqa: E402
from mccnn_tpu_torch.pipeline.match import (  # noqa: E402
    MatchPipeline,
    _cbca_aggregate,
    _run_cbca,
    match_pair,
)
from mccnn_tpu_torch.utils.config import MatchConfig  # noqa: E402

from test_torch_pipeline_modes import (  # noqa: E402
    ROUNDS,
    _assert_f32_parity,
    _both,
)
from torch_parity import jax_params, scene_pair  # noqa: E402


@pytest.fixture(scope="module")
def wide():
    """The scene's own disparities stay below 20; the search range is 132."""
    left, right, gt, _ = scene_pair("slanted", 12, 136, seed=1,
                                    max_disparity=20)
    return left, right, gt, 132


def test_d_chunked_cbca_matches_jax(wide):
    got, want, gt, ndisp = _both(wide, cbca_chunk_d=128)
    assert got["left_volume"].shape[-1] == 256
    _assert_f32_parity(got, want, gt, ndisp)
    # chunking changes nothing in f32: aggregation is independent per lane
    whole = match_pair(params_from_numpy(jax_params()),
                       torch.from_numpy(wide[0]), torch.from_numpy(wide[1]),
                       ndisp, MatchConfig(**ROUNDS)).numpy()
    np.testing.assert_array_equal(got["disparity"], whole)


def test_rolldot_cost_volume_matches_jax():
    _assert_f32_parity(*_both(scene_pair("occlusion", 48, 64),
                              cost_volume_method="rolldot"))


def test_int8_d_chunks_quantize_per_chunk(rng):
    """With fused8 every chunk call has its own scale, as in JAX's
    ``run_cbca``: the chunked result is the per-chunk results side by side,
    not the whole-volume result."""
    image = torch.from_numpy(scene_pair("textureless", 24, 40)[0])
    arms = compute_arms(image, 0.02, 14)
    volume = torch.from_numpy(
        rng.uniform(-1, 1, (24, 40, 256)).astype(np.float32))
    volume[..., 128:] *= 0.1  # the second chunk has a finer scale
    volume[..., 200:] = 1e9
    aggregate = _cbca_aggregate("fused8")
    got = _run_cbca(aggregate, volume.clone(), arms, 2, 14, 128)
    want = torch.cat([cbca_int8_plain(volume[..., :128].contiguous(), arms, 2),
                      cbca_int8_plain(volume[..., 128:].contiguous(), arms, 2)],
                     dim=2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    whole = _run_cbca(aggregate, volume.clone(), arms, 2, 14, 0)
    assert not torch.equal(got[..., 128:200], whole[..., 128:200])
    assert float(got[..., 200:].min()) >= 1e8


def test_chunk_must_divide_the_padded_depth(wide):
    left, right, _, ndisp = wide
    with pytest.raises(ValueError, match="divide"):
        match_pair(params_from_numpy(jax_params()), torch.from_numpy(left),
                   torch.from_numpy(right), ndisp, MatchConfig(**ROUNDS),
                   cbca_chunk_d=96)


def test_pipeline_passes_chunk_and_method_on(wide):
    left, right, _, ndisp = wide
    pipeline = MatchPipeline(jax_params(), MatchConfig(**ROUNDS), bucket=1,
                             device="cpu", cbca_chunk_d=96)
    assert pipeline.cbca_chunk_d == 96
    with pytest.raises(ValueError, match="divide"):
        pipeline(left, right, ndisp)
    with pytest.raises(ValueError, match="method"):
        MatchPipeline(jax_params(), device="cpu", cost_volume_method="scan")
