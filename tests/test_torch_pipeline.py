"""The port's match_pair, MatchPipeline and serve CLI against JAX."""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mccnn_tpu.io.pfm import read_pfm  # noqa: E402
from mccnn_tpu.pipeline.match import match_pair as jax_match_pair  # noqa: E402
from mccnn_tpu.utils.config import MatchConfig  # noqa: E402
from mccnn_tpu_torch.models.net import params_from_numpy  # noqa: E402
from mccnn_tpu_torch.models.params import save_params  # noqa: E402
from mccnn_tpu_torch.pipeline.match import (  # noqa: E402
    MatchPipeline,
    match_pair,
)

from test_cli import _write_scene  # noqa: E402
from torch_parity import jax_params, scene_pair  # noqa: E402


def _bad2(disparity, gt):
    return float(np.mean(np.abs(disparity - gt) > 2.0))


@pytest.fixture(scope="module")
def case():
    """A 48 x 64 occlusion scene through JAX at paper defaults, f32."""
    left, right, gt, ndisp = scene_pair("occlusion", 48, 64)
    params = jax_params()
    # paper defaults; sgm_chunk is JAX's semantics-neutral scan-unroll knob,
    # set to 1 to keep the CPU compile short
    config = MatchConfig(sgm_chunk=1)
    out = jax.jit(lambda a, b: jax_match_pair(
        params, a, b, ndisp, config, return_volumes=True))(left, right)
    want = {k: np.asarray(v) for k, v in out.items()}
    return {"left": left, "right": right, "gt": gt, "ndisp": ndisp,
            "net": params_from_numpy(params), "want": want}


def _port(case, **kwargs):
    out = match_pair(case["net"], torch.from_numpy(case["left"]),
                     torch.from_numpy(case["right"]), case["ndisp"],
                     return_volumes=True, **kwargs)
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def port_f32(case):
    """The port's default f32 pipeline on the case, volumes included."""
    return _port(case)


def test_match_pair_f32_matches_jax(case, port_f32):
    got, want, ndisp = port_f32, case["want"], case["ndisp"]
    for name in ("left_volume", "right_volume"):
        # float reassociation only (rtol 1e-4); atol for costs near zero
        np.testing.assert_allclose(got[name][..., :ndisp],
                                   want[name][..., :ndisp], rtol=1e-4,
                                   atol=1e-4)
        assert got[name][..., ndisp:].min() >= 1e8
    for name in ("left_disparity", "right_disparity"):
        assert np.mean(got[name] != want[name]) <= 0.005
    assert abs(_bad2(got["disparity"], case["gt"])
               - _bad2(want["disparity"], case["gt"])) <= 0.005


def test_match_pair_bf16_within_budget_of_jax_f32(case):
    got = _port(case, volume_dtype="bfloat16")
    assert np.isfinite(got["disparity"]).all()
    # the bf16 schedule's budget: 0.5 pt bad-2.0 of the exact f32 result
    assert abs(_bad2(got["disparity"], case["gt"])
               - _bad2(case["want"]["disparity"], case["gt"])) <= 0.005


@pytest.mark.parametrize("cbca_impl", ["fused", "xla"])
def test_cbca_impl_names_run_the_default_path(case, port_f32, cbca_impl):
    """Every accepted name runs ``cbca_fused``: the same disparities."""
    got = _port(case, cbca_impl=cbca_impl)["disparity"]
    np.testing.assert_array_equal(got, port_f32["disparity"])


@pytest.mark.parametrize("kwargs", [
    {"cbca_impl": "fused4"},
    {"cbca_impl": "mxu", "volume_dtype": "bfloat16"},
    {"cbca_impl": "rolling8"},
    {"cbca_impl": "fused2_8"},
    {"cbca_impl": "pallas", "volume_dtype": "bfloat16"},
    {"cost_volume_method": "scan"},
    {"volume_dtype": "int8"},
    {"cbca_chunk_d": 100},
    {"volume_dtype": "float16"},
])
def test_unported_options_raise(case, kwargs):
    """Every option of the JAX ``match_pair`` runs in the port (see
    ``test_torch_pipeline_variants.py``); what raises is what neither
    package takes: unknown names, the two f32-only CBCA backends on bf16
    volumes, a chunk that does not divide the padded depth."""
    with pytest.raises(ValueError):
        match_pair(case["net"], torch.zeros(16, 24), torch.zeros(16, 24), 4,
                   **kwargs)


def test_pipeline_buckets_and_crops(case):
    left, right = case["left"][:45, :61], case["right"][:45, :61]
    pipeline = MatchPipeline(jax_params(), bucket=16, device="cpu")
    got = pipeline(left, right, case["ndisp"])
    assert got.shape == (45, 61)
    padded = [np.pad(x, ((0, 3), (0, 3)), mode="edge") for x in (left, right)]
    want = match_pair(case["net"], *map(torch.from_numpy, padded),
                      case["ndisp"]).numpy()[:45, :61]
    np.testing.assert_array_equal(got, want)
    staged, times = pipeline.stage_times(left, right, case["ndisp"])
    assert list(times) == ["features", "cost_volume", "cbca_1", "sgm",
                           "cbca_2", "wta", "lr_interpolation", "subpixel",
                           "median", "bilateral"]
    assert all(seconds >= 0 for seconds in times.values())
    np.testing.assert_array_equal(staged, got)


def test_pipeline_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        MatchPipeline(jax_params(), device="cuda")


def test_serve_cli_on_cpu(tmp_path, rng):
    from mccnn_tpu_torch.cli.serve import main

    data_dir = tmp_path / "data"
    _write_scene(data_dir / "warm", rng, height=24, width=40)
    _write_scene(data_dir / "cold", rng, height=32, width=48)
    warmup_list = tmp_path / "warm.txt"
    warmup_list.write_text(f"{data_dir}/warm/im0.png\n")
    weights = tmp_path / "weights.npz"
    save_params(jax_params(), str(weights))
    out = tmp_path / "out"
    stdout = io.StringIO()
    main(["--resume", str(weights), "--bucket", "8", "--device", "cpu",
          "--warmup_list", str(warmup_list)],
         stdin=io.StringIO(f"{data_dir}/warm {out}/warm\n"
                           f"{data_dir}/missing {out}/missing\n"
                           f"{data_dir}/cold {out}/cold\n"
                           f"{data_dir}/cold {out}/cold2\n"),
         stdout=stdout)
    ready, warm, bad, cold, cold2 = (
        json.loads(line) for line in stdout.getvalue().splitlines())
    assert ready == {"event": "ready", "warmed": 1}
    assert warm["ok"] and warm["warm"] is True
    assert bad["ok"] is False and "error" in bad
    assert cold["ok"] and cold["warm"] is False
    assert cold2["ok"] and cold2["warm"] is True
    for name, shape in (("warm", (24, 40)), ("cold", (32, 48))):
        disparity = read_pfm(str(out / name / "disp0MCCNN.pfm"))
        assert disparity.shape == shape
        assert np.isfinite(disparity).all()
        assert (out / name / "disp0MCCNN.pgm").exists()
        assert float((out / name / "timeMCCNN.txt").read_text()) > 0
