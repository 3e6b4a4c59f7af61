"""The port's bench and bench tools on the CPU, against the JAX repo's
bench.py: its pair, its record, its serving schedule at 24 x 40, ndisp 8;
the training bench, the serve bench over real pipes and bench_all's log.
"""

import json
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mccnn_tpu.pipeline.match import match_pair as jax_match_pair  # noqa: E402
from mccnn_tpu.utils.config import MatchConfig as JaxMatchConfig  # noqa: E402
from mccnn_tpu_torch import bench  # noqa: E402
from mccnn_tpu_torch.io.pfm import read_pfm  # noqa: E402
from mccnn_tpu_torch.models.net import (  # noqa: E402
    init_params,
    params_from_numpy,
)
from mccnn_tpu_torch.tools import bench_all, bench_serve  # noqa: E402

from torch_parity import jitted  # noqa: E402

HEIGHT, WIDTH, NDISP = 24, 40, 8
# the JAX bench's record keys and isolated stages (bench.py:329-351, :259)
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "seconds_per_pair",
            "schedule", "stages_ms_isolated", "cbca_volume_gbps",
            "cbca_impl", "stages_in_pipeline_est_ms"}
STAGES = ("features", "cost_volume", "cbca", "sgm", "post")


@pytest.mark.parametrize("shape", [(HEIGHT, WIDTH), (1000, 1504)])
def test_bench_pair_is_the_jax_bench_pair(shape):
    """bench.py:284-290, written out as there, bit for bit."""
    height, width = shape
    rng = np.random.default_rng(0)
    base = rng.normal(size=(height, width)).astype(np.float32)
    left = jnp.asarray((base - base.mean()) / base.std())
    shifted = np.roll(base, -12, axis=1) + 0.05 * rng.normal(
        size=(height, width)
    ).astype(np.float32)
    right = jnp.asarray((shifted - shifted.mean()) / shifted.std())
    got_left, got_right = bench.bench_pair(height, width)
    for got, want in ((got_left, left), (got_right, right)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))


def test_main_prints_one_record_with_the_jax_keys(capsys):
    # one window of one pair, and no parity check (96 x 256 plain CBCA
    # rounds, 4 s here: it holds kernels to plain versions, which on the
    # CPU are the same functions; chip_smoke.py runs it on the card)
    record = bench.main(HEIGHT, WIDTH, NDISP, device="cpu", windows=1,
                        pairs=1, parity=False)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == record
    assert JAX_KEYS <= set(record)
    assert record["metric"] == "halfres_full_pipeline_megapixels_per_s"
    assert record["schedule"] == "bf16_fused" and record["unit"] == "MP/s"
    assert record["value"] == HEIGHT * WIDTH / 1e6 / record[
        "seconds_per_pair"]
    assert record["vs_baseline"] == record["value"] / bench.TARGET_MPS
    assert record["seconds_per_pair"] == min(record["samples_s"])
    assert set(record["stages_ms_isolated"]) == {*STAGES, "cbca_ms_per_round"}
    assert set(record["stages_in_pipeline_est_ms"]) == set(STAGES)
    assert set(record["tflops"]) == {"features", "cost_volume"}
    # the CPU names itself and gives no device memory; no kernel launches
    assert record["device"] == "cpu" and record["peak_device_gb"] is None
    assert record["launches"] == {} and record["finite"] is True
    assert len(record["samples_s"]) == 1 and "parity" not in record


def _jax_band_bf16(features_left, features_right, sides):
    """JAX's band on descriptors rounded to bf16, f32 sums, bf16 volumes:
    what its band kernel computes on its chip (the one-pass DEFAULT dot
    rounds each operand to bf16), by its matrix-product route, bit for bit
    at this size; the kernel in interpret mode adds 2 s of compile."""
    import jax.numpy as jnp
    from mccnn_tpu.ops.cost_volume import cost_volume_pair

    def rounded(f):
        return f.astype(jnp.bfloat16).astype(jnp.float32)

    return cost_volume_pair(rounded(features_left), rounded(features_right),
                            NDISP, method="matmul", sides=sides,
                            dtype=jnp.bfloat16)


def test_half_schedule_matches_jax_on_carried_weights():
    """The bench's serving schedule (bf16 volumes, paper defaults) against
    JAX's match_pair on the same pair and the bench's weights
    (``init_params(0)``, carried to both), on the route the JAX bench takes
    on its chip: the band on bf16-rounded descriptors as the port's band
    (JAX's CPU "auto" correlates f32 descriptors), one volume at a time,
    and CBCA with f32 sums stored per round ("xla", what K2 computes).
    The volumes agree to one bf16 ulp at the largest cost (the band's sums
    round apart on a few entries), the WTA maps exactly. JAX's compile is
    most of the time and does not shrink with the shape."""
    params = init_params(0)
    left, right = bench.bench_pair(HEIGHT, WIDTH)
    run = bench.matcher(params_from_numpy(params), NDISP,
                        {**bench.HALF, "return_volumes": True})
    got = {k: v.float().numpy() for k, v in run(
        torch.from_numpy(left), torch.from_numpy(right)).items()}
    # the features held across the right volume's phase, as JAX's default
    # band schedule holds them (the same values as recomputing them)
    want = jitted(jax_match_pair, "ndisp", "config", "cost_volume_fn",
                  "cbca_impl", "volume_dtype", "return_volumes",
                  "recompute_features")(
        params, left, right, ndisp=NDISP, config=JaxMatchConfig(sgm_chunk=1),
        cost_volume_fn=_jax_band_bf16, cbca_impl="xla",
        volume_dtype="bfloat16", return_volumes=True,
        recompute_features=False)
    want = {k: np.asarray(v).astype(np.float32) for k, v in want.items()}
    for key in ("left_volume", "right_volume"):
        costs = want[key][..., :NDISP]
        ulp = 2.0 ** (np.floor(np.log2(np.abs(costs).max())) - 7)
        np.testing.assert_allclose(got[key][..., :NDISP], costs, atol=ulp,
                                   rtol=0)
        np.testing.assert_array_equal(got[key][..., NDISP:],
                                      want[key][..., NDISP:])
    for key in ("left_disparity", "right_disparity"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["disparity"], want["disparity"],
                               atol=1e-4, rtol=0)


def test_bench_train_record():
    record = bench.bench_train(batch=8, steps=2, device="cpu", warmup=2,
                               windows=2)
    assert record["metric"] == "train_steps_per_s_batch8"
    assert record["value"] == 1.0 / record["seconds_per_step"]
    assert record["seconds_per_step"] == min(record["samples_s"])
    assert len(record["samples_s"]) == 2 and record["warmup_steps"] == 2
    assert record["device"] == "cpu" and record["peak_device_gb"] is None
    assert np.isfinite([record["first_loss"], record["last_loss"]]).all()


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.cli(["--config", "quarter"])


@pytest.mark.parametrize("client", ["pipelined", "sync"])
def test_serve_bench_over_real_pipes(tmp_path, client):
    root = tmp_path / "serve"
    record = bench_serve.run(["--scenes", "2", "--height", str(HEIGHT),
                              "--width", str(WIDTH), "--ndisp",
                              str(NDISP), "--bucket", "8", "--client",
                              client, "--device", "cpu", "--root",
                              str(root)])
    assert record["client"] == client and record["device"] == "cpu"
    assert record["scenes"] == record["answered_ok"] == 2
    assert record["missing_artifacts"] == 0
    assert len(record["latencies_s"]) == 2 and record["value"] > 0
    for i in range(2):
        disparity = read_pfm(str(root / "out" / f"s{i:02d}" /
                                 "disp0MCCNN.pfm"))
        assert disparity.shape == (HEIGHT, WIDTH)
        assert np.isfinite(disparity).all()


def test_bench_all_appends_one_record_per_config(tmp_path, monkeypatch):
    """Each config's last JSON line, with the config, host, device and
    commit; a failed config is logged and makes the exit code 1."""
    calls = []

    def fake_run(config, device, timeout):
        calls.append((config, device))
        if config == "full":
            return subprocess.CompletedProcess([], 1, "", "out of memory")
        lines = ["log line", json.dumps({"metric": config, "value": 1.5})]
        return subprocess.CompletedProcess([], 0, "\n".join(lines), "")

    monkeypatch.setattr(bench_all, "run_config", fake_run)
    out = tmp_path / "log.jsonl"
    out.write_text('{"config": "earlier"}\n')
    code = bench_all.main(["--configs", "half,full,serve", "--out",
                           str(out), "--device", "cpu", "--commit", "abc"])
    assert code == 1
    assert calls == [("half", "cpu"), ("full", "cpu"), ("serve", "cpu")]
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert records[0] == {"config": "earlier"}
    half, full, serve = records[1:]
    assert half["ok"] and half["metric"] == "half" and half["value"] == 1.5
    assert not full["ok"] and full["returncode"] == 1
    assert "out of memory" in full["stderr_tail"]
    for record, config in ((half, "half"), (full, "full"), (serve, "serve")):
        assert record["config"] == config
        assert record["device"] == "cpu" and record["commit"] == "abc"
        assert record["host"] and record["wall_seconds"] >= 0
    assert bench_all.command("serve", "cpu")[-3:] == [
        "mccnn_tpu_torch.tools.bench_serve", "--device", "cpu"]
    # the JAX bench's log stays its own
    assert bench_all.build_parser().parse_args([]).out == os.path.join(
        bench_all.ROOT, "BENCH_torch_full.jsonl")
