"""The roofline and MFU arithmetic against PERF.md's numbers, and the
readers that use it on made-up runs."""

import math

import pytest

from portbench import arith, harness
from portbench.trace import Trace, breakdown, busy_seconds, idle_gaps

K2_NAME = ("void (anonymous namespace)::cbca_walk_kernel<__nv_bfloat16, 13, "
           "256, 16, 16, 256>(__nv_bfloat16 const*, __nv_bfloat16*)")


def test_k2_bound_is_perf_md_section_6():
    # 1000 x 1504 x 256 bf16: 1.570 GB, 0.4687 ms
    nbytes = arith.cbca_round_bytes(1000, 1504, 256, 2)
    assert nbytes == pytest.approx(1.570176e9)
    assert arith.bound_seconds(nbytes) * 1e3 == pytest.approx(0.4687,
                                                              abs=5e-5)


def test_conv_flops_is_the_bench_formula():
    assert arith.conv_flops(1000, 1504) == 2 * 1000 * 1504 * 2 * 9 * 64 * (
        1 + 4 * 64)


def test_ideal_pair_seconds_at_half_size():
    # the user's 1000 x 1504 pixels and 200 disparities, not the padded
    # 1024 x 1536 x 256 that the program computes
    stages = arith.pair_stage_flops(1000, 1504, 200, 18, "bfloat16")
    assert stages["band"] == (2.0 * 1000 * 1504 * 200 * 64 * 2, "bfloat16")
    assert stages["cbca"][0] == 2 * 18 * 5 * 1000 * 1504 * 200
    ideal = arith.ideal_pair_seconds(1000, 1504, 200, 18, "bfloat16")
    conv = arith.conv_flops(1000, 1504) / 67e12
    assert conv == pytest.approx(13.29e-3, rel=1e-3)
    assert conv < ideal < conv * 1.2


def _run(cell="half-stream-mix", pairs=10, window=1.5, k2_ms=1.75):
    run = harness.Run(cell=harness.load_cell(
        cell, harness.manifest_with_put_off()))
    run.window = (0.0, window)
    for i in range(pairs):
        req = harness.Request(i, i % 8, 0.1 * i, 1000 * 1504)
        req.t_dispatch, req.t_dispatched, req.t_done = 0.1 * i, 0.1 * i + .09, \
            0.1 * i + 0.15
        req.output = object()
        run.requests.append(req)
    trace = Trace(window=(0.0, 1.0))
    trace.device = [(K2_NAME, 0.1 + 0.01 * k, 0.1 + 0.01 * k + k2_ms * 1e-3)
                    for k in range(36)]
    trace.device.append(("other", 0.5, 0.8))
    trace.spans = [("portbench.dispatch", 0.0, 0.6),
                   ("portbench.fetch", 0.6, 1.0)]
    trace.host_ops = [("aten::copy_", 0.85, 0.95)]
    run.trace = trace
    return run


def test_k2_roofline_reader():
    run = _run(k2_ms=1.75)
    share = harness.metric_reader("k2_roofline.stream")(run)
    bound = arith.bound_seconds(arith.cbca_round_bytes(1024, 1536, 256, 2))
    assert share == pytest.approx(100 * bound / 1.75e-3)
    assert 0 < share < 100
    run.trace.device = [d for d in run.trace.device if d[0] == "other"]
    assert harness.metric_reader("k2_roofline.stream")(run) is None


def test_full_size_k2_launch_is_a_256_lane_chunk():
    run = _run("full-stream-mix", k2_ms=6.4)
    share = harness.metric_reader("k2_roofline.stream")(run)
    bound = arith.bound_seconds(arith.cbca_round_bytes(2048, 3072, 256, 2))
    assert share == pytest.approx(100 * bound / 6.4e-3)


def test_mfu_and_rate_readers():
    run = _run(pairs=10, window=1.5)
    ideal = arith.ideal_pair_seconds(1000, 1504, 200, 18, "bfloat16")
    mfu = harness.metric_reader("pair_mfu.stream")(run)
    assert mfu == pytest.approx(100 * ideal * 10 / 1.5)
    assert 0 < mfu < 100
    rate = harness.metric_reader("mpix_per_s")(run)
    assert rate == pytest.approx(10 * 1000 * 1504 / 1e6 / 1.5)
    assert harness.metric_reader("dispatch_ms.stream")(run) == (
        pytest.approx(90.0))


def test_idle_is_the_union_of_intervals():
    run = _run()
    trace = run.trace
    # K2's 36 launches of 1.75 ms start 10 ms apart from 0.1 s: no overlap
    busy = 36 * 1.75e-3 + 0.3
    assert busy_seconds(trace) == pytest.approx(busy)
    idle = harness.metric_reader("device_idle_pct.stream")(run)
    assert idle == pytest.approx(100 * (1 - busy))
    gaps = idle_gaps(trace)
    assert gaps[0] == (0.0, 0.1) and gaps[-1] == pytest.approx((0.8, 1.0))
    out = breakdown(trace, trace)
    assert out["device_ops"][0][0] == "other"
    assert out["device_ops"][1][1] == pytest.approx(36 * 1.75e-3)
    longest = out["idle_gaps"][0]
    assert longest[0] == "fetch > aten::copy_"
    assert longest[1] == pytest.approx(0.2)


def test_latency_p95_counts_unanswered_requests_over_any_limit():
    run = _run("half-open-mix", pairs=20)
    read = harness.metric_reader("latency_p95_s")
    assert read(run) == pytest.approx(0.15)
    run.requests[0].output = None
    run.requests[1].error = "fetch: boom"
    assert read(run) >= 1e9
    assert not math.isnan(harness.metric_reader("service_ms.open")(run))


def test_open_loop_arrivals_are_the_same_gaps_in_another_order():
    a = harness.due_times(1, 200, 40.0)
    b = harness.due_times(2**31 + 9, 200, 40.0)
    assert a[0] == b[0] == 0.0 and len(a) == 200
    gaps_a = sorted(list(a[1:] - a[:-1]) + [40.0 - a[-1]])
    gaps_b = sorted(list(b[1:] - b[:-1]) + [40.0 - b[-1]])
    assert gaps_a == pytest.approx(gaps_b)
    assert not (a == b).all()


ACCURATE = {"num_layers": 5, "num_maps": 112, "kernel_size": 3,
            "input_channels": 1, "num_fc_layers": 3, "num_fc_units": 384}


def test_accurate_net_counts_at_half_size():
    # 1000 x 1504 pixels, 200 disparities, 112 maps, 3 x 384 FC by hand
    stages = arith.pair_stage_flops(1000, 1504, 200, 18, "bfloat16",
                                    ACCURATE)
    assert list(stages) == ["features", "decision", "cbca", "sgm", "wta"]
    features = 2 * 1000 * 1504 * 2 * 9 * 112 * 449
    assert stages["features"] == (features, "float32")
    assert features / 1e12 == pytest.approx(2.7228, abs=5e-5)
    decision = (2 * 1000 * 1504 * 2 * 112 * 384
                + 1000 * 1504 * 200 * (2 * 2 * 384**2 + 4 * 384))
    assert stages["decision"] == (decision, "bfloat16")
    assert decision / 1e12 == pytest.approx(178.14, abs=5e-3)
    ideal = arith.ideal_pair_seconds(1000, 1504, 200, 18, "bfloat16",
                                     ACCURATE)
    assert ideal == pytest.approx(0.2218, abs=5e-5)
    # the decision network is most of the ideal; the fast band is not
    assert stages["decision"][0] / 989e12 / ideal > 0.8


def test_fast_net_stated_or_left_out_counts_alike():
    fast = {"patch_size": 11, "num_layers": 5, "num_maps": 64,
            "kernel_size": 3, "input_channels": 1, "bias_range": 0.05}
    for size in ((1000, 1504, 200), (2000, 3072, 400)):
        assert arith.pair_stage_flops(*size, 18, "bfloat16", fast) == (
            arith.pair_stage_flops(*size, 18, "bfloat16"))
        assert arith.conv_flops(*size[:2], fast) == arith.conv_flops(
            *size[:2])


@pytest.mark.parametrize("cell", ["half-stream-mix", "full-stream-mix"])
def test_pair_mfu_is_the_fast_formula_to_the_bit(cell):
    # the reader's value before it took the configuration's net, written
    # out: the fast net's five stages at their peaks
    run = _run(cell, pairs=7, window=2.25)
    c = run.config
    h, w, d = c["height"], c["width"], c["ndisp"]
    volume = float(h) * w * d
    stages = [(2.0 * h * w * 2 * 9 * 64 * (1 + 4 * 64), 67e12),
              (2.0 * h * w * d * 64 * 2, 989e12),
              (2 * 18 * 5 * volume, 67e12), (2 * 4 * 7 * volume, 67e12),
              (2 * volume, 67e12)]
    ideal = sum(flops / peak for flops, peak in stages)
    assert harness.metric_reader("pair_mfu.stream")(run) == (
        100.0 * ideal * 7 / 2.25)
