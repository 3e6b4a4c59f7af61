"""The port's spans (``mccnn_tpu_torch/utils/tracing.py``): nothing recorded
while off, one pair's spans nested in stage order while on, the set-up
spans, and maps identical either way. This file imports no JAX; the cases
marked ``cuda`` run on a card (``pytest tests/test_torch_tracing.py
--noconftest``) and skip here."""

import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mccnn_tpu_torch.pipeline.match import MatchPipeline  # noqa: E402
from mccnn_tpu_torch.utils import tracing  # noqa: E402
from torch_parity import require_card, scene_pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("features", "cost_volume", "cbca", "sgm", "post")
# the order of a pair's stage spans on the band path: the right volume,
# its WTA, the left volume, its WTA, then LR, subpixel and the filters
STAGE_ORDER = (["features"]
               + ["cost_volume", "cbca", "sgm", "cbca", "post"] * 2
               + ["post"])


def _params(seed=0, maps=8, layers=3):
    """A small net on the CPU; the band kernel K1 takes 64 maps on a card."""
    rng = np.random.default_rng(seed)
    params, cin = {}, 1
    for i in range(1, layers + 1):
        params[f"conv{i}"] = {
            "w": rng.normal(0, 0.3, (3, 3, cin, maps)).astype(np.float32),
            "b": rng.normal(0, 0.05, maps).astype(np.float32)}
        cin = maps
    return params


@pytest.fixture
def traced():
    """The tracer emptied and off, and left so."""
    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def scene():
    left, right, _, ndisp = scene_pair(height=24, width=40, max_disparity=6)
    return left, right, ndisp


def _pair_spans(pair):
    return [s for s in tracing.records() if s.pair == pair
            and not s.name.startswith(tracing.SETUP)]


def _self_seconds(span, spans):
    inner = sorted((s.start, s.end) for s in spans if s.parent == span.id)
    covered, at = 0.0, span.start
    for start, end in inner:
        start, end = max(start, at), min(end, span.end)
        if end > start:
            covered += end - start
            at = end
    return span.seconds - covered


def test_off_records_nothing_and_enters_no_record_function(
        traced, scene, monkeypatch):
    left, right, ndisp = scene
    pipeline = MatchPipeline(_params(), bucket=8, device="cpu")
    pipeline(left, right, ndisp)  # the bucket's first pair, recorded always
    before = len(tracing.records())

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    reads = []
    clock = types.SimpleNamespace(
        perf_counter=lambda: reads.append(1) or time.perf_counter())
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "time", clock)
    assert not tracing.on()
    pipeline(left, right, ndisp)
    assert len(tracing.records()) == before
    assert reads == []
    handle = pipeline.dispatch(left, right, ndisp)
    assert handle[2] is None and handle[3] is False  # no pair id, not first
    pipeline.fetch(handle)


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_spans_nest_under_one_pair_in_stage_order(traced, scene, how):
    left, right, ndisp = scene
    pipeline = MatchPipeline(_params(), bucket=8, device="cpu")
    pipeline(left, right, ndisp)  # warm
    tracing.reset()
    if how == "enable":
        tracing.enable()
        handle = pipeline.dispatch(left, right, ndisp)
        pipeline.fetch(handle)
        tracing.disable()
    else:
        activities = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=activities) as prof:
            handle = pipeline.dispatch(left, right, ndisp)
            pipeline.fetch(handle)
        names = {e.key for e in prof.key_averages()}
        assert {"mccnn." + n for n in ("dispatch", "copy_in", *STAGES,
                                       "copy_out")} <= names
    pair = handle[2]
    assert pair is not None
    spans = _pair_spans(pair)
    assert {s.pair for s in tracing.records()
            if not s.name.startswith(tracing.SETUP)} == {pair}
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == {"dispatch", "copy_in", *STAGES, "copy_out"}
    (dispatch,), (copy_in,) = by_name["dispatch"], by_name["copy_in"]
    (copy_out,) = by_name["copy_out"]
    assert dispatch.parent is None and copy_out.parent is None
    assert copy_in.parent == dispatch.id
    stages = sorted((s for s in spans if s.name in STAGES),
                    key=lambda s: s.start)
    assert [s.name for s in stages] == STAGE_ORDER
    assert all(s.parent == dispatch.id for s in stages)
    assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))
    assert dispatch.start <= copy_in.start and copy_in.end <= stages[0].start
    assert stages[-1].end <= dispatch.end <= copy_out.start
    parts = sum(_self_seconds(s, spans) for s in stages) + copy_in.seconds
    assert parts == pytest.approx(dispatch.seconds, rel=0.05)
    assert all(s.device_ms is None for s in spans)  # no card: no events


def _firsts():
    return [s for s in tracing.records() if s.name == "setup.first_pair"]


def test_first_pair_recorded_once_a_bucket_shape(traced, scene):
    """Once a bucket shape: its first pair's dispatch and its fetch, one
    span each."""
    left, right, ndisp = scene
    pipeline = MatchPipeline(_params(), bucket=16, device="cpu")
    tracing.reset()
    pipeline(left, right, ndisp)  # 24 x 40 -> 32 x 48
    pipeline(left[:20, :36], right[:20, :36], ndisp)  # the same bucket
    pipeline(left, right, ndisp)
    firsts = _firsts()
    assert len(firsts) == 2 and all(s.seconds > 0 for s in firsts)
    assert firsts[0].end <= firsts[1].start
    pipeline(left[:12], right[:12], ndisp)  # 16 x 48: a new bucket
    pipeline(left, right, ndisp + 2)  # another depth
    assert len(_firsts()) == 6
    assert MatchPipeline(_params(), bucket=16, device="cpu")(
        left, right, ndisp).shape == left.shape
    assert len(_firsts()) == 8  # a pipeline's own buckets


def test_first_pair_leaves_out_the_callers_time_between_its_calls(
        traced, scene):
    """What the caller does between a first pair's dispatch and its fetch
    (the next pair's dispatch, waiting for input) is not set-up."""
    left, right, ndisp = scene
    pipeline = MatchPipeline(_params(), bucket=8, device="cpu")
    tracing.reset()
    start = time.perf_counter()
    handle = pipeline.dispatch(left, right, ndisp)
    time.sleep(0.2)
    pipeline.fetch(handle)
    wall = time.perf_counter() - start
    dispatch_part, fetch_part = _firsts()
    assert dispatch_part.end <= fetch_part.start - 0.2
    assert dispatch_part.seconds + fetch_part.seconds <= wall - 0.2


def test_setup_spans_after_import_library_and_pipeline_init(tmp_path):
    """In a fresh process: the package's import, the library (its build
    found in place; loaded too where there is a card) and a pipeline's
    construction each leave their set-up span, with tracing off."""
    code = f"""
import sys
import numpy as np
import torch
import mccnn_tpu_torch
from mccnn_tpu_torch.kernels import build
from mccnn_tpu_torch.pipeline.match import MatchPipeline
from mccnn_tpu_torch.utils import tracing
assert not tracing.on()
if torch.cuda.is_available():
    build.library()
    device = "cuda"
else:
    build.BUILD_DIR = __import__("pathlib").Path({str(tmp_path)!r})
    build.library_path().write_bytes(b"")  # found: no compiler is run
    build.build()
    device = "cpu"
params = {{"conv1": {{"w": np.ones((3, 3, 1, 4), np.float32),
                      "b": np.zeros(4, np.float32)}}}}
MatchPipeline(params, device=device)
for s in tracing.records():
    print(s.name, s.parent is None, s.seconds)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ), check=True).stdout
    lines = [line.split() for line in out.splitlines()]
    names = [name for name, _, _ in lines]
    assert names[0] == "setup.import"
    assert "setup.library" in names and names[-1] == "setup.pipeline"
    assert all(float(seconds) >= 0 for _, _, seconds in lines)
    # the library's build and its load are spans of their own, one each
    assert all(top == "True" for _, top, _ in lines)
    assert names.count("setup.library") == 1
    assert names.count("setup.load") == int(torch.cuda.is_available())


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_map_is_bit_identical_with_tracing_on_and_off(traced, scene, device):
    if device == "cuda":
        require_card()
    left, right, ndisp = scene
    pipeline = MatchPipeline(_params(maps=64 if device == "cuda" else 8),
                             bucket=8, device=device, volume_dtype="bfloat16")
    off = pipeline(left, right, ndisp)
    tracing.enable()
    on = pipeline(left, right, ndisp)
    tracing.disable()
    np.testing.assert_array_equal(on, off)
    assert any(s.name == "dispatch" for s in tracing.records())


@pytest.mark.cuda
def test_stage_device_times_on_the_card(traced):
    require_card()
    left, right, _, ndisp = scene_pair(height=96, width=160,
                                       max_disparity=20)
    pipeline = MatchPipeline(_params(maps=64), bucket=32, device="cuda",
                             volume_dtype="bfloat16")
    pipeline(left, right, ndisp)
    tracing.reset()
    tracing.enable()
    handle = pipeline.dispatch(left, right, ndisp)
    pipeline.fetch(handle)
    tracing.disable()
    spans = _pair_spans(handle[2])
    stages = [s for s in spans if s.name in STAGES]
    assert [s.name for s in sorted(stages, key=lambda s: s.start)] == (
        STAGE_ORDER)
    # read at the end of fetch, with no wait: the device passed them all
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in stages)
    (dispatch,) = [s for s in spans if s.name == "dispatch"]
    assert dispatch.device_ms is not None
    assert (sum(s.device_ms for s in stages)
            <= dispatch.device_ms * 1.01 + 0.05)


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_spans_keep_no_raw_volume_alive(traced, scene, on):
    """The stage spans hold no tensor: once CBCA has made its own volume,
    the raw cost volume is freed before SGM runs, as without spans (on a
    card that volume is 0.8 GB at Middlebury half size)."""
    import weakref

    from mccnn_tpu_torch.models.net import params_from_numpy
    from mccnn_tpu_torch.ops.cost_volume import cost_volume_pair
    from mccnn_tpu_torch.ops.sgm import _sgm_one_volume
    from mccnn_tpu_torch.pipeline.match import match_pair

    left, right, ndisp = (torch.from_numpy(x) if hasattr(x, "shape") else x
                          for x in scene)
    raw, alive = [], []

    def cost_volume_fn(fl, fr, sides):
        volume = cost_volume_pair(fl, fr, ndisp, sides=sides)
        raw.append(weakref.ref(volume))
        return volume

    def sgm_fn(volume, *args):
        alive.append(raw[-1]() is not None)
        return _sgm_one_volume(volume, *args)

    if on:
        tracing.enable()
    match_pair(params_from_numpy(_params()), left, right, ndisp,
               cost_volume_fn=cost_volume_fn, sgm_fn=sgm_fn)
    assert alive == [False, False]
