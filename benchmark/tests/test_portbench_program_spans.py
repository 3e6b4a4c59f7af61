"""The readers of the program's own spans (``portbench/program_spans.py``):
a traced CPU rehearsal reads every host metric, the device ones read
nothing without a card, every reader reads nothing from a program without
a tracer, set-up splits into the program's part and the rest, and the
program's clock is put on the trace's."""

import math
import sys

import pytest

from portbench import harness, program_spans
from portbench.trace import Trace

NEW = [m for m in harness.read_json(harness.ROOT / "BENCHMARK.json")
       ["per_layer"] if m["source"] == "program_span"
       or m["name"] in ("device_ops_per_pair.stream",
                        "idle_in_enqueue_pct.stream")]
DEVICE = {m["name"] for m in NEW if "device" in m["name"]
          or m["name"] == "idle_in_enqueue_pct.stream"}


@pytest.fixture(scope="module")
def traced_run():
    from conftest import tiny_cell

    cell = tiny_cell("half-stream-mix")
    run, _, _ = harness.drive(cell, 2**31 + 29, 0.5, True, "cpu")
    return run


def test_every_new_metric_is_listed_for_both_stream_cells():
    assert len(NEW) == 16
    for metric in NEW:
        assert metric["workloads"] == ["half-stream-mix", "full-stream-mix"]
        assert metric["moves"] in ("setup_s", "mpix_per_s")


def test_cpu_rehearsal_reads_every_host_metric(traced_run):
    for metric in NEW:
        value = harness.metric_reader(metric["name"])(traced_run)
        if metric["name"] in DEVICE:
            assert value is None, metric["name"]  # no card, no events
        else:
            assert value is not None and value >= 0, metric["name"]
    line = harness.result(traced_run, {"bad_pct": 0.0, "mean_abs_px": 0.0},
                          True, "cpu")
    assert {m["name"] for m in NEW} - DEVICE <= set(line["metrics"])


def test_stage_host_times_and_copy_in_fill_the_dispatch_span(traced_run):
    spans = program_spans.records()
    pairs = program_spans.stretch_pairs(traced_run, spans)
    assert len(pairs) == len(traced_run.stretch)
    dispatch = sum(s.seconds for group in pairs.values() for s in group
                   if s.name == "dispatch") * 1e3 / len(pairs)
    parts = sum(program_spans.per_pair_ms(traced_run, name)
                for name in ("copy_in", *program_spans.STAGES))
    assert parts == pytest.approx(dispatch, rel=0.05)


def test_setup_splits_into_the_program_and_the_rest(traced_run):
    inside = harness.metric_reader("setup_program_s.stream")(traced_run)
    outside = harness.metric_reader("setup_outside_s.stream")(traced_run)
    assert 0 < inside < traced_run.setup_s and outside > 0
    assert inside + outside == pytest.approx(traced_run.setup_s, rel=1e-12)


def test_setup_counts_a_set_up_span_inside_another_once(monkeypatch):
    from mccnn_tpu_torch.utils.tracing import Span

    # the library built and loaded inside a first pair's dispatch; a span
    # that ends in the window is not set-up
    spans = [Span("setup.import", 0.0, 1.0, 1),
             Span("setup.first_pair", 2.0, 5.0, 2),
             Span("setup.library", 2.5, 3.5, 3),
             Span("setup.load", 3.5, 4.0, 4),
             Span("setup.first_pair", 6.0, 6.5, 5),
             Span("setup.first_pair", 9.0, 11.0, 6)]
    monkeypatch.setattr(program_spans, "records", lambda: spans)
    run = harness.Run(cell=None)
    run.setup_s, run.window = 10.0, (10.0, 20.0)
    assert program_spans.setup_program_s(run) == pytest.approx(4.5)


def test_every_reader_reads_nothing_without_the_tracer(traced_run,
                                                       monkeypatch):
    import mccnn_tpu_torch.utils

    monkeypatch.delattr(mccnn_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "mccnn_tpu_torch.utils.tracing", None)
    assert program_spans.records() is None
    for metric in NEW:
        assert harness.metric_reader(metric["name"])(traced_run) is None


def test_alignment_recovers_a_known_offset():
    offset = 1234.5678
    program = [(10.0 + k, 10.6 + k) for k in range(3)]
    # each harness span encloses its program span by a few microseconds
    margins = [(3e-6, 5e-6), (7e-6, 2e-6), (4e-6, 6e-6)]
    harness_spans = [(a + offset - m0, b + offset + m1)
                     for (a, b), (m0, m1) in zip(program, margins)]
    found, error = program_spans.align(harness_spans, program)
    assert abs(found - offset) <= error + 1e-9
    assert 0 <= error <= 3e-6
    assert program_spans.align(harness_spans[:2], program) is None


def test_idle_share_inside_stages_on_a_synthetic_trace(monkeypatch):
    from mccnn_tpu_torch.utils.tracing import Span

    offset = 500.0
    # program clock: one pair's dispatch [1, 4], a stage [1.5, 2.5]; the
    # device stretch's pair came before, ending at 0.5
    spans = [Span("dispatch", 1.0, 4.0, 1, None, 7),
             Span("features", 1.5, 2.5, 2, 1, 7),
             Span("copy_out", 4.5, 5.0, 3, None, 7)]
    monkeypatch.setattr(program_spans, "records", lambda: spans)
    # trace clock: device busy [501, 502] and [503, 505.5]: idle [502, 503]
    host = Trace(device=[("k", 501.0, 502.0), ("k", 503.0, 505.5)],
                 spans=[("portbench.dispatch", 501.0 - 1e-6, 504.0 + 1e-6)],
                 window=(501.0, 505.5))
    run = harness.Run(cell=None)
    run.trace = Trace(device=[("k", 0.0, 0.4)], window=(0.0, 0.4))
    run.host_trace = host
    run.stretch = [harness.Request(0, 0, 0.0, 0, t_dispatch=0.0,
                                   t_dispatched=0.1, t_done=0.5)]
    share = program_spans.idle_in_enqueue_pct(run)
    # the stage [501.5, 502.5] covers half of the idle second
    assert share == pytest.approx(50.0, abs=1e-3)
    assert math.isclose(program_spans.host_stretch_alignment(run, spans)[0],
                        offset, abs_tol=1e-6)
