"""The comparison fails a broken program: each fault is planted under the
timed path of a tiny CPU run, the rest of the run is driven as on the
card, and ``correct`` must come out false. The control, the program with
its int8 CBCA storage (``cbca_impl="fused8"``, the step below the bf16
volumes the configurations state), must fail too."""

import numpy as np
import pytest

from portbench import harness

SEED = 2**31 + 29


def _line(cell, inject=None, overrides=None, seconds=0.5):
    run, weights, pool = harness.drive(cell, SEED, seconds, False, "cpu", inject=inject,
                                       pipeline_overrides=overrides)
    numbers = harness.compare(run, weights, pool, SEED, "cpu")
    return harness.result(run, numbers, False, "cpu"), numbers


def test_the_sound_program_passes(tiny):
    line, numbers = _line(tiny("half-stream-mix"))
    assert line["correct"] is True
    assert numbers == {"bad_pct": 0.0, "mean_abs_px": 0.0}


def test_cbca_that_returns_its_volume_unchanged_fails(tiny, monkeypatch):
    from mccnn_tpu_torch.pipeline import match

    monkeypatch.setattr(match, "cbca_fused",
                        lambda volume, *args, **kwargs: volume)
    line, numbers = _line(tiny("half-stream-mix"))
    assert line["correct"] is False and line["failed"] == 0


def test_sgm_that_returns_its_volume_unchanged_fails(tiny, monkeypatch):
    from mccnn_tpu_torch.pipeline import match

    monkeypatch.setattr(match, "_sgm_one_volume",
                        lambda volume, *args, **kwargs: volume)
    line, numbers = _line(tiny("half-stream-mix"))
    assert line["correct"] is False and line["failed"] == 0


class _Altered:
    """The program with one answer altered where it is produced: the
    second map fetched in the window is a pixel and a half off on its
    upper half."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.fetched = 0

    def dispatch(self, *args):
        return self.pipeline.dispatch(*args)

    def fetch(self, handle):
        out = self.pipeline.fetch(handle)
        self.fetched += 1
        if self.fetched == 4:  # two warm pairs, then the window's second
            out = out.copy()
            out[: out.shape[0] // 2] += 1.5
        return out


def test_an_answer_altered_where_it_is_produced_fails(tiny):
    line, numbers = _line(tiny("half-stream-mix"), inject=_Altered,
                          seconds=3.0)
    assert line["correct"] is False and line["failed"] == 0


class _Lost(_Altered):
    """The program with one answer lost: its fetch raises."""

    def fetch(self, handle):
        self.fetched += 1
        if self.fetched == 4:
            raise RuntimeError("lost")
        return self.pipeline.fetch(handle)


def test_an_answer_that_never_comes_fails(tiny):
    line, numbers = _line(tiny("half-stream-mix"), inject=_Lost, seconds=3.0)
    assert line["failed"] == 1 and line["correct"] is False


@pytest.mark.parametrize("workload", ["half-stream-mix", "full-stream-mix"])
def test_the_int8_control_fails(tiny, workload):
    line, numbers = _line(tiny(workload), overrides={"cbca_impl": "fused8"})
    assert line["correct"] is False and line["failed"] == 0
    assert np.isfinite(list(numbers.values())).all()


def test_a_window_with_no_map_to_compare_fails(tiny):
    run = harness.Run(cell=tiny("half-stream-mix"))
    pool = [{"family": f} for f in ("translation", "slanted")]
    numbers = harness.compare(run, None, pool, SEED, "cpu")
    assert harness.result(run, numbers, False, "cpu")["correct"] is False
